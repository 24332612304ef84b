// dense_walk: the dense leveled trie walk of the dense matcher, writing the
// packed match words.
//
// Replaces the JAX package's Pallas kernel K4,
//   maxmq_tpu/matching/pallas_kernel.py  _make_kernel (pallas_call at :206),
// and the pack step that follows it there (maxmq_tpu/matching/dense.py
// pack_and_extract, the [B, R] -> uint32 words reshape-and-sum). The sparse
// extract of the nonzero words stays a torch step after this kernel, as the
// reference's is an XLA step after its kernel.
//
// What it computes, per topic b (tokens t_l = toks[b, l] for l < n_tok_cols,
// else -1 — the trailing pad column that gives '#' its parent match):
//   s_{-1} = the root (active);
//   for each level l < n_levels, for each slot j < width[l]:
//     parent = (l == 0) ? 1 : s_{l-1}[parent_idx[l][j]]
//     match  = t_l == child_tok[l][j]
//              | (child_tok == PLUS && t_l >= 0)       [MQTT-4.7.1-3]
//              | (child_tok == HASH)                   [MQTT-4.7.1.2]
//              with both wildcard terms off at level 0 for '$' topics
//                                                      [MQTT-4.7.2-1]
//     s_l[j] = parent & match
//   and an emitter slot j < n_emit[l] sets row r = emit_base[l] + j when
//     s_l[j] & (lengths[b] == l + 1 || !emit_exact[l][j])   ('#' rows ungated)
//   out[b, w] bit i = row 32w + i, for w < n_words (words past the rows are 0).
// Padding slots (child_tok NEVER) match nothing. Bucket pad topics (length 0,
// all tokens -1) do match root '#' rows; the caller trims them, as the
// reference does. This is the Pallas kernel's function: its one-hot product
// s @ E_l selects exactly s_{l-1}[parent_idx[l][j]] (and at level 0, with
// s all ones, 1 for every real slot).
//
// Design. One warp walks one topic; lane i owns slots j = 32k + i. The
// block stages the tables (child_tok, parent_idx, emit_exact: 9 bytes a
// slot, about 37 KB at 8 levels x 512 slots) in shared memory once and its
// warps loop over topics (a grid of a few blocks per SM), so table reads
// from device memory are per block, not per topic. A level's state is a
// bit set in the warp's shared memory: __ballot_sync assembles each 32-slot
// word, and the parent read is a shared-memory gather of one bit (the state
// is at most 16 words, one bank each, so it is conflict-free). Emitted rows
// are OR'd into a per-topic word buffer in shared memory (one ballot per
// 32 emitter slots, at most two words touched) and written out coalesced.
// A level walks only its real slots (width[l], rounded up to whole warps),
// and a topic stops at the first level whose state is empty: nothing below
// an inactive slot can match.
//
// What bounds it on an H100: integer operations. Per topic the work the
// function needs is about 4 INT32 operations for every real slot of every
// level walked (compare, wildcard OR, parent bit, AND), one more for every
// emitter slot and a few per level, against ~4 bytes of token per level read
// and 4 * n_words bytes written, so operations, not bytes, set the floor
// (chip_smoke.py counts both).
//
// Interface: a plain C function (no PyTorch headers) launched on the caller's
// stream; it returns cudaGetLastError() so the Python wrapper can raise.
// Words are written as uint32 into an int32 tensor.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int PLUS = -2;
constexpr int HASH = -3;
constexpr int WARPS_PER_BLOCK = 8;
constexpr int MAX_STATE_WORDS = 16;  // 512 slots
constexpr int MAX_ROW_WORDS = 64;    // 2048 rows
constexpr unsigned FULL_MASK = 0xFFFFFFFFu;

__host__ __device__ constexpr size_t smem_bytes(int n_levels, int slots) {
  return static_cast<size_t>(n_levels) * slots * 4 * 2   // child_tok, parent
         + static_cast<size_t>(n_levels) * 3 * 4        // width, n_emit, base
         + WARPS_PER_BLOCK * 2 * MAX_STATE_WORDS * 4    // state, two buffers
         + WARPS_PER_BLOCK * MAX_ROW_WORDS * 4          // emitted rows
         + static_cast<size_t>(n_levels) * slots;       // emit_exact
}

__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
    dense_walk_kernel(const int32_t* __restrict__ toks, long long ld_toks,
                      int n_tok_cols, const int32_t* __restrict__ lengths,
                      const uint8_t* __restrict__ dollar,
                      const int32_t* __restrict__ child_tok,
                      const int32_t* __restrict__ parent_idx,
                      const uint8_t* __restrict__ emit_exact,
                      const int32_t* __restrict__ meta, int n_levels,
                      int slots, int batch, int n_words, int row_words,
                      uint32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int table = n_levels * slots;
  int32_t* s_ct = reinterpret_cast<int32_t*>(smem);
  int32_t* s_par = s_ct + table;
  int32_t* s_meta = s_par + table;  // [3][n_levels]
  uint32_t* s_state = reinterpret_cast<uint32_t*>(s_meta + 3 * n_levels);
  uint32_t* s_rows = s_state + WARPS_PER_BLOCK * 2 * MAX_STATE_WORDS;
  uint8_t* s_exact =
      reinterpret_cast<uint8_t*>(s_rows + WARPS_PER_BLOCK * MAX_ROW_WORDS);

  for (int i = threadIdx.x; i < table; i += blockDim.x) {
    s_ct[i] = __ldg(child_tok + i);
    s_par[i] = __ldg(parent_idx + i);
    s_exact[i] = __ldg(emit_exact + i);
  }
  for (int i = threadIdx.x; i < 3 * n_levels; i += blockDim.x)
    s_meta[i] = __ldg(meta + i);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t* state = s_state + warp * 2 * MAX_STATE_WORDS;
  uint32_t* rows = s_rows + warp * MAX_ROW_WORDS;
  for (int w = lane; w < MAX_ROW_WORDS; w += 32) rows[w] = 0u;
  __syncwarp();

  const int stride = gridDim.x * WARPS_PER_BLOCK;
  for (int b = blockIdx.x * WARPS_PER_BLOCK + warp; b < batch; b += stride) {
    // per-topic values are warp-uniform, so every branch on them is too
    const int len = __ldg(lengths + b);
    const bool dol = __ldg(dollar + b) != 0;
    const int32_t* trow = toks + static_cast<size_t>(b) * ld_toks;
    const uint32_t* prev = state;
    uint32_t* cur = state + MAX_STATE_WORDS;
    for (int l = 0; l < n_levels; ++l) {
      const int tok = l < n_tok_cols ? __ldg(trow + l) : -1;
      const int width = s_meta[l];
      const int n_emit = s_meta[n_levels + l];
      const int emit_base = s_meta[2 * n_levels + l];
      const bool at_end = len == l + 1;
      const bool wild_ok = !(l == 0 && dol);
      const int32_t* ct_l = s_ct + l * slots;
      const int32_t* par_l = s_par + l * slots;
      const uint8_t* ex_l = s_exact + l * slots;
      uint32_t any = 0u;
      for (int k0 = 0; k0 < width; k0 += 32) {
        const int j = k0 + lane;  // < slots: slots is a multiple of 32
        const int ct = ct_l[j];
        bool parent = true;
        if (l > 0) {
          const int p = par_l[j];
          parent = (prev[p >> 5] >> (p & 31)) & 1u;
        }
        const bool wild =
            wild_ok && ((ct == PLUS && tok >= 0) || ct == HASH);
        const bool bit = parent && (tok == ct || wild);
        const uint32_t word = __ballot_sync(FULL_MASK, bit);
        if (lane == 0) cur[k0 >> 5] = word;
        any |= word;
        if (k0 < n_emit) {  // warp-uniform: this word holds emitter slots
          const bool emit = bit && j < n_emit && (at_end || ex_l[j] == 0);
          const uint32_t em = __ballot_sync(FULL_MASK, emit);
          if (lane == 0 && em != 0u) {
            const int r = emit_base + k0;
            const int w = r >> 5, sh = r & 31;
            rows[w] |= em << sh;
            if (sh != 0 && (em >> (32 - sh)) != 0u)
              rows[w + 1] |= em >> (32 - sh);
          }
        }
      }
      __syncwarp();  // this level's state and rows are visible to all lanes
      if (any == 0u) break;  // warp-uniform: nothing deeper can match
      const uint32_t* next_prev = cur;
      cur = const_cast<uint32_t*>(prev);
      prev = next_prev;
    }
    uint32_t* dst = out + static_cast<size_t>(b) * n_words;
    for (int w = lane; w < n_words; w += 32) {
      uint32_t v = 0u;
      if (w < row_words) {
        v = rows[w];
        rows[w] = 0u;  // each lane clears the words it wrote out
      }
      dst[w] = v;
    }
    __syncwarp();  // cleared before lane 0 ORs the next topic's rows
  }
}

}  // namespace

extern "C" int dense_walk_launch(const void* toks, long long ld_toks,
                                 int n_tok_cols, const void* lengths,
                                 const void* dollar, const void* child_tok,
                                 const void* parent_idx,
                                 const void* emit_exact, const void* meta,
                                 int n_levels, int slots, int batch,
                                 int n_words, int row_words, void* out,
                                 void* stream) {
  if (batch <= 0) return static_cast<int>(cudaGetLastError());
  if (slots <= 0 || slots % 32 != 0 || slots > 32 * MAX_STATE_WORDS ||
      row_words > MAX_ROW_WORDS || row_words > n_words || n_levels <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(n_levels, slots);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(dense_walk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, dense_walk_kernel, WARPS_PER_BLOCK * 32, smem)) !=
          cudaSuccess)
    return static_cast<int>(err);
  if (per_sm <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long needed =
      (static_cast<long long>(batch) + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  const long long cap = static_cast<long long>(sms) * per_sm;
  const int blocks = static_cast<int>(needed < cap ? needed : cap);
  dense_walk_kernel<<<blocks, WARPS_PER_BLOCK * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(toks), ld_toks, n_tok_cols,
      static_cast<const int32_t*>(lengths),
      static_cast<const uint8_t*>(dollar),
      static_cast<const int32_t*>(child_tok),
      static_cast<const int32_t*>(parent_idx),
      static_cast<const uint8_t*>(emit_exact),
      static_cast<const int32_t*>(meta), n_levels, slots, batch, n_words,
      row_words, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dense_walk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
