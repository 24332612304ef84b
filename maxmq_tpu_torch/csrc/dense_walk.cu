// dense_walk: the dense leveled trie walk of the dense matcher, with the
// packing of its matched rows into words and the sparse extract of the
// nonzero words fused in.
//
// Replaces the JAX package's Pallas kernel K4,
//   maxmq_tpu/matching/pallas_kernel.py  _make_kernel (pallas_call at :206),
// and the two XLA steps that follow it there (maxmq_tpu/matching/dense.py
// pack_and_extract: the [B, R] -> uint32 words pack, then the top_k extract of
// the nonzero words).
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
//   word w of the topic = bits of rows 32w .. 32w+31 (bit i = row 32w + i);
//   then the extract:
//     word_idx[b, k], word_val[b, k] = the k-th nonzero word in ascending w
//       (its index and bits) for k < max_words, else -1 and 0;
//     overflow[b] = lengths[b] < 0 || number of nonzero words > max_words.
// Padding slots (child_tok NEVER) match nothing. Bucket pad topics (length 0,
// all tokens -1) do match root '#' rows; the caller trims them, as the
// reference does. Too-deep topics walk like any other (their words are
// extracted and their overflow flag is set). This is the Pallas kernel's
// function: its one-hot product s @ E_l selects exactly
// s_{l-1}[parent_idx[l][j]] (and at level 0, with s all ones, 1 for every
// real slot), followed by the reference's pack and top_k.
//
// What bounds it on an H100: integer operations. Per topic the work the
// function needs is about 4 INT32 operations for every real slot of every
// level walked (compare, wildcard OR, parent bit, AND), one more for every
// emitter slot, a few per level and one per nonzero word, against ~4 bytes of
// token per level read and 8 * max_words + 1 bytes written, so operations,
// not bytes, set the floor (chip_smoke.py counts both).
//
// Design. A lane owns one topic and a warp walks 32 topics through the same
// slots in lockstep, so every table value is a shared-memory broadcast that
// serves 32 topics:
//   - The block stages the tables once in shared memory: per slot one 16-byte
//     entry {child_tok, parent word offset, parent bit mask, 0} (the parent
//     index pre-split on the host so the gather needs no shifts), and per
//     32-slot chunk the masks of its '+' slots, '#' slots and at_end-gated
//     emitter slots. Warps loop over groups of 32 topics (a grid of a few
//     blocks per SM).
//   - A topic's level state is a bit set in the warp's shared memory, laid
//     out [word][lane] so that every lane's read of its own parent word is
//     conflict-free. Per slot a lane reads its parent word, tests the bit
//     and compares its token, accumulating a parent word and a match word for
//     the chunk in registers; then
//       state = match | (parent & ((plus_mask & '+' on) | (hash_mask & '#'
//               on)))
//     and the emitter word is state & (at_end ? ~0 : ~exact_mask) over the
//     chunk's emitter slots — no ballot, no second table read.
//   - The extract is streamed: rows come out in ascending order (levels emit
//     consecutive row ranges, chunks ascend), so a lane keeps one open word
//     (index, bits), ORs each emitter word into it (at most two words a
//     chunk), and when a higher word opens it ranks the closed one and, while
//     fewer than max_words are out, writes its (index, bits) pair. At the end
//     the warp pads each of its 32 topics' output rows with -1 / 0,
//     coalesced. The [B, n_words] word matrix is never written.
//   - A level walks only its real slots (width[l], rounded up to whole
//     chunks), and a warp stops at the first level where all 32 of its
//     topics' states are empty: nothing below an inactive slot can match.
//
// Interface: a plain C function (no PyTorch headers) launched on the caller's
// stream; it returns cudaGetLastError() so the Python wrapper can raise.
// Words are written as uint32 into an int32 tensor.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS_PER_BLOCK = 8;
constexpr int MAX_STATE_WORDS = 16;  // 512 slots
constexpr unsigned FULL_MASK = 0xFFFFFFFFu;

__host__ __device__ constexpr size_t smem_bytes(int n_levels, int slots) {
  return static_cast<size_t>(n_levels) * slots * 16          // slot entries
         + static_cast<size_t>(n_levels) * (slots / 32) * 16 // chunk masks
         + WARPS_PER_BLOCK * 2 * MAX_STATE_WORDS * 32 * 4    // states
         + static_cast<size_t>(n_levels) * 3 * 4;            // meta
}

// The open output word of one lane's topic (the streamed extract).
struct Extract {
  int idx;       // word index of the open word, -1 = none
  uint32_t val;  // its bits
  int n;         // nonzero words closed so far
  int32_t* out_idx;
  int32_t* out_val;
  int max_words;

  __device__ __forceinline__ void close() {
    if (idx >= 0) {
      if (n < max_words) {
        out_idx[n] = idx;
        out_val[n] = static_cast<int32_t>(val);
      }
      ++n;
    }
  }
  // OR bits v into word r; r never decreases between calls
  __device__ __forceinline__ void add(int r, uint32_t v) {
    if (v == 0u) return;
    if (r != idx) {
      close();
      idx = r;
      val = 0u;
    }
    val |= v;
  }
};

__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
    dense_walk_kernel(const int32_t* __restrict__ toks, long long ld_toks,
                      int n_tok_cols, const int32_t* __restrict__ lengths,
                      const uint8_t* __restrict__ dollar,
                      const int4* __restrict__ slot_tab,
                      const uint4* __restrict__ chunk_masks,
                      const int32_t* __restrict__ meta, int n_levels,
                      int slots, int batch, int max_words,
                      int32_t* __restrict__ word_idx,
                      int32_t* __restrict__ word_val,
                      uint8_t* __restrict__ overflow) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int chunks = slots / 32;
  const int table = n_levels * slots;
  int4* s_tab = reinterpret_cast<int4*>(smem);
  uint4* s_mask = reinterpret_cast<uint4*>(s_tab + table);
  uint32_t* s_state =
      reinterpret_cast<uint32_t*>(s_mask + n_levels * chunks);
  int32_t* s_meta = reinterpret_cast<int32_t*>(
      s_state + WARPS_PER_BLOCK * 2 * MAX_STATE_WORDS * 32);  // [3][n_levels]

  for (int i = threadIdx.x; i < table; i += blockDim.x)
    s_tab[i] = __ldg(slot_tab + i);
  for (int i = threadIdx.x; i < n_levels * chunks; i += blockDim.x)
    s_mask[i] = __ldg(chunk_masks + i);
  for (int i = threadIdx.x; i < 3 * n_levels; i += blockDim.x)
    s_meta[i] = __ldg(meta + i);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // this lane's two state buffers: word w of a buffer at [w * 32 + lane]
  uint32_t* const buf0 = s_state + warp * 2 * MAX_STATE_WORDS * 32 + lane;
  uint32_t* const buf1 = buf0 + MAX_STATE_WORDS * 32;

  const int stride = gridDim.x * WARPS_PER_BLOCK * 32;
  for (int base = (blockIdx.x * WARPS_PER_BLOCK + warp) * 32; base < batch;
       base += stride) {
    const int b = base + lane;
    const bool exists = b < batch;
    const int len = exists ? __ldg(lengths + b) : 0;
    const bool dol = exists && __ldg(dollar + b) != 0;
    const int32_t* trow = toks + static_cast<size_t>(exists ? b : 0) * ld_toks;
    Extract ex;
    ex.idx = -1;
    ex.val = 0u;
    ex.n = 0;
    ex.out_idx = word_idx + static_cast<size_t>(b) * max_words;
    ex.out_val = word_val + static_cast<size_t>(b) * max_words;
    ex.max_words = exists ? max_words : 0;  // a missing topic writes nothing

    // the root: every level-0 slot's parent reads as active
#pragma unroll
    for (int w = 0; w < MAX_STATE_WORDS; ++w) buf0[w * 32] = FULL_MASK;
    const unsigned char* prev = reinterpret_cast<const unsigned char*>(buf0);
    uint32_t* cur = buf1;
    bool alive = exists;
    for (int l = 0; l < n_levels; ++l) {
      if (!__any_sync(FULL_MASK, alive)) break;  // nothing deeper can match
      const int tok = (exists && l < n_tok_cols) ? __ldg(trow + l) : -1;
      const bool wild_ok = !(l == 0 && dol);
      const uint32_t plus_on = (wild_ok && tok >= 0) ? FULL_MASK : 0u;
      const uint32_t hash_on = wild_ok ? FULL_MASK : 0u;
      const uint32_t any_emit = (len == l + 1) ? FULL_MASK : 0u;
      const int width = s_meta[l];
      const int n_emit = s_meta[n_levels + l];
      const int emit_base = s_meta[2 * n_levels + l];
      const int4* tab = s_tab + l * slots;
      const uint4* mask = s_mask + l * chunks;
      uint32_t any = 0u;
      for (int c = 0; c * 32 < width; ++c) {
        uint32_t par = 0u, eq = 0u;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int4 e = tab[c * 32 + i];  // broadcast
          const uint32_t pw =
              *reinterpret_cast<const uint32_t*>(prev + e.y);
          const bool p = (pw & static_cast<uint32_t>(e.z)) != 0u;
          par |= p ? (1u << i) : 0u;
          eq |= (p && tok == e.x) ? (1u << i) : 0u;
        }
        const uint4 m = mask[c];  // {'+', '#', exact, 0}
        const uint32_t word = eq | (par & ((m.x & plus_on) | (m.y & hash_on)));
        cur[c * 32] = word;
        any |= word;
        const int left = n_emit - c * 32;
        if (left > 0) {  // uniform: this chunk holds emitter slots
          const uint32_t emitters = left >= 32 ? FULL_MASK : (1u << left) - 1u;
          const uint32_t em = word & emitters & (any_emit | ~m.z);
          const int r = (emit_base >> 5) + c, sh = emit_base & 31;
          ex.add(r, em << sh);
          if (sh != 0) ex.add(r + 1, em >> (32 - sh));
        }
      }
      alive = any != 0u;
      uint32_t* next = const_cast<uint32_t*>(
          reinterpret_cast<const uint32_t*>(prev));
      prev = reinterpret_cast<const unsigned char*>(cur);
      cur = next;
    }
    ex.close();
    if (exists) overflow[b] = (len < 0 || ex.n > max_words) ? 1 : 0;
    // pad every topic's row past its pairs, the warp writing one row at a time
    for (int t = 0; t < 32; ++t) {
      const int n_t = __shfl_sync(FULL_MASK, ex.n, t);
      if (base + t >= batch) break;  // uniform
      const size_t row = static_cast<size_t>(base + t) * max_words;
      for (int k = lane; k < max_words; k += 32) {
        if (k >= n_t) {
          word_idx[row + k] = -1;
          word_val[row + k] = 0;
        }
      }
    }
  }
}

// Blocks of one launch (a persistent grid: at most what the SMs hold at
// once), or a negative CUDA error code.
int grid_blocks(int n_levels, int slots, int batch) {
  const size_t smem = smem_bytes(n_levels, slots);
  cudaError_t err;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(dense_walk_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem))) != cudaSuccess)
    return -static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, dense_walk_kernel, WARPS_PER_BLOCK * 32, smem)) !=
          cudaSuccess)
    return -static_cast<int>(err);
  if (per_sm <= 0) return -static_cast<int>(cudaErrorInvalidConfiguration);
  const long long per_block = WARPS_PER_BLOCK * 32;
  const long long needed =
      (static_cast<long long>(batch) + per_block - 1) / per_block;
  const long long cap = static_cast<long long>(sms) * per_sm;
  return static_cast<int>(needed < cap ? needed : cap);
}

}  // namespace

extern "C" int dense_walk_blocks(int n_levels, int slots, int batch) {
  return grid_blocks(n_levels, slots, batch);
}

extern "C" int dense_walk_launch(const void* toks, long long ld_toks,
                                 int n_tok_cols, const void* lengths,
                                 const void* dollar, const void* slot_tab,
                                 const void* chunk_masks, const void* meta,
                                 int n_levels, int slots, int batch,
                                 int max_words, void* word_idx,
                                 void* word_val, void* overflow,
                                 void* stream) {
  if (batch <= 0) return static_cast<int>(cudaGetLastError());
  if (slots <= 0 || slots % 32 != 0 || slots > 32 * MAX_STATE_WORDS ||
      n_levels <= 0 || max_words <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = grid_blocks(n_levels, slots, batch);
  if (blocks < 0) return -blocks;
  const size_t smem = smem_bytes(n_levels, slots);
  dense_walk_kernel<<<blocks, WARPS_PER_BLOCK * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(toks), ld_toks, n_tok_cols,
      static_cast<const int32_t*>(lengths),
      static_cast<const uint8_t*>(dollar),
      static_cast<const int4*>(slot_tab),
      static_cast<const uint4*>(chunk_masks),
      static_cast<const int32_t*>(meta), n_levels, slots, batch, max_words,
      static_cast<int32_t*>(word_idx), static_cast<int32_t*>(word_val),
      static_cast<uint8_t*>(overflow));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dense_walk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
