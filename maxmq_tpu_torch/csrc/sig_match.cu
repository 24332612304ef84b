// sig_match_fixed: the fused signature-match kernel of the fixed-slot path.
//
// Replaces both TPU kernels of the JAX package's fixed path:
//   K1  maxmq_tpu/matching/sig_pallas.py  _chunk_kernel_select (masked-select
//       expansion, tables with <= 40 device groups)
//   K2  maxmq_tpu/matching/sig_pallas.py  _chunk_kernel_mxu (one-hot MXU
//       expansion, tables with > 40 device groups)
// and their cross-chunk merge (_merge_chunk_outputs). Both TPU expansions
// compute sig_exp[b, w] = sig[b, grp_of_word[w]] (the one-hot product is
// exact), so on this card both are one gather from the topic's signature
// row, and one kernel serves every group count.
//
// What it computes, per topic b (one launch per batch):
//   for every device word w (32 rows of one group), in ascending order —
//   the 32-bit region [0, n_words32) first, then the packed 16-bit region
//   [n_words32, n_words32 + n_words16) — the match word
//     32-bit: bit j set iff sig_exp == planes32[j][w]
//     16-bit: the SWAR zero-lane detect of x = sig_exp ^ planes16[j][w],
//             (x - 0x00010001) & ~x & 0x80008000, shifted right by 15 - j:
//             bits j (low lane, row 32w+j) and 16+j (high lane, row 32w+16+j)
//   then
//     overflow = too_deep[b] || any word with > 1 bit || nonzero words > max_rows
//     rows[b, k] = (w << 5) | (31 - clz(word)) for the first max_rows nonzero
//                  words in ascending w, slots past the count = -1 (0xFFFFFFFF)
//     counts[b]  = overflow ? 0xFF : number of nonzero words
//   and an overflow topic's row slots are all -1.
//
// Why one pass equals the Pallas path after its merge: every chunk kernel
// reports count 0xF (overflow) when its own chunk has a multi-bit word or more
// than max_rows nonzero words (or the topic is too deep), else min(count,
// max_rows) and its first max_rows encodings. _merge_chunk_outputs ORs the
// chunk overflows, sums the other chunks' counts and overflows again when the
// sum exceeds max_rows, then min-extracts the first max_rows encodings of the
// union. With max_rows <= 14 (the engine's bound) 0xF is never a real count,
// so the merged result is exactly: overflow = too deep OR any multi-bit word
// OR more than max_rows nonzero words in total; count = the total; rows = the
// first max_rows ascending encodings — what this single walk computes.
//
// The SWAR detect is reproduced as the TPU kernel does it, imprecision
// included: a borrow out of a zero low lane can fake the high-lane bit when
// hi ^ rep == 1, which makes the word multi-bit and overflows the topic. An
// exact per-lane compare would change counts.
//
// Padding: the kernel walks only real words, so the reference's padding
// columns (group -1 -> sig_exp 0, planes 0xFFFFFFFF, 16-bit lanes 0xFFFF)
// never exist here; they cannot produce a bit in the reference either.
// Group-padding rows inside real words keep their poison planes and are
// compared like any row, as in the reference.
//
// What bounds it on an H100: integer compare throughput. Per topic the work is
// 32 * n_words32 + 16 * n_words16 plane passes (about 98K at 1M subscriptions)
// against 4 * n_groups bytes of signature input, so operations, not bytes,
// set the floor. The design keeps plane traffic off that floor: each warp
// serves TOPICS_PER_WARP topics, and each lane loads its word's 32 (or 16)
// plane values into registers once per 32-word step and compares all of the
// warp's topics against them, so the plane table (390 KB of 32-bit planes at
// 1M subscriptions, resident in the 50 MB L2) is read once per warp instead
// of once per topic. A __ballot_sync per step orders extraction by lane (=
// ascending word) without a sort; a topic that overflows stops early.
//
// Interface: a plain C function (no PyTorch headers) launched on the caller's
// stream; it returns cudaGetLastError() so the Python wrapper can raise.
// Tensors arrive as int32 carrying uint32 bits and are read as uint32 here.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TOPICS_PER_WARP = 8;
constexpr int WARPS_PER_BLOCK = 4;
constexpr unsigned FULL_MASK = 0xFFFFFFFFu;

template <int NPLANES>
__device__ __forceinline__ uint32_t match_word(uint32_t s,
                                               const uint32_t (&p)[NPLANES]) {
  uint32_t acc = 0;
  if constexpr (NPLANES == 32) {
#pragma unroll
    for (int j = 0; j < 32; ++j) acc |= static_cast<uint32_t>(s == p[j]) << j;
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint32_t x = s ^ p[j];
      const uint32_t zero = (x - 0x00010001u) & ~x & 0x80008000u;
      acc |= zero >> (15 - j);
    }
  }
  return acc;
}

// Walk one single-width word region for the warp's topics. `live`, `count`
// and `over` are per-topic and uniform across the warp's lanes, so every
// branch on them is warp-uniform and the ballots see all 32 lanes.
template <int NPLANES>
__device__ __forceinline__ void walk_region(
    const uint32_t* __restrict__ planes, long long ld, int n_region,
    int word_base, const int32_t* __restrict__ grp_of_word,
    const uint32_t* __restrict__ sig, int n_groups, int b0, int max_rows,
    int32_t* __restrict__ rows, bool (&live)[TOPICS_PER_WARP],
    int (&count)[TOPICS_PER_WARP], bool (&over)[TOPICS_PER_WARP],
    int lane) {
  for (int w0 = 0; w0 < n_region; w0 += 32) {
    bool any_live = false;
#pragma unroll
    for (int t = 0; t < TOPICS_PER_WARP; ++t) any_live |= live[t];
    if (!any_live) return;
    const int w = w0 + lane;
    const bool in = w < n_region;
    uint32_t p[NPLANES];
    int g = -1;
    if (in) {
#pragma unroll
      for (int j = 0; j < NPLANES; ++j) p[j] = __ldg(planes + j * ld + w);
      g = __ldg(grp_of_word + word_base + w);
    }
    const uint32_t enc_base = static_cast<uint32_t>(word_base + w) << 5;
#pragma unroll
    for (int t = 0; t < TOPICS_PER_WARP; ++t) {
      if (!live[t]) continue;
      uint32_t acc = 0;
      if (in) {
        const uint32_t s =
            g >= 0 ? __ldg(sig + static_cast<size_t>(b0 + t) * n_groups + g)
                   : 0u;
        acc = match_word<NPLANES>(s, p);
      }
      const unsigned nz = __ballot_sync(FULL_MASK, acc != 0);
      if (nz == 0) continue;
      const bool multi = __any_sync(FULL_MASK, (acc & (acc - 1)) != 0);
      const int rank = count[t] + __popc(nz & ((1u << lane) - 1u));
      if (acc != 0 && rank < max_rows) {
        rows[static_cast<size_t>(b0 + t) * max_rows + rank] =
            static_cast<int32_t>(enc_base | (31 - __clz(acc)));
      }
      count[t] += __popc(nz);
      if (multi || count[t] > max_rows) {  // overflow: nothing else matters
        over[t] = true;
        live[t] = false;
      }
    }
  }
}

__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
    sig_match_fixed_kernel(const uint32_t* __restrict__ sig, int n_groups,
                           const uint8_t* __restrict__ too_deep,
                           const int32_t* __restrict__ grp_of_word,
                           const uint32_t* __restrict__ planes32,
                           long long ld32, int n_words32,
                           const uint32_t* __restrict__ planes16,
                           long long ld16, int n_words16, int batch,
                           int max_rows, uint8_t* __restrict__ counts,
                           int32_t* __restrict__ rows) {
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int b0 = warp * TOPICS_PER_WARP;
  if (b0 >= batch) return;  // warp-uniform

  bool live[TOPICS_PER_WARP];
  bool over[TOPICS_PER_WARP];
  int count[TOPICS_PER_WARP];
#pragma unroll
  for (int t = 0; t < TOPICS_PER_WARP; ++t) {
    const int b = b0 + t;
    const bool exists = b < batch;
    const bool deep = exists && too_deep[b] != 0;
    live[t] = exists && !deep;
    over[t] = deep;
    count[t] = 0;
  }
  walk_region<32>(planes32, ld32, n_words32, 0, grp_of_word, sig, n_groups,
                  b0, max_rows, rows, live, count, over, lane);
  walk_region<16>(planes16, ld16, n_words16, n_words32, grp_of_word, sig,
                  n_groups, b0, max_rows, rows, live, count, over, lane);

#pragma unroll
  for (int t = 0; t < TOPICS_PER_WARP; ++t) {
    const int b = b0 + t;
    if (b >= batch) break;
    const int kept = over[t] ? 0 : min(count[t], max_rows);
    for (int k = kept + lane; k < max_rows; k += 32)
      rows[static_cast<size_t>(b) * max_rows + k] = -1;
    if (lane == 0)
      counts[b] = over[t] ? 0xFF : static_cast<uint8_t>(count[t]);
  }
}

}  // namespace

extern "C" int sig_match_fixed_launch(
    const void* sig, int n_groups, const void* too_deep,
    const void* grp_of_word, const void* planes32, long long ld32,
    int n_words32, const void* planes16, long long ld16, int n_words16,
    int batch, int max_rows, void* counts, void* rows, void* stream) {
  if (batch <= 0) return static_cast<int>(cudaGetLastError());
  const int warps = (batch + TOPICS_PER_WARP - 1) / TOPICS_PER_WARP;
  const int blocks = (warps + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  sig_match_fixed_kernel<<<blocks, WARPS_PER_BLOCK * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(sig), n_groups,
      static_cast<const uint8_t*>(too_deep),
      static_cast<const int32_t*>(grp_of_word),
      static_cast<const uint32_t*>(planes32), ld32, n_words32,
      static_cast<const uint32_t*>(planes16), ld16, n_words16, batch,
      max_rows, static_cast<uint8_t*>(counts), static_cast<int32_t*>(rows));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sig_match_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
