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
// set the floor (chip_smoke.py counts one compare a plane pass).
//
// Design. A lane owns two topics; a block's threads walk the same words in
// lockstep, so every plane value read from shared memory is a broadcast that
// serves the whole block's topics (up to 512). Batches too small to give
// every SM a block that way (the service's 256 topics) give each topic eight
// lanes instead (LANES_PER_TOPIC), each comparing four of every word's
// planes (two of the 16-bit ones), a ballot ORing their verdicts: 16x the
// warps and shorter compare chains for the same batch.
//   - Plane tiles of TILE_WORDS words x 32 (or 16) planes are copied from the
//     L2-resident table into shared memory with cp.async, double buffered,
//     one tile ahead of the compare. Each word's planes are stored rotated by
//     the word's index, which makes the staging stores conflict-free; the
//     first phase ORs over all of a word's planes, so their order is free.
//     The plane table is read once per block instead of once per 8 topics.
//   - Phase one decides only whether a word is nonzero for a topic: an OR of
//     sig_exp == plane over the 32 planes (an ISETP.EQ.OR predicate chain,
//     one instruction a plane), or for packed 16-bit planes the
//     OR-accumulated zero-lane detect acc |= (x - 0x00010001) & ~x, masked
//     with 0x80008000 once after the word. That mask test is nonzero exactly
//     when the exact SWAR word is (each plane's bit 15/31 survives the OR),
//     so F5's fake high-lane bit keeps its effect.
//   - A nonzero word's index goes to the topic's next row slot (while the
//     count is <= max_rows); past max_rows the topic has overflowed and its
//     compares no longer matter. A block stops at the first tile barrier
//     where all its topics have overflowed.
//   - Phase two, after the walk, rebuilds the exact match word of each kept
//     word (at most max_rows a topic, planes read from L2): a multi-bit word
//     overflows the topic, else the slot gets (w << 5) | highest bit. Only
//     overflow depends on the order in which the conditions are found, and
//     overflow is their OR, so deferring the multi-bit test changes nothing.
// Topic state is per lane; the only divergent code is the rare nonzero-word
// store and phase two. The sig_exp gather is reloaded only when the word's
// group changes (a warp-uniform test: groups are runs of words).
//
// Interface: a plain C function (no PyTorch headers) launched on the caller's
// stream; it returns cudaGetLastError() so the Python wrapper can raise.
// Tensors arrive as int32 carrying uint32 bits and are read as uint32 here.
// The wrapper picks the lanes per topic and warps per block so that small
// batches still spread over the card's SMs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE_WORDS = 32;
constexpr int MAX_WARPS = 8;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The exact match word of one word for signature value s (phase two).
template <int NPLANES>
__device__ __forceinline__ uint32_t exact_word(uint32_t s,
                                               const uint32_t* __restrict__ p,
                                               long long ld) {
  uint32_t acc = 0;
  if constexpr (NPLANES == 32) {
#pragma unroll
    for (int j = 0; j < 32; ++j)
      acc |= static_cast<uint32_t>(s == __ldg(p + j * ld)) << j;
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint32_t x = s ^ __ldg(p + j * ld);
      acc |= ((x - 0x00010001u) & ~x & 0x80008000u) >> (15 - j);
    }
  }
  return acc;
}

template <int TOPICS_PER_THREAD>
struct Topics {
  int b[TOPICS_PER_THREAD];     // topic index (may be >= batch)
  int count[TOPICS_PER_THREAD]; // nonzero words so far; > max_rows = overflow
  uint32_t s[TOPICS_PER_THREAD];
};

// Stage one tile: TILE_WORDS words x NPLANES planes (rotated by word) and the
// words' groups.
template <int NPLANES>
__device__ __forceinline__ void stage_tile(uint32_t* __restrict__ tile,
                                           int32_t* __restrict__ grp,
                                           const uint32_t* __restrict__ planes,
                                           long long ld, int w0, int valid,
                                           const int32_t* __restrict__ gsrc,
                                           int tid, int nthreads) {
  for (int e = tid; e < NPLANES * TILE_WORDS; e += nthreads) {
    const int j = e / TILE_WORDS, i = e % TILE_WORDS;
    if (i < valid)
      cp_async4(tile + i * NPLANES + ((j + i) & (NPLANES - 1)),
                planes + j * ld + w0 + i);
  }
  if (tid < valid) cp_async4(grp + tid, gsrc + w0 + tid);
}

// Phase one for one word and one topic on eight lanes: this lane's slice
// (4 of 32 planes, 2 of 16) of the word's staged planes.
template <int NPLANES>
__device__ __forceinline__ bool slice_hit(const uint32_t* __restrict__ row,
                                          uint32_t s, int sub) {
  if constexpr (NPLANES == 32) {
    const uint4 p = *reinterpret_cast<const uint4*>(row + sub * 4);
    return s == p.x || s == p.y || s == p.z || s == p.w;
  } else {
    const uint2 p = *reinterpret_cast<const uint2*>(row + sub * 2);
    const uint32_t x = s ^ p.x, y = s ^ p.y;
    return ((((x - 0x00010001u) & ~x) | ((y - 0x00010001u) & ~y)) &
            0x80008000u) != 0u;
  }
}

// Phase one for one word and a lane's own topics: all of the word's staged
// planes, two independent accumulators a topic.
template <int NPLANES, int TOPICS_PER_THREAD>
__device__ __forceinline__ void wide_hits(const uint32_t* __restrict__ row,
                                          const Topics<TOPICS_PER_THREAD>& tp,
                                          bool (&hit)[TOPICS_PER_THREAD]) {
  const uint4* r4 = reinterpret_cast<const uint4*>(row);
  if constexpr (NPLANES == 32) {
    bool h0[TOPICS_PER_THREAD], h1[TOPICS_PER_THREAD];
#pragma unroll
    for (int k = 0; k < TOPICS_PER_THREAD; ++k) h0[k] = h1[k] = false;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const uint4 p = r4[c];
#pragma unroll
      for (int k = 0; k < TOPICS_PER_THREAD; ++k) {
        const uint32_t s = tp.s[k];
        h0[k] = h0[k] || s == p.x;
        h1[k] = h1[k] || s == p.y;
        h0[k] = h0[k] || s == p.z;
        h1[k] = h1[k] || s == p.w;
      }
    }
#pragma unroll
    for (int k = 0; k < TOPICS_PER_THREAD; ++k) hit[k] = h0[k] || h1[k];
  } else {
    uint32_t a0[TOPICS_PER_THREAD], a1[TOPICS_PER_THREAD];
#pragma unroll
    for (int k = 0; k < TOPICS_PER_THREAD; ++k) a0[k] = a1[k] = 0u;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint4 p = r4[c];
#pragma unroll
      for (int k = 0; k < TOPICS_PER_THREAD; ++k) {
        const uint32_t s = tp.s[k];
        uint32_t x = s ^ p.x;
        a0[k] |= (x - 0x00010001u) & ~x;
        x = s ^ p.y;
        a1[k] |= (x - 0x00010001u) & ~x;
        x = s ^ p.z;
        a0[k] |= (x - 0x00010001u) & ~x;
        x = s ^ p.w;
        a1[k] |= (x - 0x00010001u) & ~x;
      }
    }
#pragma unroll
    for (int k = 0; k < TOPICS_PER_THREAD; ++k)
      hit[k] = ((a0[k] | a1[k]) & 0x80008000u) != 0u;
  }
}

// A nonzero word w of topic k (rare): its index goes to the topic's next row
// slot while the count is within max_rows; `writer` is the one lane of the
// topic that stores.
template <int TOPICS_PER_THREAD>
__device__ __forceinline__ void record(Topics<TOPICS_PER_THREAD>& tp, int k,
                                       bool hit, int w, bool writer,
                                       int batch, int max_rows,
                                       int32_t* __restrict__ rows) {
  if (!hit) return;
  const int c = tp.count[k];
  if (c < max_rows && tp.b[k] < batch && writer)
    rows[static_cast<size_t>(tp.b[k]) * max_rows + c] = w;
  tp.count[k] = c + 1;
}

// Phase one over one single-width word region. Returns false when every topic
// of the block has overflowed (all threads return the same value).
template <int NPLANES, int TOPICS_PER_THREAD, int LANES_PER_TOPIC>
__device__ bool walk_region(uint32_t (*tiles)[TILE_WORDS * 32],
                            int32_t (*grps)[TILE_WORDS],
                            const uint32_t* __restrict__ planes, long long ld,
                            int n_region, int word_base,
                            const int32_t* __restrict__ grp_of_word,
                            const uint32_t* __restrict__ sig, int n_groups,
                            int batch, int max_rows, int32_t* __restrict__ rows,
                            Topics<TOPICS_PER_THREAD>& tp, int tid,
                            int nthreads) {
  static_assert((LANES_PER_TOPIC == 1 && TOPICS_PER_THREAD == 2) ||
                    (LANES_PER_TOPIC == 8 && TOPICS_PER_THREAD == 1),
                "two topics a lane, or eight lanes a topic");
  if (n_region <= 0) return true;
  const int n_tiles = (n_region + TILE_WORDS - 1) / TILE_WORDS;
  const int32_t* gsrc = grp_of_word + word_base;
  stage_tile<NPLANES>(tiles[0], grps[0], planes, ld, 0,
                      min(TILE_WORDS, n_region), gsrc, tid, nthreads);
  cp_async_commit();
  int g_cur = -1;
  bool alive = true;
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      const int w1 = (t + 1) * TILE_WORDS;
      stage_tile<NPLANES>(tiles[(t + 1) & 1], grps[(t + 1) & 1], planes, ld,
                          w1, min(TILE_WORDS, n_region - w1), gsrc, tid,
                          nthreads);
    }
    cp_async_commit();  // possibly empty: keeps wait_group<1> exact
    cp_async_wait<1>();
    __syncthreads();
    const uint32_t* tile = tiles[t & 1];
    const int32_t* grp = grps[t & 1];
    const int w0 = t * TILE_WORDS;
    const int valid = min(TILE_WORDS, n_region - w0);
    bool mine = false;
#pragma unroll
    for (int k = 0; k < TOPICS_PER_THREAD; ++k)
      mine |= tp.b[k] < batch && tp.count[k] <= max_rows;
    if (__any_sync(0xFFFFFFFFu, mine)) {  // warp-uniform skip
      for (int i = 0; i < valid; ++i) {
        const int g = grp[i];
        if (g != g_cur) {  // uniform: every lane reads the same word
          g_cur = g;
#pragma unroll
          for (int k = 0; k < TOPICS_PER_THREAD; ++k)
            tp.s[k] = tp.b[k] < batch
                          ? __ldg(sig + static_cast<size_t>(tp.b[k]) *
                                            n_groups + g)
                          : 0u;
        }
        const int w = word_base + w0 + i;
        if constexpr (LANES_PER_TOPIC > 1) {
          // eight lanes share a topic, each comparing its slice of the
          // word's planes; a ballot ORs the slices
          const int group = tid & 31 & ~7;  // the topic's first lane
          const int sub = tid & 7;          // this lane's slice of the planes
          const unsigned bal = __ballot_sync(
              0xFFFFFFFFu, slice_hit<NPLANES>(tile + i * NPLANES, tp.s[0],
                                              sub));
          record(tp, 0, ((bal >> group) & 0xFFu) != 0u, w, sub == 0, batch,
                 max_rows, rows);
        } else {
          bool hit[TOPICS_PER_THREAD];
          wide_hits<NPLANES>(tile + i * NPLANES, tp, hit);
#pragma unroll
          for (int k = 0; k < TOPICS_PER_THREAD; ++k)
            record(tp, k, hit[k], w, true, batch, max_rows, rows);
        }
      }
    }
    bool still = false;
#pragma unroll
    for (int k = 0; k < TOPICS_PER_THREAD; ++k)
      still |= tp.b[k] < batch && tp.count[k] <= max_rows;
    // every thread reaches this barrier, overflowed or not; it also keeps the
    // next iteration's staging from overwriting the tile still being read
    alive = __syncthreads_or(still) != 0;
    if (!alive) break;
  }
  cp_async_wait<0>();  // no copy may land after the buffers are reused
  __syncthreads();
  return alive;
}

template <int TOPICS_PER_THREAD, int LANES_PER_TOPIC>
__global__ void __launch_bounds__(MAX_WARPS * 32)
    sig_match_fixed_kernel(const uint32_t* __restrict__ sig, int n_groups,
                           const uint8_t* __restrict__ too_deep,
                           const int32_t* __restrict__ grp_of_word,
                           const uint32_t* __restrict__ planes32,
                           long long ld32, int n_words32,
                           const uint32_t* __restrict__ planes16,
                           long long ld16, int n_words16, int batch,
                           int max_rows, uint8_t* __restrict__ counts,
                           int32_t* __restrict__ rows) {
  __shared__ __align__(16) uint32_t tiles[2][TILE_WORDS * 32];
  __shared__ int32_t grps[2][TILE_WORDS];
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int slots = nthreads / LANES_PER_TOPIC;  // topics a block row
  const int b0 = blockIdx.x * slots * TOPICS_PER_THREAD;
  const int sub = tid % LANES_PER_TOPIC;

  Topics<TOPICS_PER_THREAD> tp;
#pragma unroll
  for (int k = 0; k < TOPICS_PER_THREAD; ++k) {
    const int b = b0 + k * slots + tid / LANES_PER_TOPIC;
    tp.b[k] = b;
    // a too-deep topic starts overflowed: it stores nothing
    tp.count[k] = (b < batch && too_deep[b] != 0) ? max_rows + 1 : 0;
    tp.s[k] = 0u;
  }
  constexpr int T = TOPICS_PER_THREAD, L = LANES_PER_TOPIC;
  if (walk_region<32, T, L>(tiles, grps, planes32, ld32, n_words32, 0,
                            grp_of_word, sig, n_groups, batch, max_rows, rows,
                            tp, tid, nthreads))
    walk_region<16, T, L>(tiles, grps, planes16, ld16, n_words16, n_words32,
                          grp_of_word, sig, n_groups, batch, max_rows, rows,
                          tp, tid, nthreads);

  // phase two: the exact words of the kept slots, then the padding
#pragma unroll
  for (int k = 0; k < TOPICS_PER_THREAD; ++k) {
    const int b = tp.b[k];
    if (b >= batch || sub != 0) continue;
    int32_t* r = rows + static_cast<size_t>(b) * max_rows;
    bool over = tp.count[k] > max_rows;
    const int kept = over ? 0 : tp.count[k];
    for (int c = 0; c < kept; ++c) {
      const int w = r[c];
      const uint32_t s =
          __ldg(sig + static_cast<size_t>(b) * n_groups + grp_of_word[w]);
      const uint32_t acc =
          w < n_words32 ? exact_word<32>(s, planes32 + w, ld32)
                        : exact_word<16>(s, planes16 + (w - n_words32), ld16);
      if (acc & (acc - 1u)) {
        over = true;
        break;
      }
      r[c] = static_cast<int32_t>((static_cast<uint32_t>(w) << 5) |
                                  (31 - __clz(acc)));
    }
    for (int c = over ? 0 : kept; c < max_rows; ++c) r[c] = -1;
    counts[b] = over ? 0xFF : static_cast<uint8_t>(tp.count[k]);
  }
}

template <int TOPICS_PER_THREAD, int LANES_PER_TOPIC>
cudaError_t launch(const void* sig, int n_groups, const void* too_deep,
                   const void* grp_of_word, const void* planes32,
                   long long ld32, int n_words32, const void* planes16,
                   long long ld16, int n_words16, int batch, int max_rows,
                   int warps_per_block, void* counts, void* rows,
                   cudaStream_t stream) {
  const int threads = warps_per_block * 32;
  const int per_block = threads / LANES_PER_TOPIC * TOPICS_PER_THREAD;
  const int blocks = (batch + per_block - 1) / per_block;
  sig_match_fixed_kernel<TOPICS_PER_THREAD, LANES_PER_TOPIC>
      <<<blocks, threads, 0, stream>>>(
          static_cast<const uint32_t*>(sig), n_groups,
          static_cast<const uint8_t*>(too_deep),
          static_cast<const int32_t*>(grp_of_word),
          static_cast<const uint32_t*>(planes32), ld32, n_words32,
          static_cast<const uint32_t*>(planes16), ld16, n_words16, batch,
          max_rows, static_cast<uint8_t*>(counts),
          static_cast<int32_t*>(rows));
  return cudaGetLastError();
}

}  // namespace

// lanes_per_topic 1 runs two topics a thread (large batches), 8 runs one
// topic on eight lanes (small batches); warps_per_block 1..8. The wrapper
// picks both (sig_kernel.launch_shape).
extern "C" int sig_match_fixed_launch(
    const void* sig, int n_groups, const void* too_deep,
    const void* grp_of_word, const void* planes32, long long ld32,
    int n_words32, const void* planes16, long long ld16, int n_words16,
    int batch, int max_rows, int lanes_per_topic, int warps_per_block,
    void* counts, void* rows, void* stream) {
  if (batch <= 0) return static_cast<int>(cudaGetLastError());
  if (warps_per_block < 1 || warps_per_block > MAX_WARPS)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (lanes_per_topic == 1)
    return static_cast<int>(launch<2, 1>(
        sig, n_groups, too_deep, grp_of_word, planes32, ld32, n_words32,
        planes16, ld16, n_words16, batch, max_rows, warps_per_block, counts,
        rows, st));
  if (lanes_per_topic == 8)
    return static_cast<int>(launch<1, 8>(
        sig, n_groups, too_deep, grp_of_word, planes32, ld32, n_words32,
        planes16, ld16, n_words16, batch, max_rows, warps_per_block, counts,
        rows, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* sig_match_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
