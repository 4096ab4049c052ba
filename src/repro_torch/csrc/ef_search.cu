// Elias-Fano NextGEQ over one 128-value tile per cursor, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/ef_search/kernel.py:ef_search_blocks.
//
// Tile layout (repro_torch/kernels/ef_search/ops.py::ef_pack_blocks): the
// block's values rebased as r = value - block_base - 1 split into l low bits
// (`lo[tile, 128]`, uint16 widened to int32) and a unary high stream of 384
// bits: one 1-bit per lane at position high + lane, shipped as 24 16-bit
// words (`hi[tile, 24]`, widened to int32).  `lbits[tile]` is l (<= 15) and
// every high is <= 255.
//
// Contract (the one of decode_search): value = the smallest block docID
// >= probe (2^31 - 1 if none), rank = the count of block docIDs < probe.
// With rp = max(probe - base - 1, 0) the rank is #{lanes : r < rp}; a probe
// past the tile's high range (rp >> l > 255) therefore gives rank 128 and
// a probe <= base gives rank 0, as the TPU kernel's `hp > 255` and clip do.
//
// What bounds it: bytes.  A cursor reads 512 B of low bits, 96 B of high
// words (48 B of payload widened) and 16 B of row index, codec row, base
// and probe, and writes 8 B; the integer work is ~100 ops per lane, far
// below what the card could do in the time HBM takes to deliver the bytes.
//
// What the design does about it: one warp per cursor, 4 lanes per thread,
// one 16-byte load of low bits per thread and one 8-byte load of high
// words on each of the first 12 threads.  The 12 32-bit words of the high
// stream are broadcast by shuffles; every thread takes their prefix
// popcounts, picks the word holding each of its lanes' one-bits with
// selects and finds the bit with one __fns, so high = position - lane with
// no select dictionary and no shared memory.
// Rank comes from four ballots + popc, the value from one shuffle of the
// lane at min(rank, 127).  The TPU version needed hierarchical cumsums
// over a [8, 24, 16] bit tile instead.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kVals = 128;
constexpr int kHiWords = 24;  // 16-bit words of the high stream
constexpr int kWords = 12;    // the same stream as 32-bit words
constexpr int kWarps = 8;     // cursors per 256-thread block
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(32 * kWarps) ef_search_kernel(
    const int* __restrict__ lo, const int* __restrict__ hi,
    const int* __restrict__ lbits, const int* __restrict__ block_base,
    const int* __restrict__ codec_row, const int* __restrict__ rows,
    const int* __restrict__ pe, int* __restrict__ value,
    int* __restrict__ rank, int n) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long c = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (c >= n) return;  // warp-uniform: the whole warp leaves together
  const int row = rows[c];
  const long long er = codec_row ? codec_row[row] : row;
  const unsigned base = static_cast<unsigned>(block_base[row]);
  const int l = lbits[er];
  // rebased probe, wrapping like the reference's int32 arithmetic
  const int rp = max(static_cast<int>(static_cast<unsigned>(pe[c]) - base - 1u), 0);

  unsigned word = 0;
  if (lane < kWords) {
    const int2 h = reinterpret_cast<const int2*>(hi + er * kHiWords)[lane];
    word = (static_cast<unsigned>(h.x) & 0xffffu) |
           ((static_cast<unsigned>(h.y) & 0xffffu) << 16);
  }
  unsigned words[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) words[w] = __shfl_sync(kFull, word, w);

  const int4 lo4 = reinterpret_cast<const int4*>(lo + er * kVals)[lane];
  const unsigned low[4] = {static_cast<unsigned>(lo4.x), static_cast<unsigned>(lo4.y),
                           static_cast<unsigned>(lo4.z), static_cast<unsigned>(lo4.w)};
  // one-bits before each word; pre[kWords] = 128 in a well-formed tile
  unsigned pre[kWords + 1];
  pre[0] = 0;
#pragma unroll
  for (int w = 0; w < kWords; ++w) pre[w + 1] = pre[w] + __popc(words[w]);
  int r[4];
  int below_count = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const unsigned k = 4u * lane + e;  // this lane's one-bit is the k-th (0-based)
    // pick the word holding it with selects, then one __fns inside it
    unsigned word_k = 0, before = 0, at = 0;
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      const bool here = k >= pre[w] && k < pre[w + 1];
      word_k = here ? words[w] : word_k;
      before = here ? pre[w] : before;
      at = here ? 32u * w : at;
    }
    const unsigned pos = at + __fns(word_k, 0, static_cast<int>(k - before + 1));
    const unsigned high = pos - k;
    r[e] = static_cast<int>((high << l) | low[e]);
    below_count += __popc(__ballot_sync(kFull, r[e] < rp));
  }
  // the answer is lane min(rank, 127): every thread offers its element of
  // that lane's quad, and the owning thread's offer is taken
  const int rc = min(below_count, kVals - 1);
  const int offer = r[rc & 3];
  const int sel = __shfl_sync(kFull, offer, rc >> 2);
  if (lane == 0) {
    value[c] = below_count >= kVals
                   ? INT_MAX
                   : static_cast<int>(base + 1u + static_cast<unsigned>(sel));
    rank[c] = below_count;
  }
}

}  // namespace

extern "C" int ef_search(const void* lo, const void* hi, const void* lbits,
                         const void* block_base, const void* codec_row,
                         const void* rows, const void* pe, void* value,
                         void* rank, int n, void* stream) {
  if (n > 0) {
    ef_search_kernel<<<(n + kWarps - 1) / kWarps, 32 * kWarps, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(lo), static_cast<const int*>(hi),
        static_cast<const int*>(lbits), static_cast<const int*>(block_base),
        static_cast<const int*>(codec_row), static_cast<const int*>(rows),
        static_cast<const int*>(pe), static_cast<int*>(value),
        static_cast<int*>(rank), n);
  }
  return static_cast<int>(cudaGetLastError());
}
