// Elias-Fano NextGEQ over one 128-value tile per cursor, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/ef_search/kernel.py:ef_search_blocks.
//
// Tile layout (repro_torch/kernels/ef_search/ops.py::ef_pack_blocks): the
// block's values rebased as r = value - block_base - 1 split into l low bits
// (`lo[tile, 128]`, uint16 widened to int32) and a unary high stream of 384
// bits: one 1-bit per lane at position high + lane, shipped as 24 16-bit
// words (`hi[tile, 24]`, widened to int32).  `lbits[tile]` is l (<= 15) and
// every high is <= 255, so the stream holds 128 ones and 256 zeros.
//
// Contract (the one of decode_search): value = the smallest block docID
// >= probe (2^31 - 1 if none), rank = the count of block docIDs < probe.
// With rp = max(probe - base - 1, 0) in wrapping int32 arithmetic, split
// into hp = rp >> l and lp = rp & (2^l - 1):
//   count_lt = ones before the hp-th zero (0 when hp = 0)   lanes high < hp
//   count_le = ones before the (hp + 1)-th zero            lanes high <= hp
//   rank     = count_lt + #{lanes in [count_lt, count_le) : lo < lp}
// and hp > 255 gives rank 128, as the TPU kernel's `hp > 255` and clip do.
// The value's high part is the position of the min(rank, 127)-th one minus
// that index, its low part one load of lo.
//
// What bounds it.  The tile is never decoded: a cursor reads its row
// index, probe, codec row, base and l, the tile's 96 B of high words and
// only the lanes of `lo` its answer needs (the run of equal high parts and
// the answer lane), and writes 8 B.  On an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py) the full-size launch (1.92 M cursors) takes 0.0826 ms,
// twice those bytes over HBM's rate (0.0415 ms); a warp a cursor that
// decoded all 128 lanes, with a 12-word select a lane, was issue-bound at
// 1.5599 ms on the same card.  What is left is the chain of
// dependent loads a cursor walks (row, codec row and l, high words, one to
// eight loads of lo): at 48 registers an SM holds 1,280 cursors.
//
// What the design does about it: one thread a cursor, so a 256-thread block
// keeps 256 independent cursors' loads in flight.  A warp stages its 32
// tiles' high words in shared memory with coalesced 16-byte loads (lane j
// moves piece j + 32 i of the warp's 192), and each thread reads its own
// tile back as 12 32-bit words.  Three selects (two select-0, one select-1)
// each pick their word with selects over the 12 popcounts and finish with
// one __fns.  The equal-high run is searched by bisection in `lo` (at most
// 7 loads, none for an empty run), and the answer lane is one more load.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kVals = 128;
constexpr int kHiWords = 24;          // 16-bit words of the high stream
constexpr int kWords = 12;            // the same stream as 32-bit words
constexpr int kPieces = kHiWords / 4; // 16-byte pieces of a tile's high words
constexpr int kStreamBits = 384;      // 128 ones + 256 zeros
constexpr int kMaxHigh = 255;
constexpr int kThreads = 256;         // cursors per block, one a thread
constexpr int kWarps = kThreads / 32;
// ints a staged tile takes: 24 padded to 28, so the 16-byte reads of any 8
// neighbouring threads fall on distinct banks
constexpr int kPitch = 28;
constexpr unsigned kFull = 0xffffffffu;

// Position of the k-th (0-based) one bit (kOnes) or zero bit of the stream
// `w`, given the ones before each word; kStreamBits when there is none, as
// the reference's #{j : count_j <= k} gives.
template <bool kOnes>
__device__ __forceinline__ int select_bit(const unsigned (&w)[kWords],
                                          const int (&ones_before)[kWords + 1],
                                          int k) {
  unsigned word = 0;
  int at = -1, rem = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const int before = kOnes ? ones_before[i] : 32 * i - ones_before[i];
    const int upto = kOnes ? ones_before[i + 1] : 32 * (i + 1) - ones_before[i + 1];
    const bool here = at < 0 && k < upto;
    word = here ? (kOnes ? w[i] : ~w[i]) : word;
    rem = here ? k - before : rem;
    at = here ? 32 * i : at;
  }
  return at < 0 ? kStreamBits : at + static_cast<int>(__fns(word, 0, rem + 1));
}

__global__ void __launch_bounds__(kThreads) ef_search_kernel(
    const int* __restrict__ lo, const int* __restrict__ hi,
    const int* __restrict__ lbits, const int* __restrict__ block_base,
    const int* __restrict__ codec_row, const int* __restrict__ rows,
    const int* __restrict__ pe, int* __restrict__ value,
    int* __restrict__ rank, int n) {
  __shared__ __align__(16) int staged[kWarps][32 * kPitch];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long c = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = c < n;
  int er = 0, l = 0, rp = 0;
  unsigned base = 0;
  if (live) {
    const int row = rows[c];
    er = codec_row ? codec_row[row] : row;
    base = static_cast<unsigned>(block_base[row]);
    l = lbits[er];
    // rebased probe, wrapping like the reference's int32 arithmetic
    rp = max(static_cast<int>(static_cast<unsigned>(pe[c]) - base - 1u), 0);
  }
  const int hp = rp >> l;
  const bool search = live && hp <= kMaxHigh;
  const unsigned need = __ballot_sync(kFull, search);
  int* st = staged[warp];
  if (need) {  // warp-uniform
#pragma unroll
    for (int i = 0; i < kPieces; ++i) {
      const int piece = lane + 32 * i;
      const int t = piece / kPieces, q = piece % kPieces;
      const int et = __shfl_sync(kFull, er, t);
      if ((need >> t) & 1u) {
        reinterpret_cast<int4*>(st + t * kPitch)[q] =
            reinterpret_cast<const int4*>(hi + static_cast<long long>(et) * kHiWords)[q];
      }
    }
    __syncwarp();
  }
  if (!live) return;
  if (!search) {  // past the tile's high range: every lane is below
    value[c] = INT_MAX;
    rank[c] = kVals;
    return;
  }
  unsigned w[kWords];
  int ones_before[kWords + 1];
  ones_before[0] = 0;
#pragma unroll
  for (int q = 0; q < kPieces; ++q) {
    const int4 h = reinterpret_cast<const int4*>(st + lane * kPitch)[q];
    w[2 * q] = (static_cast<unsigned>(h.x) & 0xffffu) |
               ((static_cast<unsigned>(h.y) & 0xffffu) << 16);
    w[2 * q + 1] = (static_cast<unsigned>(h.z) & 0xffffu) |
                   ((static_cast<unsigned>(h.w) & 0xffffu) << 16);
  }
#pragma unroll
  for (int i = 0; i < kWords; ++i) ones_before[i + 1] = ones_before[i] + __popc(w[i]);

  const int lp = rp & ((1 << l) - 1);
  const int count_lt = hp == 0 ? 0 : select_bit<false>(w, ones_before, hp - 1) - (hp - 1);
  const int count_le = select_bit<false>(w, ones_before, hp) - hp;
  // lows ascend within the run of equal highs: bisect for the first lane
  // of the run whose low part is >= lp
  const int* lo_t = lo + static_cast<long long>(er) * kVals;
  int a = count_lt, b = min(count_le, kVals);
  while (a < b) {
    const int m = (a + b) >> 1;
    if (lo_t[m] < lp) a = m + 1; else b = m;
  }
  const int rc = min(a, kVals - 1);
  const unsigned high =
      static_cast<unsigned>(select_bit<true>(w, ones_before, rc) - rc);
  const unsigned low = static_cast<unsigned>(lo_t[rc]);
  value[c] = a >= kVals ? INT_MAX
                        : static_cast<int>(base + 1u + ((high << l) | low));
  rank[c] = a;
}

}  // namespace

extern "C" int ef_search(const void* lo, const void* hi, const void* lbits,
                         const void* block_base, const void* codec_row,
                         const void* rows, const void* pe, void* value,
                         void* rank, int n, void* stream) {
  if (n > 0) {
    ef_search_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(lo), static_cast<const int*>(hi),
        static_cast<const int*>(lbits), static_cast<const int*>(block_base),
        static_cast<const int*>(codec_row), static_cast<const int*>(rows),
        static_cast<const int*>(pe), static_cast<int*>(value),
        static_cast<int*>(rank), n);
  }
  return static_cast<int>(cudaGetLastError());
}
