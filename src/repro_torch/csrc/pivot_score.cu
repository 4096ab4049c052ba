// Fused Block-Max pivot + kept-slot BM25 scoring, for sm_90a.
//
// Replaces repro/kernels/pivot_score/kernel.py::pivot_score_blocks, which on
// the TPU is two pallas_calls (pivot_select_blocks, then bm25_score_blocks)
// around an XLA gather of the kept blocks' freq tiles.  Here it is ONE
// kernel: a thread block per cursor (chunk row); warp 0 runs the pivot of
// pivot_tile.cuh and leaves the first kSlots kept lanes in shared memory,
// then the block's eight warps score those slots with the row scorer of
// bm25_tile.cuh, two slots each.
//
// Slot s of cursor c scores arena row clamp(base[r] + max(out[c, s], 0),
// 0, n_blocks - 1): slots past the kept count (out = -1) score the chunk's
// base row -- the reference's deterministic garbage, masked by the count
// -- and the clamp is to the n_blocks rows that norm_q and lob hold, not to
// the row count of the freq tiles, which is padded to a multiple of 8.
//
// What bounds it: bytes.  Per cursor the pivot moves about 1.55 KB (see
// blockmax_pivot.cu) and each of the 16 slots reads 1.15 KB of freq tile
// and norm codes and writes 512 B of scores: about 28 KB per cursor.
//
// What the design does about it: the kept lane list never leaves the chip
// between the two halves (shared memory instead of an HBM round trip and a
// gather), and the freq rows are read in place, never copied.  Warps 1-7
// idle while warp 0 pivots; that costs latency per block, not bandwidth.

#include <cuda_runtime.h>

#include "bm25_tile.cuh"
#include "pivot_tile.cuh"
#include "svb_tile.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kSlots = 16;  // repro_torch/kernels/pivot_score: SCORE_SLOTS

__global__ void __launch_bounds__(32 * kWarps) pivot_score_kernel(
    const int* __restrict__ qb, const int* __restrict__ nblk,
    const int* __restrict__ base, const int* __restrict__ qmin,
    const int* __restrict__ rows, const int* __restrict__ flens,
    const unsigned char* __restrict__ fdata,
    const unsigned char* __restrict__ norm_q, const float* __restrict__ idf,
    const int* __restrict__ lob, const float* __restrict__ table,
    int* __restrict__ out, int* __restrict__ aux, float* __restrict__ sscores,
    int n_blocks, float k1p1) {
  __shared__ float tab[kNormLevels];
  __shared__ int first[kSlots];
  __shared__ __align__(16) unsigned char smem[kWarps][kBytes];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long c = blockIdx.x;
  const long long r = rows[c];
  if (warp == 0) {
    const PivotResult res = pivot_row(qb + r * kVals, qmin + c * kVals,
                                      nblk[r], lane, out + c * kVals, first,
                                      kSlots);
    if (lane == 0) {
      aux[3 * c] = res.count;
      aux[3 * c + 1] = res.pivot;
      aux[3 * c + 2] = res.maxq;
    }
  }
  load_table(table, tab);  // its __syncthreads also publishes first[]
  const long long b0 = base[r];
  for (int s = warp; s < kSlots; s += kWarps) {
    long long row = b0 + (first[s] > 0 ? first[s] : 0);
    if (row < 0) row = 0;
    if (row > n_blocks - 1) row = n_blocks - 1;
    float sc[4];
    score_row(flens + row * kVals, fdata + row * kBytes, norm_q + row * kVals,
              tab, idf[lob[row]], k1p1, smem[warp], lane, sc);
    reinterpret_cast<float4*>(sscores + (c * kSlots + s) * kVals)[lane] =
        make_float4(sc[0], sc[1], sc[2], sc[3]);
    __syncwarp();  // the staging buffer is reused by the next slot
  }
}

}  // namespace

extern "C" int pivot_score(const void* qb, const void* nblk, const void* base,
                           const void* qmin, const void* rows,
                           const void* flens, const void* fdata,
                           const void* norm_q, const void* idf,
                           const void* lob, const void* table, void* out,
                           void* aux, void* sscores, int n, int n_blocks,
                           float k1p1, void* stream) {
  if (n > 0) {
    pivot_score_kernel<<<n, 32 * kWarps, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(qb), static_cast<const int*>(nblk),
        static_cast<const int*>(base), static_cast<const int*>(qmin),
        static_cast<const int*>(rows), static_cast<const int*>(flens),
        static_cast<const unsigned char*>(fdata),
        static_cast<const unsigned char*>(norm_q),
        static_cast<const float*>(idf), static_cast<const int*>(lob),
        static_cast<const float*>(table), static_cast<int*>(out),
        static_cast<int*>(aux), static_cast<float*>(sscores), n_blocks, k1p1);
  }
  return static_cast<int>(cudaGetLastError());
}
