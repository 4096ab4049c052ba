// Block-Max WAND pivot selection over resident bound chunks, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/blockmax_pivot/kernel.py::
// pivot_select_blocks -> blockmax_pivot_select below.
//
// The host reduces theta, the per-term multiplicities, the range-aligned
// co-candidate bounds and the proportional-share floor to one minimal
// admissible u8 code per block (qmin, float64-exact), so the device test is
// integer only.  Each cursor names a chunk row of the resident bound table
// (PivotChunks: up to 128 consecutive blocks of one list) and brings its
// own [128] qmin tile; the kernel keeps, compacts and pivots the row (see
// pivot_tile.cuh).
//
// What bounds it: bytes.  Per cursor 512 B of bound codes + 512 B of qmin
// + 4 B of nblk are read and 512 B of kept lanes + 12 B of aux written
// (about 1.55 KB).
//
// What the design does about it: the TPU version compacted the kept lanes
// with a [128 x 128] one-hot MXU matmul and took every chunk as a gathered
// copy.  Here one warp owns one cursor and gathers its chunk row itself
// (rows).  The keep test is four ballots and a popc prefix; each kept lane
// is written at its slot of a warp-private 512 B row in shared memory, and
// lane t then stores slots 4t .. 4t+3, -1 at and past the count, as one
// int4: the output row leaves as one coalesced 512 B store, where scattered
// 4-byte stores of the kept lanes and the -1 fill took up to 8 store
// instructions a lane.  The max is a warp reduce, the pivot a ballot and
// __ffs.  (A grid sized to the card, each warp walking a run of cursors
// with the next one's loads in flight, measured no faster at the ranked
// path's 16,384 cursors: PERF.md.)

#include <cuda_runtime.h>

#include "pivot_tile.cuh"

namespace {

constexpr int kWarps = 8;  // cursors per 256-thread block

__global__ void __launch_bounds__(32 * kWarps) pivot_select_kernel(
    const int* __restrict__ qb, const int* __restrict__ nblk,
    const int* __restrict__ qmin, const int* __restrict__ rows,
    int* __restrict__ out, int* __restrict__ aux, int n) {
  __shared__ __align__(16) int compact[kWarps][kVals];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long c = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (c >= n) return;  // warp-uniform
  const long long r = rows[c];
  const PivotKeep k =
      pivot_keep(reinterpret_cast<const int4*>(qb + r * kVals)[lane],
                 reinterpret_cast<const int4*>(qmin + c * kVals)[lane],
                 nblk[r], lane);
  int* slots = compact[warp];
  int slot = k.slot;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (k.keep[e]) slots[slot++] = 4 * lane + e;
  }
  __syncwarp();
  int4 o = reinterpret_cast<const int4*>(slots)[lane];
  if (4 * lane >= k.count) o.x = -1;
  if (4 * lane + 1 >= k.count) o.y = -1;
  if (4 * lane + 2 >= k.count) o.z = -1;
  if (4 * lane + 3 >= k.count) o.w = -1;
  reinterpret_cast<int4*>(out + c * kVals)[lane] = o;
  const PivotResult res = pivot_max(k);
  if (lane == 0) {
    aux[3 * c] = res.count;
    aux[3 * c + 1] = res.pivot;
    aux[3 * c + 2] = res.maxq;
  }
}

}  // namespace

extern "C" int blockmax_pivot_select(const void* qb, const void* nblk,
                                     const void* qmin, const void* rows,
                                     void* out, void* aux, int n,
                                     void* stream) {
  if (n > 0) {
    pivot_select_kernel<<<(n + kWarps - 1) / kWarps, 32 * kWarps, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(qb), static_cast<const int*>(nblk),
        static_cast<const int*>(qmin), static_cast<const int*>(rows),
        static_cast<int*>(out), static_cast<int*>(aux), n);
  }
  return static_cast<int>(cudaGetLastError());
}
