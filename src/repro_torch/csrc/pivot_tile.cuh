// Block-Max WAND pivot selection of one chunk row by one warp: the keep test
// and slots (pivot_keep) and the max and pivot (pivot_max), shared by
// blockmax_pivot.cu and pivot_score.cu, and pivot_score's whole row
// (pivot_row, which stores each kept lane at its slot).
//
// A chunk row holds the u8 bound codes (widened to int32) of up to 128
// consecutive blocks of one list; `qmin` holds the minimal admissible code
// per lane.  Integer contract of repro/kernels/blockmax_pivot/kernel.py:
//   keep    = qb >= qmin && lane < nblk
//   out     = the kept lanes, ascending, then -1 up to 128
//   count   = number kept
//   maxq    = max qb over kept lanes (-1 if none)
//   pivot   = lowest kept lane with qb == maxq (-1 if none)
//
// Lane t of the warp holds chunk lanes 4t .. 4t+3 (one int4 load per
// array).  Four ballots give every kept lane its slot: the kept lanes of
// lower threads (popc of the ballots under the thread's bit) plus the kept
// lanes before it in its own four.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>

#include "svb_tile.cuh"

struct PivotResult {
  int count, pivot, maxq;
};

// The keep test of lane t's four chunk lanes 4t .. 4t+3 and the slot of its
// first kept lane in the compacted row.
struct PivotKeep {
  int qb[4];
  bool keep[4];
  int slot, count;
};

__device__ __forceinline__ PivotKeep pivot_keep(int4 q4, int4 m4, int nblk,
                                                int lane) {
  PivotKeep k;
  const int qm[4] = {m4.x, m4.y, m4.z, m4.w};
  k.qb[0] = q4.x, k.qb[1] = q4.y, k.qb[2] = q4.z, k.qb[3] = q4.w;
  unsigned ball[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    k.keep[e] = k.qb[e] >= qm[e] && 4 * lane + e < nblk;
    ball[e] = __ballot_sync(kFull, k.keep[e]);
  }
  const unsigned below = (1u << lane) - 1u;  // lane 0: 0
  k.slot = 0, k.count = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    k.slot += __popc(ball[e] & below);
    k.count += __popc(ball[e]);
  }
  return k;
}

// count, maxq (a warp max over the kept lanes) and the pivot (the lowest
// kept lane at maxq, from a ballot a lane position and __ffs).
__device__ __forceinline__ PivotResult pivot_max(const PivotKeep& k) {
  int m = -1;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (k.keep[e]) m = max(m, k.qb[e]);
  }
  const int maxq = __reduce_max_sync(kFull, m);
  int pivot = INT_MAX;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const unsigned b = __ballot_sync(kFull, k.keep[e] && k.qb[e] == maxq);
    if (b) pivot = min(pivot, 4 * (__ffs(b) - 1) + e);
  }
  PivotResult r;
  r.count = k.count;
  r.pivot = k.count > 0 ? pivot : -1;
  r.maxq = maxq;
  return r;
}

// Select one chunk row.  Writes out_row[0..128); when `first` is not null,
// also first[s] = out_row[s] for s < n_first (the slots a fused caller
// scores next), through the caller's shared memory.
__device__ __forceinline__ PivotResult pivot_row(
    const int* __restrict__ qb_row, const int* __restrict__ qmin_row, int nblk,
    int lane, int* __restrict__ out_row, int* first, int n_first) {
  const PivotKeep k =
      pivot_keep(reinterpret_cast<const int4*>(qb_row)[lane],
                 reinterpret_cast<const int4*>(qmin_row)[lane], nblk, lane);
  int slot = k.slot;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (k.keep[e]) {
      out_row[slot] = 4 * lane + e;
      if (first != nullptr && slot < n_first) first[slot] = 4 * lane + e;
      ++slot;
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int p = 4 * lane + e;
    if (p >= k.count) out_row[p] = -1;
    if (first != nullptr && p < n_first && p >= k.count) first[p] = -1;
  }
  return pivot_max(k);
}
