// Block-Max WAND pivot selection of one chunk row by one warp; shared by
// blockmax_pivot.cu and pivot_score.cu.
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

// Select one chunk row.  Writes out_row[0..128); when `first` is not null,
// also first[s] = out_row[s] for s < n_first (the slots a fused caller
// scores next), through the caller's shared memory.
__device__ __forceinline__ PivotResult pivot_row(
    const int* __restrict__ qb_row, const int* __restrict__ qmin_row, int nblk,
    int lane, int* __restrict__ out_row, int* first, int n_first) {
  const int4 q4 = reinterpret_cast<const int4*>(qb_row)[lane];
  const int4 m4 = reinterpret_cast<const int4*>(qmin_row)[lane];
  const int qb[4] = {q4.x, q4.y, q4.z, q4.w};
  const int qm[4] = {m4.x, m4.y, m4.z, m4.w};
  bool keep[4];
  unsigned ball[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    keep[e] = qb[e] >= qm[e] && 4 * lane + e < nblk;
    ball[e] = __ballot_sync(kFull, keep[e]);
  }
  const unsigned below = (1u << lane) - 1u;  // lane 0: 0
  int slot = 0, count = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    slot += __popc(ball[e] & below);
    count += __popc(ball[e]);
  }
  int m = -1;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (keep[e]) {
      out_row[slot] = 4 * lane + e;
      if (first != nullptr && slot < n_first) first[slot] = 4 * lane + e;
      ++slot;
      m = max(m, qb[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int p = 4 * lane + e;
    if (p >= count) out_row[p] = -1;
    if (first != nullptr && p < n_first && p >= count) first[p] = -1;
  }
  const int maxq = __reduce_max_sync(kFull, m);
  int pivot = INT_MAX;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const unsigned b = __ballot_sync(kFull, keep[e] && qb[e] == maxq);
    if (b) pivot = min(pivot, 4 * (__ffs(b) - 1) + e);
  }
  PivotResult r;
  r.count = count;
  r.pivot = count > 0 ? pivot : -1;
  r.maxq = maxq;
  return r;
}
