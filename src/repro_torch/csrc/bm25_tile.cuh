// The float32 BM25 contract of repro_torch/ranked/bm25.py::score_tf, for
// one lane and for one warp-decoded freq row; shared by bm25_score.cu and
// pivot_score.cu.
//
//   score = idf * ((tf * k1p1) / (tf + k_hat)),  k_hat = table[norm_q]
//
// in exactly that order, each step rounded to nearest.  The explicit
// __fmul_rn / __fadd_rn / __fdiv_rn keep nvcc from contracting a multiply
// and an add into an FMA (-fmad is left at its default, true) and from
// using an approximate division; the norm is gathered from the 256-entry
// table in shared memory, never recomputed as kmin + kstep * q.  The
// sources must never be built with --use_fast_math.
#pragma once

#include "svb_tile.cuh"

constexpr int kNormLevels = 256;

__device__ __forceinline__ float bm25_contract(float idf, float tf, float k1p1,
                                               float k_hat) {
  return __fmul_rn(idf, __fdiv_rn(__fmul_rn(tf, k1p1), __fadd_rn(tf, k_hat)));
}

// tf of a decoded freq value (tf - 1), widened as the reference does: int32
// add (wrapping), then int -> float32 rounded to nearest.
__device__ __forceinline__ float tf_of(unsigned v) {
  return __int2float_rn(static_cast<int>(v + 1u));
}

// Copy the norm table into shared memory; every thread of the block must
// call it, and it ends with __syncthreads().
__device__ __forceinline__ void load_table(const float* __restrict__ table,
                                           float* tab) {
  for (int i = threadIdx.x; i < kNormLevels; i += blockDim.x) tab[i] = table[i];
  __syncthreads();
}

// Score one freq row with one warp: lane t ends with the contract scores
// of lanes 4t .. 4t+3 (padding lanes score whatever their bytes decode to;
// callers mask them).  `smem` is this warp's 512-byte staging buffer.
__device__ __forceinline__ void score_row(
    const int* __restrict__ flens_row, const unsigned char* __restrict__ fdata_row,
    const unsigned char* __restrict__ norm_row, const float* tab, float idf,
    float k1p1, unsigned char* smem, int lane, float s[4]) {
  unsigned v[4];
  decode_row(flens_row, fdata_row, smem, lane, v);
  const unsigned codes = reinterpret_cast<const unsigned*>(norm_row)[lane];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    s[e] = bm25_contract(idf, tf_of(v[e]), k1p1, tab[(codes >> (8 * e)) & 0xffu]);
  }
}
