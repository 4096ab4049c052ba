// Fixed-arity EmbeddingBag, out[b] = sum_k w[b,k] * table[ids[b,k]] in f32,
// for sm_90a.
//
// Replaces the TPU kernel repro/kernels/embedding_bag/kernel.py::
// embedding_bag -> bag_kernel below (table in f32 or bf16).
//
// What bounds it: bytes.  A bag reads K ids and weights (8 B each) and K
// table rows of D values, and writes D floats; one multiply and one add per
// value read.  The distinct rows of a batch are few beside the rows it
// gathers (a multi-hot feature repeats its items), so they live in L2 and
// the least traffic from device memory is the distinct rows once, the ids
// and weights, and the output.
//
// What the design does about it: the Pallas kernel prefetched the ids into
// scalar memory and let each (b, k) grid step stream one row into VMEM.
// Here a block of 256 threads takes 256 / L bags, L threads a bag (L the
// power of two >= D, at least 8 and at most 256; wider rows loop over
// column groups).  The block stages a chunk of each bag's ids -- wrapped
// and clamped into the table -- and weights in shared memory, with one
// coalesced pass over the [B, K] arrays, so no thread loads an id or a
// weight on its own and no lookup leaves the table.  Then each thread sums
// its column over the chunk: neighbouring threads read neighbouring values
// of one row.  One f32 accumulator a column, k in order, each step one
// __fmul_rn and one __fadd_rn, so the result equals the plain version
// (ref.py) bit for bit; no fast math, no fused multiply-add.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStage = 512;  // (row, weight) pairs staged per pass a block
constexpr int kMinLanes = 8;

__device__ __forceinline__ float value(const float* t, size_t i) {
  return t[i];
}

__device__ __forceinline__ float value(const __nv_bfloat16* t, size_t i) {
  return __bfloat162float(t[i]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bag_kernel(const T* __restrict__ table, const int* __restrict__ ids,
               const float* __restrict__ w, float* __restrict__ out, int B,
               int K, int V, int D, int lanes) {
  __shared__ int s_row[kStage];
  __shared__ float s_w[kStage];
  const int bags = kThreads / lanes;
  const int chunk = kStage / bags;  // k values staged per bag a pass
  const int local = threadIdx.x / lanes;
  const int lane = threadIdx.x % lanes;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * bags;
  const int64_t b = first + local;
  for (int d0 = 0; d0 < D; d0 += lanes) {
    const int d = d0 + lane;
    const bool live = b < B && d < D;
    float acc = 0.0f;
    for (int k0 = 0; k0 < K; k0 += chunk) {
      __syncthreads();  // the previous chunk is consumed
      for (int e = threadIdx.x; e < kStage; e += kThreads) {
        const int64_t bb = first + e / chunk;
        const int k = k0 + e % chunk;
        int row = 0;
        float wt = 0.0f;
        if (bb < B && k < K) {
          const int64_t at = bb * K + k;
          int id = ids[at];
          if (id < 0) id += V;
          row = min(max(id, 0), V - 1);
          wt = w[at];
        }
        s_row[e] = row;
        s_w[e] = wt;
      }
      __syncthreads();
      if (live) {
        const int n = min(chunk, K - k0);
        const int* rows = s_row + local * chunk;
        const float* ws = s_w + local * chunk;
#pragma unroll 8
        for (int kk = 0; kk < n; ++kk) {
          const float v = value(table, static_cast<size_t>(rows[kk]) * D + d);
          acc = __fadd_rn(acc, __fmul_rn(ws[kk], v));
        }
      }
    }
    if (live) out[b * D + d] = acc;
  }
}

int lanes_for(int D) {
  int lanes = kMinLanes;
  while (lanes < D && lanes < kThreads) lanes *= 2;
  return lanes;
}

template <typename T>
int launch(const T* table, const int* ids, const float* w, float* out, int B,
           int K, int V, int D, void* stream) {
  const int lanes = lanes_for(D);
  const int bags = kThreads / lanes;
  const int grid = static_cast<int>((static_cast<int64_t>(B) + bags - 1) / bags);
  bag_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, ids, w, out, B, K, V, D, lanes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int embedding_bag_f32(const float* table, const int* ids,
                                 const float* w, float* out, int B, int K,
                                 int V, int D, void* stream) {
  return launch(table, ids, w, out, B, K, V, D, stream);
}

extern "C" int embedding_bag_bf16(const void* table, const int* ids,
                                  const float* w, float* out, int B, int K,
                                  int V, int D, void* stream) {
  return launch(static_cast<const __nv_bfloat16*>(table), ids, w, out, B, K,
                V, D, stream);
}
