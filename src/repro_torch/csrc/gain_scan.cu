// Gain-function scan of the paper's partitioner (Definition 1), for sm_90a.
//
// Replaces the TPU kernel repro/kernels/gain_scan/kernel.py::gain_scan ->
// gain_scan below.
//
// Per element the gain delta is 8 * VByte bytes of max(gap - 1, 0) minus
// the gap; g is its inclusive prefix over the whole sequence, and every
// 1024-element block reports the min and max of its g.  The host's
// dominating-point machine then reads g.
//
// What bounds it: bytes.  Each element's gap is read and its g written,
// 8 B per element, plus 8 B of min/max per block.  The arithmetic (five
// compares and a scan step per element) is far below the card's rate.
//
// What the design does about it: the TPU version walked the blocks in
// grid order with the running gain in a scalar scratch cell, and scanned
// each (8, 128) tile by log-step shifted adds.  Blocks of a CUDA grid run in
// no order, so the carry comes from a reduce-then-scan instead:
//   1. gain_reduce: one CTA per block sums its 1024 deltas;
//   2. gain_carry: one CTA turns the block sums into exclusive prefixes;
//   3. gain_write: one CTA per block reads its gaps again, scans them (a
//      4-element run per thread, a warp scan by shuffles, the 8 warp totals
//      through shared memory), adds its carry, writes g as 16-byte stores
//      and reduces the block's min and max.
// The gaps are read twice: 12 B per element against the 8 B bound.
//
// Every sum is taken in uint32, so it wraps where the reference's int32
// wraps and no signed overflow is undefined; min and max compare the
// final int32 values.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 1024;  // elements per block of the contract
constexpr int kThreads = kBlock / 4;
constexpr int kWarps = kThreads / 32;
constexpr int kCarryThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t gain_delta(int gap) {
  int v = static_cast<int>(static_cast<uint32_t>(gap) - 1u);
  v = v > 0 ? v : 0;
  const uint32_t nbytes = 1u + (v >= 128) + (v >= 16384) + (v >= 2097152) +
                          (v >= 268435456);
  return 8u * nbytes - static_cast<uint32_t>(gap);
}

__device__ __forceinline__ uint32_t delta_sum(int4 x, uint32_t* run) {
  run[0] = gain_delta(x.x);
  run[1] = run[0] + gain_delta(x.y);
  run[2] = run[1] + gain_delta(x.z);
  run[3] = run[2] + gain_delta(x.w);
  return run[3];
}

__device__ __forceinline__ uint32_t warp_inclusive(uint32_t v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t t = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// Inclusive scan over the W warps of a CTA; every thread calls it.
template <int W>
__device__ __forceinline__ uint32_t block_inclusive(uint32_t v) {
  __shared__ uint32_t tot[W];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_inclusive(v, lane);
  if (lane == 31) tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    uint32_t t = lane < W ? tot[lane] : 0u;
    t = warp_inclusive(t, lane);
    if (lane < W) tot[lane] = t;
  }
  __syncthreads();
  return warp ? v + tot[warp - 1] : v;
}

__global__ void __launch_bounds__(kThreads) gain_reduce_kernel(
    const int4* __restrict__ gaps, uint32_t* __restrict__ sums) {
  uint32_t run[4];
  const uint32_t s = delta_sum(gaps[blockIdx.x * kThreads + threadIdx.x], run);
  const uint32_t incl = block_inclusive<kWarps>(s);
  if (threadIdx.x == kThreads - 1) sums[blockIdx.x] = incl;
}

// One CTA: each thread sums a contiguous run of block sums, the CTA scans
// the run totals, and each thread rewrites its run as exclusive prefixes.
__global__ void __launch_bounds__(kCarryThreads) gain_carry_kernel(
    uint32_t* __restrict__ sums, int nb) {
  const int per = (nb + kCarryThreads - 1) / kCarryThreads;
  const int lo = min(static_cast<int>(threadIdx.x) * per, nb);
  const int hi = min(lo + per, nb);
  uint32_t s = 0;
  for (int b = lo; b < hi; ++b) s += sums[b];
  uint32_t run = block_inclusive<kCarryThreads / 32>(s) - s;
  for (int b = lo; b < hi; ++b) {
    const uint32_t v = sums[b];
    sums[b] = run;
    run += v;
  }
}

__global__ void __launch_bounds__(kThreads) gain_write_kernel(
    const int4* __restrict__ gaps, const uint32_t* __restrict__ carry,
    int4* __restrict__ g, int* __restrict__ mn, int* __restrict__ mx) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  uint32_t run[4];
  const uint32_t s = delta_sum(gaps[t], run);
  const uint32_t base = carry[blockIdx.x] + block_inclusive<kWarps>(s) - s;
  const int4 out = make_int4(static_cast<int>(base + run[0]),
                             static_cast<int>(base + run[1]),
                             static_cast<int>(base + run[2]),
                             static_cast<int>(base + run[3]));
  g[t] = out;
  int lo = min(min(out.x, out.y), min(out.z, out.w));
  int hi = max(max(out.x, out.y), max(out.z, out.w));
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(kFull, lo, o));
    hi = max(hi, __shfl_xor_sync(kFull, hi, o));
  }
  __shared__ int wlo[kWarps], whi[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    wlo[warp] = lo;
    whi[warp] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      lo = min(lo, wlo[w]);
      hi = max(hi, whi[w]);
    }
    mn[blockIdx.x] = lo;
    mx[blockIdx.x] = hi;
  }
}

}  // namespace

// gaps [nb * 1024] int32 -> g [nb * 1024], mn [nb], mx [nb] int32; sums is
// [nb] scratch.  Every pointer 16-byte aligned (the wrapper checks gaps and
// allocates the rest).
extern "C" int gain_scan(const void* gaps, void* g, void* mn, void* mx,
                         void* sums, int nb, void* stream) {
  if (nb <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int4* gp = static_cast<const int4*>(gaps);
  uint32_t* sp = static_cast<uint32_t*>(sums);
  gain_reduce_kernel<<<nb, kThreads, 0, s>>>(gp, sp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gain_carry_kernel<<<1, kCarryThreads, 0, s>>>(sp, nb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gain_write_kernel<<<nb, kThreads, 0, s>>>(
      gp, sp, static_cast<int4*>(g), static_cast<int*>(mn),
      static_cast<int*>(mx));
  return static_cast<int>(cudaGetLastError());
}
