// Gain-function scan of the paper's partitioner (Definition 1), for sm_90a:
// one pass with decoupled look-back.
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
// grid order with the running gain in a scalar scratch cell.  CTAs of a
// CUDA grid run in no order, so the carry crosses them by decoupled
// look-back, and the gaps are read once:
//   1. a CTA takes the next tile of kTile whole blocks from an atomic
//      counter, so every tile it waits on has started before it;
//   2. it reads its gaps with 16-byte loads (4 per thread and block),
//      turns them into deltas, and scans the tile: a run per thread, warp
//      shuffles, then the kTile x 8 warp totals in one warp;
//   3. it publishes the tile's sum (flag A) in one 64-bit status word,
//      then sums its predecessors' words 32 at a time, nearest first,
//      until it meets an inclusive prefix (flag P); it publishes its own
//      inclusive prefix;
//   4. it writes g with 16-byte stores and reduces each block's min and
//      max from the final g values.
// The status words and the counter start from zero on each launch (one
// cudaMemsetAsync in the entry point).
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
constexpr int kTile = 4;  // blocks per tile: kTile * kWarps warp totals
constexpr unsigned kFull = 0xffffffffu;
constexpr uint64_t kFlagA = 1ull << 32;  // status: the tile's own sum
constexpr uint64_t kFlagP = 2ull << 32;  // status: its inclusive prefix

static_assert(kTile * kWarps == 32, "one warp scans the warp totals");

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

__device__ __forceinline__ void store_status(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ uint64_t load_status(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// The exclusive carry of `tile`, summed from its predecessors' status
// words by one warp; every lane returns it.
__device__ __forceinline__ uint32_t look_back(const uint64_t* status,
                                              int tile, int lane) {
  uint32_t carry = 0;
  for (int pred = tile - 1;; pred -= 32) {
    const int t = pred - lane;  // lane 0 reads the nearest predecessor
    uint64_t w;
    do {
      w = t >= 0 ? load_status(status + t) : kFlagP;  // before tile 0: 0
    } while (__any_sync(kFull, (w >> 32) == 0));
    const uint32_t p = __ballot_sync(kFull, (w & ~0xffffffffull) == kFlagP);
    uint32_t v = static_cast<uint32_t>(w);
    if (p) {
      // sum up to and including the nearest inclusive prefix
      v = lane < __ffs(p) ? v : 0u;
      return carry + __reduce_add_sync(kFull, v);
    }
    carry += __reduce_add_sync(kFull, v);
  }
}

__global__ void __launch_bounds__(kThreads) gain_scan_kernel(
    const int4* __restrict__ gaps, int4* __restrict__ g,
    int* __restrict__ mn, int* __restrict__ mx, uint64_t* __restrict__ status,
    unsigned* __restrict__ counter, int nb) {
  __shared__ int s_tile;
  __shared__ uint32_t s_tot[kTile * kWarps];
  __shared__ int s_lo[kTile][kWarps], s_hi[kTile][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = static_cast<int>(atomicAdd(counter, 1u));
  __syncthreads();
  const int tile = s_tile;
  const int b0 = tile * kTile;
  const int nq = min(kTile, nb - b0);  // blocks in this tile

  uint32_t run[kTile][4], sum[kTile], incl[kTile];
#pragma unroll
  for (int q = 0; q < kTile; ++q) {
    if (q < nq) {
      sum[q] = delta_sum(gaps[(b0 + q) * kThreads + threadIdx.x], run[q]);
    } else {  // past the last block: adds nothing, written nowhere
      sum[q] = run[q][0] = run[q][1] = run[q][2] = run[q][3] = 0u;
    }
    incl[q] = sum[q];
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int q = 0; q < kTile; ++q) {
      const uint32_t t = __shfl_up_sync(kFull, incl[q], o);
      if (lane >= o) incl[q] += t;
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int q = 0; q < kTile; ++q) s_tot[q * kWarps + warp] = incl[q];
  }
  __syncthreads();

  if (warp == 0) {
    // the warp totals in element order (block-major), scanned
    const uint32_t v = s_tot[lane];
    uint32_t x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t t = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += t;
    }
    const uint32_t agg = __shfl_sync(kFull, x, 31);
    uint32_t carry = 0;
    if (tile == 0) {
      if (lane == 0) store_status(status, kFlagP | agg);
    } else {
      if (lane == 0) store_status(status + tile, kFlagA | agg);
      carry = look_back(status, tile, lane);
      if (lane == 0) store_status(status + tile, kFlagP | (carry + agg));
    }
    s_tot[lane] = carry + x - v;
  }
  __syncthreads();

#pragma unroll
  for (int q = 0; q < kTile; ++q) {
    if (q < nq) {
      const uint32_t b = s_tot[q * kWarps + warp] + incl[q] - sum[q];
      const int4 out = make_int4(static_cast<int>(b + run[q][0]),
                                 static_cast<int>(b + run[q][1]),
                                 static_cast<int>(b + run[q][2]),
                                 static_cast<int>(b + run[q][3]));
      g[(b0 + q) * kThreads + threadIdx.x] = out;
      const int lo = __reduce_min_sync(
          kFull, min(min(out.x, out.y), min(out.z, out.w)));
      const int hi = __reduce_max_sync(
          kFull, max(max(out.x, out.y), max(out.z, out.w)));
      if (lane == 0) {
        s_lo[q][warp] = lo;
        s_hi[q][warp] = hi;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < nq) {
    const int q = threadIdx.x;
    int lo = s_lo[q][0], hi = s_hi[q][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      lo = min(lo, s_lo[q][w]);
      hi = max(hi, s_hi[q][w]);
    }
    mn[b0 + q] = lo;
    mx[b0 + q] = hi;
  }
}

}  // namespace

// gaps [nb * 1024] int32 -> g [nb * 1024], mn [nb], mx [nb] int32; scratch
// is at least ceil(nb / 4) + 1 64-bit words (the tile counter, then a
// status word a tile), zeroed here.  Every pointer 16-byte aligned (the
// wrapper checks gaps and allocates the rest).
extern "C" int gain_scan(const void* gaps, void* g, void* mn, void* mx,
                         void* scratch, int nb, void* stream) {
  if (nb <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (nb + kTile - 1) / kTile;
  uint64_t* words = static_cast<uint64_t*>(scratch);
  cudaError_t err = cudaMemsetAsync(words, 0, sizeof(uint64_t) * (tiles + 1), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  gain_scan_kernel<<<tiles, kThreads, 0, s>>>(
      static_cast<const int4*>(gaps), static_cast<int4*>(g),
      static_cast<int*>(mn), static_cast<int*>(mx), words + 1,
      reinterpret_cast<unsigned*>(words), nb);
  return static_cast<int>(cudaGetLastError());
}
