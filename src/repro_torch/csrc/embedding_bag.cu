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
// and weights, and the output.  What the kernel cannot avoid, short of
// deduplicating bags, is gathering B * K rows through L2 and L1.
//
// What the design does about it: the Pallas kernel prefetched the ids into
// scalar memory and let each (b, k) grid step stream one row into VMEM.
// Here a warp owns 8 units, a unit being one bag's group of 4 * VEC columns
// and 4 lanes, each lane VEC columns: at D = 16 a warp sums 8 bags at once,
// each lane loading 16 bytes of a row (VEC = 4); wider rows take several
// units a bag.  Rows whose D is not a multiple of 4, or a table not aligned
// for the vector load, take VEC = 1.  There is no shared memory and no
// block-wide sync: the 4 lanes of a unit load 16 of its bag's ids and
// weights (4 each, 16 bytes when K allows) one chunk ahead, wrap and clamp
// the ids into the table, and hand each slot's to the unit's lanes by
// __shfl_sync.  A lane issues the chunk's 16 row loads before its adds.
// The grid holds every warp the card takes at once.  Rows come through L1,
// where the padding's row 0 and some of the items' rows hit, the rest from
// L2.  (Cache hints -- evict-last rows, streamed ids -- measured no faster
// on the recsys path, and rows that skip L1 far slower: PERF.md.)
//
// The f32 contract: one accumulator a column, k in order from +0.0, each
// step one __fmul_rn and one __fadd_rn, so the result equals the plain
// version (ref.py) bit for bit; no fast math, no fused multiply-add.  Every
// slot's row is read and added, a zero weight's too (0 * inf is NaN in the
// plain version).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;      // warps a block
constexpr int kUnitLanes = 4;  // lanes of a unit
constexpr int kUnits = 32 / kUnitLanes;  // units a warp
constexpr int kChunk = 16;     // k slots a unit takes a pass, 4 a lane

// VEC consecutive values of a table row as floats, read through L1.
template <typename T, int VEC>
struct RowLoad;

template <>
struct RowLoad<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  }
};

template <>
struct RowLoad<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    v[0] = __ldg(p);
  }
};

// bf16 widens exactly: its bits are the top half of the float's.
template <>
struct RowLoad<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* v) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = __uint_as_float(x.x << 16);
    v[1] = __uint_as_float(x.x & 0xffff0000u);
    v[2] = __uint_as_float(x.y << 16);
    v[3] = __uint_as_float(x.y & 0xffff0000u);
  }
};

template <>
struct RowLoad<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* v) {
    const unsigned short h = __ldg(reinterpret_cast<const unsigned short*>(p));
    v[0] = __uint_as_float(static_cast<unsigned>(h) << 16);
  }
};

template <int VEC>
__device__ __forceinline__ void store(float* p, const float* acc) {
  if constexpr (VEC == 4) {
    __stcs(reinterpret_cast<float4*>(p),
           make_float4(acc[0], acc[1], acc[2], acc[3]));
  } else {
    __stcs(p, acc[0]);
  }
}

// The unit's ids and weights of slots k .. k + 3 (k = k0 + 4q, q the lane's
// place in its unit); the ids wrapped and clamped into the table, slots
// past K read as row 0, weight 0 (never added).
__device__ __forceinline__ void load_slots(const int* ids, const float* w,
                                           int64_t at, int k, int K, int V,
                                           bool kvec, int* row, float* wt) {
  int id[4] = {0, 0, 0, 0};
  float ws[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (kvec) {  // K % 4 == 0, both arrays 16-byte aligned: k + 3 < K
    if (k < K) {
      const int4 i4 = __ldg(reinterpret_cast<const int4*>(ids + at));
      const float4 w4 = __ldg(reinterpret_cast<const float4*>(w + at));
      id[0] = i4.x, id[1] = i4.y, id[2] = i4.z, id[3] = i4.w;
      ws[0] = w4.x, ws[1] = w4.y, ws[2] = w4.z, ws[3] = w4.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (k + j < K) {
        id[j] = __ldg(ids + at + j);
        ws[j] = __ldg(w + at + j);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int r = id[j];
    if (r < 0) r += V;
    row[j] = min(max(r, 0), V - 1);
    wt[j] = ws[j];
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(32 * kWarps)
    bag_kernel(const T* __restrict__ table, const int* __restrict__ ids,
               const float* __restrict__ w, float* __restrict__ out, int K,
               int V, int D, int groups, int64_t units, bool kvec) {
  const int lane = threadIdx.x & 31;
  const int q = lane & (kUnitLanes - 1);
  const int lead = lane & ~(kUnitLanes - 1);  // lane q = 0 of the unit
  const int64_t tasks = (units + kUnits - 1) / kUnits;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       t < tasks; t += stride) {
    const int64_t unit = t * kUnits + lane / kUnitLanes;
    const bool live_unit = unit < units;
    const int64_t bag = live_unit ? unit / groups : 0;
    const int col = static_cast<int>(live_unit ? unit % groups : 0) *
                        (kUnitLanes * VEC) + q * VEC;
    const bool live = live_unit && col < D;  // VEC = 4: D % 4 == 0
    const int64_t slots = bag * K + kUnitLanes * q;
    int nrow[4], crow[4];
    float nw[4], cw[4];
    if (K > 0) {
      load_slots(ids, w, slots, kUnitLanes * q, live_unit ? K : 0, V, kvec,
                 nrow, nw);
    }
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
    for (int k0 = 0; k0 < K; k0 += kChunk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) crow[j] = nrow[j], cw[j] = nw[j];
      const int n = min(kChunk, K - k0);  // warp-uniform
      float v[kChunk][VEC];
#pragma unroll
      for (int kk = 0; kk < kChunk; ++kk) {
        if (kk < n) {
          const int r = __shfl_sync(kFull, crow[kk & 3], lead | (kk >> 2));
          if (live) {
            RowLoad<T, VEC>::load(table + static_cast<size_t>(r) * D + col,
                                  v[kk]);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) v[kk][e] = 0.0f;
          }
        }
      }
      if (k0 + kChunk < K) {  // the next chunk's ids and weights, ahead
        const int k = k0 + kChunk + kUnitLanes * q;
        load_slots(ids, w, slots + k0 + kChunk, k, live_unit ? K : 0, V,
                   kvec, nrow, nw);
      }
#pragma unroll
      for (int kk = 0; kk < kChunk; ++kk) {
        if (kk < n) {
          const float wt = __shfl_sync(kFull, cw[kk & 3], lead | (kk >> 2));
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            acc[e] = __fadd_rn(acc[e], __fmul_rn(wt, v[kk][e]));
          }
        }
      }
    }
    if (live) store<VEC>(out + bag * D + col, acc);
  }
}

// Every block the card holds at once, or fewer when there are fewer tasks
// (one task a warp, as many blocks as the tasks need, measured slower).
template <typename T, int VEC>
unsigned grid_for(long long tasks) {
  static const int resident = [] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bag_kernel<T, VEC>,
                                                  32 * kWarps, 0);
    return max(sms * per_sm, 1);
  }();
  const long long want = (tasks + kWarps - 1) / kWarps;
  return static_cast<unsigned>(min(want, static_cast<long long>(resident)));
}

template <typename T, int VEC>
void launch_vec(const T* table, const int* ids, const float* w, float* out,
                int B, int K, int V, int D, bool kvec, cudaStream_t stream) {
  const int groups = (D + kUnitLanes * VEC - 1) / (kUnitLanes * VEC);
  const int64_t units = static_cast<int64_t>(B) * groups;
  const unsigned grid = grid_for<T, VEC>((units + kUnits - 1) / kUnits);
  bag_kernel<T, VEC><<<grid, 32 * kWarps, 0, stream>>>(
      table, ids, w, out, K, V, D, groups, units, kvec);
}

bool aligned(const void* p, uintptr_t to) {
  return reinterpret_cast<uintptr_t>(p) % to == 0;
}

// VEC = 4 when every row starts on the vector load's alignment (D % 4 == 0
// and the table aligned to 4 values); ids and weights go 16 bytes at a time
// when every bag's slots do (K % 4 == 0, both arrays 16-byte aligned).
template <typename T>
int launch(const T* table, const int* ids, const float* w, float* out, int B,
           int K, int V, int D, void* stream) {
  const bool kvec = K % 4 == 0 && aligned(ids, 16) && aligned(w, 16);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % 4 == 0 && aligned(table, 4 * sizeof(T)) && aligned(out, 16)) {
    launch_vec<T, 4>(table, ids, w, out, B, K, V, D, kvec, s);
  } else {
    launch_vec<T, 1>(table, ids, w, out, B, K, V, D, kvec, s);
  }
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
