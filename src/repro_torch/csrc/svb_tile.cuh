// Warp decoder of one block Stream-VByte row, shared by the kernels of
// vbyte_decode.cu, bm25_score.cu and pivot_score.cu.
//
// Layout (repro_torch/kernels/vbyte_decode/ops.py::pack_blocks): one arena
// row holds 128 values as int32 byte lengths (1..4) `lens[row, 128]` and
// their little-endian bytes packed from the front of `data[row, 512]`.  A
// decoded value is (gap - 1) for docID rows and (tf - 1) for freq rows.
//
// One warp owns one row: each lane moves 16 B of lens and 16 B of data with
// a single vector load (coalesced 512 B per warp per array), the data go to
// shared memory, a warp exclusive scan of the lane byte counts gives every
// value's offset, and each lane assembles its 4 values from shared memory.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kVals = 128;
constexpr int kBytes = 512;
constexpr unsigned kFull = 0xffffffffu;

// Decode one row with one warp: lane t ends with values 4t .. 4t+3 as
// uint32.  `smem` is this warp's 512-byte staging buffer; the caller must
// __syncwarp() before reusing it for another row.
__device__ __forceinline__ void decode_row(
    const int* __restrict__ lens_row, const unsigned char* __restrict__ data_row,
    unsigned char* smem, int lane, unsigned v[4]) {
  reinterpret_cast<uint4*>(smem)[lane] =
      reinterpret_cast<const uint4*>(data_row)[lane];
  const int4 l4 = reinterpret_cast<const int4*>(lens_row)[lane];
  const int len[4] = {l4.x, l4.y, l4.z, l4.w};
  const int own = len[0] + len[1] + len[2] + len[3];
  int incl = own;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  int start = incl - own;  // byte offset of value 4t within the row
  __syncwarp();
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    unsigned x = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (len[e] > j) {
        const int at = min(max(start + j, 0), kBytes - 1);
        x |= static_cast<unsigned>(smem[at]) << (8 * j);
      }
    }
    v[e] = x;
    start += len[e];
  }
}

// docIDs of a decoded docID row: base + inclusive prefix of (gap - 1) + 1,
// summed in uint32 so that they wrap exactly as the reference's int32
// arithmetic does.  Lane t ends with the docIDs of values 4t .. 4t+3.
__device__ __forceinline__ void row_docids(unsigned base, const unsigned v[4],
                                           int lane, int doc[4]) {
  unsigned pre[4];
  unsigned acc = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    acc += v[e] + 1u;
    pre[e] = acc;
  }
  unsigned incl = acc;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  const unsigned off = base + (incl - acc);
#pragma unroll
  for (int e = 0; e < 4; ++e) doc[e] = static_cast<int>(off + pre[e]);
}
