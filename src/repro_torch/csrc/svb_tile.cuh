// Warp decoder of one block Stream-VByte row, shared by the kernels of
// vbyte_decode.cu, bm25_score.cu and pivot_score.cu, and its pipelined
// form (stage_lens + stage_data + decode_staged), which decode_search
// runs.
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

// Byte offset of value 4t of the row in lane t: a warp exclusive scan of
// the lanes' byte counts.
__device__ __forceinline__ int lane_byte_start(const int len[4], int lane) {
  const int own = len[0] + len[1] + len[2] + len[3];
  int incl = own;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  return incl - own;
}

// Assemble a lane's 4 values from the row's bytes in shared memory, value
// 4t starting at byte `start`.
__device__ __forceinline__ void gather_values(const int len[4], int start,
                                              const unsigned char* smem,
                                              unsigned v[4]) {
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
  const int start = lane_byte_start(len, lane);
  __syncwarp();
  gather_values(len, start, smem, v);
}

// The pipelined form of decode_row, for kernels that keep rows in flight.
// A row is staged into a slot of kSlotBytes in shared memory with cp.async
// in two steps: its lens (16 B a lane), then, once they have landed, only
// the prefix of its bytes that the lens say holds values (16 B a lane that
// has any).  Once both have landed, decode_staged assembles each value
// from two aligned 32-bit words; the slot's 16 B of padding past the bytes
// keep those reads inside it.
constexpr int kSlotBytes = kVals * 4 + kBytes + 16;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `kPending` of this thread's newest copy groups are
// still in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Start the copy of a row's lens into `slot` (the caller commits).
__device__ __forceinline__ void stage_lens(const int* __restrict__ lens_row,
                                           unsigned char* slot, int lane) {
  cp_async16(slot + 16 * lane, lens_row + 4 * lane);
}

// Start the copy of the bytes a row's values occupy into `slot`, once this
// lane's copy of the lens has landed (the caller commits): the 16-byte
// pieces below the sum of the lens, which hold every byte decode_staged
// reads.
__device__ __forceinline__ void stage_data(const unsigned char* __restrict__ data_row,
                                           unsigned char* slot, int lane) {
  const int4 l4 = reinterpret_cast<const int4*>(slot)[lane];
  const int total = __reduce_add_sync(kFull, l4.x + l4.y + l4.z + l4.w);
  if (16 * lane < total) {
    cp_async16(slot + kVals * 4 + 16 * lane, data_row + 16 * lane);
  }
}

// A lane's 4 values from the row's bytes in shared memory, value 4t
// starting at byte `start`, from two aligned 32-bit words each.  Equal to
// gather_values for lens in the layout's 1..4: each value lies below the
// sum of the lens, and the bytes read beyond it are masked off.
__device__ __forceinline__ void gather_words(const int len[4], int start,
                                             const unsigned char* smem,
                                             unsigned v[4]) {
  const unsigned* w = reinterpret_cast<const unsigned*>(smem);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int at = start >> 2;
    const unsigned x = __funnelshift_r(w[at], w[at + 1], (start & 3) * 8);
    v[e] = x & (len[e] >= 4 ? 0xffffffffu : (1u << (8 * len[e])) - 1u);
    start += len[e];
  }
}

// Decode a row staged by stage_lens + stage_data, once every lane's copies
// have landed (cp_async_wait, then __syncwarp): lane t ends with values
// 4t .. 4t+3, as decode_row gives them for lens in the layout's 1..4.
__device__ __forceinline__ void decode_staged(const unsigned char* slot,
                                              int lane, unsigned v[4]) {
  const int4 l4 = reinterpret_cast<const int4*>(slot)[lane];
  const int len[4] = {l4.x, l4.y, l4.z, l4.w};
  gather_words(len, lane_byte_start(len, lane), slot + kVals * 4, v);
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
