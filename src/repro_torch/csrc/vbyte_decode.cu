// Block Stream-VByte decode, plain and fused with NextGEQ, for sm_90a.
//
// Replaces the TPU kernels of repro/kernels/vbyte_decode/kernel.py:
//   decode_blocks        -> vbyte_decode_blocks below
//   decode_search_blocks -> vbyte_decode_search below
//
// Layout: see svb_tile.cuh, which holds the warp row decoder these kernels
// share with bm25_score.cu and pivot_score.cu.  A decoded value is
// (gap - 1); the docIDs of a row are block_base[row] + cumsum(gap),
// computed in uint32 so that they wrap exactly as the reference's int32
// arithmetic does.
//
// What bounds it: bytes.  A row is 512 B of lens + 512 B of data read once,
// and the arithmetic per byte is a handful of integer ops, so the floor is
// HBM bandwidth: ~1 KiB per row (+512 B written by decode_blocks, +16 B of
// row index, base, probe and results per decode_search cursor).
//
// What the design does about it: the TPU version rebuilt the byte gather
// as four one-hot matmuls because the TPU has no byte shuffle.  Here one
// warp owns one row (svb_tile.cuh::decode_row).  decode_search gathers
// the located row itself (rows, codec_row), so no gathered copy of the
// arena is ever materialised; it keeps the docIDs in
// registers and writes 8 B per cursor: the rank from four ballots + popc,
// the value from a masked warp min.  Packing lens into 2 bits and staging
// rows with TMA would cut the bytes further; that is later work.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "svb_tile.cuh"

namespace {

constexpr int kWarps = 8;  // rows (or cursors) per 256-thread block

__global__ void __launch_bounds__(32 * kWarps) decode_blocks_kernel(
    const int* __restrict__ lens, const unsigned char* __restrict__ data,
    const int* __restrict__ rows, int* __restrict__ out, int n) {
  __shared__ __align__(16) unsigned char smem[kWarps][kBytes];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long c = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (c >= n) return;  // warp-uniform: the whole warp leaves together
  const long long row = rows ? rows[c] : c;
  unsigned v[4];
  decode_row(lens + row * kVals, data + row * kBytes, smem[warp], lane, v);
  reinterpret_cast<int4*>(out + c * kVals)[lane] =
      make_int4(static_cast<int>(v[0]), static_cast<int>(v[1]),
                static_cast<int>(v[2]), static_cast<int>(v[3]));
}

__global__ void __launch_bounds__(32 * kWarps) decode_search_kernel(
    const int* __restrict__ lens, const unsigned char* __restrict__ data,
    const int* __restrict__ block_base, const int* __restrict__ codec_row,
    const int* __restrict__ rows, const int* __restrict__ pe,
    int* __restrict__ value, int* __restrict__ rank, int n) {
  __shared__ __align__(16) unsigned char smem[kWarps][kBytes];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long c = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (c >= n) return;  // warp-uniform
  const int row = rows[c];
  const long long srow = codec_row ? codec_row[row] : row;
  const int probe = pe[c];
  unsigned v[4];
  decode_row(lens + srow * kVals, data + srow * kBytes, smem[warp], lane, v);
  int doc[4];
  row_docids(static_cast<unsigned>(block_base[row]), v, lane, doc);
  int below_count = 0;
  int best = INT_MAX;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const bool below = doc[e] < probe;
    below_count += __popc(__ballot_sync(kFull, below));
    if (!below) best = min(best, doc[e]);
  }
  best = __reduce_min_sync(kFull, best);
  if (lane == 0) {
    value[c] = best;
    rank[c] = below_count;
  }
}

inline unsigned grid_for(int n) { return (n + kWarps - 1) / kWarps; }

}  // namespace

extern "C" int vbyte_decode_blocks(const void* lens, const void* data,
                                   const void* rows, void* out, int n,
                                   void* stream) {
  if (n > 0) {
    decode_blocks_kernel<<<grid_for(n), 32 * kWarps, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(lens), static_cast<const unsigned char*>(data),
        static_cast<const int*>(rows), static_cast<int*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vbyte_decode_search(const void* lens, const void* data,
                                   const void* block_base,
                                   const void* codec_row, const void* rows,
                                   const void* pe, void* value, void* rank,
                                   int n, void* stream) {
  if (n > 0) {
    decode_search_kernel<<<grid_for(n), 32 * kWarps, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(lens), static_cast<const unsigned char*>(data),
        static_cast<const int*>(block_base),
        static_cast<const int*>(codec_row), static_cast<const int*>(rows),
        static_cast<const int*>(pe), static_cast<int*>(value),
        static_cast<int*>(rank), n);
  }
  return static_cast<int>(cudaGetLastError());
}
