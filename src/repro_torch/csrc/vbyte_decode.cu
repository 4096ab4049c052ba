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
// What bounds it.  decode_blocks: bytes, ~1 KiB read and 512 B written a
// row, and a handful of integer ops a byte.  decode_search: not bytes.
// Its bound counts, once for each row its cursors locate, the row's 512 B
// of lens and the bytes of its data that hold values (the sum of its
// lens, about 128 B on the corpus's small gaps).  The kernel stages those
// pieces once per cursor, rounded up to 16 B, so on random cursors it
// moves more than the bound counts; and what limits it is issue: the
// decode's shuffles, its byte assembly and the ballots (more rows in
// flight did not make it faster; fewer instructions did).  On an NVIDIA
// H100 80GB HBM3 at 700 W (chip_smoke.py) 2^20 random cursors on 637,533
// rows take 0.3413 ms, 38% of their 0.1283 ms bound (a warp a cursor:
// 0.4382 ms), the same cursors sorted by block as the engine sends them
// 0.2370 ms, and two boolean batches 1.8727 ms of kernel time (a warp a
// cursor: 7.38 ms).
//
// What the design does about it: the TPU version rebuilt the byte gather
// as four one-hot matmuls because the TPU has no byte shuffle.  Here one
// warp decodes one row at a time (svb_tile.cuh).  decode_blocks gives each
// warp one row.  decode_search gathers the located row itself (rows,
// codec_row), so no gathered copy of the arena is ever materialised, and
// keeps rows in flight: one warp of a grid sized to the card walks a run
// of consecutive cursors, resolves their rows 32 at a time (the next batch
// already on its way) and stages each row with cp.async into a ring of 4
// slots of shared memory, its lens 3 cursors ahead and its bytes 2 ahead.
// A cursor on the block of the one before it stages and decodes nothing.
// Values are assembled from two aligned 32-bit words each.  The answer
// keeps the docIDs in registers and writes 8 B per cursor: the rank from
// four ballots + popc, the value from a masked warp min, stored 32 cursors
// at a time.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "svb_tile.cuh"

namespace {

constexpr int kWarps = 8;   // warps of a 256-thread block
// decode_search stages a cursor's lens 3 cursors ahead of its decode and its
// bytes 2 ahead, in a ring of 4 slots a warp
constexpr int kLensAhead = 3;
constexpr int kDataAhead = kLensAhead - 1;  // the waits assume this
constexpr int kSlots = kLensAhead + 1;

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

// The cursors' rows, resolved a batch of 32 at a time: lane j of a warp
// holds cursor j of the batch.  `repeat` (the same in every lane) has bit
// j set when cursor j needs no row of its own: its block row is the
// previous cursor's, or it lies past the warp's last cursor.
struct Batch {
  int row;        // block row
  int srow;       // row of lens / data
  unsigned base;  // block_base of the block row
  int probe;
  unsigned repeat;
};

// Batch b of the warp's run; `prev_row` is the last block row of batch
// b - 1 (ignored for b = 0).
__device__ __forceinline__ Batch load_batch(
    const int* __restrict__ block_base, const int* __restrict__ codec_row,
    const int* __restrict__ rows, const int* __restrict__ pe, long long first,
    int count, int b, int prev_row, int lane) {
  Batch m{0, 0, 0u, 0, 0u};
  const int k = 32 * b + lane;
  const bool in = k < count;
  if (in) {
    m.row = rows[first + k];
    m.srow = codec_row ? codec_row[m.row] : m.row;
    m.base = static_cast<unsigned>(block_base[m.row]);
    m.probe = pe[first + k];
  }
  const int before = __shfl_up_sync(kFull, m.row, 1);
  const bool same = lane > 0 ? before == m.row : b > 0 && prev_row == m.row;
  m.repeat = __ballot_sync(kFull, !in || same);
  return m;
}

// A warp walks `per_warp` consecutive cursors.  Cursor k's lens are staged
// kLensAhead cursors ahead of its decode and its bytes kDataAhead ahead, so
// while the warp decodes cursor k, the lens of k + 3 and the bytes of
// k + 1 and k + 2 are in flight.  Every step commits two copy groups
// (lens, then bytes; empty when there is nothing to copy), which fixes the
// waits.  A cursor on the same block row as the one before it (the
// engine's cursors come sorted, and its pow2 padding repeats a cursor)
// stages nothing and reuses the docIDs already in registers.
__global__ void __launch_bounds__(32 * kWarps) decode_search_kernel(
    const int* __restrict__ lens, const unsigned char* __restrict__ data,
    const int* __restrict__ block_base, const int* __restrict__ codec_row,
    const int* __restrict__ rows, const int* __restrict__ pe,
    int* __restrict__ value, int* __restrict__ rank, int n, int per_warp) {
  __shared__ __align__(16) unsigned char ring[kWarps][kSlots][kSlotBytes];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long first =
      (static_cast<long long>(blockIdx.x) * kWarps + warp) * per_warp;
  if (first >= n) return;  // warp-uniform: the whole warp leaves together
  const int count = static_cast<int>(min(static_cast<long long>(per_warp), n - first));
  int batch = 0;
  Batch cur = load_batch(block_base, codec_row, rows, pe, first, count, 0, 0, lane);
  Batch nxt = load_batch(block_base, codec_row, rows, pe, first, count, 1,
                         __shfl_sync(kFull, cur.row, 31), lane);
  // bit i: cursor k + i needs no row of its own (k the cursor being
  // decoded; the window moves on by one bit a cursor)
  unsigned long long window =
      cur.repeat | (static_cast<unsigned long long>(nxt.repeat) << 32);
  auto fresh = [&](int d) { return !((static_cast<unsigned>(window) >> d) & 1u); };
  // the storage row of cursor k + d, where j = k & 31 and j + d < 64
  auto srow_at = [&](int j, int d) -> long long {
    const int x = j + d;
    return __shfl_sync(kFull, x < 32 ? cur.srow : nxt.srow, x & 31);
  };
  // one step of the pipeline, for cursor k: the lens of k + kLensAhead,
  // then (once they have landed) the bytes of k + kDataAhead
  auto stage = [&](int k, int j, bool data_too) {
    if (fresh(kLensAhead)) {
      stage_lens(lens + srow_at(j, kLensAhead) * kVals,
                 ring[warp][(k + kLensAhead) % kSlots], lane);
    }
    cp_async_commit();
    cp_async_wait<2>();  // every group but the last two: k + kDataAhead's lens
    if (data_too && fresh(kDataAhead)) {
      stage_data(data + srow_at(j, kDataAhead) * kBytes,
                 ring[warp][(k + kDataAhead) % kSlots], lane);
    }
    cp_async_commit();
  };
  // the steps of cursors -3 .. -1: the lens of cursors 0 .. 2, and the
  // bytes of 0 and 1
#pragma unroll
  for (int c = 0; c < kLensAhead; ++c) {
    if (fresh(c)) stage_lens(lens + srow_at(0, c) * kVals, ring[warp][c], lane);
    cp_async_commit();
    cp_async_wait<2>();
    const int cd = c - (kLensAhead - kDataAhead);
    if (cd >= 0 && fresh(cd)) {
      stage_data(data + srow_at(0, cd) * kBytes, ring[warp][cd], lane);
    }
    cp_async_commit();
  }
  int my_value = 0, my_rank = 0;  // lane j: cursor j of the current batch
  int doc[4];
  for (int k = 0; k < count; ++k) {
    const int j = k & 31;
    stage(k, j, true);
    cp_async_wait<2 * kDataAhead>();  // this lane's copies of cursor k ...
    __syncwarp();                     // ... and every other lane's
    if (fresh(0)) {
      unsigned v[4];
      decode_staged(ring[warp][k % kSlots], lane, v);
      row_docids(__shfl_sync(kFull, cur.base, j), v, lane, doc);
    }
    const int probe = __shfl_sync(kFull, cur.probe, j);
    int below_count = 0;
    int best = INT_MAX;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool below = doc[e] < probe;
      below_count += __popc(__ballot_sync(kFull, below));
      if (!below) best = min(best, doc[e]);
    }
    best = __reduce_min_sync(kFull, best);
    if (lane == j) {
      my_value = best;
      my_rank = below_count;
    }
    __syncwarp();  // cursor k's slot is refilled only after every lane read it
    window >>= 1;
    if (j == 31 || k == count - 1) {  // the batch is done: one coalesced store
      if (lane <= j) {
        value[first + k - j + lane] = my_value;
        rank[first + k - j + lane] = my_rank;
      }
      ++batch;
      cur = nxt;
      nxt = load_batch(block_base, codec_row, rows, pe, first, count, batch + 1,
                       __shfl_sync(kFull, cur.row, 31), lane);
      window |= static_cast<unsigned long long>(nxt.repeat) << 32;
    }
  }
}

inline unsigned grid_for(int n) { return (n + kWarps - 1) / kWarps; }

// decode_search's grid: every warp the card holds at once, or one warp a
// cursor when there are fewer cursors than that.
inline void search_grid(int n, unsigned* blocks, int* per_warp) {
  static const int resident = [] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_search_kernel,
                                                  32 * kWarps, 0);
    return max(sms * per_sm, 1);
  }();
  const long long want = (static_cast<long long>(n) + kWarps - 1) / kWarps;
  *blocks = static_cast<unsigned>(min(want, static_cast<long long>(resident)));
  const long long warps = static_cast<long long>(*blocks) * kWarps;
  *per_warp = static_cast<int>((n + warps - 1) / warps);
}

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
    unsigned blocks;
    int per_warp;
    search_grid(n, &blocks, &per_warp);
    decode_search_kernel<<<blocks, 32 * kWarps, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(lens), static_cast<const unsigned char*>(data),
        static_cast<const int*>(block_base),
        static_cast<const int*>(codec_row), static_cast<const int*>(rows),
        static_cast<const int*>(pe), static_cast<int*>(value),
        static_cast<int*>(rank), n, per_warp);
  }
  return static_cast<int>(cudaGetLastError());
}
