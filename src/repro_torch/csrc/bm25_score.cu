// Fused freq decode + BM25 scoring over the ranked arena, for sm_90a.
//
// Replaces the TPU kernels of repro/kernels/bm25_score/kernel.py:
//   bm25_score_blocks       -> bm25_score_rows below
//   bm25_score_probe_blocks -> bm25_score_probe below
//
// The ranked sidecar stores term frequencies as a PARALLEL Stream-VByte
// block stream (freq_lens / freq_data, lane-aligned with the docID blocks,
// one row per block whatever the docID codec) plus a u8 length-norm code
// per lane (norm_q).  Scoring a row is: decode the freq tile with the warp
// decoder of svb_tile.cuh, gather K_hat from the 256-entry norm table, and
// evaluate the f32 contract of bm25_tile.cuh.  idf is a property of the
// row's owning list and is read as idf[lob[row]].
//
// What bounds it: bytes.  Per scored row 512 B of freq lens + 512 B of freq
// data + 128 B of norm codes are read and 512 B of scores written (about
// 1.66 KB); the probe kernel adds the 1 KB docID tile and writes 4 B per
// cursor (about 2.2 KB per cursor).  The arithmetic is one division and a
// few multiplies per lane.
//
// What the design does about it: the TPU version gathered rows and the
// per-row idf into [nr,128] staging tiles in XLA and rebuilt the norm
// gather as a one-hot MXU matmul.  Here each warp gathers its own row
// through `rows` (so no gathered copy of the arena and no fmeta tile ever
// exist), the table lives in shared memory (1 KB per block), and the probe
// kernel decodes the freq tile only when the probe matched a lane of the
// docID tile (a ballot), scoring just that lane.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "bm25_tile.cuh"
#include "svb_tile.cuh"

namespace {

constexpr int kWarps = 8;  // rows (or cursors) per 256-thread block

__global__ void __launch_bounds__(32 * kWarps) score_rows_kernel(
    const int* __restrict__ flens, const unsigned char* __restrict__ fdata,
    const unsigned char* __restrict__ norm_q, const float* __restrict__ idf,
    const int* __restrict__ lob, const float* __restrict__ table,
    const int* __restrict__ rows, float* __restrict__ out, int n, float k1p1) {
  __shared__ float tab[kNormLevels];
  __shared__ __align__(16) unsigned char smem[kWarps][kBytes];
  load_table(table, tab);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long c = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (c >= n) return;  // warp-uniform, after the block-wide table load
  const long long row = rows ? rows[c] : c;
  float s[4];
  score_row(flens + row * kVals, fdata + row * kBytes, norm_q + row * kVals,
            tab, idf[lob[row]], k1p1, smem[warp], lane, s);
  reinterpret_cast<float4*>(out + c * kVals)[lane] =
      make_float4(s[0], s[1], s[2], s[3]);
}

__global__ void __launch_bounds__(32 * kWarps) score_probe_kernel(
    const int* __restrict__ lens, const unsigned char* __restrict__ data,
    const int* __restrict__ block_base, const int* __restrict__ codec_row,
    const int* __restrict__ flens, const unsigned char* __restrict__ fdata,
    const unsigned char* __restrict__ norm_q, const float* __restrict__ idf,
    const int* __restrict__ lob, const float* __restrict__ table,
    const int* __restrict__ rows, const int* __restrict__ pe,
    float* __restrict__ out, int n, float k1p1) {
  __shared__ float tab[kNormLevels];
  __shared__ __align__(16) unsigned char smem[kWarps][kBytes];
  load_table(table, tab);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long c = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (c >= n) return;  // warp-uniform
  const long long row = rows[c];
  const long long srow = codec_row ? codec_row[row] : row;
  const int probe = pe[c];
  unsigned v[4];
  decode_row(lens + srow * kVals, data + srow * kBytes, smem[warp], lane, v);
  int doc[4];
  row_docids(static_cast<unsigned>(block_base[row]), v, lane, doc);
  // docIDs ascend within a row, so at most one lane matches; take the
  // lowest (lane 4t + e) should malformed rows hold several
  int hit = INT_MAX;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const unsigned b = __ballot_sync(kFull, doc[e] == probe);
    if (b) hit = min(hit, 4 * (__ffs(b) - 1) + e);
  }
  if (hit == INT_MAX) {  // warp-uniform: absent, no freq bytes read
    if (lane == 0) out[c] = 0.0f;
    return;
  }
  __syncwarp();  // every lane is done with the docID bytes in smem
  decode_row(flens + row * kVals, fdata + row * kBytes, smem[warp], lane, v);
  if (lane == (hit >> 2)) {
    const int e = hit & 3;
    const float k_hat = tab[norm_q[row * kVals + hit]];
    out[c] = bm25_contract(idf[lob[row]], tf_of(v[e]), k1p1, k_hat);
  }
}

inline unsigned grid_for(int n) { return (n + kWarps - 1) / kWarps; }

}  // namespace

extern "C" int bm25_score_rows(const void* flens, const void* fdata,
                               const void* norm_q, const void* idf,
                               const void* lob, const void* table,
                               const void* rows, void* out, int n, float k1p1,
                               void* stream) {
  if (n > 0) {
    score_rows_kernel<<<grid_for(n), 32 * kWarps, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(flens),
        static_cast<const unsigned char*>(fdata),
        static_cast<const unsigned char*>(norm_q),
        static_cast<const float*>(idf), static_cast<const int*>(lob),
        static_cast<const float*>(table), static_cast<const int*>(rows),
        static_cast<float*>(out), n, k1p1);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bm25_score_probe(const void* lens, const void* data,
                                const void* block_base, const void* codec_row,
                                const void* flens, const void* fdata,
                                const void* norm_q, const void* idf,
                                const void* lob, const void* table,
                                const void* rows, const void* pe, void* out,
                                int n, float k1p1, void* stream) {
  if (n > 0) {
    score_probe_kernel<<<grid_for(n), 32 * kWarps, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(lens), static_cast<const unsigned char*>(data),
        static_cast<const int*>(block_base),
        static_cast<const int*>(codec_row), static_cast<const int*>(flens),
        static_cast<const unsigned char*>(fdata),
        static_cast<const unsigned char*>(norm_q),
        static_cast<const float*>(idf), static_cast<const int*>(lob),
        static_cast<const float*>(table), static_cast<const int*>(rows),
        static_cast<const int*>(pe), static_cast<float*>(out), n, k1p1);
  }
  return static_cast<int>(cudaGetLastError());
}
