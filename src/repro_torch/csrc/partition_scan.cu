// The paper's dominating-point state machine, one step per element, for
// sm_90a.
//
// Replaces the lax.scan of repro/core/partition.py::optimal_partitioning_jax
// (an XLA loop, not a Pallas kernel) -> partition_scan below.
//
// The machine carries (T, i, j, g, mn, mx, k) in int32 from one element to
// the next; each step adds the element's gain delta to g, moves the
// running min or max, and may emit a boundary (emit_e and emit_b exclude
// each other).  mask[k] records whether step k emitted, pos[k] the boundary
// (new_j after an E emission, new_i otherwise), and the carry after the
// last step goes to the host, which applies close().  The step is the
// jnp.where logic of the reference, select for select.
//
// What bounds it: operations, as one dependency chain.  Every step needs
// the g, mn and mx of the step before: at least a compare and a select
// per step.  As compiled for sm_90a, though, one step is about 35
// instructions with a carried chain of about 7, and the single thread's
// issue schedule, not the chain, sets its time (chip_smoke.py's scan_sass
// reads the SASS).  The bytes (4 B read, 5 B written per element) take a
// thousandth of that time.
//
// What the design does about it: one thread walks the sequence.  Nothing
// leaves the chain: the deltas come 16 at a time as 16-byte loads issued a
// chunk ahead, and pos and mask leave as 16-byte stores, so no step waits
// on memory.  A faster design (blocked, with a carry per block as the
// blocked partitioner does) is later work.
//
// int32 arithmetic wraps through uint32, as the reference's int32 does,
// without signed overflow.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16;  // deltas per 16-byte-load group

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

struct Carry {
  int T, i, j, g, mn, mx, k;
};

// One step of optimal_partitioning_jax's scan; returns emit, sets pos.
__device__ __forceinline__ bool step(Carry& c, int dk, int F2, int& pos) {
  const int k1 = wadd(c.k, 1);
  const int g = wadd(c.g, dk);
  const bool nondec = dk >= 0;

  // non-decreasing branch
  const bool up = nondec && g > c.mx;
  const int new_mx = up ? g : c.mx;
  const int new_i = up ? k1 : c.i;
  const bool emit_e = nondec && c.mn < -c.T && wsub(c.mn, g) < -F2;

  // decreasing branch
  const bool down = !nondec && g < c.mn;
  const int new_mn = down ? g : c.mn;
  const int new_j = down ? k1 : c.j;
  const bool emit_b = !nondec && c.mx > c.T && wsub(c.mx, g) > F2;

  const bool emit = emit_e || emit_b;
  pos = emit_e ? new_j : new_i;

  // apply update() effects
  const int g2 = emit_e ? wsub(g, new_mn) : (emit_b ? wsub(g, new_mx) : g);
  c.T = emit ? F2 : c.T;
  c.mn = emit_e ? 0 : (emit_b ? g2 : new_mn);
  c.mx = emit_e ? g2 : (emit_b ? 0 : new_mx);
  c.i = emit_e ? k1 : new_i;
  c.j = emit_b ? k1 : new_j;
  c.g = g2;
  c.k = k1;
  return emit;
}

__global__ void __launch_bounds__(32) partition_scan_kernel(
    const int* __restrict__ deltas, uint8_t* __restrict__ mask,
    int* __restrict__ pos, int* __restrict__ carry, int n, int F) {
  if (threadIdx.x != 0) return;
  const int F2 = 2 * F;
  Carry c{F, 0, 0, 0, 0, 0, 0};
  const int n_full = n - n % kChunk;
  const int4* d4 = reinterpret_cast<const int4*>(deltas);
  int4 cur[4], nxt[4];
  if (n_full) {
#pragma unroll
    for (int q = 0; q < 4; ++q) cur[q] = d4[q];
  }
  for (int base = 0; base < n_full; base += kChunk) {
    if (base + kChunk < n_full) {
#pragma unroll
      for (int q = 0; q < 4; ++q) nxt[q] = d4[(base + kChunk) / 4 + q];
    }
    int p[kChunk];
    uint32_t m[kChunk / 4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int d[4] = {cur[q].x, cur[q].y, cur[q].z, cur[q].w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (step(c, d[u], F2, p[4 * q + u])) m[q] |= 1u << (8 * u);
      }
    }
    int4* p4 = reinterpret_cast<int4*>(pos + base);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      p4[q] = make_int4(p[4 * q], p[4 * q + 1], p[4 * q + 2], p[4 * q + 3]);
    }
    *reinterpret_cast<uint4*>(mask + base) = make_uint4(m[0], m[1], m[2], m[3]);
#pragma unroll
    for (int q = 0; q < 4; ++q) cur[q] = nxt[q];
  }
  for (int k = n_full; k < n; ++k) {
    int p;
    mask[k] = step(c, deltas[k], F2, p) ? 1 : 0;
    pos[k] = p;
  }
  carry[0] = c.T;
  carry[1] = c.i;
  carry[2] = c.j;
  carry[3] = c.g;
  carry[4] = c.mn;
  carry[5] = c.mx;
  carry[6] = c.k;
}

}  // namespace

// deltas [n] int32 -> mask [n] uint8 (0/1), pos [n] int32, carry [7] int32.
// deltas, mask and pos 16-byte aligned (the wrapper checks deltas and
// allocates the rest); 0 <= F < 2^30.
extern "C" int partition_scan(const void* deltas, void* mask, void* pos,
                              void* carry, int n, int F, void* stream) {
  partition_scan_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(deltas), static_cast<uint8_t*>(mask),
      static_cast<int*>(pos), static_cast<int*>(carry), n, F);
  return static_cast<int>(cudaGetLastError());
}
