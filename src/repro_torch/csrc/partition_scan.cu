// The paper's dominating-point state machine as a warp-cooperative
// segmented scan, for sm_90a.
//
// Replaces the lax.scan of repro/core/partition.py::optimal_partitioning_jax
// (an XLA loop, not a Pallas kernel) -> partition_scan below.
//
// The machine carries (T, i, j, g, mn, mx, k) in int32 from one element to
// the next; each step adds the element's gain delta to g, moves the
// running min or max, and may emit a boundary (emit_e and emit_b exclude
// each other).  mask[k] records whether step k emitted, pos[k] the boundary
// (new_j after an E emission, new_i otherwise), and the carry after the
// last step goes to the host, which applies close().
//
// Between two emissions the machine is a set of scans, so a warp runs many
// steps at once and still reproduces the reference step for step:
//   - g is the wrapped prefix sum of the deltas from the carried g;
//   - (mx, i) is the running max of g over the steps with d >= 0, and i the
//     first step that reached it (strict >: the earlier step wins a tie);
//     (mn, j) the running min over the steps with d < 0;
//   - the E and B tests of step k read mn and mx as they stood before k.
// An emission re-seeds the carry from the emitting step alone: E at step k
// sets g to g - mn, mn 0, mx g, i k + 1 and keeps j; B sets g to g - mx,
// mx 0, mn g, j k + 1 and keeps i; both set T to 2F.
//
// What bounds it: the emissions, in principle.  Each one decides the carry
// every later step reads, so the emissions form a chain of at least a
// compare and a select each; the steps between two emissions are
// independent scans, and the bytes (4 B read and 5 B written a step) are
// a small share of the card's rate.  In practice: one list a launch, so
// one warp does the whole list, and its time is the warp's integer issue
// rate (16 lanes a cycle for most integer instructions) and the latency of
// its shuffles, paid once a round and again at every emission.
//
// What the design does about it: the warp walks the list in rounds of
// kRound = 512 steps, 16 consecutive steps a lane (four 16-byte loads; the
// next round's already in registers and the one after in flight, four
// rounds ahead prefetched to L2).  A round's prefix sum of the deltas is
// scanned while the round before it is evaluated, since it does not depend
// on the carry.  An evaluation runs, for every step still open:
//   - seeded running max and min (a run per lane, then warp shuffles).
//     Each step enters as two candidates: its g for the max if d >= 0,
//     else INT_MIN; its g for the min if d < 0, else INT_MAX.  The neutral
//     values are exact for every test below, so no step carries a flag;
//   - the lane's last up and down step, and those before the lane (a
//     ballot and one shuffle each: such steps only move forward);
//   - the E and B tests of every step, last step first so that the
//     lane's first emitting step is the one kept; a warp min-reduction
//     gives the round's first emitting step.
// The steps before it commit (pos new_i, mask 0), the emitting step
// commits with mask 1, the warp re-seeds the carry from the emitting step
// alone and evaluates the rest of the round again.  A round's first pass
// skips the per-step test of which steps are open; only the restarts and
// the short last round (its lanes past n masked) pay for it.  pos and mask
// leave as 16-byte stores per lane; for the boundaries alone the emitting
// lane writes each boundary in order, and mask and pos are not written.
//
// int32 arithmetic wraps through uint32, as the reference's int32 does,
// without signed overflow; every compare is on the same wrapped int32
// values as the reference's.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kRun = 16;             // consecutive steps a lane holds
constexpr int kRound = 32 * kRun;    // steps a round
constexpr int kPrefetchRounds = 4;   // rounds ahead prefetched to L2
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

// The kRun deltas of one lane from step `first`, 0 past n: 16-byte loads
// when the whole run lies inside, one guarded load a step otherwise.
__device__ __forceinline__ void load_run(const int* __restrict__ deltas,
                                         int first, int n, int* d) {
  if (first + kRun <= n) {
    const int4* d4 = reinterpret_cast<const int4*>(deltas + first);
#pragma unroll
    for (int q = 0; q < kRun / 4; ++q) {
      const int4 x = d4[q];
      d[4 * q] = x.x;
      d[4 * q + 1] = x.y;
      d[4 * q + 2] = x.z;
      d[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int u = 0; u < kRun; ++u) d[u] = first + u < n ? deltas[first + u] : 0;
  }
}

// Exclusive prefix sum across the warp; lane 0 gets 0.
__device__ __forceinline__ uint32_t warp_excl_sum(uint32_t v, int lane) {
  uint32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t t = __shfl_up_sync(kFull, x, o);
    x += lane >= o ? t : 0u;
  }
  return x - v;
}

// Running min and max across the warp, exclusive, seeded: lane 0 gets the
// seeds.  A lane below the offset gets its own value back from the
// shuffle, which min and max ignore.
__device__ __forceinline__ void warp_excl_min_max(int& lo, int& hi, int lo0,
                                                  int hi0, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    lo = min(lo, __shfl_up_sync(kFull, lo, o));
    hi = max(hi, __shfl_up_sync(kFull, hi, o));
  }
  const int l = __shfl_up_sync(kFull, lo, 1);
  const int h = __shfl_up_sync(kFull, hi, 1);
  lo = lane ? min(l, lo0) : lo0;
  hi = lane ? max(h, hi0) : hi0;
}

// One evaluation of a round from its first uncommitted step.  Each step
// enters as two candidates: gx, its g if it may move mx (evaluated, d >=
// 0), else INT_MIN; gn, its g if it may move mn (evaluated, d < 0), else
// INT_MAX.  The neutral values are exact, not only for the scans: a step
// with gx == INT_MIN can neither set a new max nor pass the E test (with
// mn < -T, mn - INT_MIN wraps to >= 0 >= -2F), and one with gn == INT_MAX
// neither a new min nor the B test (with mx > T, mx - INT_MAX <= 0 <= 2F),
// whatever its real g.  So no step needs a flag of its own.
struct Pass {
  int gx[kRun], gn[kRun];  // the two candidates
  int bmx[kRun];           // mx as it stood before each step
  int bmn[kRun];           // mn likewise
  int li[kRun];  // the lane's last up step (a new max) up to u, else -1
  int lj[kRun];  // the lane's last down step (a new min) up to u, else -1
  int mx, mn;    // mx and mn after the lane's last step
  int wi, wj;    // the last up and down step before the lane, else ci, cj
  int fe;        // the lane's first emitting step, kRun if none
};

// Which steps of a lane's run an evaluation takes: kAll every one (a whole
// round's first pass); otherwise u >= lo, and with kTail also u < hi (the
// last round, past n).
template <bool kAll, bool kTail>
__device__ __forceinline__ void evaluate(Pass& v, const int* cur,
                                         const uint32_t* P, uint32_t off,
                                         int lo, int hi, int kb, int T,
                                         int F2, int ci, int cj, int cmx,
                                         int cmn, int lane) {
  // running max of gx and min of gn: a run per lane (exclusive at each
  // step), then the warp, seeded
  int lmx = INT_MIN, lmn = INT_MAX;
#pragma unroll
  for (int u = 0; u < kRun; ++u) {
    const int g = static_cast<int>(off + P[u]);
    const bool on = kAll || (u >= lo && (!kTail || u < hi));
    v.gx[u] = on && cur[u] >= 0 ? g : INT_MIN;
    v.gn[u] = on && cur[u] < 0 ? g : INT_MAX;
    v.bmx[u] = lmx;
    v.bmn[u] = lmn;
    lmx = max(lmx, v.gx[u]);
    lmn = min(lmn, v.gn[u]);
  }
  int wmn = lmn, wmx = lmx;
  warp_excl_min_max(wmn, wmx, cmn, cmx, lane);
  v.mx = max(wmx, lmx);
  v.mn = min(wmn, lmn);

  // mn and mx before each step, and the lane's last up and down steps
  int last_i = -1, last_j = -1;
#pragma unroll
  for (int u = 0; u < kRun; ++u) {
    v.bmx[u] = max(wmx, v.bmx[u]);
    v.bmn[u] = min(wmn, v.bmn[u]);
    last_i = v.gx[u] > v.bmx[u] ? kb + u : last_i;
    last_j = v.gn[u] < v.bmn[u] ? kb + u : last_j;
    v.li[u] = last_i;
    v.lj[u] = last_j;
  }
  // the emission tests, last step first, so that the first emitting step
  // is the one kept
  int fe = kRun;
#pragma unroll
  for (int u = kRun - 1; u >= 0; --u) {
    const int bx = v.bmx[u], bn = v.bmn[u];
    fe = (bn < -T) & (wsub(bn, v.gx[u]) < -F2) ? u : fe;
    fe = (bx > T) & (wsub(bx, v.gn[u]) > F2) ? u : fe;
  }
  v.fe = fe;
  // up and down steps only move forward, so the last one before the lane
  // is the highest lane below it that has one
  const uint32_t below = (1u << lane) - 1u;
  const uint32_t bu = __ballot_sync(kFull, last_i >= 0) & below;
  const uint32_t bd = __ballot_sync(kFull, last_j >= 0) & below;
  const int wi = __shfl_sync(kFull, last_i, bu ? 31 - __clz(bu) : 0);
  const int wj = __shfl_sync(kFull, last_j, bd ? 31 - __clz(bd) : 0);
  v.wi = bu ? wi : ci;
  v.wj = bd ? wj : cj;
}

// What the emitting step leaves: its two candidates, mn and mx before it,
// and the lane's last up and down step up to it.
struct Emit {
  int gx, gn, mn, mx, li, lj;
};

// Step eu of the lane's run (eu the same in every lane: a uniform switch,
// not an index into registers).
__device__ __forceinline__ Emit read_step(const Pass& v, int eu) {
  Emit o{};
  switch (eu) {
#define PICK(U)                                                          \
  case U:                                                                \
    o = Emit{v.gx[U], v.gn[U], v.bmn[U], v.bmx[U], v.li[U], v.lj[U]};    \
    break;
    PICK(0) PICK(1) PICK(2) PICK(3) PICK(4) PICK(5) PICK(6) PICK(7)
    PICK(8) PICK(9) PICK(10) PICK(11) PICK(12) PICK(13) PICK(14) PICK(15)
#undef PICK
  }
  return o;
}
static_assert(kRun == 16, "read_step names each step of a run");

// The carry, the same in every lane: T, i, j, g, mn, mx, and the count of
// emissions so far.
struct Carry {
  int T, i, j, mn, mx;
  uint32_t g;
  int emitted;
};

// The round's prefix of the deltas, from 0 at its start.
__device__ __forceinline__ void round_prefix(const int* d, uint32_t* P,
                                             int lane) {
  uint32_t acc = 0;
#pragma unroll
  for (int u = 0; u < kRun; ++u) {
    acc += static_cast<uint32_t>(d[u]);
    P[u] = acc;
  }
  const uint32_t ex = warp_excl_sum(acc, lane);
#pragma unroll
  for (int u = 0; u < kRun; ++u) P[u] += ex;
}

// One round: evaluate, commit up to the first emission, re-seed, evaluate
// again, until no emission is left; then write the lane's mask and pos
// (kPos).  kTail: the last round, cnt < kRound steps.
template <bool kPos, bool kTail>
__device__ __forceinline__ void run_round(Carry& c, const int* cur,
                                          const uint32_t* P, int base,
                                          int cnt, int F2, uint8_t* mask,
                                          int* pos, int* bounds, int lane) {
  const int s0 = lane * kRun;    // round index of the lane's first step
  const int hi = cnt - s0;       // the lane's steps before n: u < hi
  const int kb = base + s0 + 1;  // k + 1 of the lane's first step
  int pv[kRun];                  // pos of each step, as committed
  uint32_t mbits = 0;            // bit u: step u emitted
  uint32_t off = c.g;            // g of a step = off + P
  int lo = 0;                    // the lane's steps to evaluate: u >= lo
  Pass v;
  evaluate<!kTail, kTail>(v, cur, P, off, lo, hi, kb, c.T, F2, c.i, c.j,
                          c.mx, c.mn, lane);
  while (true) {
    if (kPos) {
      // pos = new_i of every step evaluated; the steps after the first
      // emission are evaluated and written again.  A lane's steps come
      // after every earlier lane's and the carry's, so new_i is the larger
      // of the lane's own last up step and wi.
#pragma unroll
      for (int u = 0; u < kRun; ++u) {
        pv[u] = u >= lo ? max(v.li[u], v.wi) : pv[u];
      }
    }
    // the first emitting step of the round, kRound if none
    const int e = __reduce_min_sync(kFull, v.fe < kRun ? s0 + v.fe : kRound);
    if (e == kRound) {
      // the carry after the round's last step, which lane 31 holds (steps
      // past n add 0 and move nothing)
      c.g = __shfl_sync(kFull, off + P[kRun - 1], 31);
      c.mx = __shfl_sync(kFull, v.mx, 31);
      c.mn = __shfl_sync(kFull, v.mn, 31);
      c.i = __shfl_sync(kFull, max(v.li[kRun - 1], v.wi), 31);
      c.j = __shfl_sync(kFull, max(v.lj[kRun - 1], v.wj), 31);
      break;
    }

    // the emitting step (rare), step eu of lane el: an E emission when it
    // could move mx (its delta is >= 0), a B emission otherwise.  E takes
    // away mn, B mx; the carry it leaves comes from lane el.
    const int el = e / kRun, eu = e % kRun;
    const Emit o = read_step(v, eu);
    const bool is_e = o.gx != INT_MIN;
    const int new_i = max(o.li, v.wi), new_j = max(o.lj, v.wj);
    const int x = is_e ? o.mn : o.mx;
    const int g2 = wsub(is_e ? o.gx : o.gn, x);
    const int pe = is_e ? new_j : new_i;
    if (lane == el) {
      if (kPos) {
#pragma unroll
        for (int u = 0; u < kRun; ++u) pv[u] = u == eu ? pe : pv[u];
      }
      mbits |= 1u << eu;
      if (bounds) bounds[c.emitted] = pe;
    }
    c.mn = __shfl_sync(kFull, is_e ? 0 : g2, el);
    c.mx = __shfl_sync(kFull, is_e ? g2 : 0, el);
    c.i = __shfl_sync(kFull, is_e ? kb + eu : new_i, el);
    c.j = __shfl_sync(kFull, is_e ? new_j : kb + eu, el);
    off -= static_cast<uint32_t>(__shfl_sync(kFull, x, el));
    c.T = F2;
    ++c.emitted;
    lo = e + 1 - s0;
    evaluate<false, kTail>(v, cur, P, off, lo, hi, kb, c.T, F2, c.i, c.j,
                           c.mx, c.mn, lane);
  }

  if (kPos) {
    const int first = base + s0;
    if (!kTail || s0 + kRun <= cnt) {
      int4* p4 = reinterpret_cast<int4*>(pos + first);
      uint32_t m[kRun / 4];
#pragma unroll
      for (int q = 0; q < kRun / 4; ++q) {
        p4[q] = make_int4(pv[4 * q], pv[4 * q + 1], pv[4 * q + 2],
                          pv[4 * q + 3]);
        // four bits to four bytes: the multiply puts bit v at bit 8v
        m[q] = (((mbits >> (4 * q)) & 0xfu) * 0x204081u) & 0x01010101u;
      }
      *reinterpret_cast<uint4*>(mask + first) =
          make_uint4(m[0], m[1], m[2], m[3]);
    } else {
#pragma unroll
      for (int u = 0; u < kRun; ++u) {
        if (u < hi) {
          pos[first + u] = pv[u];
          mask[first + u] = (mbits >> u) & 1u;
        }
      }
    }
  }
}

// kPos: write mask and pos of every step; otherwise the boundaries alone.
// The whole rounds run first, each beside the prefix scan of the round
// after it (which does not depend on the carry); the last round, if it is
// short, runs alone with its lanes past n masked.
template <bool kPos>
__global__ void __launch_bounds__(32, 1) partition_scan_kernel(
    const int* __restrict__ deltas, uint8_t* __restrict__ mask,
    int* __restrict__ pos, int* __restrict__ bounds, int* __restrict__ carry,
    int n, int F) {
  const int lane = threadIdx.x;
  const int s0 = lane * kRun;
  const int F2 = 2 * F;
  Carry c{F, 0, 0, 0, 0, 0u, 0};
  int cur[kRun], nxt[kRun];
  uint32_t P[kRun];
  load_run(deltas, s0, n, cur);
  load_run(deltas, kRound + s0, n, nxt);
  round_prefix(cur, P, lane);
  int base = 0;
  for (; base + kRound <= n; base += kRound) {
    int nx2[kRun];
    load_run(deltas, base + 2 * kRound + s0, n, nx2);
    const int ahead = base + kPrefetchRounds * kRound + s0;
    if (ahead < n) {
      asm volatile("prefetch.global.L2 [%0];" ::"l"(deltas + ahead));
    }
    uint32_t Pn[kRun];
    round_prefix(nxt, Pn, lane);
    run_round<kPos, false>(c, cur, P, base, kRound, F2, mask, pos, bounds,
                           lane);
#pragma unroll
    for (int u = 0; u < kRun; ++u) {
      cur[u] = nxt[u];
      nxt[u] = nx2[u];
      P[u] = Pn[u];
    }
  }
  if (base < n) {
    run_round<kPos, true>(c, cur, P, base, n - base, F2, mask, pos, bounds,
                          lane);
  }
  if (lane == 0) {
    carry[0] = c.T;
    carry[1] = c.i;
    carry[2] = c.j;
    carry[3] = static_cast<int>(c.g);
    carry[4] = c.mn;
    carry[5] = c.mx;
    carry[6] = n;
    carry[7] = c.emitted;
  }
}

}  // namespace

// deltas [n] int32 -> carry [8] int32: (T, i, j, g, mn, mx, k) after the
// last step, then the number of emissions.  With mask and pos given:
// mask [n] uint8 (0/1) and pos [n] int32 of every step.  With bounds
// given: bounds [n] int32, whose first carry[7] entries are the emitted
// boundaries in order.  Either pair may be null.  deltas, mask and pos
// 16-byte aligned (the wrapper checks deltas and allocates the rest);
// 0 <= F < 2^30.
extern "C" int partition_scan(const void* deltas, void* mask, void* pos,
                              void* bounds, void* carry, int n, int F,
                              void* stream) {
  auto kernel = mask ? partition_scan_kernel<true> : partition_scan_kernel<false>;
  kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(deltas), static_cast<uint8_t*>(mask),
      static_cast<int*>(pos), static_cast<int*>(bounds),
      static_cast<int*>(carry), n, F);
  return static_cast<int>(cudaGetLastError());
}
