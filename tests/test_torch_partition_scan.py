"""The port's scan partitioner against the JAX package: the scan state
machine against ``optimal_partitioning_jax`` (carry, mask, and pos where
mask), and ``optimal_partitioning_via_scan`` / ``optimal_partitioning_blocked``
against the JAX ones and the paper's loop.  A numpy emulation of the CUDA
kernel's rounds (seeded warp scans, the first emission, commit and re-seed)
is held to the plain version and to the JAX scan.  Every comparison is
exact; the CUDA kernel is held to its plain version only on a card (``cuda``
marker)."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from repro.core.costs import gain_deltas_np
from repro.core import partition as rpart
from repro.kernels.gain_scan.ops import optimal_partitioning_blocked as ref_blocked

from repro_torch.core import partition as tpart
from repro_torch.kernels.gain_scan.ops import optimal_partitioning_blocked
from repro_torch.kernels.partition_scan import kernel as tk
from repro_torch.kernels.partition_scan.ref import partition_scan_ref

I32_MIN, I32_MAX = -(2**31), 2**31 - 1
LANES = 32
# deltas near the int32 limits, where g and its differences wrap
EXTREME = np.random.default_rng(9).choice(
    [2**31 - 1, -(2**31), 2**30, -(2**30), 1, -1, 0], 400).astype(np.int32)


def _gaps(rng, n, dense_frac=0.7, max_sparse=5000):
    return np.where(
        rng.random(n) < dense_frac,
        rng.integers(1, 3, n),
        rng.integers(1, max_sparse, n),
    ).astype(np.int64)


def _assert_scan_matches(deltas, F):
    carry, mask, pos = tpart.optimal_partitioning_scan(deltas, F, device="cpu")
    wc, wm, wp = rpart.optimal_partitioning_jax(
        jnp.asarray(deltas, dtype=jnp.int32), F=F)
    assert carry.dtype == pos.dtype == torch.int32 and mask.dtype == torch.bool
    assert carry.tolist() == [int(x) for x in wc]
    wm = np.asarray(wm)
    assert np.array_equal(mask.numpy(), wm)
    assert np.array_equal(pos.numpy()[wm], np.asarray(wp)[wm])
    return mask


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("F", [16, 64, 256])
def test_scan_matches_lax_scan(seed, F):
    rng = np.random.default_rng(40 + seed)
    deltas = gain_deltas_np(_gaps(rng, int(rng.integers(1, 2500))))
    _assert_scan_matches(deltas, F)


def test_scan_matches_lax_scan_on_extreme_deltas():
    """Deltas near the int32 limits, where g and its differences wrap."""
    mask = _assert_scan_matches(EXTREME, 64)
    assert mask.any()


@pytest.mark.parametrize("F", [16, 64, 256])
@pytest.mark.parametrize("n", [1, 2, None])
def test_scan_and_blocked_partitioners_match_reference(F, n):
    rng = np.random.default_rng(F * 7 + (n or 0))
    n = n or int(rng.integers(3, 3000))
    gaps = _gaps(rng, n)
    want = rpart.optimal_partitioning(gaps, F)
    got = tpart.optimal_partitioning_via_scan(gaps, F, device="cpu")
    assert got.dtype == np.int64
    assert np.array_equal(got, rpart.optimal_partitioning_via_scan(gaps, F))
    assert np.array_equal(got, want)
    assert np.array_equal(tpart.optimal_partitioning(gaps, F), want)
    blocked = optimal_partitioning_blocked(gaps, F, device="cpu")
    assert np.array_equal(blocked, ref_blocked(gaps, F))
    assert np.array_equal(blocked, want)


def test_empty_sequence():
    empty = np.zeros(0, np.int64)
    assert tpart.optimal_partitioning_via_scan(empty).tolist() == [0]
    assert optimal_partitioning_blocked(empty, device="cpu").tolist() == [0]
    carry, mask, pos = tpart.optimal_partitioning_scan(empty, 64, device="cpu")
    assert carry.tolist() == [64, 0, 0, 0, 0, 0, 0]
    assert mask.numel() == pos.numel() == 0


@given(
    gaps=st.lists(
        st.one_of(st.integers(1, 2), st.integers(1, 100_000)), min_size=1, max_size=120
    ),
    F=st.sampled_from([8, 64, 128]),
)
@settings(max_examples=60, deadline=None)
def test_property_optimality(gaps, F):
    gaps = np.asarray(gaps, dtype=np.int64)
    c_dp, _ = rpart.dp_optimal(gaps, F)
    P = tpart.optimal_partitioning_via_scan(gaps, F, device="cpu")
    assert rpart.partitioning_cost(gaps, P, F) == c_dp
    assert np.array_equal(optimal_partitioning_blocked(gaps, F, device="cpu"), P)
    # strictly increasing endpoints, last == n
    assert (np.diff(P) > 0).all() or len(P) == 1
    assert P[-1] == len(gaps)


def test_cpu_tensors_take_the_plain_version():
    d = torch.from_numpy(gain_deltas_np(_gaps(np.random.default_rng(3), 700)))
    before = tk.partition_scan.launches
    for g, w in zip(tk.partition_scan(d.int(), 64), partition_scan_ref(d, 64)):
        assert torch.equal(g, w)
    assert tk.partition_scan.launches == before
    with pytest.raises(ValueError, match="F must lie"):
        tk.partition_scan(d.int(), 2**30)


def test_entry_points_run_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpart.optimal_partitioning_via_scan(np.array([1, 2, 3]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpart.optimal_partitioning_scan(np.array([1, -2, 3]))


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    rng = np.random.default_rng(6)
    # lengths around a lane's 16 steps and a round's 512, one long run, and
    # the wrapping mix; F = 0 emits at most steps
    seqs = [gain_deltas_np(_gaps(rng, n)) for n in
            (0, 1, 15, 16, 17, 33, 127, 128, 129, 511, 512, 513, 4097,
             100_003)]
    for d, F in [(x, F) for x in seqs + [EXTREME] for F in (64, 0)]:
        d = torch.from_numpy(np.asarray(d).astype(np.int32))
        want = partition_scan_ref(d, F)
        before = tk.partition_scan.launches
        got = tk.partition_scan(d.cuda(), F)
        carry, bounds = tk.partition_scan_bounds(d.cuda(), F)
        assert tk.partition_scan.launches == before + 2
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
        m = int(carry[7])
        assert carry[:7].cpu().tolist() == want[0].tolist()
        assert torch.equal(bounds[:m].cpu(), want[2][want[1]])


# --------------------------------------------------------------------------
# The kernel's rounds, emulated in numpy
# --------------------------------------------------------------------------

def _i32(x):
    """Wrap to int32, as the reference's int32 carry does."""
    return (np.asarray(x, np.int64) + 2**31) % 2**32 - 2**31


def _excl_lanes(tot, seed, op):
    """The warp's exclusive scan of the lanes' totals, seeded."""
    return np.concatenate([[seed], op(op.accumulate(tot)[:-1], seed)])[:, None]


def _warp_round_scan(deltas, F, run=16):
    """``csrc/partition_scan.cu`` step for step, a [LANES, run] array for
    the warp: rounds of LANES * run steps; each step enters as gx (its g if
    d >= 0, else INT_MIN) and gn (its g if d < 0, else INT_MAX); seeded
    running max and min, a run per lane then across the lanes; the emission
    tests on mn and mx before each step; the first emitting step over the
    lanes; pos = new_i committed for every step evaluated; re-seed from the
    emitting step and evaluate the rest of the round again.  Returns
    (carry [7], mask, pos) as numpy arrays."""
    d_all = np.asarray(deltas, np.int64)
    n, R, F2 = d_all.size, LANES * run, 2 * F
    T, ci, cj, cmn, cmx, cg = F, 0, 0, 0, 0, 0
    mask, pos = np.zeros(n, bool), np.zeros(n, np.int64)
    u = np.arange(run)
    s0 = (np.arange(LANES) * run)[:, None]
    for base in range(0, n, R):
        cnt = min(R, n - base)
        d = np.zeros(R, np.int64)
        d[:cnt] = d_all[base : base + cnt]
        d = d.reshape(LANES, run)
        P = np.cumsum(d).reshape(LANES, run)
        kb, hi = base + s0 + 1, cnt - s0
        pv, mb = np.zeros((LANES, run), np.int64), np.zeros((LANES, run), bool)
        off, lo = cg, -s0
        while True:
            g = _i32(off + P)
            on = (u >= lo) & (u < hi)
            gx = np.where(on & (d >= 0), g, I32_MIN)
            gn = np.where(on & (d < 0), g, I32_MAX)
            lmx = np.maximum.accumulate(gx, axis=1)
            lmn = np.minimum.accumulate(gn, axis=1)
            wmx = _excl_lanes(lmx[:, -1], cmx, np.maximum)
            wmn = _excl_lanes(lmn[:, -1], cmn, np.minimum)
            bmx = np.maximum(wmx, np.concatenate(
                [np.full((LANES, 1), I32_MIN), lmx[:, :-1]], 1))
            bmn = np.minimum(wmn, np.concatenate(
                [np.full((LANES, 1), I32_MAX), lmn[:, :-1]], 1))
            li = np.maximum.accumulate(np.where(gx > bmx, kb + u, -1), axis=1)
            lj = np.maximum.accumulate(np.where(gn < bmn, kb + u, -1), axis=1)
            # up and down steps only move forward: the last one before a
            # lane is the largest of the lanes below, else the carry's
            wi = _excl_lanes(li[:, -1], ci, np.maximum)
            wj = _excl_lanes(lj[:, -1], cj, np.maximum)
            emits = (((bmn < -T) & (_i32(bmn - gx) < -F2))
                     | ((bmx > T) & (_i32(bmx - gn) > F2)))
            pv = np.where(u >= lo, np.maximum(li, wi), pv)
            fe = np.where(emits.any(1), emits.argmax(1), run)
            e = int(np.where(fe < run, s0[:, 0] + fe, R).min())
            if e == R:  # no emission left: the carry after the last step
                cg = int(_i32(off + P[-1, -1]))
                cmx = int(max(wmx[-1, 0], lmx[-1, -1]))
                cmn = int(min(wmn[-1, 0], lmn[-1, -1]))
                ci = int(max(li[-1, -1], wi[-1, 0]))
                cj = int(max(lj[-1, -1], wj[-1, 0]))
                break
            el, eu = divmod(e, run)
            is_e = gx[el, eu] != I32_MIN
            new_i = int(max(li[el, eu], wi[el, 0]))
            new_j = int(max(lj[el, eu], wj[el, 0]))
            x = int(bmn[el, eu] if is_e else bmx[el, eu])
            g2 = int(_i32((gx if is_e else gn)[el, eu] - x))
            pv[el, eu] = new_j if is_e else new_i
            mb[el, eu] = True
            cmn, cmx = (0, g2) if is_e else (g2, 0)
            ci, cj = (base + e + 1, new_j) if is_e else (new_i, base + e + 1)
            off -= x
            T = F2
            lo = e + 1 - s0
        pos[base : base + cnt] = pv.ravel()[:cnt]
        mask[base : base + cnt] = mb.ravel()[:cnt]
    return np.array([T, ci, cj, cg, cmn, cmx, n], np.int64), mask, pos


def _assert_rounds_match(deltas, F):
    """The emulated rounds (4 steps a lane: rounds of 128; 16: of 512, as
    the kernel) against the plain version (carry, mask, pos at every step)
    and the JAX scan (carry, mask, pos where mask)."""
    d = torch.from_numpy(np.asarray(deltas, np.int32))
    want = [t.numpy() for t in partition_scan_ref(d, F)]
    wc, wm, wp = (np.asarray(t) for t in rpart.optimal_partitioning_jax(
        jnp.asarray(deltas, dtype=jnp.int32), F=F))
    for run in (4, 16):
        carry, mask, pos = _warp_round_scan(deltas, F, run)
        assert carry.tolist() == want[0].tolist() == wc.tolist()
        assert np.array_equal(mask, want[1]) and np.array_equal(mask, wm)
        assert np.array_equal(pos, want[2])
        assert np.array_equal(pos[mask], wp[wm])
    return want[1]


@pytest.mark.parametrize("n", [127, 128, 129, 255, 256, 257, 511, 512, 1500])
@pytest.mark.parametrize("F", [0, 1, 16, 64])
def test_round_emulation_matches_plain_and_lax_scan(n, F):
    rng = np.random.default_rng(n * 5 + F)
    _assert_rounds_match(gain_deltas_np(_gaps(rng, n, dense_frac=0.5)), F)


@pytest.mark.parametrize("F", [0, 1, 64])
def test_round_emulation_on_extreme_deltas(F):
    """The wrapping mix, once within a round and once across rounds."""
    assert _assert_rounds_match(EXTREME, F).any()
    _assert_rounds_match(np.tile(EXTREME, 3)[:1100], F)


@pytest.mark.parametrize("F", [0, 64])
def test_scan_bounds_match_lax_scan(F):
    """partition_scan_bounds: the carry, the count, then pos[mask] in
    order; what optimal_partitioning_via_scan fetches."""
    deltas = gain_deltas_np(_gaps(np.random.default_rng(F + 1), 900))
    carry, bounds = tk.partition_scan_bounds(
        torch.from_numpy(deltas.astype(np.int32)), F)
    wc, wm, wp = (np.asarray(t) for t in rpart.optimal_partitioning_jax(
        jnp.asarray(deltas, dtype=jnp.int32), F=F))
    assert carry.dtype == bounds.dtype == torch.int32
    assert carry[:7].tolist() == [int(x) for x in wc]
    m = int(carry[7])
    assert m == int(wm.sum()) and bounds.numel() == len(deltas)
    assert bounds[:m].tolist() == wp[wm].tolist()
