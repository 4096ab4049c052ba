"""The port's scan partitioner against the JAX package: the scan state
machine against ``optimal_partitioning_jax`` (carry, mask, and pos where
mask), and ``optimal_partitioning_via_scan`` / ``optimal_partitioning_blocked``
against the JAX ones and the paper's loop.  Every comparison is exact; the
CUDA kernel is held to its plain version only on a card (``cuda`` marker)."""

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
    rng = np.random.default_rng(9)
    big = rng.choice([2**31 - 1, -(2**31), 2**30, -(2**30), 1, -1, 0], 400)
    mask = _assert_scan_matches(big.astype(np.int32), 64)
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
    # lengths around the kernel's 16-element chunks, and one long run
    for n in (0, 1, 15, 16, 17, 33, 100_003):
        d = torch.from_numpy(gain_deltas_np(_gaps(rng, n)).astype(np.int32))
        before = tk.partition_scan.launches
        got = tk.partition_scan(d.cuda(), 64)
        assert tk.partition_scan.launches == before + 1
        for g, w in zip(got, partition_scan_ref(d, 64)):
            assert torch.equal(g.cpu(), w)
