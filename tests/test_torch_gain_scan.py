"""The port's gain scan against the JAX package: the torch cost half, the
plain version and ``gain_prefix`` against the Pallas kernel (interpret mode)
and its jnp oracle, the range guard, the blocked partitioner and an index
built through it.  Every comparison is exact (integer contracts); the CUDA
kernel itself is held to its plain version only on a card (``cuda``
marker)."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core.costs as rcosts
from repro.core.index import build_partitioned_index as ref_build
from repro.core.partition import optimal_partitioning as ref_optimal
from repro.kernels.gain_scan import ops as rops
from repro.kernels.gain_scan.kernel import gain_scan as ref_gain_scan
from repro.kernels.gain_scan.ref import gain_scan_ref as ref_gain_scan_ref

import repro_torch.core.costs as tcosts
from repro_torch.core.index import build_partitioned_index as port_build
from repro_torch.kernels.gain_scan import kernel as tk
from repro_torch.kernels.gain_scan import ops as tops
from repro_torch.kernels.gain_scan.ref import gain_scan_ref

from test_torch_host import _corpus, assert_same_index

I32_MAX = 2**31 - 1
GUARD_N = 53_687_091  # the largest n with 40 n < 2^31
THRESHOLD_VALUES = [127, 128, 16383, 16384, 2097151, 2097152, 268435455,
                    268435456]


def _gaps(rng, n, dense_frac, hi=10**5):
    return np.where(
        rng.random(n) < dense_frac, rng.integers(1, 3, n), rng.integers(1, hi, n)
    ).astype(np.int64)


def _padded(gaps):
    gp = np.ones(-(-len(gaps) // 1024) * 1024, np.int32)
    gp[: len(gaps)] = gaps
    return gp


def _assert_matches_reference(gaps):
    """Port gain_prefix and plain version == Pallas (interpret) == jnp oracle."""
    got = tops.gain_prefix(gaps, device="cpu")
    want = rops.gain_prefix(gaps, use_kernel=True, interpret=True)
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and np.array_equal(g, np.asarray(w))
    gp = _padded(gaps)
    port = gain_scan_ref(torch.from_numpy(gp))
    for g, w in zip(port, ref_gain_scan_ref(jnp.asarray(gp))):
        assert np.array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(port, ref_gain_scan(jnp.asarray(gp), interpret=True)):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert np.array_equal(got[0], np.cumsum(rcosts.gain_deltas_np(gaps)))
    return got


@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 5000])
@pytest.mark.parametrize("dense_frac", [0.0, 0.5, 0.95])
def test_gain_prefix_matches_pallas_and_oracle(n, dense_frac):
    rng = np.random.default_rng(n + int(dense_frac * 100))
    _assert_matches_reference(_gaps(rng, n, dense_frac))


def test_gaps_at_every_vbyte_threshold():
    """v = gap - 1 on both sides of each VByte byte-count step."""
    vals = np.array(THRESHOLD_VALUES, np.int64)
    gaps = np.concatenate([vals + 1, np.ones(3, np.int64), vals[::-1] + 1])
    g, _, _ = _assert_matches_reference(gaps)
    deltas = np.diff(np.concatenate([[0], g.astype(np.int64)]))
    nbytes = (deltas[: len(vals)] + vals + 1) // 8
    assert nbytes.tolist() == [1, 2, 2, 3, 3, 4, 4, 5]


@pytest.mark.parametrize("n", [1, 1025, 2047])
def test_padded_last_block_min_max_include_the_pad(n):
    """The pad (gap 1, delta +7) counts in the last block's min and max."""
    gaps = np.full(n, 1000, np.int64)  # every real delta is 16 - 1000
    g, mn, mx = _assert_matches_reference(gaps)
    pad_g = int(g[-1]) + 7 * np.arange(1, len(_padded(gaps)) - n + 1)
    real = g[(len(mn) - 1) * 1024 :]
    last = np.concatenate([real, pad_g])
    assert mn[-1] == last.min() and mx[-1] == last.max()
    if len(pad_g) > len(real):  # only the pad reaches the block's max
        assert mx[-1] == pad_g[-1] > real.max()


class _Sized:
    """A sequence known only by its length and sum: the guard reads both
    before it touches an element."""

    def __init__(self, n, total):
        self.n, self.total = n, total

    def __len__(self):
        return self.n

    def sum(self, axis=None, dtype=None, out=None):
        return self.total


def test_range_guard_at_its_limits():
    tops.check_range(GUARD_N, 0)
    tops.check_range(1, I32_MAX)
    tops.check_range(0, 2**40)  # nothing to scan
    for n, total in ((GUARD_N + 1, 0), (1, 2**31)):
        with pytest.raises(ValueError, match="universe < 2"):
            tops.check_range(n, total)
        with pytest.raises(ValueError, match="universe < 2"):
            tops.gain_prefix(_Sized(n, total), device="cpu")
        with pytest.raises(ValueError, match="universe < 2"):
            rops.gain_prefix(_Sized(n, total))
    assert 40 * GUARD_N < 2**31 <= 40 * (GUARD_N + 1)


def test_torch_cost_half_matches_jnp_half():
    rng = np.random.default_rng(11)
    x = np.concatenate([rng.integers(0, 2**31, 2000), [0, 1, 2, 3],
                        np.array(THRESHOLD_VALUES), [I32_MAX - 1, I32_MAX]])
    x = x.astype(np.int32)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    for port, ref in ((tcosts.bit_length_torch, rcosts.bit_length_jnp),
                      (tcosts._clz32, rcosts._clz32),
                      (tcosts._popcount32, rcosts._popcount32),
                      (tcosts.vbyte_cost_bits_torch, rcosts.vbyte_cost_bits_jnp)):
        got = port(tx)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(ref(jx)))
    gaps = np.maximum(x, 1)
    got = tcosts.gain_deltas_torch(torch.from_numpy(gaps))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(),
                          np.asarray(rcosts.gain_deltas_jnp(jnp.asarray(gaps))))
    assert np.array_equal(got.numpy(), rcosts.gain_deltas_np(gaps))


def test_cpu_tensors_take_the_plain_version():
    gp = torch.from_numpy(_padded(np.arange(1, 2001)))
    before = tk.gain_scan.launches
    for g, w in zip(tk.gain_scan(gp), gain_scan_ref(gp)):
        assert torch.equal(g, w)
    assert tk.gain_scan.launches == before
    with pytest.raises(ValueError, match="n % 1024"):
        tk.gain_scan(gp[:1000])


def test_entry_points_run_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tops.gain_prefix(np.array([1, 2, 3]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tops.optimal_partitioning_blocked(np.array([1, 2, 3]))


@pytest.mark.parametrize("F", [16, 64, 256])
@pytest.mark.parametrize("n", [1, 2, None])
def test_blocked_partitioner_matches_reference(F, n):
    rng = np.random.default_rng(F + (n or 0))
    n = n or int(rng.integers(3, 3000))
    gaps = _gaps(rng, n, 0.8)
    got = tops.optimal_partitioning_blocked(gaps, F, device="cpu")
    assert got.dtype == np.int64
    assert np.array_equal(got, rops.optimal_partitioning_blocked(gaps, F))
    assert np.array_equal(got, ref_optimal(gaps, F))


@pytest.mark.parametrize("codecs", ["svb", "auto"])
def test_index_through_blocked_partitioner_matches_reference(codecs):
    corpus = _corpus(4, n_lists=5)
    got = port_build(corpus, codecs=codecs, partitioner=functools.partial(
        tops.optimal_partitioning_blocked, device="cpu"))
    want = ref_build(corpus, codecs=codecs,
                     partitioner=rops.optimal_partitioning_blocked)
    assert_same_index(got, want)
    assert_same_index(got, port_build(corpus, codecs=codecs))


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    rng = np.random.default_rng(5)
    # the last: 2^14 + 3 blocks, more tiles than the card holds at once, so
    # that the look-back waits on tiles still running
    for gaps in (_gaps(rng, 300_000, 0.5), np.full(5000, 2**20, np.int64),
                 np.array(THRESHOLD_VALUES) + 1,
                 _gaps(rng, (2**14 + 3) * 1024, 0.5)):
        gp = torch.from_numpy(_padded(gaps))
        before = tk.gain_scan.launches
        got = tk.gain_scan(gp.cuda())
        assert tk.gain_scan.launches == before + 1
        for g, w in zip(got, gain_scan_ref(gp)):
            assert torch.equal(g.cpu(), w)


def _no_wrapper(*a, **kw):
    raise AssertionError("use_kernel=False must not reach the kernel wrapper")


def test_gain_prefix_use_kernel_false_runs_the_plain_version(monkeypatch):
    """The reference's ``use_kernel`` keyword: False runs the plain version
    on the chosen device, never the wrapper; both equal the reference's
    jnp oracle."""
    gaps = _gaps(np.random.default_rng(11), 3000, 0.7)
    with_kernel = tops.gain_prefix(gaps, device="cpu")
    monkeypatch.setattr(tops, "gain_scan", _no_wrapper)
    got = tops.gain_prefix(gaps, use_kernel=False, device="cpu")
    want = rops.gain_prefix(gaps, use_kernel=False)
    for g, k, w in zip(got, with_kernel, want):
        assert g.dtype == np.int32 and np.array_equal(g, np.asarray(w))
        assert np.array_equal(g, k)


def test_blocked_partitioner_use_kernel_false_matches_reference(monkeypatch):
    gaps = _gaps(np.random.default_rng(12), 2500, 0.8)
    monkeypatch.setattr(tops, "gain_scan", _no_wrapper)
    got = tops.optimal_partitioning_blocked(gaps, 64, use_kernel=False,
                                            device="cpu")
    want = rops.optimal_partitioning_blocked(gaps, 64, use_kernel=False)
    assert np.array_equal(got, want) and np.array_equal(got, ref_optimal(gaps, 64))
