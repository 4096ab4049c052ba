"""The port's Block-Max pivot kernel against the JAX package.

The plain PyTorch version (what the wrapper runs for CPU tensors) is held
exactly to the Pallas kernel in interpret mode, the jnp oracle and the
numpy mirrors; the host reduction (``dequant_table``, ``qmin_for``) and the
chunk tiling are held to the reference's; the CUDA kernel is held to the
plain version on the card (``cuda`` marker).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import build_partitioned_index as ref_build
from repro.core.engine_core import build_pivot_chunks as ref_chunks
from repro.data.postings import make_corpus, make_freqs
from repro.kernels.blockmax_pivot import kernel as rk
from repro.kernels.blockmax_pivot import ops as rops
from repro.kernels.blockmax_pivot import ref as rref

from repro_torch.convert import index_arrays, index_from_arrays
from repro_torch.core.engine_core import build_pivot_chunks, pivot_graph
from repro_torch.kernels.blockmax_pivot import kernel as tk
from repro_torch.kernels.blockmax_pivot import ops as tops

QMIN_NONE = 256
PARTS = ("compact", "count", "pivot", "maxq")


def _tiles(seed):
    """Random chunk tiles with edge rows: qmin 0 / QMIN_NONE, nblk 0 / 128,
    and a row whose every kept lane ties at the max."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 40))
    qb = rng.integers(0, 256, (n, 128))
    qmin = rng.integers(0, QMIN_NONE + 1, (n, 128))
    nblk = rng.integers(0, 129, n)
    qmin[0], qmin[1] = 0, QMIN_NONE
    nblk[-1], nblk[-2] = 0, 128
    qb[2] = 77
    qmin[2] = 0
    return qb, qmin, nblk


def _plain(qb, qmin, nblk):
    """The port's wrapper on CPU tensors, the chunk rows taken in order."""
    n = len(qb)
    out = tk.pivot_select(
        torch.from_numpy(qb.astype(np.int32)),
        torch.from_numpy(nblk.astype(np.int32)),
        torch.from_numpy(qmin.astype(np.int32)),
        torch.arange(n, dtype=torch.int32))
    assert all(t.dtype == torch.int32 for t in out)
    return [t.numpy().astype(np.int64) for t in out]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pivot_select_plain_matches_pallas_ref_and_numpy(seed):
    qb, qmin, nblk = _tiles(seed)
    got = _plain(qb, qmin, nblk)
    n = len(qb)
    pad = (-n) % 8
    meta = np.zeros((n + pad, 128), np.int32)
    meta[:n, rk.PMETA_NBLK] = nblk
    qbp = np.concatenate([qb, np.zeros((pad, 128), np.int64)]).astype(np.int32)
    qmp = np.concatenate([qmin, np.full((pad, 128), QMIN_NONE)]).astype(np.int32)
    out, aux = rk.pivot_select_blocks(jnp.asarray(qbp), jnp.asarray(qmp),
                                      jnp.asarray(meta), interpret=True)
    out, aux = np.asarray(out)[:n], np.asarray(aux)[:n]
    pallas = (out, aux[:, rk.AUX_COUNT], aux[:, rk.AUX_PIVOT],
              aux[:, rk.AUX_MAXQ])
    jref = rref.pivot_select_ref(jnp.asarray(qb.astype(np.int32)),
                                 jnp.asarray(qmin.astype(np.int32)),
                                 jnp.asarray(nblk.astype(np.int32)))
    for want in (pallas, jref, rops.pivot_select_np(qb, qmin, nblk),
                 tops.pivot_select_np(qb, qmin, nblk)):
        for g, w, part in zip(got, want, PARTS):
            assert np.array_equal(g, np.asarray(w)), part


def test_pivot_select_matches_brute_force():
    qb, qmin, nblk = _tiles(7)
    compact, count, pivot, maxq = _plain(qb, qmin, nblk)
    for i in range(len(qb)):
        kept = [l for l in range(int(nblk[i])) if qb[i, l] >= qmin[i, l]]
        assert count[i] == len(kept)
        assert list(compact[i, : count[i]]) == kept
        assert (compact[i, count[i]:] == -1).all()
        if kept:
            m = max(int(qb[i, l]) for l in kept)
            assert maxq[i] == m
            assert pivot[i] == min(l for l in kept if qb[i, l] == m)
        else:
            assert maxq[i] == -1 and pivot[i] == -1


def test_pivot_select_gathers_chunk_rows():
    """Cursors name rows of the resident table, in any order and with
    repeats: the result equals pivoting the gathered rows."""
    qb, qmin, nblk = _tiles(4)
    rows = np.array([3, 0, 3, len(qb) - 1, 2], np.int32)
    qm = qmin[rows]
    got = tk.pivot_select(*(torch.from_numpy(x.astype(np.int32))
                            for x in (qb, nblk, qm, rows)))
    want = tops.pivot_select_np(qb[rows], qm, nblk[rows])
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)


def test_pivot_select_empty():
    z = torch.zeros(0, dtype=torch.int32)
    out = tk.pivot_select(torch.zeros((3, 128), dtype=torch.int32),
                          torch.ones(3, dtype=torch.int32),
                          torch.zeros((0, 128), dtype=torch.int32), z)
    assert out[0].shape == (0, 128) and all(len(t) == 0 for t in out[1:])


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_qmin_reduction_matches_reference(seed):
    """dequant_table and qmin_for are the reference's float64 host code:
    identical outputs, and qmin is EXACTLY the float admissibility test."""
    rng = np.random.default_rng(seed)
    scale = np.float32(rng.choice([0.0, 1e-6, 0.037, 1.0, 117.3]))
    deq = tops.dequant_table(scale)
    assert np.array_equal(deq, rops.dequant_table(scale))
    mult = rng.integers(1, 5, 16).astype(np.float64)
    rest = rng.uniform(0, 50, 16)
    rest[0] = 0.0
    theta = rng.choice([-np.inf, 0.0, float(rng.uniform(0, 300)),
                        float(4 * deq[-1] + 100)], 16)
    got = tops.qmin_for(mult, rest, theta, deq)
    assert np.array_equal(got, rops.qmin_for(mult, rest, theta, deq))
    grid = np.arange(256)
    for b in range(16):
        passes = mult[b] * deq[grid] + rest[b] >= theta[b]
        assert np.array_equal(grid >= got[b], passes)


def test_pivot_chunks_match_reference():
    """The chunk table is the reference's, array for array, including lists
    of more than one chunk."""
    rng = np.random.default_rng(11)
    corpus = make_corpus(rng, n_lists=4, min_len=2000, max_len=24000)
    freqs = make_freqs(rng, corpus)
    ridx = ref_build(corpus, "optimal", freqs=freqs)
    tidx = index_from_arrays(index_arrays(ridx))
    want = ref_chunks(ridx.arena)
    got = build_pivot_chunks(tidx.arena)
    assert (np.diff(got.offsets) > 1).any()
    for k in ("qb", "nblk", "base", "offsets"):
        g, w = getattr(got, k), getattr(want, k)
        assert g.dtype == w.dtype and np.array_equal(g, w), k
    dev = got.on("cpu")
    assert dev.qb.dtype == dev.nblk.dtype == dev.base.dtype == torch.int32
    assert got.on("cpu") is dev
    # pivot_graph runs the kernel wrapper over the resident table
    rows = torch.arange(len(got.nblk), dtype=torch.int32)
    qmin = torch.zeros((len(got.nblk), 128), dtype=torch.int32)
    compact, count, _, _ = pivot_graph(dev, rows, qmin)
    assert np.array_equal(count.numpy(), got.nblk)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    rng = np.random.default_rng(3)
    nc, n = 700, 5000
    qb = rng.integers(0, 256, (nc, 128)).astype(np.int32)
    nblk = rng.integers(0, 129, nc).astype(np.int32)
    rows = rng.integers(0, nc, n).astype(np.int32)
    qmin = rng.integers(0, QMIN_NONE + 1, (n, 128)).astype(np.int32)
    qmin[::7] = 0
    qmin[1::7] = rng.integers(200, 257, (len(qmin[1::7]), 128))
    cpu = [torch.from_numpy(x) for x in (qb, nblk, qmin, rows)]
    want = tk.pivot_select(*cpu)
    before = tk.pivot_select.launches
    got = tk.pivot_select(*(t.cuda() for t in cpu))
    assert tk.pivot_select.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
