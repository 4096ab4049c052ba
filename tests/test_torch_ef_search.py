"""The port's Elias-Fano NextGEQ tiles against the JAX package.

Tile packing is byte-identical; the plain PyTorch ``ef_search`` (what the
wrapper runs for CPU tensors) is held exactly to the Pallas kernel in
interpret mode and to ``ef_search_ref``; the CUDA kernel is held to the
plain version on the card (``cuda`` marker).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.ef_search import kernel as rk
from repro.kernels.ef_search import ops as rops
from repro.kernels.ef_search import ref as rref

from repro_torch.kernels.ef_search import kernel as tk
from repro_torch.kernels.ef_search import ops as tops
from repro_torch.kernels.ef_search import ref as tref

I32_MAX = 2**31 - 1


def _tiles(seed, universes):
    """Rows of 128 ascending docIDs, one per rebased universe ``u`` (the
    row's last value is base + 1 + u)."""
    rng = np.random.default_rng(seed)
    vals, bases = [], []
    for u in universes:
        r = np.sort(rng.choice(u, 127, replace=False))
        base = int(rng.integers(-1, 50_000))
        vals.append(base + 1 + np.append(r, u))
        bases.append(base)
    return np.asarray(vals, np.int64), np.asarray(bases, np.int64)


# l = 0 (u < 256) through l = 15 (u just below 2^23)
UNIVERSES = [127, 200, 255, 256, 1000, 70_000, (1 << 22) + 3, (1 << 23) - 1]


def test_ef_pack_blocks_byte_identical():
    vals, bases = _tiles(0, UNIVERSES)
    got, want = tops.ef_pack_blocks(vals, bases), rops.ef_pack_blocks(vals, bases)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[2][0] == 0 and got[2][-1] == 15  # the two extreme l
    assert np.array_equal(tops.ef_block_eligible(vals, bases),
                          rops.ef_block_eligible(vals, bases))
    assert np.array_equal(tops.ef_decode_rows_np(*got, bases), vals)
    with pytest.raises(ValueError, match="EF tile range"):
        tops.ef_pack_blocks(vals[:1] + np.append(np.zeros(127), 1 << 23),
                            bases[:1])


def _cursors(vals, bases, lbits, rng):
    """Probes: below base, at base, base + 1, each lane, one past a lane,
    the last lane, just past it, and past the tile's high range."""
    rows, probes = [], []
    for r in range(len(bases)):
        lane = int(rng.integers(1, 128))
        hp_big = bases[r] + 1 + (256 << int(lbits[r]))
        for p in (bases[r] - 3, bases[r], bases[r] + 1, vals[r, 0],
                  vals[r, lane], vals[r, lane] + 1, vals[r, -1],
                  vals[r, -1] + 1, hp_big, hp_big + 12345):
            rows.append(r)
            probes.append(int(p))
    return np.asarray(rows), np.asarray(probes)


def _pallas(lo, hi, lbits, bases, rows, probes):
    meta = np.zeros((len(rows), 128), np.int32)
    meta[:, : rk.EF_HI_WORDS] = hi[rows]
    meta[:, rk.EFMETA_LBITS] = lbits[rows]
    meta[:, rk.EFMETA_BASE] = bases[rows]
    meta[:, rk.EFMETA_PROBE] = probes
    out = np.asarray(rk.ef_search_blocks(
        jnp.asarray(lo[rows].astype(np.int32)), jnp.asarray(meta),
        interpret=True))
    return out[:, 0], out[:, 1]


@pytest.mark.parametrize("half", [0, 1])
def test_ef_search_plain_matches_pallas_and_ref(half):
    vals, bases = _tiles(1, UNIVERSES)
    lo, hi, lbits = tops.ef_pack_blocks(vals, bases)
    rows, probes = _cursors(vals, bases, lbits, np.random.default_rng(2))
    sl = slice(40 * half, 40 * (half + 1))  # nr <= 40 per Pallas call
    rows, probes = rows[sl], probes[sl]
    want_v, want_r = _pallas(lo, hi, lbits, bases, rows, probes)
    rv, rr = rref.ef_search_ref(
        jnp.asarray(lo[rows].astype(np.int32)), jnp.asarray(hi[rows].astype(np.int32)),
        jnp.asarray(lbits[rows].astype(np.int32)),
        jnp.asarray(bases[rows].astype(np.int32)),
        jnp.asarray(probes.astype(np.int32)))
    assert np.array_equal(np.asarray(rv), want_v)
    assert np.array_equal(np.asarray(rr), want_r)
    i32 = [torch.from_numpy(np.asarray(x).astype(np.int32))
           for x in (lo, hi, lbits, bases, rows, probes)]
    value, rank = tk.ef_search(*i32)
    assert value.dtype == rank.dtype == torch.int32
    assert np.array_equal(value.numpy(), want_v)
    assert np.array_equal(rank.numpy(), want_r)
    # the contract, spelled out
    for i, (r, p) in enumerate(zip(rows, probes)):
        k = int(np.searchsorted(vals[r], p, "left"))
        assert want_r[i] == k
        assert want_v[i] == (vals[r, k] if k < 128 else I32_MAX)


def test_ef_search_edge_results():
    """hp > 255 gives rank 128 (2^31-1); probe <= base gives rank 0 and the
    first lane, as does probe = base + 1."""
    vals, bases = _tiles(3, [255, (1 << 23) - 1])
    lo, hi, lbits = tops.ef_pack_blocks(vals, bases)
    rows = np.array([0, 0, 0, 1, 1, 1])
    probes = np.array([bases[0] + 1 + 256, bases[0], bases[0] + 1,
                       bases[1] + 1 + (256 << 15), bases[1] - 9, bases[1] + 1])
    v, r = tops.ef_search(lo, hi, lbits, bases, rows, probes, backend="torch",
                          device="cpu")
    assert r.tolist() == [128, 0, 0, 128, 0, 0]
    assert v.tolist() == [I32_MAX, vals[0, 0], vals[0, 0],
                          I32_MAX, vals[1, 0], vals[1, 0]]


def test_ef_search_numpy_path_matches_reference_mirror():
    vals, bases = _tiles(4, UNIVERSES)
    lo, hi, lbits = tops.ef_pack_blocks(vals, bases)
    rows, probes = _cursors(vals, bases, lbits, np.random.default_rng(5))
    want = rops.ef_search_np(lo, hi, lbits, bases, rows, probes)
    got = tops.ef_search(lo, hi, lbits, bases, rows, probes, backend="numpy")
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_ef_search_through_codec_row():
    vals, bases = _tiles(6, UNIVERSES[:4])
    lo, hi, lbits = tops.ef_pack_blocks(vals, bases)
    # blocks 0..5 of a mixed arena; blocks 1, 2, 4, 5 are EF tiles 0..3
    codec_row = np.array([0, 0, 1, 1, 2, 3], np.int32)
    block_base = np.array([0, *bases[:2], 0, *bases[2:]], np.int32)
    rows = np.array([1, 2, 4, 5, 5], np.int32)
    tile = codec_row[rows]
    probes = vals[tile, 77].astype(np.int32)
    got = tk.ef_search(*[torch.from_numpy(np.asarray(x).astype(np.int32)) for x in
                         (lo, hi, lbits, block_base, rows, probes)],
                       codec_row=torch.from_numpy(codec_row))
    assert got[0].tolist() == vals[tile, 77].tolist()
    assert got[1].tolist() == [77] * 5


@pytest.mark.cuda
def test_cuda_ef_search_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    vals, bases = _tiles(7, UNIVERSES * 8)
    lo, hi, lbits = tops.ef_pack_blocks(vals, bases)
    rows, probes = _cursors(vals, bases, lbits, np.random.default_rng(8))
    cpu = [torch.from_numpy(np.asarray(x).astype(np.int32))
           for x in (lo, hi, lbits, bases, rows, probes)]
    got = tk.ef_search(*[t.cuda() for t in cpu])
    for g, w in zip(got, tref.ef_search_ref(*cpu)):
        assert torch.equal(g.cpu(), w)
