"""The port's Elias-Fano NextGEQ tiles against the JAX package.

Tile packing is byte-identical; the plain PyTorch ``ef_search`` (what the
wrapper runs for CPU tensors) is held exactly to the Pallas kernel in
interpret mode and to ``ef_search_ref``.  A numpy emulation of the CUDA
kernel's steps (select-0 for the run of equal high parts, bisection in its
low parts, select-1 for the value's high part) is held to both, on random
tiles and on edge tiles and probes; the CUDA kernel itself is held to the
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


# -- the CUDA kernel's steps, emulated ---------------------------------------

STREAM_BITS = 384


def _wrap32(x):
    return (int(x) + 2**31) % 2**32 - 2**31


def _select(words, k, ones):
    """Position of the k-th (0-based) one or zero bit of the 384-bit stream
    (384 if none): the word from the popcounts, then the bit, as the
    kernel's ``select_bit`` and its one ``__fns``."""
    before = 0
    for i, w in enumerate(words):
        x = w if ones else ~w & 0xFFFFFFFF
        cnt = bin(x).count("1")
        if k < before + cnt:
            set_bits = [b for b in range(32) if (x >> b) & 1]
            return 32 * i + set_bits[k - before]
        before += cnt
    return STREAM_BITS


def ef_search_emulated(lo, hi, l, base, probe):
    """One cursor through ``csrc/ef_search.cu``'s steps: (value, rank, the
    number of ``lo`` loads)."""
    rp = max(_wrap32(int(probe) - int(base) - 1), 0)
    hp = rp >> int(l)
    if hp > 255:
        return I32_MAX, 128, 0
    lp = rp & ((1 << int(l)) - 1)
    h = [int(x) & 0xFFFF for x in hi]
    words = [h[2 * i] | (h[2 * i + 1] << 16) for i in range(12)]
    count_lt = 0 if hp == 0 else _select(words, hp - 1, False) - (hp - 1)
    count_le = _select(words, hp, False) - hp
    a, b, loads = count_lt, min(count_le, 128), 0
    while a < b:
        m = (a + b) >> 1
        loads += 1
        if lo[m] < lp:
            a = m + 1
        else:
            b = m
    rc = min(a, 127)
    high = _select(words, rc, True) - rc
    value = _wrap32(int(base) + 1 + ((high << int(l)) | int(lo[rc])))
    return (I32_MAX if a >= 128 else value), a, loads + 1


def _edge_tile(kind, rng):
    """(vals [128], base) of one edge tile."""
    base = int(rng.integers(-1, 50_000))
    if kind == "all-high-equal":  # l = 15, every high part 200
        r = (200 << 15) + np.sort(rng.choice(1 << 15, 128, replace=False))
    elif kind == "runs-of-one-l0":  # l = 0: high = r, all distinct
        r = np.sort(rng.choice(200, 128, replace=False))
    elif kind == "runs-of-one-l15":  # l = 15, high parts 0, 2, .., 252, 255
        r = (np.append(np.arange(127) * 2, 255) << 15) + rng.integers(0, 1 << 15, 128)
    elif kind == "l0-full":  # l = 0, the high parts 0..127
        r = np.arange(128)
    elif kind == "padded":  # 40 values, then the last one repeated
        r = np.sort(rng.choice(70_000, 40, replace=False))
        r = np.append(r, np.full(88, r[-1]))
    elif kind == "base-near-int-min":  # rebased probes wrap below -2^31
        base = -(2**31) + 10
        r = np.sort(rng.choice(1 << 20, 128, replace=False))
    elif kind == "base-near-int-max":  # rebased probes wrap above 2^31 - 1
        r = np.sort(rng.choice(1 << 20, 128, replace=False))
        base = I32_MAX - 2 - int(r[-1])
    else:
        raise ValueError(kind)
    return base + 1 + r.astype(np.int64), base


EDGE_TILES = ["all-high-equal", "runs-of-one-l0", "runs-of-one-l15", "l0-full",
              "padded", "base-near-int-min", "base-near-int-max"]


def _edge_probes(vals, base, l, rng):
    """hp = 0, hp = 255 and hp > 255, probes <= base, probes that wrap past
    2^31 in the rebase, each lane's value and one past it at random."""
    top = base + 1 + (255 << l)
    probes = [base - (1 << 20), base - 1, base, base + 1, base + 1 + (1 << l) - 1,
              top, top + (1 << l) // 2, top + (1 << l) - 1,
              base + 1 + (256 << l), base + 1 + (256 << l) + 77, I32_MAX,
              -(2**31), -(2**31) + 3, I32_MAX - 5]
    lanes = rng.integers(0, 128, 12)
    probes += vals[lanes].tolist() + (vals[lanes] + 1).tolist()
    return np.asarray([_wrap32(p) for p in probes], np.int64)


def _case(case):
    """(lo, hi, lbits, bases, rows, probes) of one parametrised case."""
    rng = np.random.default_rng(sum(map(ord, case)))
    if case.startswith("random"):
        vals, bases = _tiles(int(case[-1]), UNIVERSES)
        lo, hi, lbits = tops.ef_pack_blocks(vals, bases)
        rows, probes = _cursors(vals, bases, lbits, rng)
        return lo, hi, lbits, bases, rows, probes
    vals, base = _edge_tile(case, rng)
    lo, hi, lbits = tops.ef_pack_blocks(vals[None], np.asarray([base]))
    probes = _edge_probes(vals, base, int(lbits[0]), rng)
    return lo, hi, lbits, np.asarray([base]), np.zeros(len(probes), np.int64), probes


@pytest.mark.parametrize("case", ["random-0", "random-1", "random-2", *EDGE_TILES])
def test_emulated_kernel_matches_pallas_and_plain(case):
    """The CUDA kernel's algorithm, step for step in numpy, gives the Pallas
    kernel's (value, rank) on every cursor, and so does the plain version;
    the bisection never takes more than 7 loads, plus one for the value."""
    lo, hi, lbits, bases, rows, probes = _case(case)
    got = [ef_search_emulated(lo[r], hi[r], lbits[r], bases[r], p)
           for r, p in zip(rows, probes)]
    assert max(g[2] for g in got) <= 8
    pad = -len(rows) % 8  # the Pallas grid takes whole 8-row blocks
    prow = np.concatenate([rows, np.repeat(rows[:1], pad)])
    ppro = np.concatenate([probes, np.repeat(probes[:1], pad)])
    want_v, want_r = (x[: len(rows)] for x in
                      _pallas(lo, hi, lbits, bases, prow, ppro))
    assert [g[0] for g in got] == want_v.tolist()
    assert [g[1] for g in got] == want_r.tolist()
    i32 = [torch.from_numpy(np.asarray(x).astype(np.int32))
           for x in (lo, hi, lbits, bases, rows, probes)]
    value, rank = tk.ef_search(*i32)
    assert value.tolist() == want_v.tolist() and rank.tolist() == want_r.tolist()
    if case in ("all-high-equal", "l0-full"):
        assert (lbits == (15 if case == "all-high-equal" else 0)).all()


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
    # the edge tiles and probes, and launches of 1 to 33 cursors
    for case in EDGE_TILES:
        lo, hi, lbits, bases, rows, probes = _case(case)
        for n in (1, 7, 9, 32, 33):
            cpu = [torch.from_numpy(np.asarray(x).astype(np.int32))
                   for x in (lo, hi, lbits, bases, rows[:n], probes[:n])]
            got = tk.ef_search(*[t.cuda() for t in cpu])
            for g, w in zip(got, tref.ef_search_ref(*cpu)):
                assert torch.equal(g.cpu(), w), (case, n)
