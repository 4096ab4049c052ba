"""The port's BM25 scoring kernels against the JAX package.

The plain PyTorch versions (what the wrappers run for CPU tensors) are held
bit-exactly -- scores compared as int32 bit patterns, never with a
tolerance -- to the Pallas kernels in interpret mode, to the jnp oracles and
to the numpy mirrors of both packages; the CUDA kernels are held to the
plain versions on the card (``cuda`` marker).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import build_partitioned_index as ref_build
from repro.data.postings import make_corpus, make_freqs
from repro.kernels.bm25_score import kernel as rk
from repro.kernels.bm25_score import ops as rops
from repro.kernels.bm25_score import ref as rref
from repro.kernels.vbyte_decode.kernel import META_BASE, META_PROBE

from repro_torch.core import build_partitioned_index
from repro_torch.kernels.bm25_score import kernel as tk
from repro_torch.kernels.bm25_score import ops as tops


def _bits(x):
    """float32 values as int32 bit patterns: equality is bit-exactness."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.int32).numpy()
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def _indexes(seed=0, codecs="auto", n_lists=8):
    rng = np.random.default_rng(seed)
    corpus = make_corpus(rng, n_lists=n_lists, min_len=300, max_len=4000)
    freqs = make_freqs(rng, corpus)
    return (ref_build(corpus, "optimal", freqs=freqs, codecs=codecs),
            build_partitioned_index(corpus, "optimal", freqs=freqs,
                                    codecs=codecs))


def _cut_at(points):
    def partitioner(gaps):
        pts = sorted(set(int(p) for p in points) | {len(gaps)})
        return np.asarray([p for p in pts if 0 < p <= len(gaps)], np.int64)

    return partitioner


def _mixed_index(seed=17):
    """A port index whose ``auto`` arena mixes codecs: clustered runs
    (Elias-Fano) beside sparse one-byte gaps (Stream-VByte), with freqs."""
    rng = np.random.default_rng(seed)
    low = np.cumsum(rng.choice([1, 2, 6, 10, 20, 30], size=700)) - 1
    sparse = low[-1] + 1 + np.cumsum(rng.integers(65, 128, size=1500))
    lists = [np.concatenate([low, sparse]),
             np.unique(np.concatenate([low[::3], sparse[::2]])),
             np.unique(np.concatenate([low[1::2], sparse[::5]])),
             sparse[1::3].copy()]
    lists = [x.astype(np.int64) for x in lists]
    freqs = make_freqs(rng, lists)
    return build_partitioned_index(lists, freqs=freqs, codecs="auto",
                                   partitioner=_cut_at([300, 700]))


def _cpu(arena):
    return arena.on("cpu")


def _k1p1(r):
    return np.float32(r.params.k1 + 1.0)


@pytest.mark.parametrize("seed", [0, 3])
def test_score_rows_plain_matches_pallas_ref_and_numpy(seed):
    ridx, tidx = _indexes(seed)
    ra, ta = ridx.arena_for("auto"), tidx.arena_for("auto")
    r, dev = ta.ranked, _cpu(ta)
    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.integers(0, ta.n_blocks, 13),
                           [0, ta.n_blocks - 1]]).astype(np.int64)
    lob = ta.part_list[ta.part_of_block]
    idf_rows = r.idf[lob[rows]]
    got = tk.bm25_score_rows(dev.freq_lens, dev.freq_data, dev.norm_q,
                             dev.idf, dev.lob, dev.norm_table, _k1p1(r),
                             torch.from_numpy(rows.astype(np.int32)))
    assert got.dtype == torch.float32 and got.shape == (len(rows), 128)
    rr = ra.ranked
    want_pallas = rops.bm25_score_rows(
        rr.freq_lens, rr.freq_data, rr.norm_q, rows, idf_rows, rr.norm_table,
        _k1p1(rr), backend="pallas", interpret=True)
    want_ref = rops.bm25_score_rows(
        rr.freq_lens, rr.freq_data, rr.norm_q, rows, idf_rows, rr.norm_table,
        _k1p1(rr), backend="ref")
    want_np = rops.bm25_score_rows(
        rr.freq_lens, rr.freq_data, rr.norm_q, rows, idf_rows, rr.norm_table,
        _k1p1(rr), backend="numpy")
    for want in (want_pallas, want_ref, want_np):
        assert np.array_equal(_bits(got), _bits(want))
    # the port's numpy mirror agrees too
    mine = tops.score_rows_np(r.freq_lens[rows], r.freq_data[rows],
                              r.norm_q[rows], idf_rows, r.norm_table, _k1p1(r))
    assert np.array_equal(_bits(mine), _bits(want_np))
    # rows=None scores every block of the arena (the impact mirror's call)
    every = tk.bm25_score_rows(dev.freq_lens, dev.freq_data, dev.norm_q,
                               dev.idf, dev.lob, dev.norm_table, _k1p1(r))
    assert every.shape == (ta.n_blocks, 128)
    assert np.array_equal(_bits(every[torch.from_numpy(rows)]), _bits(got))


def _probe_cursors(arena, rng, n=40):
    """(rows, probes): members, docIDs just off a member, the block base
    and one past the block's last real docID."""
    from repro_torch.core.engine_core import decode_rows_values

    rows = rng.integers(0, arena.n_blocks, n)
    vals = decode_rows_values(arena, rows, "numpy")
    lane = rng.integers(0, 128, n)
    nreal = arena.lane_valid[rows].sum(1)
    lane = np.minimum(lane, nreal - 1)
    probes = vals[np.arange(n), lane]
    probes[1::4] += 1
    probes[2::4] = arena.block_base[rows[2::4]]
    last = vals[np.arange(n), nreal - 1]
    probes[3::8] = last[3::8] + 1
    return rows.astype(np.int64), probes.astype(np.int64)


def test_score_probe_plain_matches_pallas_and_numpy():
    ridx, tidx = _indexes(1, codecs="svb")
    ra, ta = ridx.arena_for("svb"), tidx.arena_for("svb")
    assert not ta.multi
    rows, probes = _probe_cursors(ta, np.random.default_rng(2))
    r, dev = ta.ranked, _cpu(ta)
    got = tk.bm25_score_probe(
        dev.lens, dev.data, dev.block_base, None, dev.freq_lens,
        dev.freq_data, dev.norm_q, dev.idf, dev.lob, dev.norm_table,
        _k1p1(r), torch.from_numpy(rows.astype(np.int32)),
        torch.from_numpy(probes.astype(np.int32)))
    rr = ra.ranked
    idf_rows = rr.idf[ra.part_list[ra.part_of_block][rows]]
    args = (ra.lens, ra.data, rr.freq_lens, rr.freq_data, rr.norm_q,
            ra.block_base, rows, probes, idf_rows, rr.norm_table, _k1p1(rr))
    want = rops.bm25_score_probe(*args, backend="pallas", interpret=True)
    assert np.array_equal(_bits(got), _bits(want))
    assert np.array_equal(_bits(rops.bm25_score_probe(*args, backend="ref")),
                          _bits(want))
    assert np.array_equal(_bits(rops.score_probe_np(*args)), _bits(want))
    mine = tops.score_probe_np(ta.lens, ta.data, r.freq_lens, r.freq_data,
                               r.norm_q, ta.block_base, rows, probes,
                               idf_rows, r.norm_table, _k1p1(r))
    assert np.array_equal(_bits(mine), _bits(want))
    hits = want != 0
    assert hits.sum() >= len(rows) // 4 and (~hits).sum() >= len(rows) // 4


def test_score_probe_through_codec_row_in_a_multi_codec_arena():
    """In a multi-codec arena the docID tile of an SVB block is reached
    through ``codec_row``; the freq tile stays at the block row.  The
    result equals the numpy mirror over the single-codec arena of the same
    index."""
    tidx = _mixed_index()
    ta, ts = tidx.arena_for("auto"), tidx.arena_for("svb")
    assert ta.multi and (ta.block_codec == 0).any()
    svb_blocks = np.nonzero(ta.block_codec == 0)[0]
    rows, probes = _probe_cursors(ts, np.random.default_rng(5), 60)
    keep = np.isin(rows, svb_blocks)
    rows, probes = rows[keep], probes[keep]
    assert len(rows) >= 10
    r, dev = ta.ranked, _cpu(ta)
    got = tk.bm25_score_probe(
        dev.lens, dev.data, dev.block_base, dev.codec_row, dev.freq_lens,
        dev.freq_data, dev.norm_q, dev.idf, dev.lob, dev.norm_table,
        _k1p1(r), torch.from_numpy(rows.astype(np.int32)),
        torch.from_numpy(probes.astype(np.int32)))
    idf_rows = r.idf[ts.part_list[ts.part_of_block][rows]]
    want = tops.score_probe_np(ts.lens, ts.data, r.freq_lens, r.freq_data,
                               r.norm_q, ts.block_base, rows, probes,
                               idf_rows, r.norm_table, _k1p1(r))
    assert np.array_equal(_bits(got), _bits(want))


def test_pallas_probe_staging_matches_port_signature():
    """The Pallas probe kernel staged by hand (META / FMETA lanes, the
    table broadcast to its tile) gives the port's plain version, lane 0."""
    ridx, tidx = _indexes(6, codecs="svb", n_lists=6)
    ra, ta = ridx.arena_for("svb"), tidx.arena_for("svb")
    rows, probes = _probe_cursors(ta, np.random.default_rng(7), 16)
    rr = ra.ranked
    meta = np.zeros((16, 128), np.int32)
    meta[:, META_BASE] = ra.block_base[rows]
    meta[:, META_PROBE] = probes
    fmeta = np.zeros((16, 128), np.float32)
    fmeta[:, rk.FMETA_IDF] = rr.idf[ra.part_list[ra.part_of_block][rows]]
    fmeta[:, rk.FMETA_K1P1] = _k1p1(rr)
    tile = np.broadcast_to(rr.norm_table, (8, 256)).copy()
    out = np.asarray(rk.bm25_score_probe_blocks(
        jnp.asarray(ra.lens[rows]), jnp.asarray(ra.data[rows]),
        jnp.asarray(rr.freq_lens[rows]), jnp.asarray(rr.freq_data[rows]),
        jnp.asarray(rr.norm_q[rows].astype(np.int32)), jnp.asarray(tile),
        jnp.asarray(meta), jnp.asarray(fmeta), interpret=True))
    assert (out[:, 1:] == 0).all()
    dev = _cpu(ta)
    got = tk.bm25_score_probe(
        dev.lens, dev.data, dev.block_base, None, dev.freq_lens,
        dev.freq_data, dev.norm_q, dev.idf, dev.lob, dev.norm_table,
        _k1p1(ta.ranked), torch.from_numpy(rows.astype(np.int32)),
        torch.from_numpy(probes.astype(np.int32)))
    assert np.array_equal(_bits(got), _bits(out[:, 0]))
    # and the jnp oracle of the row scorer, straight
    sc = rref.score_rows_ref(
        jnp.asarray(rr.freq_lens[rows]), jnp.asarray(rr.freq_data[rows]),
        jnp.asarray(rr.norm_q[rows].astype(np.int32)),
        jnp.asarray(fmeta[:, rk.FMETA_IDF]), jnp.asarray(rr.norm_table),
        jnp.float32(_k1p1(rr)))
    mine = tk.bm25_score_rows(dev.freq_lens, dev.freq_data, dev.norm_q,
                              dev.idf, dev.lob, dev.norm_table,
                              _k1p1(ta.ranked),
                              torch.from_numpy(rows.astype(np.int32)))
    assert np.array_equal(_bits(mine), _bits(np.asarray(sc)))


def test_cpu_tensors_take_the_plain_version_and_mixed_devices_raise():
    _, tidx = _indexes(2, codecs="svb", n_lists=4)
    ta = tidx.arena_for("svb")
    dev = _cpu(ta)
    before = (tk.bm25_score_rows.launches, tk.bm25_score_probe.launches)
    rows = torch.tensor([0, 1], dtype=torch.int32)
    tk.bm25_score_rows(dev.freq_lens, dev.freq_data, dev.norm_q, dev.idf,
                       dev.lob, dev.norm_table, 2.2, rows)
    tk.bm25_score_probe(dev.lens, dev.data, dev.block_base, None,
                        dev.freq_lens, dev.freq_data, dev.norm_q, dev.idf,
                        dev.lob, dev.norm_table, 2.2, rows, rows)
    assert (tk.bm25_score_rows.launches, tk.bm25_score_probe.launches) == before
    with pytest.raises(ValueError, match="one device"):
        tk.bm25_score_rows(dev.freq_lens, dev.freq_data, dev.norm_q, dev.idf,
                           dev.lob, dev.norm_table, 2.2,
                           torch.empty(1, dtype=torch.int32, device="meta"))


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    tidx = _mixed_index(8)
    for policy in ("svb", "auto"):
        ta = tidx.arena_for(policy)
        cpu, gpu = ta.on("cpu"), ta.on("cuda")
        rng = np.random.default_rng(9)
        k1p1 = _k1p1(ta.ranked)
        rows = rng.integers(0, ta.n_blocks, 3000).astype(np.int32)
        rc, rg = torch.from_numpy(rows), torch.from_numpy(rows).cuda()
        side = ("freq_lens", "freq_data", "norm_q", "idf", "lob", "norm_table")
        want = tk.bm25_score_rows(*(getattr(cpu, k) for k in side), k1p1, rc)
        got = tk.bm25_score_rows(*(getattr(gpu, k) for k in side), k1p1, rg)
        assert np.array_equal(_bits(got.cpu()), _bits(want))
        every = tk.bm25_score_rows(*(getattr(gpu, k) for k in side), k1p1)
        assert np.array_equal(
            _bits(every.cpu()),
            _bits(tk.bm25_score_rows(*(getattr(cpu, k) for k in side), k1p1)))
        svb = (np.nonzero(ta.block_codec == 0)[0] if ta.multi
               else np.arange(ta.n_blocks))
        rows, probes = _probe_cursors(tidx.arena_for("svb"), rng, 4000)
        keep = np.isin(rows, svb)
        rows = rows[keep].astype(np.int32)
        probes = probes[keep].astype(np.int32)
        cr = (cpu.codec_row, gpu.codec_row) if ta.multi else (None, None)
        for d, c in ((cpu, cr[0]), (gpu, cr[1])):
            out = tk.bm25_score_probe(
                d.lens, d.data, d.block_base, c, *(getattr(d, k) for k in side),
                k1p1, torch.from_numpy(rows).to(d.lens.device),
                torch.from_numpy(probes).to(d.lens.device))
            if d is cpu:
                want = out
            else:
                assert np.array_equal(_bits(out.cpu()), _bits(want))
