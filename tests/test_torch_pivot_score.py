"""The port's fused pivot + kept-slot scoring kernel against the JAX package.

The plain PyTorch version (what the wrapper runs for CPU tensors) is held
bit-exactly -- scores compared as int32 bit patterns -- to the Pallas
composition in interpret mode, the jnp oracle and the numpy mirrors; the
slot gather clamps to the arena's real last row; the CUDA kernel is held
to the plain version on the card (``cuda`` marker).
"""

import numpy as np
import pytest
import torch

from repro.core import build_partitioned_index as ref_build
from repro.core.engine_core import build_pivot_chunks as ref_chunks
from repro.data.postings import make_corpus, make_freqs
from repro.kernels.pivot_score import ops as rops

from repro_torch.convert import index_arrays, index_from_arrays
from repro_torch.core.engine_core import build_pivot_chunks, pivot_score_graph
from repro_torch.kernels.bm25_score import kernel as bk
from repro_torch.kernels.pivot_score import kernel as tk
from repro_torch.kernels.pivot_score import ops as tops
from repro_torch.kernels.pivot_score.ref import SCORE_SLOTS

QMIN_NONE = 256
PARTS = ("compact", "count", "pivot", "maxq", "sscores")


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    x = np.asarray(x)
    if x.dtype == np.float32:
        return np.ascontiguousarray(x).view(np.int32)
    return x.astype(np.int64)


_IDX = {}


def _indexes(seed):
    if seed not in _IDX:
        rng = np.random.default_rng(seed)
        corpus = make_corpus(rng, n_lists=6, min_len=300, max_len=12000)
        freqs = make_freqs(rng, corpus)
        ridx = ref_build(corpus, "optimal", freqs=freqs)
        _IDX[seed] = (ridx, index_from_arrays(index_arrays(ridx)))
    return _IDX[seed]


def _cursors(pc, rng, n):
    rows = rng.integers(0, len(pc.base), n)
    qmins = rng.integers(0, QMIN_NONE + 1, (n, 128))
    qmins[: max(1, n // 3)] = 0  # permissive rows: plenty of kept slots
    qmins[-1] = QMIN_NONE
    return rows, qmins


def _plain(ta, pc, rows, qmins):
    d, p = ta.on("cpu"), pc.on("cpu")
    return pivot_score_graph(
        p, d, torch.from_numpy(rows.astype(np.int32)),
        torch.from_numpy(qmins.astype(np.int32)),
        np.float32(ta.ranked.params.k1 + 1.0))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pivot_score_plain_matches_pallas_ref_and_numpy(seed):
    ridx, tidx = _indexes(seed)
    ra, ta = ridx.arena, tidx.arena
    rpc, pc = ref_chunks(ra), build_pivot_chunks(ta)
    rows, qmins = _cursors(pc, np.random.default_rng(seed + 1), 19)
    got = _plain(ta, pc, rows, qmins)
    r = ra.ranked
    lob = ra.part_list[ra.part_of_block]
    args = (rpc.qb[rows], qmins, rpc.nblk[rows], rpc.base[rows],
            r.freq_lens, r.freq_data, r.norm_q, r.idf[lob].astype(np.float32),
            r.norm_table, float(r.params.k1 + 1.0))
    wants = [rops.pivot_score(*args, backend=be)
             for be in ("pallas", "ref", "numpy")]
    tr = ta.ranked
    targs = (pc.qb[rows], qmins, pc.nblk[rows], pc.base[rows],
             tr.freq_lens, tr.freq_data, tr.norm_q,
             tr.idf[ta.part_list[ta.part_of_block]], tr.norm_table,
             np.float32(tr.params.k1 + 1.0))
    wants.append(tops.pivot_score_np(*targs))
    assert got[4].shape == (len(rows), SCORE_SLOTS, 128)
    for want in wants:
        for g, w, part in zip(got, want, PARTS):
            assert np.array_equal(_bits(g), _bits(w)), part


def test_valid_slots_match_row_scorer():
    """Every kept slot's lane scores equal ``bm25_score_rows`` of the kept
    arena row, bit for bit; slots past the count score the chunk base."""
    _, tidx = _indexes(4)
    ta = tidx.arena
    pc = build_pivot_chunks(ta)
    rows, qmins = _cursors(pc, np.random.default_rng(5), 21)
    compact, count, _, _, ss = _plain(ta, pc, rows, qmins)
    d = ta.on("cpu")
    k1p1 = np.float32(ta.ranked.params.k1 + 1.0)
    for i in range(len(rows)):
        ns = min(int(count[i]), SCORE_SLOTS)
        slot_rows = np.full(SCORE_SLOTS, pc.base[rows[i]])
        slot_rows[:ns] += compact[i, :ns].numpy()
        want = bk.bm25_score_rows(d.freq_lens, d.freq_data, d.norm_q, d.idf,
                                  d.lob, d.norm_table, k1p1,
                                  torch.from_numpy(slot_rows.astype(np.int32)))
        assert np.array_equal(_bits(ss[i]), _bits(want)), i


def test_slot_rows_clamp_to_the_last_real_block():
    """A chunk whose last valid block is the arena's last row, in an arena
    whose block count is not a multiple of 8 (the freq tiles are padded to
    one, norm_q and lob are not): the kept slot scores that row, and a
    malformed chunk reaching past it clamps to it -- never to a padding row
    of the freq tiles, whose norm code and idf do not exist."""
    for seed in range(12):
        _, tidx = _indexes(seed)
        ta = tidx.arena
        if ta.n_blocks % 8:
            break
    assert ta.n_blocks % 8 and ta.ranked.freq_lens.shape[0] > ta.n_blocks
    pc = build_pivot_chunks(ta)
    last = len(pc.base) - 1
    nb_last = int(pc.nblk[last])
    assert pc.base[last] + nb_last - 1 == ta.n_blocks - 1
    qmin = np.full((1, 128), QMIN_NONE)
    qmin[0, nb_last - 1] = 0  # keep only the arena's last block
    compact, count, _, _, ss = _plain(ta, pc, np.array([last]), qmin)
    assert count.tolist() == [1] and compact[0, 0] == nb_last - 1
    d = ta.on("cpu")
    k1p1 = np.float32(ta.ranked.params.k1 + 1.0)
    last_row = bk.bm25_score_rows(
        d.freq_lens, d.freq_data, d.norm_q, d.idf, d.lob, d.norm_table, k1p1,
        torch.tensor([ta.n_blocks - 1], dtype=torch.int32))
    assert np.array_equal(_bits(ss[0, 0]), _bits(last_row[0]))
    # a malformed chunk table: base at the last block, 9 lanes all kept --
    # slots 1..8 would name rows past the arena; they clamp to its last row
    qb = torch.zeros((1, 128), dtype=torch.int32)
    bad = tk.pivot_score(
        qb, torch.tensor([9], dtype=torch.int32),
        torch.tensor([ta.n_blocks - 1], dtype=torch.int32),
        torch.zeros((1, 128), dtype=torch.int32),
        torch.zeros(1, dtype=torch.int32), d.freq_lens, d.freq_data,
        d.norm_q, d.idf, d.lob, d.norm_table, k1p1)
    assert bad[1].tolist() == [9]
    for s in range(SCORE_SLOTS):
        assert np.array_equal(_bits(bad[4][0, s]), _bits(last_row[0])), s
    mirror = tops.pivot_score_np(
        np.zeros((1, 128)), np.zeros((1, 128)), [9], [ta.n_blocks - 1],
        ta.ranked.freq_lens, ta.ranked.freq_data, ta.ranked.norm_q,
        ta.ranked.idf[ta.part_list[ta.part_of_block]], ta.ranked.norm_table,
        k1p1)
    assert np.array_equal(_bits(mirror[4]), _bits(bad[4]))


def test_cpu_tensors_take_the_plain_version():
    _, tidx = _indexes(0)
    ta = tidx.arena
    pc = build_pivot_chunks(ta)
    before = tk.pivot_score.launches
    _plain(ta, pc, np.array([0, 1]), np.zeros((2, 128)))
    assert tk.pivot_score.launches == before


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    _, tidx = _indexes(2)
    ta = tidx.arena
    pc = build_pivot_chunks(ta)
    rows, qmins = _cursors(pc, np.random.default_rng(6), 3000)
    want = _plain(ta, pc, rows, qmins)
    d, p = ta.on("cuda"), pc.on("cuda")
    before = tk.pivot_score.launches
    got = pivot_score_graph(
        p, d, torch.from_numpy(rows.astype(np.int32)).cuda(),
        torch.from_numpy(qmins.astype(np.int32)).cuda(),
        np.float32(ta.ranked.params.k1 + 1.0))
    assert tk.pivot_score.launches == before + 1
    for g, w, part in zip(got, want, PARTS):
        assert np.array_equal(_bits(g.cpu()), _bits(w)), part
