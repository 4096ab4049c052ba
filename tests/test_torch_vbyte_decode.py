"""The port's block Stream-VByte decoder against the JAX package.

The plain PyTorch versions (what the wrappers run for CPU tensors) are held
exactly to the Pallas kernels in interpret mode and to the ``ref.py``
oracles; the CUDA kernels themselves are held to the plain versions on the
card (``cuda`` marker).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.vbyte_decode import kernel as rk
from repro.kernels.vbyte_decode import ops as rops
from repro.kernels.vbyte_decode import ref as rref

from repro_torch.kernels.vbyte_decode import kernel as tk
from repro_torch.kernels.vbyte_decode import ops as tops
from repro_torch.kernels.vbyte_decode import ref as tref

I32_MAX = 2**31 - 1


def _steps(rng, nb):
    """[nb,128] docID steps (gap) whose gap-1 spans 1..4 bytes per row."""
    width = rng.integers(1, 24, (nb, 1))
    return 1 + rng.integers(0, 1 << width, (nb, 128), dtype=np.int64)


def _arena(seed, nb=16, near_max=False):
    rng = np.random.default_rng(seed)
    steps = _steps(rng, nb)
    steps[0, :4] = [1, (1 << 8) + 1, (1 << 16) + 1, (1 << 24) + 1]  # 1..4 bytes
    steps[1, :64] = (1 << 24) + 1  # half the row 4 bytes wide
    base = rng.integers(-1, 1000, nb)
    if near_max:
        # the last lane of every row lands just below 2^31 - 1
        base = I32_MAX - steps.sum(1) - rng.integers(0, 3, nb)
    lens, data, _ = tops.pack_blocks((steps - 1).astype(np.uint32).reshape(-1))
    vals = base[:, None] + np.cumsum(steps, 1)
    return lens, data, base, vals


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_blocks_byte_identical(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 3000))
    vals = rng.integers(0, 2**32, n, dtype=np.int64).astype(np.uint32)
    vals[: n // 2] >>= rng.integers(0, 32, n // 2).astype(np.uint32)
    got, want = tops.pack_blocks(vals), rops.pack_blocks(vals)
    assert got[2] == want[2]
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[0].shape[0] % tk.BM == 0  # padded to whole 8-row groups


@pytest.mark.parametrize("seed", [0, 5])
def test_decode_blocks_plain_matches_pallas_and_ref(seed):
    lens, data, _, _ = _arena(seed, nb=24)
    # one row whose values need the full 32 bits: the int32 result wraps
    full = np.full(128, 2**32 - 1, np.uint32)
    fl, fd, _ = tops.pack_blocks(full)
    lens, data = np.concatenate([lens, fl]), np.concatenate([data, fd])
    want = np.asarray(rk.decode_blocks(jnp.asarray(lens), jnp.asarray(data),
                                       interpret=True))
    assert np.array_equal(
        np.asarray(rref.decode_blocks_ref(jnp.asarray(lens), jnp.asarray(data))),
        want)
    got = tk.decode_blocks(torch.from_numpy(lens), torch.from_numpy(data))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert (want[24] == -1).all()
    assert np.array_equal(tops.decode_blocks_np(lens, data),
                          rops.decode_blocks_np(lens, data))
    # a row subset, in any order, decodes the gathered rows
    rows = np.array([3, 0, 24, 3, 17], np.int32)
    sub = tk.decode_blocks(torch.from_numpy(lens), torch.from_numpy(data),
                           torch.from_numpy(rows))
    assert np.array_equal(sub.numpy(), want[rows])
    assert np.array_equal(
        tops.decode_block_rows(lens[rows], data[rows], backend="torch",
                               device="cpu"),
        want[rows].astype(np.int64))


def _pallas_search(lens, data, base, rows, probes):
    meta = np.zeros((len(rows), 128), np.int32)
    meta[:, rk.META_BASE] = base[rows]
    meta[:, rk.META_PROBE] = probes
    out = np.asarray(rk.decode_search_blocks(
        jnp.asarray(lens[rows]), jnp.asarray(data[rows]), jnp.asarray(meta),
        interpret=True))
    return out[:, 0], out[:, 1]


def _edge_cursors(vals, base, rng, n_random=20):
    """(rows, probes) covering a probe below base, at base, equal to a lane,
    one past a lane, the last lane and past the last lane."""
    nb = len(base)
    rows, probes = [], []
    for r in range(min(nb, 6)):
        lane = int(rng.integers(0, 128))
        for p in (base[r] - 5, base[r], base[r] + 1, vals[r, 0], vals[r, lane],
                  vals[r, lane] + 1, vals[r, -1], vals[r, -1] + 1):
            rows.append(r)
            probes.append(min(int(p), I32_MAX))
    rr = rng.integers(0, nb, n_random)
    lane = rng.integers(0, 128, n_random)
    rows += rr.tolist()
    probes += (vals[rr, lane] - rng.integers(0, 2, n_random)).tolist()
    return np.asarray(rows, np.int64), np.asarray(probes, np.int64)


@pytest.mark.parametrize("near_max", [False, True], ids=["small", "near-2^31"])
def test_decode_search_plain_matches_pallas_and_ref(near_max):
    lens, data, base, vals = _arena(7, nb=16, near_max=near_max)
    rows, probes = _edge_cursors(vals, base, np.random.default_rng(8))
    rows, probes = rows[:32], probes[:32]
    want_v, want_r = _pallas_search(lens, data, base, rows, probes)
    rv, rr = rref.decode_search_ref(
        jnp.asarray(lens[rows]), jnp.asarray(data[rows]),
        jnp.asarray(base[rows].astype(np.int32)),
        jnp.asarray(probes.astype(np.int32)))
    assert np.array_equal(np.asarray(rv), want_v)
    assert np.array_equal(np.asarray(rr), want_r)
    value, rank = tk.decode_search(
        torch.from_numpy(lens), torch.from_numpy(data),
        torch.from_numpy(base.astype(np.int32)),
        torch.from_numpy(rows.astype(np.int32)),
        torch.from_numpy(probes.astype(np.int32)))
    assert value.dtype == rank.dtype == torch.int32
    assert np.array_equal(value.numpy(), want_v)
    assert np.array_equal(rank.numpy(), want_r)
    # the contract, spelled out: NextGEQ and rank of every cursor
    for i, (r, p) in enumerate(zip(rows, probes)):
        k = int(np.searchsorted(vals[r], p, "left"))
        assert want_r[i] == k
        assert want_v[i] == (vals[r, k] if k < 128 else I32_MAX)


def test_decode_search_through_codec_row():
    """``codec_row`` maps block rows to storage rows, as in a multi-codec
    arena: the result equals searching the stored rows directly."""
    lens, data, base, vals = _arena(3, nb=8)
    perm = np.array([5, 2, 7, 0, 1, 6, 3, 4], np.int32)  # block -> storage
    lens_s, data_s = np.empty_like(lens), np.empty_like(data)
    lens_s[perm], data_s[perm] = lens[:8], data[:8]
    rows = np.array([0, 3, 7, 7, 2], np.int32)
    probes = vals[rows, 40].astype(np.int32)
    want = tk.decode_search(*map(torch.from_numpy, (
        lens, data, base.astype(np.int32), rows, probes)))
    got = tk.decode_search(*map(torch.from_numpy, (
        lens_s, data_s, base.astype(np.int32), rows, probes)),
        codec_row=torch.from_numpy(perm))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_numpy_path_keeps_last_lane_convention():
    """The port's numpy path mirrors ``decode_search_np``: a probe past the
    row's last lane returns the LAST lane's value (rank 128)."""
    lens, data, base, vals = _arena(4, nb=8)
    rows = np.array([0, 1, 2, 2])
    probes = np.array([vals[0, -1] + 1, vals[1, 5], vals[2, -1], vals[2, -1] + 9])
    want = rops.decode_search_np(lens, data, base, rows, probes)
    got = tops.decode_search(lens, data, base, rows, probes, backend="numpy")
    for g, w in zip(got, want):
        assert g.dtype == np.int64 and np.array_equal(g, w)
    assert got[0][0] == vals[0, -1] and got[1][0] == 128


def test_torch_path_keeps_pallas_convention():
    """The port's torch path follows the Pallas kernel: a probe past the
    row's last lane gives 2^31-1 and rank 128."""
    lens, data, base, vals = _arena(4, nb=8)
    rows = np.array([0, 1, 2, 2])
    probes = np.array([vals[0, -1] + 1, vals[1, 5], vals[2, -1], vals[2, -1] + 9])
    want = rops.decode_search(lens, data, base, rows, probes, backend="ref")
    got = tops.decode_search(lens, data, base, rows, probes, backend="torch",
                             device="cpu")
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert got[0][0] == I32_MAX and got[1][0] == 128
    assert got[0][3] == I32_MAX and got[0][2] == vals[2, -1]


def test_cpu_tensors_take_the_plain_version():
    """CPU inputs run the plain version and launch nothing; bad backends and
    mixed devices are refused."""
    lens, data, base, vals = _arena(2, nb=8)
    before = (tk.decode_blocks.launches, tk.decode_search.launches)
    args = [torch.from_numpy(x) for x in (lens, data, base.astype(np.int32))]
    rows = torch.tensor([1, 2], dtype=torch.int32)
    pe = torch.tensor([int(vals[1, 3]), int(vals[2, 9])], dtype=torch.int32)
    assert torch.equal(tk.decode_blocks(args[0], args[1]),
                       tref.decode_blocks_ref(args[0], args[1]))
    v, r = tk.decode_search(*args, rows, pe)
    assert v.tolist() == [vals[1, 3], vals[2, 9]] and r.tolist() == [3, 9]
    assert (tk.decode_blocks.launches, tk.decode_search.launches) == before
    with pytest.raises(ValueError, match="unknown backend"):
        tops.decode_search(lens, data, base, [0], [1], backend="pallas")
    with pytest.raises(ValueError, match="one device"):
        tk.on_cpu(args[0], torch.empty(0, device="meta"))


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    lens, data, base, vals = _arena(9, nb=64, near_max=True)
    rows, probes = _edge_cursors(vals, base, np.random.default_rng(1), 5000)
    cpu = [torch.from_numpy(x) for x in (
        lens, data, base.astype(np.int32), rows.astype(np.int32),
        probes.astype(np.int32))]
    gpu = [t.cuda() for t in cpu]
    assert torch.equal(tk.decode_blocks(gpu[0], gpu[1]).cpu(),
                       tref.decode_blocks_ref(cpu[0], cpu[1]))
    assert torch.equal(tk.decode_blocks(gpu[0], gpu[1], gpu[3]).cpu(),
                       tref.decode_blocks_ref(cpu[0], cpu[1], cpu[3]))
    for g, w in zip(tk.decode_search(*gpu), tref.decode_search_ref(*cpu)):
        assert torch.equal(g.cpu(), w)
