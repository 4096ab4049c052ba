"""The port's EmbeddingBag against the JAX package: the plain version
against the Pallas kernel (interpret mode, as ``test_kernels.py`` runs it)
and its jnp oracle, the out-of-range id rule, the k-ordered summation, the
bag ops, the dispatch rule and the launch counter.  The CUDA kernel itself
is held to its plain version only on a card (``cuda`` marker).

Tolerances: f32 1e-5 and bf16 3e-2 against the reference, its own (the
Pallas kernel may contract ``out + w * row`` into a fused multiply-add, so
it is not bit-exact to a k-ordered sum); exact against the k-ordered f32
loop and for single-row bags, where no sum order enters.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.embedding_bag import ops as rops
from repro.kernels.embedding_bag.kernel import embedding_bag as ref_kernel
from repro.kernels.embedding_bag.ref import embedding_bag_ref as ref_oracle

from repro_torch.kernels.embedding_bag import kernel as tk
from repro_torch.kernels.embedding_bag import ops as tops
from repro_torch.kernels.embedding_bag.ref import clamp_ids, embedding_bag_ref

TOL = {"f32": 1e-5, "bf16": 3e-2}
JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}
# test_kernels.py's shapes (B, K, V, D), then DCN-v2's two widths (16 at
# full size, 8 at the smoke config); B * K <= 256 keeps interpret mode short
SHAPES = [(4, 3, 64, 128), (16, 8, 1024, 128), (8, 16, 256, 256),
          (1, 1, 8, 128), (16, 16, 1024, 16), (32, 8, 512, 8)]


def _inputs(rng, B, K, V, D):
    table = rng.normal(size=(V, D)).astype(np.float32)
    ids = rng.integers(0, V, (B, K)).astype(np.int32)
    mask = rng.random((B, K)) < 0.7
    return table, ids, mask


@pytest.mark.parametrize("B,K,V,D", SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_version_matches_pallas_and_oracle(B, K, V, D, dtype):
    rng = np.random.default_rng(B * K + D)
    table, ids, mask = _inputs(rng, B, K, V, D)
    jt = jnp.asarray(table, JNP[dtype])
    tt = torch.from_numpy(table).to(TORCH[dtype])
    got = tops.multi_hot_embed(tt, torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (B, D)
    w = jnp.asarray(mask, jnp.float32)
    want_k = ref_kernel(jt, jnp.asarray(ids), w, interpret=True)
    want_r = ref_oracle(jt, jnp.asarray(ids), w).astype(jnp.float32)
    tol = TOL[dtype]
    for want in (want_k, want_r):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


def test_out_of_range_ids_follow_the_pallas_kernel():
    """A negative id wraps once by +V, then ids clamp to [0, V-1], as the
    Pallas kernel reads them; the jnp oracle fills NaN instead."""
    V, D = 8, 128
    rng = np.random.default_rng(0)
    table = rng.normal(size=(V, D)).astype(np.float32)
    raw = [-1, V, V + 3, -V - 2, -V, -V - 1, 2**31 - 1, -(2**31), 3]
    rows = [V - 1, V - 1, V - 1, 0, 0, 0, V - 1, 0, 3]
    ids = np.array(raw, np.int32)[:, None]
    w = rng.normal(size=ids.shape).astype(np.float32)
    got = tk.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                           torch.from_numpy(w)).numpy()
    want = np.asarray(ref_kernel(jnp.asarray(table), jnp.asarray(ids),
                                 jnp.asarray(w), interpret=True))
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert clamp_ids(torch.from_numpy(ids[:, 0]), V).tolist() == rows
    assert np.array_equal(got, w * table[rows])
    oracle = np.asarray(ref_oracle(jnp.asarray(table), jnp.asarray(ids),
                                   jnp.asarray(w)))
    assert np.isnan(oracle[[1, 2, 3]]).all()  # V, V + 3, -V - 2


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_version_is_the_k_ordered_f32_sum(dtype):
    rng = np.random.default_rng(7)
    B, K, V, D = 64, 40, 300, 24
    table, ids, _ = _inputs(rng, B, K, V, D)
    w = rng.normal(size=(B, K)).astype(np.float32)
    tt = torch.from_numpy(table).to(TORCH[dtype])
    got = embedding_bag_ref(tt, torch.from_numpy(ids), torch.from_numpy(w))
    rows = tt.float().numpy()
    acc = np.zeros((B, D), np.float32)
    for k in range(K):
        acc = acc + w[:, k, None] * rows[ids[:, k]]
    assert acc.dtype == np.float32
    assert np.array_equal(got.numpy().view(np.int32), acc.view(np.int32))


def test_multi_hot_embed_matches_the_reference_ops():
    rng = np.random.default_rng(3)
    table, ids, mask = _inputs(rng, 16, 8, 200, 16)
    got = tops.multi_hot_embed(torch.from_numpy(table), torch.from_numpy(ids),
                               torch.from_numpy(mask)).numpy()
    for use_kernel in (True, False):
        want = rops.multi_hot_embed(jnp.asarray(table), jnp.asarray(ids),
                                    jnp.asarray(mask), use_kernel=use_kernel,
                                    interpret=True)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_segment_sum_embed_matches_the_reference():
    rng = np.random.default_rng(4)
    V, D, n, n_bags = 100, 12, 300, 17
    table = rng.normal(size=(V, D)).astype(np.float32)
    flat = rng.integers(0, V, n).astype(np.int32)
    bags = np.sort(rng.integers(0, n_bags, n)).astype(np.int32)
    got = tops.segment_sum_embed(torch.from_numpy(table), torch.from_numpy(flat),
                                 torch.from_numpy(bags), n_bags)
    want = rops.segment_sum_embed(jnp.asarray(table), jnp.asarray(flat),
                                  jnp.asarray(bags), n_bags)
    assert got.shape == (n_bags, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    rng = np.random.default_rng(5)
    table, ids, mask = _inputs(rng, 8, 4, 50, 16)
    before = tk.embedding_bag.launches
    got = tops.multi_hot_embed(torch.from_numpy(table), torch.from_numpy(ids),
                               torch.from_numpy(mask))
    assert tk.embedding_bag.launches == before == 0
    want = embedding_bag_ref(torch.from_numpy(table), torch.from_numpy(ids),
                             torch.from_numpy(mask).float())
    assert torch.equal(got, want)


def test_a_table_that_requires_grad_is_refused():
    table = torch.zeros((10, 4), requires_grad=True)
    ids = torch.zeros((2, 3), dtype=torch.int32)
    w = torch.ones((2, 3))
    with pytest.raises(ValueError, match="no backward kernel"):
        tk.embedding_bag(table, ids, w)
    with torch.no_grad():  # no gradient to lose
        assert tk.embedding_bag(table, ids, w).shape == (2, 4)
    assert tk.embedding_bag(table.detach(), ids, w).shape == (2, 4)


@pytest.mark.parametrize("bad", [
    lambda t, i, w: (t, i.long(), w),  # ids not int32
    lambda t, i, w: (t.double(), i, w),  # table not f32 / bf16
    lambda t, i, w: (t, i, w[:, :2]),  # weights of another shape
    lambda t, i, w: (t[:, :0], i, w),  # D = 0
    lambda t, i, w: (t[:0], i, w),  # nothing to read
])
def test_inputs_the_kernel_does_not_take_are_refused(bad):
    table = torch.zeros((10, 4))
    ids = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises((TypeError, ValueError)):
        tk.embedding_bag(*bad(table, ids, torch.ones((2, 3))))


# the CUDA kernel's tiling (csrc/embedding_bag.cu): a unit is one bag's
# group of 4 * VEC columns and UNIT_LANES lanes, a warp takes UNITS units,
# each pass CHUNK k slots whose ids and weights the unit's lanes hold 4 each
UNIT_LANES, UNITS, CHUNK = 4, 8, 16
EDGE_D = (1, 3, 16, 17, 128, 300)
EDGE_K = (1, 33, 64, 65)
EDGE_B = 19  # not a multiple of the 8 bags a warp takes at D <= 16


def _edge_inputs(rng, B, K, V, D):
    """Inputs at the kernel's edges: ids -1 and V planted, a +inf and a -inf
    row read under zero weights in every seventh bag, a third of the
    weights 0."""
    table = rng.normal(size=(V, D)).astype(np.float32)
    table[5], table[6] = np.inf, -np.inf
    ids = rng.integers(0, V, (B, K))
    ids[ids == 5], ids[ids == 6] = 7, 8
    w = rng.normal(size=(B, K)).astype(np.float32)
    w[rng.random((B, K)) < 1 / 3] = 0.0
    ids[0::2, 0], ids[1::2, K - 1] = -1, V
    ids[3::7, K // 2] = np.where(np.arange(len(ids[3::7])) % 2, 5, 6)
    w[3::7, K // 2] = 0.0
    return table, ids.astype(np.int32), w


def _paths(D, K, item, table_at, ids_at):
    """(VEC, 16-byte id loads) as ``launch`` in the source picks them: VEC 4
    when D % 4 == 0 and the table sits on 4 values' alignment, 16-byte id
    and weight loads when K % 4 == 0 and both arrays sit on 16 bytes."""
    return (4 if D % 4 == 0 and table_at % (4 * item) == 0 else 1,
            K % 4 == 0 and ids_at % 16 == 0)


def _emulate_kernel(rows, ids, w, item=4, table_at=0, ids_at=0):
    """The CUDA kernel's steps in numpy, every lane of every warp at once.

    rows [V, D] f32 (a bf16 table widened: ``item`` 2), ids [B, K], w [B,
    K]; ``table_at`` / ``ids_at``: byte offsets of the table and of ids and
    weights past a 16-byte boundary, which pick the paths (``_paths``).
    Returns (out, the times each output value was written)."""
    V, D = rows.shape
    B, K = ids.shape
    vec, kvec = _paths(D, K, item, table_at, ids_at)
    groups = -(-D // (UNIT_LANES * vec))
    units = B * groups
    tasks = -(-units // UNITS)
    lane = np.arange(32)
    q = lane % UNIT_LANES
    lead = lane - q
    unit = np.arange(tasks)[:, None] * UNITS + lane[None, :] // UNIT_LANES
    live_unit = unit < units
    bag = np.where(live_unit, unit // groups, 0)
    col = np.where(live_unit, unit % groups, 0) * UNIT_LANES * vec + q * vec
    live = live_unit & (col < D)

    def load_slots(k0):  # each lane's 4 slots k0 + 4q .. 4q + 3
        k = k0 + UNIT_LANES * q[None, :, None] + np.arange(4)
        ok = live_unit[:, :, None] & (k < K)
        if kvec:  # one 16-byte load or none: K % 4 == 0
            assert (ok == ok[:, :, :1]).all()
        kc = np.minimum(k, K - 1)
        r = np.where(ok, ids[bag[:, :, None], kc], 0).astype(np.int64)
        r = np.clip(np.where(r < 0, r + V, r), 0, V - 1)
        return r, np.where(ok, w[bag[:, :, None], kc], np.float32(0))

    cols = np.minimum(col[:, :, None] + np.arange(vec), D - 1)
    acc = np.zeros((tasks, 32, vec), np.float32)
    for k0 in range(0, K, CHUNK):  # 0 * inf is NaN, as in the kernel
        crow, cw = load_slots(k0)
        for kk in range(min(CHUNK, K - k0)):
            src = lead | (kk >> 2)  # __shfl_sync from the unit's lane
            r, wt = crow[:, src, kk & 3], cw[:, src, kk & 3]
            v = np.where(live[:, :, None], rows[r[:, :, None], cols],
                         np.float32(0))
            with np.errstate(invalid="ignore"):
                acc = acc + wt[:, :, None] * v
            assert acc.dtype == np.float32
    out = np.zeros((B, D), np.float32)
    written = np.zeros((B, D), np.int64)
    for e in range(vec):
        at = live & (col + e < D)
        out[bag[at], col[at] + e] = acc[:, :, e][at]
        np.add.at(written, (bag[at], col[at] + e), 1)
    return out, written


@pytest.mark.parametrize("D", EDGE_D)
@pytest.mark.parametrize("K", EDGE_K)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_emulated_kernel_tiling_matches_plain_version(D, K, dtype):
    """The kernel's tiling, held bit for bit to the plain version: lanes a
    row and column groups (VEC 4 for D % 4 == 0, else the scalar path),
    ids and weights handed out by shuffles, per-lane accumulators summed in
    k order; every output value written once."""
    rng = np.random.default_rng(D * 100 + K)
    table, ids, w = _edge_inputs(rng, EDGE_B, K, 50, D)
    tt = torch.from_numpy(table).to(TORCH[dtype])
    want = embedding_bag_ref(tt, torch.from_numpy(ids), torch.from_numpy(w))
    assert torch.isnan(want).any() and torch.isfinite(want).any()
    got, written = _emulate_kernel(tt.float().numpy(), ids, w,
                                   item=tt.element_size())
    assert (written == 1).all()
    assert np.array_equal(got.view(np.int32), want.numpy().view(np.int32))


@pytest.mark.parametrize("dtype,table_at,ids_at,paths", [
    ("f32", 0, 0, (4, True)), ("f32", 4, 0, (1, True)),
    ("f32", 8, 4, (1, False)), ("bf16", 0, 4, (4, False)),
    ("bf16", 8, 0, (4, True)), ("bf16", 2, 0, (1, True)),
])
def test_emulated_kernel_alignment_paths(dtype, table_at, ids_at, paths):
    """A table or ids off their vector alignment take the scalar paths, and
    every path gives the plain version's bits (D = 16, K = 64: the recsys
    path's shape)."""
    rng = np.random.default_rng(table_at + ids_at)
    table, ids, w = _edge_inputs(rng, EDGE_B, 64, 50, 16)
    tt = torch.from_numpy(table).to(TORCH[dtype])
    assert _paths(16, 64, tt.element_size(), table_at, ids_at) == paths
    want = embedding_bag_ref(tt, torch.from_numpy(ids), torch.from_numpy(w))
    got, written = _emulate_kernel(tt.float().numpy(), ids, w,
                                   tt.element_size(), table_at, ids_at)
    assert (written == 1).all()
    assert np.array_equal(got.view(np.int32), want.numpy().view(np.int32))


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    rng = np.random.default_rng(6)
    cases = [(65536, 64, 4096, 16), (1000, 64, 5000, 128), (300, 5, 100, 300),
             (7, 1000, 50, 3), (9, 0, 10, 16), (0, 4, 10, 16)]
    for B, K, V, D in cases:
        table, ids, _ = _inputs(rng, B, K, V, D)
        if ids.size:
            ids.flat[:: 7] = -1
            ids.flat[3:: 11] = V
        w = rng.normal(size=(B, K)).astype(np.float32)
        for dtype in ("f32", "bf16"):
            args = (torch.from_numpy(table).to(TORCH[dtype]),
                    torch.from_numpy(ids), torch.from_numpy(w))
            before = tk.embedding_bag.launches
            got = tk.embedding_bag(*(a.cuda() for a in args))
            assert tk.embedding_bag.launches == before + (1 if B else 0)
            want = embedding_bag_ref(*args)
            assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    # the tiling's edges: every D and K of the emulation's cases, with inf
    # rows under zero weights, on the card's NaNs (plain version on the card)
    for D in EDGE_D:
        for K in EDGE_K:
            table, ids, w = _edge_inputs(rng, 1003, K, 4099, D)
            for dtype in ("f32", "bf16"):
                args = [torch.from_numpy(x).cuda() for x in (table, ids, w)]
                args[0] = args[0].to(TORCH[dtype])
                got = tk.embedding_bag(*args)
                want = embedding_bag_ref(*args)
                assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # tables and ids off their vector alignment: the scalar paths
    table, ids, w = (torch.from_numpy(x).cuda()
                     for x in _edge_inputs(rng, 1003, 64, 4099, 16))
    for dtype, t_by, i_by in (("f32", 1, 0), ("f32", 0, 1), ("bf16", 1, 0),
                              ("bf16", 4, 1)):
        t = _shifted(table.to(TORCH[dtype]), t_by)
        i, ww = _shifted(ids, i_by), _shifted(w, i_by)
        got = tk.embedding_bag(t, i, ww)
        want = embedding_bag_ref(t, i, ww)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _shifted(x, by):
    """x's values, ``by`` elements past the start of a fresh allocation."""
    flat = torch.empty(x.numel() + by, dtype=x.dtype, device=x.device)
    flat[by:] = x.reshape(-1)
    return flat[by:].view(x.shape)


def test_multi_hot_embed_use_kernel_false_runs_the_plain_version(monkeypatch):
    """The reference's ``use_kernel`` keyword: False runs the plain version
    on the tensors' device, never the wrapper; bit-equal to the wrapper's
    CPU route and within the reference's own tolerance of its oracle."""
    rng = np.random.default_rng(6)
    table, ids, mask = _inputs(rng, 16, 8, 200, 16)
    args = (torch.from_numpy(table), torch.from_numpy(ids),
            torch.from_numpy(mask))
    with_kernel = tops.multi_hot_embed(*args)

    def no_wrapper(*a, **kw):
        raise AssertionError("use_kernel=False must not reach embedding_bag")

    monkeypatch.setattr(tops, "embedding_bag", no_wrapper)
    got = tops.multi_hot_embed(*args, use_kernel=False)
    assert torch.equal(got, with_kernel)
    want = rops.multi_hot_embed(jnp.asarray(table), jnp.asarray(ids),
                                jnp.asarray(mask), use_kernel=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
