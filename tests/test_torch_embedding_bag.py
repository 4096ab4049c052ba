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
