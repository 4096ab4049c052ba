"""The port's transformer LM against the JAX package: configs and counts,
RoPE, both attention paths, the dense and MoE FFNs, a layer, the forward,
the chunked loss and its gradients, prefill, decode and the cache; and the
reference's own contracts (``test_transformer_consistency.py``) on the port.

The reference's parameters are carried across (``convert.
lm_tree_from_arrays``) and the inputs drawn with numpy from a seed.

Tolerances and why: at ``compute_dtype=float32`` the reference's own bound,
rtol/atol 2e-5, on hidden states, attention outputs, FFN outputs, logits,
caches and losses (f32 sums in another order: XLA's dots against torch's;
``exp``/``sin``/``cos`` within an ulp), and atol 2e-5 on gradients; the
port's own consistency contracts use the reference test's bounds (2e-5,
1e-4 for decode against prefill, 1e-5 for the window).  At bf16 (the
configs' compute dtype) every op rounds to 8 bits of mantissa and one
bf16 matmul of either package can differ from the other's by an ulp
(2^-8 relative), which the next layers carry: hidden states and logits are
held to a relative L2 error of 2e-2 (a few ulps of drift) with every
element within 0.25 of the reference (the largest |hidden| is ~5), the
loss to rtol 2e-3.  Integers (top-k indices, capacity positions, cache
slots) are held exactly.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as ref_get_arch
from repro.models import common as RC
from repro.models import transformer as RT

from repro_torch import convert
from repro_torch.configs import all_arch_ids, get_arch, lm_shapes
from repro_torch.models import common as TC
from repro_torch.models import transformer as TT
from repro_torch.models.common import param_dict

LM_ARCHS = ["command-r-35b", "mixtral-8x22b", "moonshot-v1-16b-a3b",
            "qwen1.5-0.5b", "qwen3-0.6b"]
BASE = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_head=8,
            d_ff=64, vocab=97)
TOL = dict(rtol=2e-5, atol=2e-5)
# the reference's entry points, jitted (the config static), so a loop of
# decode steps compiles once
REF_FORWARD = jax.jit(RT.forward, static_argnums=2)
REF_LOSS_GRAD = jax.jit(jax.value_and_grad(RT.lm_loss), static_argnums=3)
REF_PREFILL = jax.jit(RT.prefill_step, static_argnums=2)
REF_SERVE = jax.jit(RT.serve_step, static_argnums=4)

FULL_COUNTS = {
    "qwen1.5-0.5b": (619_570_176, 619_570_176),
    "qwen3-0.6b": (751_632_384, 751_632_384),
    "command-r-35b": (32_380_690_432, 32_380_690_432),
    "mixtral-8x22b": (140_630_071_296, 39_161_468_928),
    "moonshot-v1-16b-a3b": (28_057_995_264, 3_974_301_696),
}


def _cfgs(dtype="f32", **kw):
    """(reference cfg, port cfg) of the same fields at one compute dtype."""
    jd, td = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return (RT.TransformerConfig(compute_dtype=jd, **kw),
            TT.TransformerConfig(compute_dtype=td, **kw))


def _port_cfg(rcfg, dtype=None):
    """The port's config of the reference's, field for field."""
    d = dataclasses.asdict(rcfg)
    d["param_dtype"] = torch.float32
    d["compute_dtype"] = dtype or {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        jnp.dtype(rcfg.compute_dtype).name]
    return TT.TransformerConfig(**d)


def _carry(rcfg, tcfg, seed=1):
    params = RT.init_params(jax.random.PRNGKey(seed), rcfg)
    arrays = jax.tree_util.tree_map(np.asarray, params)
    return params, TT.Transformer(tcfg, convert.lm_tree_from_arrays(arrays, tcfg, "cpu"))


def _tokens(vocab, B=2, S=16, seed=2):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _np(x):
    return x.detach().float().numpy()


def _flat(tree) -> dict:
    out = {}
    for path, x in jax.tree_util.tree_leaves_with_path(tree):
        out[".".join(str(p.key) for p in path)] = np.asarray(x, np.float32)
    return out


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _assert_bf16_close(got, want, atol=0.25):
    assert _rel_l2(got, want) < 2e-2
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0, atol=atol)


# --------------------------------------------------------------------------
# configs, counts, registry
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_configs_equal_the_reference_field_for_field(arch):
    bundle, ref = get_arch(arch), ref_get_arch(arch)
    assert bundle.family == ref.family == "lm"
    for which in ("full", "smoke"):
        got, want = getattr(bundle, which), getattr(ref, which)
        assert got == _port_cfg(want)
        assert got.param_dtype == torch.float32 and got.compute_dtype == torch.bfloat16
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
    assert [dataclasses.asdict(s) for s in bundle.shapes] == [
        dataclasses.asdict(s) for s in ref.shapes]


@pytest.mark.parametrize("arch", sorted(FULL_COUNTS))
def test_full_config_counts(arch):
    full = get_arch(arch).full
    assert (full.param_count(), full.active_param_count()) == FULL_COUNTS[arch]
    assert sum(math.prod(s) for s in TT.param_shapes(full).values()) == full.param_count()


def test_lm_shapes_and_registry():
    from repro.configs import lm_shapes as ref_lm_shapes

    for full_only in (True, False):
        assert lm_shapes(full_only) == tuple(
            type(lm_shapes(full_only)[0])(**dataclasses.asdict(s))
            for s in ref_lm_shapes(full_only))
    assert lm_shapes(True)[-1].skip.startswith("pure full-attention arch")
    assert lm_shapes(False)[-1].skip == ""
    assert len(all_arch_ids()) == 10
    assert set(LM_ARCHS) <= set(all_arch_ids())
    assert get_arch("gin-tu").family == "gnn"
    assert get_arch("gin-tu").full.name == "gin-tu"


def test_cast_tree_matches_the_reference():
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3) / 7,
            "b": [np.arange(4, dtype=np.int32), {"c": np.ones(3, np.float32)}]}
    want = RC.cast_tree(jax.tree_util.tree_map(jnp.asarray, tree), jnp.bfloat16)
    got = TC.cast_tree({"a": _t(tree["a"]), "b": [_t(tree["b"][0]), {"c": _t(tree["b"][1]["c"])}]},
                       torch.bfloat16)
    assert got["a"].dtype == torch.bfloat16 and got["b"][1]["c"].dtype == torch.bfloat16
    assert got["b"][0].dtype == torch.int32
    np.testing.assert_array_equal(_np(got["a"]), np.asarray(want["a"], np.float32))
    np.testing.assert_array_equal(got["b"][0].numpy(), np.asarray(want["b"][0]))


def test_mesh_names_wait_for_the_several_device_slice(tmp_path):
    """The mesh names, which raised until the several-device slice: the
    specs equal the reference's; ``moe_ffn_shard_map`` without a mesh is
    ``moe_ffn``; on a 1-rank mesh a forward with ``moe_shard_map=True``
    (the TP-in-expert branch, its ``psum`` over the group) equals the
    reference's forward and the port's without it; ``_moe_local`` with no
    axis is one GShard group."""
    from test_torch_mesh import _norm, one_rank_mesh

    from repro_torch.launch.mesh import set_mesh

    rcfg, tcfg = _cfgs(**BASE, n_experts=4, top_k=2)
    for tp in (1, 2, 4):
        assert _norm(TT.param_specs(tcfg, tp=tp)) == _norm(RT.param_specs(rcfg, tp=tp))
    for kind in ("train", "prefill", "decode"):
        assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in TT.input_specs(
            tcfg, kind, 8, 2).items()} == {k: (v.shape, str(v.dtype)) for k, v in
                                          RT.input_specs(rcfg, kind, 8, 2).items()}
    cfg = dataclasses.replace(tcfg, moe_shard_map=True)
    params, model = _carry(rcfg, cfg)
    tok = _tokens(rcfg.vocab)
    with torch.no_grad():
        plain, aux0 = TT.forward(model, _t(tok).long(), tcfg)
        same, _ = TT.forward(model, _t(tok).long(), cfg)  # no mesh: moe_ffn
        lp = TT.layer_params(model)[0]
        x = torch.randn(32, tcfg.d_model, generator=torch.Generator().manual_seed(0))
        args = (x, lp["router"], lp["w1"], lp["w3"], lp["w2"])
        local, aux_l = TT._moe_local(*args, cfg, cfg.n_experts, None)
        one, aux_1 = TT.moe_ffn(*args, tcfg)
    np.testing.assert_array_equal(same.numpy(), plain.numpy())
    np.testing.assert_allclose(local.numpy(), one.numpy(), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(float(aux_l), float(aux_1), rtol=1e-6)
    ref, _ = RT.forward(params, jnp.asarray(tok), rcfg)
    with one_rank_mesh(tmp_path) as mesh, set_mesh(mesh), torch.no_grad():
        got, aux = TT.forward(model, _t(tok).long(), cfg)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(aux0), rtol=1e-6)


def test_tree_carries_across_both_ways():
    rcfg, tcfg = _cfgs(**BASE, qkv_bias=True, qk_norm=True)
    params, model = _carry(rcfg, tcfg)
    back = convert.lm_params_to_arrays(model)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, params))
    for k, v in _flat(params).items():
        np.testing.assert_array_equal(_flat(back)[k], v)
    # the module's parameter order is jax's leaf order
    assert list(param_dict(model)) == list(_flat(params))
    bad = jax.tree_util.tree_map(np.asarray, params)
    bad["layers"]["wq"] = bad["layers"]["wq"][:, :, :-1]
    with pytest.raises(ValueError, match="does not fit"):
        convert.lm_tree_from_arrays(bad, tcfg, "cpu")


# --------------------------------------------------------------------------
# the pieces, f32
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_rope(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 12, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, 12)
    jx = jnp.asarray(x) if dtype is np.float32 else jnp.asarray(x, jnp.bfloat16)
    tx = _t(x) if dtype is np.float32 else _t(x).bfloat16()
    want = RT.rope(jx, jnp.asarray(pos), 10_000.0)
    got = TT.rope(tx, _t(pos), 10_000.0)
    assert got.dtype == tx.dtype
    if dtype is np.float32:
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    else:  # one rounding to bf16 of f32 values within an ulp of each other
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   rtol=2 ** -7, atol=1e-6)


def _qkv(rng, B=2, S=16, H=4, KV=2, D=8):
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("window", [0, 5, 8])
def test_attention_paths_match_the_reference(window):
    rng = np.random.default_rng(window)
    q, k, v = _qkv(rng)
    pos = np.arange(16)
    want = RT.full_attention(*map(jnp.asarray, (q, k, v, pos, pos)), window)
    got = TT.full_attention(*map(_t, (q, k, v, pos, pos)), window)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    for chunk in (4, 8):
        want_c = RT.chunked_attention(*map(jnp.asarray, (q, k, v, pos, pos)), window, chunk)
        got_c = TT.chunked_attention(*map(_t, (q, k, v, pos, pos)), window, chunk)
        np.testing.assert_allclose(_np(got_c), np.asarray(want_c), **TOL)
        np.testing.assert_allclose(_np(got_c), _np(got), **TOL)


@pytest.mark.parametrize("window", [0, 8])
def test_chunked_attention_skipping_dead_chunks_is_bit_exact(window, monkeypatch):
    """A kv chunk the mask wholly hides leaves (max, denom, acc) as they are,
    bit for bit, so skipping it changes nothing; a chunk it wholly keeps
    gives the same bits without the mask."""
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, S=32)
    pos = _t(np.arange(32) + 100)
    args = (*map(_t, (q, k, v)), pos, pos, window, 4)
    live = TT._live_blocks(pos.reshape(8, 4), pos.reshape(8, 4), window)
    assert sum(map(len, live)) < 64  # some chunks are skipped
    assert sum(not partial for row in live for _, partial in row) > 0
    skipped = TT.chunked_attention(*args)
    monkeypatch.setattr(TT, "_live_blocks", lambda qpc, kpc, w: [
        [(j, True) for j in range(kpc.shape[0])]] * qpc.shape[0])
    assert torch.equal(TT.chunked_attention(*args), skipped)


def test_dense_ffn_matches_the_reference():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    w1, w3 = (rng.normal(size=(16, 24)).astype(np.float32) / 4 for _ in range(2))
    w2 = rng.normal(size=(24, 16)).astype(np.float32) / 5
    want = RT.dense_ffn(*map(jnp.asarray, (x, w1, w3, w2)))
    np.testing.assert_allclose(_np(TT.dense_ffn(*map(_t, (x, w1, w3, w2)))),
                               np.asarray(want), **TOL)


def test_top_k_breaks_ties_by_the_lower_index():
    probs = np.array([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.4, 0.1, 0.4]], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), 3)
    got_v, got_i = TT._top_k(_t(probs), 3)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def _moe_inputs(rng, T=24, d=16, E=4, ff=12):
    x = rng.normal(size=(T, d)).astype(np.float32)
    router = rng.normal(size=(d, E)).astype(np.float32) / 4
    w1, w3 = (rng.normal(size=(E, d, ff)).astype(np.float32) / 4 for _ in range(2))
    w2 = rng.normal(size=(E, ff, d)).astype(np.float32) / 3.5
    return x, router, w1, w3, w2


@pytest.mark.parametrize("groups,factor", [(1, 1.25), (2, 1.25), (2, 0.34), (3, 0.5)])
def test_moe_ffn_output_aux_and_gradients(groups, factor):
    rng = np.random.default_rng(groups)
    rcfg, tcfg = _cfgs(**BASE, n_experts=4, top_k=2, moe_groups=groups,
                       capacity_factor=factor)
    ins = _moe_inputs(rng)
    r = rng.normal(size=(24, 16)).astype(np.float32)

    def ref_obj(*a):
        out, aux = RT.moe_ffn(*a, rcfg)
        return jnp.sum(out * r) + aux, (out, aux)

    (_, (want, want_aux)), want_g = jax.value_and_grad(
        ref_obj, argnums=(0, 1, 2, 3, 4), has_aux=True)(*map(jnp.asarray, ins))
    tins = [_t(a).requires_grad_() for a in ins]
    got, aux = TT.moe_ffn(*tins, tcfg)
    got_g = torch.autograd.grad((got * _t(r)).sum() + aux, tins)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=2e-5)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5, atol=2e-5)
    # the dropping cases drop: some token has a zero row
    T, G = 24, max(1, min(groups, 24))
    cap = max(int(math.ceil(T // G * 2 / 4 * factor)), 4)
    if cap < T // G * 2 / 4:
        assert (np.abs(_np(got)).sum(1) == 0).any() or float(aux) > 0


@pytest.mark.parametrize("extra", [{}, {"qkv_bias": True, "qk_norm": True},
                                   {"n_experts": 4, "top_k": 2}, {"sliding_window": 6}])
def test_layer_matches_the_reference(extra):
    rcfg, tcfg = _cfgs(**BASE, **extra)
    params, model = _carry(rcfg, tcfg)
    lp = {k: v[0] for k, v in params["layers"].items()}
    x = np.random.default_rng(5).normal(size=(2, 12, 32)).astype(np.float32)
    pos = np.arange(12)
    want, want_aux, want_kv = RT._layer(jnp.asarray(x), lp, jnp.asarray(pos), rcfg)
    got, aux, kv = TT._layer(_t(x), TT.layer_params(model)[0], _t(pos), tcfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=2e-5)
    for g, w in zip(kv, want_kv):
        np.testing.assert_allclose(_np(g), np.asarray(w), **TOL)


@pytest.mark.parametrize("window,Sc,cache_pos", [(0, 8, 5), (0, 8, 11), (8, 8, 5), (8, 8, 21)])
def test_cache_positions(window, Sc, cache_pos):
    rcfg, tcfg = _cfgs(**{**BASE, "sliding_window": window})
    want = RT._cache_positions(Sc, jnp.int32(cache_pos), rcfg)
    got = TT._cache_positions(Sc, cache_pos, tcfg, "cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# forward, loss, gradients, serving: the five smoke configs
# --------------------------------------------------------------------------

def _smoke(arch, dtype):
    rcfg = ref_get_arch(arch).smoke
    if dtype == "f32":
        rcfg = dataclasses.replace(rcfg, compute_dtype=jnp.float32)
    tcfg = _port_cfg(rcfg)
    params, model = _carry(rcfg, tcfg, seed=0)
    return rcfg, tcfg, params, model


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_loss_and_gradients_f32(arch):
    rcfg, tcfg, params, model = _smoke(arch, "f32")
    tok, lab = _tokens(rcfg.vocab, S=32), _tokens(rcfg.vocab, S=32, seed=3)
    want_h, want_aux = REF_FORWARD(params, jnp.asarray(tok), rcfg)
    got_h, got_aux = TT.forward(model, _t(tok), tcfg)
    np.testing.assert_allclose(_np(got_h), np.asarray(want_h), **TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=2e-5, atol=1e-7)
    want_l, want_g = REF_LOSS_GRAD(params, jnp.asarray(tok), jnp.asarray(lab), rcfg)
    loss = TT.lm_loss(model, _t(tok), _t(lab), tcfg)
    named = param_dict(model)
    grads = torch.autograd.grad(loss, list(named.values()))
    np.testing.assert_allclose(float(loss), float(want_l), rtol=2e-5)
    want_g = _flat(want_g)
    assert list(named) == list(want_g)
    for (k, _), g in zip(named.items(), grads):
        np.testing.assert_allclose(g.numpy(), want_g[k], rtol=2e-5, atol=2e-5, err_msg=k)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_and_loss_bf16(arch):
    rcfg, tcfg, params, model = _smoke(arch, "bf16")
    tok, lab = _tokens(rcfg.vocab, S=32), _tokens(rcfg.vocab, S=32, seed=3)
    want_h, _ = REF_FORWARD(params, jnp.asarray(tok), rcfg)
    with torch.no_grad():
        got_h, _ = TT.forward(model, _t(tok), tcfg)
        loss = TT.lm_loss(model, _t(tok), _t(lab), tcfg)
    assert got_h.dtype == torch.bfloat16
    _assert_bf16_close(_np(got_h), np.asarray(want_h, np.float32))
    want_l = RT.lm_loss(params, jnp.asarray(tok), jnp.asarray(lab), rcfg)
    np.testing.assert_allclose(float(loss), float(want_l), rtol=2e-3)


def test_chunked_loss_keeps_no_full_logits():
    """The backward recomputes each chunk's logits: no saved tensor holds
    [B, S, V] values, and the remainder branch (S not a multiple of the
    chunk) is taken."""
    rcfg, tcfg, params, model = _smoke("qwen3-0.6b", "f32")
    B, S = 2, 40  # 2 chunks of 16 and a remainder of 8
    tok, lab = _tokens(rcfg.vocab, B, S), _tokens(rcfg.vocab, B, S, seed=3)
    sizes = []

    def pack(t):
        sizes.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = TT.lm_loss(model, _t(tok), _t(lab), tcfg)
    assert max(sizes) < B * S * rcfg.vocab
    want = RT.lm_loss(params, jnp.asarray(tok), jnp.asarray(lab), rcfg)
    np.testing.assert_allclose(float(loss), float(want), rtol=2e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_decode_and_cache_match_the_reference(arch, dtype):
    """prefill_step, init_cache and serve_step past the window (the smoke
    mixtral's is 16): logits and caches against the reference's."""
    rcfg, tcfg, params, model = _smoke(arch, dtype)
    B, S, n = 2, 32, 20
    tok = _tokens(rcfg.vocab, B, S)
    want_l, want_c = REF_PREFILL(params, jnp.asarray(tok), rcfg)
    got_l, got_c = TT.prefill_step(model, _t(tok), tcfg)
    assert got_c.shape == want_c.shape and got_c.dtype == tcfg.compute_dtype
    close = ((lambda g, w: np.testing.assert_allclose(g, w, **TOL)) if dtype == "f32"
             else _assert_bf16_close)
    close(_np(got_l), np.asarray(want_l))
    close(_np(got_c), np.asarray(want_c, np.float32))
    rc, tc = RT.init_cache(rcfg, B, n), TT.init_cache(tcfg, B, n, "cpu")
    assert tc.shape == rc.shape and tc.dtype == tcfg.compute_dtype and not tc.any()
    for i in range(n):
        wl, rc = REF_SERVE(params, rc, jnp.asarray(tok[:, i]), jnp.int32(i), rcfg)
        gl, tc2 = TT.serve_step(model, tc, _t(tok[:, i]), i, tcfg)
        assert tc2 is tc  # the cache is updated in place
        close(_np(gl), np.asarray(wl))
    close(_np(tc), np.asarray(rc, np.float32))


def test_serve_step_clamps_the_insert_past_the_cache():
    """Without a window, a decode at cache_pos >= Sc writes its keys and
    values into the last slot, as ``dynamic_update_slice`` clamps it."""
    rcfg, tcfg = _cfgs(**BASE)
    params, model = _carry(rcfg, tcfg)
    B, Sc = 2, 6
    tok = _tokens(rcfg.vocab, B, 10)
    rc, tc = RT.init_cache(rcfg, B, Sc), TT.init_cache(tcfg, B, Sc, "cpu")
    for i in range(10):
        wl, rc = REF_SERVE(params, rc, jnp.asarray(tok[:, i]), jnp.int32(i), rcfg)
        before = tc.clone()
        gl, tc = TT.serve_step(model, tc, _t(tok[:, i]), i, tcfg)
        np.testing.assert_allclose(_np(gl), np.asarray(wl), **TOL)
        np.testing.assert_allclose(_np(tc), np.asarray(rc), **TOL)
        if i >= Sc:  # only the last slot changed
            assert torch.equal(tc[:, :, :, :Sc - 1], before[:, :, :, :Sc - 1])
            assert not torch.equal(tc[:, :, :, Sc - 1], before[:, :, :, Sc - 1])


# --------------------------------------------------------------------------
# the reference's own contracts (test_transformer_consistency.py) on the port
# --------------------------------------------------------------------------

def _port_params_tokens(cfg, B=2, S=16):
    """The reference test's draws (PRNGKey 1 params, PRNGKey 2 tokens),
    carried across."""
    rcfg = RT.TransformerConfig(**{**dataclasses.asdict(cfg), "param_dtype": jnp.float32,
                                   "compute_dtype": jnp.float32})
    params = RT.init_params(jax.random.PRNGKey(1), rcfg)
    tok = jax.random.randint(jax.random.PRNGKey(2), (B, S), 0, cfg.vocab)
    arrays = jax.tree_util.tree_map(np.asarray, params)
    return TT.Transformer(cfg, convert.lm_tree_from_arrays(arrays, cfg, "cpu")), _t(tok).long()


PBASE = dict(BASE, compute_dtype=torch.float32)


def test_chunked_equals_full():
    cfg_full = TT.TransformerConfig(attn_chunk=10**6, **PBASE)
    cfg_chunk = TT.TransformerConfig(attn_chunk=4, **PBASE)
    model, tok = _port_params_tokens(cfg_full)
    h1, _ = TT.forward(model, tok, cfg_full)
    h2, _ = TT.forward(model, tok, cfg_chunk)
    np.testing.assert_allclose(_np(h1), _np(h2), rtol=2e-5, atol=2e-5)


def test_chunked_equals_full_swa():
    cfg_full = TT.TransformerConfig(attn_chunk=10**6, sliding_window=8, **PBASE)
    cfg_chunk = TT.TransformerConfig(attn_chunk=4, sliding_window=8, **PBASE)
    model, tok = _port_params_tokens(cfg_full)
    h1, _ = TT.forward(model, tok, cfg_full)
    h2, _ = TT.forward(model, tok, cfg_chunk)
    np.testing.assert_allclose(_np(h1), _np(h2), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("window", [0, 8])
def test_decode_matches_prefill(window):
    cfg = TT.TransformerConfig(sliding_window=window, attn_chunk=10**6, **PBASE)
    model, tok = _port_params_tokens(cfg)
    B, S = tok.shape
    logits_pf, _ = TT.prefill_step(model, tok, cfg)
    cache = TT.init_cache(cfg, B, S, "cpu")
    for i in range(S):
        lg, cache = TT.serve_step(model, cache, tok[:, i], i, cfg)
    np.testing.assert_allclose(_np(lg), _np(logits_pf), rtol=1e-4, atol=1e-4)


def test_swa_ring_buffer_beyond_window():
    """Decoding past the window must equal full recompute with SWA mask."""
    cfg = TT.TransformerConfig(sliding_window=8, attn_chunk=10**6, **PBASE)
    model, tok = _port_params_tokens(cfg, S=16)
    B, S = tok.shape
    cache = TT.init_cache(cfg, B, S, "cpu")
    assert cache.shape[3] == 8  # ring buffer is window-sized
    for i in range(S):
        lg, cache = TT.serve_step(model, cache, tok[:, i], i, cfg)
    logits_pf, _ = TT.prefill_step(model, tok, cfg)
    np.testing.assert_allclose(_np(lg), _np(logits_pf), rtol=1e-4, atol=1e-4)


def test_swa_prefill_lines_up_with_the_ring_only_at_multiples_of_the_window():
    """The reference's quirk, copied: a prefill longer than the window keeps
    its last ``window`` positions in slots 0.., and decode expects position
    p in slot p % window, so decoding on from a 16-token prefill (a
    multiple of 8) equals a full prefill, and from a 12-token one it does
    not."""
    cfg = TT.TransformerConfig(sliding_window=8, attn_chunk=10**6, **PBASE)
    model, tok = _port_params_tokens(cfg, S=20)
    want, _ = TT.prefill_step(model, tok, cfg)
    for S0, lines_up in ((16, True), (12, False)):
        _, cache = TT.prefill_step(model, tok[:, :S0], cfg)
        for i in range(S0, 20):
            lg, cache = TT.serve_step(model, cache, tok[:, i], i, cfg)
        assert np.allclose(_np(lg), _np(want), rtol=1e-4, atol=1e-4) == lines_up


def test_sliding_window_ignores_distant_past():
    """Changing tokens older than the window must not change the last logits
    (with a single layer; deeper stacks propagate beyond the window)."""
    cfg = TT.TransformerConfig(**{**PBASE, "n_layers": 1, "sliding_window": 4,
                                  "attn_chunk": 10**6})
    model, tok = _port_params_tokens(cfg, S=12)
    h1, _ = TT.forward(model, tok, cfg)
    tok2 = tok.clone()
    tok2[:, 0:4] = (tok[:, 0:4] + 1) % cfg.vocab
    h2, _ = TT.forward(model, tok2, cfg)
    np.testing.assert_allclose(_np(h1[:, -1]), _np(h2[:, -1]), rtol=1e-5, atol=1e-5)


def test_moe_routes_and_trains():
    cfg = TT.TransformerConfig(n_experts=4, top_k=2, **PBASE)
    model, tok = _port_params_tokens(cfg)
    loss = TT.lm_loss(model, tok, tok, cfg)
    assert np.isfinite(float(loss))
    (g1,) = torch.autograd.grad(loss, [model.layers.w1])  # [L, E, d, ff]
    per_expert = g1.abs().sum((0, 2, 3))
    assert (per_expert > 0).all()
