"""The port's recsys models and trainer path against the JAX package, at
the smoke configs of the four recsys archs (DCN-v2, DLRM, DIN, BST):
configs and registry, parameters carried across, forward / loss / serve /
retrieval, gradients, AdamW, the train step, the data pipeline and the
whole example loop.

Tolerances and why: forward, loss and scores rtol 1e-5 and gradients atol
1e-6 (f32 sums in another order: XLA's dots against torch's); the optimizer
atol 1e-6 + rtol 1e-5 (its pow, sqrt and global-norm sum may differ by an
ulp); train steps losses rtol 1e-5 and parameters atol 1e-5 + rtol 1e-4
(Adam divides by sqrt(v) + eps, so a gradient near eps carries its ulp
differences into the step), where at most ceil(1e-5 x the parameter
count) elements whose RMS gradient is nonzero but under 100 x eps may
lie within Adam's step bound instead (``_assert_params_close``), in BST's
4-step train-step test alone, which has one such element; every other
arch and test holds every element to the plain bound; the data pipeline
exactly.
"""

import dataclasses
import hashlib
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import RECSYS_SHAPES as REF_SHAPES
from repro.configs import get_arch as ref_get_arch
from repro.data import recsys_data as rdata
from repro.kernels.embedding_bag.ops import multi_hot_embed as ref_multi_hot_embed
from repro.launch.cells import make_train_step as ref_make_train_step
from repro.models import common as RC
from repro.models import recsys as R
from repro.optim import adamw as radamw

from repro_torch import convert
from repro_torch.configs import RECSYS_SHAPES, all_arch_ids, get_arch
from repro_torch.data import recsys_data as tdata
from repro_torch.examples import train_recsys as ex
from repro_torch.kernels.embedding_bag import kernel as ebk
from repro_torch.launch.cells import make_train_step
from repro_torch.models import recsys as T
from repro_torch.models import common as TC
from repro_torch.models.common import param_dict, tree_size
from repro_torch.optim import adamw as tadamw

ARCHS = ["bst", "dcn-v2", "din", "dlrm-rm2"]  # the reference's RS_ARCHS, sorted


def _carried(arch, seed=0):
    """(reference cfg, port cfg, JAX params, the port's module holding them)."""
    rcfg, tcfg = ref_get_arch(arch).smoke, get_arch(arch).smoke
    params = R.init_params(jax.random.PRNGKey(seed), rcfg)
    arrays = jax.tree_util.tree_map(np.asarray, params)
    return rcfg, tcfg, params, convert.recsys_params_from_arrays(arrays, tcfg, "cpu")


def _flat(tree) -> dict:
    """A JAX tree as {dotted name: numpy array}, the port's names."""
    out = {}
    for path, x in jax.tree_util.tree_leaves_with_path(tree):
        name = ".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        out[name] = np.asarray(x)
    return out


def _batch(rng, cfg, B):
    b = rdata.make_ctr_batch(rng, cfg, B)
    return b, {k: torch.from_numpy(v) for k, v in b.items()}


def _assert_params_close(model, tree, atol, rtol, adam=None):
    """The port's parameters (a module, or a dict of tensors by dotted
    name) against the reference's tree, every element within ``atol + rtol
    * |want|``.

    With ``adam`` = (the reference's AdamW state, the summed lr of its
    steps), an element may instead lie within Adam's step bound (2 x the
    summed lr) if its bias-corrected RMS gradient sqrt(v_hat) is nonzero
    but under 100 x Adam's eps (1e-8): there m_hat / (sqrt(v_hat) + eps)
    turns an ulp-sized difference of a gradient that f32 sums cancel to
    near eps into a step of order lr, and no sum order pins it.  At most
    ceil(1e-5 x the parameter count) elements may use that bound."""
    want = _flat(tree)
    named = model if isinstance(model, dict) else param_dict(model)
    got = {k: p.detach().numpy() for k, p in named.items()}
    assert list(got) == list(want)  # the JAX tree's leaf order
    if adam is None:
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=rtol,
                                       err_msg=k)
        return 0
    opt, lr_sum = adam
    v = _flat(opt["v"])
    c2 = 1.0 - 0.95 ** int(opt["count"])
    n_cond = 0
    for k in want:
        diff = np.abs(got[k] - want[k])
        off = diff > atol + rtol * np.abs(want[k])
        near_eps = (v[k] > 0) & (np.sqrt(v[k] / c2) < 100 * 1e-8)
        assert not np.any(off & ~near_eps), (k, float(diff[off & ~near_eps].max()))
        assert np.all(diff[off] <= 2 * lr_sum), k
        n_cond += int(off.sum())
    assert n_cond <= math.ceil(1e-5 * sum(x.size for x in want.values()))
    return n_cond


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference_field_for_field(arch):
    for which in ("full", "smoke"):
        got = getattr(get_arch(arch), which)
        want = getattr(ref_get_arch(arch), which)
        g, w = dataclasses.asdict(got), dataclasses.asdict(want)
        assert str(g.pop("compute_dtype")).split(".")[-1] == jnp.dtype(
            w.pop("compute_dtype")).name
        assert g == w
        assert got.table_rows == want.table_rows
        assert got.param_count() == want.param_count()
    assert get_arch(arch).shapes == RECSYS_SHAPES
    assert [dataclasses.asdict(s) for s in RECSYS_SHAPES] == [
        dataclasses.asdict(s) for s in REF_SHAPES]
    # the recsys archs beside the LM family's five (A7c) and gin-tu (A7d)
    assert [a for a in all_arch_ids() if get_arch(a).family == "recsys"] == ARCHS
    assert len(all_arch_ids()) == 10


def test_full_dcn_v2_counts():
    cfg = get_arch("dcn-v2").full
    assert cfg.table_rows == 27_262_976
    assert cfg.param_count() == 438_776_258


def test_common_helpers_match_the_reference():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(5, 7, 24)).astype(np.float32)
    scale, bias = (rng.normal(size=24).astype(np.float32) for _ in range(2))
    tx, ts, tb = (torch.from_numpy(a) for a in (x, scale, bias))
    np.testing.assert_allclose(TC.rms_norm(tx, ts).numpy(),
                               np.asarray(RC.rms_norm(x, scale)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(TC.layer_norm(tx, ts, tb).numpy(),
                               np.asarray(RC.layer_norm(x, scale, bias)), rtol=1e-5, atol=1e-5)
    tree = {"a": tx, "b": [{"w": ts.bfloat16()}]}
    jtree = {"a": jnp.asarray(x), "b": [{"w": jnp.asarray(scale, jnp.bfloat16)}]}
    assert TC.tree_size(tree) == RC.tree_size(jtree) == x.size + 24
    assert TC.tree_bytes(tree) == RC.tree_bytes(jtree) == 4 * x.size + 2 * 24
    gen = torch.Generator().manual_seed(0)
    keys = TC.split_keys(gen, ["a", "b"])
    w = TC.dense_init(keys["a"], (400, 300))
    std = 1 / 20  # 1/sqrt(fan_in)
    assert w.shape == (400, 300) and float(w.abs().max()) <= 2 * std
    assert abs(float(w.std()) / std - 0.88) < 0.02  # a normal cut at +-2 sd
    again = TC.split_keys(torch.Generator().manual_seed(0), ["a", "b"])
    assert torch.equal(TC.dense_init(again["a"], (400, 300)), w)
    assert not torch.equal(TC.dense_init(keys["b"], (400, 300)), w)


@pytest.mark.parametrize("arch", ARCHS)
def test_carried_parameters(arch):
    rcfg, tcfg, params, model = _carried(arch)
    assert tree_size(model) == rcfg.param_count() == tcfg.param_count()
    back = convert.recsys_params_to_arrays(model)
    for k, x in _flat(params).items():
        assert np.array_equal(_flat(back)[k], x), k
    with pytest.raises(ValueError, match="does not fit"):
        convert.recsys_params_from_arrays(back, get_arch(arch).full, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_serve_and_grads_match_jax(arch):
    rcfg, tcfg, params, model = _carried(arch)
    b, tb = _batch(np.random.default_rng(1), rcfg, 32)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    for tfn, rfn in ((T.forward, R.forward), (T.serve_score, R.serve_score)):
        np.testing.assert_allclose(tfn(model, tb, tcfg).detach().numpy(),
                                   np.asarray(rfn(params, jb, rcfg)), rtol=1e-5, atol=1e-7)
    loss = T.loss_fn(model, tb, tcfg)
    rloss, rgrads = jax.value_and_grad(R.loss_fn)(params, jb, rcfg)
    np.testing.assert_allclose(float(loss.detach()), float(rloss), rtol=1e-5)
    leaves = param_dict(model)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    want = _flat(rgrads)
    for k, g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), want[k], atol=1e-6, rtol=0, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_retrieval_step_matches_jax(arch):
    rcfg, tcfg, params, model = _carried(arch)
    rng = np.random.default_rng(2)
    if rcfg.kind in ("dcn", "dlrm"):
        user = {"dense": rng.normal(size=(1, rcfg.n_dense)).astype(np.float32),
                "sparse": rng.integers(0, rcfg.rows_per_field,
                                       (1, rcfg.n_sparse)).astype(np.int32)}
        vocab = rcfg.rows_per_field
    else:  # a user's history, partly masked; the candidate is the target
        user = {"history": rng.integers(0, rcfg.item_vocab,
                                        (1, rcfg.seq_len)).astype(np.int32),
                "hist_mask": np.arange(rcfg.seq_len)[None] < rcfg.seq_len // 2}
        vocab = rcfg.item_vocab
    user["candidates"] = rng.integers(0, vocab, 64).astype(np.int32)
    got = T.retrieval_step(model, {k: torch.from_numpy(v) for k, v in user.items()},
                           tcfg)
    want = R.retrieval_step(params, {k: jnp.asarray(v) for k, v in user.items()}, rcfg)
    assert got.shape == (64,)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


# sha256 over (name, f32 bytes) of every leaf of init_model(smoke, seed 0) on
# the CPU, as the DCN-v2 / DLRM-only module drew them before DIN and BST
# came: adding the sequential kinds must not move a dcn/dlrm draw
PARENT_INIT_SHA256 = {
    "dcn-v2": "6adcd08b228e9173d0f5eb415e6ebb60850f84b03ab0585afaccf5bae7198f55",
    "dlrm-rm2": "cae7092b03d6cc325424076306eb5b4fc58304cebecb253bb75d5ceee221dbd4",
}


@pytest.mark.parametrize("arch", sorted(PARENT_INIT_SHA256))
def test_dcn_and_dlrm_init_from_seed_0_is_unchanged(arch):
    h = hashlib.sha256()
    for k, p in param_dict(T.init_model(get_arch(arch).smoke, 0, "cpu")).items():
        h.update(k.encode())
        h.update(p.detach().numpy().tobytes())
    assert h.hexdigest() == PARENT_INIT_SHA256[arch]


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gin-tu"])
def test_lm_and_gnn_archs_wait_for_their_slice(arch):
    """The LM archs (A7c) and the GNN arch (A7d) have landed: the launcher
    builds them and takes a step."""
    from repro_torch.launch.train import build_training

    state, step, batches, cfg = build_training(arch, smoke=True, batch=4, seq_len=16,
                                               device="cpu")
    assert cfg == get_arch(arch).smoke and int(state[1]["count"]) == 0
    state, m = step(state, batches(0))
    assert np.isfinite(float(m["loss"])) and int(state[1]["count"]) == 1


def test_full_sequential_counts():
    assert get_arch("din").full.param_count() == 37_785_017
    assert get_arch("bst").full.param_count() == 68_467_424
    assert get_arch("din").full.param_count() == ref_get_arch("din").full.param_count()
    assert get_arch("bst").full.param_count() == ref_get_arch("bst").full.param_count()


def test_optimizer_pieces_match_the_reference():
    rng = np.random.default_rng(3)
    shapes = {"a": (7, 5), "b": (5,), "c": (300, 4)}
    p = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    g = {k: (rng.normal(size=s) * 10.0 ** rng.integers(-9, 1, s)).astype(np.float32)
         for k, s in shapes.items()}
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    for max_norm in (1.0, 1e-3, 1e6):
        (cg, gn), (rcg, rgn) = (tadamw.clip_by_global_norm(tg, max_norm),
                                radamw.clip_by_global_norm(jg, max_norm))
        np.testing.assert_allclose(float(gn), float(rgn), rtol=1e-6)
        for k in g:
            np.testing.assert_allclose(cg[k].numpy(), np.asarray(rcg[k]), rtol=1e-6, atol=0)
    for step in (0, 1, 5, 10, 11, 500, 10**6):
        np.testing.assert_allclose(
            float(tadamw.cosine_lr(step, 1e-2, 10, 1000)),
            float(radamw.cosine_lr(jnp.int32(step), 1e-2, 10, 1000)), rtol=1e-6)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    ts = tadamw.adamw_init(tp)
    jp, js = {k: jnp.asarray(v) for k, v in p.items()}, radamw.adamw_init(p)
    for lr in (1e-3, 3e-2, 1e-2):
        tadamw.adamw_update(tg, ts, tp, lr)
        jp, js = radamw.adamw_update(jg, js, jp, jnp.float32(lr))
    assert ts["count"] == int(js["count"]) == 3
    for k in p:
        for got, want in ((tp[k], jp[k]), (ts["m"][k], js["m"][k]), (ts["v"][k], js["v"][k])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_the_jitted_jax_step(arch):
    rcfg, tcfg, params, model = _carried(arch)
    rstep = jax.jit(ref_make_train_step(R.loss_fn, rcfg, base_lr=1e-2))
    tstep = make_train_step(T.loss_fn, tcfg, base_lr=1e-2)
    ropt, topt = radamw.adamw_init(params), tadamw.adamw_init(param_dict(model))
    lr_sum = 0.0
    for s in range(4):  # one step, then three more
        b, tb = _batch(np.random.default_rng(10 + s), rcfg, 16)
        params, ropt, rm = rstep(params, ropt, b)
        _, topt, tm = tstep(model, topt, tb)
        lr_sum += float(radamw.cosine_lr(jnp.int32(s + 1), 1e-2, 10, 100_000))
        np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(rm["grad_norm"]), rtol=1e-5)
        _assert_params_close(model, params, atol=1e-5, rtol=1e-4,
                             adam=(ropt, lr_sum) if arch == "bst" else None)
    assert topt["count"] == int(ropt["count"]) == 4


def test_data_pipeline_equals_the_reference():
    for arch in ARCHS:  # dense/sparse batches, and history/mask/target ones
        cfg = get_arch(arch).smoke
        got = tdata.make_ctr_batch(np.random.default_rng(4), cfg, 64)
        want = rdata.make_ctr_batch(np.random.default_rng(4), ref_get_arch(arch).smoke, 64)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
    tstore = tdata.make_multihot_store(np.random.default_rng(0), 40, 5000, 40)
    rstore = rdata.make_multihot_store(np.random.default_rng(0), 40, 5000, 40)
    assert convert.index_arrays(tstore).keys() == convert.index_arrays(rstore).keys()
    for k, v in convert.index_arrays(rstore).items():
        assert np.array_equal(convert.index_arrays(tstore)[k], v), k
    users = np.random.default_rng(5).integers(0, 40, 100)
    for pad_to in (8, 64):
        got = tdata.decode_multihot_batch(tstore, users, pad_to, device="cpu")
        want = rdata.decode_multihot_batch(rstore, users, pad_to)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)


def test_the_example_loop_matches_the_reference_loop():
    """``run(SMOKE, 3, 8)`` from carried parameters against the reference
    example's loop rebuilt from its pieces, with the Pallas EmbeddingBag in
    interpret mode over the table padded to 128 columns."""
    rcfg, tcfg, params, _ = _carried("dcn-v2")
    arrays = jax.tree_util.tree_map(np.asarray, params)
    steps, batch = 3, 8
    res = ex.run(tcfg, steps, batch, device="cpu", params=arrays)
    assert ebk.embedding_bag.launches == 0
    step_fn = jax.jit(ref_make_train_step(R.loss_fn, rcfg, base_lr=1e-2))
    opt = radamw.adamw_init(params)
    store = rdata.make_multihot_store(np.random.default_rng(0), n_users=256,
                                      vocab=rcfg.rows_per_field, mean_items=40)
    for s, rec in enumerate(res["records"]):
        b = rdata.make_ctr_batch(np.random.default_rng(s), rcfg, batch)
        users = np.random.default_rng(s).integers(0, 256, batch)
        ids, mask = rdata.decode_multihot_batch(store, users, pad_to=64)
        assert np.array_equal(rec["ids"].numpy(), ids)
        assert np.array_equal(rec["mask"].numpy(), mask)
        table = params["table"][: rcfg.rows_per_field]
        pad = ((0, 0), (0, 128 - table.shape[1]))
        bag = ref_multi_hot_embed(jnp.pad(table, pad), jnp.asarray(ids),
                                  jnp.asarray(mask))[:, : rcfg.embed_dim]
        np.testing.assert_allclose(rec["bag"].numpy(), np.asarray(bag), rtol=1e-5, atol=1e-5)
        b["dense"] = np.concatenate(
            [b["dense"][:, : rcfg.n_dense - rcfg.embed_dim],
             np.asarray(bag)[:, : rcfg.embed_dim]], axis=1
        ).astype(np.float32)[:, : rcfg.n_dense]
        np.testing.assert_allclose(rec["batch"]["dense"].numpy(), b["dense"],
                                   rtol=1e-5, atol=1e-5)
        params, opt, m = step_fn(params, opt, b)
        np.testing.assert_allclose(rec["loss"], float(m["loss"]), rtol=1e-5)
    _assert_params_close(res["state"]["model"], params, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("call", [
    lambda cfg: T.init_model(cfg),
    lambda cfg: ex.setup(cfg),
    lambda cfg: ex.run(cfg, 1, 4),
    lambda cfg: ex.main(["--steps", "1"]),
    lambda cfg: convert.recsys_params_from_arrays(
        convert.recsys_params_to_arrays(T.init_model(cfg, device="cpu")), cfg),
    lambda cfg: tdata.decode_multihot_batch(
        tdata.make_multihot_store(np.random.default_rng(0), 4, 100, 5), [0, 1], 8),
])
def test_entry_points_need_a_card_unless_told_cpu(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call(get_arch("dcn-v2").smoke)
