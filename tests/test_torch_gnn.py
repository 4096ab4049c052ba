"""The port's GIN (``repro_torch.models.gnn``) and its config against the
JAX package: configs and registry, the parameter tree carried across,
forward, loss and gradients for node and graph classification, one train
step, the host-side dst-shard layout and the names that wait for the mesh.

Tolerances and why: losses rtol 1e-6 and logits atol 1e-6 + rtol 1e-5
(f32 sums in another order: XLA's scatter-add and dots against torch's
``index_add`` and matmuls); gradients and the parameters after an AdamW
step atol 1e-5 + rtol 1e-4 on every element; configs, shapes, dtypes and
the dst-shard layout exactly.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as ref_get_arch
from repro.launch.cells import make_train_step as ref_make_train_step
from repro.models import gnn as RG
from repro.optim import adamw as radamw

from repro_torch import convert
from repro_torch.configs import all_arch_ids, get_arch
from repro_torch.launch.cells import make_train_step
from repro_torch.launch.train import named_leaves
from repro_torch.models import gnn as TG
from repro_torch.models.common import param_dict
from repro_torch.optim import adamw_init

from test_torch_recsys import _assert_params_close, _flat


def _cfgs(readout: bool):
    rcfg, tcfg = ref_get_arch("gin-tu").smoke, get_arch("gin-tu").smoke
    if readout:
        rcfg = dataclasses.replace(rcfg, graph_readout=True, n_classes=2)
        tcfg = dataclasses.replace(tcfg, graph_readout=True, n_classes=2)
    return rcfg, tcfg


def _carry(rcfg, tcfg, seed=0):
    params = RG.init_params(jax.random.PRNGKey(seed), rcfg)
    arrays = jax.tree_util.tree_map(np.asarray, params)
    return params, TG.GIN(tcfg, convert.gnn_tree_from_arrays(arrays, tcfg, "cpu"))


def _batch(cfg, seed=0, n=64, e=256, n_graphs=8):
    """``test_models_smoke.py::test_gnn_smoke_all_modes``'s inputs: 10% of
    the edges padded, half the nodes labelled; for graph readout sorted
    graph ids and a label a graph."""
    rng = np.random.default_rng(seed)
    b = {
        "feats": rng.normal(size=(n, cfg.d_in)).astype(np.float32),
        "edges": rng.integers(0, n, (2, e)).astype(np.int32),
        "edge_mask": rng.random(e) < 0.9,
    }
    if cfg.graph_readout:
        b["graph_ids"] = np.sort(rng.integers(0, n_graphs, n)).astype(np.int32)
        b["labels"] = rng.integers(0, cfg.n_classes, n_graphs).astype(np.int32)
    else:
        b["labels"] = rng.integers(0, cfg.n_classes, n).astype(np.int32)
        b["label_mask"] = rng.random(n) < 0.5
    return b, {k: torch.from_numpy(v) for k, v in b.items()}


def test_configs_and_registry_match_the_reference():
    from repro.configs import gin_tu as ref_cfg
    from repro_torch.configs import gin_tu

    assert dataclasses.asdict(gin_tu.FULL) == dataclasses.asdict(ref_cfg.FULL)
    assert dataclasses.asdict(gin_tu.SMOKE) == dataclasses.asdict(ref_cfg.SMOKE)
    assert [dataclasses.asdict(s) for s in gin_tu.SHAPES] == [
        dataclasses.asdict(s) for s in ref_cfg.SHAPES]
    bundle = get_arch("gin-tu")
    assert bundle.family == "gnn" and bundle.full is gin_tu.FULL
    assert (bundle.full.n_layers, bundle.full.d_in, bundle.full.d_hidden,
            bundle.full.n_classes) == (5, 1433, 64, 7)
    from repro.configs import all_arch_ids as ref_all_arch_ids

    assert all_arch_ids() == ref_all_arch_ids()
    assert len(all_arch_ids()) == 10
    with pytest.raises(KeyError, match="no-such-arch"):
        get_arch("no-such-arch")


@pytest.mark.parametrize("readout", [False, True], ids=["nodes", "graphs"])
def test_shape_tree_matches_eval_shape(readout):
    rcfg, tcfg = _cfgs(readout)
    for rc, tc in ((rcfg, tcfg), (ref_get_arch("gin-tu").full, get_arch("gin-tu").full)):
        want = {".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): x
                for path, x in jax.tree_util.tree_leaves_with_path(
                    RG.init_params_shape_tree(rc))}
        got = named_leaves(TG.init_params_shape_tree(tc))
        assert list(got) == list(want)
        for k, w in want.items():
            assert tuple(got[k].shape) == tuple(w.shape), k
            assert got[k].dtype == torch.float32 and w.dtype == jnp.float32, k
            assert got[k].device.type == "meta", k


def test_init_params_draws_the_reference_tree():
    cfg = get_arch("gin-tu").smoke
    gen = torch.Generator().manual_seed(0)
    tree = TG.init_params(gen, cfg)
    model = TG.GIN(cfg, tree)
    want = _flat(RG.init_params(jax.random.PRNGKey(0), ref_get_arch("gin-tu").smoke))
    got = param_dict(model)
    assert list(got) == list(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        if k.endswith(("eps", "b1", "b2", "ln_bias", "head_b")):
            assert not got[k].any(), k
        if k.endswith("ln_scale"):
            assert bool((got[k] == 1).all()), k
    # the module wraps the tree's leaves without a copy
    assert got["layers.0.w1"].data_ptr() == tree["layers"][0]["w1"].data_ptr()
    assert tree["layers"][0]["eps"].shape == ()
    # and the tree crosses back to the reference's arrays
    back = convert.gnn_params_to_arrays(model)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, RG.init_params(
            jax.random.PRNGKey(0), ref_get_arch("gin-tu").smoke)))
    for k, x in _flat(back).items():
        assert np.array_equal(x, got[k].detach().numpy()), k


def test_tree_from_arrays_checks_the_shapes():
    rcfg, tcfg = _cfgs(False)
    arrays = jax.tree_util.tree_map(
        np.asarray, RG.init_params(jax.random.PRNGKey(0), rcfg))
    with pytest.raises(ValueError, match="does not fit"):
        convert.gnn_tree_from_arrays(arrays, dataclasses.replace(tcfg, d_hidden=9), "cpu")
    with pytest.raises(ValueError, match="does not fit"):
        convert.gnn_tree_from_arrays(arrays, dataclasses.replace(tcfg, n_layers=3), "cpu")


@pytest.mark.parametrize("readout", [False, True], ids=["nodes", "graphs"])
def test_forward_loss_and_gradients_match(readout):
    rcfg, tcfg = _cfgs(readout)
    params, model = _carry(rcfg, tcfg)
    b, tb = _batch(rcfg)
    kw = ({"graph_ids": b["graph_ids"], "n_graphs": b["labels"].shape[0]}
          if readout else {})
    want = RG.forward(params, b["feats"], b["edges"], b["edge_mask"], rcfg, **kw)
    tkw = ({"graph_ids": tb["graph_ids"], "n_graphs": tb["labels"].shape[0]}
           if readout else {})
    got = TG.forward(model, tb["feats"], tb["edges"], tb["edge_mask"], tcfg, **tkw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    loss_r, grads_r = jax.value_and_grad(RG.loss_fn)(params, b, rcfg)
    loss_t = TG.loss_fn(model, tb, tcfg)
    np.testing.assert_allclose(loss_t.item(), float(loss_r), rtol=1e-6)
    named = param_dict(model)
    grads_t = dict(zip(named, torch.autograd.grad(loss_t, list(named.values()))))
    want_g = _flat(grads_r)
    assert list(grads_t) == list(want_g)
    for k, w in want_g.items():
        np.testing.assert_allclose(grads_t[k].numpy(), w, atol=1e-5, rtol=1e-4,
                                   err_msg=k)
    # the mesh-free dst-sharded loss is the loss
    assert TG.loss_fn_dst_sharded(model, tb, tcfg).item() == loss_t.item()


def test_masked_edges_carry_no_message():
    """A padded edge points at node 0 and adds nothing; a label mask of
    zeros gives a zero loss (the denominator is at least 1)."""
    _, tcfg = _cfgs(False)
    _, model = _carry(*_cfgs(False))
    _, tb = _batch(tcfg)
    base = TG.forward(model, tb["feats"], tb["edges"], tb["edge_mask"], tcfg)
    pad = {k: v.clone() for k, v in tb.items()}
    pad["edges"] = torch.cat([pad["edges"], torch.zeros((2, 37), dtype=torch.int32)], 1)
    pad["edges"][0, -37:] = 5
    pad["edge_mask"] = torch.cat([pad["edge_mask"], torch.zeros(37, dtype=torch.bool)])
    got = TG.forward(model, pad["feats"], pad["edges"], pad["edge_mask"], tcfg)
    assert torch.equal(got, base)
    pad["label_mask"] = torch.zeros_like(pad["label_mask"])
    assert TG.loss_fn(model, pad, tcfg).item() == 0.0


@pytest.mark.parametrize("readout", [False, True], ids=["nodes", "graphs"])
def test_train_step_matches_the_jitted_jax_step(readout):
    rcfg, tcfg = _cfgs(readout)
    params, model = _carry(rcfg, tcfg, seed=1)
    rstep = jax.jit(ref_make_train_step(RG.loss_fn, rcfg))
    ropt = radamw.adamw_init(params)
    tstep, topt = make_train_step(TG.loss_fn, tcfg), adamw_init(param_dict(model))
    for s in range(2):
        b, tb = _batch(rcfg, seed=10 + s)
        params, ropt, rm = rstep(params, ropt, b)
        _, topt, tm = tstep(model, topt, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(rm["grad_norm"]),
                                   rtol=1e-5)
    assert topt["count"] == int(ropt["count"]) == 2
    _assert_params_close(model, params, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("n_nodes,n_shards", [(64, 4), (60, 8), (10, 1), (9, 4)])
def test_group_edges_by_dst_shard_matches(n_nodes, n_shards):
    rng = np.random.default_rng(n_nodes + n_shards)
    edges = rng.integers(0, n_nodes, (2, 300)).astype(np.int32)
    got = TG.group_edges_by_dst_shard(edges, n_nodes, n_shards)
    want = RG.group_edges_by_dst_shard(edges, n_nodes, n_shards)
    assert got[2] == want[2]
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    # every real edge lands in its dst's shard
    n_loc = n_nodes // n_shards
    for s in range(n_shards):
        sl = slice(s * got[2], (s + 1) * got[2])
        dst = got[0][1, sl][got[1][sl]]
        assert (np.minimum(dst // n_loc, n_shards - 1) == s).all()


def test_mesh_names_wait_for_the_several_device_slice(tmp_path):
    """The mesh names, which raised until the several-device slice: the
    specs equal the reference's; on a 1-rank mesh the dst-sharded loss and
    its gradients equal ``loss_fn``'s (and the reference's), from edges
    grouped by ``group_edges_by_dst_shard``; without a mesh it is
    ``loss_fn``; an abstract mesh cannot run it."""
    from jax.sharding import PartitionSpec as JP
    from test_torch_mesh import _norm, one_rank_mesh

    from repro_torch.launch.mesh import Mesh, set_mesh

    rcfg, tcfg = _cfgs(False)
    params, model = _carry(rcfg, tcfg)
    assert _norm(TG.param_specs(tcfg)) == _norm(RG.param_specs(rcfg))
    assert _norm(TG.batch_specs(tcfg)) == _norm(RG.batch_specs(rcfg))
    assert _norm(TG.batch_specs_sharded(tcfg)) == _norm(RG.batch_specs_sharded(rcfg))
    assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in TG.input_specs(
        tcfg, 8, 16).items()} == {k: (v.shape, str(v.dtype)) for k, v in
                                  RG.input_specs(rcfg, 8, 16).items()}
    assert _norm(RG.batch_specs(rcfg))["feats"] == _norm(JP())
    rb, tb = _batch(tcfg)
    # every edge real, as in the reference's test: the grouping's mask
    # marks the grouped edges, not the batch's padding
    rb["edge_mask"][:] = True
    tb["edge_mask"] = torch.from_numpy(rb["edge_mask"])
    ge, gmask, _ = TG.group_edges_by_dst_shard(rb["edges"], rb["feats"].shape[0], 1)
    sb = dict(tb, edges=torch.from_numpy(ge), edge_mask=torch.from_numpy(gmask))
    named = param_dict(model)
    want = TG.loss_fn(model, tb, tcfg)
    gwant = torch.autograd.grad(want, list(named.values()))
    ref = float(RG.loss_fn(params, jax.tree_util.tree_map(jnp.asarray, rb), rcfg))
    assert float(TG.loss_fn_dst_sharded(model, tb, tcfg).detach()) == float(want.detach())
    with one_rank_mesh(tmp_path) as mesh:
        got = TG.loss_fn_dst_sharded(model, sb, tcfg, mesh=mesh)
        ggot = torch.autograd.grad(got, list(named.values()))
        with set_mesh(mesh), torch.no_grad():
            logits = TG.forward_dst_sharded(model, sb["feats"], sb["edges"],
                                            sb["edge_mask"], tcfg, ("data", "model"), 1)
            plain = TG.forward(model, tb["feats"], tb["edges"], tb["edge_mask"], tcfg)
    np.testing.assert_allclose(logits.numpy(), plain.numpy(), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(float(got), ref, rtol=1e-6)
    for k, a, b in zip(named, ggot, gwant):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-4, err_msg=k)
    with pytest.raises(ValueError, match="abstract"):
        TG.loss_fn_dst_sharded(model, sb, tcfg, mesh=Mesh((1, 1), ("data", "model")))


def test_backward_keeps_no_message_tensor():
    """The loss's autograd graph holds no ``[E, d]`` tensor: the messages
    are rebuilt from the ids in the backward (at ogb_products' 61.86 M
    edges one layer's messages are 15.8 GB)."""
    _, tcfg = _cfgs(False)
    _, model = _carry(*_cfgs(False))
    _, tb = _batch(tcfg, n=32, e=4_000)
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = TG.loss_fn(model, tb, tcfg)
    assert saved and max(math.prod(s) for s in saved) < 4_000 * 2
    named = param_dict(model)
    assert all(g is not None for g in torch.autograd.grad(loss, list(named.values())))


def test_init_model_is_seeded_and_needs_a_card_unless_told_cpu(monkeypatch):
    cfg = get_arch("gin-tu").smoke
    a = param_dict(TG.init_model(cfg, 3, "cpu"))
    b = param_dict(TG.GIN(cfg, TG.init_params(torch.Generator().manual_seed(3), cfg)))
    assert all(torch.equal(a[k], b[k]) for k in b)
    assert not torch.equal(a["head"], param_dict(TG.init_model(cfg, 4, "cpu"))["head"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TG.init_model(cfg)
