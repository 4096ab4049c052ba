"""The port's mesh paths over 8 ``gloo`` ranks against the reference's
8-device ``shard_map`` (``test_sharded_paths.py``'s and
``test_compress.py``'s cases).

The test process draws every input with numpy from a seed and writes it
to ``tmp_path``; two subprocesses then run side by side:

* the reference, with ``--xla_force_host_platform_device_count=8``
  (device count is process-global): the shard-map MoE (EP on (4, 2) with
  E = 4, TP-in-expert on (2, 4) with E = 2), the dst-sharded GIN on
  (4, 2), the routed gather and update on (4, 2) -- also on skewed ids at
  ``slack=0.5``, so that buckets overflow -- and 30 steps of
  ``compressed_psum`` over a 4-device data axis;
* the port: 8 ranks of a ``gloo`` group (a ``FileStore`` under
  ``tmp_path``, a 60 s timeout) running the same cases on
  ``make_host_mesh`` meshes, plus the routed sparse DCN-v2 step with
  ``mesh=`` (each rank holding its block of the table, ``shard_rows``)
  against ``mesh=None``; and small cells of ``build_cell`` (LM, GNN and
  recsys steps) run on DTensors placed by their in-shardings, as the dry
  run places them, against the same steps on plain tensors.  Every rank
  writes what it got.

Bounds (the reference tests'): MoE hidden states 1e-4; GIN loss 1e-5 and
gradients 1e-4; the routed gather bit-equal, the table and accumulator
1e-5, the dropped count equal; ``compressed_psum``'s output bit-equal at
each step (its residual: see that test); every rank's results equal to
rank 0's bit for bit.  The reference's steps are jitted (its eager
``shard_map`` compiles every primitive: ~2 minutes).
"""

import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro_torch.models import gnn as TG
from repro_torch.models import transformer as TT
from repro_torch.models.common import flatten

ROOT = pathlib.Path(__file__).parent.parent
RANKS = 8
TIMEOUT_S = 240

MOE = {"ep": (4, 4, 2), "tp": (2, 2, 4)}  # case: (E, data, model)
LM = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_head=8, d_ff=64,
          vocab=96, top_k=2, attn_chunk=10**6, loss_chunk=10**6)
GIN = dict(n_layers=3, d_in=12, d_hidden=16, n_classes=5)
N_NODES, N_EDGES, R_ROWS, R_D, R_N = 64, 300, 1024, 16, 256


def _params(shapes: dict, rng) -> dict:
    out = {}
    for k in sorted(shapes):
        s = shapes[k]
        fan = s[-2] if len(s) >= 2 else (s[-1] if s else 1)
        out[k] = (rng.normal(size=s) / np.sqrt(fan)).astype(np.float32)
    return out


def _inputs(path: pathlib.Path) -> None:
    rng = np.random.default_rng(0)
    arrays = {}
    for case, (E, data, model) in MOE.items():
        cfg = TT.TransformerConfig(n_experts=E, **LM)
        for k, v in _params(TT.param_shapes(cfg), rng).items():
            arrays[f"moe_{case}/p/{k}"] = v
        arrays[f"moe_{case}/tok"] = rng.integers(0, 96, (data * 2, 16)).astype(np.int32)
    gcfg = TG.GINConfig(**GIN)
    shapes = {k: tuple(v.shape) for k, v in flatten(TG.init_params_shape_tree(gcfg)).items()}
    for k, v in _params(shapes, rng).items():
        arrays[f"gin/p/{k}"] = v
    edges = rng.integers(0, N_NODES, (2, N_EDGES)).astype(np.int32)
    ge, gmask, _ = TG.group_edges_by_dst_shard(edges, N_NODES, RANKS)
    arrays.update({"gin/feats": rng.normal(size=(N_NODES, 12)).astype(np.float32),
                   "gin/edges": edges, "gin/gedges": ge, "gin/gmask": gmask,
                   "gin/labels": rng.integers(0, 5, N_NODES).astype(np.int32),
                   "gin/lmask": rng.random(N_NODES) < 0.5})
    arrays["routed/table"] = rng.normal(size=(R_ROWS, R_D)).astype(np.float32)
    arrays["routed/ids"] = rng.integers(0, R_ROWS, R_N).astype(np.int32)
    # skewed: 3 ids in 4 owned by shard 0 (rows 0..127)
    skew = np.where(rng.random(R_N) < 0.75, rng.integers(0, 128, R_N),
                    rng.integers(0, R_ROWS, R_N))
    arrays["routed/skew_ids"] = skew.astype(np.int32)
    arrays["routed/g"] = rng.normal(size=(R_N, R_D)).astype(np.float32)
    arrays["compress/g"] = rng.normal(size=(64, 64)).astype(np.float32)
    np.savez(path / "inputs.npz", **arrays)


_REFERENCE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import sys, dataclasses
sys.path.insert(0, "src")
import repro  # installs jax version-compat backfills (repro.compat)
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.models import transformer as T, gnn as G
from repro.launch.cells import routed_table_gather, routed_table_update
from repro.optim.compress import compressed_psum, ef_init
from repro_torch.models.common import unflatten

out_dir = sys.argv[1]
inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
MOE, LM, GIN = {moe}, {lm}, {gin}


def sub(prefix):
    return unflatten({{k[len(prefix):]: jnp.asarray(v) for k, v in inp.items()
                      if k.startswith(prefix)}})


def mesh(d, m):
    return jax.make_mesh((d, m), ("data", "model"), axis_types=(AxisType.Auto,) * 2)


res = {{}}
for case, (E, data, model) in MOE.items():
    cfg = T.TransformerConfig(n_experts=E, compute_dtype=jnp.float32,
                              moe_shard_map=True, **LM)
    params = sub(f"moe_{{case}}/p/")
    tok = jnp.asarray(inp[f"moe_{{case}}/tok"])
    with jax.set_mesh(mesh(data, model)):
        h, aux = jax.jit(lambda p: T.forward(p, tok, cfg),
                         in_shardings=(T.param_specs(cfg, tp=model),))(params)
    res[f"moe_{{case}}/h"], res[f"moe_{{case}}/aux"] = np.asarray(h), np.asarray(aux)

cfg = G.GINConfig(**GIN)
params = sub("gin/p/")
batch = {{"feats": jnp.asarray(inp["gin/feats"]), "edges": jnp.asarray(inp["gin/gedges"]),
          "edge_mask": jnp.asarray(inp["gin/gmask"]),
          "labels": jnp.asarray(inp["gin/labels"]),
          "label_mask": jnp.asarray(inp["gin/lmask"])}}
with jax.set_mesh(mesh(4, 2)):
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: G.loss_fn_dst_sharded(p, batch, cfg)))(params)
res["gin/loss"] = np.asarray(loss)
for k, v in jax.tree_util.tree_flatten_with_path(grads)[0]:
    res["gin/g/" + ".".join(str(getattr(e, "key", getattr(e, "idx", e))) for e in k)] = np.asarray(v)

table = jnp.asarray(inp["routed/table"])
g = jnp.asarray(inp["routed/g"])
m = mesh(4, 2)
for name, slack in (("ids", 4.0), ("skew_ids", 0.5)):
    ids = jnp.asarray(inp["routed/" + name])
    with jax.set_mesh(m):
        emb = jax.jit(lambda t, i: routed_table_gather(
            t, i, m, ("model", "data"), ("data", "model"), slack=slack))(table, ids)
        t2, a2, dropped = jax.jit(lambda t, a, i, gg: routed_table_update(
            t, a, i, gg, 0.1, m, ("model", "data"), ("data", "model"),
            slack=slack))(table, jnp.zeros(table.shape[0]), ids, g)
    for k, v in (("emb", emb), ("table", t2), ("acc", a2), ("dropped", dropped)):
        res[f"routed/{{name}}/{{k}}"] = np.asarray(v)

m4 = jax.make_mesh((4,), ("data",), axis_types=(AxisType.Auto,))
gt = jnp.asarray(inp["compress/g"])
outs = []
with jax.set_mesh(m4):
    ef = ef_init({{"g": gt}})
    step = jax.jit(lambda g, e: compressed_psum(g, e, m4, ("data",)))
    for _ in range(30):
        o, ef = step({{"g": gt}}, ef)
        outs.append(np.asarray(o["g"]))
res["compress/out"] = np.stack(outs)
res["compress/ef"] = np.asarray(ef["g"])
np.savez(os.path.join(out_dir, "reference.npz"), **res)
print("reference done")
"""


_PORT = """
import os, sys, datetime, dataclasses
sys.path.insert(0, "src")
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

MOE, LM, GIN = {moe}, {lm}, {gin}


def rank_main(rank, world, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(out_dir, "store"),
                                                         world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    from repro_torch import convert
    from repro_torch.configs import get_arch
    from repro_torch.data.recsys_data import make_ctr_batch
    from repro_torch.launch import mesh as M
    from repro_torch.launch.cells import (gather_rows, make_sparse_recsys_train_step,
                                          routed_table_gather, routed_table_update,
                                          shard_rows, sparse_opt_init)
    from repro_torch.models import gnn as G, recsys as R, transformer as T
    from repro_torch.models.common import flatten, param_dict, unflatten
    from repro_torch.optim.compress import compressed_psum, ef_init

    inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))

    def sub(prefix):
        return unflatten({{k[len(prefix):]: v for k, v in inp.items()
                          if k.startswith(prefix)}})

    t = lambda k: torch.from_numpy(inp[k])
    meshes = {{(4, 2): M.make_host_mesh(4, 2), (2, 4): M.make_host_mesh(2, 4)}}
    res = {{}}
    for case, (E, data, model) in MOE.items():
        cfg = T.TransformerConfig(n_experts=E, compute_dtype=torch.float32,
                                  moe_shard_map=True, **LM)
        lm = T.Transformer(cfg, convert.lm_tree_from_arrays(sub(f"moe_{{case}}/p/"),
                                                            cfg, "cpu"))
        with torch.no_grad(), M.set_mesh(meshes[(data, model)]):
            h, aux = T.forward(lm, t(f"moe_{{case}}/tok").long(), cfg)
        res[f"moe_{{case}}/h"], res[f"moe_{{case}}/aux"] = h.numpy(), aux.numpy()

    cfg = G.GINConfig(**GIN)
    gin = G.GIN(cfg, convert.gnn_tree_from_arrays(sub("gin/p/"), cfg, "cpu"))
    batch = {{"feats": t("gin/feats"), "edges": t("gin/gedges"),
              "edge_mask": t("gin/gmask"), "labels": t("gin/labels"),
              "label_mask": t("gin/lmask")}}
    loss = G.loss_fn_dst_sharded(gin, batch, cfg, mesh=meshes[(4, 2)])
    named = param_dict(gin)
    grads = torch.autograd.grad(loss, list(named.values()))
    res["gin/loss"] = loss.detach().numpy()
    for k, g in zip(named, grads):
        res["gin/g/" + k] = g.numpy()

    m = meshes[(4, 2)]
    for name, slack in (("ids", 4.0), ("skew_ids", 0.5)):
        ids = t("routed/" + name).long()
        emb = routed_table_gather(t("routed/table"), ids, m, ("model", "data"),
                                  ("data", "model"), slack=slack)
        t2, a2, dropped = routed_table_update(
            t("routed/table"), torch.zeros(t("routed/table").shape[0]), ids,
            t("routed/g"), 0.1, m, ("model", "data"), ("data", "model"), slack=slack)
        for k, v in (("emb", emb), ("table", t2), ("acc", a2), ("dropped", dropped)):
            res[f"routed/{{name}}/{{k}}"] = v.numpy()

    gt = {{"g": t("compress/g")}}
    ef, outs = ef_init(gt), []
    for _ in range(30):
        o, ef = compressed_psum(gt, ef, m, ("data",))
        outs.append(o["g"].numpy())
    res["compress/out"] = np.stack(outs)
    res["compress/ef"] = ef["g"].numpy()

    # the routed sparse DCN-v2 step against the local one, from one init
    scfg = get_arch("dcn-v2").smoke
    init = convert.recsys_params_to_arrays(R.init_model(scfg, 0, "cpu"))
    # (the routed step keeps each rank's block of the table and accumulator)
    taxes = ("model", "data")
    for tag, kw in (("local", {{}}), ("routed", dict(
            mesh=m, table_axes=taxes, batch_axes=("data", "model")))):
        model = convert.recsys_params_from_arrays(init, scfg, "cpu")
        if tag == "routed":
            shard_rows(model, m, taxes)
        opt = sparse_opt_init(model)
        step = make_sparse_recsys_train_step(scfg, **kw)
        for s in range(3):
            b = make_ctr_batch(np.random.default_rng(s), scfg, 64)
            _, _, met = step(model, opt, {{k: torch.from_numpy(v) for k, v in b.items()}})
            res[f"sparse/{{tag}}/loss{{s}}"] = met["loss"].numpy()
        acc = opt["table_acc"]
        if tag == "routed":
            res["sparse/routed/dropped"] = met["dropped"].numpy()
            res["sparse/routed/block_rows"] = np.array([model.table.shape[0], acc.shape[0]])
            model.table.data = gather_rows(model.table.detach(), m, taxes)
            acc = gather_rows(acc, m, taxes)
        for k, v in param_dict(model).items():
            res[f"sparse/{{tag}}/p/{{k}}"] = v.detach().numpy()
        res[f"sparse/{{tag}}/acc"] = acc.numpy()
    dtensor_cells(meshes, res)
    np.savez(os.path.join(out_dir, f"port_rank{{rank}}.npz"), **res)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(rank_main, ({ranks}, sys.argv[1]), nprocs={ranks})
    print("port done")
"""


_DTENSOR = """
import copy, dataclasses
import numpy as np
import torch


def dtensor_cells(meshes, res):
    \"\"\"Small cells of ``build_cell``, each step run twice on the same
    inputs: on plain tensors under ``set_mesh`` (the mesh paths the card
    runs) and on DTensors placed by the cell's in-shardings (the dry run's
    branches), every output leaf written as ``dt/<cell>/<form>/<leaf>``.\"\"\"
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import ShapeSpec, get_arch
    from repro_torch.data.recsys_data import make_ctr_batch
    from repro_torch.launch import mesh as M
    from repro_torch.launch.cells import (_tree_step, build_cell,
                                          make_sparse_recsys_train_step)
    from repro_torch.models import gnn as G, recsys as R, transformer as T
    from repro_torch.models.common import tree_map

    rng = np.random.default_rng(1)
    gen = torch.Generator().manual_seed(1)

    def place(tree, specs, mesh):
        def one(t, spec):
            if not isinstance(t, torch.Tensor):
                return t
            return distribute_tensor(t.clone(), mesh.device_mesh, M.spec_to_placements(
                spec if spec is not None else M.P(), mesh, t.ndim))
        return M._tree_map(one, tree, specs)

    def leaves(tree, prefix, out):
        if isinstance(tree, dict):
            for k, v in tree.items():
                leaves(v, f"{prefix}/{k}", out)
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                leaves(v, f"{prefix}/{i}", out)
        elif isinstance(tree, torch.Tensor):
            if M.is_dtensor(tree):
                tree = tree.full_tensor()  # collective: every rank
            out[prefix] = tree.detach().float().numpy()
        elif isinstance(tree, (int, float)):
            out[prefix] = np.asarray(float(tree))

    def zeros_opt(params):
        return {"m": tree_map(torch.zeros_like, params),
                "v": tree_map(torch.zeros_like, params), "count": 0}

    def both(name, cell, args, mesh, plain_fn=None):
        with M.set_mesh(mesh):
            plain = (plain_fn or cell.fn)(*copy.deepcopy(args))
        placed = tuple(place(a, s, mesh) for a, s in zip(args, cell.in_shardings))
        with M.set_mesh(mesh), implicit_replication():
            out = cell.fn(*placed)
        leaves({"out": plain}, f"dt/{name}/plain", res)
        leaves({"out": out}, f"dt/{name}/dtensor", res)

    def small(arch, **kw):
        b = get_arch(arch)
        cfg = b.smoke if b.family != "lm" else dataclasses.replace(
            b.smoke, compute_dtype=torch.float32, **kw)
        return dataclasses.replace(b, full=cfg), cfg

    def ints(hi, shape):
        return torch.from_numpy(rng.integers(0, hi, shape).astype(np.int32))

    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    m42, m24 = meshes[(4, 2)], meshes[(2, 4)]
    # the LM: train (lookups, attention and the CE's vocabulary gather, and
    # their backward), prefill and decode; MoE with EP and TP-in-expert
    for name, arch, kw, mesh in (("qwen3_train", "qwen3-0.6b", {}, m42),
                                 ("moonshot_train", "moonshot-v1-16b-a3b", {}, m42),
                                 ("mixtral_tp_train", "mixtral-8x22b",
                                  {"n_experts": 2}, m24)):
        b, cfg = small(arch, **kw)
        cell = build_cell(b, ShapeSpec("t", "train", seq_len=32, batch=8), mesh, "single")
        params = T.init_params(gen, cfg)
        batch = {"tokens": ints(cfg.vocab, (8, 32)), "labels": ints(cfg.vocab, (8, 32))}
        both(name, cell, (params, zeros_opt(params), batch), mesh)
    b, cfg = small("qwen3-0.6b")
    cell = build_cell(b, ShapeSpec("p", "prefill", seq_len=32, batch=4), m42, "single")
    both("qwen3_prefill", cell, (T.init_params(gen, cfg), ints(cfg.vocab, (4, 32))), m42)
    for name, mesh in (("qwen3_decode", m42), ("qwen3_decode_split_k", m24)):
        cell = build_cell(b, ShapeSpec("d", "decode", seq_len=32, batch=4), mesh, "single")
        cache = normal(*cell.args[1].shape)
        both(name, cell, (T.init_params(gen, cfg), cache, ints(cfg.vocab, (4,)),
                          cell.args[3]), mesh)
    # one token against a cache sharded over the sequence on every axis
    # (kv heads that do not split over `model`): split-K attention and the
    # one-token MoE (TP-in-expert) in local regions
    b, cfg = small("mixtral-8x22b", n_experts=2)
    cell = build_cell(b, ShapeSpec("d1", "decode", seq_len=32, batch=1), m24, "single")
    assert cell.meta["cache_spec"] == str(M.P(None, None, None, ("data", "model"), None,
                                              None))
    both("mixtral_one_token_decode", cell,
         (T.init_params(gen, cfg), normal(*cell.args[1].shape), ints(cfg.vocab, (1,)),
          cell.args[3]), m24)
    # a decode step's MoE: too few tokens for expert parallelism, so the
    # experts' weights move from their expert split to the ff split of
    # TP-in-expert (an all-to-all)
    b, cfg = small("moonshot-v1-16b-a3b")
    cell = build_cell(b, ShapeSpec("d", "decode", seq_len=32, batch=16), m42, "single")
    both("moonshot_decode", cell, (T.init_params(gen, cfg), normal(*cell.args[1].shape),
                                   ints(cfg.vocab, (16,)), cell.args[3]), m42)
    # the GNN: dst-sharded full batch (bf16 messages) and molecule readout
    b, gcfg = small("gin-tu")
    N, E = 64, 256
    cell = build_cell(b, ShapeSpec("f", "fullbatch", n_nodes=N, n_edges=E, d_feat=12),
                      m42, "single")
    params = G.init_params(gen, dataclasses.replace(gcfg, d_in=12))
    ge, gm, _ = G.group_edges_by_dst_shard(rng.integers(0, N, (2, E)).astype(np.int32),
                                           N, 8)
    batch = {"feats": normal(N, 12), "edges": torch.from_numpy(ge),
             "edge_mask": torch.from_numpy(gm), "labels": ints(gcfg.n_classes, (N,)),
             "label_mask": torch.from_numpy(rng.random(N) < 0.5)}
    both("gin_fullbatch", cell, (params, zeros_opt(params), batch), m42)
    ng, nn, ne = 8, 6, 12
    cell = build_cell(b, ShapeSpec("m", "molecule", n_nodes=nn, n_edges=ne, batch=ng,
                                   d_feat=10), m42, "single")
    params = G.init_params(gen, dataclasses.replace(gcfg, d_in=10, n_classes=2,
                                                    graph_readout=True))
    base = np.repeat(np.arange(ng) * nn, ne)
    batch = {"feats": normal(ng * nn, 10),
             "edges": torch.from_numpy(np.stack([rng.integers(0, nn, ng * ne) + base,
                                                 rng.integers(0, nn, ng * ne) + base]
                                                ).astype(np.int32)),
             "edge_mask": torch.from_numpy(rng.random(ng * ne) < 0.9),
             "graph_ids": torch.from_numpy(np.repeat(np.arange(ng), nn).astype(np.int32)),
             "labels": ints(2, (ng,))}
    both("gin_molecule", cell, (params, zeros_opt(params), batch), m42)
    # recsys: the row-sharded lookups of serving, and the routed sparse step
    # (its plain form: the local step, as the routed one keeps row blocks)
    for arch in ("dcn-v2", "din", "bst"):
        b, rcfg = small(arch)
        cell = build_cell(b, ShapeSpec("s", "serve", batch=16), m42, "single")
        if rcfg.kind == "dcn":
            batch = {"dense": normal(16, rcfg.n_dense),
                     "sparse": ints(rcfg.rows_per_field, (16, rcfg.n_sparse))}
        else:
            batch = {"history": ints(rcfg.item_vocab, (16, rcfg.seq_len)),
                     "hist_mask": torch.from_numpy(rng.random((16, rcfg.seq_len)) < 0.8),
                     "target": ints(rcfg.item_vocab, (16,))}
        both(f"{arch.replace('-', '_')}_serve", cell, (R.init_params(gen, rcfg), batch),
             m42)
    # retrieval: one user against candidates sharded over the data axes
    for arch in ("dcn-v2", "din", "bst"):
        b, rcfg = small(arch)
        cell = build_cell(b, ShapeSpec("r", "retrieval", batch=1, n_candidates=64), m42,
                          "single")
        if rcfg.kind == "dcn":
            batch = {"candidates": ints(rcfg.rows_per_field, (64,)),
                     "dense": normal(1, rcfg.n_dense),
                     "sparse": ints(rcfg.rows_per_field, (1, rcfg.n_sparse))}
        else:
            batch = {"candidates": ints(rcfg.item_vocab, (64,)),
                     "history": ints(rcfg.item_vocab, (1, rcfg.seq_len)),
                     "hist_mask": torch.from_numpy(rng.random((1, rcfg.seq_len)) < 0.8)}
        both(f"{arch.replace('-', '_')}_retrieval", cell, (R.init_params(gen, rcfg), batch),
             m42)
    b, rcfg = small("dcn-v2")
    cell = build_cell(b, ShapeSpec("t", "train", batch=64), m42, "single")
    params = R.init_params(gen, rcfg)
    opt = {"mlp": zeros_opt({k: v for k, v in params.items() if k != "table"}),
           "table_acc": torch.zeros(rcfg.table_rows)}
    batch = {k: torch.from_numpy(v) for k, v in
             make_ctr_batch(np.random.default_rng(1), rcfg, 64).items()}
    local = _tree_step(lambda p: R.Recsys(rcfg, p), make_sparse_recsys_train_step(rcfg))

    def local_step(*a):
        p, o, met = local(*a)
        return p, o, {**met, "dropped": torch.zeros((), dtype=torch.int64)}

    both("dcn_v2_routed_train", cell, (params, opt, batch), m42, plain_fn=local_step)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh_paths")
    _inputs(path)
    fmt = dict(moe=repr(MOE), lm=repr(LM), gin=repr(GIN), ranks=RANKS)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    port_py = path / "port_ranks.py"
    port_py.write_text(textwrap.dedent(_PORT.format(**fmt)) + textwrap.dedent(_DTENSOR))
    procs = {
        "reference": subprocess.Popen(
            [sys.executable, "-c", _REFERENCE.format(**fmt), str(path)], cwd=ROOT,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
        "port": subprocess.Popen(
            [sys.executable, str(port_py), str(path)], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
    }
    for name, p in procs.items():
        try:
            _, err = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs.values():
                q.kill()
            pytest.fail(f"the {name} run took over {TIMEOUT_S} s")
        assert p.returncode == 0, f"{name}: {err[-3000:]}"
    ref = dict(np.load(path / "reference.npz"))
    ranks = [dict(np.load(path / f"port_rank{r}.npz")) for r in range(RANKS)]
    return ref, ranks, dict(np.load(path / "inputs.npz"))


def test_every_rank_gets_the_same_results(runs):
    _, ranks, _ = runs
    for r in ranks[1:]:
        assert r.keys() == ranks[0].keys()
        for k, v in ranks[0].items():
            np.testing.assert_array_equal(r[k], v, err_msg=k)


@pytest.mark.parametrize("case", sorted(MOE))
def test_shard_map_moe_matches_the_reference(runs, case):
    ref, ranks, _ = runs
    dh = float(np.abs(ranks[0][f"moe_{case}/h"] - ref[f"moe_{case}/h"]).max())
    assert dh < 1e-4, dh
    np.testing.assert_allclose(ranks[0][f"moe_{case}/aux"], ref[f"moe_{case}/aux"],
                               rtol=1e-5)


def test_dst_sharded_gin_matches_the_reference(runs):
    ref, ranks, _ = runs
    assert abs(float(ranks[0]["gin/loss"]) - float(ref["gin/loss"])) < 1e-5
    keys = sorted(k for k in ref if k.startswith("gin/g/"))
    assert keys == sorted(k for k in ranks[0] if k.startswith("gin/g/"))
    dmax = max(float(np.abs(ranks[0][k] - ref[k]).max()) for k in keys)
    assert dmax < 1e-4, dmax


@pytest.mark.parametrize("ids", ["ids", "skew_ids"])
def test_routed_gather_and_update_match_the_reference(runs, ids):
    ref, ranks, _ = runs
    got = {k: ranks[0][f"routed/{ids}/{k}"] for k in ("emb", "table", "acc", "dropped")}
    want = {k: ref[f"routed/{ids}/{k}"] for k in got}
    np.testing.assert_array_equal(got["emb"], want["emb"])
    np.testing.assert_allclose(got["table"], want["table"], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["acc"], want["acc"], atol=1e-5, rtol=0)
    assert int(got["dropped"]) == int(want["dropped"])
    if ids == "ids":
        assert int(got["dropped"]) == 0
    else:
        # the buckets overflowed: dropped ids read zero rows
        assert int(got["dropped"]) > 0
        assert int((np.abs(got["emb"]).sum(1) == 0).sum()) >= int(got["dropped"])


def test_compressed_psum_is_bit_equal_to_the_reference(runs):
    ref, ranks, inp = runs
    for step in range(30):
        np.testing.assert_array_equal(ranks[0]["compress/out"][step],
                                      ref["compress/out"][step], err_msg=str(step))
    # the residual x - q * scale: the jitted reference contracts it into a
    # fused multiply-add (XLA:CPU; its eager run does not), so it is held
    # to the reference within 1e-5 and bit for bit to numpy's unfused
    # arithmetic of the same 30 steps
    np.testing.assert_allclose(ranks[0]["compress/ef"], ref["compress/ef"], atol=1e-5,
                               rtol=0)
    g = inp["compress/g"]
    e = np.zeros_like(g)
    for _ in range(30):
        x = g + e
        scale = np.float32(max(np.abs(x).max(), np.float32(1e-12)) / np.float32(127.0))
        q = np.clip(np.round(x / scale), -127, 127).astype(np.float32)
        e = x - q * scale
    np.testing.assert_array_equal(ranks[0]["compress/ef"], e)
    # error feedback: the time-averaged output converges to the gradient
    g = inp["compress/g"]
    rel = np.abs(ranks[0]["compress/out"].mean(0) - g).max() / np.abs(g).max()
    assert rel < 0.01, rel


def test_routed_sparse_step_matches_the_local_step(runs):
    _, ranks, _ = runs
    r = ranks[0]
    for s in range(3):
        np.testing.assert_allclose(r[f"sparse/routed/loss{s}"], r[f"sparse/local/loss{s}"],
                                   rtol=1e-6)
    keys = sorted(k[len("sparse/local/p/"):] for k in r if k.startswith("sparse/local/p/"))
    for k in keys:
        np.testing.assert_allclose(r[f"sparse/routed/p/{k}"], r[f"sparse/local/p/{k}"],
                                   atol=1e-5, rtol=0, err_msg=k)
    np.testing.assert_allclose(r["sparse/routed/acc"], r["sparse/local/acc"], atol=1e-5,
                               rtol=0)
    assert int(r["sparse/routed/dropped"]) == 0
    # every rank kept its block of rows only, from step to step
    rows = r["sparse/local/acc"].shape[0]
    assert list(r["sparse/routed/block_rows"]) == [rows // RANKS] * 2
    blocks = [x["sparse/routed/block_rows"] for x in ranks]
    assert all(list(b) == [rows // RANKS] * 2 for b in blocks)


DT_CELLS = ["qwen3_train", "moonshot_train", "mixtral_tp_train", "qwen3_prefill",
            "qwen3_decode", "qwen3_decode_split_k", "gin_fullbatch", "gin_molecule",
            "dcn_v2_serve", "din_serve", "bst_serve", "dcn_v2_routed_train",
            "dcn_v2_retrieval", "din_retrieval", "bst_retrieval",
            "mixtral_one_token_decode", "moonshot_decode"]


@pytest.mark.parametrize("cell", DT_CELLS)
def test_dtensor_branches_match_the_plain_mesh_paths(runs, cell):
    """The dry run's DTensor branches hold values: each small cell's step
    on DTensors placed by its in-shardings equals the same step on plain
    tensors under the mesh (the LM at f32), every output leaf -- updated
    parameters, AdamW moments (the gradients), loss, logits, caches --
    within 1e-5 (the reference tests' bound)."""
    _, ranks, _ = runs
    r = ranks[0]
    plain = {k[len(f"dt/{cell}/plain"):]: v for k, v in r.items()
             if k.startswith(f"dt/{cell}/plain/")}
    got = {k[len(f"dt/{cell}/dtensor"):]: v for k, v in r.items()
           if k.startswith(f"dt/{cell}/dtensor/")}
    assert plain and plain.keys() == got.keys()
    for k in plain:
        assert got[k].shape == plain[k].shape, k
        np.testing.assert_allclose(got[k], plain[k], atol=1e-5, rtol=0, err_msg=k)
