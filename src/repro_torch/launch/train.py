"""End-to-end training driver of the port: the recsys, LM and GNN archs.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      --steps 50 --smoke --device cpu        # reduced config, CPU-runnable
  PYTHONPATH=src python -m repro_torch.launch.train --arch din --smoke \
      --steps 50 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch gin-tu --smoke \
      --steps 6 --save-every 2 --fail-at 3 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch dcn-v2 --steps 100 --smoke

Counterpart of ``repro/launch/train.py``, with its flags and defaults:
the data pipeline (recsys: ``make_ctr_batch`` from ``default_rng(seed +
step)``; LM: ``ShardedBatchLoader.batch_at(step)`` over a ``TokenStream``
with an OptVB-compressed shard index; GNN: a 256-node power-law graph in a
``CompressedGraphStore``, a 2-hop subgraph of 32 seeds sampled a step;
each uploaded once a step), the AdamW train step, checkpoint/restart with
a simulated node failure (``--fail-at``), the straggler watchdog and the
restart statistics.  ``--model-scale`` scales a smoke LM up
(``examples/train_lm.py`` sizes its own ~100M model); ``--batch`` and
``--seq-len`` do not reach the GNN, as in the reference.  Runs on the card
unless ``--device cpu``.

The training state is ``(params, opt)``, a tree of tensors in the
reference's structure: ``params`` the reference's parameter tree, ``opt``
``{"count", "m", "v"}`` with ``m`` and ``v`` trees of the same shape, so
``CheckpointManager`` writes the reference's leaves in the reference's
order and a checkpoint crosses between the packages.  Each step wraps the
state's current leaves in a ``Recsys``, ``Transformer`` or ``GIN`` module
(no copy) and updates them in place: after a restart it trains on the
restored leaves.
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile

import numpy as np
import torch

from ..api import resolve_device
from ..checkpoint import CheckpointManager
from ..checkpoint.manager import tree_map
from ..configs import get_arch
from ..convert import (
    gnn_tree_from_arrays,
    lm_tree_from_arrays,
    recsys_tree_from_arrays,
)
from ..data.graph_data import CompressedGraphStore, make_powerlaw_graph
from ..data.lm_data import ShardedBatchLoader, TokenStream
from ..data.recsys_data import make_ctr_batch
from ..distributed import FaultTolerantRunner, SimulatedFailure
from ..models import gnn as G
from ..models import recsys as R
from ..models import transformer as T
from ..models.common import tree_size
from .cells import make_train_step


def named_leaves(tree, prefix: str = "") -> dict:
    """A tree's leaves by dotted name (``mlp.0.w``), in the order jax
    flattens it: dict keys sorted, list items in order."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(named_leaves(tree[k], f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, x in enumerate(tree):
            out.update(named_leaves(x, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


def adamw_tree_init(tree: dict) -> dict:
    """AdamW's state in the reference's structure: ``{"count": 0, "m":
    zeros like tree, "v": zeros like tree}``."""
    return {"count": 0, "m": tree_map(torch.zeros_like, tree),
            "v": tree_map(torch.zeros_like, tree)}


def _recsys_setup(cfg, batch: int, seed: int, device, params=None):
    """(parameter tree, loss, batches): the tree from
    ``torch.Generator(device).manual_seed(seed)``, or from the reference's
    tree of arrays ``params``; ``batches(step)`` draws ``make_ctr_batch``
    from ``default_rng(seed + step)`` and uploads it."""
    if params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        tree = R.init_params(gen, cfg)
    else:
        tree = recsys_tree_from_arrays(params, cfg, device)

    def batches(step):
        return _upload(make_ctr_batch(np.random.default_rng(seed + step), cfg,
                                      batch), device)

    return tree, R.loss_fn, batches


def _upload(b: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def _lm_setup(cfg, batch: int, seq_len: int, seed: int, device, params=None):
    """(parameter tree, loss, batches): the tree from
    ``torch.Generator(device).manual_seed(seed)``, or from the reference's
    tree of arrays ``params``; ``batches(step)`` is the loader's
    ``batch_at(step)`` over a ``seq_len * batch * 64 + 1``-token stream
    (both seeded by ``seed``), uploaded."""
    stream = TokenStream(cfg.vocab, length=seq_len * batch * 64 + 1, seed=seed)
    loader = ShardedBatchLoader(stream, batch, seq_len, seed=seed)
    if params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        tree = T.init_params(gen, cfg)
    else:
        tree = lm_tree_from_arrays(params, cfg, device)

    def batches(step):
        return _upload(loader.batch_at(step), device)

    return tree, T.loss_fn, batches


def _gnn_setup(cfg, seed: int, device, params=None):
    """(parameter tree, loss, batches), as the reference's: a 256-node
    power-law graph (average degree 6) in a ``CompressedGraphStore`` and
    features and labels for every node, all from ``default_rng(seed)``;
    ``batches(step)`` samples 32 seeds and their 2-hop subgraph (fanouts
    5, 5) from ``default_rng(seed + step)``, pads its edges to 2,048 and
    uploads the batch.  As in the reference, the subgraph's edges are in
    its local node ids and index the whole graph's ``feats``, and the
    label mask sets the seeds' global ids."""
    rng = np.random.default_rng(seed)
    n, e_pad = 256, 2048
    store = CompressedGraphStore(make_powerlaw_graph(rng, n, avg_degree=6), device)
    feats = rng.normal(size=(n, cfg.d_in)).astype(np.float32)
    labels = rng.integers(0, cfg.n_classes, n).astype(np.int32)

    def batches(step):
        r = np.random.default_rng(seed + step)
        seeds = r.choice(n, size=32, replace=False)
        nodes, edges = store.sample_subgraph(r, seeds, fanouts=(5, 5))
        e = np.zeros((2, e_pad), np.int32)
        m = np.zeros((e_pad,), bool)
        k = min(edges.shape[1], e_pad)
        e[:, :k] = edges[:, :k]
        m[:k] = True
        lm = np.zeros((n,), bool)
        lm[nodes[: len(seeds)]] = True
        return _upload({"feats": feats, "edges": e, "edge_mask": m,
                        "labels": labels, "label_mask": lm}, device)

    if params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        tree = G.init_params(gen, cfg)
    else:
        tree = gnn_tree_from_arrays(params, cfg, device)
    return tree, G.loss_fn, batches


def build_training(arch: str, smoke: bool, batch: int, seq_len: int = 128,
                   model_scale: int = 1, seed: int = 0, device="cuda",
                   params=None):
    """-> (state, step, batches, cfg) for ``FaultTolerantRunner``.

    ``state`` is ``(params, opt)`` (see the module docstring); ``step(state,
    batch) -> (state, metrics)`` takes one ``make_train_step`` step (base
    lr 1e-3, as the reference's launcher).  For the LM archs ``seq_len`` is
    the batches' sequence length and ``model_scale > 1`` scales the config
    as the reference does (twice the layers, ``model_scale`` times
    ``d_model``, ``d_ff`` and ``d_head``, a 32,768-word vocab); the recsys
    archs do not use them, nor does the GNN arch, whose batch is its
    sampler's (``_gnn_setup``).  ``params``: the reference's tree of arrays to
    start from instead of ``seed``'s draw."""
    bundle = get_arch(arch)
    cfg = bundle.smoke if smoke else bundle.full
    if bundle.family == "lm" and model_scale > 1:
        cfg = dataclasses.replace(
            cfg,
            n_layers=cfg.n_layers * 2,
            d_model=cfg.d_model * model_scale,
            d_ff=cfg.d_ff * model_scale,
            n_heads=cfg.n_heads,
            d_head=cfg.d_head * model_scale,
            vocab=32768,
        )
    dev = resolve_device(device)
    if bundle.family == "lm":
        tree, loss, batches = _lm_setup(cfg, batch, seq_len, seed, dev, params)
        module = T.Transformer
    elif bundle.family == "recsys":
        tree, loss, batches = _recsys_setup(cfg, batch, seed, dev, params)
        module = R.Recsys
    else:
        tree, loss, batches = _gnn_setup(cfg, seed, dev, params)
        module = G.GIN
    step = state_step(module, cfg, make_train_step(loss, cfg))
    return (tree, adamw_tree_init(tree)), step, batches, cfg


def state_step(module, cfg, step_fn):
    """``step(state, batch) -> (state, metrics)`` over the launcher's
    state ``(tree, {"count", "m", "v"})``: wraps the tree's current leaves
    in ``module(cfg, tree)`` (no copy) and takes one ``step_fn`` step
    (``launch.cells.make_train_step``) on them in place."""

    def step(state, b):
        tree, opt = state
        flat = {"m": named_leaves(opt["m"]), "v": named_leaves(opt["v"]),
                "count": int(opt["count"])}
        _, flat, metrics = step_fn(module(cfg, tree), flat, b)
        return (tree, {**opt, "count": flat["count"]}), metrics

    return step


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--model-scale", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the host)")
    return ap.parse_args(argv)


def main(argv=None, params=None):
    """The launcher; returns (the final state, the runner's ``RunStats``).
    ``params``: the reference's tree of arrays to start from."""
    args = parse_args(argv)
    state, step, batches, cfg = build_training(
        args.arch, args.smoke, args.batch, args.seq_len, args.model_scale,
        device=args.device, params=params,
    )
    print(f"[train] arch={args.arch} params={tree_size(state[0]):,}")
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro-ckpt-")
    manager = CheckpointManager(ckpt_dir, keep=2)
    runner = FaultTolerantRunner(step, manager, save_every=args.save_every)
    failure = SimulatedFailure(at_steps=tuple(args.fail_at)) if args.fail_at else None
    state = runner.run(state, batches, args.steps, failure=failure,
                       log_every=args.log_every)
    print(f"[train] done: {runner.stats}")
    return state, runner.stats


if __name__ == "__main__":
    main()
