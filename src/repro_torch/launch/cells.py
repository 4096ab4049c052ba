"""Cell builder: (architecture x input shape x mesh) -> a step to trace.

Counterpart of ``repro/launch/cells.py``.  A *cell* packages what the dry
run and the roofline table need: the step function, its inputs as
``meta`` tensors (no allocation: building a FULL config allocates
nothing), the input and output shardings as ``launch.mesh.PartitionSpec``
trees, and an analytic MODEL_FLOPS estimate.  A cell's step takes the
reference's trees -- ``fn(params, opt_state, batch)`` for training, with
``opt_state`` ``{"m": tree, "v": tree, "count": int}`` -- and runs the
port's step on a module that wraps the tree's leaves.

Sharding conventions (the reference's):
  LM    : batch -> (pod, data); heads/ffn/vocab -> model (Megatron TP);
          MoE experts -> model (EP) when divisible, else TP inside experts;
          decode KV cache: batch -> data axes; kv-heads -> model when
          divisible, else *sequence* -> model (split-K); batch==1
          long-context shards the sequence over everything.
  GNN   : edge arrays -> data axes; features/params replicated (GIN is
          tiny); full batch: nodes and edges over every axis (dst-sharded).
  RecSys: embedding tables row-sharded -> model; batch -> data axes;
          dcn/dlrm training: batch and table over every axis, the table
          updated by owner-routed rowwise Adagrad.

Also here: ``make_train_step``, and ``make_sparse_recsys_train_step`` with
its owner-routed table gather and update over a mesh
(``routed_table_gather`` / ``routed_table_update`` on global tensors, as
the reference's; ``routed_gather_local`` / ``routed_update_local`` on a
rank's blocks, which the step keeps: ``shard_rows``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from ..models.common import flatten, param_dict, tree_map, unflatten
from ..optim import adamw_update, clip_by_global_norm, cosine_lr
from .mesh import (
    P,
    all_to_all,
    axis_names,
    axis_size,
    data_axes,
    data_size,
    global_from_block,
    is_dtensor,
    local_block,
    psum,
    shard_map,
    tp_size,
)


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape_name: str
    mesh_name: str
    fn: Callable
    args: tuple  # trees of meta tensors (and host ints)
    in_shardings: tuple
    out_shardings: Any  # None => no constraint on the results
    model_flops: float  # analytic "useful" FLOPs per step (all devices)
    meta: dict


def _pad_to(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def _opt_specs(param_spec_tree):
    return {
        "m": param_spec_tree,
        "v": tree_map(lambda s: s, param_spec_tree),
        "count": P(),
    }


def _zip_map(fn, specs, shapes):
    if isinstance(specs, dict):
        return {k: _zip_map(fn, specs[k], shapes[k]) for k in specs}
    if isinstance(specs, list):
        return [_zip_map(fn, s, t) for s, t in zip(specs, shapes)]
    return fn(specs, shapes)


def _zero1_specs(param_spec_tree, params_shape, mesh):
    """ZeRO-1: shard AdamW moments over the data axes as well.

    For each leaf, the first dimension that is unsharded in the param spec
    and divisible by the data-axes product additionally gets the data axes.
    """
    dsh = data_axes(mesh)
    ds = data_size(mesh)

    def shard_leaf(spec, shape):
        entries = list(spec) + [None] * (len(shape.shape) - len(spec))
        for i, (e, n) in enumerate(zip(entries, shape.shape)):
            if e is None and n % ds == 0 and n > 0:
                entries[i] = dsh
                return P(*entries)
        return P(*entries)

    moments = _zip_map(shard_leaf, param_spec_tree, params_shape)
    return {
        "m": moments,
        "v": tree_map(lambda s: s, moments),
        "count": P(),
    }


def _opt_shape(params_shape) -> dict:
    """``adamw_init``'s state of a meta tree: f32 moments, count 0."""
    def f32(t):
        return torch.empty(t.shape, dtype=torch.float32, device="meta")

    return {"m": tree_map(f32, params_shape), "v": tree_map(f32, params_shape),
            "count": 0}


def _reduced(grads: dict, like: dict) -> dict:
    """The gradients at the placements of ``like`` (the AdamW moments):
    on DTensors (the dry run) each partial gradient is reduced once here,
    all-reduced or reduce-scattered onto ZeRO-1's shards, where the clip
    and both moments would each reduce it again (DTensor keeps no
    reduction).  Plain tensors pass as they are."""
    return {k: g.redistribute(g.device_mesh, like[k].placements)
            if is_dtensor(g) and is_dtensor(like[k]) else g for k, g in grads.items()}


def make_train_step(loss_fn, cfg, base_lr: float = 1e-3, warmup: int = 10,
                    total: int = 100_000):
    """Generic loss -> grad -> clip -> AdamW step.

    ``step(model, opt_state, batch) -> (model, opt_state, metrics)``
    updates the model's parameters and ``opt_state`` in place (see
    ``optim.adamw``); ``opt_state`` comes from ``adamw_init(param_dict(
    model))``.  ``metrics`` holds the loss and the gradient's global norm
    as 0-d tensors on the model's device (reading them syncs).
    """

    def step(model, opt_state, batch):
        params = param_dict(model)
        loss = loss_fn(model, batch, cfg)
        grads = torch.autograd.grad(loss, list(params.values()))
        grads = _reduced(dict(zip(params, grads)), opt_state["m"])
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        lr = cosine_lr(opt_state["count"] + 1, base_lr, warmup, total)
        adamw_update(grads, opt_state, params, lr)
        return model, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return step


def _tree_step(module_of, step, moments=("m", "v")):
    """A module step as the reference's tree step: ``fn(params, opt_state,
    batch) -> (params, opt_state, metrics)``; the module wraps ``params``'
    leaves, the moments go by dotted name."""

    def flat(st):
        return {**st, **{k: flatten(st[k]) for k in moments}}

    def nest(st):
        return {**st, **{k: unflatten(st[k]) for k in moments}}

    def fn(params, opt_state, batch):
        model = module_of(params)
        if "mlp" in opt_state:  # the sparse step's state
            opt = {**opt_state, "mlp": flat(opt_state["mlp"])}
        else:
            opt = flat(opt_state)
        _, opt, metrics = step(model, opt, batch)
        out = {**opt, "mlp": nest(opt["mlp"])} if "mlp" in opt else nest(opt)
        return unflatten(param_dict(model)), out, metrics

    return fn


# ==========================================================================
# LM cells
# ==========================================================================

def _lm_cell(bundle, shape, mesh, mesh_name: str) -> Cell:
    from ..models import transformer as T

    cfg = bundle.full
    dsh = data_axes(mesh)
    ds = data_size(mesh)
    tp = tp_size(mesh)
    if cfg.is_moe:
        # GShard grouped dispatch (one capacity group per data shard) +
        # the explicit-collective shard_map MoE
        cfg = dataclasses.replace(cfg, moe_groups=ds, moe_shard_map=True)
    pspecs = T.param_specs(cfg, tp=tp)
    params_shape = T.init_params_shape_tree(cfg)

    def module_of(params):
        return T.Transformer(cfg, params)

    N = cfg.param_count()
    N_act = cfg.active_param_count()

    if shape.kind == "train":
        tokens_total = shape.seq_len * shape.batch

        def loss(model, batch, cfg):
            return T.lm_loss(model, batch["tokens"], batch["labels"], cfg)

        step = _tree_step(module_of, make_train_step(loss, cfg))
        batch_shape = T.input_specs(cfg, "train", shape.seq_len, shape.batch)
        bspec = {"tokens": P(dsh, None), "labels": P(dsh, None)}
        ospecs = _zero1_specs(pspecs, params_shape, mesh)  # ZeRO-1 moments
        in_sh = (pspecs, ospecs, bspec)
        out_sh = (pspecs, ospecs, {"loss": P(), "grad_norm": P()})
        return Cell(
            bundle.arch_id, shape.name, mesh_name, step,
            (params_shape, _opt_shape(params_shape), batch_shape), in_sh, out_sh,
            model_flops=6.0 * N_act * tokens_total,
            meta={"params": N, "active_params": N_act, "tokens": tokens_total},
        )

    if shape.kind == "prefill":
        def fn(params, tokens):
            return T.prefill_step(module_of(params), tokens, cfg)

        tok = T.input_specs(cfg, "prefill", shape.seq_len, shape.batch)["tokens"]
        in_sh = (pspecs, P(dsh, None))
        return Cell(
            bundle.arch_id, shape.name, mesh_name, fn, (params_shape, tok),
            in_sh, None,
            model_flops=2.0 * N_act * shape.seq_len * shape.batch,
            meta={"params": N, "active_params": N_act},
        )

    if shape.kind == "decode":
        Sc = min(shape.seq_len, cfg.sliding_window) if cfg.sliding_window > 0 else shape.seq_len
        specs = T.input_specs(cfg, "decode", shape.seq_len, shape.batch)

        kv_ok = cfg.n_kv_heads % tp == 0
        if shape.batch % ds == 0 and shape.batch >= ds:
            if kv_ok:
                cspec = P(None, None, dsh, None, "model", None)
            else:  # split-K: shard the cache sequence over `model`
                cspec = P(None, None, dsh, "model", None, None)
            tspec = P(dsh)
        else:  # tiny batch (long-context): shard sequence over everything
            seq_axes = dsh if kv_ok else dsh + ("model",)
            cspec = P(None, None, None, seq_axes, "model" if kv_ok else None, None)
            tspec = P(None)

        def fn(params, cache, token, cache_pos):
            return T.serve_step(module_of(params), cache, token, cache_pos, cfg)

        in_sh = (pspecs, cspec, tspec, P())
        # the port's decode position is a host int: the dry run traces the
        # step at the cache's last slot
        return Cell(
            bundle.arch_id, shape.name, mesh_name, fn,
            (params_shape, specs["cache"], specs["token"], Sc - 1), in_sh, None,
            model_flops=2.0 * N_act * shape.batch,
            meta={"params": N, "active_params": N_act, "cache_len": Sc,
                  "cache_spec": str(cspec)},
        )

    raise ValueError(shape.kind)


# ==========================================================================
# GNN cells
# ==========================================================================

def _gin_flops(cfg, n_nodes: int, n_edges: int, train: bool) -> float:
    f = 0.0
    d_prev = cfg.d_in
    for _ in range(cfg.n_layers):
        f += 2.0 * n_edges * d_prev  # message gather+sum
        f += 2.0 * n_nodes * (d_prev * cfg.d_hidden + cfg.d_hidden * cfg.d_hidden)
        d_prev = cfg.d_hidden
    f += 2.0 * n_nodes * cfg.d_hidden * cfg.n_classes
    return f * (3.0 if train else 1.0)


def _gnn_cell(bundle, shape, mesh, mesh_name: str) -> Cell:
    from ..models import gnn as G

    dsh = data_axes(mesh)
    pad = 512  # divisible by every data-axes product we use (16, 32)

    if shape.kind == "sampled":
        # 2-hop neighbor-sampled subgraph (fanout 15-10) at the sampler's
        # static pads
        b = shape.batch
        n_nodes = b * (1 + 15 + 150)
        n_edges = b * (15 + 150)
        d_feat = shape.d_feat
        n_classes = 41
    elif shape.kind == "molecule":
        n_nodes = shape.batch * shape.n_nodes
        n_edges = shape.batch * shape.n_edges
        d_feat = shape.d_feat
        n_classes = 2
    else:  # fullbatch
        n_nodes = shape.n_nodes
        n_edges = shape.n_edges
        d_feat = shape.d_feat
        n_classes = 47 if shape.name == "ogb_products" else bundle.full.n_classes

    cfg = dataclasses.replace(
        bundle.full,
        d_in=d_feat,
        n_classes=n_classes,
        graph_readout=(shape.kind == "molecule"),
        message_dtype="bfloat16" if shape.kind == "fullbatch" else "float32",
    )

    # full-batch node classification uses the dst-aligned sharded path:
    # nodes/edges sharded over EVERY mesh axis
    dst_sharded = shape.kind == "fullbatch"
    if dst_sharded:
        all_axes = tuple(a for a in ("pod", "data", "model") if a in axis_names(mesh))
        S = math.prod(axis_size(mesh, a) for a in all_axes)
        n_nodes = _pad_to(n_nodes, S)
        n_edges_p = _pad_to(n_edges, S)
        specs = G.input_specs(cfg, n_nodes, n_edges_p)
        bspec = G.batch_specs_sharded(cfg, axes=all_axes)

        def loss(model, batch, cfg):
            return G.loss_fn_dst_sharded(model, batch, cfg)
    else:
        n_edges_p = _pad_to(n_edges, pad)
        specs = G.input_specs(
            cfg, n_nodes, n_edges_p,
            n_graphs=shape.batch if shape.kind == "molecule" else 0,
        )
        bspec = G.batch_specs(cfg, data_axes=dsh)
        loss = G.loss_fn
    step = _tree_step(lambda p: G.GIN(cfg, p), make_train_step(loss, cfg))
    params_shape = G.init_params_shape_tree(cfg)
    pspecs = tree_map(lambda _: P(), params_shape)
    in_sh = (pspecs, _opt_specs(pspecs), bspec)
    out_sh = (pspecs, _opt_specs(pspecs), {"loss": P(), "grad_norm": P()})
    return Cell(
        bundle.arch_id, shape.name, mesh_name, step,
        (params_shape, _opt_shape(params_shape), specs), in_sh, out_sh,
        model_flops=_gin_flops(cfg, n_nodes, n_edges, train=True),
        meta={"n_nodes": n_nodes, "n_edges": n_edges_p, "d_feat": d_feat},
    )


# ==========================================================================
# RecSys: the owner-routed table gather and update
# ==========================================================================

def _buckets(ids_loc, S: int, rows_loc: int, slack: float):
    """Each id's owner shard, its slot in the owner's bucket and whether it
    fits the bucket's capacity ``max(8, ceil(n_loc / S * slack))``."""
    n_loc = ids_loc.shape[0]
    owner = ids_loc // rows_loc
    onehot = (owner[:, None] == torch.arange(S, device=ids_loc.device)[None, :]).int()
    pos = (torch.cumsum(onehot, 0) - onehot)[torch.arange(n_loc, device=ids_loc.device),
                                             owner]
    cap = max(8, int(math.ceil(n_loc / S * slack)))
    keep = pos < cap
    return owner, pos, keep, cap


def _to_buckets(owner, pos, keep, cap: int, S: int, vals, fill):
    """``[S, cap, ...]``: each kept value at its slot, ``fill`` elsewhere
    (an overflowing value goes to a spare slot that is cut off: no
    data-dependent shapes, so the dry run traces it)."""
    b = torch.full((S, cap + 1, *vals.shape[1:]), fill, dtype=vals.dtype,
                   device=vals.device)
    b.index_put_((owner, torch.where(keep, pos, cap)), vals)
    return b[:, :cap]


def _bucket_ids(owner, pos, keep, cap: int, S: int, vals, fill: int):
    """``[S, cap]`` ids: the kept ids at their slots, ``fill`` elsewhere.
    An overflowing id writes ``fill`` into its owner's last slot, over the
    kept id there, as the reference's in-order ``.at[].set`` does (a
    reference quirk, kept: that kept id then reads or writes nothing)."""
    b = _to_buckets(owner, pos, keep, cap, S, vals, fill)
    over = torch.zeros(S, dtype=torch.int32, device=vals.device).index_add_(
        0, owner, (~keep).int()) > 0
    b[:, cap - 1] = torch.where(over, fill, b[:, cap - 1])
    return b


def _a2a_axes(table, table_axes: tuple, mesh) -> tuple:
    """The axes whose shard order is the order of the table's row blocks:
    ``table_axes`` for a plain block (cut by ``shard_rows``, the reference's
    order), the mesh's order for a DTensor (whose placements shard a
    multi-axis entry in the mesh's order)."""
    if is_dtensor(table):
        return tuple(a for a in axis_names(mesh) if a in table_axes)
    return table_axes


def _local(t):
    return t.to_local() if is_dtensor(t) else t


def routed_update_local(table_loc, acc_loc, ids_loc, g_loc, base_lr: float, mesh,
                        table_axes: tuple, batch_axes: tuple, slack: float = 4.0):
    """``routed_table_update`` on this rank's blocks: ``table_loc`` and
    ``acc_loc`` (its rows of the table and the accumulator, updated IN
    PLACE) and ``ids_loc`` / ``g_loc`` (its (row id, gradient) pairs).
    Only the id and gradient buckets cross the wire.  Returns the rows
    dropped by bucket overflow, summed over the mesh."""
    S = math.prod(axis_size(mesh, a) for a in table_axes)
    rows_loc = table_loc.shape[0]
    d = g_loc.shape[-1]
    owner, pos, keep, cap = _buckets(ids_loc, S, rows_loc, slack)
    dropped = torch.sum(1 - keep.int())
    b_ids = _bucket_ids(owner, pos, keep, cap, S, ids_loc % rows_loc, -1)
    b_g = _to_buckets(owner, pos, keep, cap, S, g_loc, 0.0)
    # one hop: shard s receives every peer's bucket destined for s
    r_ids = all_to_all(b_ids, table_axes, mesh)  # [S, cap]
    r_g = all_to_all(b_g, table_axes, mesh)  # [S, cap, d]
    valid = r_ids >= 0
    # an empty slot adds zeros: the reference sends every one to row 0;
    # here slot i goes to row i % rows_loc, which adds the same zeros
    # without piling millions of updates on one row (the card's atomics
    # and its deterministic scatter serialise those)
    spare = torch.arange(valid.numel(), device=valid.device).reshape(
        valid.shape) % rows_loc
    rows = torch.where(valid, r_ids, spare).reshape(-1)
    g = torch.where(valid[..., None], r_g, 0).reshape(-1, d)
    acc_loc.index_add_(0, rows, torch.sum(g * g, -1))
    scale = (base_lr / torch.sqrt(acc_loc[rows] + 1e-8)).to(table_loc.dtype)
    table_loc.index_add_(0, rows, -scale[:, None] * g.to(table_loc.dtype))
    return psum(dropped, table_axes + tuple(
        a for a in batch_axes if a not in table_axes), mesh)


def routed_gather_local(table_loc, ids_loc, mesh, table_axes: tuple,
                        slack: float = 4.0):
    """``routed_table_gather`` on this rank's blocks: the rows of
    ``ids_loc`` from the table whose row block here is ``table_loc``."""
    S = math.prod(axis_size(mesh, a) for a in table_axes)
    rows_loc = table_loc.shape[0]
    owner, pos, keep, cap = _buckets(ids_loc, S, rows_loc, slack)
    pos_c = torch.where(keep, pos, cap - 1)
    b_ids = _bucket_ids(owner, pos, keep, cap, S, ids_loc % rows_loc, 0)
    r_ids = all_to_all(b_ids, table_axes, mesh)  # [S, cap]
    rows = table_loc.index_select(0, r_ids.reshape(-1))
    rows = rows.reshape(S, cap, table_loc.shape[-1])
    back = all_to_all(rows, table_axes, mesh)  # [S, cap, d]
    return back[owner, pos_c] * keep[:, None].to(back.dtype)


def routed_table_update(table, acc, ids, g_emb, base_lr: float, mesh,
                        table_axes: tuple, batch_axes: tuple, slack: float = 4.0):
    """Owner-routed sparse table update (the DLRM butterfly), on global
    tensors as the reference's: returns (table, acc, rows dropped by
    bucket overflow, summed over the mesh), every rank the same.

    The table (and its rowwise-Adagrad accumulator) is sharded over
    ``table_axes``.  Each rank buckets its local (row_id, grad) pairs by
    owner shard and ships them with ONE capacity-bounded all_to_all of ids
    and one of gradients; owners apply a purely local scatter
    (``routed_update_local``).  Plain global tensors are cut into blocks
    and the results gathered back to every rank: a table-sized all_gather,
    which the sparse step avoids by keeping its table as blocks
    (``shard_rows``).  DTensors keep their blocks.
    """
    axes = _a2a_axes(table, table_axes, mesh)

    def body(table_loc, acc_loc, ids_loc, g_loc):
        table_loc, acc_loc = table_loc.clone(), acc_loc.clone()
        dropped = routed_update_local(table_loc, acc_loc, ids_loc, g_loc, base_lr,
                                      mesh, axes, batch_axes, slack)
        return table_loc, acc_loc, dropped

    with torch.no_grad():
        return shard_map(
            body, mesh,
            (P(axes, None), P(axes), P(batch_axes), P(batch_axes, None)),
            (P(axes, None), P(axes), P()),
        )(table, acc, ids, g_emb)


def routed_table_gather(table, ids, mesh, table_axes: tuple, batch_axes: tuple,
                        slack: float = 4.0):
    """Owner-routed embedding gather (the forward half of the butterfly):
    an all_to_all of id buckets out and one of the gathered rows back; an
    id past its bucket's capacity reads zeros."""
    axes = _a2a_axes(table, table_axes, mesh)
    with torch.no_grad():
        return shard_map(
            lambda t, i: routed_gather_local(t, i, mesh, axes, slack), mesh,
            (P(axes, None), P(batch_axes)), P(batch_axes, None))(table, ids)


def shard_rows(model, mesh, table_axes: tuple) -> None:
    """Replace ``model.table`` (the global table, the same on every rank)
    by this rank's block of rows over ``table_axes``, as the sparse step
    with a mesh keeps it; then ``sparse_opt_init`` makes the matching
    accumulator block."""
    S = math.prod(axis_size(mesh, a) for a in table_axes)
    block = model.table.detach().chunk(S)[mesh.shard_index(table_axes)]
    model.table = torch.nn.Parameter(block.clone(), requires_grad=False)


def gather_rows(block, mesh, table_axes: tuple):
    """The global tensor of per-rank row blocks (``shard_rows``'s inverse:
    a table-sized all_gather, for checks, never in the step)."""
    with torch.no_grad():
        return global_from_block(block, P(table_axes), mesh)


def sparse_opt_init(model) -> dict:
    """The sparse step's optimizer state: AdamW over every parameter but
    the table, and one f32 rowwise-Adagrad accumulator a table row."""
    from ..optim import adamw_init

    other = {k: v for k, v in param_dict(model).items() if k != "table"}
    table = model.table
    return {"mlp": adamw_init(other),
            "table_acc": torch.zeros(table.shape[0], dtype=torch.float32,
                                     device=table.device)}


def make_sparse_recsys_train_step(cfg, base_lr: float = 1e-2, mesh=None,
                                  table_axes: tuple = (),
                                  batch_axes: tuple = ()):
    """dcn/dlrm train step with SPARSE embedding updates.

    The dense step keeps AdamW moments for the whole table and a dense
    gradient of it.  Here gradients are taken with respect to the
    non-table parameters and the gathered embedding rows ``emb`` [B, F,
    d]; the non-table parameters take the clipped AdamW step; the table is
    updated by rowwise Adagrad on the touched rows only, by scatter:
    ``acc[id] += |g|^2`` summed over every occurrence of a row, then each
    occurrence adds ``-base_lr / sqrt(acc[id] + 1e-8) * g`` with the
    accumulator read after all the adds.  A row id repeated in the batch
    sums its occurrences, as the reference's ``.at[].add`` does (on the
    card ``index_add_`` sums them with atomics, in no fixed order).

    With ``mesh`` and ``table_axes`` the gather and the update are
    owner-routed over all_to_alls (``routed_gather_local`` /
    ``routed_update_local``): ``model.table`` and ``opt_state
    ["table_acc"]`` hold this rank's block of rows over ``table_axes``
    (``shard_rows`` before ``sparse_opt_init``; on one rank the block is
    the table; a DTensor's local block in the dry run) and stay blocks
    from step to step.  The batch is global, every rank's the same (a
    DTensor sharded over ``batch_axes`` in the dry run): each rank routes
    the ids of its block of it, the gathered rows are all-gathered over
    ``batch_axes`` for the dense part, which every rank runs on the whole
    batch, and each rank routes its block of the row gradients back.  The
    wire is ids, embedding rows and their gradients, never the table.

    ``step(model, opt_state, batch) -> (model, opt_state, metrics)``
    updates the model's parameters and ``opt_state`` (``sparse_opt_init``)
    in place; with a mesh ``metrics`` also holds ``dropped``.
    """
    from ..models.recsys import ctr_head

    if cfg.kind not in ("dcn", "dlrm"):
        raise ValueError(f"the sparse step takes dcn or dlrm, not {cfg.kind}")
    routed = mesh is not None and bool(table_axes)

    def step(model, opt_state, batch):
        params = param_dict(model)
        table = params.pop("table")
        F, d = cfg.n_sparse, cfg.embed_dim
        offs = torch.arange(F, device=batch["sparse"].device) * cfg.rows_per_field
        flat_ids = (batch["sparse"].long() + offs[None, :]).reshape(-1)
        if routed:
            table_loc = _local(table.detach())
            S = math.prod(axis_size(mesh, a) for a in table_axes)
            if table_loc.shape[0] * S != cfg.table_rows:
                raise ValueError(f"the table's block has {table_loc.shape[0]} rows, "
                                 f"not {cfg.table_rows} / {S}: shard_rows first")
            axes = _a2a_axes(table, table_axes, mesh)
            ids_loc = local_block(flat_ids, P(batch_axes), mesh)
            with torch.no_grad():
                emb = global_from_block(
                    routed_gather_local(table_loc, ids_loc, mesh, axes),
                    P(batch_axes, None), mesh, table if is_dtensor(table) else None)
        else:
            emb = table.detach().index_select(0, flat_ids)
        emb = emb.reshape(-1, F, d).requires_grad_()
        logits = ctr_head(model, batch["dense"], emb, cfg).float()
        y = batch["label"].float()
        loss = torch.mean(torch.clamp_min(logits, 0) - logits * y
                          + torch.log1p(torch.exp(-logits.abs())))
        *g_other, g_emb = torch.autograd.grad(loss, [*params.values(), emb])
        mlp = opt_state["mlp"]
        g_other = _reduced(dict(zip(params, g_other)), mlp["m"])
        g_other, gnorm = clip_by_global_norm(g_other, 1.0)
        lr = cosine_lr(mlp["count"] + 1, base_lr, 10, 100_000)
        adamw_update(g_other, mlp, params, lr)
        # rowwise Adagrad, scatter only
        g_flat = g_emb.reshape(-1, d)
        acc = opt_state["table_acc"]
        metrics = {"loss": loss.detach(), "grad_norm": gnorm}
        with torch.no_grad():
            if routed:
                metrics["dropped"] = routed_update_local(
                    table_loc, _local(acc), ids_loc,
                    local_block(g_flat, P(batch_axes, None), mesh), base_lr, mesh,
                    axes, batch_axes)
            else:
                acc.index_add_(0, flat_ids, torch.sum(g_flat * g_flat, -1))
                scale = base_lr / torch.sqrt(acc[flat_ids] + 1e-8)
                table.index_add_(0, flat_ids, -scale[:, None] * g_flat)
        return model, opt_state, metrics

    return step


# ==========================================================================
# RecSys cells
# ==========================================================================

def _recsys_flops(cfg, batch: int, train: bool) -> float:
    d = cfg.embed_dim
    if cfg.kind == "dcn":
        x0 = cfg.n_dense + cfg.n_sparse * d
        per = cfg.n_cross_layers * 2 * x0 * x0
        dims = (x0, *cfg.mlp, 1)
        per += sum(2 * a * b for a, b in zip(dims, dims[1:]))
    elif cfg.kind == "dlrm":
        dims = (cfg.n_dense, *cfg.bot_mlp)
        per = sum(2 * a * b for a, b in zip(dims, dims[1:]))
        nv = cfg.n_sparse + 1
        per += 2 * nv * nv * d
        inter = nv * (nv - 1) // 2 + cfg.bot_mlp[-1]
        dims = (inter, *cfg.top_mlp, 1)
        per += sum(2 * a * b for a, b in zip(dims, dims[1:]))
    elif cfg.kind == "din":
        dims = (4 * d, *cfg.attn_mlp, 1)
        per = cfg.seq_len * sum(2 * a * b for a, b in zip(dims, dims[1:]))
        per += 2 * cfg.seq_len * d
        dims = (3 * d, 200, 80, 1)
        per += sum(2 * a * b for a, b in zip(dims, dims[1:]))
    else:  # bst
        L = cfg.seq_len + 1
        per = cfg.n_blocks * (2 * L * (3 * d * d + d * d + 8 * d * d) + 2 * L * L * d * 2)
        dims = (L * d, 1024, 512, 256, 1)
        per += sum(2 * a * b for a, b in zip(dims, dims[1:]))
    return float(per) * batch * (3.0 if train else 1.0)


def _recsys_cell(bundle, shape, mesh, mesh_name: str) -> Cell:
    from ..models import recsys as R

    cfg = bundle.full
    dsh = data_axes(mesh)
    params_shape = R.init_params_shape_tree(cfg)
    pspecs = R.param_specs(cfg)

    def module_of(params):
        return R.Recsys(cfg, params)

    if shape.kind == "train":
        specs = R.input_specs(cfg, "train", shape.batch)
        if cfg.kind in ("dcn", "dlrm"):
            # sparse-update path: batch sharded over EVERY axis, the table
            # row-sharded over EVERY axis with owner-routed updates
            all_ax = dsh + ("model",)
            table_axes = ("model",) + dsh  # table shard-major order
            bspec = {"dense": P(all_ax), "sparse": P(all_ax), "label": P(all_ax)}
            step = _tree_step(module_of, make_sparse_recsys_train_step(
                cfg, mesh=mesh, table_axes=table_axes, batch_axes=all_ax))
            other_shape = {k: v for k, v in params_shape.items() if k != "table"}
            opt_shape = {
                "mlp": _opt_shape(other_shape),
                "table_acc": torch.empty((cfg.table_rows,), dtype=torch.float32,
                                         device="meta"),
            }
            pspecs = dict(pspecs)
            pspecs["table"] = P(table_axes, None)
            other_specs = {k: v for k, v in pspecs.items() if k != "table"}
            opt_specs = {"mlp": _opt_specs(other_specs), "table_acc": P(table_axes)}
            in_sh = (pspecs, opt_specs, bspec)
            out_sh = (pspecs, opt_specs, {"loss": P(), "grad_norm": P()})
        else:
            bspec = R.batch_specs(cfg, "train", data_axes=dsh)
            step = _tree_step(module_of, make_train_step(R.loss_fn, cfg))
            opt_shape = _opt_shape(params_shape)
            in_sh = (pspecs, _opt_specs(pspecs), bspec)
            out_sh = (pspecs, _opt_specs(pspecs), {"loss": P(), "grad_norm": P()})
        return Cell(
            bundle.arch_id, shape.name, mesh_name, step,
            (params_shape, opt_shape, specs), in_sh, out_sh,
            model_flops=_recsys_flops(cfg, shape.batch, True),
            meta={"params": cfg.param_count()},
        )

    if shape.kind == "serve":
        def fn(params, batch):
            return R.serve_score(module_of(params), batch, cfg)

        specs = R.input_specs(cfg, "serve", shape.batch)
        bspec = R.batch_specs(cfg, "serve", data_axes=dsh)
        return Cell(
            bundle.arch_id, shape.name, mesh_name, fn, (params_shape, specs),
            (pspecs, bspec), None,
            model_flops=_recsys_flops(cfg, shape.batch, False),
            meta={},
        )

    if shape.kind == "retrieval":
        def fn(params, batch):
            return R.retrieval_step(module_of(params), batch, cfg)

        specs = R.input_specs(cfg, "retrieval", shape.batch, shape.n_candidates)
        bspec = R.batch_specs(cfg, "retrieval", data_axes=dsh)
        return Cell(
            bundle.arch_id, shape.name, mesh_name, fn, (params_shape, specs),
            (pspecs, bspec), None,
            model_flops=_recsys_flops(cfg, shape.n_candidates, False),
            meta={"n_candidates": shape.n_candidates},
        )

    raise ValueError(shape.kind)


# ==========================================================================
# Entry point
# ==========================================================================

def build_cell(bundle, shape, mesh, mesh_name: str) -> Cell:
    """The cell of ``bundle`` x ``shape`` on ``mesh`` (a ``launch.mesh.Mesh``,
    abstract or not)."""
    if bundle.family == "lm":
        return _lm_cell(bundle, shape, mesh, mesh_name)
    if bundle.family == "gnn":
        return _gnn_cell(bundle, shape, mesh, mesh_name)
    if bundle.family == "recsys":
        return _recsys_cell(bundle, shape, mesh, mesh_name)
    raise ValueError(bundle.family)
