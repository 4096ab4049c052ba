"""GIN (Graph Isomorphism Network, arXiv:1810.00826) in PyTorch.

Counterpart of ``repro/models/gnn.py``.  Message passing is a gather of
the source rows (``index_select``) and a sum into the destination rows
(``index_add``), the reference's ``h[src]`` and ``jax.ops.segment_sum``;
the ``eps`` parameters are learnable (GIN-eps).  No TPU kernel lies on
this path: the reference computes it with XLA's scatter-add, not Pallas.
On the card ``index_add`` sums with atomics, so the f32 order of a node's
messages is not the CPU's.

Supported input regimes (all padded/masked to static shapes):
  * full-batch node classification (cora-like / ogbn-products-like),
  * sampled-subgraph mini-batch training (neighbor sampler in
    ``repro_torch.data.graph_data``),
  * batched small graphs with segment-sum readout (molecule).

Normalization: LayerNorm, as the reference (the original model uses
BatchNorm).  The parameters keep the reference's tree -- ``layers[i].
{eps, w1, b1, w2, b2, ln_scale, ln_bias}``, ``head``, ``head_b``, every
weight ``[in, out]`` -- held by a ``GIN`` module without a copy, so
``models.common.param_dict`` gives jax's leaf order (``init_model`` draws
one on the card unless told otherwise).  Entry points as in the
reference: ``forward``, ``loss_fn(model, batch, cfg)`` (for
``launch.cells.make_train_step``) and ``loss_fn_dst_sharded``, which over
a mesh (an argument, or the ambient ``launch.mesh.set_mesh``) runs the
dst-aligned sharded path: nodes and edges split over every mesh axis, one
``all_gather`` of the node block a layer in ``message_dtype``.  The dry
run's shardings and meta tensors come from ``param_specs``,
``input_specs``, ``batch_specs`` and ``batch_specs_sharded``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..api import resolve_device
from ..launch.mesh import (
    P,
    all_gather,
    axis_index,
    axis_names,
    axis_size,
    from_local,
    get_abstract_mesh,
    is_dtensor,
    psum,
    shard_map,
)
from .common import dense_init, layer_norm, meta, split_keys, tree_map


@dataclasses.dataclass(frozen=True)
class GINConfig:
    name: str = "gin"
    n_layers: int = 5
    d_in: int = 1433
    d_hidden: int = 64
    n_classes: int = 7
    graph_readout: bool = False  # True => graph classification (molecule)
    message_dtype: str = "float32"  # "bfloat16" halves the all_gather wire
    # bytes in the dst-sharded path (accumulation stays f32)


def shape_tree(cfg: GINConfig) -> dict:
    """The parameter tree's leaf shapes, in the reference's structure."""
    h = cfg.d_hidden
    dims = [cfg.d_in] + [h] * cfg.n_layers
    layers = [{"eps": (), "w1": (dims[l], h), "b1": (h,), "w2": (h, h),
               "b2": (h,), "ln_scale": (h,), "ln_bias": (h,)}
              for l in range(cfg.n_layers)]
    return {"layers": layers, "head": (h, cfg.n_classes),
            "head_b": (cfg.n_classes,)}


def init_params(gen: torch.Generator, cfg: GINConfig) -> dict:
    """The reference's tree, drawn from ``gen`` on its device: ``eps`` a
    0-d f32 zero, biases and LayerNorm biases zeros, LayerNorm scales
    ones, ``w1``, ``w2`` and ``head`` fan-in truncated normals."""
    dev = gen.device
    shapes = shape_tree(cfg)
    ks = split_keys(gen, [*map(str, range(cfg.n_layers)), "head"])
    layers = []
    for l, s in enumerate(shapes["layers"]):
        k = split_keys(ks[str(l)], ["1", "2"])
        layers.append({
            "eps": torch.zeros((), device=dev),
            "w1": dense_init(k["1"], s["w1"]),
            "b1": torch.zeros(s["b1"], device=dev),
            "w2": dense_init(k["2"], s["w2"]),
            "b2": torch.zeros(s["b2"], device=dev),
            "ln_scale": torch.ones(s["ln_scale"], device=dev),
            "ln_bias": torch.zeros(s["ln_bias"], device=dev),
        })
    return {"layers": layers, "head": dense_init(ks["head"], shapes["head"]),
            "head_b": torch.zeros(shapes["head_b"], device=dev)}


def init_params_shape_tree(cfg: GINConfig) -> dict:
    """``init_params``'s tree on the ``meta`` device: shapes and dtypes,
    no storage."""
    shapes = shape_tree(cfg)
    return {"layers": [{k: meta(s) for k, s in l.items()} for l in shapes["layers"]],
            "head": meta(shapes["head"]), "head_b": meta(shapes["head_b"])}


class Layer(nn.Module):
    """One GIN layer's seven leaves."""

    def __init__(self, eps, w1, b1, w2, b2, ln_scale, ln_bias):
        super().__init__()
        self.eps = nn.Parameter(eps)
        self.w1 = nn.Parameter(w1)
        self.b1 = nn.Parameter(b1)
        self.w2 = nn.Parameter(w2)
        self.b2 = nn.Parameter(b2)
        self.ln_scale = nn.Parameter(ln_scale)
        self.ln_bias = nn.Parameter(ln_bias)


class GIN(nn.Module):
    """A GIN holding the reference's parameter tree.  Each parameter wraps
    its tree leaf without a copy."""

    def __init__(self, cfg: GINConfig, tree: dict):
        super().__init__()
        self.cfg = cfg
        self.head = nn.Parameter(tree["head"])
        self.head_b = nn.Parameter(tree["head_b"])
        self.layers = nn.ModuleList(Layer(**l) for l in tree["layers"])

    def forward(self, feats, edges, edge_mask, graph_ids=None, n_graphs=0):
        return forward(self, feats, edges, edge_mask, self.cfg, graph_ids, n_graphs)


def init_model(cfg: GINConfig, seed: int = 0, device="cuda") -> GIN:
    """A model initialised from ``torch.Generator(device).manual_seed(seed)``
    on ``device`` (the card unless the caller asks for the CPU)."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    return GIN(cfg, init_params(gen, cfg))


class _SegmentSum(torch.autograd.Function):
    """``index_add`` into zeros whose backward gathers the gradient at the
    ids, as jax's ``segment_sum`` does.  It keeps only the ids: autograd's
    own ``index_add`` keeps its whole ``[E, d]`` source for the backward,
    which at ogb_products' 61.86 M edges is 15.8 GB a layer."""

    @staticmethod
    def forward(ctx, data, segment_ids, num_segments):
        ctx.save_for_backward(segment_ids)
        out = data.new_zeros((num_segments, *data.shape[1:]))
        return out.index_add_(0, segment_ids, data)

    @staticmethod
    def backward(ctx, grad):
        (segment_ids,) = ctx.saved_tensors
        return grad.index_select(0, segment_ids), None, None


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int):
    """``jax.ops.segment_sum`` for in-range ids: row i of ``data`` added
    into row ``segment_ids[i]`` of a zero ``[num_segments, ...]``.  On
    DTensors (the dry run) each rank sums its own rows: rows split over a
    mesh axis give a partial sum over it, as XLA's under pjit."""
    if is_dtensor(data):
        return _segment_sum_dtensor(data, segment_ids, num_segments)
    return _SegmentSum.apply(data, segment_ids, num_segments)


def _segment_sum_dtensor(data, segment_ids, num_segments: int):
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = data.device_mesh
    pl = [Replicate() if isinstance(p, Partial) else p for p in data.placements]
    data = data.redistribute(mesh, pl)
    rows = [p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in pl]
    ids = segment_ids.redistribute(mesh, rows)
    out_pl = [Partial() if isinstance(p, Shard) and p.dim == 0 else p for p in pl]
    local = _SegmentSum.apply(data.to_local(), ids.to_local(), num_segments)
    return from_local(local, mesh, out_pl, (num_segments, *data.shape[1:]))


def aggregate(h: torch.Tensor, src, dst, keep: torch.Tensor) -> torch.Tensor:
    """One layer's messages summed at their destinations: row v is the sum
    of ``h[src[e]] * keep[e]`` over the edges e with ``dst[e] == v``."""
    return segment_sum(_gather_rows(h, src) * keep, dst, h.shape[0])


def _gather_rows(h, idx):
    """``h.index_select(0, idx)``; on DTensors (the dry run) in a local
    region: each rank gathers its ids' rows from every row of ``h``, and
    the rows' cotangents sum over the mesh axes that split the ids."""
    if not is_dtensor(h):
        return h.index_select(0, idx)
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = h.device_mesh
    split = [isinstance(p, Shard) and p.dim == 0 for p in idx.placements]
    hpl = [p if isinstance(p, Shard) and p.dim > 0 else Replicate()
           for p in h.placements]
    ipl = [Shard(0) if s else Replicate() for s in split]
    h, idx = h.redistribute(mesh, hpl), idx.redistribute(mesh, ipl)
    grad = [Partial() if s and isinstance(p, Replicate) else p
            for s, p in zip(split, hpl)]
    rows = h.to_local(grad_placements=grad).index_select(0, idx.to_local())
    out_pl = [Shard(0) if s else p for s, p in zip(split, hpl)]
    return from_local(rows, mesh, out_pl, (idx.shape[0], *h.shape[1:]))


def forward(model, feats, edges, edge_mask, cfg: GINConfig, graph_ids=None,
            n_graphs: int = 0):
    """feats: [N, d_in]; edges: [2, E] (src, dst); edge_mask: [E] bool.

    Padded edges point at node 0 but are masked out of the aggregation:
    their messages are multiplied by 0, as the reference's are.
    """
    h = feats
    src, dst = edges[0], edges[1]
    keep = edge_mask[:, None].to(h.dtype)  # one [E, 1] mask for every layer
    for lp in model.layers:
        z = (1.0 + lp.eps) * h + aggregate(h, src, dst, keep)
        z = torch.relu(z @ lp.w1 + lp.b1)
        z = z @ lp.w2 + lp.b2
        h = layer_norm(z, lp.ln_scale, lp.ln_bias)
    if cfg.graph_readout:
        assert graph_ids is not None
        g = segment_sum(h, graph_ids, n_graphs)
        return g @ model.head + model.head_b
    return h @ model.head + model.head_b


def loss_fn(model, batch: dict, cfg: GINConfig):
    """batch: feats, edges, edge_mask, labels, label_mask (+ graph_ids).
    The mean NLL over the label mask (over every graph for the molecule
    case), its denominator at least 1."""
    if cfg.graph_readout:
        labels = batch["labels"]
        logits = forward(model, batch["feats"], batch["edges"], batch["edge_mask"],
                         cfg, graph_ids=batch["graph_ids"], n_graphs=labels.shape[0])
        mask = torch.ones(labels.shape[0], dtype=torch.float32, device=labels.device)
    else:
        logits = forward(model, batch["feats"], batch["edges"], batch["edge_mask"], cfg)
        labels = batch["labels"]
        mask = batch["label_mask"].float()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[:, None])[:, 0]
    return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


# ==========================================================================
# dst-aligned sharded message passing
# ==========================================================================
#
# Nodes AND edges are sharded over every mesh axis:
#
#   * the pipeline delivers edges grouped by destination shard
#     (``group_edges_by_dst_shard``): shard s holds only edges whose dst
#     lies in [s*N/S, (s+1)*N/S), padded + masked;
#   * per layer, all_gather the [N/S, d] node block (the ONLY collective),
#     gather sources locally, segment_sum into the LOCAL dst range (no
#     all-reduce), run the MLP on the local node block;
#   * the loss is a local masked CE + psum.

def _all_axes(mesh) -> tuple:
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data", "model") if a in names)


def param_tree(model) -> dict:
    """A ``GIN``'s parameters as the reference's tree (the same tensors)."""
    if isinstance(model, dict):
        return model
    keys = ("eps", "w1", "b1", "w2", "b2", "ln_scale", "ln_bias")
    return {"layers": [{k: getattr(l, k) for k in keys} for l in model.layers],
            "head": model.head, "head_b": model.head_b}


def forward_dst_sharded(model, feats_loc, edges_loc, edge_mask_loc, cfg: GINConfig,
                        axes: tuple, n_shards: int):
    """Body run per shard inside ``shard_map``: feats_loc [N/S, d];
    edges_loc [2, E/S] (dst in this shard's range).  ``model`` is a
    ``GIN`` or its tree.  The shard index is the axes' row-major index.
    Each layer's messages are rebuilt from the ids in the backward, as
    ``aggregate``'s are."""
    params = param_tree(model)
    n_loc = feats_loc.shape[0]
    dst_off = axis_index(axes) * n_loc
    h_loc = feats_loc
    src, dst = edges_loc[0], edges_loc[1] - dst_off
    keep = edge_mask_loc[:, None].to(torch.float32)
    mdt = torch.bfloat16 if cfg.message_dtype == "bfloat16" else torch.float32
    for lp in params["layers"]:
        # the ONLY collective: gather node blocks in message_dtype (bf16
        # halves the wire); segment accumulation stays f32
        h_full = all_gather(h_loc.to(mdt), axes)
        msg = h_full.index_select(0, src).to(torch.float32).mul_(keep)
        agg = segment_sum(msg, dst, n_loc)
        z = (1.0 + lp["eps"]) * h_loc + agg
        z = torch.relu(z @ lp["w1"] + lp["b1"])
        z = z @ lp["w2"] + lp["b2"]
        h_loc = layer_norm(z, lp["ln_scale"], lp["ln_bias"])
    return h_loc @ params["head"] + params["head_b"]


def loss_fn_dst_sharded(model, batch: dict, cfg: GINConfig, mesh=None):
    """batch: feats [N,d], edges [2,E] dst-grouped, edge_mask, labels,
    label_mask -- global tensors, split over every mesh axis (see
    ``batch_specs_sharded``); every rank gets the same loss.  Without a
    mesh (none given, none ambient) it is ``loss_fn``."""
    mesh = mesh or get_abstract_mesh()
    if mesh is None or not axis_names(mesh):
        return loss_fn(model, batch, cfg)
    axes = _all_axes(mesh)
    S = 1
    for a in axes:
        S *= axis_size(mesh, a)

    def body(feats, edges, emask, labels, lmask, params):
        logits = forward_dst_sharded(params, feats, edges, emask, cfg, axes, S)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, labels.long()[:, None])[:, 0]
        m = lmask.float()
        num = psum((nll * m).sum(), axes)
        den = psum(m.sum(), axes)
        return num / torch.clamp_min(den, 1.0)

    return shard_map(body, mesh,
                     (P(axes, None), P(None, axes), P(axes), P(axes), P(axes), P()),
                     P())(batch["feats"], batch["edges"], batch["edge_mask"],
                          batch["labels"], batch["label_mask"], param_tree(model))


def batch_specs_sharded(cfg: GINConfig, axes=("pod", "data", "model")):
    return {
        "feats": P(axes, None),
        "edges": P(None, axes),
        "edge_mask": P(axes),
        "labels": P(axes),
        "label_mask": P(axes),
    }


def group_edges_by_dst_shard(edges: np.ndarray, n_nodes: int, n_shards: int):
    """Host-side layout pass: group (+pad) edges so slice s holds only edges
    with dst in shard s's node range.  Returns (edges [2, S*E_loc], mask,
    E_loc)."""
    n_loc = n_nodes // n_shards
    owner = np.minimum(edges[1] // n_loc, n_shards - 1)
    counts = np.bincount(owner, minlength=n_shards)
    e_loc = int(counts.max()) if counts.size else 1
    out = np.zeros((2, n_shards * e_loc), edges.dtype)
    mask = np.zeros(n_shards * e_loc, bool)
    for s in range(n_shards):
        sel = np.flatnonzero(owner == s)
        out[:, s * e_loc : s * e_loc + sel.size] = edges[:, sel]
        # padding edges self-loop into the local range so indices stay local
        out[1, s * e_loc + sel.size : (s + 1) * e_loc] = s * n_loc
        mask[s * e_loc : s * e_loc + sel.size] = True
    return out, mask, e_loc


def param_specs(cfg: GINConfig, model_axis: str = "model"):
    """GIN is tiny -> replicate everything."""
    return tree_map(lambda _: P(), init_params_shape_tree(cfg))


def input_specs(cfg: GINConfig, n_nodes: int, n_edges: int, n_graphs: int = 0):
    """The dry run's inputs as ``meta`` tensors (shapes pre-padded by the
    caller)."""
    spec = {
        "feats": meta((n_nodes, cfg.d_in), torch.float32),
        "edges": meta((2, n_edges), torch.int32),
        "edge_mask": meta((n_edges,), torch.bool),
    }
    if cfg.graph_readout:
        spec["graph_ids"] = meta((n_nodes,), torch.int32)
        spec["labels"] = meta((n_graphs,), torch.int32)
    else:
        spec["labels"] = meta((n_nodes,), torch.int32)
        spec["label_mask"] = meta((n_nodes,), torch.bool)
    return spec


def batch_specs(cfg: GINConfig, data_axes=("pod", "data")):
    """PartitionSpecs: edges sharded over data axes, nodes replicated."""
    d = data_axes
    spec = {
        "feats": P(),
        "edges": P(None, d),
        "edge_mask": P(d),
    }
    if cfg.graph_readout:
        spec["graph_ids"] = P()
        spec["labels"] = P()
    else:
        spec["labels"] = P()
        spec["label_mask"] = P()
    return spec
