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
``launch.cells.make_train_step``) and ``loss_fn_dst_sharded`` without a
mesh.  The dst-sharded path and the mesh specs wait for the several-device
slice and raise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..api import resolve_device
from .common import dense_init, layer_norm, split_keys

A7E = ("the mesh machinery comes with the several-device slice of the port "
       "(ROADMAP Queue A 7, A7e)")


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

    def meta(s):
        return torch.empty(s, dtype=torch.float32, device="meta")

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
    into row ``segment_ids[i]`` of a zero ``[num_segments, ...]``."""
    return _SegmentSum.apply(data, segment_ids, num_segments)


def aggregate(h: torch.Tensor, src, dst, keep: torch.Tensor) -> torch.Tensor:
    """One layer's messages summed at their destinations: row v is the sum
    of ``h[src[e]] * keep[e]`` over the edges e with ``dst[e] == v``."""
    return segment_sum(h.index_select(0, src) * keep, dst, h.shape[0])


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
# dst-aligned sharded message passing: waits for the mesh (A7e)
# ==========================================================================

def forward_dst_sharded(model, feats_loc, edges_loc, edge_mask_loc, cfg: GINConfig,
                        axes: tuple, n_shards: int):
    raise NotImplementedError(f"forward_dst_sharded: {A7E}")


def loss_fn_dst_sharded(model, batch: dict, cfg: GINConfig, mesh=None):
    """Without a mesh, ``loss_fn`` (the reference's branch for no mesh);
    the sharded loss waits for the several-device slice."""
    if mesh is None:
        return loss_fn(model, batch, cfg)
    raise NotImplementedError(f"loss_fn_dst_sharded over a mesh: {A7E}")


def batch_specs_sharded(cfg: GINConfig, axes=("pod", "data", "model")):
    raise NotImplementedError(f"batch_specs_sharded: {A7E}")


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
    raise NotImplementedError(f"param_specs: {A7E}")


def input_specs(cfg: GINConfig, n_nodes: int, n_edges: int, n_graphs: int = 0):
    raise NotImplementedError(f"input_specs: {A7E}")


def batch_specs(cfg: GINConfig, data_axes=("pod", "data")):
    raise NotImplementedError(f"batch_specs: {A7E}")
