"""RecSys models: DCN-v2, DLRM, DIN and BST as an ``nn.Module``.

Counterpart of ``repro/models/recsys.py``.  The parameters keep the JAX
tree's names and layouts -- ``table``, ``cross[i].w/b``, ``mlp[i].w/b``,
``bot``/``top`` for DLRM, ``out``; ``item_table`` and ``attn[i].w/b`` for
DIN; ``item_table``, ``pos`` and ``blocks[i].{wqkv, wo, ln1, ln2, ff1,
ff2}`` for BST -- with every weight ``[in, out]`` (``x @ w + b``), so
carrying a JAX tree across is a copy (``repro_torch.convert``).  All
sparse tables of DCN-v2 and DLRM are ONE flat ``[n_sparse *
rows_per_field, embed_dim]`` table, with per-field offsets added to the
lookup ids; DIN and BST look their items up in one ``[item_vocab,
embed_dim]`` table.

Entry points as in the reference: ``forward`` (CTR logit), ``loss_fn``
(binary logloss), ``serve_score`` and ``retrieval_step`` (one user against
``n_candidates`` items, batched).  The sequential heads copy the
reference's numerics: the masked scores are filled with -1e30 before the
softmax, BST divides its scores by ``math.sqrt(dh)``, and the attention
runs as plain einsums (not ``scaled_dot_product_attention``, whose
masking and operation order differ).  The dry run's shardings and meta
tensors: ``param_specs``, ``input_specs`` and ``batch_specs``.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..api import resolve_device
from ..launch.mesh import P, from_local, is_dtensor, lookup_rows
from .common import (
    dense_init,
    meta,
    meta_tree,
    param_dict,
    rms_norm,
    split_keys,
    tree_map,
    unflatten,
)

KINDS = ("dcn", "dlrm", "din", "bst")
MASK_FILL = -1e30  # the reference's fill of masked scores


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(kind)


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str = "recsys"
    kind: str = "dcn"  # dcn | dlrm | din | bst
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 16
    rows_per_field: int = 1_000_000
    # dcn
    n_cross_layers: int = 3
    mlp: tuple = (1024, 1024, 512)
    # dlrm
    bot_mlp: tuple = (512, 256, 64)
    top_mlp: tuple = (512, 512, 256)
    # din / bst (sequential)
    seq_len: int = 0
    attn_mlp: tuple = (80, 40)
    n_blocks: int = 1
    n_heads: int = 8
    item_vocab: int = 2_000_000
    compute_dtype: torch.dtype = torch.float32

    @property
    def table_rows(self) -> int:
        return self.n_sparse * self.rows_per_field

    def param_count(self) -> int:
        return sum(math.prod(s) for s in param_shapes(self).values())


def _mlp_shapes(name: str, dims) -> dict:
    out = {}
    for i in range(len(dims) - 1):
        out[f"{name}.{i}.b"] = (dims[i + 1],)
        out[f"{name}.{i}.w"] = (dims[i], dims[i + 1])
    return out


def _block_shapes(i: int, d: int) -> dict:
    return {f"blocks.{i}.ff1": (d, 4 * d), f"blocks.{i}.ff2": (4 * d, d),
            f"blocks.{i}.ln1": (d,), f"blocks.{i}.ln2": (d,),
            f"blocks.{i}.wo": (d, d), f"blocks.{i}.wqkv": (d, 3 * d)}


def param_shapes(cfg: RecsysConfig) -> dict[str, tuple]:
    """Every parameter's dotted name and shape, in the JAX tree's leaf
    order (keys sorted: cross, mlp, out, table / bot, out, table, top /
    attn, item_table, mlp, out / blocks, item_table, mlp, out, pos)."""
    _check_kind(cfg.kind)
    d = cfg.embed_dim
    table = {"table": (cfg.table_rows, d)}
    items = {"item_table": (cfg.item_vocab, d)}
    if cfg.kind == "dcn":
        x0 = cfg.n_dense + cfg.n_sparse * d
        shapes = {}
        for i in range(cfg.n_cross_layers):
            shapes[f"cross.{i}.b"] = (x0,)
            shapes[f"cross.{i}.w"] = (x0, x0)
        return {**shapes, **_mlp_shapes("mlp", (x0, *cfg.mlp)),
                "out": (cfg.mlp[-1], 1), **table}
    if cfg.kind == "dlrm":
        nvec = cfg.n_sparse + 1
        inter = nvec * (nvec - 1) // 2 + cfg.bot_mlp[-1]
        return {**_mlp_shapes("bot", (cfg.n_dense, *cfg.bot_mlp)),
                "out": (cfg.top_mlp[-1], 1), **table,
                **_mlp_shapes("top", (inter, *cfg.top_mlp))}
    if cfg.kind == "din":
        return {**_mlp_shapes("attn", (4 * d, *cfg.attn_mlp, 1)), **items,
                **_mlp_shapes("mlp", (3 * d, 200, 80)), "out": (80, 1)}
    L = cfg.seq_len + 1
    blocks = {}
    for i in range(cfg.n_blocks):
        blocks.update(_block_shapes(i, d))
    return {**blocks, **items, **_mlp_shapes("mlp", (L * d, 1024, 512, 256)),
            "out": (256, 1), "pos": (L, d)}


def _mlp_init(gen, dims, device) -> list[dict]:
    ks = split_keys(gen, [str(i) for i in range(len(dims) - 1)])
    return [
        {"w": dense_init(ks[str(i)], (dims[i], dims[i + 1])),
         "b": torch.zeros((dims[i + 1],), device=device)}
        for i in range(len(dims) - 1)
    ]


def _init_sequential(gen: torch.Generator, cfg: RecsysConfig) -> dict:
    """DIN's and BST's trees.  Their keys are drawn from names of their own
    so that the dcn/dlrm draws from a seed stay as they were."""
    dev = gen.device
    ks = split_keys(gen, ["item", "attn", "blk", "mlp", "out", "pos"])
    d = cfg.embed_dim
    p = {"item_table": dense_init(ks["item"], (cfg.item_vocab, d), scale=0.01)}
    if cfg.kind == "din":
        p["attn"] = _mlp_init(ks["attn"], (4 * d, *cfg.attn_mlp, 1), dev)
        p["mlp"] = _mlp_init(ks["mlp"], (3 * d, 200, 80), dev)
        p["out"] = dense_init(ks["out"], (80, 1))
        return p
    L = cfg.seq_len + 1
    p["pos"] = dense_init(ks["pos"], (L, d), scale=0.02)
    kb = split_keys(ks["blk"], [str(i) for i in range(cfg.n_blocks)])
    p["blocks"] = []
    for i in range(cfg.n_blocks):
        k = split_keys(kb[str(i)], ["1", "2", "3", "4"])
        p["blocks"].append({
            "wqkv": dense_init(k["1"], (d, 3 * d)),
            "wo": dense_init(k["2"], (d, d)),
            "ln1": torch.ones((d,), device=dev),
            "ln2": torch.ones((d,), device=dev),
            "ff1": dense_init(k["3"], (d, 4 * d)),
            "ff2": dense_init(k["4"], (4 * d, d)),
        })
    p["mlp"] = _mlp_init(ks["mlp"], (L * d, 1024, 512, 256), dev)
    p["out"] = dense_init(ks["out"], (256, 1))
    return p


def init_params(gen: torch.Generator, cfg: RecsysConfig) -> dict:
    """The reference's parameter tree (nested dicts and lists of tensors),
    drawn on ``gen``'s device with the reference's initialisers."""
    _check_kind(cfg.kind)
    if cfg.kind in ("din", "bst"):
        return _init_sequential(gen, cfg)
    dev = gen.device
    ks = split_keys(gen, ["table", "cross", "mlp", "bot", "top", "out"])
    d = cfg.embed_dim
    p = {"table": dense_init(ks["table"], (cfg.table_rows, d), scale=0.01)}
    if cfg.kind == "dcn":
        x0 = cfg.n_dense + cfg.n_sparse * d
        kc = split_keys(ks["cross"], [str(i) for i in range(cfg.n_cross_layers)])
        p["cross"] = [
            {"w": dense_init(kc[str(i)], (x0, x0)),
             "b": torch.zeros((x0,), device=dev)}
            for i in range(cfg.n_cross_layers)
        ]
        p["mlp"] = _mlp_init(ks["mlp"], (x0, *cfg.mlp), dev)
        p["out"] = dense_init(ks["out"], (cfg.mlp[-1], 1))
    else:
        p["bot"] = _mlp_init(ks["bot"], (cfg.n_dense, *cfg.bot_mlp), dev)
        nvec = cfg.n_sparse + 1
        inter = nvec * (nvec - 1) // 2 + cfg.bot_mlp[-1]
        p["top"] = _mlp_init(ks["top"], (inter, *cfg.top_mlp), dev)
        p["out"] = dense_init(ks["out"], (cfg.top_mlp[-1], 1))
    return p


def init_params_shape_tree(cfg: RecsysConfig) -> dict:
    """``init_params``'s tree on the ``meta`` device: shapes and dtypes,
    no storage."""
    return meta_tree(param_shapes(cfg))


def param_specs(cfg: RecsysConfig, model_axis: str = "model"):
    """Everything replicated but the table, row-sharded over `model`."""
    specs = tree_map(lambda _: P(), init_params_shape_tree(cfg))
    if cfg.kind in ("dcn", "dlrm"):
        specs["table"] = P(model_axis, None)
    else:
        specs["item_table"] = P(model_axis, None)
    return specs


class Dense(nn.Module):
    """One ``x @ w + b`` layer with the reference's ``[in, out]`` weight."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)


class Block(nn.Module):
    """One BST transformer block: the reference's six leaves."""

    def __init__(self, wqkv, wo, ln1, ln2, ff1, ff2):
        super().__init__()
        self.wqkv, self.wo = nn.Parameter(wqkv), nn.Parameter(wo)
        self.ln1, self.ln2 = nn.Parameter(ln1), nn.Parameter(ln2)
        self.ff1, self.ff2 = nn.Parameter(ff1), nn.Parameter(ff2)


class Recsys(nn.Module):
    """A recsys model holding the reference's parameter tree.  Each
    parameter wraps its tree leaf without a copy."""

    def __init__(self, cfg: RecsysConfig, tree: dict):
        super().__init__()
        _check_kind(cfg.kind)
        self.cfg = cfg
        for key in sorted(tree):
            v = tree[key]
            if key == "blocks":
                setattr(self, key, nn.ModuleList(Block(**l) for l in v))
            elif isinstance(v, list):
                setattr(self, key, nn.ModuleList(Dense(l["w"], l["b"]) for l in v))
            else:
                setattr(self, key, nn.Parameter(v))

    def forward(self, batch: dict) -> torch.Tensor:
        return forward(self, batch, self.cfg)


def init_model(cfg: RecsysConfig, seed: int = 0, device="cuda") -> Recsys:
    """A model initialised from ``torch.Generator(device).manual_seed(seed)``
    on ``device`` (the card unless the caller asks for the CPU)."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    return Recsys(cfg, init_params(gen, cfg))


def _mlp_apply(layers, x, act=torch.relu, last_act: bool = True):
    for i, l in enumerate(layers):
        x = x @ l.w + l.b
        if last_act or i + 1 < len(layers):
            x = act(x)
    return x


# --------------------------------------------------------------------------
# Embedding lookup (the multi-hot bag goes through kernels/embedding_bag)
# --------------------------------------------------------------------------

def _reduce_rows(rows):
    """A row-sharded lookup's partial sums reduced once, as the reference's
    masked gather is followed by one all-reduce (left partial, each use in
    the head reduces them again)."""
    from torch.distributed.tensor import Partial, Replicate

    return rows.redistribute(rows.device_mesh, [
        Replicate() if isinstance(p, Partial) else p for p in rows.placements])


def embed_fields(table, sparse_ids, rows_per_field: int):
    """sparse_ids [B, F] per-field ids -> [B, F, d] (ids offset per field).
    The ids must lie in [0, rows_per_field): the reference's ``take`` would
    fill NaN, ``index_select`` raises."""
    B, F = sparse_ids.shape
    offs = torch.arange(F, device=sparse_ids.device) * rows_per_field
    if is_dtensor(table):  # the dry run
        return _reduce_rows(lookup_rows(table, sparse_ids.long() + offs[None, :]))
    idx = (sparse_ids.long() + offs[None, :]).reshape(-1)
    return table.index_select(0, idx).reshape(B, F, table.shape[1])


# --------------------------------------------------------------------------
# Forward per model kind
# --------------------------------------------------------------------------

def ctr_head(model, dense, emb, cfg: RecsysConfig):
    """dcn/dlrm logits [B] from the embedding block emb [B, F, d]."""
    if cfg.kind == "dcn":
        x0 = torch.cat([dense, emb.reshape(emb.shape[0], -1)], -1)
        x = x0
        for l in model.cross:
            x = x0 * (x @ l.w + l.b) + x  # DCN-v2 cross
        h = _mlp_apply(model.mlp, x)
        return (h @ model.out)[:, 0]
    dv = _mlp_apply(model.bot, dense)  # [B, bot_mlp[-1]]
    vecs = torch.cat([dv[:, None, :], emb], 1)  # [B, F + 1, d]
    gram = torch.einsum("bnd,bmd->bnm", vecs, vecs)
    n = vecs.shape[1]
    iu = torch.triu_indices(n, n, offset=1, device=gram.device)
    inter = gram[:, iu[0], iu[1]]  # [B, n(n-1)/2]
    h = _mlp_apply(model.top, torch.cat([dv, inter], -1))
    return (h @ model.out)[:, 0]


def take_items(table, ids):
    """``table[ids]`` for ids of any shape: [..., d] (the reference's
    ``jnp.take``; ids must lie in [0, item_vocab))."""
    if is_dtensor(table):  # the dry run
        return _reduce_rows(lookup_rows(table, ids))
    return table.index_select(0, ids.reshape(-1).long()).reshape(
        *ids.shape, table.shape[1])


def forward(model, batch: dict, cfg: RecsysConfig):
    _check_kind(cfg.kind)
    if cfg.kind in ("dcn", "dlrm"):
        emb = embed_fields(model.table, batch["sparse"], cfg.rows_per_field)
        return ctr_head(model, batch["dense"], emb, cfg)
    hist = take_items(model.item_table, batch["history"])  # [B, L, d]
    tgt = take_items(model.item_table, batch["target"])  # [B, d]
    head = _din_head if cfg.kind == "din" else _bst_head
    return head(model, hist, batch["hist_mask"], tgt, cfg)


def _din_head(model, hist, hist_mask, tgt, cfg: RecsysConfig):
    """hist [B, L, d], hist_mask [B, L] bool, tgt [B, d] -> logits [B]."""
    t = tgt[:, None, :].expand_as(hist)
    a_in = torch.cat([hist, t, hist - t, hist * t], -1)  # [B, L, 4d]
    scores = _mlp_apply(model.attn, a_in, act=torch.sigmoid, last_act=False)[..., 0]
    scores = torch.where(hist_mask, scores, MASK_FILL)
    w = torch.softmax(scores, -1)
    user = torch.einsum("bl,bld->bd", w, hist)
    h = _mlp_apply(model.mlp, torch.cat([user, tgt, user * tgt], -1))
    return (h @ model.out)[:, 0]


def _bst_head(model, hist, hist_mask, tgt, cfg: RecsysConfig):
    """hist [B, L, d], hist_mask [B, L] bool, tgt [B, d] -> logits [B]."""
    B, L, d = hist.shape
    x = torch.cat([hist, tgt[:, None, :]], 1) + model.pos[None]
    ones = torch.ones((B, 1), dtype=torch.bool, device=hist_mask.device)
    mask = torch.cat([hist_mask, ones], 1)  # [B, L + 1]
    H = cfg.n_heads
    dh = d // H
    for blk in model.blocks:
        h = rms_norm(x, blk.ln1)
        q, k, v = (t.reshape(B, L + 1, H, dh)
                   for t in (h @ blk.wqkv).split(d, -1))
        s = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(dh)
        s = torch.where(mask[:, None, None, :], s, MASK_FILL)
        p_attn = torch.softmax(s, -1)
        o = torch.einsum("bhst,bthd->bshd", p_attn, v).reshape(B, L + 1, d)
        x = x + o @ blk.wo
        h = rms_norm(x, blk.ln2)
        x = x + torch.relu(h @ blk.ff1) @ blk.ff2
    h = _mlp_apply(model.mlp, x.reshape(B, -1))
    return (h @ model.out)[:, 0]


def loss_fn(model, batch: dict, cfg: RecsysConfig):
    """Binary logloss, in the reference's stable form."""
    logits = forward(model, batch, cfg).float()
    y = batch["label"].float()
    return torch.mean(
        torch.clamp_min(logits, 0) - logits * y
        + torch.log1p(torch.exp(-logits.abs()))
    )


def serve_score(model, batch: dict, cfg: RecsysConfig):
    return forward(model, batch, cfg)


def _local_model(model):
    """``model`` over the local tensors of its replicated leaves, the
    row-sharded tables left out: the heads' weights in a local region (the
    dry run)."""
    leaves = {k: v.detach().to_local() for k, v in param_dict(model).items()
              if k not in ("table", "item_table")}
    return Recsys(model.cfg, unflatten(leaves)).requires_grad_(False)


def _per_candidate(fn, model, cand, *rows):
    """``fn(model, cand, *rows)``, whose result has one row a candidate.  On
    DTensors (the dry run) in a local region, as the reference's plan runs
    it: each rank scores its own candidates (``cand``'s block of rows over
    the axes that shard them) against the user's replicated ``rows``, with
    the replicated weights whole, and the result takes those candidates'
    placements.  (DTensor's broadcast of a replicated user row against
    sharded candidates either replicates the candidates or fails to view
    the sharded rows.)"""
    if not is_dtensor(cand):
        return fn(model, cand, *rows)
    from torch.distributed.tensor import Replicate, Shard

    mesh = cand.device_mesh
    pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
          for p in cand.placements]
    local = [r.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()
             if is_dtensor(r) else r for r in rows]
    out = fn(None if model is None else _local_model(model),
             cand.redistribute(mesh, pl).to_local(), *local)
    return from_local(out.contiguous(), mesh, pl, (cand.shape[0], *out.shape[1:]))


def _with_candidates(_model, cand, sparse):
    """The user's ``sparse`` ids [1, n_sparse] broadcast to the candidates,
    field 0 replaced by the candidate: [C, n_sparse]."""
    out = sparse.expand(cand.shape[0], sparse.shape[1]).clone()
    out[:, 0] = cand
    return out


def retrieval_step(model, batch: dict, cfg: RecsysConfig):
    """One user against ``candidates`` [C], one batched forward.  For
    dcn/dlrm the candidate replaces sparse field 0 and the user's other
    features are broadcast; for din/bst the candidate is the attention
    target of the user's broadcast history."""
    _check_kind(cfg.kind)
    cand = batch["candidates"]
    if cfg.kind in ("dcn", "dlrm"):
        sparse = _per_candidate(_with_candidates, None, cand, batch["sparse"])
        emb = embed_fields(model.table, sparse, cfg.rows_per_field)  # [C, F, d]

        def score(model, emb, dense):
            return ctr_head(model, dense.expand(emb.shape[0], cfg.n_dense), emb, cfg)

        return _per_candidate(score, model, emb, batch["dense"])
    hist = take_items(model.item_table, batch["history"])  # [1, L, d]
    tgt = take_items(model.item_table, cand)  # [C, d]
    head = _din_head if cfg.kind == "din" else _bst_head

    def score(model, tgt, hist, mask):
        C = tgt.shape[0]
        return head(model, hist.expand(C, *hist.shape[1:]),
                    mask.expand(C, mask.shape[1]), tgt, cfg)

    return _per_candidate(score, model, tgt, hist, batch["hist_mask"])


# --------------------------------------------------------------------------
# Dry-run input specs
# --------------------------------------------------------------------------

def input_specs(cfg: RecsysConfig, kind: str, batch: int, n_candidates: int = 0):
    """An entry point's inputs as ``meta`` tensors."""
    f32, i32 = torch.float32, torch.int32
    if kind == "retrieval":
        spec = {"candidates": meta((n_candidates,), i32)}
        if cfg.kind in ("dcn", "dlrm"):
            spec["dense"] = meta((1, cfg.n_dense), f32)
            spec["sparse"] = meta((1, cfg.n_sparse), i32)
        else:
            spec["history"] = meta((1, cfg.seq_len), i32)
            spec["hist_mask"] = meta((1, cfg.seq_len), torch.bool)
        return spec
    if cfg.kind in ("dcn", "dlrm"):
        spec = {
            "dense": meta((batch, cfg.n_dense), f32),
            "sparse": meta((batch, cfg.n_sparse), i32),
        }
    else:
        spec = {
            "history": meta((batch, cfg.seq_len), i32),
            "hist_mask": meta((batch, cfg.seq_len), torch.bool),
            "target": meta((batch,), i32),
        }
    if kind == "train":
        spec["label"] = meta((batch,), f32)
    return spec


def batch_specs(cfg: RecsysConfig, kind: str, data_axes=("pod", "data")):
    d = data_axes
    if kind == "retrieval":
        spec = {"candidates": P(d)}
        if cfg.kind in ("dcn", "dlrm"):
            spec.update({"dense": P(), "sparse": P()})
        else:
            spec.update({"history": P(), "hist_mask": P()})
        return spec
    if cfg.kind in ("dcn", "dlrm"):
        spec = {"dense": P(d), "sparse": P(d)}
    else:
        spec = {"history": P(d), "hist_mask": P(d), "target": P(d)}
    if kind == "train":
        spec["label"] = P(d)
    return spec
