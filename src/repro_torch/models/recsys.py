"""RecSys models: DCN-v2 and DLRM as an ``nn.Module``.

Counterpart of ``repro/models/recsys.py``.  The parameters keep the JAX
tree's names and layouts -- ``table``, ``cross[i].w/b``, ``mlp[i].w/b``,
``bot``/``top`` for DLRM, ``out`` -- with every weight ``[in, out]``
(``x @ w + b``), so carrying a JAX tree across is a copy
(``repro_torch.convert``).  All sparse tables are ONE flat
``[n_sparse * rows_per_field, embed_dim]`` table, with per-field offsets
added to the lookup ids.

Entry points as in the reference: ``forward`` (CTR logit), ``loss_fn``
(binary logloss), ``serve_score`` and ``retrieval_step`` (one user against
``n_candidates`` items, batched).  The sequential kinds (DIN, BST) come
with a later slice of the port (ROADMAP Queue A 7) and raise here.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..api import resolve_device
from .common import dense_init, split_keys


def _check_kind(kind: str) -> None:
    if kind in ("din", "bst"):
        raise NotImplementedError(
            f"the {kind} recsys kind is not ported yet: DIN/BST come with a "
            "later slice of the port (ROADMAP Queue A 7)")
    if kind not in ("dcn", "dlrm"):
        raise ValueError(kind)


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str = "recsys"
    kind: str = "dcn"  # dcn | dlrm (din | bst: a later slice)
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


def param_shapes(cfg: RecsysConfig) -> dict[str, tuple]:
    """Every parameter's dotted name and shape, in the JAX tree's leaf
    order (keys sorted: cross, mlp, out, table / bot, out, table, top)."""
    _check_kind(cfg.kind)
    d = cfg.embed_dim
    table = {"table": (cfg.table_rows, d)}
    if cfg.kind == "dcn":
        x0 = cfg.n_dense + cfg.n_sparse * d
        shapes = {}
        for i in range(cfg.n_cross_layers):
            shapes[f"cross.{i}.b"] = (x0,)
            shapes[f"cross.{i}.w"] = (x0, x0)
        return {**shapes, **_mlp_shapes("mlp", (x0, *cfg.mlp)),
                "out": (cfg.mlp[-1], 1), **table}
    nvec = cfg.n_sparse + 1
    inter = nvec * (nvec - 1) // 2 + cfg.bot_mlp[-1]
    return {**_mlp_shapes("bot", (cfg.n_dense, *cfg.bot_mlp)),
            "out": (cfg.top_mlp[-1], 1), **table,
            **_mlp_shapes("top", (inter, *cfg.top_mlp))}


def _mlp_init(gen, dims, device) -> list[dict]:
    ks = split_keys(gen, [str(i) for i in range(len(dims) - 1)])
    return [
        {"w": dense_init(ks[str(i)], (dims[i], dims[i + 1])),
         "b": torch.zeros((dims[i + 1],), device=device)}
        for i in range(len(dims) - 1)
    ]


def init_params(gen: torch.Generator, cfg: RecsysConfig) -> dict:
    """The reference's parameter tree (nested dicts and lists of tensors),
    drawn on ``gen``'s device with the reference's initialisers."""
    _check_kind(cfg.kind)
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


class Dense(nn.Module):
    """One ``x @ w + b`` layer with the reference's ``[in, out]`` weight."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)


class Recsys(nn.Module):
    """A DCN-v2 or DLRM model holding the reference's parameter tree."""

    def __init__(self, cfg: RecsysConfig, tree: dict):
        super().__init__()
        _check_kind(cfg.kind)
        self.cfg = cfg
        for key in sorted(tree):
            v = tree[key]
            if isinstance(v, list):
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

def embed_fields(table, sparse_ids, rows_per_field: int):
    """sparse_ids [B, F] per-field ids -> [B, F, d] (ids offset per field).
    The ids must lie in [0, rows_per_field): the reference's ``take`` would
    fill NaN, ``index_select`` raises."""
    B, F = sparse_ids.shape
    offs = torch.arange(F, device=sparse_ids.device) * rows_per_field
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


def forward(model, batch: dict, cfg: RecsysConfig):
    _check_kind(cfg.kind)
    emb = embed_fields(model.table, batch["sparse"], cfg.rows_per_field)
    return ctr_head(model, batch["dense"], emb, cfg)


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


def retrieval_step(model, batch: dict, cfg: RecsysConfig):
    """One user against ``candidates`` [C]: the candidate replaces sparse
    field 0, the user's other features are broadcast; one batched
    forward."""
    _check_kind(cfg.kind)
    cand = batch["candidates"]
    C = cand.shape[0]
    sparse = batch["sparse"].expand(C, cfg.n_sparse).clone()
    sparse[:, 0] = cand
    dense = batch["dense"].expand(C, cfg.n_dense)
    return forward(model, {"dense": dense, "sparse": sparse}, cfg)

