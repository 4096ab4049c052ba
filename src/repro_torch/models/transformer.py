"""Decoder-only transformer LM: dense and MoE, GQA, RoPE, SwiGLU, qk-norm,
QKV-bias, sliding-window attention, chunked (flash-style) attention,
a loop over stacked layers with remat.

Counterpart of ``repro/models/transformer.py`` for the five LM archs
(command-r-35b, qwen1.5-0.5b, qwen3-0.6b, moonshot-v1-16b-a3b,
mixtral-8x22b) through ``TransformerConfig``.  The parameters keep the
reference's tree -- ``embed`` [V, d], ``final_ln`` [d], ``lm_head`` [d, V]
and ``layers.*`` stacked ``[L, ...]`` -- held by a ``Transformer`` module
whose ``param_dict`` gives jax's leaf order.  Entry points as in the
reference:

  * ``lm_loss(model, tokens, labels, cfg)``   -- chunked cross-entropy,
    for ``launch.cells.make_train_step``;
  * ``prefill_step(model, tokens, cfg)``       -- last-position logits and
    a freshly built KV cache;
  * ``serve_step(model, cache, token, cache_pos, cfg)`` -- one decode step;
    it writes the new keys and values into ``cache`` in place (see there).

The numerics are the reference's: bf16 residual stream (``compute_dtype``)
over f32 parameters, q, k and v upcast to f32 in attention, masked scores
filled with -1e30 (not -inf), the two attention paths' own operation
order, RoPE on halves, ``lax.top_k``'s tie order in the router.  No
``scaled_dot_product_attention``: its masking and operation order differ.
The work runs as plain torch ops (the reference computes it in jnp and
``lax.scan`` outside any Pallas kernel).

The mesh machinery: ``param_specs`` / ``input_specs`` (the dry run's
shardings and meta tensors), ``maybe_shard`` (a redistribute of a DTensor
inside ``launch.mesh.set_mesh``, else the identity) and, with
``cfg.moe_shard_map``, ``moe_ffn_shard_map``: the MoE over the ambient
mesh's explicit collectives (``launch.mesh.shard_map``), an
``all_to_all`` of the capacity buffer over ``model`` when the experts
split over it (EP), else a token-sized ``psum`` of each rank's slice of
every expert (TP-in-expert).  On DTensors (the dry run) the attention,
the embedding lookup, the loss's vocabulary and the prefill's cache take
local regions or explicit redistributes (``_attend``, ``lookup_rows``),
as do a training step's projections to its own heads
(``_attend_own_heads``), a decode cache split over its slots
(``_split_k_attention``) and a decode step's few tokens through the MoE
(``_moe_replicated``); the layer input's cotangents sum once
(``_sum_cotangents``) and the remat keeps the reference's saved products
(``_remat_policy``).  Plain tensors take the paths above unchanged.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..api import resolve_device
from ..launch.mesh import (
    P,
    all_to_all,
    axis_names,
    axis_size,
    data_axes,
    from_local,
    get_abstract_mesh,
    is_dtensor,
    keep_axes,
    lookup_rows,
    pmax,
    pmean,
    psum,
    shard_map,
    spec_to_placements,
)
from .common import dense_init, meta, meta_tree, rms_norm, split_keys

_BATCH = P(("pod", "data"), None, None)  # activations: batch over the data axes
MASK_FILL = -1e30  # the reference's fill of masked scores and first max
I32_MAX = 2**31 - 1  # position of a cache slot that holds nothing yet


def maybe_shard(x: torch.Tensor, spec) -> torch.Tensor:
    """``with_sharding_constraint`` that degrades gracefully: inside
    ``set_mesh`` a DTensor is redistributed to ``spec`` (the axis names the
    mesh lacks dropped, so one spec serves the single-pod mesh, the
    multi-pod mesh and none); a plain tensor, global on every rank, and
    anything outside a mesh pass as they are."""
    mesh = get_abstract_mesh()
    if mesh is None or not axis_names(mesh) or not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, spec_to_placements(
        keep_axes(spec, mesh), mesh, x.ndim))


def _sum_cotangents(x: torch.Tensor) -> torch.Tensor:
    """The identity.  On a DTensor (the dry run) its backward reduces the
    cotangent to ``x``'s placements, as Megatron's all-reduce of a
    column-parallel input's gradient: the partial cotangents that each
    rank's heads or ff slice leave are summed here once, so the backward of
    the layer runs on whole ones.  (Left partial, DTensor reduce-scatters
    them onto the next product's contraction and gathers its weight
    whole.)"""
    if not is_dtensor(x):
        return x
    return from_local(x.to_local(), x.device_mesh, x.placements, x.shape)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str = "lm"
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    d_head: int = 32
    d_ff: int = 512
    vocab: int = 1024
    qkv_bias: bool = False
    qk_norm: bool = False
    # MoE (n_experts == 0 -> dense FFN)
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_groups: int = 1  # GShard-style groups: positions and capacity per group
    moe_shard_map: bool = False  # explicit-collective MoE (moe_ffn_shard_map)
    # attention
    sliding_window: int = 0  # 0 => full causal attention
    rope_theta: float = 10_000.0
    attn_chunk: int = 1024  # flash-style chunking threshold / block
    loss_chunk: int = 512  # sequence chunking for the CE loss
    # numerics
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    remat: bool = True

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head

    def param_count(self) -> int:
        c = self
        attn = c.d_model * (c.q_dim + 2 * c.kv_dim) + c.q_dim * c.d_model
        if c.qkv_bias:
            attn += c.q_dim + 2 * c.kv_dim
        if c.qk_norm:
            attn += 2 * c.d_head
        if c.is_moe:
            ffn = c.n_experts * 3 * c.d_model * c.d_ff + c.d_model * c.n_experts
        else:
            ffn = 3 * c.d_model * c.d_ff
        per_layer = attn + ffn + 2 * c.d_model
        return c.n_layers * per_layer + 2 * c.vocab * c.d_model + c.d_model

    def active_param_count(self) -> int:
        """Activated params per token (MoE counts top_k experts only)."""
        if not self.is_moe:
            return self.param_count()
        c = self
        attn = c.d_model * (c.q_dim + 2 * c.kv_dim) + c.q_dim * c.d_model
        ffn = c.top_k * 3 * c.d_model * c.d_ff + c.d_model * c.n_experts
        per_layer = attn + ffn + 2 * c.d_model
        return c.n_layers * per_layer + 2 * c.vocab * c.d_model + c.d_model


# ==========================================================================
# Parameters (stacked [L, ...] leaves)
# ==========================================================================

def param_shapes(cfg: TransformerConfig) -> dict[str, tuple]:
    """Every leaf's dotted name and shape, in jax's leaf order."""
    L, d, q, kv, ff, V = (cfg.n_layers, cfg.d_model, cfg.q_dim, cfg.kv_dim,
                          cfg.d_ff, cfg.vocab)
    layers = {"ln1": (L, d), "ln2": (L, d), "wk": (L, d, kv), "wo": (L, q, d),
              "wq": (L, d, q), "wv": (L, d, kv)}
    if cfg.qkv_bias:
        layers.update(bq=(L, q), bk=(L, kv), bv=(L, kv))
    if cfg.qk_norm:
        layers.update(q_norm=(L, cfg.d_head), k_norm=(L, cfg.d_head))
    if cfg.is_moe:
        E = cfg.n_experts
        layers.update(router=(L, d, E), w1=(L, E, d, ff), w3=(L, E, d, ff),
                      w2=(L, E, ff, d))
    else:
        layers.update(w1=(L, d, ff), w3=(L, d, ff), w2=(L, ff, d))
    return {"embed": (V, d), "final_ln": (d,),
            **{f"layers.{k}": layers[k] for k in sorted(layers)},
            "lm_head": (d, V)}


def init_params(gen: torch.Generator, cfg: TransformerConfig) -> dict:
    """The reference's parameter tree, drawn on ``gen``'s device with the
    reference's initialisers (other numbers than jax's for one seed)."""
    L, d, q, kv, ff, V = (cfg.n_layers, cfg.d_model, cfg.q_dim, cfg.kv_dim,
                          cfg.d_ff, cfg.vocab)
    dev = gen.device
    ks = split_keys(gen, ["embed", "head", "wq", "wk", "wv", "wo", "ffn1",
                          "ffn2", "ffn3", "router"])
    pd = cfg.param_dtype
    layers: dict[str, torch.Tensor] = {
        "wq": dense_init(ks["wq"], (L, d, q), dtype=pd),
        "wk": dense_init(ks["wk"], (L, d, kv), dtype=pd),
        "wv": dense_init(ks["wv"], (L, d, kv), dtype=pd),
        "wo": dense_init(ks["wo"], (L, q, d), dtype=pd),
        "ln1": torch.ones((L, d), dtype=pd, device=dev),
        "ln2": torch.ones((L, d), dtype=pd, device=dev),
    }
    if cfg.qkv_bias:
        layers["bq"] = torch.zeros((L, q), dtype=pd, device=dev)
        layers["bk"] = torch.zeros((L, kv), dtype=pd, device=dev)
        layers["bv"] = torch.zeros((L, kv), dtype=pd, device=dev)
    if cfg.qk_norm:
        layers["q_norm"] = torch.ones((L, cfg.d_head), dtype=pd, device=dev)
        layers["k_norm"] = torch.ones((L, cfg.d_head), dtype=pd, device=dev)
    if cfg.is_moe:
        E = cfg.n_experts
        layers["router"] = dense_init(ks["router"], (L, d, E), dtype=pd)
        layers["w1"] = dense_init(ks["ffn1"], (L, E, d, ff), dtype=pd)
        layers["w3"] = dense_init(ks["ffn3"], (L, E, d, ff), dtype=pd)
        layers["w2"] = dense_init(ks["ffn2"], (L, E, ff, d), dtype=pd)
    else:
        layers["w1"] = dense_init(ks["ffn1"], (L, d, ff), dtype=pd)
        layers["w3"] = dense_init(ks["ffn3"], (L, d, ff), dtype=pd)
        layers["w2"] = dense_init(ks["ffn2"], (L, ff, d), dtype=pd)
    return {
        "embed": dense_init(ks["embed"], (V, d), scale=0.02, dtype=pd),
        "layers": layers,
        "final_ln": torch.ones((d,), dtype=pd, device=dev),
        "lm_head": dense_init(ks["head"], (d, V), dtype=pd),
    }


class Layers(nn.Module):
    """The stacked ``[L, ...]`` leaves of every layer, by the reference's
    names."""

    def __init__(self, tree: dict):
        super().__init__()
        for k in sorted(tree):
            setattr(self, k, nn.Parameter(tree[k]))


class Transformer(nn.Module):
    """An LM holding the reference's parameter tree.  Each parameter wraps
    its tree leaf without a copy."""

    def __init__(self, cfg: TransformerConfig, tree: dict):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(tree["embed"])
        self.final_ln = nn.Parameter(tree["final_ln"])
        self.layers = Layers(tree["layers"])
        self.lm_head = nn.Parameter(tree["lm_head"])

    def forward(self, tokens: torch.Tensor, positions=None):
        return forward(self, tokens, self.cfg, positions)


def init_model(cfg: TransformerConfig, seed: int = 0, device="cuda") -> Transformer:
    """A model initialised from ``torch.Generator(device).manual_seed(seed)``
    on ``device`` (the card unless the caller asks for the CPU)."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    return Transformer(cfg, init_params(gen, cfg))


def layer_params(model) -> list[dict[str, torch.Tensor]]:
    """Each layer's leaves (views of the stacked ``[L, ...]`` parameters,
    one ``unbind`` a leaf, so the backward stacks each leaf's gradient
    once)."""
    names = sorted(n for n, _ in model.layers.named_parameters())
    per = zip(*(getattr(model.layers, n).unbind(0) for n in names))
    return [dict(zip(names, vals)) for vals in per]


def init_params_shape_tree(cfg: TransformerConfig) -> dict:
    """``init_params``'s tree on the ``meta`` device: shapes and dtypes,
    no storage."""
    return meta_tree(param_shapes(cfg), cfg.param_dtype)


def param_specs(cfg: TransformerConfig, model_axis: str = "model", tp: int = 16):
    """PartitionSpec tree matching init_params (Megatron TP over `model`)."""
    m = model_axis
    kv_shardable = cfg.n_kv_heads % tp == 0
    layers: dict[str, Any] = {
        "wq": P(None, None, m),
        "wk": P(None, None, m) if kv_shardable else P(None, None, None),
        "wv": P(None, None, m) if kv_shardable else P(None, None, None),
        "wo": P(None, m, None),
        "ln1": P(None, None),
        "ln2": P(None, None),
    }
    if cfg.qkv_bias:
        layers["bq"] = P(None, m)
        layers["bk"] = P(None, m) if kv_shardable else P(None, None)
        layers["bv"] = P(None, m) if kv_shardable else P(None, None)
    if cfg.qk_norm:
        layers["q_norm"] = P(None, None)
        layers["k_norm"] = P(None, None)
    if cfg.is_moe:
        if cfg.n_experts % tp == 0:  # expert parallelism over `model`
            layers["router"] = P(None, None, None)
            layers["w1"] = P(None, m, None, None)
            layers["w3"] = P(None, m, None, None)
            layers["w2"] = P(None, m, None, None)
        else:  # TP inside each expert
            layers["router"] = P(None, None, None)
            layers["w1"] = P(None, None, None, m)
            layers["w3"] = P(None, None, None, m)
            layers["w2"] = P(None, None, m, None)
    else:
        layers["w1"] = P(None, None, m)
        layers["w3"] = P(None, None, m)
        layers["w2"] = P(None, m, None)
    return {
        "embed": P(m, None),
        "layers": layers,
        "final_ln": P(None),
        "lm_head": P(None, m),
    }


def input_specs(cfg: TransformerConfig, shape_kind: str, seq_len: int, batch: int):
    """Each entry point's inputs as ``meta`` tensors (the dry run's)."""
    tok = meta((batch, seq_len), torch.int32)
    if shape_kind == "train":
        return {"tokens": tok, "labels": meta((batch, seq_len), torch.int32)}
    if shape_kind == "prefill":
        return {"tokens": tok}
    if shape_kind == "decode":
        Sc = min(seq_len, cfg.sliding_window) if cfg.sliding_window > 0 else seq_len
        cache = meta((cfg.n_layers, 2, batch, Sc, cfg.n_kv_heads, cfg.d_head),
                     cfg.compute_dtype)
        return {"cache": cache, "token": meta((batch,), torch.int32)}
    raise ValueError(shape_kind)


# ==========================================================================
# RoPE
# ==========================================================================

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions: [..., S].  Rotates the two halves of
    each head (not pairs), in f32."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32, device=x.device)
                      / half)
    ang = positions[..., None].float() * freqs  # [..., S, half]
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# ==========================================================================
# Attention
# ==========================================================================

def _attn_scores_mask(q_pos, k_pos, window: int):
    """[Sq, Sk] bool mask: causal, optionally sliding-window."""
    m = k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        m &= k_pos[None, :] > (q_pos[:, None] - window)
    return m


def _f32_heads(x, *perm):
    """``x.permute(*perm)`` upcast to f32 in one contiguous copy (the
    upcast is exact; the layout puts each (batch, kv head) pair's rows
    together for ``bmm``)."""
    x = x.permute(*perm)
    return torch.empty(x.shape, dtype=torch.float32, device=x.device).copy_(x)


def full_attention(q, k, v, q_pos, k_pos, window: int):
    """q: [B,Sq,H,D]; k,v: [B,Sk,KV,D].  Materializes [Sq,Sk] scores; head
    h is group ``h // G`` of the kv heads (``q.reshape(B,S,KV,G,D)``)."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = _f32_heads(q.reshape(B, Sq, KV, G, D), 0, 2, 3, 1, 4)  # [B,KV,G,Sq,D]
    kf = _f32_heads(k, 0, 2, 1, 3)  # [B,KV,Sk,D]
    vf = _f32_heads(v, 0, 2, 1, 3)
    s = torch.bmm(qf.view(B * KV, G * Sq, D), kf.view(B * KV, Sk, D).transpose(1, 2))
    s = s.view(B, KV, G, Sq, Sk) * (1.0 / math.sqrt(D))
    mask = _attn_scores_mask(q_pos, k_pos, window)
    s = torch.where(mask[None, None, None], s, MASK_FILL)
    p = torch.softmax(s, -1)
    o = torch.bmm(p.view(B * KV, G * Sq, Sk), vf.view(B * KV, Sk, D))
    o = o.view(B, KV, G, Sq, D).permute(0, 3, 1, 2, 4)
    return o.reshape(B, Sq, H, D).to(q.dtype)


def _live_blocks(qpc, kpc, window: int) -> list[list[tuple[int, bool]]]:
    """For each q chunk, ``(kv chunk, partly masked)`` for the kv chunks
    holding any pair the mask keeps.  A chunk with none leaves the online
    softmax's (max, denom, acc) as they are, bit for bit (its scores are
    all -1e30 and its weights 0), so the loop skips it; a chunk whose
    every pair is kept needs no mask (``where`` keeps every score, the
    mask multiplies by 1).  One host read of the chunks' position
    ranges."""
    nq, nk = qpc.shape[0], kpc.shape[0]
    r = torch.cat([qpc.amin(1), qpc.amax(1), kpc.amin(1), kpc.amax(1)]).tolist()
    qlo, qhi = r[:nq], r[nq:2 * nq]
    klo, khi = r[2 * nq:2 * nq + nk], r[2 * nq + nk:]
    live = []
    for a, b in zip(qlo, qhi):
        row = []
        for j, (c, e) in enumerate(zip(klo, khi)):
            if c <= b and (window <= 0 or e > a - window):
                whole = e <= a and (window <= 0 or c > b - window)
                row.append((j, not whole))
        live.append(row)
    return live


def _split_k_attention(q, k, v, q_pos, k_pos, window: int, axes):
    """``full_attention`` over keys whose sequence is split over the mesh
    ``axes`` (a decode cache, the reference's split-K): each rank scores
    its block of the slots, and the softmax combines over ``axes`` (the
    scores' max, then the sums of the weights and of the weighted values).
    Inside ``_attend``'s local region; ``k_pos`` is this block's."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = _f32_heads(q.reshape(B, Sq, KV, G, D), 0, 2, 3, 1, 4)  # [B,KV,G,Sq,D]
    kf = _f32_heads(k, 0, 2, 1, 3)  # [B,KV,Sk,D]
    vf = _f32_heads(v, 0, 2, 1, 3)
    s = torch.bmm(qf.view(B * KV, G * Sq, D), kf.view(B * KV, Sk, D).transpose(1, 2))
    s = s.view(B, KV, G, Sq, Sk) * (1.0 / math.sqrt(D))
    mask = _attn_scores_mask(q_pos, k_pos, window)
    s = torch.where(mask[None, None, None], s, MASK_FILL)
    p = torch.exp(s - pmax(s.amax(-1, keepdim=True), axes))
    l = psum(p.sum(-1), axes)  # [B,KV,G,Sq]
    o = psum(torch.bmm(p.view(B * KV, G * Sq, Sk), vf.view(B * KV, Sk, D)), axes)
    o = o.view(B, KV, G, Sq, D) / l[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


def _attend(fn, q, k, v, *rest):
    """``fn(q, k, v, *rest)``; on DTensors (the dry run) in a local region:
    each rank attends its batch rows and its query heads with the kv heads
    they read (all heads are independent), then the result is a DTensor of
    q's placements.  Keys whose sequence is sharded (a decode cache, ``fn``
    ``full_attention``) stay so: q is gathered over those axes, and each
    rank attends its block of the slots (``_split_k_attention``).  No
    gradient flows here on DTensors: a training step attends in
    ``_attend_own_heads``."""
    if not is_dtensor(q):
        return fn(q, k, v, *rest)
    from torch.distributed.tensor import Replicate, Shard

    mesh = q.device_mesh
    seq = [i for i, p in enumerate(k.placements) if isinstance(p, Shard) and p.dim == 1]
    qpl = [p if isinstance(p, Shard) and p.dim in (0, 2) and i not in seq else Replicate()
           for i, p in enumerate(q.placements)]
    kv_heads = k.shape[2]
    n_head_shards = math.prod(mesh.size(i) for i, p in enumerate(qpl)
                              if isinstance(p, Shard) and p.dim == 2)
    kv_split = kv_heads % n_head_shards == 0
    kpl = [Shard(1) if i in seq else
           p if isinstance(p, Shard) and (p.dim == 0 or kv_split) else Replicate()
           for i, p in enumerate(qpl)]
    ql = q.redistribute(mesh, qpl).to_local()
    kl, vl = (t.redistribute(mesh, kpl).to_local() for t in (k, v))
    if not kv_split:  # this rank's query heads read a slice of the kv heads
        G = q.shape[2] // kv_heads
        coord, block = mesh.get_coordinate(), 0
        for i, p in enumerate(qpl):
            if isinstance(p, Shard) and p.dim == 2:
                block = block * mesh.size(i) + coord[i]
        h0 = block * ql.shape[2]
        lo, hi = h0 // G, (h0 + ql.shape[2] - 1) // G + 1
        kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
    if seq:
        q_pos, k_pos, window = rest
        coord, block = mesh.get_coordinate(), 0
        for i in seq:
            block = block * mesh.size(i) + coord[i]
        n = kl.shape[1]
        out = _split_k_attention(ql, kl, vl, q_pos, k_pos[block * n:(block + 1) * n],
                                 window, tuple(mesh.mesh_dim_names[i] for i in seq))
    else:
        out = fn(ql, kl, vl, *rest)
    return from_local(out.contiguous(), mesh, qpl, q.shape)


def _host_live_blocks(q_pos, k_pos, nq: int, nk: int, window: int):
    """``_live_blocks`` of the positions' chunks, read from real tensors
    also under a fake mode (the dry run's positions are real)."""
    from torch._subclasses.fake_tensor import FakeTensor, unset_fake_temporarily

    if isinstance(q_pos, FakeTensor) or isinstance(k_pos, FakeTensor):
        return _live_blocks(q_pos.reshape(nq, -1), k_pos.reshape(nk, -1), window)
    with unset_fake_temporarily():
        return _live_blocks(q_pos.reshape(nq, -1), k_pos.reshape(nk, -1), window)


def chunked_attention(q, k, v, q_pos, k_pos, window: int, chunk: int):
    """Flash-style online-softmax attention, O(chunk^2) live scores.

    An outer loop over q chunks, an inner one over kv chunks with the
    running (max, denom, acc) carried in f32; q is scaled before its
    scores (the full path scales the scores).
    """
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    C = chunk
    nq = S // C
    nk = k.shape[1] // C
    scale = 1.0 / math.sqrt(D)
    # [nq, B, KV, G, C, D] and [nk, B, KV, C, D]: one chunk's rows together
    qf = _f32_heads(q.reshape(B, nq, C, KV, G, D), 1, 0, 3, 4, 2, 5) * scale
    kf = _f32_heads(k.reshape(B, nk, C, KV, D), 1, 0, 3, 2, 4)
    vf = _f32_heads(v.reshape(B, nk, C, KV, D), 1, 0, 3, 2, 4)
    qpc = q_pos.reshape(nq, C)
    kpc = k_pos.reshape(nk, C)
    out = []
    for qi, live in enumerate(_host_live_blocks(q_pos, k_pos, nq, nk, window)):
        qb = qf[qi].view(B * KV, G * C, D)
        m = torch.full((B, KV, G, C), MASK_FILL, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, KV, G, C), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, KV, G, C, D), dtype=torch.float32, device=q.device)
        for ki, partial in live:
            s = torch.bmm(qb, kf[ki].view(B * KV, C, D).transpose(1, 2))
            s = s.view(B, KV, G, C, C)
            if partial:
                mask = _attn_scores_mask(qpc[qi], kpc[ki], window)[None, None, None]
                s = torch.where(mask, s, MASK_FILL)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            if partial:
                p = p * mask
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = torch.bmm(p.view(B * KV, G * C, C), vf[ki].view(B * KV, C, D))
            acc = acc * corr[..., None] + pv.view(B, KV, G, C, D)
            m = m_new
        o = acc / torch.clamp_min(l, 1e-30)[..., None]  # [B,KV,G,C,D]
        out.append(o.permute(0, 3, 1, 2, 4).reshape(B, C, H, D))
    return torch.stack(out, 1).reshape(B, S, H, D).to(q.dtype)


# ==========================================================================
# FFN (dense SwiGLU / MoE with cumsum dispatch)
# ==========================================================================

def _silu(x):
    """``jax.nn.silu``: x * sigmoid(x), each op rounded in x's dtype."""
    return x * torch.sigmoid(x)


def dense_ffn(x, w1, w3, w2):
    h = _silu(x @ w1) * (x @ w3)
    return h @ w2


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last axis, ties broken by the
    lower index (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(x, router, w1, w3, w2, cfg: TransformerConfig):
    """Sort-free top-k dispatch: cumsum position assignment.

    x: [T, d].  Returns ([T, d], aux_loss).  Tokens split into
    ``moe_groups`` groups; within a group, a token's position in an expert
    is the exclusive cumsum of the group's assignment mask; a position at
    or past the capacity is dropped (its row zeroed, its slot clamped to
    ``cap - 1``, its gate zeroed).  The dispatch is a scatter-add
    (``index_put_(accumulate=True)``, deterministic on the card under
    ``torch.use_deterministic_algorithms``), the combine a gather.  The
    aux (Switch) loss counts the assignments before the capacity cut.
    """
    T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    G = max(1, min(cfg.moe_groups, T))
    while T % G:
        G //= 2
    Tg = T // G
    logits = x.float() @ router.float()  # [T, E]
    probs = torch.softmax(logits, -1)
    gates, idx = _top_k(probs, k)  # [T, k]
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)

    cap = int(math.ceil(Tg * k / E * cfg.capacity_factor))
    cap = max(cap, 4)
    idx_g = idx.reshape(G, Tg, k)
    # assignment mask [G, Tg, E] (top-k indices are distinct: 0 or 1)
    mask = F.one_hot(idx_g, E).sum(2)
    pos_te = torch.cumsum(mask, 1) - mask  # exclusive, within each group
    pos = torch.gather(pos_te, 2, idx_g)  # [G, Tg, k]
    keep = pos < cap
    pos_c = torch.where(keep, pos, cap - 1)

    g_i = torch.arange(G, device=x.device)[:, None].expand(G, Tg * k)
    e_i, p_i = idx_g.reshape(G, Tg * k), pos_c.reshape(G, Tg * k)
    xk = torch.where(keep[..., None], x.reshape(G, Tg, 1, d), 0)  # [G,Tg,k,d]
    buf = torch.zeros((G, E, cap, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((g_i, e_i, p_i), xk.reshape(G, Tg * k, d),
                        accumulate=True)
    ep = E % 16 == 0
    buf = maybe_shard(buf, P(("pod", "data"), "model" if ep else None, None, None))
    h = _silu(torch.einsum("gecd,edf->gecf", buf, w1)) * torch.einsum(
        "gecd,edf->gecf", buf, w3)
    y = torch.einsum("gecf,efd->gecd", h, w2)  # [G, E, cap, d]
    # combine by GATHER within the group: out[g,t] = sum_j gate_j * y[g,e_j,pos_j]
    yk = y[g_i, e_i, p_i].reshape(G, Tg, k, d)
    out = torch.einsum("gtk,gtkd->gtd",
                       (gates.reshape(G, Tg, k) * keep).to(yk.dtype),
                       yk).reshape(T, d)
    # aux load-balancing loss (Switch-style)
    me = probs.mean(0)
    ce = mask.sum((0, 1)).float() / (T * k)
    aux = E * torch.sum(me * ce)
    return out.to(x.dtype), aux


def _moe_local(x, router, w1, w3, w2, cfg: TransformerConfig, n_local_experts: int,
               model_axis: str | None, data_axes_names: tuple = ()):
    """Per-rank MoE body run inside ``shard_map``.

    x: [T_local, d] (this rank's tokens).  Dispatch positions are computed
    locally (one GShard group a rank).  Two modes:
      * TP-in-expert (w1 local [E, d, ff/tp]): a partial y, combined
        locally, then a ``psum`` of the TOKEN-sized output over `model`,
        kept in the compute dtype;
      * EP (w1 local [E/tp, d, ff]): ``all_to_all`` of the capacity buffer
        over `model`, so each rank computes its resident experts, then
        back.
    The aux loss is ``pmean``ed over the data axes and `model`.
    """
    T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    logits = x.float() @ router.float()
    probs = torch.softmax(logits, -1)
    gates, idx = _top_k(probs, k)
    gates = (gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)).to(x.dtype)

    cap = max(4, int(math.ceil(T * k / E * cfg.capacity_factor)))
    mask = F.one_hot(idx, E).sum(1)  # [T, E] (top-k indices are distinct)
    pos = torch.gather(torch.cumsum(mask, 0) - mask, 1, idx)
    keep = pos < cap
    pos_c = torch.where(keep, pos, cap - 1)

    e_i, p_i = idx.reshape(-1), pos_c.reshape(-1)
    xk = torch.where(keep[..., None], x[:, None, :], 0)
    buf = torch.zeros((E, cap, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((e_i, p_i), xk.reshape(T * k, d), accumulate=True)

    ep = n_local_experts < E
    if ep and model_axis is not None:
        tp = E // n_local_experts
        # [E, cap, d] -> [tp, E/tp, cap, d]; after the all_to_all over
        # model, dim 0 is the source rank: -> [E/tp, tp*cap, d]
        bufe = all_to_all(buf.reshape(tp, n_local_experts, cap, d), model_axis)
        bufe = bufe.transpose(0, 1).reshape(n_local_experts, tp * cap, d)
        h = _silu(torch.einsum("ecd,edf->ecf", bufe, w1)) * torch.einsum(
            "ecd,edf->ecf", bufe, w3)
        y = torch.einsum("ecf,efd->ecd", h, w2)
        y = y.reshape(n_local_experts, tp, cap, d).transpose(0, 1).contiguous()
        y = all_to_all(y, model_axis).reshape(E, cap, d)
    else:
        h = _silu(torch.einsum("ecd,edf->ecf", buf, w1)) * torch.einsum(
            "ecd,edf->ecf", buf, w3)
        y = torch.einsum("ecf,efd->ecd", h, w2)  # partial over model when TP

    yk = y[e_i, p_i].reshape(T, k, d)
    out = torch.einsum("tk,tkd->td", gates * keep.to(gates.dtype), yk)
    if not ep and model_axis is not None:
        # keep the wire in the compute dtype: the operand is not upcast
        out = psum(out.to(x.dtype), model_axis)
    me = probs.mean(0)
    ce = mask.sum(0).float() / (T * k)
    aux = E * torch.sum(me * ce)
    for ax in data_axes_names:
        aux = pmean(aux, ax)
    if model_axis is not None:
        aux = pmean(aux, model_axis)
    return out.to(x.dtype), aux


def _moe_replicated(x, router, w1, w3, w2, cfg: TransformerConfig, mesh):
    """``moe_ffn`` of DTensors (the dry run) whose tokens cannot shard over
    the mesh (a decode step's few), in a local region as the reference's
    plan runs it: every rank dispatches every token against its slice of
    each expert's ff dimension (TP-in-expert; expert-parallel weights are
    moved to it), and the token-sized partial result sums over `model`.
    (DTensor's rules fail to view the dispatch buffer's group dimension,
    of size 1, sharded over the data axes.)"""
    w_spec, w2_spec = P(None, None, "model"), P(None, "model", None)

    def body(xl, rl, w1l, w3l, w2l):
        out, aux = moe_ffn(xl, rl, w1l, w3l, w2l, cfg)
        return psum(out, "model"), aux

    return shard_map(body, mesh, (P(None, None), P(None, None), w_spec, w_spec, w2_spec),
                     (P(None, None), P()))(x, router, w1, w3, w2)


def moe_ffn_shard_map(x, router, w1, w3, w2, cfg: TransformerConfig):
    """Explicit-collective MoE over the ambient mesh (``set_mesh``).

    Falls back to ``moe_ffn`` when no mesh with a `model` axis is active,
    and, as the reference does, when the token count cannot split over the
    mesh.  EP shards the tokens over the data axes and `model`;
    TP-in-expert shards them over the data axes only.
    """
    mesh = get_abstract_mesh()
    if mesh is None or "model" not in axis_names(mesh):
        return moe_ffn(x, router, w1, w3, w2, cfg)
    dsh = data_axes(mesh)
    tp = axis_size(mesh, "model")
    ds = math.prod(axis_size(mesh, a) for a in dsh)
    E = cfg.n_experts
    T = x.shape[0]
    ep = E % tp == 0 and T % (ds * tp) == 0 and T >= 4 * ds * tp
    if (not ep and (T % ds != 0 or T < 4 * ds)) or not dsh:
        # decode-sized token counts cannot shard over the mesh
        if is_dtensor(x):
            return _moe_replicated(x, router, w1, w3, w2, cfg, mesh)
        return moe_ffn(x, router, w1, w3, w2, cfg)
    w_spec = P("model", None, None) if ep else P(None, None, "model")
    w2_spec = P("model", None, None) if ep else P(None, "model", None)
    n_local = E // tp if ep else E
    x_spec = P(dsh + ("model",), None) if ep else P(dsh, None)

    def body(xl, rl, w1l, w3l, w2l):
        return _moe_local(xl, rl, w1l, w3l, w2l, cfg, n_local, "model", dsh)

    return shard_map(body, mesh, (x_spec, P(None, None), w_spec, w_spec, w2_spec),
                     (x_spec, P()))(x, router, w1, w3, w2)


# ==========================================================================
# Layer / forward
# ==========================================================================

def _project_qkv(h, lp, positions, cfg: TransformerConfig):
    """q [B,S,H,D] and k, v [B,S,KV,D] of the normed input h [B,S,d]: the
    projections, biases, qk norms and rotations.  The head counts are the
    weights' widths over ``d_head`` (a rank's own heads in
    ``_attend_own_heads``)."""
    cd = cfg.compute_dtype
    B, S, _ = h.shape
    D = cfg.d_head
    q = h @ lp["wq"].to(cd)
    kk = h @ lp["wk"].to(cd)
    vv = h @ lp["wv"].to(cd)
    if cfg.qkv_bias:
        q = q + lp["bq"].to(cd)
        kk = kk + lp["bk"].to(cd)
        vv = vv + lp["bv"].to(cd)
    q = q.reshape(B, S, q.shape[-1] // D, D)
    kk = kk.reshape(B, S, kk.shape[-1] // D, D)
    vv = vv.reshape(B, S, vv.shape[-1] // D, D)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"])
        kk = rms_norm(kk, lp["k_norm"])
    q = rope(q, positions, cfg.rope_theta)
    kk = rope(kk, positions, cfg.rope_theta)
    return q, kk, vv


def _self_attention(S: int, cfg: TransformerConfig):
    """The attention of an S-token step over its own keys, and the
    arguments after the positions."""
    if S > cfg.attn_chunk and S % cfg.attn_chunk == 0:
        return chunked_attention, (cfg.sliding_window, cfg.attn_chunk)
    return full_attention, (cfg.sliding_window,)


def _attend_own_heads(h, lp, positions, cfg: TransformerConfig):
    """The attention of a step that keeps no cache, on DTensors (the dry
    run), in one local region from the normed input h to the heads'
    output: each rank projects its query heads and only the kv heads they
    read, and attends them, as the reference's plan does.  (With k and v's
    weights replicated -- kv heads that do not split over `model` --
    DTensor would project every kv head on every rank.)  The weights'
    cotangents are partial over the axes that split the batch or slice a
    replicated weight."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = h.device_mesh
    cd = cfg.compute_dtype
    hpl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
           for p in h.placements]
    hl = h.redistribute(mesh, hpl).to_local(
        grad_placements=[p if isinstance(p, Shard) else Partial() for p in hpl])

    def local(w):
        return w.to(cd).to_local(grad_placements=[
            p if isinstance(p, Shard) else Partial() for p in w.placements])

    names = ["wq", "wk", "wv"] + (["bq", "bk", "bv"] if cfg.qkv_bias else []) + (
        ["q_norm", "k_norm"] if cfg.qk_norm else [])
    w = {n: local(lp[n]) for n in names}
    D, KV = cfg.d_head, cfg.n_kv_heads
    heads = [i for i, p in enumerate(lp["wq"].placements) if isinstance(p, Shard)]
    coord, block = mesh.get_coordinate(), 0
    for i in heads:
        block = block * mesh.size(i) + coord[i]
    Hl = w["wq"].shape[-1] // D
    if w["wk"].shape[-1] == KV * D:  # replicated: this rank's heads' slice
        G = cfg.n_heads // KV
        lo, hi = block * Hl // G, (block * Hl + Hl - 1) // G + 1
        for n in ("wk", "wv", "bk", "bv"):
            if n in w:
                w[n] = w[n][..., lo * D:hi * D]
    q, kk, vv = _project_qkv(hl, w, positions, cfg)
    fn, extra = _self_attention(q.shape[1], cfg)
    o = fn(q, kk, vv, positions, positions, *extra)
    opl = [Shard(2) if i in heads else p for i, p in enumerate(hpl)]
    return from_local(o.contiguous(), mesh, opl, (*h.shape[:2], cfg.n_heads, D))


def _layer(x, lp, positions, cfg: TransformerConfig, kv_cache=None,
           cache_pos=None, keep_kv: bool = True):
    """One transformer block.  x: [B,S,d].  Returns (y, aux, new_kv)
    (``new_kv`` None when ``keep_kv`` is false and ``x`` a DTensor).

    With ``kv_cache=(ck, cv)`` and ``cache_pos`` (a decode step), the new
    keys and values are written into ``ck``/``cv`` in place at
    ``cache_pos`` (its ring slot under a sliding window), the start
    clamped as ``dynamic_update_slice`` clamps it: past the last slot of a
    window-less cache they land in the last slot.
    """
    cd = cfg.compute_dtype
    B, S, d = x.shape
    h = _sum_cotangents(rms_norm(x, lp["ln1"]).to(cd))
    if kv_cache is None and not keep_kv and is_dtensor(h):
        o, new_kv = _attend_own_heads(h, lp, positions, cfg), None
    elif kv_cache is not None:
        if cache_pos is None:
            raise ValueError("cache without cache_pos")
        q, kk, vv = _project_qkv(h, lp, positions, cfg)
        ck, cv = kv_cache  # [B, S_cache, KV, D]
        Sc = ck.shape[1]
        slot = cache_pos % Sc if cfg.sliding_window > 0 else cache_pos
        slot = min(max(slot, 0), Sc - S)  # dynamic_update_slice's clamp
        _write_slots(ck, slot, kk)
        _write_slots(cv, slot, vv)
        k_pos_abs = _cache_positions(Sc, cache_pos, cfg, x.device)
        o = _attend(full_attention, q, ck, cv, positions, k_pos_abs,
                    cfg.sliding_window)
        new_kv = (ck, cv)
    else:
        q, kk, vv = _project_qkv(h, lp, positions, cfg)
        fn, extra = _self_attention(S, cfg)
        o = _attend(fn, q, kk, vv, positions, positions, *extra)
        new_kv = (kk, vv)
    # a DTensor's partial sums over `model` reduce here, as Megatron's
    # all-reduce after the row-parallel product (no-op on plain tensors)
    o = maybe_shard(o.reshape(B, S, cfg.q_dim) @ lp["wo"].to(cd), _BATCH)
    x = x + o.to(x.dtype)

    h = _sum_cotangents(rms_norm(x, lp["ln2"]).to(cd))
    if cfg.is_moe:
        moe = moe_ffn_shard_map if cfg.moe_shard_map else moe_ffn
        y, aux = moe(h.reshape(B * S, d), lp["router"].to(cd),
                     lp["w1"].to(cd), lp["w3"].to(cd), lp["w2"].to(cd), cfg)
        # tokens split over data x model may cut a sequence: back to whole
        # sequences before the reshape (no-op on plain tensors)
        y = maybe_shard(y, P(("pod", "data"), None)).reshape(B, S, d)
    else:
        y = maybe_shard(dense_ffn(h, lp["w1"].to(cd), lp["w3"].to(cd),
                                  lp["w2"].to(cd)), _BATCH)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + y.to(x.dtype), aux, new_kv


def _write_slots(c, slot: int, new) -> None:
    """``c[:, slot:slot + S] = new`` in place.  On DTensors (the dry run)
    in a local region: a write into a dimension that DTensor shards would
    land in a gathered copy, so each rank writes the slots that fall in its
    block of the sequence, ``new`` laid out as the cache's other
    dimensions are."""
    if not is_dtensor(c):
        c[:, slot:slot + new.shape[1]] = new
        return
    from torch.distributed.tensor import Replicate, Shard

    mesh = c.device_mesh
    seq = [i for i, p in enumerate(c.placements) if isinstance(p, Shard) and p.dim == 1]
    pl = [Replicate() if i in seq else p for i, p in enumerate(c.placements)]
    nl = (new.redistribute(mesh, pl).to_local() if is_dtensor(new) else new).to(c.dtype)
    cl = c.to_local()
    coord, block = mesh.get_coordinate(), 0
    for i in seq:
        block = block * mesh.size(i) + coord[i]
    n = cl.shape[1]
    lo, hi = max(slot, block * n), min(slot + nl.shape[1], (block + 1) * n)
    if lo < hi:
        cl[:, lo - block * n:hi - block * n] = nl[:, lo - slot:hi - slot]


def _cache_positions(Sc: int, cache_pos: int, cfg: TransformerConfig, device):
    """Absolute positions held by each cache slot at decode time."""
    slots = torch.arange(Sc, device=device)
    if cfg.sliding_window > 0:
        # ring buffer: slot s holds the latest absolute position p <= cache_pos
        # with p % Sc == s; invalid (future) slots get a huge position.
        base = (cache_pos // Sc) * Sc
        pos = torch.where(slots <= cache_pos % Sc, base + slots, base - Sc + slots)
        return torch.where(pos >= 0, pos, I32_MAX)
    return torch.where(slots <= cache_pos, slots, I32_MAX)


def _arange(S: int, tokens) -> torch.Tensor:
    """``torch.arange(S)`` on the tokens' device.  On fake tensors (the dry
    run) a real host tensor: the chunk loop reads its values."""
    from torch._subclasses.fake_tensor import FakeTensor, unset_fake_temporarily

    local = tokens.to_local() if is_dtensor(tokens) else tokens
    if isinstance(local, FakeTensor):
        with unset_fake_temporarily():
            return torch.arange(S)
    return torch.arange(S, device=tokens.device)


def _embed(model, tokens, cfg: TransformerConfig):
    if is_dtensor(model.embed):
        return lookup_rows(model.embed, tokens).to(cfg.compute_dtype)
    return model.embed[tokens].to(cfg.compute_dtype)



def _save_dots(ctx, op, *args, **kwargs):
    """``_remat_policy``'s choice for one op: keep ``mm`` and ``addmm``."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_policy(x) -> dict:
    """``checkpoint``'s policy for a layer.  On DTensors (the dry run) the
    reference's, ``dots_with_no_batch_dims_saveable``: the products
    without batch dimensions (``mm``) are kept for the backward, the rest
    (attention's ``bmm``, the MoE's expert einsums, the elementwise ops)
    recomputed.  On plain tensors the whole layer is recomputed, the
    least memory on one card."""
    if not is_dtensor(x):
        return {}
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    return {"context_fn": functools.partial(create_selective_checkpoint_contexts,
                                            _save_dots)}


def forward(model, tokens, cfg: TransformerConfig, positions=None):
    """tokens: [B,S] -> (final hidden states [B,S,d] (pre lm_head), the
    summed aux loss).  With ``cfg.remat`` and gradients on, each layer is
    recomputed in the backward (``torch.utils.checkpoint``; on DTensors
    its products without batch dimensions are kept: ``_remat_policy``)."""
    B, S = tokens.shape
    if positions is None:
        positions = _arange(S, tokens)
    x = _embed(model, tokens, cfg)
    x = maybe_shard(x, _BATCH)
    names = sorted(n for n, _ in model.layers.named_parameters())

    def body(x, *vals):
        y, aux, _ = _layer(x, dict(zip(names, vals)), positions, cfg, keep_kv=False)
        return y, aux

    remat = cfg.remat and torch.is_grad_enabled()
    auxs = []
    for lp in layer_params(model):
        vals = [lp[n] for n in names]
        if remat:
            x, aux = checkpoint(body, x, *vals, use_reentrant=False,
                                preserve_rng_state=False, **_remat_policy(x))
        else:
            x, aux = body(x, *vals)
        auxs.append(aux)
    x = _sum_cotangents(rms_norm(x, model.final_ln))
    return x, torch.stack(auxs).sum()


def _chunk_ce(xs, head, ls):
    """Summed cross-entropy of one sequence chunk: xs [B,C,d], ls [B,C]."""
    logits = (xs @ head).float()
    if is_dtensor(logits):  # the dry run: gather the vocab before the gold pick
        from torch.distributed.tensor import Replicate, Shard

        logits = logits.redistribute(logits.device_mesh, [
            Replicate() if not isinstance(p, Shard) or p.dim == logits.ndim - 1
            else p for p in logits.placements])
    lse = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, ls[..., None].long())[..., 0]
    return (lse - gold).sum()


def lm_loss(model, tokens, labels, cfg: TransformerConfig):
    """Chunked cross-entropy over the vocab.  Each chunk's logits are
    recomputed in the backward, so no [B,S,V] logits are kept."""
    x, aux = forward(model, tokens, cfg)
    B, S, d = x.shape
    C = min(cfg.loss_chunk, S)
    nc = S // C
    head = model.lm_head.to(cfg.compute_dtype)

    def ce(xs, ls):
        if torch.is_grad_enabled():
            return checkpoint(_chunk_ce, xs, head, ls, use_reentrant=False,
                              preserve_rng_state=False)
        return _chunk_ce(xs, head, ls)

    total = torch.stack([ce(x[:, ci * C:(ci + 1) * C], labels[:, ci * C:(ci + 1) * C])
                         for ci in range(nc)]).sum()
    if S - nc * C:
        total = total + ce(x[:, nc * C:], labels[:, nc * C:])
    return total / (B * S) + 0.01 * aux


def loss_fn(model, batch: dict, cfg: TransformerConfig):
    """``lm_loss`` of a batch ``{"tokens", "labels"}`` (the launcher's
    loss)."""
    return lm_loss(model, batch["tokens"], batch["labels"], cfg)


# ==========================================================================
# Serving
# ==========================================================================

def init_cache(cfg: TransformerConfig, batch: int, max_len: int, device="cuda"):
    """Zeros [L, 2, B, Sc, KV, D] in ``compute_dtype``; Sc is ``max_len``,
    or the window where the config has one below it."""
    Sc = min(max_len, cfg.sliding_window) if cfg.sliding_window > 0 else max_len
    shape = (cfg.n_layers, 2, batch, Sc, cfg.n_kv_heads, cfg.d_head)
    return torch.zeros(shape, dtype=cfg.compute_dtype,
                       device=resolve_device(device))


@torch.no_grad()
def prefill_step(model, tokens, cfg: TransformerConfig):
    """Prompt forward: returns last-position logits [B, V] (f32) + KV cache
    [L, 2, B, Sc, KV, D].  Under a sliding window shorter than the prompt
    the cache keeps the last ``sliding_window`` positions, slot i holding
    position S - window + i, as the reference does: a later ``serve_step``
    expects position p in slot p % window, so the two line up only when S
    is a multiple of the window."""
    B, S = tokens.shape
    positions = _arange(S, tokens)
    x = _embed(model, tokens, cfg)
    x = maybe_shard(x, _BATCH)
    w = cfg.sliding_window
    Sc = w if 0 < w < S else S
    if is_dtensor(x):  # the dry run: each layer's kv kept, stacked at the end
        kvs = []
        for lp in layer_params(model):
            x, _aux, kv = _layer(x, lp, positions, cfg)
            kvs.append(torch.stack([t[:, S - Sc:] for t in kv]))
        cache = torch.stack(kvs)
    else:
        cache = torch.empty((cfg.n_layers, 2, B, Sc, cfg.n_kv_heads, cfg.d_head),
                            dtype=cfg.compute_dtype, device=tokens.device)
        for li, lp in enumerate(layer_params(model)):
            x, _aux, kv = _layer(x, lp, positions, cfg)
            cache[li, 0] = kv[0][:, S - Sc:]
            cache[li, 1] = kv[1][:, S - Sc:]
    x = rms_norm(x[:, -1:], model.final_ln)
    logits = (x @ model.lm_head.to(cfg.compute_dtype)).float()
    return logits[:, 0], cache


@torch.no_grad()
def serve_step(model, cache, token, cache_pos: int, cfg: TransformerConfig):
    """One decode step.  cache: [L,2,B,Sc,KV,D]; token: [B] int; cache_pos:
    the new token's position (a host int).  Returns (logits [B, V] f32,
    cache).

    Unlike the reference, which returns a new cache, this CONSUMES its
    input: the new keys and values are written into ``cache`` in place
    and the same tensor is returned (a functional copy of a 32,768-slot
    cache would move gigabytes a token)."""
    cache_pos = int(cache_pos)
    positions = torch.full((1,), cache_pos, device=token.device)
    x = _embed(model, token[:, None], cfg)
    for li, lp in enumerate(layer_params(model)):
        x, _aux, _ = _layer(x, lp, positions, cfg,
                            kv_cache=(cache[li, 0], cache[li, 1]),
                            cache_pos=cache_pos)
    x = rms_norm(x, model.final_ln)
    logits = (x @ model.lm_head.to(cfg.compute_dtype)).float()
    return logits[:, 0], cache
