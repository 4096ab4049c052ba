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
``lax.scan`` outside any Pallas kernel).  The mesh machinery --
``param_specs``, ``input_specs``, ``moe_ffn_shard_map`` -- waits for the
several-device slice and raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..api import resolve_device
from .common import dense_init, rms_norm, split_keys

MASK_FILL = -1e30  # the reference's fill of masked scores and first max
I32_MAX = 2**31 - 1  # position of a cache slot that holds nothing yet
A7E = ("the mesh machinery comes with the several-device slice of the port "
       "(ROADMAP Queue A 7, A7e)")


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
    moe_shard_map: bool = False  # explicit-collective MoE: waits for A7e
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


def param_specs(cfg: TransformerConfig, model_axis: str = "model", tp: int = 16):
    raise NotImplementedError(f"param_specs: {A7E}")


def input_specs(cfg: TransformerConfig, shape_kind: str, seq_len: int, batch: int):
    raise NotImplementedError(f"input_specs: {A7E}")


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
    for qi, live in enumerate(_live_blocks(qpc, kpc, window)):
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
    if cfg.moe_shard_map:
        raise NotImplementedError(f"moe_shard_map=True: {A7E}")
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


def moe_ffn_shard_map(x, router, w1, w3, w2, cfg: TransformerConfig):
    raise NotImplementedError(f"moe_ffn_shard_map: {A7E}")


def _moe_local(*args, **kwargs):
    raise NotImplementedError(f"_moe_local: {A7E}")


# ==========================================================================
# Layer / forward
# ==========================================================================

def _layer(x, lp, positions, cfg: TransformerConfig, kv_cache=None,
           cache_pos=None):
    """One transformer block.  x: [B,S,d].  Returns (y, aux, new_kv).

    With ``kv_cache=(ck, cv)`` and ``cache_pos`` (a decode step), the new
    keys and values are written into ``ck``/``cv`` in place at
    ``cache_pos`` (its ring slot under a sliding window), the start
    clamped as ``dynamic_update_slice`` clamps it: past the last slot of a
    window-less cache they land in the last slot.
    """
    cd = cfg.compute_dtype
    B, S, d = x.shape
    h = rms_norm(x, lp["ln1"]).to(cd)
    q = h @ lp["wq"].to(cd)
    kk = h @ lp["wk"].to(cd)
    vv = h @ lp["wv"].to(cd)
    if cfg.qkv_bias:
        q = q + lp["bq"].to(cd)
        kk = kk + lp["bk"].to(cd)
        vv = vv + lp["bv"].to(cd)
    q = q.reshape(B, S, cfg.n_heads, cfg.d_head)
    kk = kk.reshape(B, S, cfg.n_kv_heads, cfg.d_head)
    vv = vv.reshape(B, S, cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"])
        kk = rms_norm(kk, lp["k_norm"])
    q = rope(q, positions, cfg.rope_theta)
    kk = rope(kk, positions, cfg.rope_theta)

    if kv_cache is not None:
        if cache_pos is None:
            raise ValueError("cache without cache_pos")
        ck, cv = kv_cache  # [B, S_cache, KV, D]
        Sc = ck.shape[1]
        slot = cache_pos % Sc if cfg.sliding_window > 0 else cache_pos
        slot = min(max(slot, 0), Sc - S)  # dynamic_update_slice's clamp
        ck[:, slot:slot + S] = kk
        cv[:, slot:slot + S] = vv
        k_pos_abs = _cache_positions(Sc, cache_pos, cfg, x.device)
        o = full_attention(q, ck, cv, positions, k_pos_abs, cfg.sliding_window)
        new_kv = (ck, cv)
    else:
        if S > cfg.attn_chunk and S % cfg.attn_chunk == 0:
            o = chunked_attention(q, kk, vv, positions, positions,
                                  cfg.sliding_window, cfg.attn_chunk)
        else:
            o = full_attention(q, kk, vv, positions, positions,
                               cfg.sliding_window)
        new_kv = (kk, vv)
    o = o.reshape(B, S, cfg.q_dim) @ lp["wo"].to(cd)
    x = x + o.to(x.dtype)

    h = rms_norm(x, lp["ln2"]).to(cd)
    if cfg.is_moe:
        y, aux = moe_ffn(h.reshape(B * S, d), lp["router"].to(cd),
                         lp["w1"].to(cd), lp["w3"].to(cd), lp["w2"].to(cd), cfg)
        y = y.reshape(B, S, d)
    else:
        y = dense_ffn(h, lp["w1"].to(cd), lp["w3"].to(cd), lp["w2"].to(cd))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + y.to(x.dtype), aux, new_kv


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


def _embed(model, tokens, cfg: TransformerConfig):
    return model.embed[tokens].to(cfg.compute_dtype)


def forward(model, tokens, cfg: TransformerConfig, positions=None):
    """tokens: [B,S] -> (final hidden states [B,S,d] (pre lm_head), the
    summed aux loss).  With ``cfg.remat`` and gradients on, each layer is
    recomputed in the backward (``torch.utils.checkpoint``)."""
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, device=tokens.device)
    x = _embed(model, tokens, cfg)
    names = sorted(n for n, _ in model.layers.named_parameters())

    def body(x, *vals):
        y, aux, _ = _layer(x, dict(zip(names, vals)), positions, cfg)
        return y, aux

    remat = cfg.remat and torch.is_grad_enabled()
    auxs = []
    for lp in layer_params(model):
        vals = [lp[n] for n in names]
        if remat:
            x, aux = checkpoint(body, x, *vals, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, aux = body(x, *vals)
        auxs.append(aux)
    x = rms_norm(x, model.final_ln)
    return x, torch.stack(auxs).sum()


def _chunk_ce(xs, head, ls):
    """Summed cross-entropy of one sequence chunk: xs [B,C,d], ls [B,C]."""
    logits = (xs @ head).float()
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
    positions = torch.arange(S, device=tokens.device)
    x = _embed(model, tokens, cfg)
    w = cfg.sliding_window
    Sc = w if 0 < w < S else S
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
