"""AdamW + gradient clipping + LR schedule on dicts of tensors.

Counterpart of ``repro/optim/adamw.py``, with its exact formulas: b2 =
0.95, weight decay on every leaf (the embedding table included), the clip
scale ``min(1, max_norm / max(gn, 1e-9))``.  ``torch.optim.AdamW`` and
``clip_grad_norm_`` differ in the clip epsilon and in where the decay
enters, so they are not used.

The state mirrors the parameter dict: ``{"m": {name: zeros}, "v": ...,
"count": int}``.  ``adamw_update`` works in place with
``torch._foreach_*`` ops -- the parameters, ``m`` and ``v`` are updated,
not copied -- each op one rounded f32 operation in the reference's order.
"""

from __future__ import annotations

import math

import torch


def adamw_init(params: dict) -> dict:
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
    return {"m": zeros, "v": {k: z.clone() for k, z in zeros.items()},
            "count": 0}


def clip_by_global_norm(grads: dict, max_norm: float):
    """-> (grads scaled by min(1, max_norm / max(gn, 1e-9)), gn), gn the
    global L2 norm in f32 (a 0-d tensor on the gradients' device)."""
    gn = torch.sqrt(sum(g.float().square().sum() for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}, gn


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def adamw_update(grads: dict, state: dict, params: dict, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.01):
    """One AdamW step, in place on ``params`` and ``state``; returns them.
    ``lr`` is a float or a 0-d f32 tensor."""
    count = state["count"] + 1
    c1 = float(1.0 - _f32(b1) ** _f32(count))
    c2 = float(1.0 - _f32(b2) ** _f32(count))
    lr = float(_f32(lr))
    names = list(grads)
    g = [grads[k].float() for k in names]
    m = [state["m"][k] for k in names]
    v = [state["v"][k] for k in names]
    p = [params[k] for k in names]
    with torch.no_grad():
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
        torch._foreach_mul_(v, b2)
        torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2))
        step = torch._foreach_div(m, c1)
        den = torch._foreach_div(v, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        torch._foreach_div_(step, den)
        del den
        torch._foreach_add_(step, torch._foreach_mul(p, weight_decay))
        torch._foreach_mul_(step, lr)
        torch._foreach_sub_(p, step)
    state["count"] = count
    return params, state


def cosine_lr(step, base_lr: float, warmup: int, total: int,
              min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_ratio * base_lr``: a 0-d
    f32 tensor on the CPU."""
    step = _f32(step)
    warm = base_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5
                     * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)
