"""The generic train step of the cell builder.

Counterpart of ``make_train_step`` in ``repro/launch/cells.py``.  The rest
of that module -- the mesh cells, their shardings and FLOP estimates, and
``make_sparse_recsys_train_step`` -- waits for a later slice of the port
(ROADMAP Queue A 7).
"""

from __future__ import annotations

import torch

from ..models.common import param_dict
from ..optim import adamw_update, clip_by_global_norm, cosine_lr


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
        grads, gnorm = clip_by_global_norm(dict(zip(params, grads)), 1.0)
        lr = cosine_lr(opt_state["count"] + 1, base_lr, warmup, total)
        adamw_update(grads, opt_state, params, lr)
        return model, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return step
