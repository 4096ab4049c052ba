"""The train steps of the cell builder.

Counterpart of ``make_train_step`` and ``make_sparse_recsys_train_step``
(in its local-scatter form) in ``repro/launch/cells.py``.  The rest of
that module -- the mesh cells, their shardings and FLOP estimates, and the
owner-routed table gather and update -- waits for the several-device
slice of the port (ROADMAP Queue A 7, A7e).
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

    ``step(model, opt_state, batch) -> (model, opt_state, metrics)``
    updates the model's parameters and ``opt_state`` (``sparse_opt_init``)
    in place.  ``mesh`` (the owner-routed update over an all-to-all) waits
    for the several-device slice and raises.
    """
    if mesh is not None or table_axes or batch_axes:
        raise NotImplementedError(
            "the owner-routed table gather and update (mesh=...) come with "
            "the several-device slice of the port (ROADMAP Queue A 7, A7e)")
    from ..models.recsys import ctr_head

    if cfg.kind not in ("dcn", "dlrm"):
        raise ValueError(f"the sparse step takes dcn or dlrm, not {cfg.kind}")

    def step(model, opt_state, batch):
        params = param_dict(model)
        table = params.pop("table")
        F, d = cfg.n_sparse, cfg.embed_dim
        offs = torch.arange(F, device=table.device) * cfg.rows_per_field
        flat_ids = (batch["sparse"].long() + offs[None, :]).reshape(-1)
        emb = table.detach().index_select(0, flat_ids)
        emb = emb.reshape(-1, F, d).requires_grad_()
        logits = ctr_head(model, batch["dense"], emb, cfg).float()
        y = batch["label"].float()
        loss = torch.mean(torch.clamp_min(logits, 0) - logits * y
                          + torch.log1p(torch.exp(-logits.abs())))
        *g_other, g_emb = torch.autograd.grad(loss, [*params.values(), emb])
        g_other, gnorm = clip_by_global_norm(dict(zip(params, g_other)), 1.0)
        mlp = opt_state["mlp"]
        lr = cosine_lr(mlp["count"] + 1, base_lr, 10, 100_000)
        adamw_update(g_other, mlp, params, lr)
        # rowwise Adagrad, scatter only
        g_flat = g_emb.reshape(-1, d)
        acc = opt_state["table_acc"]
        with torch.no_grad():
            acc.index_add_(0, flat_ids, torch.sum(g_flat * g_flat, -1))
            scale = base_lr / torch.sqrt(acc[flat_ids] + 1e-8)
            table.index_add_(0, flat_ids, -scale[:, None] * g_flat)
        return model, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return step
