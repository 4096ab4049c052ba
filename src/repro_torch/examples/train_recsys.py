"""Train DCN-v2 on synthetic CTR batches, with an OptVB-compressed multi-hot
feature decoded each step and reduced through the EmbeddingBag kernel.

    PYTHONPATH=src python -m repro_torch.examples.train_recsys [--steps 100] [--batch 64]

Counterpart of ``examples/train_recsys.py``: the reference's loop, at its
smoke config, on the card unless ``--device cpu``.  Each step draws a CTR
batch and a batch of users from ``default_rng(step)``, decodes the users'
"recently viewed" lists from the partitioned index, reduces them with
``multi_hot_embed`` over the first field's rows of the table, splices the
bag into the dense features and takes one ``make_train_step`` step.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import obs
from ..api import resolve_device
from ..configs import get_arch
from ..convert import recsys_params_from_arrays
from ..data.recsys_data import (
    decode_multihot_batch,
    make_ctr_batch,
    make_multihot_store,
)
from ..kernels.embedding_bag.ops import multi_hot_embed
from ..launch.cells import make_train_step
from ..models.common import param_dict
from ..models.recsys import init_model, loss_fn
from ..optim import adamw_init

N_USERS = 256
MEAN_ITEMS = 40
PAD_TO = 64
BASE_LR = 1e-2


def setup(cfg, *, device="cuda", seed=0, params=None) -> dict:
    """The model (from ``seed`` on ``device``, or the reference's tree of
    arrays ``params``), its AdamW state, the train step and the multi-hot
    store (``default_rng(seed)``: 256 users, mean 40 items)."""
    dev = resolve_device(device)
    model = (init_model(cfg, seed, dev) if params is None
             else recsys_params_from_arrays(params, cfg, dev))
    store = make_multihot_store(np.random.default_rng(seed), n_users=N_USERS,
                                vocab=cfg.rows_per_field, mean_items=MEAN_ITEMS)
    return {"cfg": cfg, "device": dev, "model": model,
            "opt": adamw_init(param_dict(model)), "store": store,
            "step_fn": make_train_step(loss_fn, cfg, base_lr=BASE_LR)}


def train_step(state: dict, s: int, batch: int) -> dict:
    """Step ``s`` of the loop: its loss, the host seconds of the CTR batch
    and of the multi-hot decode, the seconds of the rest (upload, bag,
    train step, the card synchronized), and the tensors it trained on."""
    cfg, dev = state["cfg"], state["device"]
    t0 = obs.now()
    b = make_ctr_batch(np.random.default_rng(s), cfg, batch)
    t1 = obs.now()
    users = np.random.default_rng(s).integers(0, N_USERS, batch)
    ids, mask = decode_multihot_batch(state["store"], users, pad_to=PAD_TO,
                                      device=dev)
    t2 = obs.now()
    ids, mask = torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)
    # the reference pads the table to 128 columns for the TPU's lanes and
    # slices the bag back; the kernel takes the [rows_per_field, d] rows
    table = state["model"].table.detach()[: cfg.rows_per_field]
    bag = multi_hot_embed(table, ids, mask)
    # the reference's splice, as it is: at the full config (n_dense 13 <
    # embed_dim 16) it keeps 10 dense columns and the bag's first 3
    dense = torch.from_numpy(b["dense"]).to(dev)
    dense = torch.cat([dense[:, : cfg.n_dense - cfg.embed_dim],
                       bag[:, : cfg.embed_dim]], 1)[:, : cfg.n_dense]
    tb = {"dense": dense.contiguous(),
          "sparse": torch.from_numpy(b["sparse"]).to(dev),
          "label": torch.from_numpy(b["label"]).to(dev)}
    _, _, m = state["step_fn"](state["model"], state["opt"], tb)
    loss = float(m["loss"])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t3 = obs.now()
    return {"loss": loss, "batch_s": t1 - t0, "decode_s": t2 - t1,
            "step_s": t3 - t2, "batch": tb, "ids": ids, "mask": mask,
            "bag": bag}


def run(cfg, steps: int, batch: int, *, device="cuda", seed=0,
        params=None) -> dict:
    """The reference example's loop: ``steps`` steps of ``batch`` examples.
    Returns the set-up state (model, optimizer, store) after the last
    step, each step's record (``train_step``) and the losses."""
    state = setup(cfg, device=device, seed=seed, params=params)
    records = [train_step(state, s, batch) for s in range(steps)]
    return {"state": state, "records": records,
            "losses": [r["loss"] for r in records]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions)")
    args = ap.parse_args(argv)
    cfg = get_arch("dcn-v2").smoke
    res = run(cfg, args.steps, args.batch, device=args.device)
    store, losses = res["state"]["store"], res["losses"]
    print(f"multi-hot store: {store.space_bits()//8:,} B compressed "
          f"({store.bits_per_int():.2f} bpi)")
    for s in range(0, len(losses), 20):
        print(f"step {s:4d} loss {losses[s]:.4f}")
    print(f"first-10 mean loss {np.mean(losses[:10]):.4f} -> "
          f"last-10 mean {np.mean(losses[-10:]):.4f}")


if __name__ == "__main__":
    main()
