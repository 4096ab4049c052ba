"""Train a ~100M-parameter qwen-style LM for a few hundred steps on the
synthetic token pipeline, with checkpoint/restart and a simulated node
failure at step ``min(150, steps // 2)``.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300]
    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 40 --device cpu

Counterpart of ``examples/train_lm.py``: its config (d_model 512, 8
layers, d_ff 1408, a 32,768-word vocab and head: 59,253,248 parameters,
which the reference calls ~100M), its loader (a
``seq_len * batch * 256 + 1``-token stream, the OptVB-packed shard index),
``make_train_step`` at base lr 3e-4 with 20 warm-up steps, a checkpoint
every 50 steps; on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import tempfile

import torch

from ..api import resolve_device
from ..checkpoint import CheckpointManager
from ..convert import lm_tree_from_arrays
from ..data.lm_data import ShardedBatchLoader, TokenStream
from ..distributed import FaultTolerantRunner, SimulatedFailure
from ..launch.cells import make_train_step
from ..launch.train import adamw_tree_init, state_step
from ..models import transformer as T
from ..models.common import tree_size

CFG = T.TransformerConfig(
    name="lm-100m", n_layers=8, d_model=512, n_heads=8, n_kv_heads=8,
    d_head=64, d_ff=1408, vocab=32768, attn_chunk=128, loss_chunk=128,
)
SAVE_EVERY = 50


def run(steps: int = 300, batch: int = 8, seq_len: int = 256, *,
        device="cuda", params=None, ckpt_dir=None, cfg=CFG) -> dict:
    """The example's loop.  ``params``: the reference's tree of arrays to
    start from instead of seed 0's draw on ``device``.  Returns the final
    state ``(params, opt)``, every step's loss in the order taken (the
    replayed steps after the restart included), the runner's stats and
    the loader."""
    dev = resolve_device(device)
    if params is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        tree = T.init_params(gen, cfg)
    else:
        tree = lm_tree_from_arrays(params, cfg, dev)
    n = tree_size(tree)
    print(f"params: {n:,} (~{n/1e6:.0f}M)")

    stream = TokenStream(cfg.vocab, length=seq_len * batch * 256 + 1)
    loader = ShardedBatchLoader(stream, batch, seq_len)
    print(f"compressed shard index: {loader.compressed_index_bytes:,} bytes "
          f"(OptVB) vs {loader.offsets().size * 8:,} raw")

    state_fn = state_step(T.Transformer, cfg,
                          make_train_step(T.loss_fn, cfg, base_lr=3e-4, warmup=20))
    losses = []

    def step(state, b):
        state, m = state_fn(state, b)
        losses.append(float(m["loss"]))
        return state, m

    def batches(s):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in loader.batch_at(s).items()}

    mgr = CheckpointManager(ckpt_dir or tempfile.mkdtemp(prefix="lm100m-"),
                            keep=2)
    runner = FaultTolerantRunner(step, mgr, save_every=SAVE_EVERY)
    state = runner.run(
        (tree, adamw_tree_init(tree)), batches, steps,
        failure=SimulatedFailure(at_steps=(min(150, steps // 2),)),
        log_every=10,
    )
    print(f"done: {runner.stats}")
    return {"state": state, "losses": losses, "stats": runner.stats,
            "loader": loader}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the host)")
    args = ap.parse_args(argv)
    run(args.steps, args.batch, args.seq_len, device=args.device)


if __name__ == "__main__":
    main()
