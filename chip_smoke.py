#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py                 # the full-size run
    python3 chip_smoke.py --n-lists 16    # a shallower corpus, same shapes

Run from the root of a checkout, on a machine with a CUDA card.  Phases:

1. card      -- ``nvidia-smi`` name and power limit;
2. build     -- compile every CUDA source of ``src/repro_torch/csrc`` with
   ``nvcc`` (one process each, all started together), then
   ``repro_torch.analyze.kernel_check``'s PTX rule: the PTX of the three
   libraries that evaluate an f32 contract (BM25's; the bag's k-ordered
   sum) must hold no contracted multiply-add (``fma.rn.f32``) and no
   approximate division (``div.approx`` / ``div.full.f32``);
3. recsys train -- ``repro_torch.examples.train_recsys.run`` at the full
   DCN-v2 width (13 dense and 26 sparse fields, a 27,262,976 x 16 table,
   3 cross layers, MLP 1024-1024-512), initialised on the card from seed
   0, at the config's ``train_batch`` shape (65,536): one warm-up step and
   5 timed ones, each decoding a multi-hot feature from the partitioned
   index and reducing it through ``embedding_bag``, with the launch counts
   set to 0 just before and read just after.  Held: the card's logits on
   4,096 examples to a CPU forward of the same parameters, three
   smoke-config steps on the card to three on the CPU, every loss finite;
   ``embedding_bag`` to its plain version (phase 7's check, run here while
   the path's tensors are alive); two steps traced as in phase 4.  Then
   (a) ``launch.cells.make_sparse_recsys_train_step`` (rowwise Adagrad by
   scatter on the table, AdamW on the rest) at the same width on the same
   batches: a warm-up and 5 timed steps, two traced, its peak memory
   beside the dense step's, three smoke-config steps held card against
   CPU with the untouched table rows bit-unchanged (one ``recsys
   sparse:`` line); (b) DIN and BST at full width through
   ``launch.train.build_training(arch, smoke=False, batch=65_536)``: 6
   timed steps (a warm-up and 5 more), then under torch's deterministic
   algorithms a run through ``FaultTolerantRunner`` with a checkpoint
   every 2 and a simulated failure at step 3, which must restart once,
   replay the restored step with its first pass's loss bit for bit, and
   end bit-equal to a run of the same steps without the failure
   (parameters, AdamW moments, step count); every loss finite, logits of
   4,096 examples held to a CPU forward (rtol 1e-4, atol 1e-6), three
   smoke steps card against CPU; (c) their
   ``serve_score`` at 512 and 262,144 examples and ``retrieval_step`` at
   the retrieval shape's 1,000,000 candidates, or the largest power of
   two whose measured memory fits the card (the cut printed), its first
   256 scores held to the CPU's (one ``recsys seq:`` line an arch).  The
   phase prints the seconds of each piece;
3c. lm       -- ``models/transformer.py`` at full width, TF32 off and
   bf16 reduced-precision reductions off (every run here is held against
   the CPU or another path): (a) qwen3-0.6b's whole FULL config (28
   layers, 751,632,384 parameters): under deterministic algorithms, the
   ``FaultTolerantRunner`` run of ``launch.train.build_training`` at
   ``train_4k``'s 4,096 tokens and ``LM_RESTART_BATCH`` sequences (a
   checkpoint every 2 steps, on ``/dev/shm`` where it is writable, a
   failure at step 3) ends bit-equal to an unbroken run; then the batch
   that fits is the largest power of two whose predicted peak fits 85%
   of the free memory (cut from 256; the forward and backward measured
   at 1 and 2 sequences, AdamW's update at 1), and the steps run at it or
   at ``LM_BATCH_CAP`` (8) if smaller, for the run's time limit: 1 + 5
   timed steps and 2 traced, the device's activity alone (one ``lm
   train:`` line: step p50/p99, tokens/s,
   peak memory, device busy share and top device ops, mfu as
   6 x active parameters x tokens against the dense bf16 peak); the
   logits of a 256-token prompt held to a CPU forward, chunked attention
   to full at 2,048 tokens, and decode from a prefill of 1,984 tokens to
   ``prefill_step`` of 2,048, each at bf16 (relative L2
   ``LM_BF16_REL``) and f32 (``LM_F32_REL``); a prefill at
   ``prefill_32k``'s 32,768 tokens (batch cut from 32 to 1), and 32
   decode steps on ``decode_32k``'s 32,768-slot cache filled from a
   prefill of 31,744 tokens, its batch the largest power of two whose
   measured memory fits 95% of the card (cut from 128; one ``lm
   serve:`` line); (b) moonshot-v1-16b-a3b at full width, its depth the
   most layers whose training peak, measured at 1 and 2 layers, fits 85%
   of the free memory: 3 train steps at 4,096 tokens, every expert of
   every layer fed gradient by uniform tokens (the reference's
   ``test_moe_routes_and_trains``), the logits of a 256-token prompt held
   to a CPU forward, a prefill of 4,096 tokens and 8 decode steps held to
   a prefill of all of them (at a capacity that drops no token: a
   prefill drops, a decode step never does); (c) mixtral-8x22b at full
   width, serve only, its depth from the measured serving peak: a
   prefill of 8,192 tokens (two windows, so the ring lines up) and 64
   decode steps through the ring, and a decode from one window to 4,160
   tokens held to the card's prefill of them; (d) the five LM archs'
   smoke configs from one init on the card and on the CPU: a prefill
   and 20 decode steps (past the smoke window) held to each other, 3
   launcher steps with losses within rtol 2e-3; (e)
   ``examples.train_lm.run(40)`` on the card: one restart, the last
   losses below the first.  Every cut is printed in the ``lm reduced:``
   line; the phase prints its seconds against its budget of 180 s;
4. boolean  -- ``repro_torch.launch.serve`` over the full-size corpus
   (``--n-lists 256 --min-len 10000 --max-len 2000000 --seed 0 --codec
   auto``: 104.55 M postings), then a few batches through an engine over
   the ``ef`` arena of the SAME index, with every kernel's launch count set
   to 0 just before and read just after; the batched answers are checked
   against the port's scalar NextGEQ loop, and two batches are traced with
   ``torch.profiler`` (device time per kernel against the wall time).
   Then, with the launch counts set to 0 again, ``core.jax_engine.
   DeviceList`` over the index's two longest lists (about 2 M postings
   each, decoded by ``decode_blocks``): the decode, the AND and 1,024
   NextGEQ probes (past the end included) held exactly to numpy (one
   ``device list:`` line); and the paper's two examples,
   ``examples.quickstart.run`` and ``examples.index_serving.run``, on the
   card, whose asserts must pass;
5. index build -- the boolean path's corpus, made again from its seed,
   through the two device partitioners with the launch counts set to 0
   just before and read just after: ``build_partitioned_index(...,
   partitioner=optimal_partitioning_blocked, codecs="auto")`` (the
   ``gain_scan`` kernel) must equal the boolean path's index, built by the
   host ``optimal_partitioning``, array for array; and
   ``optimal_partitioning_via_scan`` (the ``partition_scan`` kernel) must
   give the host's endpoints on every list.  The wall seconds of the three
   partitioners are printed;
6. ranked   -- ``serve --ranked --topk 10 --resident kernel`` over the same
   full-size corpus with its term frequencies, 512 queries of arity 2 in
   batches of 64; then 2 batches through ``resident="mirror"`` (which
   scores the whole arena once) and ``contributions()`` on 4,096 (term,
   doc) pairs, through the ``auto`` arena and through the ``ef`` arena of
   the same index, all with the launch counts set to 0 just before and
   read just after.  The top-k of 64 queries is held to ``exhaustive_topk``,
   the mirror's to the kernel residency's, the contributions to the host
   path, all exactly; two batches are traced as in phase 4;
6b. loop    -- ``serve --ranked --loop`` over phase 6's engine and queries
   (the corpus is not built again), its flags through ``serve.parse_args``
   and then ``serve.serve_loop``: 15 s of Poisson arrivals at half phase
   6's measured q/s (``--batch 64 --max-delay-ms 2``, no deadline), then
   10 s at twice it with ``--max-queue 128`` and ``--deadline-ms`` 3 x
   phase 6's batch p99, which must shed, then 5 s at twice it with a
   deadline of half phase 6's batch p50, below a wave's service, which
   must expire requests unserved; the launch counts set to 0 just
   before and read just after (``pivot_select``, ``pivot_score`` and
   ``bm25_score_rows`` must have launched).  Every served result must
   equal phase 6's for the same query, docIDs and f64 scores bit for bit;
   obs is armed with a ``MetricsServer`` on an ephemeral port, whose
   ``/metrics`` must count as many ``serve_request_ms`` samples as
   requests served and expired, and every run's arrivals must all be
   served, expired or shed.  One ``loop path:`` JSON line a run (offered,
   arrived and sustained q/s, request p50/p99/p99.9 from the scheduled
   arrival, waves, shed, expired);
6c. shards  -- sharded serving over phase 4's and phase 6's indexes and
   their first 128 queries (no corpus is built again; 256 before the
   recsys phase grew, 192 before the LM phase came, a depth cut it
   prints), with the launch
   counts set to 0 just before each run and read just after
   (``decode_search`` on the boolean runs, ``bm25_score_probe`` and
   ``pivot_select`` on the ranked ones must have launched): (a) ``serve
   --shards 4 --replicas 2 --faults 1`` (flags through
   ``serve.parse_args``, the ``auto`` arena, so the host loop), which
   must report availability 1.0000 and a failover, every answer equal
   to phase 4's; (b) ``--shards 4 --faults 1 --recover``: one recovery
   with a finite p99, every shard HEALTHY, answers equal to phase 4's,
   the checkpoint's bytes and save and restore seconds printed; then
   the same shards without replicas or checkpoint, whose answers after
   the fault to queries that touch a lost list must equal phase 4's
   engine on the live-restricted queries, and every other phase 4's;
   (c) ``--ranked --topk 10 --shards 4 --replicas 2 --faults 1`` over
   phase 6's index, top-k bit-identical to phase 6's; (d)
   ``EngineConfig(shards=4, replicas=2, shard_mesh=[cuda:0] * 4,
   codec_policy="svb")``, boolean and ranked (kernel residency), one
   injected fault, through the device-list dispatch (banner "shard_map
   over 4 devices"), answers equal to the host loop's; (e) ``shards=1``
   with ``shard_mesh="auto"``, the dispatch on one card, bit-identical
   to the unsharded engine.  Every ranked run's ``contributions()`` on
   4,096 pairs equals the host path.  One ``shard path:`` JSON line a
   run (mode, shards, replicas, q/s, every batch's ms and their p50/p99,
   availability, failures, failovers, recoveries, recovery p99, each
   shard's device bytes); the phase prints its seconds against its
   budget of 180 s;
6d. analyze -- ``repro_torch.analyze`` on the card: the contract registry,
   the idiom lint and the kernel sources (any finding fails; phase 2's
   PTX result printed again), and the host-sync audit of the tiny
   workload under ``torch.cuda.set_sync_debug_mode("warn")``, held to the
   committed ``sync_baseline.json`` (each path's sync sites and hidden
   syncs printed, and the audit's launches); then, for each of phase 4's
   and phase 6's full-size indexes, a fresh engine of the same config
   serves a warm batch of 64 queries over half the lists, then a
   data-cold batch of 64 over the other half under the card's sync debug
   mode: sync events, sites and (site, kind) pairs a batch (one ``analyze
   full size:`` JSON line); a pair not in ``FULL_SYNC_SITES`` fails, and
   the answers must equal the same batch's served again without the
   debug mode.  The phase prints its seconds against its budget of 60 s;
7. kernels  -- each kernel against its plain PyTorch version on the card,
   at the main paths' shapes, over the arenas and corpus they built
   (integer contracts and the f32 BM25 contract: zero mismatches allowed),
   timed with CUDA events beside its bound (bytes moved over the card's
   memory rate, or for ``partition_scan`` the larger of that and the chain
   its emissions form over the card's clock); for the two index-build
   kernels also their device time summed over the path's 256 per-list
   launches.  ``decode_search`` is also held on launches of 1, 7, 9 and
   2^20 + 3 cursors and timed on its cursors sorted by block, as the
   engine sends them; ``ef_search`` is also held on edge tiles and probes,
   and its bound counted from the lanes of ``lo`` its answers need (the
   count that charges every tile's ``lo`` beside it), and decode_search's
   from the bytes of its rows that hold values (the count that charges
   every row all 512 B of ``data`` beside it); ``pivot_select``,
   ``pivot_score`` and ``embedding_bag`` also get a device-only time (calls
   queued behind a spin kernel), and ``pivot_select`` and ``embedding_bag``
   their wrappers' host time and edge launches (``pivot_edge_cases``,
   ``bag_edge_cases``);
8. the ``kernels`` JSON line (each row also counts its launches in
   phases 6b, 6c and 6d, and in phase 4's DeviceList and examples), then
   the result line.

Exits non-zero, before the result line, if any phase fails, if there is no
CUDA card, or if the port's sources are not beside this script.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")
# H100 SXM HBM3 rate (NVIDIA data sheet); every kernel here is bound by bytes
HBM_BYTES_PER_S = 3.35e12
I32_MAX = 2**31 - 1
N_LISTS = 256  # the full-size corpus; --n-lists cuts its depth only
SERVE_ARGS = ["--min-len", "10000", "--max-len", "2000000", "--queries", "512",
              "--batch", "64", "--seed", "0", "--codec", "auto"]
BATCH = 64
RANKED_ARGS = ["--ranked", "--topk", "10", "--resident", "kernel",
               "--min-len", "10000", "--max-len", "2000000", "--batch", "64",
               "--seed", "0", "--codec", "auto"]
RANKED_QUERIES = 512  # --ranked-queries cuts it
TOPK = 10
RANKED_CHECK = 64  # ranked top-k held to exhaustive_topk
MIRROR_BATCHES = 2  # ranked batches served through resident="mirror"
CONTRIB_PAIRS = 4096  # (term, doc) pairs through contributions()
PROBE_CURSORS = 1 << 20  # bm25_score_probe cursors held to the plain version
# phase 6b, the serving loop over the ranked path's engine: a run at half
# the ranked path's measured q/s, then one at twice it with a bounded queue
# and a deadline of LOOP_DEADLINE_X times its batch p99, which must shed,
# then a short one at twice it with a deadline of LOOP_EXPIRE_X times its
# batch p50, which must expire requests
LOOP_HALF_S = 15.0
LOOP_OVER_S = 10.0
LOOP_EXPIRE_S = 5.0
LOOP_MAX_DELAY_MS = 2.0
LOOP_OVER_QUEUE = 128
LOOP_DEADLINE_X = 3.0
LOOP_EXPIRE_X = 0.5
LOOP_KERNELS = ("pivot_select", "pivot_score", "bm25_score_rows")
# phase 6c, sharded serving: SHARDS shards, SHARD_QUERIES queries a run (of
# phase 4's and phase 6's: two batches, the second the fault's, which a
# synchronous recovery or a failover serves whole; the depth a run serves,
# cut before the phase budget is: 256 until the recsys phase took DIN, BST
# and the sparse step, 192 until the LM phase came), and the phase's budget
# in seconds
SHARDS = 4
SHARD_QUERIES = 128
SHARD_PHASE_S = 180.0
LIBS = ["vbyte_decode", "ef_search", "bm25_score", "blockmax_pivot",
        "pivot_score", "gain_scan", "partition_scan", "embedding_bag"]
# phase 6d, the analyser: its seconds are held to this budget (printed,
# not a gate; a fresh ranked engine's warm batch builds its host flat
# mirror, about 22 s of it); the seed of its full-size batches; and each
# path's sync sites, with the torch function that syncs, that a
# data-cold full-size batch may reach (a new one fails the phase)
ANALYZE_PHASE_S = 60.0
ANALYZE_SEED = 20
FULL_SYNC_SITES = {
    "boolean_and": [
        "src/repro_torch/core/engine_core.py::_dispatch [cpu]",
        "src/repro_torch/core/engine_core.py::_dispatch [to]",
        "src/repro_torch/core/engine_core.py::decode_rows_values [cpu]",
        "src/repro_torch/core/engine_core.py::decode_rows_values [to]",
    ],
    "ranked_topk": [
        "src/repro_torch/ranked/topk_engine.py::_fetch [cpu]",
        "src/repro_torch/ranked/topk_engine.py::_theta_round_dev [tensor]",
        "src/repro_torch/ranked/topk_engine.py::_up [to]",
    ],
}
EF_BATCHES = 3  # batches served through the ef arena of the same index
CHECK_QUERIES = 64  # batched answers checked against the scalar loop
SEARCH_CURSORS = 1 << 20  # decode_search cursors held to the plain version
PROFILE_BATCHES = 2  # batches traced by torch.profiler
PLAIN_CHUNK = 1 << 19  # cursors (rows) per call of a plain version
# the longest gain_scan launch the range guard admits (40 n < 2^31), cut to
# whole 1024-element blocks: 52,428 blocks, the carry's longest chain
GUARD_LAUNCH = 53_686_272
# partition_scan's bound, the larger of two: its bytes (4 B read and 5 B
# written a step) over the memory rate, and the chain its emissions form.
# Between two emissions the steps are independent scans; each emission
# decides the carry every later step reads: at least one compare, then one
# select, each a fixed-latency integer operation of 4 cycles or more on
# sm_90a.  The emissions counted are this run's (mask.sum()).
SCAN_CHAIN_OPS = 2
SCAN_OP_CYCLES = 4
SCAN_STEP_BYTES = 4 + 5
SCAN_ROUND_STEPS = 512  # steps a round of partition_scan.cu (32 lanes x 16)
# the scan partitioner over the full corpus with the earlier one-thread
# partition_scan kernel, on an H100 80GB HBM3 at 700 W (PERF.md): wall s,
# and its partition_scan span (copy up, kernel, fetch of every step's
# mask and pos), printed beside this run's
ONE_THREAD_SCAN_S = 8.55
ONE_THREAD_SCAN_SPAN_S = 3.46
# cycles of the spin kernel queued ahead of a timed series of launches, so
# that the host's launch gaps fall before the first event (about 50 ms)
SPIN_CYCLES = 100_000_000
N_KERNELS = 10
# four kernels' times in their previous design, on an NVIDIA H100 80GB
# HBM3 at 700 W (PERF.md), printed beside this run's in the text lines
# only: the two NextGEQ kernels' (a warp a cursor; events),
# pivot_select's (scattered stores; on the card alone) and
# embedding_bag's (a block staging 16 bags; on the card alone, from
# kernel_ab.py)
PREVIOUS_MS = {"decode_search": 0.4382, "ef_search": 1.5599,
               "pivot_select": 0.0156, "embedding_bag": 0.0609}
# cursor counts of decode_search launches that leave a warp's run of
# cursors unfinished, and the edge tiles of ef_search
SEARCH_TAILS = (1, 7, 9, (1 << 20) + 3)
EF_EDGE_TILES = ("all-high-equal", "runs-of-one-l0", "runs-of-one-l15",
                 "l0-full", "padded", "base-near-int-min", "base-near-int-max")
DEVICE_REPS = 50  # calls queued behind the spin kernel for a device-only time
# a wrapper's host time: the least of HOST_ROUNDS runs of HOST_REPS calls
HOST_REPS = 200
HOST_ROUNDS = 5
# embedding_bag's edge launches: every D and K of these, B bags (not a
# multiple of the 8 bags a warp takes at D <= 16) over V rows
BAG_EDGE_D = (1, 3, 16, 17, 128, 300)
BAG_EDGE_K = (1, 33, 64, 65)
BAG_EDGE_B = 1003
BAG_EDGE_V = 4099
# pivot_select's edge launches: cursor counts that leave a block's 8 warps
# unfilled, and the path's largest launch (MAX_BUCKET) plus 3
PIVOT_EDGE_N = (1, 7, 8, 9, 33, (1 << 14) + 3)
# the recsys train phase: the full DCN-v2 config at its train_batch shape
RECSYS_ARCH = "dcn-v2"
RECSYS_SHAPE = "train_batch"
RECSYS_WARMUP = 1  # steps before the timed ones
RECSYS_STEPS = 5  # timed steps
RECSYS_CHECK = 4096  # examples whose logits are held to a CPU forward
RECSYS_PROFILE = 2  # steps traced by torch.profiler
SMOKE_STEPS = 3  # smoke-config steps held card against CPU
SMOKE_BATCH = 64
# phase 3's sequential archs at full width, through launch.train: timed
# steps (a warm-up and 5 more), then the same steps through
# FaultTolerantRunner, a checkpoint every SEQ_SAVE_EVERY steps and a
# simulated failure at step SEQ_FAIL_AT
SEQ_ARCHS = ("din", "bst")
SEQ_STEPS = 6
SEQ_SAVE_EVERY = 2
SEQ_FAIL_AT = 3
SERVE_REPS = {"serve_p99": 20, "serve_bulk": 3}  # timed calls a shape
RETRIEVAL_REPS = 2
RETRIEVAL_CHECK = 256  # candidates held to a CPU retrieval
# retrieval's memory is measured on RETRIEVAL_PROBE candidates; the run
# takes the shape's candidates if they fit in RETRIEVAL_MEM_SHARE of the
# card's free memory, else the largest power of two that does
RETRIEVAL_PROBE = 1 << 16
RETRIEVAL_MEM_SHARE = 0.85
DEVICE_LIST_PROBES = 1024  # phase 4's NextGEQ probes through DeviceList
# H100 SXM float32 rate outside the tensor cores (NVIDIA data sheet): the
# trainer's matmuls run in full f32, TF32 off
F32_PEAK = 67e12
# H100 SXM dense bf16 rate (NVIDIA data sheet, 700 W): the LM's mfu
BF16_PEAK = 989e12
# phase 3c, the LM family (models/transformer.py) at full width: qwen3-0.6b
# trained at train_4k's sequence length, its batch the largest power of two
# whose peak (forward and backward measured at LM_PROBE_BATCHES sequences,
# AdamW's update at the first) fits LM_MEM_SHARE of the free memory, timed
# at no more than LM_BATCH_CAP (the run's time limit); 1 + 5 timed steps,
# 2 traced; the restart
# check at LM_RESTART_BATCH; prefill at prefill_32k's length; decode on
# decode_32k's cache from a prefill of LM_DECODE_PREFILL tokens, its batch
# the largest power of two whose measured memory fits LM_DECODE_MEM_SHARE
# (the cache is allocated once and does not grow)
LM_ARCH = "qwen3-0.6b"
LM_PROBE_BATCHES = (1, 2)
LM_BATCH_CAP = 8
LM_MEM_SHARE = 0.85
LM_DECODE_MEM_SHARE = 0.95
LM_WARMUP = 1
LM_STEPS = 5
LM_PROFILE = 2
LM_RESTART_BATCH = 1
LM_RESTART_STEPS = 4
LM_SAVE_EVERY = 2
LM_FAIL_AT = 3
LM_CHECK_TOKENS = 256  # a prompt whose logits are held to a CPU forward
LM_CHUNK_CHECK = 2048  # chunked attention held to full attention
LM_HOLD_PREFILL, LM_HOLD_LEN = 1984, 2048  # decode held to a prefill
LM_DECODE_PREFILL = 31 * 1024
LM_DECODE_STEPS = 32
# the held tolerances: at bf16 (the config) each op rounds to 8 bits and
# the card's matmuls sum in another order than the CPU's (or than the other
# path's), so logits and hidden states are held to a relative L2 error of
# LM_BF16_REL (a few ulps of drift); at f32 (TF32 off) to LM_F32_REL.  An
# MoE is held at f32 only: at bf16 those ulps flip a router's near-tie
# between the two sides, which sends a token to another expert and moves
# its logits by a whole expert's output (its bf16 errors are printed)
LM_BF16_REL = 1e-2
LM_F32_REL = 1e-4
# moonshot and mixtral at full width: depth from measured memory
MOONSHOT_ARCH, MOONSHOT_STEPS, MOONSHOT_DECODE = "moonshot-v1-16b-a3b", 3, 8
MOE_CHECK_SEQ = 16  # the reference test's sequence length
MIXTRAL_ARCH, MIXTRAL_PREFILL, MIXTRAL_DECODE = "mixtral-8x22b", 8192, 64
MIXTRAL_HOLD = 4096  # decode from here past the window, held to a prefill
LM_SMOKE_BATCH, LM_SMOKE_SEQ, LM_SMOKE_DECODE = 4, 32, 20
LM_EXAMPLE_STEPS = 40
LM_PHASE_S = 180.0
DEVICE = "cuda"


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def sm_clock_hz() -> float:
    """The card's maximum SM clock (``nvidia-smi clocks.max.sm``), in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    try:
        return float(out.stdout.strip().splitlines()[0]) * 1e6
    except (ValueError, IndexError):
        fail(f"nvidia-smi gave no SM clock: {out.stdout!r} {out.stderr!r}")


def event_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs (after one warm-up),
    from CUDA events around the whole run."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def chunked(plain, n: int, *args, per_cursor=(), chunk=PLAIN_CHUNK):
    """Run a plain version over ``n`` cursors in chunks (its intermediates
    are ~10 KB per cursor); ``per_cursor`` names the positional args that
    are sliced, the rest are passed whole."""
    import torch

    outs = []
    for s in range(0, n, chunk):
        a = [x[s : s + chunk] if i in per_cursor else x
             for i, x in enumerate(args)]
        outs.append(plain(*a))
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def compare_f32(got, want) -> tuple[int, float]:
    """(rows whose float32 bits differ anywhere, max |difference|): the f32
    BM25 contract is bit-exact, so the bits are compared, not values
    within a tolerance."""
    import torch

    g = got.reshape(got.shape[0], -1).contiguous()
    w = want.reshape(want.shape[0], -1).contiguous()
    bad = (g.view(torch.int32) != w.view(torch.int32)).any(1)
    err = float((g - w).abs().max()) if g.numel() else 0.0
    return int(bad.sum()), err


def compare(got, want) -> tuple[int, int]:
    """(mismatching cursors or rows, max |difference|) of integer outputs."""
    import torch

    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    bad = torch.zeros(got[0].shape[0], dtype=torch.bool, device=got[0].device)
    err = 0
    for g, w in zip(got, want):
        d = (g.long() - w.long()).abs()
        d = d.reshape(d.shape[0], -1)
        bad |= (d != 0).any(1)
        err = max(err, int(d.max()) if d.numel() else 0)
    return int(bad.sum()), err


def block_last(arena) -> np.ndarray:
    """Last real docID of every block (its key without the list offset)."""
    return arena.block_keys - arena.part_list[arena.part_of_block] * arena.stride


def search_probes(rng, arena, b: np.ndarray) -> np.ndarray:
    """One probe per cursor on block ``b``: drawn from just below the
    block's base to just past its last real value, and every 64th past
    every lane of the row (2^31-1)."""
    n = len(b)
    lo = arena.block_base[b] - 1
    hi = block_last(arena)[b] + 2
    probes = lo + (rng.random(n) * (hi - lo + 1)).astype(np.int64)
    probes[::64] = I32_MAX
    return probes.astype(np.int32)


def near_max_rows(rng):
    """A small synthetic arena whose last lanes sit just below 2^31 - 1,
    with cursors at base, on a lane, one past it and past the row."""
    from repro_torch.kernels.vbyte_decode.ops import pack_blocks

    nb = 64
    steps = 1 + rng.integers(0, 1 << rng.integers(1, 24, (nb, 1)), (nb, 128))
    steps[0, :4] = [1, (1 << 8) + 1, (1 << 16) + 1, (1 << 24) + 1]
    base = I32_MAX - steps.sum(1) - rng.integers(0, 3, nb)
    vals = base[:, None] + np.cumsum(steps, 1)
    lens, data, _ = pack_blocks((steps - 1).astype(np.uint32).reshape(-1))
    rows = np.repeat(np.arange(nb), 6)
    lane = rng.integers(0, 128, len(rows))
    pick = np.stack([base, base + 1, vals[:, 0], vals[np.arange(nb), lane[::6]],
                     vals[np.arange(nb), lane[::6]] + 1,
                     np.minimum(vals[:, -1] + 1, I32_MAX)], 1).reshape(-1)
    return lens, data, base, rows, pick


def run_main_path(n_lists, torch, serve, counters, QueryEngine):
    """Phase 4; returns (the serve summary, the ef engine, launches)."""
    for c in counters.values():
        c.launches = 0
    argv = ["--n-lists", str(n_lists), *SERVE_ARGS, "--device", DEVICE]
    print(f"[chip_smoke] main path: serve {' '.join(argv)}", flush=True)
    res = serve.run(serve.parse_args(argv))
    # the same index through the ef arena: every eligible block an EF tile
    t0 = time.perf_counter()
    ef_engine = QueryEngine(res["index"], codec_policy="ef", device=DEVICE)
    if not ef_engine.arena.multi:
        fail("the ef arena holds no EF tile")
    ef_queries = res["queries"][: EF_BATCHES * BATCH]
    ef_results = []
    lat = []
    for i in range(0, len(ef_queries), BATCH):
        t1 = time.perf_counter()
        ef_results += ef_engine.intersect_batch(ef_queries[i : i + BATCH])
        lat.append(time.perf_counter() - t1)
    print(f"[chip_smoke] ef arena: {ef_engine.arena.n_blocks:,} blocks, "
          f"{int((ef_engine.arena.block_codec == 1).sum()):,} EF tiles, "
          f"{ef_engine.arena.device_nbytes(DEVICE)/1e6:.1f} MB on the card; "
          f"{len(ef_queries)} queries in {len(lat)} batches, batch p50 "
          f"{np.percentile(lat, 50)*1e3:.1f} ms "
          f"({time.perf_counter()-t0:.1f}s with the arena build)", flush=True)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    print(f"[chip_smoke] main-path launches: {launches}", flush=True)
    for k, n in launches.items():
        if n <= 0:
            fail(f"kernel {k} was never launched on the main path")
    # correctness by the repo's own means: the scalar NextGEQ loop
    idx, n_check = res["index"], min(CHECK_QUERIES, len(res["queries"]))
    t0 = time.perf_counter()
    for i, q in enumerate(res["queries"][:n_check]):
        want = idx.intersect_scalar(q)
        if not np.array_equal(res["results"][i], want):
            fail(f"auto arena: batched result of query {q} != scalar loop")
        if i < len(ef_results) and not np.array_equal(ef_results[i], want):
            fail(f"ef arena: batched result of query {q} != scalar loop")
    print(f"[chip_smoke] results identical to the scalar loop on {n_check} "
          f"queries (auto arena) and {min(n_check, len(ef_results))} (ef "
          f"arena) ({time.perf_counter()-t0:.1f}s)", flush=True)
    return res, ef_engine, launches


def run_examples_path(res, torch, counters, card) -> dict:
    """Phase 4's second part: ``core.jax_engine.DeviceList`` over the two
    longest lists of the boolean path's index (decoded by the CUDA
    ``decode_blocks``), its AND and DEVICE_LIST_PROBES NextGEQ probes held
    exactly to numpy; then the paper's two examples, ``quickstart.run``
    and ``index_serving.run``, on the card, whose asserts must pass.  The
    launch counts are set to 0 just before and read just after; returns
    them."""
    from repro_torch.core.jax_engine import DeviceList
    from repro_torch.examples import index_serving, quickstart

    t_piece = time.perf_counter()
    idx = res["index"]
    longest = np.argsort(idx.list_sizes, kind="stable")[-2:][::-1]
    lists = [idx.host_engine.decode_list(int(t)) for t in longest]
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    a, b = (DeviceList(l, device=DEVICE) for l in lists)
    up_s = time.perf_counter() - t0
    dec = a.decode()
    hits = a.intersect(b)
    rng = np.random.default_rng(6)
    hi = int(lists[0][-1])
    probes = np.concatenate([[0, lists[0][0], hi, hi + 1, I32_MAX],
                             rng.integers(0, hi + 1000, DEVICE_LIST_PROBES - 5)])
    got = a.next_geq_batch(probes).cpu().numpy()
    torch.cuda.synchronize()
    dl_launches = {k: c.launches for k, c in counters.items()}
    if dl_launches["decode_blocks"] != 4:
        fail(f"DeviceList: decode_blocks launched {dl_launches['decode_blocks']} "
             "times for 4 decodes")
    if not np.array_equal(dec.cpu().numpy(), lists[0]):
        fail("DeviceList: the decoded list differs from the host's")
    h = hits.cpu().numpy()
    inter = np.intersect1d(lists[0], lists[1])
    if not np.array_equal(h[h >= 0], inter) or len(h) != len(lists[0]):
        fail("DeviceList: intersect differs from numpy")
    ks = np.searchsorted(lists[0], probes)
    want = np.where(ks < len(lists[0]),
                    lists[0][np.minimum(ks, len(lists[0]) - 1)], -1)
    past = int((want == -1).sum())
    if not np.array_equal(got, want) or past < 2:
        fail(f"DeviceList: next_geq_batch differs from numpy ({past} probes "
             "past the end)")
    decode_ms = event_ms(a.decode, 5)
    and_ms = event_ms(lambda: a.intersect(b), 5)
    line = {"lists": [int(t) for t in longest],
            "postings": [len(l) for l in lists], "blocks": [int(x.lens.shape[0])
                                                            for x in (a, b)],
            "hits": int(inter.size), "probes": len(probes), "past_end": past,
            "upload_s": up_s, "decode_ms": decode_ms, "intersect_ms": and_ms,
            "launches": dl_launches, "card": card}
    print(f"[chip_smoke] device list: {json.dumps(line)}", flush=True)
    del a, b, dec, hits

    # the paper's two examples on the card
    for name, ex in (("quickstart", quickstart), ("index_serving", index_serving)):
        t0 = time.perf_counter()
        out = ex.run(device=DEVICE)
        print(f"[chip_smoke] example {name}: {json.dumps(out)} "
              f"({time.perf_counter()-t0:.1f}s)", flush=True)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    if (launches["decode_blocks"] < dl_launches["decode_blocks"] + 3
            or launches["decode_search"] <= 0):
        fail(f"the examples did not launch decode_blocks (its DeviceList) and "
             f"decode_search (its engine): {launches}")
    print(f"[chip_smoke] device list and examples launches: {launches}; piece "
          f"{time.perf_counter()-t_piece:.1f}s", flush=True)
    return launches


def span_ms() -> dict:
    """Summed wall ms of each ``repro_torch.obs`` span since its reset."""
    from repro_torch import obs

    spans = {}
    for (kind, name, labels), m in obs.REGISTRY.items():
        if kind == "Histogram" and name == "span_ms":
            span = dict(labels).get("span")
            spans[span] = spans.get(span, 0.0) + m.sum
    return spans


def profile_batches(torch, serve_batch, queries, card, label) -> dict:
    """Where a batch's time goes, over PROFILE_BATCHES batches of
    ``serve_batch`` (see ``profile_calls``)."""
    batches = [queries[i : i + BATCH]
               for i in range(0, PROFILE_BATCHES * BATCH, BATCH)]
    return profile_calls(torch, [lambda b=b: serve_batch(b) for b in batches],
                         card, label, "batches")


def profile_calls(torch, calls, card, label, unit, timing=None, cpu=True) -> dict:
    """Device time per kernel from ``torch.profiler`` against the wall time
    of ``calls``, and the host spans of ``repro_torch.obs``; returns the
    device ms by name (and puts the wall and busy ms into ``timing``).
    ``cpu=False`` records the device's activity alone (the host's ops are
    not read here; a trace of many of them takes long to process)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs

    obs.reset()
    obs.enable()
    acts = [ProfilerActivity.CPU] if cpu else []
    with profile(activities=acts + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for call in calls:
            call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    obs.enable(False)
    # device-side events only (kernels, memcpys): a CPU op's device time
    # repeats the time of the kernels it launched
    dev = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CPU and ev.self_device_time_total > 0:
            name = ev.key[:72]
            dev[name] = dev.get(name, 0.0) + ev.self_device_time_total / 1e3
    spans = span_ms()
    busy = sum(dev.values())
    if timing is not None:
        timing.update(wall_ms=wall_ms, busy_ms=busy)
    top = dict(sorted(dev.items(), key=lambda kv: -kv[1])[:8])
    print(f"[chip_smoke] {label} profile over {len(calls)} {unit}: wall "
          f"{wall_ms:.1f} ms, device busy {busy:.2f} ms "
          f"({busy / wall_ms:.2%}), idle {1 - busy / wall_ms:.2%} [{card}]")
    print(f"[chip_smoke] {label} profile device ms by name: "
          f"{json.dumps({k: round(v, 4) for k, v in top.items()})}")
    print(f"[chip_smoke] {label} profile host span ms: "
          f"{json.dumps({k: round(v, 1) for k, v in spans.items()})}", flush=True)
    return dev


def profile_ms(dev: dict, kernel: str) -> float:
    """A kernel's device ms in a profile, summed over the names holding it."""
    return sum(v for k, v in dev.items() if kernel in k)


def kernel_row(launches, card, name, src, replaces, mism, err, ms, plain_ms,
               nbytes, what, ops_bound=None, note=None) -> dict:
    """Print one kernel's check and return its row of the ``kernels`` line;
    fails on any mismatch against the plain version.

    The bound is ``nbytes`` over the memory rate, or ``ops_bound`` = (ms,
    how it was counted) for a kernel bound by its operations; ``note``
    adds keys to the row."""
    if ops_bound is None:
        bound_ms, bound_by = nbytes / HBM_BYTES_PER_S * 1e3, "bytes"
        how = f"{nbytes/1e6:.1f} MB at {HBM_BYTES_PER_S/1e12:.2f} TB/s"
    else:
        (bound_ms, how), bound_by = ops_bound, "operations"
    print(f"[chip_smoke] {name}: {what}: {mism} mismatches, kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({how}) [{card}]", flush=True)
    if mism:
        fail(f"{name}: {mism} mismatches against its plain version")
    return {
        "name": name, "route": "cuda", "source": src, "replaces": replaces,
        "launches": launches[name], "launches_main_path": launches[name],
        "mismatches": mism, "max_abs_err": err, "ms": ms, "kernel_ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, **(note or {}),
    }


def wrap32(x):
    """int64 values (numpy or torch) narrowed to int32 as the reference's
    int32 arithmetic wraps them."""
    return (x + 2**31) % 2**32 - 2**31


def ef_edge_cases(rng):
    """(lo, hi, lbits, bases, rows, probes): the edge tiles of ef_search,
    packed by ``ef_pack_blocks``, each with probes at hp = 0, hp = 255 and
    hp > 255, at and below its base, that wrap past 2^31 in the rebase,
    and on and one past 12 random lanes."""
    from repro_torch.kernels.ef_search.ops import ef_pack_blocks

    vals, bases = [], []
    for kind in EF_EDGE_TILES:
        base = int(rng.integers(-1, 50_000))
        if kind == "all-high-equal":  # l = 15, every high part 200
            r = (200 << 15) + np.sort(rng.choice(1 << 15, 128, replace=False))
        elif kind == "runs-of-one-l0":  # l = 0, every high part distinct
            r = np.sort(rng.choice(200, 128, replace=False))
        elif kind == "runs-of-one-l15":  # l = 15, high parts 0, 2, .., 252, 255
            r = ((np.append(np.arange(127) * 2, 255) << 15)
                 + rng.integers(0, 1 << 15, 128))
        elif kind == "l0-full":  # l = 0, high parts 0..127
            r = np.arange(128)
        elif kind == "padded":  # 40 values, then the last one repeated
            r = np.sort(rng.choice(70_000, 40, replace=False))
            r = np.append(r, np.full(88, r[-1]))
        elif kind == "base-near-int-min":
            base = -(2**31) + 10
            r = np.sort(rng.choice(1 << 20, 128, replace=False))
        else:  # base-near-int-max
            r = np.sort(rng.choice(1 << 20, 128, replace=False))
            base = I32_MAX - 2 - int(r[-1])
        vals.append(base + 1 + r.astype(np.int64))
        bases.append(base)
    vals, bases = np.asarray(vals), np.asarray(bases, np.int64)
    lo, hi, lbits = ef_pack_blocks(vals, bases)
    rows, probes = [], []
    for t, (v, base) in enumerate(zip(vals, bases)):
        l = int(lbits[t])
        top = base + 1 + (255 << l)
        lanes = rng.integers(0, 128, 12)
        p = [base - (1 << 20), base - 1, base, base + 1, base + (1 << l), top,
             top + (1 << l) // 2, top + (1 << l) - 1, base + 1 + (256 << l),
             base + 1 + (256 << l) + 77, I32_MAX, -(2**31), -(2**31) + 3,
             I32_MAX - 5, *v[lanes], *(v[lanes] + 1)]
        probes += [wrap32(int(x)) for x in p]
        rows += [t] * len(p)
    return lo, hi, lbits, bases, np.asarray(rows), np.asarray(probes)


def ef_bounds(torch, args_ef, want_rank, n_tiles) -> dict:
    """ef_search's bound, counted two ways (bytes over the memory rate).

    What these inputs need: each tile a cursor searches, its 96 B of high
    words; each tile, its l, base and codec row (12 B); each cursor, its
    row, probe and results (16 B) and the lanes of lo the contract decides
    on: the run of equal high parts [count_lt, count_le) and the answer
    lane, none for a probe past the tile's high range.  The two counts
    come from the plain version's ranks at hp << l and (hp + 1) << l.
    The full-tile count charges every tile its 512 B of lo as well."""
    from repro_torch.kernels.ef_search import ref as efref

    lo, hi, lbits, block_base, rows, pe, codec_row = args_ef
    r = rows.long()
    base = block_base[r].long()
    l = lbits[codec_row[r].long()].long()
    hp = wrap32(pe.long() - base - 1).clamp(min=0) >> l
    search = hp <= 255

    def rank_at(h):
        p = wrap32(base + 1 + (h.clamp(max=256) << l)).int()
        return chunked(efref.ef_search_ref, len(rows), lo, hi, lbits,
                       block_base, rows, p, codec_row, per_cursor=(4, 5))[1].long()

    count_lt, count_le = rank_at(hp), rank_at(hp + 1)
    lanes = torch.where(search, count_le - count_lt + (want_rank < 128).long(), 0)
    searched = int(torch.unique(r[search]).numel())
    nbytes = searched * 96 + n_tiles * 12 + len(rows) * 16 + 4 * int(lanes.sum())
    old_bytes = n_tiles * (512 + 96 + 4 + 4 + 4) + len(rows) * (4 + 4 + 8)
    return {"bytes": nbytes, "lo_lanes": int(lanes.sum()),
            "searched_tiles": searched,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "full_tile_bytes": old_bytes,
            "full_tile_bound_ms": old_bytes / HBM_BYTES_PER_S * 1e3}


def check_kernels(torch, res, ef_engine, launches, card, profile):
    """Phase 7, the boolean kernels: each against its plain version;
    returns their rows of the ``kernels`` line.  ``profile`` is the boolean
    profile's device ms by name."""
    from repro_torch.core.arena import CODEC_EF
    from repro_torch.kernels.ef_search import kernel as efk
    from repro_torch.kernels.ef_search import ref as efref
    from repro_torch.kernels.vbyte_decode import kernel as vk
    from repro_torch.kernels.vbyte_decode import ref as vref

    rng = np.random.default_rng(1)
    cuda = torch.device(DEVICE)
    rows_out = []

    def report(*a, **kw):
        rows_out.append(kernel_row(launches, card, *a, **kw))

    def on_card(*xs):
        return [torch.from_numpy(np.asarray(x).astype(np.int32)).to(cuda)
                for x in xs]

    # -- decode_search over >= 2^20 cursors of the main path's arena ------
    a = res["engine"].arena
    dev = a.on(cuda)
    svb = (np.nonzero(a.block_codec != CODEC_EF)[0] if a.multi
           else np.arange(a.n_blocks))
    cr = dev.codec_row if a.multi else None

    def search_cursors(n):
        rows = svb[rng.integers(0, len(svb), n)]
        return rows.astype(np.int32), search_probes(rng, a, rows)

    rows, pe = search_cursors(SEARCH_CURSORS)
    t_rows, t_pe = on_card(rows, pe)
    args_ds = (dev.lens, dev.data, dev.block_base, t_rows, t_pe, cr)
    got = vk.decode_search(*args_ds)
    want = chunked(vref.decode_search_ref, len(rows), *args_ds,
                   per_cursor=(3, 4))
    mism, err = compare(got, want)
    # the synthetic rows near 2^31 - 1 (values of 1..4 bytes, edge probes)
    ln, dt, bs, er, ep = near_max_rows(rng)
    edge = [torch.from_numpy(np.asarray(x).astype(t)).to(cuda) for x, t in
            ((ln, np.int32), (dt, np.uint8), (bs, np.int32), (er, np.int32),
             (ep, np.int32))]
    m2, e2 = compare(vk.decode_search(*edge), vref.decode_search_ref(*edge))
    # launches whose last warp stops inside its run of cursors
    t0 = time.perf_counter()
    tails = {}
    for n in SEARCH_TAILS:
        tr, tp = on_card(*search_cursors(n))
        args_t = (dev.lens, dev.data, dev.block_base, tr, tp, cr)
        m3, e3 = compare(vk.decode_search(*args_t),
                         chunked(vref.decode_search_ref, n, *args_t,
                                 per_cursor=(3, 4)))
        tails[n] = m3
        m2, e2 = m2 + m3, max(e2, e3)
    tails_s = time.perf_counter() - t0
    # the same cursors in the order the engine sends them: by block, then
    # probe (a cursor on the row before it decodes nothing)
    order = np.lexsort((pe, rows))
    t_order = torch.from_numpy(order).to(cuda)
    args_sorted = (*args_ds[:3], t_rows[t_order], t_pe[t_order], cr)
    m3, e3 = compare(vk.decode_search(*args_sorted),
                     tuple(w[t_order] for w in want))
    m2, e2 = m2 + m3, max(e2, e3)
    ms = event_ms(lambda: vk.decode_search(*args_ds), 20)
    sorted_ms = event_ms(lambda: vk.decode_search(*args_sorted), 20)
    plain_ms = event_ms(lambda: chunked(vref.decode_search_ref, len(rows),
                                        *args_ds, per_cursor=(3, 4)), 2)
    # the bound: each row a cursor locates, its 512 B of lens, the bytes of
    # its data that hold values (the sum of its lens), its base and codec
    # row; each cursor, its row, probe and results (16 B).  The full-row
    # count charges every row all 512 B of data.
    u_rows = np.unique(rows)
    u = len(u_rows)
    t_u = torch.from_numpy(u_rows.astype(np.int64)).to(cuda)
    used_u = int(dev.lens[t_u if cr is None else cr[t_u].long()].sum())
    per_row = 512 + 4 + (4 if a.multi else 0)
    nbytes = u * per_row + used_u + len(rows) * (4 + 4 + 8)
    full_row_bytes = u * (per_row + 512) + len(rows) * (4 + 4 + 8)
    full_row_ms = full_row_bytes / HBM_BYTES_PER_S * 1e3
    # what the kernel stages for these cursors: each cursor's 512 B of lens
    # and the 16-byte pieces of its row that hold values
    used = dev.lens[t_rows.long() if cr is None else cr[t_rows.long()].long()].sum(1)
    staged = int((512 + (used + 15) // 16 * 16).sum()) + len(rows) * (4 + 4 + 8)
    prof = profile_ms(profile, "decode_search_kernel")
    report("decode_search", "src/repro_torch/csrc/vbyte_decode.cu",
           "src/repro/kernels/vbyte_decode/kernel.py:103",
           mism + m2, max(err, e2), ms, plain_ms, nbytes,
           f"{len(rows):,} cursors on {u:,} rows + {len(er)} near-2^31 cursors "
           f"+ launches of {', '.join(f'{n:,}' for n in SEARCH_TAILS)} cursors "
           f"({tails_s:.1f}s); {staged / 1e6:.1f} MB staged, "
           f"{staged / ms / 1e9:.2f} TB/s; bound from {used_u / 1e6:.1f} MB "
           f"of data, counting every row's 512 B {full_row_ms:.4f} ms; "
           f"sorted by block {sorted_ms:.4f} ms; previous design "
           f"{PREVIOUS_MS['decode_search']:.4f} ms; {prof:.4f} ms in the "
           f"boolean profile's {PROFILE_BATCHES} batches",
           note={"full_row_bound_ms": full_row_ms,
                 "sorted_ms": sorted_ms,
                 "staged_bytes": staged,
                 "tail_mismatches": tails, "tails_s": tails_s,
                 "boolean_profile_ms": prof})

    # -- decode_blocks over every row of the arena -------------------------
    got = vk.decode_blocks(dev.lens, dev.data)
    n_rows = dev.lens.shape[0]
    all_rows = torch.arange(n_rows, dtype=torch.int32, device=cuda)
    want = chunked(vref.decode_blocks_ref, n_rows, dev.lens, dev.data,
                   all_rows, per_cursor=(2,))
    mism, err = compare(got, want)
    ms = event_ms(lambda: vk.decode_blocks(dev.lens, dev.data), 20)
    plain_ms = event_ms(lambda: chunked(vref.decode_blocks_ref, n_rows,
                                        dev.lens, dev.data, all_rows,
                                        per_cursor=(2,)), 2)
    report("decode_blocks", "src/repro_torch/csrc/vbyte_decode.cu",
           "src/repro/kernels/vbyte_decode/kernel.py:67",
           mism, err, ms, plain_ms, n_rows * (512 + 512 + 512),
           f"all {n_rows:,} rows")

    # -- ef_search over every EF tile of the ef arena ----------------------
    e = ef_engine.arena
    edev = e.on(cuda)
    ef_blocks = np.nonzero(e.block_codec == CODEC_EF)[0]
    # one cursor per tile, and one past each tile's high range (hp > 255
    # gives rank 128)
    r1 = ef_blocks.astype(np.int32)
    p1 = search_probes(rng, e, ef_blocks)
    lb = e.ef_lbits[e.codec_row[ef_blocks]].astype(np.int64)
    p2 = np.minimum(e.block_base[ef_blocks] + 1 + (256 << lb), I32_MAX)
    rows = np.concatenate([r1, r1])
    pe = np.concatenate([p1, p2.astype(np.int32)])
    t_rows, t_pe = on_card(rows, pe)
    args_ef = (edev.ef_lo, edev.ef_hi, edev.ef_lbits, edev.block_base, t_rows,
               t_pe, edev.codec_row)
    got = efk.ef_search(*args_ef)
    want = chunked(efref.ef_search_ref, len(rows), *args_ef, per_cursor=(4, 5))
    mism, err = compare(got, want)
    # the edge tiles and probes, in launches of 1 to all of their cursors
    t0 = time.perf_counter()
    edge = ef_edge_cases(rng)
    t_edge = on_card(*edge)
    m2, e2, n_edge = 0, 0, len(edge[4])
    for n in (1, 7, 9, n_edge):
        args_e = (*t_edge[:4], t_edge[4][:n], t_edge[5][:n])
        m3, e3 = compare(efk.ef_search(*args_e), efref.ef_search_ref(*args_e))
        m2, e2 = m2 + m3, max(e2, e3)
    edge_s = time.perf_counter() - t0
    ms = event_ms(lambda: efk.ef_search(*args_ef), 20)
    plain_ms = event_ms(lambda: chunked(efref.ef_search_ref, len(rows),
                                        *args_ef, per_cursor=(4, 5)), 2)
    t0 = time.perf_counter()
    bounds = ef_bounds(torch, args_ef, want[1].long(), len(ef_blocks))
    bounds_s = time.perf_counter() - t0
    prof = profile_ms(profile, "ef_search_kernel")
    report("ef_search", "src/repro_torch/csrc/ef_search.cu",
           "src/repro/kernels/ef_search/kernel.py:119",
           mism + m2, max(err, e2), ms, plain_ms, bounds["bytes"],
           f"{len(rows):,} cursors on all {len(ef_blocks):,} EF tiles + "
           f"{n_edge} edge cursors on {len(EF_EDGE_TILES)} edge tiles "
           f"({edge_s:.1f}s); bound counted from {bounds['lo_lanes']:,} lanes "
           f"of lo ({bounds_s:.1f}s), counting every tile's lo "
           f"{bounds['full_tile_bound_ms']:.4f} ms; previous design "
           f"{PREVIOUS_MS['ef_search']:.4f} ms; {prof:.4f} ms in the boolean "
           f"profile's {PROFILE_BATCHES} batches",
           note={"bytes_bound_ms": bounds["bound_ms"],
                 "full_tile_bound_ms": bounds["full_tile_bound_ms"],
                 "lo_lanes": bounds["lo_lanes"],
                 "edge_cursors": n_edge, "edge_s": edge_s,
                 "boolean_profile_ms": prof})
    torch.cuda.synchronize()
    return rows_out


def contrib_pairs(rng, engine, n: int):
    """(terms, docs): n/2 members drawn from the real lanes of the arena,
    the rest random docIDs of random lists, a few of them -1 or past the
    docID range."""
    a = engine.arena
    engine._flat_init()
    vals = engine.core.flat_vals[:-1]
    lanes = np.flatnonzero(a.lane_valid.reshape(-1))
    pick = lanes[rng.integers(0, len(lanes), n // 2)]
    t_mem = a.part_list[a.part_of_block[pick >> 7]]
    n_other = n - n // 2
    t_other = rng.integers(0, len(a.list_blk_offsets) - 1, n_other)
    d_other = rng.integers(-1, a.stride + 2, n_other)
    terms = np.concatenate([t_mem, t_other]).astype(np.int64)
    docs = np.concatenate([vals[pick], d_other]).astype(np.int64)
    order = rng.permutation(n)
    return terms[order], docs[order]


def run_ranked_path(n_queries, torch, serve, counters, card):
    """Phase 6; returns (the serve summary, the mirror engine, the
    contribution pairs, launches)."""
    from repro_torch.ranked.bm25 import exhaustive_topk
    from repro_torch.ranked.topk_engine import TopKEngine

    for c in counters.values():
        c.launches = 0
    argv = ["--n-lists", str(N_LISTS), *RANKED_ARGS, "--queries",
            str(n_queries), "--device", DEVICE]
    print(f"[chip_smoke] ranked path: serve {' '.join(argv)}", flush=True)
    res = serve.run(serve.parse_args(argv))
    idx, engine, queries = res["index"], res["engine"], res["queries"]
    if (engine.resident != "kernel"
            or engine.device.type != torch.device(DEVICE).type):
        fail(f"ranked engine is {engine.resident} on {engine.device}")
    # the same index through resident="mirror": the arena scored once
    t0 = time.perf_counter()
    mirror = TopKEngine(idx, resident="mirror", device=DEVICE,
                        codec_policy="auto")
    mq = queries[: MIRROR_BATCHES * BATCH]
    m_results, lat = [], []
    for i in range(0, len(mq), BATCH):
        t1 = time.perf_counter()
        m_results += mirror.topk_batch(mq[i : i + BATCH], TOPK)
        lat.append(time.perf_counter() - t1)
    for q, (gd, gs), (wd, ws) in zip(mq, m_results, res["results"]):
        if not (np.array_equal(gd, wd) and np.array_equal(gs, ws)):
            fail(f"mirror residency: top-k of query {q} != kernel residency")
    print(f"[chip_smoke] mirror residency: {len(mq)} queries identical to "
          f"the kernel residency; batch latencies "
          f"{[round(x * 1e3, 1) for x in lat]} ms, the first with the flat "
          f"and impact mirrors ({time.perf_counter()-t0:.1f}s) [{card}]",
          flush=True)
    # point lookups, held to the host path: through the auto arena (SVB
    # blocks: bm25_score_probe) and through the ef arena of the same index
    # (EF tiles: ef_search + bm25_score_rows)
    rng = np.random.default_rng(2)
    terms, docs = contrib_pairs(rng, engine, CONTRIB_PAIRS)
    ef_engine = TopKEngine(idx, resident="kernel", device=DEVICE,
                           codec_policy="ef")
    got, dt = {}, {}
    for name, eng in (("auto", engine), ("ef", ef_engine)):
        t0 = time.perf_counter()
        got[name] = eng.contributions(terms, docs)
        dt[name] = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    want = engine._contrib_np(terms, docs).view(np.int32)
    for name, eng in (("auto", engine), ("ef", ef_engine)):
        if not np.array_equal(got[name].view(np.int32), want):
            bad = int((got[name].view(np.int32) != want).sum())
            fail(f"contributions() over the {name} arena: {bad} of "
                 f"{len(terms)} differ from the host path")
        a = eng.arena
        k = np.searchsorted(a.block_keys, np.clip(docs, 0, a.stride - 1)
                            + terms * a.stride)
        n_ef = (int((a.block_codec[np.minimum(k, a.n_blocks - 1)] == 1).sum())
                if a.multi else 0)
        print(f"[chip_smoke] contributions() over the {name} arena: "
              f"{len(terms)} pairs, {int((got[name] != 0).sum())} members, "
              f"{n_ef} located on EF tiles, bit-identical to the host path "
              f"({dt[name]*1e3:.1f} ms)", flush=True)
    print(f"[chip_smoke] ranked-path launches: {launches}", flush=True)
    for name in ("bm25_score_probe", "bm25_score_rows", "pivot_select",
                 "pivot_score", "ef_search"):
        if launches[name] <= 0:
            fail(f"kernel {name} was never launched on the ranked path")
    # correctness by the repo's own means: the exhaustive oracle
    n_check = min(RANKED_CHECK, len(queries))
    t0 = time.perf_counter()
    want = exhaustive_topk(idx, queries[:n_check], TOPK)
    for q, (gd, gs), (wd, ws) in zip(queries, res["results"], want):
        if not (np.array_equal(gd, wd) and np.array_equal(gs, ws)):
            fail(f"ranked top-k of query {q} != exhaustive_topk")
    print(f"[chip_smoke] ranked top-{TOPK} identical to exhaustive_topk "
          f"(docIDs and f64 scores) on {n_check} queries "
          f"({time.perf_counter()-t0:.1f}s)", flush=True)
    return res, mirror, (terms, docs), launches


def scrape_count(port: int, metric: str) -> int:
    """``<metric>_count`` of the Prometheus text served on ``port``."""
    import urllib.request

    url = f"http://127.0.0.1:{port}/metrics"
    with urllib.request.urlopen(url, timeout=30) as r:
        text = r.read().decode()
    for line in text.splitlines():
        if line.startswith(f"{metric}_count "):
            return int(line.split()[1])
    fail(f"/metrics has no {metric}_count line")


def run_loop_path(rres, torch, serve, counters, card):
    """Phase 6b: ``serve --ranked --loop`` over phase 6's engine and
    queries, at half and at twice phase 6's q/s, with obs armed and its
    registry served on an ephemeral port; returns the launch counts."""
    from repro_torch import obs

    engine, queries, want = rres["engine"], rres["queries"], rres["results"]
    t_phase = time.perf_counter()
    base = ["--ranked", "--loop", "--topk", str(TOPK), "--batch", str(BATCH),
            "--seed", RANKED_ARGS[RANKED_ARGS.index("--seed") + 1],
            "--device", DEVICE,
            "--max-delay-ms", str(LOOP_MAX_DELAY_MS)]
    runs = {
        "half": ["--offered-qps", repr(0.5 * rres["qps"]),
                 "--duration", str(LOOP_HALF_S)],
        "overload": ["--offered-qps", repr(2.0 * rres["qps"]),
                     "--duration", str(LOOP_OVER_S),
                     "--max-queue", str(LOOP_OVER_QUEUE), "--deadline-ms",
                     repr(LOOP_DEADLINE_X * rres["batch_p99_s"] * 1e3)],
        "expiry": ["--offered-qps", repr(2.0 * rres["qps"]),
                   "--duration", str(LOOP_EXPIRE_S),
                   "--max-queue", str(LOOP_OVER_QUEUE), "--deadline-ms",
                   repr(LOOP_EXPIRE_X * rres["batch_p50_s"] * 1e3)]}
    for c in counters.values():
        c.launches = 0
    obs.reset()
    obs.enable()
    server = obs.MetricsServer(0)
    try:
        summaries = {}
        for name, extra in runs.items():
            argv = base + extra
            print(f"[chip_smoke] loop path ({name}): serve {' '.join(argv)}",
                  flush=True)
            summaries[name] = serve.serve_loop(serve.parse_args(argv), engine,
                                               queries)
        torch.cuda.synchronize()
        launches = {k: c.launches for k, c in counters.items()}
        n_hist = scrape_count(server.port, "serve_request_ms")
    finally:
        server.close()
        obs.enable(False)
    print(f"[chip_smoke] loop-path launches: {launches}", flush=True)
    for name in LOOP_KERNELS:
        if launches[name] <= 0:
            fail(f"kernel {name} was never launched on the loop path")
    for name, summ in summaries.items():
        if not summ["served"]:
            fail(f"loop path ({name}) served no request")
        ends = summ["served"] + summ["expired"] + summ["shed"]
        if ends != summ["arrivals"]:
            fail(f"loop path ({name}): {summ['arrivals']} arrivals but "
                 f"{ends} served, expired or shed")
        bad = 0
        for i, res in summ["results"]:
            wd, ws = want[i]
            if not (res.docs.dtype == wd.dtype and res.scores.dtype == ws.dtype
                    and np.array_equal(res.docs, wd)
                    and np.array_equal(res.scores.view(np.uint64),
                                       ws.view(np.uint64))):
                bad += 1
        if bad:
            fail(f"loop path ({name}): {bad} of {summ['served']} served "
                 "results differ from the ranked path's")
        line = {k: v for k, v in summ.items() if k != "results"}
        line.update(run=name, mismatches=bad, card=card)
        print(f"[chip_smoke] loop path: {json.dumps(line)}", flush=True)
    if not summaries["overload"]["shed"]:
        fail("loop path (overload): nothing was shed at twice the ranked "
             "path's q/s")
    if not summaries["expiry"]["expired"]:
        fail("loop path (expiry): no request expired under a deadline of "
             f"{LOOP_EXPIRE_X} x the ranked path's batch p50")
    outcomes = sum(s["served"] + s["expired"] for s in summaries.values())
    if n_hist != outcomes:
        fail(f"/metrics serve_request_ms_count {n_hist} != served + expired "
             f"{outcomes}")
    print(f"[chip_smoke] loop path: every served result bit-identical to "
          f"the ranked path's; /metrics serve_request_ms_count {n_hist} = "
          f"served + expired; phase {time.perf_counter()-t_phase:.1f}s "
          f"[{card}]", flush=True)
    return launches


def same_topk(got, want) -> bool:
    """Top-k lists equal: docIDs, and f64 scores bit for bit."""
    return len(got) == len(want) and all(
        np.array_equal(gd, wd) and gs.dtype == ws.dtype
        and np.array_equal(gs.view(np.uint64), ws.view(np.uint64))
        for (gd, gs), (wd, ws) in zip(got, want))


def shard_line(name, engine, summ, launches, card, base_qps,
               **extra) -> dict:
    """The ``shard path:`` JSON record of one phase 6c run; ``base_qps``
    is the unsharded engine's q/s on the same queries in the same run."""
    sa = engine.sharded
    f = summ.get("faults") or {}
    line = {
        "run": name,
        "mode": "shard_map" if sa.mesh is not None else "host_loop",
        "shards": sa.n_shards, "replicas": sa.replicas,
        "qps": summ["qps"], "unsharded_qps": base_qps,
        "vs_unsharded": summ["qps"] / base_qps,
        "batch_p50_ms": summ["batch_p50_s"] * 1e3,
        "batch_p99_ms": summ["batch_p99_s"] * 1e3,
        "batch_ms": [t * 1e3 for t in summ["batch_s"]],
        "availability": f.get("availability", 1.0),
        "failures": f.get("failures", 0), "failovers": f.get("failovers", 0),
        "recoveries": f.get("recoveries", 0),
        "recovery_p99_ms": (f["recovery_p99_s"] * 1e3
                            if f.get("recoveries") else None),
        "shard_device_bytes": sa.shard_device_nbytes(),
        "launches": {k: v for k, v in launches.items() if v}, "card": card,
        **extra,
    }
    print(f"[chip_smoke] shard path: {json.dumps(line)}", flush=True)
    return line


def run_shard_path(res, rres, torch, serve, counters, card):
    """Phase 6c: sharded serving with replicas, fault injection, arena
    checkpoints and shard recovery over phase 4's and phase 6's indexes
    and queries; returns the launch counts summed over its runs."""
    import contextlib
    import io

    from repro_torch.api import EngineConfig, make_query_engine, make_topk_engine
    from repro_torch.core.query_engine import QueryEngine
    from repro_torch.distributed.resilient import (
        HEALTHY,
        ResilientEngine,
        ShardFaultInjector,
    )

    t_phase = time.perf_counter()
    idx, queries = res["index"], res["queries"][:SHARD_QUERIES]
    want = res["results"][:SHARD_QUERIES]
    ridx, rqueries = rres["index"], rres["queries"][:SHARD_QUERIES]
    rwant = rres["results"][:SHARD_QUERIES]
    rng = np.random.default_rng(3)
    cterms, cdocs = contrib_pairs(rng, rres["engine"], CONTRIB_PAIRS)
    cwant = rres["engine"]._contrib_np(cterms, cdocs).view(np.int32)
    base = ["--batch", str(BATCH), "--seed", "0", "--device", DEVICE,
            "--queries", str(SHARD_QUERIES)]
    totals: dict = {}

    # the unsharded engines of phases 4 and 6 (warm) on the same queries:
    # the q/s every run is compared with
    def qps_of(serve_batch, qs):
        t0 = time.perf_counter()
        for i in range(0, len(qs), BATCH):
            serve_batch(qs[i : i + BATCH])
        return len(qs) / (time.perf_counter() - t0)

    bool_qps = qps_of(res["engine"].intersect_batch, queries)
    ranked_qps = qps_of(lambda b: rres["engine"].topk_batch(b, TOPK),
                        rqueries)
    print(f"[chip_smoke] depth cut: phase 6c serves {SHARD_QUERIES} queries "
          "a run, not 256 (192 until the LM phase), to make room for the "
          "recsys phase's sequential archs and sparse step and for the LM "
          "phase", flush=True)
    print(f"[chip_smoke] shard path: the unsharded engines on the same "
          f"{len(queries)} queries: boolean {bool_qps:.2f} q/s, ranked "
          f"{ranked_qps:.2f} q/s [{card}]", flush=True)

    def counted(fn, need):
        for c in counters.values():
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        launches = {k: c.launches for k, c in counters.items()}
        for k in need:
            if launches[k] <= 0:
                fail(f"kernel {k} was never launched on the shard path")
        for k, n in launches.items():
            totals[k] = totals.get(k, 0) + n
        return out, launches

    def check_contrib(engine, name):
        got = engine.contributions(cterms, cdocs).view(np.int32)
        if not np.array_equal(got, cwant):
            fail(f"shard path ({name}): contributions() differ from the "
                 f"host path on {int((got != cwant).sum())} pairs")

    # (a) boolean replica failover, the auto (multi-codec) arena: host loop
    args = serve.parse_args(["--n-lists", str(len(idx.list_sizes)), *base,
                             "--codec", "auto", "--shards", str(SHARDS),
                             "--replicas", "2", "--faults", "1"])
    summ, launches = counted(lambda: serve.serve_boolean(args, idx, queries),
                             ["decode_search"])
    f = summ["faults"]
    if f["availability"] != 1.0 or f["failovers"] < 1:
        fail(f"shard path (a): availability {f['availability']}, "
             f"failovers {f['failovers']}")
    if not all(np.array_equal(g, w) for g, w in zip(summ["results"], want)):
        fail("shard path (a): a failed-over answer differs from phase 4's")
    shard_line("a-boolean-failover", summ["engine"], summ, launches, card,
               bool_qps)
    summ = None  # frees the run's engine and its shards before the next
    torch.cuda.empty_cache()

    # (b) boolean checkpoint recovery, then degradation without replicas
    args = serve.parse_args(["--n-lists", str(len(idx.list_sizes)), *base,
                             "--codec", "auto", "--shards", str(SHARDS),
                             "--faults", "1", "--recover"])
    summ, launches = counted(lambda: serve.serve_boolean(args, idx, queries),
                             ["decode_search"])
    f = summ["faults"]
    p99 = f["recovery_p99_s"]
    if (f["recoveries"] != 1 or not np.isfinite(p99)
            or f["health"] != [HEALTHY] * SHARDS):
        fail(f"shard path (b): recoveries {f['recoveries']}, p99 {p99}, "
             f"health {f['health']}")
    if not all(np.array_equal(g, w) for g, w in zip(summ["results"], want)):
        fail("shard path (b): an answer served around the recovery differs "
             "from phase 4's")
    print(f"[chip_smoke] shard path (b): arena checkpoint "
          f"{f['checkpoint_bytes']:,} B on disk (arena "
          f"{summ['engine'].arena.nbytes():,} B in memory), save "
          f"{f['checkpoint_s']:.3f}s, shard restore {f['restore_s']}s, "
          f"recovery p99 {p99 * 1e3:.1f} ms [{card}]", flush=True)
    shard_line("b-boolean-recover", summ["engine"], summ, launches, card,
               bool_qps, checkpoint_bytes=f["checkpoint_bytes"],
               checkpoint_s=f["checkpoint_s"], restore_s=f["restore_s"])
    summ = None  # frees the run's engine and its shards before the next
    torch.cuda.empty_cache()
    deg = ResilientEngine(
        make_query_engine(idx, args.cfg.replace(fault_injector=None)),
        injector=ShardFaultInjector(at_batches=(1,), shards=(0,)))
    (got, _, n_deg), launches = counted(
        lambda: serve.serve_resilient(deg, queries, BATCH), ["decode_search"])
    missing = set(deg.sa.unserved_lists().tolist())
    # shard 0 is dead from batch 1 on: a query served there that touches a
    # lost list gets the answer of its live terms, every other query
    # phase 4's
    lost = [i >= BATCH and any(t in missing for t in q)
            for i, q in enumerate(queries)]
    live = [[t for t in q if t not in missing] for q in queries]
    restricted = res["engine"].intersect_batch(live)
    bad = sum(not np.array_equal(g, r if x else w)
              for g, w, r, x in zip(got, want, restricted, lost))
    if not missing or n_deg != sum(lost) or bad:
        fail(f"shard path (b): {len(missing)} lists lost, {n_deg} degraded "
             f"queries of {sum(lost)} after the fault that touch them, {bad} "
             "answers not the live-restricted ones where degraded and "
             "phase 4's elsewhere")
    print(f"[chip_smoke] shard path (b): without replicas or checkpoint "
          f"{len(missing)} lists lost, {n_deg} of {len(queries)} queries "
          "degraded, each equal to phase 4's answer of the query restricted "
          "to live lists", flush=True)
    del deg
    torch.cuda.empty_cache()

    # (c) ranked replica failover over phase 6's index: host loop
    args = serve.parse_args(["--n-lists", str(len(ridx.list_sizes)), *base,
                             "--ranked", "--topk", str(TOPK), "--resident",
                             "kernel", "--codec", "auto", "--shards",
                             str(SHARDS), "--replicas", "2", "--faults", "1"])

    def ranked_c():
        out = serve.serve_ranked(args, ridx, rqueries)
        check_contrib(out["engine"], "c")
        return out

    summ, launches = counted(ranked_c, ["bm25_score_probe", "pivot_select"])
    f = summ["faults"]
    if f["availability"] != 1.0 or f["failovers"] < 1:
        fail(f"shard path (c): availability {f['availability']}, "
             f"failovers {f['failovers']}")
    if summ["engine"].resident != "kernel" or not same_topk(summ["results"],
                                                              rwant):
        fail("shard path (c): a failed-over top-k differs from phase 6's")
    shard_line("c-ranked-failover", summ["engine"], summ, launches, card,
               ranked_qps)
    summ = None  # frees the run's engine and its shards before the next
    torch.cuda.empty_cache()

    # (d) the device-list dispatch: four shards on one card, one fault
    mesh = [torch.device(DEVICE, 0)] * SHARDS
    cfg = EngineConfig(device=DEVICE, shards=SHARDS, replicas=2,
                       shard_mesh=mesh, codec_policy="svb")

    def dispatch_run(name, make, need, serve_fn, check, base_qps):
        def go():
            t0 = time.perf_counter()
            engine = make()
            banner = io.StringIO()
            with contextlib.redirect_stdout(banner):
                serve._print_shard_layout(engine)
            print(banner.getvalue(), end="", flush=True)
            if f"shard_map over {SHARDS} devices" not in banner.getvalue():
                fail(f"shard path ({name}): banner {banner.getvalue()!r}")
            serve_fn(engine, queries[:BATCH])  # warm-up: uploads, mirrors
            rs = ResilientEngine(engine, injector=ShardFaultInjector(
                at_batches=(1,), shards=(0,)), backoff_s=1e-3)
            t1 = time.perf_counter()
            out, lat, n_deg = serve_fn(rs, None)
            wall = time.perf_counter() - t1
            check(engine, out)
            return engine, rs, {
                "qps": SHARD_QUERIES / wall,
                "batch_p50_s": float(np.percentile(lat, 50)),
                "batch_p99_s": float(np.percentile(lat, 99)),
                "batch_s": lat,
                "faults": serve._print_fault_summary(rs, SHARD_QUERIES,
                                                     n_deg),
                "set_up_s": t1 - t0,
            }

        (engine, rs, summ), launches = counted(go, need)
        f = summ["faults"]
        if f["availability"] != 1.0 or f["failovers"] < 1:
            fail(f"shard path ({name}): availability {f['availability']}, "
                 f"failovers {f['failovers']}")
        if engine.sharded.mesh is None or engine._smap_fn is None:
            fail(f"shard path ({name}): the device-list dispatch did not run")
        shard_line(name, engine, summ, launches, card, base_qps,
                   set_up_s=summ["set_up_s"])
        del engine, rs
        torch.cuda.empty_cache()

    def serve_bool(e, warm):
        if warm is not None:
            return e.intersect_batch(warm)
        return serve.serve_resilient(e, queries, BATCH)

    def check_bool(engine, out):
        if not all(np.array_equal(g, w) for g, w in zip(out, want)):
            fail("shard path (d): a device-list answer differs from the "
                 "host loop's")

    dispatch_run("d-boolean-shard-map", lambda: make_query_engine(idx, cfg),
                 ["decode_search"], serve_bool, check_bool, bool_qps)

    def serve_topk(e, warm):
        if warm is not None:
            return e.topk_batch(rqueries[:BATCH], TOPK)
        return serve.serve_resilient(e, rqueries, BATCH, topk=TOPK)

    def check_topk(engine, out):
        if not same_topk(out, rwant):
            fail("shard path (d): a device-list top-k differs from phase 6's")
        check_contrib(engine, "d")
        if engine._smap_pivot is None:
            fail("shard path (d): the pivot did not take the dispatch")

    dispatch_run("d-ranked-shard-map",
                 lambda: make_topk_engine(ridx, cfg.replace(resident="kernel")),
                 ["bm25_score_probe", "pivot_select"], serve_topk, check_topk,
                 ranked_qps)

    # (e) one shard, shard_mesh "auto": the dispatch path on one card,
    # bit-identical to the unsharded engine over the same svb arena, whose
    # answers and q/s are taken before the counted window (which counts the
    # 1-shard engines' launches alone)
    one = EngineConfig(device=DEVICE, shards=1, codec_policy="svb")
    e0 = QueryEngine(idx, device=DEVICE, codec_policy="svb")
    terms = rng.integers(0, len(idx.list_sizes), 1 << 16)
    probes = rng.integers(0, e0.arena.stride + 2, 1 << 16)
    search_want = e0.search_batch(terms, probes)
    e0.intersect_batch(queries[:BATCH])  # warm-up: upload, mirror
    svb_qps = qps_of(e0.intersect_batch, queries)
    del e0
    torch.cuda.empty_cache()

    def run_e():
        e1 = make_query_engine(idx, one)
        for g, w in zip(e1.search_batch(terms, probes), search_want):
            if not np.array_equal(g, w):
                fail("shard path (e): 1-shard NextGEQ differs from unsharded")
        e1.intersect_batch(queries[:BATCH])  # warm-up: mirror
        t0 = time.perf_counter()
        got, lat = serve.serve_batches(e1, queries, BATCH)
        wall = time.perf_counter() - t0
        if not all(np.array_equal(g, w) for g, w in zip(got, want)):
            fail("shard path (e): a 1-shard answer differs from phase 4's")
        t1 = make_topk_engine(ridx, one.replace(resident="kernel"))
        if not same_topk(t1.topk_batch(rqueries, TOPK), rwant):
            fail("shard path (e): a 1-shard top-k differs from phase 6's")
        check_contrib(t1, "e")
        if (e1.sharded.mesh is None or e1._smap_fn is None
                or t1._smap_fn is None or t1._smap_pivot is None):
            fail("shard path (e): shards=1 did not take the dispatch path")
        return e1, t1, {
            "qps": len(queries) / wall,
            "batch_p50_s": float(np.percentile(lat, 50)),
            "batch_p99_s": float(np.percentile(lat, 99)),
            "batch_s": lat}

    (e1, t1, summ), launches = counted(
        run_e, ["decode_search", "bm25_score_probe", "pivot_select"])
    # held to the unsharded engine over the same svb arena
    shard_line("e-one-shard", e1, summ, launches, card, svb_qps)
    del e1, t1
    torch.cuda.empty_cache()
    dt = time.perf_counter() - t_phase
    # the budget is the run's time limit shared out, not a correctness
    # gate: a slow host prints over it, and the depth is cut in the source
    print(f"[chip_smoke] shard path: runs (a)-(e) passed in {dt:.1f}s, "
          f"{'within' if dt <= SHARD_PHASE_S else 'OVER'} the phase's "
          f"{SHARD_PHASE_S:.0f}s budget [{card}]", flush=True)
    return totals


def check_ptx() -> dict:
    """Phase 2: the f32 contracts survive compilation -- no FMA
    contraction, no approximate division in the PTX of their libraries
    (``kernel_check``'s PTX rule).  Returns each library's count of
    correctly rounded divisions, which phase 6d prints again."""
    from repro_torch.analyze import kernel_check, render

    findings, divs = kernel_check.check_ptx()
    if findings:
        fail(f"PTX: {len(findings)} finding(s)\n{render(findings)}")
    print(f"[chip_smoke] PTX of {', '.join(divs)}: no "
          f"{' / '.join(kernel_check.PTX_FORBIDDEN)}; div.rn.f32 "
          f"{json.dumps(divs)}", flush=True)
    return divs


def sync_batches(engine):
    """(warm, audited): a batch of BATCH queries each over two disjoint
    halves of the index's lists, drawn from ANALYZE_SEED.  A fresh engine
    that served the warm batch has done its set-up, and none of the
    audited batch's rows sit in its caches: the audited batch is
    data-cold, as the tiny workload's is."""
    from repro_torch.data.postings import make_queries

    rng = np.random.default_rng(ANALYZE_SEED)
    lists = rng.permutation(len(engine.index.list_sizes))
    half = len(lists) // 2
    return [[[int(part[t]) for t in q] for q in make_queries(rng, len(part),
                                                             BATCH)]
            for part in (lists[:half], lists[half:])]


def run_analyze_path(res, rres, torch, counters, card, ptx_divs):
    """Phase 6d: ``repro_torch.analyze`` on the card -- the contract
    registry, the idiom lint, the kernel sources, the host-sync audit of
    the tiny workload against the committed baseline -- then the card's
    sync count of one data-cold batch through fresh engines over phase 4's
    and phase 6's full-size indexes, held to FULL_SYNC_SITES.  Returns
    the phase's launches."""
    from repro_torch.analyze import (
        contracts, idiom_lint, kernel_check, render, sync_audit)

    t_phase = time.perf_counter()
    for c in counters.values():
        c.launches = 0
    findings = (contracts.check_contracts() + idiom_lint.lint_repo()
                + kernel_check.check_kernels())
    print(f"[chip_smoke] PTX of {', '.join(ptx_divs)}: checked in phase 2; "
          f"div.rn.f32 {json.dumps(ptx_divs)}", flush=True)
    measured = sync_audit.audit_hot_paths(DEVICE)
    audit_launches = {n: c.launches for n, c in counters.items()
                      if c.launches}
    findings += sync_audit.compare_baseline(measured,
                                            sync_audit.load_baseline())
    for name, m in measured["hot_paths"].items():
        print(f"[chip_smoke] analyze audit {name}: syncs {m['syncs']} "
              f"{m['sync_sites']}, hidden_syncs {m['hidden_syncs']} "
              f"{m['hidden_sites']}", flush=True)
    for hint in sync_audit.improvements(measured, sync_audit.load_baseline()):
        print(f"[chip_smoke] analyze NOTE {hint}", flush=True)
    print(f"[chip_smoke] analyze audit launches: {json.dumps(audit_launches)}",
          flush=True)
    if findings:
        fail(f"analyze: {len(findings)} finding(s)\n{render(findings)}")

    # full size: a fresh engine over each full-size index serves a warm
    # batch, then a data-cold one under the card's sync debug mode; the
    # answers must not change under it (the same batch again, without it)
    full, new_sites = {}, []
    for name, eng, serve_batch in (
        ("boolean_and", res["engine"], lambda e, b: e.intersect_batch(b)),
        ("ranked_topk", rres["engine"], lambda e, b: e.topk_batch(b, TOPK)),
    ):
        fresh = type(eng)(eng.index, config=eng.config)
        warm, cold = sync_batches(fresh)
        serve_batch(fresh, warm)
        sites = set()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with sync_audit.trap_card_syncs(sites) as counts:
            got = serve_batch(fresh, cold)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        want = serve_batch(fresh, cold)
        same = all(
            np.array_equal(g, w) if name == "boolean_and"
            else np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])
            for g, w in zip(got, want))
        if not same or len(got) != BATCH or len(want) != BATCH:
            fail(f"analyze full size: {name}'s answers changed under the "
                 "sync debug mode")
        if counts["events"] == 0:
            fail(f"analyze full size: the card saw no sync in a {name} batch "
                 "(its fetch alone syncs): the instrument is broken")
        names = sync_audit.site_names(sites)
        new_sites += [f"{name}: {n}" for n in names
                      if n not in FULL_SYNC_SITES[name]]
        for n in FULL_SYNC_SITES[name]:
            if n not in names:
                print(f"[chip_smoke] analyze NOTE {name}: {n} no longer "
                      "syncs at full size -- drop it from FULL_SYNC_SITES",
                      flush=True)
        full[name] = {"queries": len(got), "sync_events": counts["events"],
                      "sync_sites": len({n.split(" [")[0] for n in names}),
                      "sync_kinds": len(names), "sites": names,
                      "batch_ms": ms}
    print(f"[chip_smoke] analyze full size: {json.dumps(full)} [{card}]",
          flush=True)
    if new_sites:
        fail("analyze full size: sync sites not in FULL_SYNC_SITES:\n  "
             + "\n  ".join(new_sites))
    launches = {n: c.launches for n, c in counters.items()}
    dt = time.perf_counter() - t_phase
    print(f"[chip_smoke] analyze: passed in {dt:.1f}s, "
          f"{'within' if dt <= ANALYZE_PHASE_S else 'OVER'} the phase's "
          f"{ANALYZE_PHASE_S:.0f}s budget [{card}]", flush=True)
    return launches


def pivot_edge_cases(torch) -> int:
    """pivot_select against its plain version on launches of PIVOT_EDGE_N
    cursors over 64 chunk rows, among them rows of nblk 0, 1, 127 and 128
    and one whose every lane ties at the max, under qmin tiles all 0, all
    QMIN_NONE and drawn; returns the cursors checked, fails on any
    mismatch."""
    from repro_torch.kernels.blockmax_pivot import kernel as pk
    from repro_torch.kernels.blockmax_pivot import ref as pref

    rng = np.random.default_rng(5)
    nc = 64
    qb = rng.integers(0, 256, (nc, 128))
    nblk = rng.integers(0, 129, nc)
    nblk[:5] = (0, 1, 127, 128, 128)
    qb[4] = 77
    table = [torch.from_numpy(x.astype(np.int32)).to(DEVICE) for x in (qb, nblk)]
    for n in PIVOT_EDGE_N:
        rows = rng.integers(0, nc, n)
        rows[: min(n, 15)] = np.arange(min(n, 15)) % 5
        qmin = rng.integers(0, pk.QMIN_NONE + 1, (n, 128))
        qmin[0::3], qmin[1::3] = 0, pk.QMIN_NONE
        args = (*table, *(torch.from_numpy(x.astype(np.int32)).to(DEVICE)
                          for x in (qmin, rows)))
        mism, _ = compare(pk.pivot_select(*args), pref.pivot_select_ref(*args))
        if mism:
            fail(f"pivot_select: {mism} of {n} edge cursors differ from the "
                 "plain version")
    return sum(PIVOT_EDGE_N)


def check_ranked_kernels(torch, rres, launches, card, profile):
    """Phase 7, the ranked kernels: each against its plain version at the
    ranked path's largest launch shapes (``pivot_select`` also on its edge
    launches); ``profile``: the ranked profile's device ms by name; returns
    their rows of the ``kernels`` line."""
    from repro_torch.core.arena import CODEC_EF
    from repro_torch.core.engine_core import build_pivot_chunks
    from repro_torch.kernels.blockmax_pivot import kernel as pk
    from repro_torch.kernels.blockmax_pivot import ref as pref
    from repro_torch.kernels.bm25_score import kernel as bk
    from repro_torch.kernels.bm25_score import ref as bref
    from repro_torch.kernels.pivot_score import kernel as sk
    from repro_torch.kernels.pivot_score import ref as sref

    rng = np.random.default_rng(3)
    cuda = torch.device(DEVICE)
    engine = rres["engine"]
    a = engine.arena
    d = a.on(cuda)
    k1p1 = engine.k1p1
    side = (d.freq_lens, d.freq_data, d.norm_q, d.idf, d.lob, d.norm_table)
    nb, n_lists = a.n_blocks, len(a.list_blk_offsets) - 1
    side_bytes = n_lists * 4 + 256 * 4  # idf + table, read once
    rows_out = []

    def report(*args, **kw):
        rows_out.append(kernel_row(launches, card, *args, **kw))

    # -- bm25_score_rows over every block: the impact mirror's launch ------
    got = bk.bm25_score_rows(*side, k1p1)
    all_rows = torch.arange(nb, dtype=torch.int32, device=cuda)
    want = chunked(bref.score_rows_ref, nb, *side, k1p1, all_rows,
                   per_cursor=(7,))
    mism, err = compare_f32(got, want)
    ms = event_ms(lambda: bk.bm25_score_rows(*side, k1p1), 20)
    plain_ms = event_ms(lambda: chunked(bref.score_rows_ref, nb, *side, k1p1,
                                        all_rows, per_cursor=(7,)), 2)
    report("bm25_score_rows", "src/repro_torch/csrc/bm25_score.cu",
           "src/repro/kernels/bm25_score/kernel.py:86", mism, err, ms,
           plain_ms, nb * (512 + 512 + 128 + 4 + 512) + side_bytes,
           f"all {nb:,} blocks")

    # -- bm25_score_probe over 2^20 cursors on the SVB blocks --------------
    svb = (np.nonzero(a.block_codec != CODEC_EF)[0] if a.multi
           else np.arange(nb))
    rows = svb[rng.integers(0, len(svb), PROBE_CURSORS)]
    engine._flat_init()
    vals = engine.core.flat_vals[:-1].reshape(-1, 128)
    nreal = a.lane_valid[rows].sum(1)
    lane = np.minimum(rng.integers(0, 128, len(rows)), nreal - 1)
    pe = vals[rows, lane]  # members ...
    half = rng.random(len(rows)) < 0.5
    pe[half] = search_probes(rng, a, rows[half])  # ... and anything
    t_rows = torch.from_numpy(rows.astype(np.int32)).to(cuda)
    t_pe = torch.from_numpy(pe.astype(np.int32)).to(cuda)
    cr = d.codec_row if a.multi else None
    args_p = (d.lens, d.data, d.block_base, cr, *side, k1p1, t_rows, t_pe)
    got = bk.bm25_score_probe(*args_p)
    want = chunked(bref.score_probe_ref, len(rows), *args_p,
                   per_cursor=(11, 12), chunk=PLAIN_CHUNK // 2)
    mism, err = compare_f32(got[:, None], want[:, None])
    ms = event_ms(lambda: bk.bm25_score_probe(*args_p), 20)
    plain_ms = event_ms(lambda: chunked(bref.score_probe_ref, len(rows),
                                        *args_p, per_cursor=(11, 12),
                                        chunk=PLAIN_CHUNK // 2), 2)
    hit_rows = np.unique(rows[(want != 0).cpu().numpy()])
    u = len(np.unique(rows))
    nbytes = (u * (512 + 512 + 4 + 4 + (4 if a.multi else 0))
              + len(hit_rows) * (512 + 512 + 128)
              + len(rows) * (4 + 4 + 4) + side_bytes)
    report("bm25_score_probe", "src/repro_torch/csrc/bm25_score.cu",
           "src/repro/kernels/bm25_score/kernel.py:139", mism, err, ms,
           plain_ms, nbytes,
           f"{len(rows):,} cursors on {u:,} SVB blocks, "
           f"{int((want != 0).sum()):,} hits")

    # -- pivot_select: one MAX_BUCKET launch over the chunk table ----------
    pc = build_pivot_chunks(a)
    pcd = pc.on(cuda)
    n = engine.MAX_BUCKET
    crow = rng.integers(0, len(pc.nblk), n)
    # per cursor a threshold code in the chunk's own range, as theta gives
    hi = np.maximum(pc.qb[crow].max(1), 1)
    qmin = np.minimum(rng.integers(0, hi + 1)[:, None]
                      + rng.integers(-8, 9, (n, 128)), 256)
    qmin[rng.random(n) < 0.1] = 256  # terms no block of which can pass
    t_crow = torch.from_numpy(crow.astype(np.int32)).to(cuda)
    t_qmin = torch.from_numpy(np.maximum(qmin, 0).astype(np.int32)).to(cuda)
    args_s = (pcd.qb, pcd.nblk, t_qmin, t_crow)
    got = pk.pivot_select(*args_s)
    want = pref.pivot_select_ref(*args_s)
    mism, err = compare(got, want)
    ms = event_ms(lambda: pk.pivot_select(*args_s), 20)
    dev_ms = device_ms(torch, lambda: pk.pivot_select(*args_s))
    wrap_us = host_us(torch, lambda: pk.pivot_select(*args_s))
    plain_ms = event_ms(lambda: pref.pivot_select_ref(*args_s), 2)
    t0 = time.perf_counter()
    n_edge = pivot_edge_cases(torch)
    edge_s = time.perf_counter() - t0
    prof = profile_ms(profile, "pivot_select_kernel")
    uc = len(np.unique(crow))
    report("pivot_select", "src/repro_torch/csrc/blockmax_pivot.cu",
           "src/repro/kernels/blockmax_pivot/kernel.py:107", mism, err, ms,
           plain_ms, uc * (512 + 4) + n * (4 + 512 + 512 + 12),
           f"{n:,} cursors on {uc:,} of {len(pc.nblk):,} chunks, "
           f"{int(want[1].sum()):,} blocks kept, + {n_edge:,} edge cursors "
           f"in launches of {', '.join(f'{e:,}' for e in PIVOT_EDGE_N)} "
           f"({edge_s:.1f}s); {ms:.4f} ms with the wrapper, {dev_ms:.4f} ms "
           f"on the card alone, the wrapper's host time {wrap_us:.1f} us; "
           f"previous design {PREVIOUS_MS['pivot_select']:.4f} ms on the card "
           f"alone; {prof:.4f} ms in the ranked profile's {PROFILE_BATCHES} "
           f"batches",
           note={"device_ms": dev_ms, "host_us": wrap_us,
                 "edge_cursors": n_edge, "edge_s": edge_s,
                 "ranked_profile_ms": prof})

    # -- pivot_score: one PIVOT_SCORE_BUCKET launch --------------------------
    n = engine.PIVOT_SCORE_BUCKET
    args_f = (pcd.qb, pcd.nblk, pcd.base, t_qmin[:n], t_crow[:n], *side,
              k1p1)
    got = sk.pivot_score(*args_f)
    want = sref.pivot_score_ref(*args_f)
    mism, err = compare(got[:4], want[:4])
    m2, err2 = compare_f32(got[4], want[4])
    ms = event_ms(lambda: sk.pivot_score(*args_f), 20)
    dev_ms = device_ms(torch, lambda: sk.pivot_score(*args_f))
    plain_ms = event_ms(lambda: sref.pivot_score_ref(*args_f), 2)
    slot_rows = sref.slot_rows(pcd.base, t_crow[:n], want[0], nb)
    us = len(torch.unique(slot_rows))
    uc = len(np.unique(crow[:n]))
    nbytes = (uc * (512 + 4 + 4) + n * (4 + 512 + 512 + 12 + 16 * 512)
              + us * (512 + 512 + 128 + 4) + side_bytes)
    report("pivot_score", "src/repro_torch/csrc/pivot_score.cu",
           "src/repro/kernels/pivot_score/kernel.py:64", mism + m2,
           max(err, err2), ms, plain_ms, nbytes,
           f"{n:,} cursors, {16 * n:,} slots on {us:,} blocks; {ms:.4f} ms "
           f"with the wrapper, {dev_ms:.4f} ms on the card alone",
           note={"device_ms": dev_ms})
    torch.cuda.synchronize()
    return rows_out


def serve_arg(flag: str) -> int:
    """An integer argument of the boolean path's serve command."""
    return int(SERVE_ARGS[SERVE_ARGS.index(flag) + 1])


def run_build_path(n_lists, res, torch, counters, card):
    """Phase 5; returns (the gaps of every list, launches)."""
    from repro_torch import obs
    from repro_torch.core.costs import gaps_from_sorted
    from repro_torch.core.index import build_partitioned_index
    from repro_torch.core.partition import (
        optimal_partitioning,
        optimal_partitioning_via_scan,
    )
    from repro_torch.data.postings import make_corpus
    from repro_torch.kernels.gain_scan.ops import optimal_partitioning_blocked

    idx = res["index"]
    t0 = time.perf_counter()
    corpus = make_corpus(np.random.default_rng(serve_arg("--seed")),
                         n_lists=n_lists, min_len=serve_arg("--min-len"),
                         max_len=serve_arg("--max-len"))
    if not np.array_equal([len(seq) for seq in corpus], idx.list_sizes):
        fail("the corpus made again from its seed has other list sizes than "
             "the boolean path's index")
    print(f"[chip_smoke] index build: the boolean path's corpus made again "
          f"from its seed, {len(corpus)} lists, "
          f"{int(idx.list_sizes.sum()):,} postings "
          f"({time.perf_counter()-t0:.1f}s)", flush=True)
    for c in counters.values():
        c.launches = 0
    obs.reset()
    obs.enable()
    t0 = time.perf_counter()
    blocked = build_partitioned_index(
        corpus, partitioner=optimal_partitioning_blocked, codecs="auto")
    blocked_s = time.perf_counter() - t0
    spans = span_ms()
    obs.enable(False)
    # the three partitioners over the same gaps, list by list: the host loop
    # here, the blocked one from its spans in the build above, the scan here
    gaps_all = [gaps_from_sorted(seq) for seq in corpus]
    t0 = time.perf_counter()
    for gaps in gaps_all:
        optimal_partitioning(gaps)
    host_s = time.perf_counter() - t0
    obs.reset()
    obs.enable()
    t0 = time.perf_counter()
    scan_P = [optimal_partitioning_via_scan(gaps) for gaps in gaps_all]
    scan_s = time.perf_counter() - t0
    scan_spans = span_ms()
    obs.enable(False)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    print(f"[chip_smoke] index-build launches: {launches}", flush=True)
    for k, n in launches.items():
        if n != len(corpus):
            fail(f"kernel {k} launched {n} times for {len(corpus)} lists")
    # the device-partitioned index is the host-partitioned one
    n_arrays = 0
    for f in dataclasses.fields(idx):
        want, got = getattr(idx, f.name), getattr(blocked, f.name)
        if isinstance(want, np.ndarray):
            n_arrays += 1
            if got.dtype != want.dtype or not np.array_equal(got, want):
                fail(f"index through optimal_partitioning_blocked: "
                     f"{f.name} differs from the host-built index")
        elif f.compare and got != want:
            fail(f"index through optimal_partitioning_blocked: {f.name} "
                 f"{got!r} != {want!r}")
    # the scan's endpoints are the host's, read back from the host index
    lpo = idx.list_part_offsets
    for lst, P in enumerate(scan_P):
        if not np.array_equal(P, np.cumsum(idx.sizes[lpo[lst] : lpo[lst + 1]])):
            fail(f"optimal_partitioning_via_scan: list {lst}'s endpoints "
                 "differ from the host partitioner's")
    print(f"[chip_smoke] index build: optimal_partitioning_blocked's index "
          f"equals the host-built index in all {n_arrays} arrays; "
          f"optimal_partitioning_via_scan gives the host's endpoints on all "
          f"{len(scan_P)} lists ({len(idx.sizes):,} partitions)", flush=True)
    gain_s = spans.get("gain_prefix", 0.0) / 1e3
    machine_s = spans.get("state_machine", 0.0) / 1e3
    scan_span_s = scan_spans.get("partition_scan", 0.0) / 1e3
    summary = {
        "host_partitioner_s": host_s,
        "blocked_partitioner_s": gain_s + machine_s,
        "blocked_gain_prefix_s": gain_s, "blocked_state_machine_s": machine_s,
        "scan_partitioner_s": scan_s, "scan_kernel_and_fetch_s": scan_span_s,
        "one_thread_scan_partitioner_s": ONE_THREAD_SCAN_S,
        "one_thread_scan_kernel_and_fetch_s": ONE_THREAD_SCAN_SPAN_S,
        "scan_span_shrink_s": ONE_THREAD_SCAN_SPAN_S - scan_span_s,
        "host_build_s": res["build_s"], "blocked_build_s": blocked_s,
        "launches": launches, "card": card,
    }
    print(f"[chip_smoke] index build: {json.dumps(summary)}", flush=True)
    return gaps_all, launches


def scan_sass() -> str:
    """What the compiler emitted for partition_scan's round loop (the
    instance that writes mask and pos), read from ``cuobjdump -sass`` of
    the built library: its instructions and the issue cycles of the
    schedule's stall counts, per step of a round.  Static counts: the
    restart after an emission and each branch count once."""
    import re

    from repro_torch.kernels import _build

    try:
        exe = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
        proc = subprocess.run(
            [exe, "-sass", _build.library_path("partition_scan")],
            capture_output=True, text=True)
    except (OSError, RuntimeError) as e:
        return f"not measured ({e})"
    if proc.returncode:
        return f"not measured ({exe} -sass: {proc.stderr.strip()[:200]})"
    funcs = [f for f in re.split(r"\n\s*Function : ", proc.stdout)[1:]
             if "kernelILb1E" in f.splitlines()[0]]
    if not funcs:
        return "not measured (no mask-writing instance in the SASS)"
    lines = funcs[0].splitlines()
    code = []  # (address, instruction, stall cycles from the control word)
    for a, b in zip(lines, lines[1:]):
        m = re.match(r"\s*/\*([0-9a-f]{4,5})\*/\s+(.*?)\s*;\s*/\* 0x", a)
        c = re.search(r"/\* (0x[0-9a-f]{16}) \*/", b)
        if m and c:
            code.append((int(m.group(1), 16), m.group(2),
                         max((int(c.group(1), 16) >> 41) & 0xF, 1)))
    back = [(a, int(t, 16)) for a, x, _ in code
            for t in re.findall(r"BRA (0x[0-9a-f]+)", x) if int(t, 16) < a]
    if not back:
        return "not measured (no backward branch in the SASS)"
    end, top = max(back, key=lambda e: e[0] - e[1])
    loop = [(x, st) for a, x, st in code if top <= a <= end]
    n_shfl = sum(1 for x, _ in loop if "SHFL" in x or "VOTE" in x or "REDUX" in x)
    return (f"{len(loop) / SCAN_ROUND_STEPS:.2f} instructions and "
            f"{sum(st for _, st in loop) / SCAN_ROUND_STEPS:.2f} issue cycles "
            f"per step of a {SCAN_ROUND_STEPS}-step round ({len(loop)} "
            f"instructions, {n_shfl} of them shuffles, votes or reductions)")


def summed_event_ms(torch, calls) -> float:
    """Device time of each call, summed over the calls: a CUDA event pair
    around each, all queued behind a spin kernel, so that the host's gaps
    between launches fall outside every pair."""
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in calls]
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    for (start, stop), call in zip(pairs, calls):
        start.record()
        call()
        stop.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(stop) for start, stop in pairs)


def device_ms(torch, fn, reps=DEVICE_REPS) -> float:
    """Mean device time of ``fn()``, the wrapper's host time kept out:
    ``reps`` calls queued behind the spin kernel, an event pair around each
    (``summed_event_ms``), after one warm-up call."""
    fn()
    return summed_event_ms(torch, [fn] * reps) / reps


def host_us(torch, fn, reps=HOST_REPS, rounds=HOST_ROUNDS) -> float:
    """Host microseconds of ``fn()``: the host's clock around ``reps``
    calls, the card synchronized before the first and after the clock
    stops, the least mean of ``rounds`` such runs (the one the host's other
    work disturbed least)."""
    best = float("inf")
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        best = min(best, (time.perf_counter() - t0) / reps)
        torch.cuda.synchronize()
    return best * 1e6


def check_build_kernels(torch, gaps_all, launches, card):
    """Phase 7, the index-build kernels: gain_scan on every list and on one
    launch at its range guard, partition_scan on the largest list and on
    sequences that stress its restarts, each against its plain version;
    both timed at their largest launch and summed over the path's per-list
    launches.  Returns their rows of the ``kernels`` line."""
    from repro_torch.core.costs import DEFAULT_F, gain_deltas_np
    from repro_torch.kernels.gain_scan import kernel as gk
    from repro_torch.kernels.gain_scan import ref as gref
    from repro_torch.kernels.gain_scan.ops import check_range
    from repro_torch.kernels.partition_scan import kernel as sk
    from repro_torch.kernels.partition_scan import ref as sref

    cuda = torch.device(DEVICE)
    rows_out = []

    def report(*args, **kw):
        rows_out.append(kernel_row(launches, card, *args, **kw))

    def padded(gaps):
        """The gaps on the card, padded with gap 1 as gain_prefix pads."""
        gp = np.ones(-(-len(gaps) // gk.BLOCK) * gk.BLOCK, np.int32)
        gp[: len(gaps)] = gaps
        return torch.from_numpy(gp).to(cuda)

    def compare_all(got, want):
        res = [compare(g, w) for g, w in zip(got, want)]
        return sum(m for m, _ in res), max(e for _, e in res)

    # -- gain_scan on every list, then one launch at the range guard --------
    mism, err = 0, 0
    lists = [padded(gaps) for gaps in gaps_all]
    for t in lists:
        m, e = compare_all(gk.gain_scan(t), gref.gain_scan_ref(t, gk.BLOCK))
        mism, err = mism + m, max(err, e)
    path_ms = summed_event_ms(torch, [lambda t=t: gk.gain_scan(t)
                                      for t in lists])
    del lists
    cat = np.resize(np.concatenate(gaps_all), GUARD_LAUNCH)
    check_range(len(cat), int(cat.sum()))
    t = padded(cat)
    m, e = compare_all(gk.gain_scan(t), gref.gain_scan_ref(t, gk.BLOCK))
    ms = event_ms(lambda: gk.gain_scan(t), 20)
    plain_ms = event_ms(lambda: gref.gain_scan_ref(t, gk.BLOCK), 2)
    deltas = gref.vbyte_cost_bits(torch.clamp_min(t - 1, 0)) - t
    cumsum_ms = event_ms(lambda: torch.cumsum(deltas, 0, dtype=torch.int32), 20)
    nb = GUARD_LAUNCH // gk.BLOCK
    report("gain_scan", "src/repro_torch/csrc/gain_scan.cu",
           "src/repro/kernels/gain_scan/kernel.py:65", mism + m, max(err, e),
           ms, plain_ms, GUARD_LAUNCH * 8 + nb * 8,
           f"all {len(gaps_all)} lists, then {GUARD_LAUNCH:,} gaps of the "
           f"corpus ({nb:,} blocks, universe {int(cat.sum()):,}) in one "
           f"launch; torch.cumsum of its int32 deltas {cumsum_ms:.4f} ms; "
           f"summed over the {len(gaps_all)} per-list launches {path_ms:.4f} "
           f"ms", note={"cumsum_ms": cumsum_ms, "path_kernel_ms": path_ms})
    del t, deltas

    # -- partition_scan: the largest list, then sequences that restart -----
    rng = np.random.default_rng(2)

    def mixed_deltas(n, dense):
        gaps = np.where(rng.random(n) < dense, rng.integers(1, 3, n),
                        rng.integers(1, 5000, n))
        return gain_deltas_np(gaps)

    extreme = np.random.default_rng(9).choice(
        [2**31 - 1, -(2**31), 2**30, -(2**30), 1, -1, 0], 400)
    dense = mixed_deltas(200_000, 0.5)
    cases = [("dense F=0", dense, 0), ("dense F=1", dense, 1),
             ("extreme F=64", extreme, DEFAULT_F), ("extreme F=0", extreme, 0)]
    cases += [(f"n={n} F={F}", mixed_deltas(n, 0.5), F)
              for n in (1, 127, 128, 129, 4097) for F in (DEFAULT_F, 0)]

    def check_scan(d, F):
        """partition_scan and partition_scan_bounds against the plain
        version: (mismatches, max |difference|, emissions)."""
        want = sref.partition_scan_ref(d, F)
        m, e = compare_all(sk.partition_scan(d, F), want)
        carry, bounds = sk.partition_scan_bounds(d, F)
        found = want[2][want[1]]
        k = int(carry[7])
        if k != found.numel():
            return m + 1, e, found.numel()
        m += compare(carry[:7], want[0])[0]
        m += compare(bounds[:k], found)[0] if k else 0
        return m, e, k

    mism, err, checked = 0, 0, []
    for what, d, F in cases:
        m, e, k = check_scan(
            torch.from_numpy(np.asarray(d).astype(np.int32)).to(cuda), F)
        mism, err = mism + m, max(err, e)
        checked.append(f"{what}: {k:,} emissions")
    big = int(np.argmax([len(g) for g in gaps_all]))
    n = len(gaps_all[big])
    d = torch.from_numpy(gain_deltas_np(gaps_all[big]).astype(np.int32)).to(cuda)
    m, e, emissions = check_scan(d, DEFAULT_F)
    mism, err = mism + m, max(err, e)
    ms = event_ms(lambda: sk.partition_scan(d, DEFAULT_F), 5)
    bounds_ms = event_ms(lambda: sk.partition_scan_bounds(d, DEFAULT_F), 5)
    plain_ms = event_ms(lambda: sref.partition_scan_ref(d, DEFAULT_F), 1)
    # the path's launches: one a list, boundaries alone
    on_card = [torch.from_numpy(gain_deltas_np(g).astype(np.int32)).to(cuda)
               for g in gaps_all]
    path_ms = summed_event_ms(
        torch, [lambda x=x: sk.partition_scan_bounds(x, DEFAULT_F)
                for x in on_card])
    del on_card
    hz = sm_clock_hz()
    chain_ms = emissions * SCAN_CHAIN_OPS * SCAN_OP_CYCLES / hz * 1e3
    bytes_ms = n * SCAN_STEP_BYTES / HBM_BYTES_PER_S * 1e3
    sass = scan_sass()
    chain_how = (f"{emissions:,} emissions x {SCAN_CHAIN_OPS} dependent ops x "
                 f"{SCAN_OP_CYCLES} cycles at {hz/1e6:.0f} MHz; bytes "
                 f"{bytes_ms:.4f} ms")
    report("partition_scan", "src/repro_torch/csrc/partition_scan.cu",
           "src/repro/core/partition.py:172", mism, err, ms, plain_ms,
           n * SCAN_STEP_BYTES,
           f"list {big}, {n:,} steps, {emissions:,} emissions, "
           f"{ms * 1e-3 * hz / n:.2f} cycles per step; boundaries alone "
           f"{bounds_ms:.4f} ms; summed over the {len(gaps_all)} per-list "
           f"launches {path_ms:.4f} ms; also held: {'; '.join(checked)}; "
           f"its SASS: {sass}",
           ops_bound=((chain_ms, chain_how) if chain_ms >= bytes_ms else None),
           note={"sass": sass, "emissions": emissions,
                 "bounds_only_ms": bounds_ms, "path_kernel_ms": path_ms,
                 "chain_bound_ms": chain_ms, "bytes_bound_ms": bytes_ms})
    torch.cuda.synchronize()
    return rows_out


def dcn_train_flops(cfg, batch: int) -> float:
    """Model FLOPs of one DCN-v2 train step: the reference's
    ``_recsys_flops`` (``repro/launch/cells.py``), 3x the forward's matmuls
    for the forward and backward."""
    x0 = cfg.n_dense + cfg.n_sparse * cfg.embed_dim
    per = cfg.n_cross_layers * 2 * x0 * x0
    dims = (x0, *cfg.mlp, 1)
    per += sum(2 * a * b for a, b in zip(dims, dims[1:]))
    return 3.0 * per * batch


def run_recsys_path(torch, counters, card):
    """Phase 3, the dense step; returns (the run's result, launches, the
    device ms by name of two more steps, traced after the checks, and the
    ``recsys train:`` summary)."""
    from repro_torch import convert
    from repro_torch.configs import get_arch
    from repro_torch.examples import train_recsys as ex
    from repro_torch.models.common import param_dict, tree_size
    from repro_torch.models.recsys import init_model, serve_score

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[chip_smoke] recsys: allow_tf32 matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}, cudnn "
          f"{torch.backends.cudnn.allow_tf32}, float32 matmul precision "
          f"{torch.get_float32_matmul_precision()!r}", flush=True)
    bundle = get_arch(RECSYS_ARCH)
    cfg = bundle.full
    batch = next(s.batch for s in bundle.shapes if s.name == RECSYS_SHAPE)
    steps = RECSYS_WARMUP + RECSYS_STEPS
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = ex.run(cfg, steps, batch, device=DEVICE, seed=0)
    run_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    print(f"[chip_smoke] recsys-path launches: {launches}", flush=True)
    if launches["embedding_bag"] != steps:
        fail(f"embedding_bag launched {launches['embedding_bag']} times in "
             f"{steps} steps")
    losses = res["losses"]
    if not np.isfinite(losses).all():
        fail(f"recsys train: a loss is not finite: {losses}")
    model = res["state"]["model"]
    timed = res["records"][RECSYS_WARMUP:]
    step_ms = [r["step_s"] * 1e3 for r in timed]
    host_ms = [(r["batch_s"] + r["decode_s"]) * 1e3 for r in timed]
    flops = dcn_train_flops(cfg, batch)
    p50 = float(np.percentile(step_ms, 50))
    summary = {
        "config": cfg.name, "params": tree_size(model), "batch": batch,
        "steps": steps, "warmup_steps": RECSYS_WARMUP,
        "k": int(timed[0]["ids"].shape[1]),
        "step_p50_ms": p50, "step_p99_ms": float(np.percentile(step_ms, 99)),
        "step_ms": step_ms,
        "examples_per_s": batch * len(step_ms) / (sum(step_ms) / 1e3),
        "examples_per_s_with_host": batch * len(step_ms)
        / ((sum(step_ms) + sum(host_ms)) / 1e3),
        "make_ctr_batch_ms": [r["batch_s"] * 1e3 for r in timed],
        "decode_multihot_batch_ms": [r["decode_s"] * 1e3 for r in timed],
        "losses": losses, "embedding_bag_launches": launches["embedding_bag"],
        "max_memory_allocated": peak, "model_tflop_per_step": flops / 1e12,
        "model_tflops": flops / (p50 / 1e3) / 1e12,
        "f32_peak_share": flops / (p50 / 1e3) / F32_PEAK,
        "run_s": run_s, "card": card,
    }
    print(f"[chip_smoke] recsys train: {json.dumps(summary)}", flush=True)

    # the card's logits against a CPU forward of the same parameters
    first = timed[0]["batch"]
    sub = {k: v[:RECSYS_CHECK] for k, v in first.items()}
    t0 = time.perf_counter()
    with torch.no_grad():
        got = serve_score(model, sub, cfg).cpu()
        host = convert.recsys_params_from_arrays(
            convert.recsys_params_to_arrays(model), cfg, "cpu")
        want = serve_score(host, {k: v.cpu() for k, v in sub.items()}, cfg)
    del host
    if not torch.allclose(got, want, rtol=1e-4, atol=1e-6):
        fail(f"recsys logits on the card differ from the CPU forward: max "
             f"|diff| {float((got - want).abs().max()):.3e}")
    rel = float(((got - want).abs() / want.abs().clamp_min(1e-6)).max())
    print(f"[chip_smoke] recsys logits of {RECSYS_CHECK} examples of the first "
          f"timed batch equal a CPU forward of the same parameters within "
          f"rtol 1e-4, atol 1e-6 (max relative difference {rel:.3e}, max |diff| "
          f"{float((got - want).abs().max()):.3e}; "
          f"{time.perf_counter()-t0:.1f}s)", flush=True)

    # smoke-config steps on the card against the CPU, from one init
    smoke = bundle.smoke
    init = convert.recsys_params_to_arrays(init_model(smoke, 0, "cpu"))
    cpu = ex.run(smoke, SMOKE_STEPS, SMOKE_BATCH, device="cpu", params=init)
    dev = ex.run(smoke, SMOKE_STEPS, SMOKE_BATCH, device=DEVICE, params=init)
    if not np.allclose(dev["losses"], cpu["losses"], rtol=1e-5, atol=0):
        fail(f"smoke steps: card losses {dev['losses']} != CPU "
             f"{cpu['losses']}")
    worst = worst_ratio(torch, param_dict(dev["state"]["model"]),
                        param_dict(cpu["state"]["model"]))
    if worst > 1:
        fail(f"smoke steps: card parameters off the CPU's ({worst:.2f}x "
             "the tolerance)")
    print(f"[chip_smoke] recsys smoke config: {SMOKE_STEPS} steps of "
          f"{SMOKE_BATCH} on the card equal the CPU's (losses within rtol "
          f"1e-5, parameters within {worst:.3f} of atol 1e-5 + rtol 1e-4)",
          flush=True)
    prof = profile_calls(torch, [lambda s=s: ex.train_step(res["state"], s, batch)
                                 for s in range(steps, steps + RECSYS_PROFILE)],
                         card, "recsys", "steps")
    # the dense step alone on the timed batches, already on the card, as
    # the sparse step is timed: no batch upload, no bag
    st = res["state"]

    def dense_step(b):
        _, _, m = st["step_fn"](st["model"], st["opt"], b)
        return float(m["loss"])

    alone_ms = []
    for r in timed:
        t0 = time.perf_counter()
        dense_step(r["batch"])
        torch.cuda.synchronize()
        alone_ms.append((time.perf_counter() - t0) * 1e3)
    alone = {"step_p50_ms": float(np.percentile(alone_ms, 50)),
             "step_p99_ms": float(np.percentile(alone_ms, 99)),
             "step_ms": alone_ms,
             "prof": profile_calls(torch, [lambda b=r["batch"]: dense_step(b)
                                           for r in timed[:RECSYS_PROFILE]],
                                   card, "recsys dense step alone", "steps")}
    return res, launches, prof, summary, alone


def worst_ratio(torch, got: dict, want: dict, atol=1e-5, rtol=1e-4) -> float:
    """The largest |got - want| / (atol + rtol |want|) over two dicts of
    tensors by name (on any devices): above 1 is off the tolerance."""
    worst = 0.0
    for k, w in want.items():
        w = w.detach().cpu()
        d = (got[k].detach().cpu() - w).abs() / (atol + rtol * w.abs())
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
    return worst


def elements_off(torch, got: dict, want: dict, atol=1e-5,
                 rtol=1e-4) -> dict:
    """The elements of each tensor of ``got`` off ``want`` by more than
    ``atol + rtol |want|``, by name (only the names with any)."""
    off = {}
    for k, w in want.items():
        w = w.detach()
        n = int(((got[k].detach() - w).abs() > atol + rtol * w.abs()).sum())
        if n:
            off[k] = n
    return off


def run_sparse_step(torch, batches, dense, alone, card):
    """Phase 3a: ``launch.cells.make_sparse_recsys_train_step`` at the full
    DCN-v2 width on the dense step's batches (``batches``: the trainer's,
    with their ``embedding_bag`` splice), a warm-up step and the timed
    ones, beside the dense step (``dense``: its summary; ``alone``: the
    dense step alone on the same batches, its times and its profile's
    device ms by name); then smoke-config steps on the card held to the
    CPU's.  Returns its summary."""
    from repro_torch import convert
    from repro_torch.configs import get_arch
    from repro_torch.data.recsys_data import make_ctr_batch
    from repro_torch.launch.cells import (
        make_sparse_recsys_train_step,
        sparse_opt_init,
    )
    from repro_torch.models.common import param_dict, tree_size
    from repro_torch.models.recsys import init_model

    t_piece = time.perf_counter()
    bundle = get_arch(RECSYS_ARCH)
    cfg = bundle.full
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = init_model(cfg, 0, DEVICE)
    opt = sparse_opt_init(model)
    step = make_sparse_recsys_train_step(cfg)
    losses, step_ms = [], []
    for b in batches:
        t0 = time.perf_counter()
        _, _, m = step(model, opt, b)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() - base
    if not np.isfinite(losses).all():
        fail(f"sparse step: a loss is not finite: {losses}")
    prof = profile_calls(torch, [lambda b=b: step(model, opt, b)
                                 for b in batches[:RECSYS_PROFILE]],
                         card, "recsys sparse", "steps")
    timed = step_ms[RECSYS_WARMUP:]
    n_params = tree_size(model)
    del model, opt
    torch.cuda.empty_cache()

    # smoke-config steps on the card against the CPU, from one init
    smoke = bundle.smoke
    init = convert.recsys_params_to_arrays(init_model(smoke, 0, "cpu"))
    runs = {}
    touched = np.zeros(smoke.table_rows, bool)
    for dev in ("cpu", DEVICE):
        m = convert.recsys_params_from_arrays(init, smoke, dev)
        o = sparse_opt_init(m)
        st = make_sparse_recsys_train_step(smoke)
        ls = []
        for s in range(SMOKE_STEPS):
            b = make_ctr_batch(np.random.default_rng(s), smoke, SMOKE_BATCH)
            touched[(b["sparse"] + np.arange(smoke.n_sparse)
                     * smoke.rows_per_field).reshape(-1)] = True
            _, _, mm = st(m, o, {k: torch.from_numpy(v).to(dev)
                                 for k, v in b.items()})
            ls.append(float(mm["loss"]))
        runs[dev] = (m, o, ls)
    (cm, co, cl), (dm, do, dl) = runs["cpu"], runs[DEVICE]
    if not np.allclose(dl, cl, rtol=1e-5, atol=0):
        fail(f"sparse smoke steps: card losses {dl} != CPU {cl}")
    worst = worst_ratio(torch, param_dict(dm), param_dict(cm))
    acc = worst_ratio(torch, {"acc": do["table_acc"]}, {"acc": co["table_acc"]},
                      atol=1e-10, rtol=1e-5)
    table0 = torch.from_numpy(init["table"])
    rest = torch.from_numpy(~touched)
    untouched = bool(torch.equal(dm.table.detach().cpu()[rest], table0[rest]))
    if worst > 1 or acc > 1 or not untouched:
        fail(f"sparse smoke steps: card parameters {worst:.2f}x, accumulator "
             f"{acc:.2f}x the tolerance; untouched rows unchanged: {untouched}")
    dense_prof = alone["prof"]
    dense_busy = sum(dense_prof.values())
    busy = sum(prof.values())
    summary = {
        "config": cfg.name, "params": n_params, "batch": dense["batch"],
        "steps": len(batches), "warmup_steps": RECSYS_WARMUP,
        "step_p50_ms": float(np.percentile(timed, 50)),
        "step_p99_ms": float(np.percentile(timed, 99)), "step_ms": timed,
        "dense_step_p50_ms": alone["step_p50_ms"],
        "dense_step_p99_ms": alone["step_p99_ms"],
        "dense_step_ms": alone["step_ms"],
        "losses": losses,
        "device_busy_ms": busy, "dense_device_busy_ms": dense_busy,
        "multi_tensor_apply_ms": profile_ms(prof, "multi_tensor_apply"),
        "dense_multi_tensor_apply_ms": profile_ms(dense_prof,
                                                  "multi_tensor_apply"),
        "profiled_steps": RECSYS_PROFILE,
        "max_memory_allocated": peak,
        "dense_max_memory_allocated": dense["max_memory_allocated"],
        "table_acc_bytes": cfg.table_rows * 4,
        "table_adamw_moment_bytes": cfg.table_rows * cfg.embed_dim * 4 * 2,
        "smoke_worst_of_tolerance": worst, "smoke_acc_worst_of_tolerance": acc,
        "piece_s": time.perf_counter() - t_piece, "card": card,
    }
    print(f"[chip_smoke] recsys sparse: {json.dumps(summary)}", flush=True)
    print(f"[chip_smoke] recsys sparse smoke config: {SMOKE_STEPS} steps of "
          f"{SMOKE_BATCH} on the card equal the CPU's (losses within rtol "
          f"1e-5; parameters within {worst:.3f} of atol 1e-5 + rtol 1e-4, "
          f"the accumulator within {acc:.3f} of atol 1e-10 + rtol 1e-5; the "
          f"{int((~touched).sum()):,} rows no batch touched bit-unchanged); "
          f"both steps timed and traced on the same batches, already on the "
          f"card (no upload, no bag); piece {summary['piece_s']:.1f}s",
          flush=True)
    return summary


def retrieval_size(torch, fn, want: int) -> tuple[int, float]:
    """(candidates to run, device bytes a candidate): ``want`` if its
    measured memory fits RETRIEVAL_MEM_SHARE of the card's free memory,
    else the largest power of two that does.  ``fn(c)`` runs a retrieval
    of ``c`` candidates; it is measured on RETRIEVAL_PROBE."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn(RETRIEVAL_PROBE)
    torch.cuda.synchronize()
    per = (torch.cuda.max_memory_allocated() - base) / RETRIEVAL_PROBE
    torch.cuda.empty_cache()
    room = RETRIEVAL_MEM_SHARE * torch.cuda.mem_get_info()[0]
    if want * per <= room:
        return want, per
    c = 1 << int(np.log2(room / per))
    return min(c, want), per


def run_seq_arch(torch, arch, card):
    """Phase 3b and 3c for one sequential arch at full width: timed steps
    through ``launch.train.build_training``; under deterministic
    algorithms the same steps through ``FaultTolerantRunner`` (a
    checkpoint every SEQ_SAVE_EVERY steps, a failure at SEQ_FAIL_AT) held
    bit for bit to a run without the failure; logits held to a CPU
    forward and (smoke config) steps to CPU steps; then ``serve_score`` at the serve
    shapes and ``retrieval_step`` at the retrieval shape.  Returns the
    ``recsys seq:`` line."""
    import pathlib
    import shutil
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import tree_map
    from repro_torch.configs import get_arch
    from repro_torch.distributed import FaultTolerantRunner, SimulatedFailure
    from repro_torch.launch.train import build_training, named_leaves
    from repro_torch import convert
    from repro_torch.models.common import tree_size
    from repro_torch.models.recsys import (
        Recsys,
        init_model,
        retrieval_step,
        serve_score,
    )

    t_arch = time.perf_counter()
    bundle = get_arch(arch)
    shapes = {s.name: s for s in bundle.shapes}
    batch = shapes[RECSYS_SHAPE].batch
    torch.cuda.empty_cache()
    state, step, batches, cfg = build_training(arch, smoke=False, batch=batch,
                                               device=DEVICE)
    state0, state1 = (tree_map(lambda x: x.clone() if isinstance(
        x, torch.Tensor) else x, state) for _ in range(2))
    # the peak counts the training state and what the steps allocate, not
    # the two copies kept for the restart check
    base = torch.cuda.memory_allocated() - sum(
        t.numel() * t.element_size() for t in named_leaves(state).values()
        if isinstance(t, torch.Tensor))
    torch.cuda.reset_peak_memory_stats()
    made = {}

    def cached(s):  # each step's batch is drawn and uploaded once
        if s not in made:
            made[s] = batches(s)
        return made[s]

    # the timed run: SEQ_STEPS steps in torch's default mode
    step_ms, timed_losses = [], []
    for s in range(SEQ_STEPS):
        b = cached(s)
        t0 = time.perf_counter()
        state, m = step(state, b)
        timed_losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() - base
    if not np.isfinite(timed_losses).all():
        fail(f"{arch}: a loss is not finite: {timed_losses}")

    # the restart check, under torch's deterministic algorithms (cuBLAS's
    # workspace fixed in main): the run with a failure and a run of the
    # same steps without it must end bit-equal, parameters, both AdamW
    # moments and the step count
    losses = []

    def logged(st, b):
        st, m = step(st, b)
        losses.append(float(m["loss"]))
        return st, m

    ckpt = tempfile.mkdtemp(prefix="chip-smoke-ckpt-")
    torch.use_deterministic_algorithms(True)
    try:
        manager = CheckpointManager(ckpt, keep=2)
        runner = FaultTolerantRunner(logged, manager, save_every=SEQ_SAVE_EVERY)
        t0 = time.perf_counter()
        restarted = runner.run(state0, cached, SEQ_STEPS,
                               failure=SimulatedFailure(at_steps=(SEQ_FAIL_AT,)))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        ckpt_bytes = sum(f.stat().st_size for f in pathlib.Path(ckpt).rglob("*")
                         if f.is_file())
        unbroken = state1
        for s in range(SEQ_STEPS):
            unbroken, _ = step(unbroken, cached(s))
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(ckpt, ignore_errors=True)
    stats = runner.stats
    if stats.restarts != 1 or stats.steps_completed != SEQ_STEPS + stats.wasted_steps:
        fail(f"{arch}: run statistics {stats}, not one restart")
    if not np.isfinite(losses).all():
        fail(f"{arch}: a loss is not finite: {losses}")
    # the step the restart replayed first gives its first pass's loss
    at = SEQ_FAIL_AT - stats.wasted_steps
    if losses[at] != losses[SEQ_FAIL_AT]:
        fail(f"{arch}: the replayed step {at} lost {losses[SEQ_FAIL_AT]}, the "
             f"first pass {losses[at]}: the restore is not the checkpoint")
    if not int(unbroken[1]["count"]) == int(restarted[1]["count"]) == SEQ_STEPS:
        fail(f"{arch}: step counts {unbroken[1]['count']} and "
             f"{restarted[1]['count']}")

    def tensors(st):  # the parameters and both AdamW moments, by name
        return named_leaves({"params": st[0], "m": st[1]["m"], "v": st[1]["v"]})

    want = tensors(unbroken)
    n_elems = sum(x.numel() for x in want.values())
    got = tensors(restarted)
    n_off = sum(int((got[k] != w).sum()) for k, w in want.items())
    # the default mode's run against the deterministic one: the card's
    # embedding backward sums repeated rows with atomics in no fixed order
    spread = elements_off(torch, tensors(state), want)
    n_spread = sum(spread.values())
    top = dict(sorted(spread.items(), key=lambda kv: -kv[1])[:4])
    print(f"[chip_smoke] {arch} restart, deterministic algorithms: the "
          f"replayed step {at}'s loss equals its first pass; {n_off} of "
          f"{n_elems:,} elements (parameters and AdamW moments) differ from "
          f"an unbroken run's; the default mode's timed run is off the "
          f"unbroken run's by more than atol 1e-5 + rtol 1e-4 in {n_spread} "
          f"({json.dumps(top)}); {run_s:.1f}s with the restart", flush=True)
    if n_off:
        fail(f"{arch}: the restarted run ends in {n_off} elements off an "
             f"unbroken run's under deterministic algorithms")
    state = restarted
    del unbroken, state0, state1, got, want
    timed_ms = step_ms[RECSYS_WARMUP:]
    model = Recsys(cfg, state[0])

    # the card's logits against a CPU forward of the same parameters
    first = cached(0)
    sub = {k: v[:RECSYS_CHECK] for k, v in first.items()}
    with torch.no_grad():
        got = serve_score(model, sub, cfg).cpu()
        host = Recsys(cfg, tree_map(lambda x: x.cpu() if isinstance(
            x, torch.Tensor) else x, state[0]))
        want = serve_score(host, {k: v.cpu() for k, v in sub.items()}, cfg)
    if not torch.allclose(got, want, rtol=1e-4, atol=1e-6) or not torch.isfinite(got).all():
        fail(f"{arch}: logits on the card differ from the CPU forward: max "
             f"|diff| {float((got - want).abs().max()):.3e}")
    logit_diff = float((got - want).abs().max())

    # smoke-config steps on the card against the CPU, from one init
    smoke = bundle.smoke
    init = convert.recsys_params_to_arrays(init_model(smoke, 0, "cpu"))
    runs = {}
    for dev in ("cpu", DEVICE):
        st, stp, bts, _ = build_training(arch, True, SMOKE_BATCH, device=dev,
                                         params=init)
        ls = []
        for s in range(SMOKE_STEPS):
            st, m = stp(st, bts(s))
            ls.append(float(m["loss"]))
        runs[dev] = (st, ls)
    if not np.allclose(runs[DEVICE][1], runs["cpu"][1], rtol=1e-5, atol=0):
        fail(f"{arch} smoke steps: card losses {runs[DEVICE][1]} != CPU "
             f"{runs['cpu'][1]}")
    smoke_worst = worst_ratio(torch, named_leaves(runs[DEVICE][0][0]),
                              named_leaves(runs["cpu"][0][0]))
    if smoke_worst > 1:
        fail(f"{arch} smoke steps: card parameters {smoke_worst:.2f}x the "
             "tolerance off the CPU's")

    # serving: the serve shapes from the trainer's batches, on the card
    serve_ms = {}
    cat = {k: torch.cat([cached(s)[k] for s in range(SEQ_STEPS)])
           for k in first}
    with torch.no_grad():
        for name, reps in SERVE_REPS.items():
            n = shapes[name].batch
            if n > len(cat["target"]):
                fail(f"{arch}: {name} needs {n} examples")
            b = {k: v[:n] for k, v in cat.items()}
            out = serve_score(model, b, cfg)
            if out.shape != (n,) or not torch.isfinite(out).all():
                fail(f"{arch}: {name} scores are not {n} finite values")
            serve_ms[name] = event_ms(lambda b=b: serve_score(model, b, cfg), reps)
        del cat
        want_c = shapes["retrieval_cand"].n_candidates
        rng = np.random.default_rng(5)
        cands = torch.from_numpy(rng.integers(0, cfg.item_vocab, want_c)
                                 .astype(np.int32)).to(DEVICE)
        user = {"history": first["history"][:1], "hist_mask": first["hist_mask"][:1]}

        def retrieve(c):
            return retrieval_step(model, {**user, "candidates": cands[:c]}, cfg)

        n_cand, per = retrieval_size(torch, retrieve, want_c)
        torch.cuda.reset_peak_memory_stats()
        scores = retrieve(n_cand)
        retr_peak = torch.cuda.max_memory_allocated()
        if scores.shape != (n_cand,) or not torch.isfinite(scores).all():
            fail(f"{arch}: retrieval scores are not {n_cand} finite values")
        retr_ms = event_ms(lambda: retrieve(n_cand), RETRIEVAL_REPS)
        cpu_scores = retrieval_step(host, {
            **{k: v.cpu() for k, v in user.items()},
            "candidates": cands[:RETRIEVAL_CHECK].cpu()}, cfg)
        if not torch.allclose(scores[:RETRIEVAL_CHECK].cpu(), cpu_scores,
                              rtol=1e-4, atol=1e-6):
            fail(f"{arch}: retrieval scores on the card differ from the CPU's")
        del scores
    if n_cand < want_c:
        print(f"[chip_smoke] retrieval cut: {arch} retrieves {n_cand:,} "
              f"candidates, not {want_c:,}: {per:,.0f} B a candidate on the "
              f"card, {want_c * per / 1e9:.1f} GB for all of them", flush=True)
    line = {
        "config": cfg.name, "params": tree_size(state[0]), "batch": batch,
        "steps": SEQ_STEPS, "warmup_steps": RECSYS_WARMUP,
        "step_p50_ms": float(np.percentile(timed_ms, 50)),
        "step_p99_ms": float(np.percentile(timed_ms, 99)),
        "step_ms": timed_ms, "losses": timed_losses,
        "restart_run_losses": losses,
        "examples_per_s": batch / (float(np.percentile(timed_ms, 50)) / 1e3),
        "run_stats": stats.as_dict(), "save_every": SEQ_SAVE_EVERY,
        "fail_at": SEQ_FAIL_AT, "checkpoint_bytes_on_disk": ckpt_bytes,
        "run_s": run_s, "restart_elements_off": n_off,
        "default_mode_elements_off": n_spread, "elements_compared": n_elems,
        "logits_max_abs_diff": logit_diff,
        "smoke_worst_of_tolerance": smoke_worst,
        "max_memory_allocated": peak,
        "serve_p99_ms": serve_ms["serve_p99"],
        "serve_p99_batch": shapes["serve_p99"].batch,
        "serve_bulk_ms": serve_ms["serve_bulk"],
        "serve_bulk_batch": shapes["serve_bulk"].batch,
        "retrieval_candidates": n_cand, "retrieval_shape_candidates": want_c,
        "retrieval_ms": retr_ms, "retrieval_bytes_per_candidate": per,
        "retrieval_max_memory_allocated": retr_peak,
        "arch_s": time.perf_counter() - t_arch, "card": card,
    }
    print(f"[chip_smoke] recsys seq: {json.dumps(line)}", flush=True)
    del model, host, state
    torch.cuda.empty_cache()
    return line


def free_bytes(torch) -> int:
    """The card's free bytes once Python's reference cycles are collected
    and the caching allocator has let go of its cached blocks."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.mem_get_info()[0]


def rel_l2(got, want) -> float:
    g, w = got.detach().double().cpu(), want.detach().double().cpu()
    return float((g - w).norm() / w.norm().clamp_min(1e-30))


def hold(torch, out: dict, name: str, got, want, bound: float, gate=True) -> None:
    """Hold ``got`` (on the card) to ``want`` within a relative L2 error of
    ``bound``, both finite and of one shape; the result goes into ``out``.
    With ``gate`` False the error is recorded and not held (an MoE at
    bf16, see ``LM_BF16_REL``); the shapes and finiteness still are."""
    r = rel_l2(got, want)
    mx = float((got.detach().float().cpu() - want.detach().float().cpu()).abs().max())
    out[name] = {"rel_l2": r, "max_abs_diff": mx, "bound": bound if gate else None}
    if (got.shape != want.shape or not bool(torch.isfinite(got).all())
            or (gate and r > bound)):
        fail(f"lm: {name}: relative L2 {r:.3e} (max |diff| {mx:.3e}) against "
             f"its bound {bound:g}, shapes {tuple(got.shape)} {tuple(want.shape)}")


def lm_tokens(cfg, n: int, seed: int = 1):
    """``n`` tokens of the LM pipeline's stream (``TokenStream``) as a [1, n]
    tensor on the card."""
    import torch

    from repro_torch.data.lm_data import TokenStream

    toks = TokenStream(cfg.vocab, n, seed=seed).tokens
    return torch.from_numpy(toks.astype(np.int64))[None].to(DEVICE)


def lm_logits(torch, model, tok, cfg):
    """The last hidden states of ``forward`` through the head, in f32."""
    from repro_torch.models import transformer as T

    with torch.no_grad():
        h, _ = T.forward(model, tok, cfg)
        return (h @ model.lm_head.to(cfg.compute_dtype)).float()


def hold_cpu_logits(torch, model, cfg, tok, out, label) -> None:
    """The card's logits of a prompt held to a CPU forward of the same
    parameters, at the config's bf16 (recorded only for an MoE) and at
    f32."""
    import dataclasses

    from repro_torch.models import transformer as T

    host = T.Transformer(cfg, {
        "embed": model.embed.detach().cpu(), "final_ln": model.final_ln.detach().cpu(),
        "lm_head": model.lm_head.detach().cpu(),
        "layers": {n: p.detach().cpu() for n, p in model.layers.named_parameters()}})
    for dt, bound in ((torch.bfloat16, LM_BF16_REL), (torch.float32, LM_F32_REL)):
        c = dataclasses.replace(cfg, compute_dtype=dt)
        got = lm_logits(torch, model, tok, c)
        want = lm_logits(torch, host, tok.cpu(), c)
        hold(torch, out, f"{label}_cpu_logits_{str(dt)[6:]}", got, want, bound,
             gate=not cfg.is_moe or dt == torch.float32)
    del host


def decode_from(torch, model, cfg, tok, start: int, total: int):
    """Logits after teacher-forcing ``tok[:, start:total]`` through
    ``serve_step`` on a ``total``-slot cache filled by ``prefill_step`` of
    ``tok[:, :start]``; and each step's ms."""
    from repro_torch.models import transformer as T

    _, pc = T.prefill_step(model, tok[:, :start], cfg)
    cache = T.init_cache(cfg, tok.shape[0], total, DEVICE)
    cache[:, :, :, :pc.shape[3]] = pc
    del pc
    ms = []
    for i in range(start, total):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = T.serve_step(model, cache, tok[:, i], i, cfg)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return lg, ms


def lm_restart(torch, S: int, card) -> dict:
    """qwen3-0.6b's restart check at full width: under deterministic
    algorithms, LM_RESTART_STEPS steps through ``FaultTolerantRunner`` (a
    checkpoint every LM_SAVE_EVERY, a failure at LM_FAIL_AT) end bit-equal
    to the same steps without it: parameters, both AdamW moments, step
    count; the replayed step's loss equals its first pass."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed import FaultTolerantRunner, SimulatedFailure
    from repro_torch.launch.train import build_training, named_leaves

    made = {}
    losses = []
    # a tmpfs where there is one: each checkpoint holds 9 GB of state
    shm = "/dev/shm"
    ckpt = tempfile.mkdtemp(prefix="chip-smoke-lm-",
                            dir=shm if os.access(shm, os.W_OK) else None)
    torch.use_deterministic_algorithms(True)
    try:
        state, step, batches, cfg = build_training(LM_ARCH, False, LM_RESTART_BATCH,
                                                   S, device=DEVICE)

        def cached(s):
            if s not in made:
                made[s] = batches(s)
            return made[s]

        def logged(st, b):
            st, m = step(st, b)
            losses.append(float(m["loss"]))
            return st, m

        t0 = time.perf_counter()
        unbroken = state
        for s in range(LM_RESTART_STEPS):
            unbroken, _ = step(unbroken, cached(s))
        torch.cuda.synchronize()
        unbroken_s = time.perf_counter() - t0
        state, *_ = build_training(LM_ARCH, False, LM_RESTART_BATCH, S, device=DEVICE)
        runner = FaultTolerantRunner(logged, CheckpointManager(ckpt, keep=2),
                                     save_every=LM_SAVE_EVERY)
        t0 = time.perf_counter()
        restarted = runner.run(state, cached, LM_RESTART_STEPS,
                               failure=SimulatedFailure(at_steps=(LM_FAIL_AT,)))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(ckpt, ignore_errors=True)
    stats = runner.stats
    if stats.restarts != 1 or stats.steps_completed != LM_RESTART_STEPS + stats.wasted_steps:
        fail(f"lm restart: run statistics {stats}, not one restart")
    if not np.isfinite(losses).all():
        fail(f"lm restart: a loss is not finite: {losses}")
    at = LM_FAIL_AT - stats.wasted_steps
    if losses[at] != losses[LM_FAIL_AT]:
        fail(f"lm restart: the replayed step {at} lost {losses[LM_FAIL_AT]}, its "
             f"first pass {losses[at]}")
    if not int(unbroken[1]["count"]) == int(restarted[1]["count"]) == LM_RESTART_STEPS:
        fail(f"lm restart: step counts {unbroken[1]['count']} and {restarted[1]['count']}")

    def tensors(st):
        return named_leaves({"params": st[0], "m": st[1]["m"], "v": st[1]["v"]})

    want, got = tensors(unbroken), tensors(restarted)
    if not all(t.device.type == torch.device(DEVICE).type for t in got.values()):
        fail("lm restart: a restored leaf is not on the card")
    n_off = sum(int((got[k] != w).sum()) for k, w in want.items())
    n = sum(w.numel() for w in want.values())
    print(f"[chip_smoke] lm restart, deterministic algorithms, batch "
          f"{LM_RESTART_BATCH} x {S}: the replayed step {at}'s loss equals its "
          f"first pass; {n_off} of {n:,} elements (parameters and AdamW "
          f"moments) differ from an unbroken run's; {run_s:.1f}s with the "
          f"restart and {stats.steps_completed} steps, {unbroken_s:.1f}s for "
          f"the {LM_RESTART_STEPS} unbroken steps [{card}]", flush=True)
    if n_off:
        fail(f"lm restart: {n_off} elements off an unbroken run's")
    return {"restart_batch": LM_RESTART_BATCH, "restart_steps": LM_RESTART_STEPS,
            "save_every": LM_SAVE_EVERY, "fail_at": LM_FAIL_AT,
            "run_stats": stats.as_dict(), "restart_run_losses": losses,
            "restart_run_s": run_s, "restart_elements_off": n_off,
            "elements_compared": n}


def lm_train_batch(torch, S: int, want: int) -> tuple[int, dict]:
    """The train batch: the largest power of two up to ``want`` whose
    predicted peak fits LM_MEM_SHARE of the free memory, and at most
    LM_BATCH_CAP.  A step's peak is the larger of its forward and backward
    (measured at each of LM_PROBE_BATCHES sequences, linear in the batch)
    and AdamW's update (measured by a whole step at the first: its
    temporaries do not grow with the batch)."""
    from repro_torch.launch.train import build_training
    from repro_torch.models import transformer as T

    peaks = {}
    for i, b in enumerate(LM_PROBE_BATCHES):
        free_bytes(torch)
        state, step, batches, cfg = build_training(LM_ARCH, False, b, S, device=DEVICE)
        bt = batches(0)
        model = T.Transformer(cfg, state[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        torch.autograd.grad(T.loss_fn(model, bt, cfg), list(model.parameters()))
        torch.cuda.synchronize()
        peaks[b] = torch.cuda.max_memory_allocated()
        if i == 0:
            torch.cuda.reset_peak_memory_stats()
            state, m = step(state, bt)
            float(m["loss"])
            step_peak = torch.cuda.max_memory_allocated()
            del m
        del state, step, batches, bt, model
    free = free_bytes(torch)
    b0, b1 = LM_PROBE_BATCHES
    per = (peaks[b1] - peaks[b0]) / (b1 - b0)
    fixed = peaks[b0] - b0 * per

    def predicted(b):
        return max(fixed + per * b, step_peak)

    fits = 1
    while 2 * fits <= want and predicted(2 * fits) <= LM_MEM_SHARE * free:
        fits *= 2
    return fits, {"probe_fwd_bwd_peaks": peaks, "probe_step_peak": step_peak,
                  "bytes_per_sequence": per, "fixed_bytes": fixed,
                  "free_bytes": free, "batch_that_fits": fits,
                  "predicted_peak": predicted(min(fits, LM_BATCH_CAP))}


def run_lm_qwen3(torch, card, reduced: list) -> dict:
    """Phase 3c (a): qwen3-0.6b's whole FULL config trained, restarted,
    prefilled and decoded on the card, and held at full width."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.launch.train import build_training
    from repro_torch.models import transformer as T

    bundle = get_arch(LM_ARCH)
    shapes = {s.name: s for s in bundle.shapes}
    S = shapes["train_4k"].seq_len
    t0 = time.perf_counter()
    line = lm_restart(torch, S, card)
    restart_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fits, probe = lm_train_batch(torch, S, shapes["train_4k"].batch)
    probe_s = time.perf_counter() - t0
    B = min(fits, LM_BATCH_CAP)
    reduced.append({"what": f"{LM_ARCH} train_4k batch", "was": shapes["train_4k"].batch,
                    "is": fits, "why": f"the largest power of two whose peak, measured "
                    f"at {LM_PROBE_BATCHES} sequences, fits {LM_MEM_SHARE:.0%} of "
                    f"the card's free memory"})
    if B < fits:
        reduced.append({"what": f"{LM_ARCH} timed train batch", "was": fits, "is": B,
                        "why": "the run's time limit: a step takes ~0.65 s a "
                        "sequence of 4,096 tokens (f32 attention, TF32 off), so "
                        "the 8 steps at the batch that fits take ~80 s"})
    reduced.append({"what": f"{LM_ARCH} restart check batch", "was": B,
                    "is": LM_RESTART_BATCH, "why": "the check is of the state "
                    "(12 GB at any batch); a step at batch 1 takes ~1 s"})
    free_bytes(torch)
    t0 = time.perf_counter()
    state, step, batches, cfg = build_training(LM_ARCH, False, B, S, device=DEVICE)
    if not (cfg == bundle.full
            and state[0]["embed"].device.type == torch.device(DEVICE).type):
        fail("lm train: not the full config on the card")
    n_steps = LM_WARMUP + LM_STEPS
    bts = [batches(s) for s in range(n_steps + LM_PROFILE)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    for b in bts[:n_steps]:
        t1 = time.perf_counter()
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    if not np.isfinite(losses).all():
        fail(f"lm train: a loss is not finite: {losses}")
    holder = [state]

    def traced(b):
        holder[0], m = step(holder[0], b)
        losses.append(float(m["loss"]))

    timing = {}
    prof = profile_calls(torch, [lambda b=b: traced(b) for b in bts[n_steps:]], card,
                         "lm train", "steps", timing, cpu=False)
    params = holder[0][0]
    del state, holder, step, bts, m
    free_bytes(torch)
    timed = step_ms[LM_WARMUP:]
    p50 = float(np.percentile(timed, 50))
    tokens = B * S
    line.update({
        "config": cfg.name, "params": cfg.param_count(),
        "active_params": cfg.active_param_count(), "batch": B, "seq_len": S,
        "warmup_steps": LM_WARMUP, "steps": LM_STEPS, "step_ms": timed,
        "step_p50_ms": p50, "step_p99_ms": float(np.percentile(timed, 99)),
        "tokens_per_s": tokens / (p50 / 1e3), "losses": losses,
        "max_memory_allocated": peak, **probe,
        "traced_steps": LM_PROFILE, "traced_wall_ms": timing["wall_ms"],
        "device_busy_ms": timing["busy_ms"],
        "device_busy_share": timing["busy_ms"] / timing["wall_ms"],
        "top_device_ms": {k: round(v, 3) for k, v in sorted(
            prof.items(), key=lambda kv: -kv[1])[:8]},
        "mfu": 6.0 * cfg.active_param_count() * tokens / (p50 / 1e3) / BF16_PEAK,
        "mfu_peak_flops": BF16_PEAK, "restart_piece_s": restart_s,
        "probe_piece_s": probe_s, "train_piece_s": time.perf_counter() - t0,
        "card": card,
    })
    print(f"[chip_smoke] lm train: {json.dumps(line)}", flush=True)

    # held at full width: logits of a prompt against a CPU forward, the
    # chunked path against the full one, decode against prefill
    model = T.Transformer(cfg, params)
    held = {}
    tok = lm_tokens(cfg, shapes["prefill_32k"].seq_len)
    t0 = time.perf_counter()
    hold_cpu_logits(torch, model, cfg, tok[:, :LM_CHECK_TOKENS], held, LM_ARCH)
    cpu_hold_s = time.perf_counter() - t0
    for dt, bound in ((torch.bfloat16, LM_BF16_REL), (torch.float32, LM_F32_REL)):
        c = dataclasses.replace(cfg, compute_dtype=dt)
        if not (LM_CHUNK_CHECK > c.attn_chunk and LM_CHUNK_CHECK % c.attn_chunk == 0):
            fail("lm: the chunk check does not take the chunked path")
        with torch.no_grad():
            hc, _ = T.forward(model, tok[:, :LM_CHUNK_CHECK], c)
            hf, _ = T.forward(model, tok[:, :LM_CHUNK_CHECK],
                              dataclasses.replace(c, attn_chunk=2 * LM_CHUNK_CHECK))
        hold(torch, held, f"chunked_vs_full_{str(dt)[6:]}", hc, hf, bound)
        want, _ = T.prefill_step(model, tok[:, :LM_HOLD_LEN], c)
        got, _ = decode_from(torch, model, c, tok, LM_HOLD_PREFILL, LM_HOLD_LEN)
        hold(torch, held, f"decode_vs_prefill_{str(dt)[6:]}", got, want, bound)
    del hc, hf

    holds_s = time.perf_counter() - t0
    # prefill at prefill_32k's length, batch 1
    Sp = shapes["prefill_32k"].seq_len
    free_bytes(torch)
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    lg, cache = T.prefill_step(model, tok, cfg)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t1
    prefill_peak = torch.cuda.max_memory_allocated()
    if lg.shape != (1, cfg.vocab) or not bool(torch.isfinite(lg).all()):
        fail("lm prefill: the logits are not finite or not [1, vocab]")
    del lg, cache
    reduced.append({"what": f"{LM_ARCH} prefill_32k batch",
                    "was": shapes["prefill_32k"].batch, "is": 1,
                    "why": "one sequence times the chunked path at its length"})

    # decode on decode_32k's cache, filled from a prefill of LM_DECODE_PREFILL
    t0 = time.perf_counter()
    Sd, want_b = shapes["decode_32k"].seq_len, shapes["decode_32k"].batch
    _, pc = T.prefill_step(model, tok[:, :LM_DECODE_PREFILL], cfg)
    rng = np.random.default_rng(2)

    def decode_peak(b):
        c = T.init_cache(cfg, b, Sd, DEVICE)
        c[:, :, :, :LM_DECODE_PREFILL] = pc
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        T.serve_step(model, c, torch.zeros(b, dtype=torch.long, device=DEVICE),
                     LM_DECODE_PREFILL, cfg)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated()

    p1 = decode_peak(1)
    per = decode_peak(2) - p1
    room = LM_DECODE_MEM_SHARE * (free_bytes(torch) + torch.cuda.memory_allocated())
    Bd = 1
    while 2 * Bd <= want_b and p1 + per * (2 * Bd - 1) <= room:
        Bd *= 2
    reduced.append({"what": f"{LM_ARCH} decode_32k batch", "was": want_b, "is": Bd,
                    "why": f"the largest power of two whose measured memory "
                    f"({per / 1e9:.2f} GB a sequence) fits "
                    f"{LM_DECODE_MEM_SHARE:.0%} of the card"})
    cache = T.init_cache(cfg, Bd, Sd, DEVICE)
    cache[:, :, :, :LM_DECODE_PREFILL] = pc
    del pc
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (LM_DECODE_STEPS, Bd))).to(DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dec_ms = []
    for i in range(LM_DECODE_STEPS):
        t1 = time.perf_counter()
        lg, cache = T.serve_step(model, cache, toks[i], LM_DECODE_PREFILL + i, cfg)
        torch.cuda.synchronize()
        dec_ms.append((time.perf_counter() - t1) * 1e3)
    dec_peak = torch.cuda.max_memory_allocated()
    if lg.shape != (Bd, cfg.vocab) or not bool(torch.isfinite(lg).all()):
        fail("lm decode: the logits are not finite or not [batch, vocab]")
    cache_bytes = cache.numel() * cache.element_size()
    del cache, lg, model, params
    free_bytes(torch)
    d50 = float(np.percentile(dec_ms, 50))
    serve = {
        "config": cfg.name, "prefill_tokens": Sp, "prefill_ms": prefill_s * 1e3,
        "prefill_tokens_per_s": Sp / prefill_s, "prefill_max_memory_allocated": prefill_peak,
        "decode_batch": Bd, "decode_cache_slots": Sd,
        "decode_prefill_tokens": LM_DECODE_PREFILL, "decode_steps": LM_DECODE_STEPS,
        "decode_cache_bytes": cache_bytes, "decode_step_ms": dec_ms,
        "decode_ms_per_token_p50": d50,
        "decode_ms_per_token_p99": float(np.percentile(dec_ms, 99)),
        "decode_tokens_per_s": Bd / (d50 / 1e3), "decode_max_memory_allocated": dec_peak,
        "held": held, "cpu_hold_s": cpu_hold_s, "holds_piece_s": holds_s,
        "decode_piece_s": time.perf_counter() - t0, "card": card,
    }
    print(f"[chip_smoke] lm serve: {json.dumps(serve)}", flush=True)
    return {"train": line, "serve": serve}


def no_drop(cfg):
    """``cfg`` with a capacity of every token of a group (capacity_factor
    E / k): a prefill of T tokens drops those over its capacity, a decode
    step of one token never does, so decode equals prefill only where
    nothing is dropped."""
    import dataclasses

    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)


def lm_depth(torch, full, probe, share=LM_MEM_SHARE) -> tuple[int, dict]:
    """The most layers of ``full`` (at its width) whose peak fits ``share``
    of the free memory, from ``probe(cfg)`` (which returns its peak) at 1
    and 2 layers."""
    import dataclasses

    peaks = {}
    for L in (1, 2):
        free_bytes(torch)
        peaks[L] = probe(dataclasses.replace(full, n_layers=L))
    free = free_bytes(torch)
    per = peaks[2] - peaks[1]
    L = int((share * free - (peaks[1] - per)) // per)
    if L < 1:
        fail(f"{full.name}: not one layer fits ({peaks})")
    return min(L, full.n_layers), {"probe_peaks": peaks, "bytes_per_layer": per,
                                   "free_bytes": free}


def run_lm_moonshot(torch, card, reduced: list) -> dict:
    """Phase 3c (b): moonshot-v1-16b-a3b at full width, its depth the most
    layers whose measured training peak fits: train steps at train_4k's
    length; every expert of every layer receives gradient from uniform
    tokens in sequences of 16 (the reference's contract, 4,096 tokens; a
    4,096-token sequence of the Zipf stream starves some experts at this
    width, and its count is printed beside); prefill and decode, held to a
    CPU forward and to a prefill."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data.lm_data import ShardedBatchLoader, TokenStream
    from repro_torch.launch.cells import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.models.common import param_dict
    from repro_torch.optim import adamw_init

    bundle = get_arch(MOONSHOT_ARCH)
    S = next(s.seq_len for s in bundle.shapes if s.name == "train_4k")
    loader = ShardedBatchLoader(TokenStream(bundle.full.vocab, S * 64 + 1), 1, S)

    def batch(s):
        return {k: torch.from_numpy(v).to(DEVICE) for k, v in loader.batch_at(s).items()}

    def setup(cfg):
        model = T.init_model(cfg, 0, DEVICE)
        return model, adamw_init(param_dict(model)), make_train_step(T.loss_fn, cfg)

    def probe(cfg):
        model, opt, step = setup(cfg)
        b = batch(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, _, m = step(model, opt, b)
        float(m["loss"])
        return torch.cuda.max_memory_allocated()

    L, depth = lm_depth(torch, bundle.full, probe)
    cfg = dataclasses.replace(bundle.full, n_layers=L)
    reduced.append({"what": f"{MOONSHOT_ARCH} layers", "was": bundle.full.n_layers,
                    "is": L, "why": f"the most whose measured training peak "
                    f"({depth['bytes_per_layer'] / 1e9:.1f} GB a layer) fits "
                    f"{LM_MEM_SHARE:.0%} of the card"})
    model, opt, step = setup(cfg)
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    for s in range(MOONSHOT_STEPS):
        b = batch(s)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, _, m = step(model, opt, b)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    del opt

    def experts_fed(tok):  # (layer, expert) pairs whose w1 gets gradient
        loss = T.lm_loss(model, tok, tok, cfg)
        (g1,) = torch.autograd.grad(loss, [model.layers.w1])  # [L, E, d, ff]
        return int((g1.abs().sum((2, 3)) > 0).sum())

    # the reference's contract (test_moe_routes_and_trains): uniform tokens
    # in sequences of its 16, here as many as make train_4k's 4,096 tokens
    rng = np.random.default_rng(4)
    fed = experts_fed(torch.from_numpy(
        rng.integers(0, cfg.vocab, (S // MOE_CHECK_SEQ, MOE_CHECK_SEQ))).to(DEVICE))
    fed_loader = experts_fed(batch(MOONSHOT_STEPS)["tokens"])
    if not np.isfinite(losses).all() or fed != L * cfg.n_experts:
        fail(f"{MOONSHOT_ARCH}: losses {losses}, {fed} of {L * cfg.n_experts} "
             f"experts received gradient")
    held = {}
    tok = lm_tokens(cfg, S + MOONSHOT_DECODE)
    hold_cpu_logits(torch, model, cfg, tok[:, :LM_CHECK_TOKENS], held, MOONSHOT_ARCH)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    T.prefill_step(model, tok[:, :S], cfg)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t1) * 1e3
    got, dec_ms = decode_from(torch, model, cfg, tok, S, S + MOONSHOT_DECODE)
    if not bool(torch.isfinite(got).all()):
        fail(f"{MOONSHOT_ARCH}: decode logits are not finite")
    for dt, bound in ((torch.bfloat16, LM_BF16_REL), (torch.float32, LM_F32_REL)):
        hcfg = no_drop(dataclasses.replace(cfg, compute_dtype=dt))
        want, _ = T.prefill_step(model, tok, hcfg)
        got, _ = decode_from(torch, model, hcfg, tok, S, S + MOONSHOT_DECODE)
        hold(torch, held, f"decode_vs_prefill_{str(dt)[6:]}_no_drop", got, want,
             bound, gate=dt == torch.float32)
    del model
    free_bytes(torch)
    line = {"config": cfg.name, "layers": L, "params": cfg.param_count(),
            "active_params": cfg.active_param_count(), "batch": 1, "seq_len": S,
            "step_ms": step_ms, "losses": losses, "max_memory_allocated": peak,
            "experts_with_gradient": fed, "experts": L * cfg.n_experts,
            "experts_with_gradient_loader_batch": fed_loader, **depth,
            "prefill_tokens": S, "prefill_ms": prefill_ms,
            "decode_steps": MOONSHOT_DECODE, "decode_step_ms": dec_ms,
            "held": held, "card": card}
    print(f"[chip_smoke] lm moonshot: {json.dumps(line)}", flush=True)
    return line


def run_lm_mixtral(torch, card, reduced: list) -> dict:
    """Phase 3c (c): mixtral-8x22b at full width, serve only, its depth the
    most layers that fit: a prefill of two whole windows, then decode
    through the ring past them; a decode from one window held to the
    card's prefill of the same tokens."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T

    full = get_arch(MIXTRAL_ARCH).full
    W = full.sliding_window
    if MIXTRAL_PREFILL % W or MIXTRAL_HOLD % W:
        fail("mixtral: the prefills must be whole windows to line up with the ring")
    hold_len = MIXTRAL_HOLD + MIXTRAL_DECODE
    tok = lm_tokens(full, MIXTRAL_PREFILL + MIXTRAL_DECODE)

    def probe(cfg):
        model = T.init_model(cfg, 0, DEVICE)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        T.prefill_step(model, tok[:, :MIXTRAL_PREFILL], cfg)
        T.prefill_step(model, tok[:, :hold_len],
                       no_drop(dataclasses.replace(cfg, compute_dtype=torch.float32)))
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated()

    L, depth = lm_depth(torch, full, probe)
    cfg = dataclasses.replace(full, n_layers=L)
    reduced.append({"what": f"{MIXTRAL_ARCH} layers", "was": full.n_layers, "is": L,
                    "why": f"the most whose measured serving peak "
                    f"({depth['bytes_per_layer'] / 1e9:.1f} GB a layer) fits "
                    f"{LM_MEM_SHARE:.0%} of the card"})
    reduced.append({"what": f"{MIXTRAL_ARCH} shapes", "was": "train, prefill, decode",
                    "is": "prefill and decode", "why": "serve only: a layer's "
                    "training state alone is 40 GB"})
    model = T.init_model(cfg, 0, DEVICE)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    lg, cache = T.prefill_step(model, tok[:, :MIXTRAL_PREFILL], cfg)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t1) * 1e3
    if cache.shape[3] != W:
        fail(f"mixtral: the prefill's cache holds {cache.shape[3]} slots, not {W}")
    dec_ms = []
    for i in range(MIXTRAL_PREFILL, MIXTRAL_PREFILL + MIXTRAL_DECODE):
        t1 = time.perf_counter()
        lg, cache = T.serve_step(model, cache, tok[:, i], i, cfg)
        torch.cuda.synchronize()
        dec_ms.append((time.perf_counter() - t1) * 1e3)
    if not bool(torch.isfinite(lg).all()):
        fail("mixtral: decode logits are not finite")
    del cache
    held = {}
    for dt, bound in ((torch.bfloat16, LM_BF16_REL), (torch.float32, LM_F32_REL)):
        hcfg = no_drop(dataclasses.replace(cfg, compute_dtype=dt))
        want, _ = T.prefill_step(model, tok[:, :hold_len], hcfg)
        got, _ = decode_from(torch, model, hcfg, tok, MIXTRAL_HOLD, hold_len)
        hold(torch, held, f"decode_{MIXTRAL_HOLD}_to_{hold_len}_vs_prefill_"
             f"{str(dt)[6:]}_no_drop", got, want, bound, gate=dt == torch.float32)
    del model
    free_bytes(torch)
    line = {"config": cfg.name, "layers": L, "params": cfg.param_count(),
            "window": W, **depth, "prefill_tokens": MIXTRAL_PREFILL,
            "prefill_ms": prefill_ms, "prefill_tokens_per_s": MIXTRAL_PREFILL / (prefill_ms / 1e3),
            "decode_steps": MIXTRAL_DECODE, "decode_step_ms": dec_ms,
            "decode_ms_per_token_p50": float(np.percentile(dec_ms, 50)),
            "held": held, "card": card}
    print(f"[chip_smoke] lm mixtral: {json.dumps(line)}", flush=True)
    return line


def run_lm_smoke(torch, card) -> dict:
    """Phase 3c (d): the five LM archs' smoke configs from one init, on the
    card and on the CPU: a prefill and decode past the window at f32 held
    to each other (relative L2 LM_F32_REL; at bf16 the MoE archs' routers
    may break a near-tie apart), then 3 launcher steps (bf16), losses rtol
    2e-3."""
    import dataclasses

    from repro_torch import convert
    from repro_torch.configs import all_arch_ids, get_arch
    from repro_torch.launch.train import build_training
    from repro_torch.models import transformer as T

    out = {}
    for arch in [a for a in all_arch_ids() if get_arch(a).family == "lm"]:
        cfg = get_arch(arch).smoke
        init = convert.lm_params_to_arrays(T.init_model(cfg, 0, "cpu"))
        tok = np.random.default_rng(3).integers(0, cfg.vocab, (2, LM_SMOKE_SEQ))
        runs = {}
        for dev in ("cpu", DEVICE):
            st, step, batches, _ = build_training(arch, True, LM_SMOKE_BATCH, LM_SMOKE_SEQ,
                                                  device=dev, params=init)
            c32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
            model = T.Transformer(c32, st[0])
            t = torch.from_numpy(tok).to(dev)
            pl, _ = T.prefill_step(model, t, c32)
            cache = T.init_cache(c32, 2, LM_SMOKE_DECODE, dev)
            for i in range(LM_SMOKE_DECODE):
                dl, cache = T.serve_step(model, cache, t[:, i], i, c32)
            losses = []
            for s in range(SMOKE_STEPS):
                st, m = step(st, batches(s))
                losses.append(float(m["loss"]))
            runs[dev] = (pl, dl, losses)
        held = {}
        hold(torch, held, "prefill_float32", runs[DEVICE][0], runs["cpu"][0], LM_F32_REL)
        hold(torch, held, "decode_float32", runs[DEVICE][1], runs["cpu"][1], LM_F32_REL)
        if not np.allclose(runs[DEVICE][2], runs["cpu"][2], rtol=2e-3, atol=0):
            fail(f"{arch} smoke steps: card losses {runs[DEVICE][2]} != CPU "
                 f"{runs['cpu'][2]}")
        out[arch] = {"losses": runs[DEVICE][2], "cpu_losses": runs["cpu"][2], **held}
    print(f"[chip_smoke] lm smoke: {json.dumps(out)}", flush=True)
    return out


def run_lm_example(torch, card) -> dict:
    """Phase 3c (e): ``python -m repro_torch.examples.train_lm --steps 40``
    on the card: one restart, and the last losses below the first."""
    from repro_torch.examples import train_lm

    t0 = time.perf_counter()
    res = train_lm.run(LM_EXAMPLE_STEPS, device=DEVICE)
    run_s = time.perf_counter() - t0
    st, losses = res["stats"], res["losses"]
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    on_card = res["state"][0]["embed"].device.type == torch.device(DEVICE).type
    if st.restarts != 1 or not last < first or not on_card:
        fail(f"train_lm: {st}, first losses {first}, last {last}")
    line = {"steps": LM_EXAMPLE_STEPS, "run_stats": st.as_dict(),
            "first5_mean_loss": first, "last5_mean_loss": last, "run_s": run_s,
            "card": card}
    print(f"[chip_smoke] lm example: {json.dumps(line)}", flush=True)
    return line


def run_lm_path(torch, card) -> dict:
    """Phase 3c: the LM family on the card; returns each piece's seconds."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the runs held against the CPU sum bf16 products in f32 throughout
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t_phase = time.perf_counter()
    reduced, piece_s = [], {}
    for name, fn in (("qwen3", run_lm_qwen3), ("moonshot", run_lm_moonshot),
                     ("mixtral", run_lm_mixtral)):
        t0 = time.perf_counter()
        fn(torch, card, reduced)
        piece_s[name] = time.perf_counter() - t0
    for name, fn in (("smoke", run_lm_smoke), ("example", run_lm_example)):
        t0 = time.perf_counter()
        fn(torch, card)
        piece_s[name] = time.perf_counter() - t0
    phase_s = time.perf_counter() - t_phase
    print(f"[chip_smoke] lm reduced: {json.dumps(reduced)}", flush=True)
    # the budget is the run's time limit shared out, not a correctness
    # gate: a slow host prints over it, and the depth is cut in the source
    print(f"[chip_smoke] lm phase: {json.dumps(piece_s)}; {phase_s:.1f}s of "
          f"its {LM_PHASE_S:.0f}s budget [{card}]", flush=True)
    return piece_s


def bag_edge_cases(torch) -> dict:
    """embedding_bag against its plain version, bit for bit, at the edges
    of its tiling: B = BAG_EDGE_B bags of every K of BAG_EDGE_K over every
    D of BAG_EDGE_D, f32 and bf16 tables, with ids -1 and V planted, a +inf
    and a -inf row read under zero weights in every seventh bag and a third
    of the weights 0; then tables and ids off their vector alignment (the
    scalar paths).  Returns the mismatches by case; fails on any."""
    from repro_torch.kernels.embedding_bag import kernel as ek
    from repro_torch.kernels.embedding_bag import ref as eref

    rng = np.random.default_rng(4)
    B, V = BAG_EDGE_B, BAG_EDGE_V
    cases = {}

    def on_card(x):
        return torch.from_numpy(x).to(DEVICE)

    def inputs(K, D):
        table = rng.normal(size=(V, D)).astype(np.float32)
        table[5], table[6] = np.inf, -np.inf
        ids = rng.integers(0, V, (B, K))
        ids[ids == 5] = 7  # the inf rows only where planted
        ids[ids == 6] = 8
        w = rng.normal(size=(B, K)).astype(np.float32)
        w[rng.random((B, K)) < 1 / 3] = 0.0
        ids[0::2, 0], ids[1::2, K - 1] = -1, V
        ids[3::7, K // 2] = np.where(np.arange(len(ids[3::7])) % 2, 5, 6)
        w[3::7, K // 2] = 0.0
        return on_card(table), on_card(ids.astype(np.int32)), on_card(w)

    def check(name, t, i, w):
        mism, _ = compare_f32(ek.embedding_bag(t, i, w),
                              eref.embedding_bag_ref(t, i, w))
        cases[name] = mism

    for D in BAG_EDGE_D:
        for K in BAG_EDGE_K:
            table, ids, w = inputs(K, D)
            check(f"f32 D={D} K={K}", table, ids, w)
            check(f"bf16 D={D} K={K}", table.bfloat16(), ids, w)
    table, ids, w = inputs(64, 16)

    def shifted(x, by):  # the same values, `by` elements past an aligned start
        flat = torch.empty(x.numel() + by, dtype=x.dtype, device=x.device)
        flat[by:] = x.reshape(-1)
        return flat[by:].view(x.shape)

    check("f32 table 4 B past 16 B", shifted(table, 1), ids, w)
    check("ids and weights 4 B past 16 B", table, shifted(ids, 1), shifted(w, 1))
    check("bf16 table 2 B past 8 B", shifted(table.bfloat16(), 1), ids, w)
    check("bf16 table 8 B past 16 B", shifted(table.bfloat16(), 4), ids, w)
    bad = {k: v for k, v in cases.items() if v}
    if bad:
        fail(f"embedding_bag: edge launches differ from the plain version: {bad}")
    return cases


def check_recsys_kernels(torch, res, launches, card, profile):
    """Phase 7, ``embedding_bag``: against its plain version at the path's
    shape (the last step's ids and mask over the first field's rows), on
    the table padded to the reference's 128 columns, on a bf16 table, with
    out-of-range ids planted and on its edge launches (``bag_edge_cases``);
    timed with its wrapper, on the card alone and on the host, beside its
    bound and beside ``F.embedding_bag`` (the same function, timed as a
    yardstick only); ``profile``: the recsys profile's device ms by name;
    returns its row of the ``kernels`` line."""
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_bag import kernel as ek
    from repro_torch.kernels.embedding_bag import ref as eref

    cfg = res["state"]["cfg"]
    last = res["records"][-1]
    table = res["state"]["model"].table.detach()[: cfg.rows_per_field]
    ids, w = last["ids"], last["mask"].float()
    (B, K), (V, D) = ids.shape, table.shape
    checks = {}

    def check(name, t, i, ww):
        got = ek.embedding_bag(t, i, ww)
        mism, err = compare_f32(got, eref.embedding_bag_ref(t, i, ww))
        checks[name] = {"mismatches": mism, "max_abs_err": err}
        return got

    got = check(f"path D={D}", table, ids, w)
    padded = F.pad(table, (0, 128 - D))
    got128 = check("padded D=128", padded, ids, w)
    checks["padded D=128"]["equals the unpadded bag"] = bool(
        torch.equal(got128[:, :D], got))
    check("bf16 table", table.bfloat16(), ids, w)
    bad = ids.clone()
    bad[:, 0], bad[::2, 1] = -1, V
    wb = w.clone()
    wb[:, :2] = 1.0
    check("ids -1 and V", table, bad, wb)
    print(f"[chip_smoke] embedding_bag checks: {json.dumps(checks)}", flush=True)
    if not checks["padded D=128"]["equals the unpadded bag"]:
        fail("embedding_bag: the padded table's bag differs from the "
             "unpadded one")
    t0 = time.perf_counter()
    edges = bag_edge_cases(torch)
    edge_s = time.perf_counter() - t0
    ms = event_ms(lambda: ek.embedding_bag(table, ids, w), 20)
    dev_ms = device_ms(torch, lambda: ek.embedding_bag(table, ids, w))
    wrap_us = host_us(torch, lambda: ek.embedding_bag(table, ids, w))
    plain_ms = event_ms(lambda: eref.embedding_bag_ref(table, ids, w), 3)
    lib = F.embedding_bag(ids, table, per_sample_weights=w, mode="sum")
    lib_ms = event_ms(lambda: F.embedding_bag(ids, table, per_sample_weights=w,
                                              mode="sum"), 20)
    lib_err = float((lib - got).abs().max())
    ms128 = event_ms(lambda: ek.embedding_bag(padded, ids, w), 20)
    rows = len(torch.unique(eref.clamp_ids(ids, V)))
    nbytes = rows * D * 4 + B * K * 8 + B * D * 4
    gathered = B * K * D * 4
    items = int((w != 0).sum()) * D * 4  # the rows of real items, not padding
    mism = sum(c["mismatches"] for c in checks.values())
    err = max(c["max_abs_err"] for c in checks.values())
    prof = profile_ms(profile, "bag_kernel")
    return kernel_row(
        launches, card, "embedding_bag", "src/repro_torch/csrc/embedding_bag.cu",
        "src/repro/kernels/embedding_bag/kernel.py:38", mism, err, ms,
        plain_ms, nbytes,
        f"B={B:,} K={K} D={D} over {rows:,} distinct rows, + {len(edges)} "
        f"edge launches ({edge_s:.1f}s); {ms:.4f} ms with the wrapper, "
        f"{dev_ms:.4f} ms on the card alone, the wrapper's host time "
        f"{wrap_us:.1f} us; {gathered/1e6:.1f} MB gathered, "
        f"{gathered / dev_ms / 1e9:.2f} TB/s on the card alone "
        f"({gathered / HBM_BYTES_PER_S * 1e3:.4f} ms at the HBM rate), "
        f"{items/1e6:.1f} MB of them the items' rows, "
        f"{items / dev_ms / 1e9:.2f} TB/s; "
        f"previous design {PREVIOUS_MS['embedding_bag']:.4f} ms on the card "
        f"alone; padded D=128 {ms128:.4f} ms; F.embedding_bag "
        f"{lib_ms:.4f} ms, max |diff| {lib_err:.3e}; {prof:.4f} ms in the "
        f"recsys profile's {RECSYS_PROFILE} steps",
        note={"device_ms": dev_ms, "host_us": wrap_us,
              "library_ms": lib_ms, "library_max_abs_diff": lib_err,
              "gathered_bytes": gathered,
              "gathered_tb_per_s": gathered / dev_ms / 1e9,
              "item_bytes": items, "item_tb_per_s": items / dev_ms / 1e9,
              "distinct_rows": rows, "padded_d128_ms": ms128,
              "checks": checks, "edge_launches": len(edges),
              "edge_s": edge_s, "recsys_profile_ms": prof})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-lists", type=int, default=N_LISTS,
                    help="corpus depth of the boolean path; the full-size "
                         "run has 256 lists (the ranked path always does)")
    ap.add_argument("--ranked-queries", type=int, default=RANKED_QUERIES,
                    help="queries served by the ranked path (512)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    # phase 3b runs under torch's deterministic algorithms, which need
    # cuBLAS's workspace fixed before its first call (32 MiB, torch's
    # default on Hopper)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA card")
    if not os.path.isdir(os.path.join(SRC, "repro_torch", "csrc")):
        fail(f"the port's sources are not beside this script ({SRC})")
    sys.path.insert(0, SRC)
    from repro_torch.core.query_engine import QueryEngine
    from repro_torch.kernels import _build
    from repro_torch.kernels.blockmax_pivot import kernel as pk
    from repro_torch.kernels.embedding_bag import kernel as ebk
    from repro_torch.kernels.bm25_score import kernel as bk
    from repro_torch.kernels.ef_search import kernel as efk
    from repro_torch.kernels.gain_scan import kernel as gk
    from repro_torch.kernels.partition_scan import kernel as psk
    from repro_torch.kernels.pivot_score import kernel as sk
    from repro_torch.kernels.vbyte_decode import kernel as vk
    from repro_torch.launch import serve

    # 1. the card
    card = card_line()
    print(card, flush=True)
    print(f"[chip_smoke] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)

    # 2. build every kernel, one nvcc per source, all at once
    t0 = time.perf_counter()
    reports = _build.build_all(LIBS)
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[chip_smoke] ptxas {name}: {line.strip()}")
    print(f"[chip_smoke] kernels built in {time.perf_counter()-t0:.1f}s",
          flush=True)
    ptx_divs = check_ptx()

    # 3. the recsys trainer at full width, counted; embedding_bag's check
    # runs while the path's tensors are alive, then they are freed but the
    # trainer's batches, on which the sparse step trains; then DIN and BST
    t_phase = time.perf_counter()
    rec_res, rec_launches, rec_prof, rec_summary, rec_alone = run_recsys_path(
        torch, {"embedding_bag": ebk.embedding_bag, "decode_blocks":
                vk.decode_blocks}, card)
    bag_row = check_recsys_kernels(torch, rec_res, rec_launches, card, rec_prof)
    rec_batches = [r["batch"] for r in rec_res["records"]]
    del rec_res
    torch.cuda.empty_cache()
    dense_s = time.perf_counter() - t_phase
    sparse = run_sparse_step(torch, rec_batches, rec_summary, rec_alone, card)
    del rec_batches
    seq = {arch: run_seq_arch(torch, arch, card) for arch in SEQ_ARCHS}
    piece_s = {"dense": dense_s, "sparse": sparse["piece_s"],
               **{a: line["arch_s"] for a, line in seq.items()}}
    print(f"[chip_smoke] recsys phase: {json.dumps(piece_s)}; the sparse "
          f"step, DIN and BST took "
          f"{sum(piece_s.values()) - dense_s:.1f}s; phase "
          f"{time.perf_counter()-t_phase:.1f}s", flush=True)

    # 3c. the LM family at full width: qwen3-0.6b whole, moonshot and
    # mixtral at full width and cut depth, the smoke configs, train_lm
    run_lm_path(torch, card)

    # 4. the boolean path, counted
    counters = {"decode_search": vk.decode_search,
                "decode_blocks": vk.decode_blocks,
                "ef_search": efk.ef_search}
    res, ef_engine, launches = run_main_path(args.n_lists, torch, serve,
                                             counters, QueryEngine)
    if args.n_lists != N_LISTS:
        print(f"[chip_smoke] depth cut: the boolean path ran --n-lists "
              f"{args.n_lists} instead of {N_LISTS}", flush=True)
    summary = {
        "n_lists": args.n_lists, "postings": res["n_postings"],
        "build_s": res["build_s"], "bits_per_int": res["bpi"],
        "arena_device_bytes": res["arena_device_bytes"], "qps": res["qps"],
        "batch_p50_ms": res["batch_p50_s"] * 1e3,
        "batch_p99_ms": res["batch_p99_s"] * 1e3, "card": card,
    }
    print(f"[chip_smoke] boolean path: {json.dumps(summary)}", flush=True)
    # DeviceList over the index's two longest lists, and the two examples
    ex_launches = run_examples_path(res, torch, counters, card)

    bool_profile = profile_batches(torch, res["engine"].intersect_batch,
                                   res["queries"], card, "boolean")

    # 5. the index build through the device partitioners, counted
    build_gaps, blaunches = run_build_path(
        args.n_lists, res, torch,
        {"gain_scan": gk.gain_scan, "partition_scan": psk.partition_scan}, card)

    # 6. the ranked path, counted
    all_counters = {**counters, "bm25_score_probe": bk.bm25_score_probe,
                    "bm25_score_rows": bk.bm25_score_rows,
                    "pivot_select": pk.pivot_select,
                    "pivot_score": sk.pivot_score}
    rres, _, _, rlaunches = run_ranked_path(args.ranked_queries, torch, serve,
                                            all_counters, card)
    if args.ranked_queries != RANKED_QUERIES:
        print(f"[chip_smoke] ranked cut: {args.ranked_queries} queries "
              f"instead of {RANKED_QUERIES}", flush=True)
    rsummary = {
        "n_lists": N_LISTS, "postings": rres["n_postings"],
        "queries": len(rres["queries"]), "topk": TOPK,
        "freqs_s": rres["freqs_s"], "build_s": rres["build_s"],
        "arena_device_bytes": rres["arena_device_bytes"],
        "qps": rres["qps"], "batch_p50_ms": rres["batch_p50_s"] * 1e3,
        "batch_p99_ms": rres["batch_p99_s"] * 1e3,
        "stats": dict(rres["engine"].stats), "card": card,
    }
    print(f"[chip_smoke] ranked path: {json.dumps(rsummary)}", flush=True)
    reng = rres["engine"]
    ranked_profile = profile_batches(torch, lambda b: reng.topk_batch(b, TOPK),
                                     rres["queries"], card, "ranked")

    # 6b. the serving loop over the ranked path's engine, counted
    loop_launches = run_loop_path(rres, torch, serve, all_counters, card)

    # 6c. sharded serving: replicas, faults, checkpoints, recovery, counted
    shard_launches = run_shard_path(res, rres, torch, serve, all_counters,
                                    card)

    # 6d. the analyser on the card, and the full-size sync count
    analyze_launches = run_analyze_path(res, rres, torch, all_counters, card,
                                        ptx_divs)

    # 7. each kernel against its plain version
    kernels = check_kernels(torch, res, ef_engine, launches, card,
                            bool_profile)
    kernels += check_ranked_kernels(torch, rres, rlaunches, card,
                                    ranked_profile)
    kernels += check_build_kernels(torch, build_gaps, blaunches, card)
    kernels.append(bag_row)
    for row in kernels:
        row["loop_launches"] = loop_launches.get(row["name"], 0)
        row["shard_launches"] = shard_launches.get(row["name"], 0)
        row["analyze_launches"] = analyze_launches.get(row["name"], 0)
        row["examples_launches"] = ex_launches.get(row["name"], 0)
    if len(kernels) != N_KERNELS:
        fail(f"the kernels line has {len(kernels)} rows, not {N_KERNELS}")
    print(f"[chip_smoke] all phases passed in "
          f"{time.perf_counter()-t_start:.1f}s", flush=True)

    # 8. the kernels line, then the result line
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
