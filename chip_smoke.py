#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py                 # the full-size run
    python3 chip_smoke.py --n-lists 16    # a shallower corpus, same shapes

Run from the root of a checkout, on a machine with a CUDA card.  Phases:

1. card      -- ``nvidia-smi`` name and power limit;
2. build     -- compile every CUDA source of ``src/repro_torch/csrc`` with
   ``nvcc`` (one process each, all started together);
3. boolean  -- ``repro_torch.launch.serve`` over the full-size corpus
   (``--n-lists 256 --min-len 10000 --max-len 2000000 --seed 0 --codec
   auto``: 104.55 M postings), then a few batches through an engine over
   the ``ef`` arena of the SAME index, with every kernel's launch count set
   to 0 just before and read just after; the batched answers are checked
   against the port's scalar NextGEQ loop, and two batches are traced with
   ``torch.profiler`` (device time per kernel against the wall time);
4. ranked   -- ``serve --ranked --topk 10 --resident kernel`` over the same
   full-size corpus with its term frequencies, 512 queries of arity 2 in
   batches of 64; then 2 batches through ``resident="mirror"`` (which
   scores the whole arena once) and ``contributions()`` on 4,096 (term,
   doc) pairs, through the ``auto`` arena and through the ``ef`` arena of
   the same index, all with the launch counts set to 0 just before and
   read just after.  The top-k of 64 queries is held to ``exhaustive_topk``,
   the mirror's to the kernel residency's, the contributions to the host
   path, all exactly; two batches are traced as in phase 3;
5. kernels  -- each kernel against its plain PyTorch version on the card,
   at the main paths' shapes, over the arenas they built (integer
   contracts and the f32 BM25 contract: zero mismatches allowed), timed
   with CUDA events beside its bound (bytes moved over the card's memory
   rate);
6. the ``kernels`` JSON line, then the result line.

Phase 2 also reads the PTX of the two libraries that evaluate the f32
BM25 contract and fails on a contracted multiply-add (``fma.rn.f32``) or
an approximate division (``div.approx`` / ``div.full.f32``).

Exits non-zero, before the result line, if any phase fails, if there is no
CUDA card, or if the port's sources are not beside this script.
"""

from __future__ import annotations

import argparse
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
LIBS = ["vbyte_decode", "ef_search", "bm25_score", "blockmax_pivot",
        "pivot_score"]
# the libraries that evaluate the f32 BM25 contract, and what their PTX
# must not hold: a contracted multiply-add or an approximate division
F32_LIBS = ["bm25_score", "pivot_score"]
PTX_FORBIDDEN = ["fma.rn.f32", "div.approx", "div.full.f32"]
EF_BATCHES = 3  # batches served through the ef arena of the same index
CHECK_QUERIES = 64  # batched answers checked against the scalar loop
SEARCH_CURSORS = 1 << 20  # decode_search cursors held to the plain version
PROFILE_BATCHES = 2  # batches traced by torch.profiler
PLAIN_CHUNK = 1 << 19  # cursors (rows) per call of a plain version
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
    """Phase 3; returns (the serve summary, the ef engine, launches)."""
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


def profile_batches(torch, serve_batch, queries, card, label) -> None:
    """Where a batch's time goes: device time per kernel from
    ``torch.profiler`` against the wall time, and the host spans of
    ``repro_torch.obs``, over PROFILE_BATCHES batches of ``serve_batch``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs

    obs.reset()
    obs.enable()
    batches = [queries[i : i + BATCH]
               for i in range(0, PROFILE_BATCHES * BATCH, BATCH)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            serve_batch(b)
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
    spans = {}
    for (kind, name, labels), m in obs.REGISTRY.items():
        if kind == "Histogram" and name == "span_ms":
            span = dict(labels).get("span")
            spans[span] = spans.get(span, 0.0) + m.sum
    busy = sum(dev.values())
    top = dict(sorted(dev.items(), key=lambda kv: -kv[1])[:8])
    print(f"[chip_smoke] {label} profile over {len(batches)} batches: wall "
          f"{wall_ms:.1f} ms, device busy {busy:.2f} ms "
          f"({busy / wall_ms:.2%}), idle {1 - busy / wall_ms:.2%} [{card}]")
    print(f"[chip_smoke] {label} profile device ms by name: "
          f"{json.dumps({k: round(v, 4) for k, v in top.items()})}")
    print(f"[chip_smoke] {label} profile host span ms: "
          f"{json.dumps({k: round(v, 1) for k, v in spans.items()})}", flush=True)


def kernel_row(launches, card, name, src, replaces, mism, err, ms, plain_ms,
               nbytes, what) -> dict:
    """Print one kernel's check and return its row of the ``kernels`` line;
    fails on any mismatch against the plain version."""
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[chip_smoke] {name}: {what}: {mism} mismatches, kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({nbytes/1e6:.1f} MB at "
          f"{HBM_BYTES_PER_S/1e12:.2f} TB/s) [{card}]", flush=True)
    if mism:
        fail(f"{name}: {mism} mismatches against its plain version")
    return {
        "name": name, "route": "cuda", "source": src, "replaces": replaces,
        "launches": launches[name], "launches_main_path": launches[name],
        "mismatches": mism, "max_abs_err": err, "ms": ms, "kernel_ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
        "library_ms": None,
    }


def check_kernels(torch, res, ef_engine, launches, card):
    """Phase 5, the boolean kernels: each against its plain version;
    returns their rows of the ``kernels`` line."""
    from repro_torch.core.arena import CODEC_EF
    from repro_torch.kernels.ef_search import kernel as efk
    from repro_torch.kernels.ef_search import ref as efref
    from repro_torch.kernels.vbyte_decode import kernel as vk
    from repro_torch.kernels.vbyte_decode import ref as vref

    rng = np.random.default_rng(1)
    cuda = torch.device(DEVICE)
    rows_out = []

    def report(*a):
        rows_out.append(kernel_row(launches, card, *a))

    # -- decode_search over >= 2^20 cursors of the main path's arena ------
    a = res["engine"].arena
    dev = a.on(cuda)
    svb = (np.nonzero(a.block_codec != CODEC_EF)[0] if a.multi
           else np.arange(a.n_blocks))
    rows = svb[rng.integers(0, len(svb), SEARCH_CURSORS)]
    pe = search_probes(rng, a, rows)
    rows = rows.astype(np.int32)
    t_rows, t_pe = (torch.from_numpy(x).to(cuda) for x in (rows, pe))
    cr = dev.codec_row if a.multi else None
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
    ms = event_ms(lambda: vk.decode_search(*args_ds), 20)
    plain_ms = event_ms(lambda: chunked(vref.decode_search_ref, len(rows),
                                        *args_ds, per_cursor=(3, 4)), 2)
    u = len(np.unique(rows))
    nbytes = u * (512 + 512 + 4 + (4 if a.multi else 0)) + len(rows) * (4 + 4 + 8)
    report("decode_search", "src/repro_torch/csrc/vbyte_decode.cu",
           "src/repro/kernels/vbyte_decode/kernel.py:103",
           mism + m2, max(err, e2), ms, plain_ms, nbytes,
           f"{len(rows):,} cursors on {u:,} rows + {len(er)} near-2^31 cursors")

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
    t_rows, t_pe = (torch.from_numpy(x).to(cuda) for x in (rows, pe))
    args_ef = (edev.ef_lo, edev.ef_hi, edev.ef_lbits, edev.block_base, t_rows,
               t_pe, edev.codec_row)
    got = efk.ef_search(*args_ef)
    want = chunked(efref.ef_search_ref, len(rows), *args_ef, per_cursor=(4, 5))
    mism, err = compare(got, want)
    ms = event_ms(lambda: efk.ef_search(*args_ef), 20)
    plain_ms = event_ms(lambda: chunked(efref.ef_search_ref, len(rows),
                                        *args_ef, per_cursor=(4, 5)), 2)
    nbytes = len(ef_blocks) * (512 + 96 + 4 + 4 + 4) + len(rows) * (4 + 4 + 8)
    report("ef_search", "src/repro_torch/csrc/ef_search.cu",
           "src/repro/kernels/ef_search/kernel.py:119",
           mism, err, ms, plain_ms, nbytes,
           f"{len(rows):,} cursors on all {len(ef_blocks):,} EF tiles")
    torch.cuda.synchronize()
    return rows_out


def check_ptx(build) -> None:
    """Phase 2: the f32 BM25 contract survives compilation -- no FMA
    contraction, no approximate division in the PTX of its libraries."""
    for name in F32_LIBS:
        text = build.ptx(name)
        found = [w for w in PTX_FORBIDDEN if w in text]
        if found:
            fail(f"PTX of csrc/{name}.cu holds {found}: the f32 contract "
                 "would drift off the reference")
        print(f"[chip_smoke] PTX of {name}: no {' / '.join(PTX_FORBIDDEN)}; "
              f"{text.count('div.rn.f32')} div.rn.f32", flush=True)


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
    """Phase 4; returns (the serve summary, the mirror engine, the
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


def check_ranked_kernels(torch, rres, launches, card):
    """Phase 5, the ranked kernels: each against its plain version at the
    ranked path's largest launch shapes; returns their rows of the
    ``kernels`` line."""
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

    def report(*args):
        rows_out.append(kernel_row(launches, card, *args))

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
    plain_ms = event_ms(lambda: pref.pivot_select_ref(*args_s), 2)
    uc = len(np.unique(crow))
    report("pivot_select", "src/repro_torch/csrc/blockmax_pivot.cu",
           "src/repro/kernels/blockmax_pivot/kernel.py:107", mism, err, ms,
           plain_ms, uc * (512 + 4) + n * (4 + 512 + 512 + 12),
           f"{n:,} cursors on {uc:,} of {len(pc.nblk):,} chunks, "
           f"{int(want[1].sum()):,} blocks kept")

    # -- pivot_score: one PIVOT_SCORE_BUCKET launch --------------------------
    n = engine.PIVOT_SCORE_BUCKET
    args_f = (pcd.qb, pcd.nblk, pcd.base, t_qmin[:n], t_crow[:n], *side,
              k1p1)
    got = sk.pivot_score(*args_f)
    want = sref.pivot_score_ref(*args_f)
    mism, err = compare(got[:4], want[:4])
    m2, err2 = compare_f32(got[4], want[4])
    ms = event_ms(lambda: sk.pivot_score(*args_f), 20)
    plain_ms = event_ms(lambda: sref.pivot_score_ref(*args_f), 2)
    slot_rows = sref.slot_rows(pcd.base, t_crow[:n], want[0], nb)
    us = len(torch.unique(slot_rows))
    uc = len(np.unique(crow[:n]))
    nbytes = (uc * (512 + 4 + 4) + n * (4 + 512 + 512 + 12 + 16 * 512)
              + us * (512 + 512 + 128 + 4) + side_bytes)
    report("pivot_score", "src/repro_torch/csrc/pivot_score.cu",
           "src/repro/kernels/pivot_score/kernel.py:64", mism + m2,
           max(err, err2), ms, plain_ms, nbytes,
           f"{n:,} cursors, {16 * n:,} slots on {us:,} blocks")
    torch.cuda.synchronize()
    return rows_out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-lists", type=int, default=N_LISTS,
                    help="corpus depth of the boolean path; the full-size "
                         "run has 256 lists (the ranked path always does)")
    ap.add_argument("--ranked-queries", type=int, default=RANKED_QUERIES,
                    help="queries served by the ranked path (512)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

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
    from repro_torch.kernels.bm25_score import kernel as bk
    from repro_torch.kernels.ef_search import kernel as efk
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
    check_ptx(_build)

    # 3. the boolean path, counted
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

    profile_batches(torch, res["engine"].intersect_batch, res["queries"],
                    card, "boolean")

    # 4. the ranked path, counted
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
    profile_batches(torch, lambda b: reng.topk_batch(b, TOPK),
                    rres["queries"], card, "ranked")

    # 5. each kernel against its plain version
    kernels = check_kernels(torch, res, ef_engine, launches, card)
    kernels += check_ranked_kernels(torch, rres, rlaunches, card)
    if len(kernels) != 7:
        fail(f"the kernels line has {len(kernels)} rows, not 7")
    print(f"[chip_smoke] all phases passed in "
          f"{time.perf_counter()-t_start:.1f}s", flush=True)

    # 6. the kernels line, then the result line
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
