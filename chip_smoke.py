#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py                 # the full-size run
    python3 chip_smoke.py --n-lists 16    # a shallower corpus, same shapes

Run from the root of a checkout, on a machine with a CUDA card.  Phases:

1. card      -- ``nvidia-smi`` name and power limit;
2. build     -- compile every CUDA source of ``src/repro_torch/csrc`` with
   ``nvcc`` (one process each, all started together);
3. main path -- ``repro_torch.launch.serve`` over the full-size corpus
   (``--n-lists 256 --min-len 10000 --max-len 2000000 --seed 0 --codec
   auto``: 104.55 M postings), then a few batches through an engine over
   the ``ef`` arena of the SAME index, with every kernel's launch count set
   to 0 just before and read just after; the batched answers are checked
   against the port's scalar NextGEQ loop, and two batches are traced with
   ``torch.profiler`` (device time per kernel against the wall time);
4. kernels   -- each kernel against its plain PyTorch version on the card,
   at the main path's shapes, over the arenas the main path built (integer
   contracts: zero mismatches allowed), timed with CUDA events beside its
   bound (bytes moved over the card's memory rate);
5. the ``kernels`` JSON line, then the result line.

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


def chunked(plain, n: int, *args, per_cursor=()):
    """Run a plain version over ``n`` cursors in chunks (its intermediates
    are ~10 KB per cursor); ``per_cursor`` names the positional args that
    are sliced, the rest are passed whole."""
    import torch

    outs = []
    for s in range(0, n, PLAIN_CHUNK):
        a = [x[s : s + PLAIN_CHUNK] if i in per_cursor else x
             for i, x in enumerate(args)]
        outs.append(plain(*a))
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


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


def profile_batches(torch, engine, queries, card) -> None:
    """Where a batch's time goes: device time per kernel from
    ``torch.profiler`` against the wall time, and the host spans of
    ``repro_torch.obs``, over PROFILE_BATCHES batches."""
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
            engine.intersect_batch(b)
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
    print(f"[chip_smoke] profile over {len(batches)} batches: wall "
          f"{wall_ms:.1f} ms, device busy {busy:.2f} ms "
          f"({busy / wall_ms:.2%}), idle {1 - busy / wall_ms:.2%} [{card}]")
    print(f"[chip_smoke] profile device ms by name: "
          f"{json.dumps({k: round(v, 4) for k, v in top.items()})}")
    print(f"[chip_smoke] profile host span ms: "
          f"{json.dumps({k: round(v, 1) for k, v in spans.items()})}", flush=True)


def check_kernels(torch, res, ef_engine, launches, card):
    """Phase 4: each kernel against its plain version; returns the rows of
    the ``kernels`` line."""
    from repro_torch.core.arena import CODEC_EF
    from repro_torch.kernels.ef_search import kernel as efk
    from repro_torch.kernels.ef_search import ref as efref
    from repro_torch.kernels.vbyte_decode import kernel as vk
    from repro_torch.kernels.vbyte_decode import ref as vref

    rng = np.random.default_rng(1)
    cuda = torch.device(DEVICE)
    rows_out = []

    def report(name, src, replaces, mism, err, ms, plain_ms, nbytes, what):
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        print(f"[chip_smoke] {name}: {what}: {mism} mismatches, kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({nbytes/1e6:.1f} MB at {HBM_BYTES_PER_S/1e12:.2f} TB/s) "
              f"[{card}]", flush=True)
        if mism:
            fail(f"{name}: {mism} mismatches against its plain version")
        rows_out.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "launches_main_path": launches[name],
            "mismatches": mism, "max_abs_err": err, "ms": ms, "kernel_ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None,
        })

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-lists", type=int, default=N_LISTS,
                    help="corpus depth; the full-size run has 256 lists")
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
    from repro_torch.kernels.ef_search import kernel as efk
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
    reports = _build.build_all(["vbyte_decode", "ef_search"])
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[chip_smoke] ptxas {name}: {line.strip()}")
    print(f"[chip_smoke] kernels built in {time.perf_counter()-t0:.1f}s",
          flush=True)

    # 3. the main path, counted
    counters = {"decode_search": vk.decode_search,
                "decode_blocks": vk.decode_blocks,
                "ef_search": efk.ef_search}
    res, ef_engine, launches = run_main_path(args.n_lists, torch, serve,
                                             counters, QueryEngine)
    if args.n_lists != N_LISTS:
        print(f"[chip_smoke] depth cut: --n-lists {args.n_lists} instead of "
              f"{N_LISTS}", flush=True)
    summary = {
        "n_lists": args.n_lists, "postings": res["n_postings"],
        "build_s": res["build_s"], "bits_per_int": res["bpi"],
        "arena_device_bytes": res["arena_device_bytes"], "qps": res["qps"],
        "batch_p50_ms": res["batch_p50_s"] * 1e3,
        "batch_p99_ms": res["batch_p99_s"] * 1e3, "card": card,
    }
    print(f"[chip_smoke] main path: {json.dumps(summary)}", flush=True)

    profile_batches(torch, res["engine"], res["queries"], card)

    # 4. each kernel against its plain version
    kernels = check_kernels(torch, res, ef_engine, launches, card)
    print(f"[chip_smoke] all phases passed in "
          f"{time.perf_counter()-t_start:.1f}s", flush=True)

    # 5. the kernels line, then the result line
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
