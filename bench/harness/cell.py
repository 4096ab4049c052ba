"""One run of one cell: make the inputs, build the system under test, warm
it up, measure one window, check every answer against the plain
reference, and return the result line.

The system under test is ``repro_torch`` (the PyTorch and CUDA port):
``build_partitioned_index`` and its arena, and the boolean
(``QueryEngine``) or ranked (``TopKEngine``) engine a configuration's
``engine`` section describes.  The harness hands it the generated lists,
frequencies and queries and nothing else; the reference gets the same.
"""

from __future__ import annotations

import contextlib
import gc
import os
import subprocess
import sys
import time

import numpy as np

from . import drivers, gen, peaks, spec
from .trace import Probes, traced

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules (``sys.modules`` by default) whose top-level name
    (before the first dot) is one of ``FORBIDDEN``, compared whole
    (``repro_torch`` is not ``repro``)."""
    names = list(sys.modules if modules is None else modules)
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


class Context:
    """What a per-layer metric's reader may read: the window, its trace,
    the probed kernel calls, the set-up's facts, the card's memory rate."""

    def __init__(self, window, trace, probes, facts, hbm_bytes_per_s):
        self.window = window
        self.trace = trace
        self.probes = probes
        self.facts = facts
        self.hbm_bytes_per_s = hbm_bytes_per_s


def engine_config(cfg: dict, device):
    """The ``EngineConfig`` of a configuration's ``engine`` section;
    ``"shard_mesh": "one_card"`` puts every shard on ``device``."""
    import torch

    from repro_torch.api import EngineConfig

    e = dict(cfg["engine"])
    if e.get("shard_mesh") == "one_card":
        e["shard_mesh"] = [torch.device(device)] * e["shards"]
    return EngineConfig(device=str(device), **e)


def build(cfg: dict, lists, freqs, device, sync) -> tuple:
    """(index, seconds): the index over ``lists`` with its arena, and
    unsharded the arena's upload to ``device``.  ``"partitioner":
    "scan"`` partitions each list by the program's scan on ``device``
    (``optimal_partitioning_via_scan``: the endpoints of ``"optimal"``);
    any other name is ``build_partitioned_index``'s strategy."""
    from repro_torch.core import build_partitioned_index

    e = cfg["engine"]
    how: dict = {"strategy": cfg["partitioner"]}
    if cfg["partitioner"] == "scan":
        from repro_torch.core.partition import optimal_partitioning_via_scan

        how = {"partitioner": lambda gaps: optimal_partitioning_via_scan(
            gaps, device=device)}
    t0 = time.perf_counter()
    idx = build_partitioned_index(lists, freqs=freqs,
                                  codecs=e["codec_policy"], **how)
    arena = idx.arena_for(e["codec_policy"])
    if e.get("shards") is None:
        arena.on(device)
    sync()
    return idx, time.perf_counter() - t0


def prebuild_kernels() -> None:
    """Compile every CUDA source of the program at once (each ``nvcc`` in
    parallel; a checkout's first run only), in set-up, so that no kernel a
    window reaches for the first time compiles inside it."""
    from repro_torch.kernels import _build

    _build.build_all(sorted(f[:-3] for f in os.listdir(_build.CSRC)
                            if f.endswith(".cu")))


def make_engine(op: str, idx, ecfg):
    from repro_torch.api import make_query_engine, make_topk_engine

    return make_query_engine(idx, ecfg) if op == "and" else make_topk_engine(
        idx, ecfg)


def reference(op: str, k, lists, freqs, device, control: bool = False):
    """The plain reference as a function of a query; with ``control``, the
    cell's control (the top-k in bfloat16, the AND decided by bucket)."""
    from bench.reference import search

    corpus = search.Corpus(lists, device)
    if op == "and":
        if control:
            return lambda q: search.intersect_coarse(corpus, q)
        return lambda q: search.intersect(corpus, q)
    scores = search.Scores(corpus, freqs,
                           "bfloat16" if control else np.float32)
    return lambda q: scores.topk(q, k)


def same(op: str, got, want) -> bool:
    """An AND answer holds the same docIDs; a top-k answer the same docIDs
    and the same f64 scores, in the same order."""
    if op == "and":
        return np.array_equal(np.asarray(got), want)
    return (np.array_equal(np.asarray(got[0]), want[0])
            and np.array_equal(np.asarray(got[1], np.float64), want[1]))


def count_wrong(op: str, qidx, answers, pool, answer_of) -> int:
    """Answers that differ from ``answer_of`` (each query asked once)."""
    want: dict = {}
    wrong = 0
    for i, got in zip(qidx, answers):
        if i not in want:
            want[i] = answer_of(pool[i])
        wrong += not same(op, got, want[i])
    return wrong


def check(op: str, k, window, lists, freqs, pool, device) -> dict:
    """Every answer of the window against the plain reference: the numbers
    compared, each beside its limit."""
    wrong = count_wrong(op, window.qidx, window.answers, pool,
                        reference(op, k, lists, freqs, device))
    unanswered = window.attempted - len(window.answers) + window.unanswered
    return {
        "wrong_answers": {"value": wrong, "limit": 0},
        "unanswered": {"value": unanswered, "limit": 0},
    }


def passed(checks: dict, attempted: int) -> bool:
    """Every number within its limit, on a window that sent queries."""
    return attempted > 0 and all(c["value"] <= c["limit"]
                                 for c in checks.values())


def host_speed() -> float:
    """Seconds of a fixed piece of host work (a Python loop and a numpy
    sort of a fixed array): how fast this process's CPU runs now."""
    t0 = time.perf_counter()
    x = 0
    for i in range(300_000):
        x += i * i % 7
    np.sort(np.random.default_rng(0).integers(0, 1 << 40, 2_000_000))
    return time.perf_counter() - t0


def power_limit() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_start: float, root: str = spec.ROOT, device: str = "cuda",
             log=sys.stderr) -> dict:
    """One run of cell ``name``; returns the result line's object (its
    last key, ``checks``, holds each number compared and its limit)."""
    import torch

    def say(msg):
        print(f"[bench] {msg}", file=log, flush=True)

    bm = spec.load(root)
    cell = spec.workload(bm, name)
    cfg = spec.config(bm, cell["config"], root)
    mix = spec.traffic(cell["traffic"], root)
    code = spec.traffic_code(cell["traffic"], root)
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    from repro_torch import obs

    obs.enable(False)

    host_s = [host_speed()]
    # -- inputs, from the seed --------------------------------------------
    t0 = time.perf_counter()
    lists, freqs = gen.make_inputs(seed, cfg, dev)
    n_post = int(sum(len(x) for x in lists))
    n_lists = len(lists)
    unit = mix.get("batch") or mix["max_batch"]
    if hasattr(code, "pool"):
        pool = code.pool(seed, cfg, mix)
    else:
        pool = gen.query_pool(seed, cfg, mix["pool"], mix["arity"])
    warm = gen.warm_pool(seed, n_lists, mix["warmup"] * unit, mix["arity"])
    t_inputs = time.perf_counter() - t0
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev) if on_card else 0
    span = sum(int(x[-1]) - int(x[0]) for x in lists)
    say(f"{name} seed {seed}: {n_lists} lists, {n_post:,} postings, mean "
        f"gap {span / max(n_post - n_lists, 1):.4f}, docIDs from "
        f"{min(int(x[0]) for x in lists):,} to "
        f"{max(int(x[-1]) for x in lists):,}; inputs {t_inputs:.1f}s; "
        f"host work {host_s[0]:.3f}s, {torch.get_num_threads()} threads, "
        f"{len(os.sched_getaffinity(0))} CPUs")

    # -- the system under test ----------------------------------------------
    if on_card:
        prebuild_kernels()
    idx, build_s = build(cfg, lists, freqs, dev, sync)
    bits = idx.bits_per_int()
    engine = make_engine(mix["op"], idx, engine_config(cfg, dev))
    say(f"index {build_s:.1f}s, {bits:.4f} bits/posting")

    readers = {}
    if trace:
        readers = {m["name"]: spec.reader(m["name"], root)
                   for m in spec.metrics_of(bm, name, "per_layer")}
    wanted: dict = {}
    for r in readers.values():
        for fn, mods in getattr(r, "PROBES", {}).items():
            wanted.setdefault(fn, [])
            wanted[fn] += [m for m in mods if m not in wanted[fn]]
    probes = Probes(wanted)
    marks: dict = {}

    @contextlib.contextmanager
    def around():
        sync()
        marks["setup_s"] = time.perf_counter() - t_start
        marks["held"] = (torch.cuda.memory_allocated(dev) - base
                         if on_card else 0)
        if not trace:
            yield
            sync()
            return
        probes.install()
        try:
            with traced(dev) as box:
                yield
            marks["trace"] = box["trace"]
        finally:
            probes.restore()

    serve = code.serve if hasattr(code, "serve") else drivers.serve
    window = serve(engine, mix, pool, warm, seconds, seed, around)
    host_s.append(host_speed())
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    say(f"window {window.seconds:.2f}s: {len(window.answers)} answers of "
        f"{window.attempted}, {window.units} engine calls; set-up "
        f"{marks['setup_s']:.1f}s; host work {host_s[1]:.3f}s; answers "
        f"came at intervals (s) "
        f"{[round(u, 3) for u in window.unit_seconds()]}")

    metrics: dict = {}
    units = {m["name"]: m["unit"] for m in bm["end_to_end"] + bm["per_layer"]}
    if trace:
        tr = marks.get("trace")
        ctx = Context(window, tr, dict(probes.calls),
                      {"index_build_s": build_s, "bits_per_posting": bits},
                      peaks.hbm_bytes_per_s(kind))
        for mname, r in readers.items():
            v = r.read(ctx)
            if v is not None:
                metrics[mname] = {"value": float(v), "unit": units[mname]}

    device_info = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                   "count": cell["chips"], "memory_peak_bytes": int(peak)}
    out = {"correct": False, "attempted": window.attempted, "failed": 0,
           "metrics": metrics, "device": device_info}
    if trace and marks.get("trace") is not None:
        tr = marks["trace"]
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.device_ops(10),
                            "idle_gaps": tr.idle_gaps(10)}
    if on_card:
        device_info["power"] = power_limit()

    # -- free the program's state, then the reference ----------------------
    probes.calls.clear()
    del engine, idx, probes, readers
    marks.pop("trace", None)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    checks = check(mix["op"], mix.get("k"), window, lists, freqs, pool, dev)
    say(f"reference {time.perf_counter() - t0:.1f}s")
    out["correct"] = passed(checks, window.attempted)
    out["failed"] = (checks["wrong_answers"]["value"]
                     + checks["unanswered"]["value"])
    if not trace:
        right = len(window.answers) - checks["wrong_answers"]["value"]
        e2e = {
            "setup_s": marks["setup_s"],
            "qps": right / window.seconds,
            "device_bytes_per_posting": (marks["held"] / n_post
                                         if on_card else None),
        }
        for m in spec.metrics_of(bm, name, "end_to_end"):
            if e2e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                      "unit": m["unit"]}
    out["checks"] = checks
    return out
