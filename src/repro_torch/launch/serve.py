"""Index serving: the paper's own application as a batched query service.

  PYTHONPATH=src python -m repro_torch.launch.serve --n-lists 64 --queries 512
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --compare-scalar
  PYTHONPATH=src python -m repro_torch.launch.serve --ranked --topk 10

Counterpart of the boolean-AND and ranked paths of
``repro/launch/serve.py``.  Builds
an optimally-partitioned index over a synthetic clustered corpus,
transcodes it into the block arena, uploads the arena to the card, then
serves boolean-AND queries through the batched
``repro_torch.core.query_engine.QueryEngine``: the fused pipeline (one
locate searchsorted + the ``decode_search`` / ``ef_search`` kernels)
resident on the device; ``--no-fused`` selects the partition-LRU engine.
Reports space against the un-partitioned baseline, throughput and
per-batch latency percentiles.  ``--compare-scalar`` also times the
per-query NextGEQ loop and verifies the batched results against it.

The engine runs on the card (``--device cuda``, the default) and refuses
to start without one; ``--device cpu`` runs the plain PyTorch versions of
the kernels instead.  ``--backend numpy`` serves from the host mirror.
``--codec {auto,svb,ef}`` selects the arena codec policy; ``--config
FILE`` loads an ``EngineConfig`` JSON whose fields explicit flags override.

``--ranked`` serves exact BM25 top-k (``--topk``) instead, through
``repro_torch.ranked.topk_engine.TopKEngine`` over the freq-carrying arena
(``--resident {auto,mirror,kernel}``); ``--compare-scalar`` then checks
every result against the exhaustive oracle ``exhaustive_topk``.  Sharded,
fault-injected and looped serving come with later slices.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import obs
from ..api import (
    EngineConfig,
    make_query_engine,
    make_topk_engine,
    resolve_backend,
    resolve_device,
)
from ..core import build_partitioned_index, build_unpartitioned_index
from ..data.postings import make_corpus, make_freqs, make_queries

_percentile = obs.Histogram.percentile_of


def _latency_line(lat: list[float], per_q: list[float]) -> str:
    return (f"p50 {_percentile(lat, 50)*1e3:.2f} ms  "
            f"p90 {_percentile(lat, 90)*1e3:.2f} ms  "
            f"p99 {_percentile(lat, 99)*1e3:.2f} ms  "
            f"p99.9 {_percentile(lat, 99.9)*1e3:.2f} ms  "
            f"(per-query p50 {_percentile(per_q, 50)*1e3:.3f} ms)")


def serve_batches(engine, queries: list[list[int]], batch: int):
    """Run all queries through the engine in batches; returns (results,
    per-batch wall latencies in seconds).  Each batch ends in its host
    fetch, so a latency covers the device work of the batch."""
    results: list[np.ndarray] = []
    latencies: list[float] = []
    for i in range(0, len(queries), batch):
        chunk = queries[i : i + batch]
        with obs.timer("serve_batch_ms", path="boolean_and") as t:
            results.extend(engine.intersect_batch(chunk))
        latencies.append(t.elapsed_s)
    return results, latencies


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--n-lists", type=int, default=64)
    ap.add_argument("--min-len", type=int, default=1_000)
    ap.add_argument("--max-len", type=int, default=100_000)
    ap.add_argument("--queries", type=int, default=512)
    ap.add_argument("--arity", type=int, default=2)
    ap.add_argument("--batch", type=int, default=64)
    # engine flags default to None so a --config file is not clobbered by
    # argparse defaults: EngineConfig.from_args only overrides fields the
    # caller actually set
    ap.add_argument("--backend", default=None,
                    choices=["auto", "torch", "numpy"],
                    help="'torch' (= 'auto') serves from the arena resident "
                         "on --device; 'numpy' from the host mirror")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="torch device of the engine (default cuda; there "
                         "is no silent fallback to the CPU)")
    ap.add_argument("--no-fused", dest="fused", action="store_false",
                    default=None,
                    help="serve through the partition-LRU engine instead "
                         "of the fused device pipeline")
    ap.add_argument("--codec", default=None, choices=["auto", "svb", "ef"],
                    help="arena codec policy: 'auto' lets the partitioner "
                         "pick VByte/Elias-Fano/bitvector per partition by "
                         "encoded size, 'svb' keeps the VByte/bitvector "
                         "arena, 'ef' prefers Elias-Fano wherever a block "
                         "is eligible")
    ap.add_argument("--ranked", action="store_true",
                    help="serve exact BM25 top-k over the freq-carrying "
                         "arena instead of boolean AND")
    ap.add_argument("--topk", type=int, default=10,
                    help="results per ranked query")
    ap.add_argument("--resident", default=None,
                    choices=["auto", "mirror", "kernel"],
                    help="ranked residency: 'mirror' scores the arena once "
                         "into a host impact mirror, 'kernel' keeps only "
                         "compressed blocks and bound tiles on the device "
                         "and prunes there; 'auto' picks 'kernel' on a card")
    ap.add_argument("--config", default=None, metavar="PATH",
                    help="EngineConfig JSON file supplying the engine "
                         "options; explicit flags override its fields")
    ap.add_argument("--compare-scalar", action="store_true",
                    help="also time the per-query NextGEQ loop (the "
                         "exhaustive BM25 oracle with --ranked) and verify "
                         "the batched results against it")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    args = build_parser().parse_args(argv)
    args.cfg = EngineConfig.from_args(args)
    return args


def run(args) -> dict:
    """The boolean-AND serving path; returns what it built and measured.

    Keys: ``index``, ``engine``, ``queries``, ``results``, ``n_postings``,
    ``build_s``, ``bpi``, ``arena_device_bytes`` (None off the device
    backend), ``qps``, ``batch_p50_s``, ``batch_p99_s``.
    """
    cfg = args.cfg
    if resolve_backend(cfg.backend) == "torch":
        try:
            resolve_device(cfg.device)  # fail before the corpus is built
        except RuntimeError as e:
            raise SystemExit(f"[serve] {e}") from None
    rng = np.random.default_rng(args.seed)
    t0 = obs.now()
    corpus = make_corpus(
        rng, n_lists=args.n_lists, min_len=args.min_len, max_len=args.max_len
    )
    n_postings = sum(len(l) for l in corpus)
    print(f"[serve] corpus: {args.n_lists} lists, {n_postings:,} postings "
          f"({obs.now()-t0:.1f}s)")
    if args.ranked:
        return run_ranked(args, rng, corpus, n_postings)

    t0 = obs.now()
    idx = build_partitioned_index(corpus, "optimal", codecs=cfg.codec_policy)
    t_build = obs.now() - t0
    base = build_unpartitioned_index(corpus)
    print(f"[serve] space: optimal {idx.bits_per_int():.2f} bpi vs "
          f"un-partitioned {base.bits_per_int():.2f} bpi "
          f"({base.bits_per_int()/idx.bits_per_int():.2f}x); "
          f"build {t_build:.1f}s, {n_postings/max(t_build,1e-9)/1e6:.2f} M ints/s")

    queries = [
        [int(t) for t in q]
        for q in make_queries(rng, args.n_lists, args.queries, args.arity)
    ]
    t0 = obs.now()
    engine = make_query_engine(idx, cfg)
    dev_bytes = None
    if engine.device is not None:
        dev_bytes = engine.arena.device_nbytes(engine.device)
    t_arena = obs.now() - t0
    a = engine.arena
    print(f"[serve] arena ({cfg.codec_policy}): {a.n_blocks:,} blocks, "
          f"{a.nbytes()/1e6:.1f} MB host"
          + (f", {dev_bytes/1e6:.1f} MB on {engine.device}"
             if dev_bytes is not None else "")
          + f" ({t_arena:.1f}s)")
    # warm-up batch: first kernel build and launch, flat mirror / LRU fill
    engine.intersect_batch(queries[: args.batch])

    t0 = obs.now()
    results, lat = serve_batches(engine, queries, args.batch)
    wall = obs.now() - t0
    n_results = sum(r.size for r in results)
    sizes = [len(queries[i : i + args.batch])
             for i in range(0, len(queries), args.batch)]
    per_q = [l / max(s, 1) for l, s in zip(lat, sizes)]
    path = "fused" if engine.fused else "partition-lru"
    where = engine.device if engine.device is not None else "host"
    print(f"[serve] batched AND ({engine.backend}/{path} on {where}, "
          f"batch={args.batch}): {len(queries)/wall:,.0f} q/s, "
          f"{wall/len(queries)*1e3:.3f} ms/query avg, "
          f"{n_results:,} results total")
    print(f"[serve] batch latency: {_latency_line(lat, per_q)}")
    print(f"[serve] engine stats: {dict(engine.stats)}")

    if args.compare_scalar:
        n_check = min(len(queries), 128)
        t0 = obs.now()
        scalar = [idx.intersect_scalar(q) for q in queries[:n_check]]
        dt = obs.now() - t0
        for q, got, want in zip(queries[:n_check], results[:n_check], scalar):
            assert np.array_equal(got, want), f"mismatch on query {q}"
        speedup = (dt / n_check) / (wall / len(queries))
        print(f"[serve] scalar loop: {dt/n_check*1e3:.2f} ms/query over "
              f"{n_check} queries -> batched speedup {speedup:.1f}x, "
              f"results identical")
    return {
        "index": idx,
        "engine": engine,
        "queries": queries,
        "results": results,
        "n_postings": n_postings,
        "build_s": t_build,
        "bpi": idx.bits_per_int(),
        "arena_device_bytes": dev_bytes,
        "qps": len(queries) / wall,
        "batch_p50_s": _percentile(lat, 50),
        "batch_p99_s": _percentile(lat, 99),
    }


def run_ranked(args, rng, corpus, n_postings: int) -> dict:
    """The ``--ranked`` path: batched BM25 top-k over the freq arena.

    Keys: ``index``, ``engine``, ``queries``, ``results``, ``n_postings``,
    ``freqs_s`` (the tf generator), ``build_s`` (index + arena with its
    ranked sidecar), ``bpi``, ``arena_device_bytes`` (None off the device
    backend), ``qps``, ``batch_p50_s``, ``batch_p99_s``, ``oracle_s`` (per
    query, None without ``--compare-scalar``).
    """
    from ..ranked.bm25 import exhaustive_topk

    cfg = args.cfg
    t0 = obs.now()
    freqs = make_freqs(rng, corpus)
    t_freqs = obs.now() - t0
    t0 = obs.now()
    idx = build_partitioned_index(
        corpus, "optimal", freqs=freqs, codecs=cfg.codec_policy
    )
    # includes the freq transcode + block-max sidecar
    arena = idx.arena_for(cfg.codec_policy)
    t_build = obs.now() - t0
    print(f"[serve] ranked index: {idx.bits_per_int():.2f} bpi docIDs + "
          f"{idx.freq_payload.size * 8 / max(int(idx.list_sizes.sum()), 1):.2f} "
          f"bpi freqs; arena {arena.nbytes() / 1e6:.1f} MB "
          f"(freqs {t_freqs:.1f}s, build {t_build:.1f}s)")

    queries = [
        [int(t) for t in q]
        for q in make_queries(rng, args.n_lists, args.queries, args.arity)
    ]
    engine = make_topk_engine(idx, cfg)
    dev_bytes = None
    if engine.device is not None:
        dev_bytes = arena.device_nbytes(engine.device)
    where = engine.device if engine.device is not None else "host"
    print(f"[serve] ranked arena ({cfg.codec_policy}): {arena.n_blocks:,} "
          f"blocks" + (f", {dev_bytes/1e6:.1f} MB on {where}"
                       if dev_bytes is not None else ""))
    t0 = obs.now()
    engine.topk_batch(queries[: args.batch], args.topk)  # warm mirror + cache
    print(f"[serve] warm-up batch: {obs.now()-t0:.1f}s (flat mirror"
          + (", impact mirror" if engine.resident == "mirror" else "") + ")")

    t0 = obs.now()
    results, lat = [], []
    for i in range(0, len(queries), args.batch):
        with obs.timer("serve_batch_ms", path="ranked") as bt:
            results.extend(
                engine.topk_batch(queries[i : i + args.batch], args.topk)
            )
        lat.append(bt.elapsed_s)
    wall = obs.now() - t0
    sizes = [len(queries[i : i + args.batch])
             for i in range(0, len(queries), args.batch)]
    per_q = [l / max(s, 1) for l, s in zip(lat, sizes)]
    print(f"[serve] ranked top-{args.topk} ({engine.backend}/"
          f"{engine.resident} on {where}, batch={args.batch}): "
          f"{len(queries)/wall:,.0f} q/s, "
          f"{wall/len(queries)*1e3:.3f} ms/query avg")
    print(f"[serve] batch latency: {_latency_line(lat, per_q)}")
    print(f"[serve] engine stats: {dict(engine.stats)}")

    oracle_s = None
    if args.compare_scalar:
        n_check = min(len(queries), 64)
        t0 = obs.now()
        want = exhaustive_topk(idx, queries[:n_check], args.topk)
        dt = obs.now() - t0
        for q, (gd, gs), (wd, ws) in zip(queries, results, want):
            assert np.array_equal(gd, wd) and np.array_equal(gs, ws), (
                f"top-k mismatch on query {q}"
            )
        oracle_s = dt / n_check
        speedup = oracle_s / (wall / len(queries))
        print(f"[serve] exhaustive oracle: {dt/n_check*1e3:.2f} ms/query "
              f"over {n_check} queries -> block-max speedup {speedup:.1f}x, "
              f"identical top-k")
    return {
        "index": idx,
        "engine": engine,
        "queries": queries,
        "results": results,
        "n_postings": n_postings,
        "freqs_s": t_freqs,
        "build_s": t_build,
        "bpi": idx.bits_per_int(),
        "arena_device_bytes": dev_bytes,
        "qps": len(queries) / wall,
        "batch_p50_s": _percentile(lat, 50),
        "batch_p99_s": _percentile(lat, 99),
        "oracle_s": oracle_s,
    }


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
