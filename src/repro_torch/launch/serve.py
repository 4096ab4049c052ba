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
every result against the exhaustive oracle ``exhaustive_topk``.

``--loop`` (requires ``--ranked``) serves through the CONTINUOUS-BATCHING
async engine instead of fixed batches (``repro_torch.serving``): requests
arrive on an asyncio loop at ``--offered-qps`` (Poisson) for
``--duration`` seconds, a deadline-aware batch former coalesces them into
pow2-bucketed waves (``--batch`` caps the wave, ``--max-delay-ms`` bounds
the linger, ``--deadline-ms`` sets the per-request SLO, ``--max-queue``
the backpressure bound), and the report adds sustained q/s, wave
occupancy, deadline misses and end-to-end latency p50/p99/p99.9.
``--metrics-port`` serves the armed obs registry over HTTP and
``--metrics-dump`` writes its JSON snapshot at exit, on either path.

``--shards N`` list-hash-partitions the arena into N shards and routes
every cursor batch per shard: one dispatch over a device per shard when
the process sees N cards, a host-side loop of per-shard engines on
``--device`` otherwise (the banner says which).  Results are identical to
unsharded serving -- the merge is a pure scatter at the result boundary.
``--replicas R`` places every list on R shards, and ``--faults`` /
``--fault-prob`` inject shard deaths at the dispatch boundary: serving
then runs through ``ResilientEngine`` -- retry with backoff, replica
failover, degradation to live lists -- and reports availability,
failures, failovers and recoveries.  ``--recover`` checkpoints the arena
up front so DEAD shards restore from it and re-admit.
``--compare-scalar`` is skipped after faults: degraded batches are not
held to the oracle.
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


def _print_shard_layout(engine) -> None:
    sa = engine.sharded
    if sa is None:
        return
    sizes = [len(f) for f in sa.lists_of]
    mode = (
        f"shard_map over {len(sa.mesh)} devices"
        if sa.mesh is not None else "host loop (too few devices for a mesh)"
    )
    # sizes from ROUTING METADATA only: forcing sa.shards here would
    # materialize the per-shard arena slices even on the numpy backend,
    # which never routes
    lbo = engine.arena.list_blk_offsets
    blocks = [int((lbo[f + 1] - lbo[f]).sum()) for f in sa.lists_of]
    per_blk = engine.arena.nbytes() / max(engine.arena.n_blocks, 1)
    print(f"[serve] shards: {sa.n_shards} ({mode}); lists/shard {sizes}; "
          f"~MB/shard {[round(b * per_blk / 1e6, 1) for b in blocks]}")


def _make_resilient(args, engine):
    """Wrap the engine for fault-injected serving, or None without
    --faults/--fault-prob.  The checkpoint tempdir (with --recover) lives
    until ``_close_resilient`` at the end of serving -- real deployments
    point CheckpointManager at durable storage instead."""
    if not args.faults and args.fault_prob == 0.0:
        return None
    from ..distributed.resilient import ResilientEngine, ShardFaultInjector

    at = tuple(int(b) for b in args.faults.split(",")) if args.faults else ()
    injector = ShardFaultInjector(
        at_batches=at, probability=args.fault_prob, seed=args.seed,
        shards=tuple(range(args.cfg.shards)),
    )
    manager = None
    if args.recover:
        import tempfile

        from ..checkpoint import CheckpointManager

        manager = CheckpointManager(
            tempfile.mkdtemp(prefix="arena-ckpt-"), async_save=False
        )
    res = ResilientEngine(engine, injector=injector, manager=manager)
    if manager is not None:
        res.checkpoint()
    return res


def _close_resilient(res) -> None:
    """End fault-injected serving: join any background restore, then
    remove the --recover checkpoint tempdir."""
    if res is None or res.manager is None:
        return
    import shutil

    res.wait_recovered()
    res.manager.wait()
    shutil.rmtree(res.manager.dir, ignore_errors=True)


def serve_resilient(res, queries, batch: int, topk: int | None = None):
    """Serve all queries through a ResilientEngine; returns (results,
    latencies, n_degraded_queries)."""
    results: list = []
    lat: list[float] = []
    degraded_q = 0
    for i in range(0, len(queries), batch):
        chunk = queries[i : i + batch]
        with obs.timer("serve_batch_ms", path="resilient") as t:
            if topk is None:
                out, info = res.intersect_batch(chunk)
            else:
                out, info = res.topk_batch(chunk, topk)
        lat.append(t.elapsed_s)
        results.extend(out)
        if info.degraded:
            miss = set(info.missing_lists.tolist())
            degraded_q += sum(
                1 for q in chunk if any(int(t) in miss for t in q)
            )
    return results, lat, degraded_q


def _print_fault_summary(res, n_queries: int, degraded_q: int) -> dict:
    """Print the fault lines; returns them as a dict (``availability``,
    ``degraded_queries``, the stats counters, ``recovery_p99_s``,
    ``health``, and with a checkpoint its ``checkpoint_bytes``,
    ``checkpoint_s`` and ``restore_s``)."""
    stats = res.stats
    avail = (n_queries - degraded_q) / max(n_queries, 1)
    p99 = res.recovery_p99_s()
    rec = f"{p99 * 1e3:.1f} ms" if p99 == p99 else "n/a"
    print(f"[serve] faults: availability {avail:.4f} "
          f"({n_queries - degraded_q}/{n_queries} exact, "
          f"{degraded_q} degraded), failures {stats['failures']}, "
          f"retries {stats['retries']}, failovers {stats['failovers']}, "
          f"recoveries {stats['recoveries']} (p99 {rec})")
    print(f"[serve] shard health: {res.health}")
    out = {
        "availability": avail, "degraded_queries": degraded_q,
        **{k: v for k, v in stats.items() if k != "recovery_s"},
        "recovery_p99_s": p99, "health": list(res.health),
    }
    if res.checkpoint_bytes is not None:
        print(f"[serve] arena checkpoint: {res.checkpoint_bytes:,} B, save "
              f"{res.checkpoint_s:.3f}s, shard restores "
              f"{[round(t, 3) for t in res.restore_s]}s")
        out.update(checkpoint_bytes=res.checkpoint_bytes,
                   checkpoint_s=res.checkpoint_s,
                   restore_s=list(res.restore_s))
    return out


def _device_bytes(engine) -> dict:
    """Bytes the engine holds on its device(s): the arena, or with shards
    each shard's sub-arena (None off the device backend)."""
    if engine.device is None:
        return {"arena_device_bytes": None, "shard_device_bytes": None}
    if engine.sharded is not None:
        return {"arena_device_bytes": None,
                "shard_device_bytes": engine.sharded.shard_device_nbytes()}
    return {"arena_device_bytes": engine.arena.device_nbytes(engine.device),
            "shard_device_bytes": None}


def serve_loop(args, engine, queries) -> dict:
    """The --loop endpoint: open-loop Poisson arrivals through the
    continuous-batching ``AsyncTopKServer``.

    Arrivals are scheduled at absolute times (``t0`` plus cumulative
    exponential gaps), so a driver that falls behind sends the late
    arrivals at once instead of stretching the gaps, and each request's
    latency and queue wait run from its scheduled arrival: the driver's
    lag counts against the server, not in its favour.

    Returns the run's summary: ``offered_qps`` (the flag), ``arrived_qps``
    (arrivals over ``--duration``), ``sustained_qps``, ``wall_s``,
    ``arrivals``, ``served``, ``expired``, ``shed``, ``late``, ``p50_ms``,
    ``p99_ms``, ``p999_ms`` (request latency of the served),
    ``queue_wait_p50_ms``, ``driver_lag_p99_ms`` (scheduled arrival to
    submission), ``waves``, ``full_waves``, ``bucket_hits``,
    ``padded_queries`` and ``results``: ``(query index, ServeResult)`` of
    every served request, query index into ``queries``.
    """
    import asyncio

    from ..serving import AsyncTopKServer, QueueFull

    server = AsyncTopKServer(
        engine,
        k=args.topk,
        max_batch=args.batch,
        max_queue=args.max_queue,
        max_delay_s=args.max_delay_ms / 1e3,
        default_deadline_s=(
            args.deadline_ms / 1e3 if args.deadline_ms else float("inf")
        ),
    )

    async def drive():
        rng = np.random.default_rng(args.seed + 1)
        results: list = []  # (query index, ServeResult, driver lag s)
        t0 = obs.now()

        async def client(i, t_arrive):
            lag = obs.now() - t_arrive
            try:
                results.append((i, await server.try_submit(queries[i]), lag))
            except QueueFull:
                pass  # counted in server.stats["shed"]

        async with server:
            tasks = []
            end = t0 + args.duration
            t_next = t0
            while t_next < end:
                wait = t_next - obs.now()
                if wait > 0:
                    await asyncio.sleep(wait)
                tasks.append(asyncio.ensure_future(
                    client(len(tasks) % len(queries), t_next)
                ))
                # Poisson arrivals at the offered rate
                t_next += rng.exponential(1.0 / args.offered_qps)
            await asyncio.gather(*tasks)
        return results, len(tasks), obs.now() - t0

    results, arrivals, wall = asyncio.run(drive())
    ok = [(i, r, lag) for i, r, lag in results if not r.expired]
    lat = [lag + r.latency_s for _, r, lag in ok]
    waits = [lag + r.wait_s for _, r, lag in ok]
    lags = [lag for _, _, lag in results]
    st, fst = server.stats, server.former.stats
    arrived_qps = arrivals / args.duration
    print(f"[serve] loop: offered {args.offered_qps:,.0f} q/s for "
          f"{args.duration:.1f}s (arrived {arrived_qps:,.2f} q/s) -> "
          f"sustained {len(ok)/wall:,.0f} q/s "
          f"({len(ok)} served, {st['expired']} expired, {st['shed']} shed, "
          f"{st['late']} late)")
    if lat:
        print(f"[serve] loop latency: "
              f"p50 {_percentile(lat, 50)*1e3:.2f} ms  "
              f"p99 {_percentile(lat, 99)*1e3:.2f} ms  "
              f"p99.9 {_percentile(lat, 99.9)*1e3:.2f} ms  "
              f"(queue-wait p50 {_percentile(waits, 50)*1e3:.3f} ms, "
              f"from scheduled arrival)")
    waves = max(fst["waves"], 1)
    print(f"[serve] loop waves: {fst['waves']} "
          f"({fst['full_waves']} full, "
          f"occupancy {st['served']/(waves*args.batch):.2f}, "
          f"bucket reuse {fst['bucket_hits']}/{fst['waves']}, "
          f"{st['padded_queries']} padded)")
    print(f"[serve] engine stats: {dict(engine.stats)}")
    return {
        "offered_qps": args.offered_qps,
        "arrived_qps": arrived_qps,
        "sustained_qps": len(ok) / wall,
        "wall_s": wall,
        "arrivals": arrivals,
        "served": st["served"],
        "expired": st["expired"],
        "shed": st["shed"],
        "late": st["late"],
        "p50_ms": _percentile(lat, 50) * 1e3,
        "p99_ms": _percentile(lat, 99) * 1e3,
        "p999_ms": _percentile(lat, 99.9) * 1e3,
        "queue_wait_p50_ms": _percentile(waits, 50) * 1e3,
        "driver_lag_p99_ms": _percentile(lags, 99) * 1e3,
        "waves": fst["waves"],
        "full_waves": fst["full_waves"],
        "bucket_hits": fst["bucket_hits"],
        "padded_queries": st["padded_queries"],
        "results": [(i, r) for i, r, _ in ok],
    }


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
    ap.add_argument("--shards", type=int, default=None,
                    help="list-hash-partition the arena into N shards: one "
                         "dispatch over a card per shard when the process "
                         "sees N cards, a host-side shard loop otherwise")
    ap.add_argument("--replicas", type=int, default=None,
                    help="place every list on R shards; routing prefers "
                         "the primary, replicas carry its lists "
                         "bit-identically when it dies")
    ap.add_argument("--faults", default=None,
                    help="comma-separated batch indices at which a shard "
                         "dies (e.g. '2,5'); serves through the "
                         "ResilientEngine health state machine")
    ap.add_argument("--fault-prob", type=float, default=0.0,
                    help="per-batch shard-death probability (seeded by "
                         "--seed), instead of/alongside --faults")
    ap.add_argument("--recover", action="store_true",
                    help="checkpoint the arena up front (OptVB-packed "
                         "sidecars) and restore DEAD shards' sub-arenas "
                         "from it, re-admitting them")
    ap.add_argument("--compare-scalar", action="store_true",
                    help="also time the per-query NextGEQ loop (the "
                         "exhaustive BM25 oracle with --ranked) and verify "
                         "the batched results against it")
    ap.add_argument("--loop", action="store_true",
                    help="serve through the continuous-batching async "
                         "engine (repro_torch.serving, requires --ranked): "
                         "Poisson arrivals at --offered-qps for "
                         "--duration seconds, deadline-aware waves")
    ap.add_argument("--offered-qps", type=float, default=2_000.0,
                    help="open-loop arrival rate for --loop (Poisson)")
    ap.add_argument("--duration", type=float, default=5.0,
                    help="seconds of --loop arrivals before draining")
    ap.add_argument("--max-delay-ms", type=float, default=2.0,
                    help="batch-former linger: a partial wave fires after "
                         "this long (latency floor vs occupancy trade)")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request SLO for --loop; requests past it "
                         "are expired unserved (0 = no deadline)")
    ap.add_argument("--max-queue", type=int, default=1_024,
                    help="bounded request queue for --loop: admissions "
                         "beyond it shed (backpressure bound)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="arm the obs layer and serve the live metrics "
                         "registry over HTTP: /metrics (Prometheus text) "
                         "and /metrics.json (JSON snapshot); 0 binds an "
                         "ephemeral port")
    ap.add_argument("--metrics-dump", default=None, metavar="PATH",
                    help="arm the obs layer and write the JSON metrics "
                         "snapshot to PATH at exit")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    ap = build_parser()
    args = ap.parse_args(argv)
    args.cfg = EngineConfig.from_args(args)
    if args.cfg.shards is not None and not args.cfg.fused and not args.ranked:
        # the ranked engine has no fused= knob; only boolean-AND serving
        # needs the fused pipeline for sharding
        ap.error("--shards requires the fused engine (drop --no-fused)")
    if (args.faults or args.fault_prob) and args.cfg.shards is None:
        ap.error("--faults/--fault-prob require --shards")
    if args.loop and not args.ranked:
        ap.error("--loop serves ranked top-k; add --ranked")
    if args.loop and (args.faults or args.fault_prob):
        ap.error("--loop and fault injection are separate lanes; "
                 "drop --faults/--fault-prob")
    return args


def check_device(args) -> None:
    """Fail, before any corpus is built, when the torch backend's device
    is missing."""
    if resolve_backend(args.cfg.backend) == "torch":
        try:
            resolve_device(args.cfg.device)
        except RuntimeError as e:
            raise SystemExit(f"[serve] {e}") from None


def _corpus(args):
    """-> (the seeded generator, the corpus, its posting count)."""
    rng = np.random.default_rng(args.seed)
    t0 = obs.now()
    corpus = make_corpus(
        rng, n_lists=args.n_lists, min_len=args.min_len, max_len=args.max_len
    )
    n_postings = sum(len(l) for l in corpus)
    print(f"[serve] corpus: {args.n_lists} lists, {n_postings:,} postings "
          f"({obs.now()-t0:.1f}s)")
    return rng, corpus, n_postings


def run(args) -> dict:
    """The serving paths: build the corpus and its index, then serve.

    Boolean AND returns ``serve_boolean``'s keys plus ``index``,
    ``queries``, ``n_postings``, ``build_s`` and ``bpi``; ``--ranked``
    returns ``run_ranked``'s.
    """
    cfg = args.cfg
    check_device(args)
    if args.ranked:
        return run_ranked(args)
    rng, corpus, n_postings = _corpus(args)

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
    return {
        "index": idx,
        "queries": queries,
        "n_postings": n_postings,
        "build_s": t_build,
        "bpi": idx.bits_per_int(),
        **serve_boolean(args, idx, queries),
    }


def serve_boolean(args, idx, queries) -> dict:
    """Serve boolean-AND ``queries`` over a built ``idx`` with the engine
    ``args.cfg`` describes (sharded and fault-injected per the flags).

    Keys: ``engine``, ``results``, ``arena_device_bytes`` (None off the
    device backend or when sharded), ``shard_device_bytes`` (per shard
    when sharded on the device), ``qps``, ``batch_s`` (every batch's
    seconds), ``batch_p50_s``, ``batch_p99_s``,
    ``resilient`` (the ``ResilientEngine``, or None) and ``faults`` (its
    summary, or None).
    """
    cfg = args.cfg
    t0 = obs.now()
    engine = make_query_engine(idx, cfg)
    _print_shard_layout(engine)
    t_arena = obs.now() - t0
    a = engine.arena
    print(f"[serve] arena ({cfg.codec_policy}): {a.n_blocks:,} blocks, "
          f"{a.nbytes()/1e6:.1f} MB host ({t_arena:.1f}s)")
    # warm-up batch: first kernel build and launch, arena upload, flat
    # mirror / LRU fill
    engine.intersect_batch(queries[: args.batch])
    resilient = _make_resilient(args, engine)

    t0 = obs.now()
    try:
        if resilient is not None:
            results, lat, degraded_q = serve_resilient(resilient, queries,
                                                       args.batch)
        else:
            results, lat = serve_batches(engine, queries, args.batch)
    finally:
        _close_resilient(resilient)
    wall = obs.now() - t0
    n_results = sum(r.size for r in results)
    sizes = [len(queries[i : i + args.batch])
             for i in range(0, len(queries), args.batch)]
    per_q = [l / max(s, 1) for l, s in zip(lat, sizes)]
    path = "fused" if engine.fused else "partition-lru"
    where = engine.device if engine.device is not None else "host"
    dev_bytes = _device_bytes(engine)
    on_dev = (dev_bytes["arena_device_bytes"]
              or sum(dev_bytes["shard_device_bytes"] or [0]))
    print(f"[serve] batched AND ({engine.backend}/{path} on {where}, "
          f"batch={args.batch}): {len(queries)/wall:,.0f} q/s, "
          f"{wall/len(queries)*1e3:.3f} ms/query avg, "
          f"{n_results:,} results total"
          + (f"; {on_dev/1e6:.1f} MB on the device" if on_dev else ""))
    print(f"[serve] batch latency: {_latency_line(lat, per_q)}")
    print(f"[serve] engine stats: {dict(engine.stats)}")
    out = {
        "engine": engine,
        "results": results,
        **dev_bytes,
        "qps": len(queries) / wall,
        "batch_s": lat,
        "batch_p50_s": _percentile(lat, 50),
        "batch_p99_s": _percentile(lat, 99),
        "resilient": resilient,
        "faults": None,
    }
    if resilient is not None:
        # degraded batches must not be verified against the oracle
        out["faults"] = _print_fault_summary(resilient, len(queries),
                                             degraded_q)
        return out

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
    return out


def build_ranked(args) -> dict:
    """The ``--ranked`` path's build half: the corpus, its term
    frequencies, the optimal index with the freq arena of its codec policy
    (host only), and the queries, all from ``args.seed``.

    Keys: ``index``, ``queries``, ``n_postings``, ``freqs_s`` (the tf
    generator), ``build_s`` (index + arena with its ranked sidecar),
    ``bpi``.
    """
    cfg = args.cfg
    rng, corpus, n_postings = _corpus(args)
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
    return {
        "index": idx,
        "queries": queries,
        "n_postings": n_postings,
        "freqs_s": t_freqs,
        "build_s": t_build,
        "bpi": idx.bits_per_int(),
    }


def run_ranked(args) -> dict:
    """The ``--ranked`` path: batched BM25 top-k over the freq arena --
    ``build_ranked``'s keys, then ``serve_ranked``'s."""
    built = build_ranked(args)
    return {**built, **serve_ranked(args, built["index"], built["queries"])}


def serve_ranked(args, idx, queries) -> dict:
    """Serve ranked top-k ``queries`` over a built freq-carrying ``idx``
    with the engine ``args.cfg`` describes.

    Keys: ``engine``, ``arena_device_bytes`` / ``shard_device_bytes`` (as
    ``serve_boolean``), ``results``, ``qps``, ``batch_s``, ``batch_p50_s``,
    ``batch_p99_s``, ``oracle_s`` (per query, None without
    ``--compare-scalar``), ``resilient`` and ``faults``.  With ``--loop``
    the warm-up batch is followed by ``serve_loop`` instead of the fixed
    batches, and the keys from ``results`` on give way to ``loop``, its
    summary.
    """
    from ..ranked.bm25 import exhaustive_topk

    cfg = args.cfg
    engine = make_topk_engine(idx, cfg)
    _print_shard_layout(engine)
    arena = engine.arena
    where = engine.device if engine.device is not None else "host"
    print(f"[serve] ranked arena ({cfg.codec_policy}): {arena.n_blocks:,} "
          f"blocks, {engine.resident} residency on {where}")
    t0 = obs.now()
    engine.topk_batch(queries[: args.batch], args.topk)  # warm mirror + cache
    print(f"[serve] warm-up batch: {obs.now()-t0:.1f}s (flat mirror"
          + (", impact mirror" if engine.resident == "mirror" else "") + ")")
    built = {"engine": engine, **_device_bytes(engine)}
    if args.loop:
        return {**built, "loop": serve_loop(args, engine, queries)}
    resilient = _make_resilient(args, engine)

    t0 = obs.now()
    try:
        if resilient is not None:
            results, lat, degraded_q = serve_resilient(
                resilient, queries, args.batch, topk=args.topk
            )
        else:
            results, lat = [], []
            for i in range(0, len(queries), args.batch):
                with obs.timer("serve_batch_ms", path="ranked") as bt:
                    results.extend(engine.topk_batch(
                        queries[i : i + args.batch], args.topk))
                lat.append(bt.elapsed_s)
    finally:
        _close_resilient(resilient)
    wall = obs.now() - t0
    sizes = [len(queries[i : i + args.batch])
             for i in range(0, len(queries), args.batch)]
    per_q = [l / max(s, 1) for l, s in zip(lat, sizes)]
    dev_bytes = _device_bytes(engine)
    print(f"[serve] ranked top-{args.topk} ({engine.backend}/"
          f"{engine.resident} on {where}, batch={args.batch}): "
          f"{len(queries)/wall:,.0f} q/s, "
          f"{wall/len(queries)*1e3:.3f} ms/query avg")
    print(f"[serve] batch latency: {_latency_line(lat, per_q)}")
    print(f"[serve] engine stats: {dict(engine.stats)}")
    out = {
        **built,
        **dev_bytes,
        "results": results,
        "qps": len(queries) / wall,
        "batch_s": lat,
        "batch_p50_s": _percentile(lat, 50),
        "batch_p99_s": _percentile(lat, 99),
        "oracle_s": None,
        "resilient": resilient,
        "faults": None,
    }
    if resilient is not None:
        # degraded batches must not be verified against the oracle
        out["faults"] = _print_fault_summary(resilient, len(queries),
                                             degraded_q)
        return out

    if args.compare_scalar:
        n_check = min(len(queries), 64)
        t0 = obs.now()
        want = exhaustive_topk(idx, queries[:n_check], args.topk)
        dt = obs.now() - t0
        for q, (gd, gs), (wd, ws) in zip(queries, results, want):
            assert np.array_equal(gd, wd) and np.array_equal(gs, ws), (
                f"top-k mismatch on query {q}"
            )
        out["oracle_s"] = dt / n_check
        speedup = out["oracle_s"] / (wall / len(queries))
        print(f"[serve] exhaustive oracle: {dt/n_check*1e3:.2f} ms/query "
              f"over {n_check} queries -> block-max speedup {speedup:.1f}x, "
              f"identical top-k")
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    server = None
    if args.metrics_port is not None or args.metrics_dump:
        obs.enable()
    if args.metrics_port is not None:
        server = obs.MetricsServer(args.metrics_port)
        print(f"[serve] metrics: http://127.0.0.1:{server.port}/metrics "
              f"(Prometheus) and /metrics.json")
    try:
        run(args)
    finally:
        if args.metrics_dump:
            obs.write_snapshot(args.metrics_dump)
            print(f"[serve] metrics snapshot -> {args.metrics_dump}")
        if server is not None:
            server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
