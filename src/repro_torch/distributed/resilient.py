"""Fault-tolerant sharded serving.

Counterpart of ``repro/distributed/resilient.py``.  The query-path
counterpart of ``fault_tolerance.py``: a training step that dies restarts
from checkpoint; a SERVING shard that dies must keep the engine
answering.  Three pieces:

* ``ShardFaultInjector`` -- ``SimulatedFailure`` for the query path.
  Consulted at every shard-dispatch boundary the engines have (the
  ``_ShardMapDispatch.__call__`` device-list path, the per-shard
  ``EngineCore`` host loop, and ``TopKEngine``'s per-shard dispatch loops),
  so injected faults exercise the REAL serving code paths, not a mock.
* ``ResilientEngine`` -- a wrapper around a sharded ``QueryEngine`` or
  ``TopKEngine`` holding a per-shard health state machine

      HEALTHY -> SUSPECT -> DEAD -> RECOVERING -> HEALTHY

  with bounded exponential-backoff retry under a per-batch deadline.  A
  DEAD shard's lists fail over to live replicas (``replicas=R`` routing in
  ``core.shard``; bit-identical, the merge being a pure scatter).  Lists
  with no live replica degrade: the batch is answered restricted to live
  lists and tagged ``ServeInfo(degraded=True, missing_lists=...)`` --
  exactly the no-fault answer of the restricted queries -- while (given a
  ``CheckpointManager``) the lost sub-arena restores from the arena
  checkpoint (``core.arena_ckpt.restore_shard``, optionally on a
  background thread) and the shard re-admits.  The restored sub-arena
  comes back as host numpy; it is uploaded to its device at the next
  batch boundary, on the serving thread, never from the restore thread.
* identity discipline -- replica-served and recovered results are
  bit-identical to the no-fault run; degraded results are the no-fault
  results of the live-restricted queries.

The numpy backend serves sharded engines through the global flat mirror
unrouted (see ``query_engine``); its only per-shard dispatch boundary is
the wrapper's preflight health check, so health/degradation semantics are
identical across backends even though the fault surfaces differ.
"""

from __future__ import annotations

import dataclasses
import itertools
import random
import threading
import time

import numpy as np

from .. import obs

HEALTHY = "HEALTHY"
SUSPECT = "SUSPECT"
DEAD = "DEAD"
RECOVERING = "RECOVERING"


class ShardFailure(RuntimeError):
    """Raised at a shard-dispatch boundary to emulate a dead shard."""

    def __init__(self, shard: int):
        self.shard = int(shard)
        super().__init__(f"shard {self.shard} failed")


class ShardFaultInjector:
    """``SimulatedFailure`` mirrored onto the query path.

    Faults arm per BATCH (``begin_batch`` is called once per served batch
    by ``ResilientEngine``) and fire at dispatch: any armed shard that
    receives cursors raises ``ShardFailure`` from the dispatch boundary.

    at_batches: batch indices at which the next victim shard dies
        (deterministic schedule, fires once each like ``at_steps``).
    probability: per-batch death probability, seeded -- the same seed
        replays the same fault schedule.
    shards: victim pool, cycled through by deterministic schedules.
    transient: a fired fault clears at the next batch (a blip, not a
        death) unless the engine marked it dead meanwhile.
    """

    def __init__(
        self,
        at_batches=(),
        probability: float = 0.0,
        seed: int = 0,
        shards=(0,),
        transient: bool = False,
    ):
        self.at_batches = set(at_batches)
        self.probability = float(probability)
        self.transient = bool(transient)
        self._rng = random.Random(seed)
        self._victims = itertools.cycle(tuple(shards))
        self.dead: set[int] = set()
        self.batch = -1
        self.fired = 0

    def begin_batch(self) -> None:
        self.batch += 1
        if self.transient:
            self.dead.clear()
        fire = False
        if self.batch in self.at_batches:
            self.at_batches.discard(self.batch)
            fire = True
        elif self.probability > 0 and self._rng.random() < self.probability:
            fire = True
        if fire:
            self.dead.add(next(self._victims))
            self.fired += 1

    def check(self, shard: int) -> None:
        """The dispatch boundary: dead shards answer with ShardFailure."""
        if int(shard) in self.dead:
            raise ShardFailure(int(shard))

    def check_shards(self, shards) -> None:
        for s in np.asarray(shards).ravel():
            self.check(int(s))

    def revive(self, shard: int) -> None:
        self.dead.discard(int(shard))


@dataclasses.dataclass
class ServeInfo:
    """Per-batch serving outcome riding alongside the results."""

    degraded: bool = False
    missing_lists: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64)
    )
    retries: int = 0
    failed_shards: list = dataclasses.field(default_factory=list)


class ResilientEngine:
    """Health-supervised serving over a sharded Query/TopK engine.

    engine: a ``QueryEngine`` or ``TopKEngine`` built with ``shards=N``
        (and usually ``replicas=R``).  The injector is late-wired into the
        engine's dispatch boundaries, so wrapping an already-warm engine
        works.
    injector: the ``ShardFaultInjector`` driving the failure schedule
        (None = supervise only; faults then never fire).
    manager: a ``CheckpointManager`` holding (or about to hold, via
        ``checkpoint()``) a global arena checkpoint; enables DEAD-shard
        recovery.  None = dead shards stay dead (replicas or degradation
        carry the traffic).
    max_retries / backoff_s / deadline_s: bounded retry -- attempt i
        sleeps ``backoff_s * 2**(i-1)``, and no batch retries past its
        deadline.  Exhaustion (or ``dead_after`` accumulated failures)
        escalates SUSPECT -> DEAD.
    recover_async: restore the lost sub-arena on a background thread and
        re-admit at a later batch boundary (the serving loop keeps
        answering degraded/failed-over meanwhile); False restores inline
        so the very next attempt is whole again.
    """

    def __init__(
        self,
        engine,
        injector: ShardFaultInjector | None = None,
        manager=None,
        max_retries: int = 2,
        backoff_s: float = 0.002,
        deadline_s: float = 2.0,
        dead_after: int = 3,
        recover_async: bool = False,
    ):
        if engine.sharded is None:
            raise ValueError("ResilientEngine needs a sharded engine (shards=N)")
        self.engine = engine
        self.sa = engine.sharded
        self.injector = injector
        self.manager = manager
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.deadline_s = float(deadline_s)
        self.dead_after = int(dead_after)
        self.recover_async = bool(recover_async)
        S = self.sa.n_shards
        self.health = [HEALTHY] * S
        self.failures = np.zeros(S, np.int64)
        # CounterDict mirrors the numeric counters onto obs when armed;
        # the raw recovery_s list passes through untouched
        self.stats = obs.CounterDict(
            "resilient",
            {
                "batches": 0,
                "failures": 0,
                "retries": 0,
                "failovers": 0,
                "degraded_batches": 0,
                "dead_events": 0,
                "recoveries": 0,
                "recovery_s": [],
            },
        )
        self._ckpt_step: int | None = None
        # what the checkpoint cost: its write (s), its bytes on disk, and
        # the seconds of every shard restore from it (reporting only)
        self.checkpoint_s: float | None = None
        self.checkpoint_bytes: int | None = None
        self.restore_s: list[float] = []
        self._death_t: dict[int, float] = {}
        self._ready: dict[int, object] = {}
        self._lock = threading.Lock()
        self._threads: list[threading.Thread] = []
        if injector is not None:
            self._wire_injector(injector)

    def _wire_injector(self, injector) -> None:
        """Late-wire the injector into every dispatch boundary the engine
        may already have materialized (cores, device-list dispatchers)."""
        eng = self.engine
        eng.fault_injector = injector
        for core in getattr(eng, "_shard_cores", []) or []:
            if core is not None:
                core.injector = injector
        for attr in ("_smap_fn", "_smap_pivot"):
            fn = getattr(eng, attr, None)
            if fn is not None:
                fn.injector = injector

    # ------------------------------------------------------------------
    # checkpoint / recovery
    # ------------------------------------------------------------------
    def checkpoint(self, step: int = 0) -> None:
        """Write the global arena checkpoint recovery restores from."""
        from ..core.arena_ckpt import save_arena

        if self.manager is None:
            raise ValueError("checkpoint() needs a CheckpointManager")
        t0 = obs.now()
        save_arena(self.manager, self.sa.arena, step)
        self.checkpoint_s = obs.now() - t0
        path = self.manager.dir / f"step_{step:010d}"
        self.checkpoint_bytes = sum(
            f.stat().st_size for f in path.iterdir() if f.is_file()
        )
        self._ckpt_step = step

    def _set_health(self, s: int, new: str) -> None:
        """Single choke point for health transitions: mutates the state
        AND emits the transition as an obs counter + trace event, so the
        HEALTHY -> SUSPECT -> DEAD -> RECOVERING -> HEALTHY trajectory is
        reconstructable from the registry snapshot alone."""
        old = self.health[s]
        if old == new:
            return
        self.health[s] = new
        obs.count("resilient_health_transitions", shard=str(s), src=old, dst=new)
        obs.event("health_transition", shard=s, src=old, dst=new)

    def _mark_dead(self, s: int) -> None:
        if self.health[s] in (DEAD, RECOVERING):
            return
        self._set_health(s, DEAD)
        self.stats["dead_events"] += 1
        self.sa.dead[s] = True
        self._death_t[s] = obs.now()
        self._evict(s)
        if self.manager is not None:
            self._start_recovery(s)

    def _evict(self, s: int) -> None:
        """Simulate the loss: drop the shard's sub-arena, its device
        tensors and per-shard engine state, so recovery provably rebuilds
        from the checkpoint (routing never targets a dead shard, so the
        holes are unread)."""
        self.sa.evict(s)
        cores = getattr(self.engine, "_shard_cores", None)
        if cores:
            cores[s] = None

    def _start_recovery(self, s: int) -> None:
        from ..core.arena_ckpt import restore_shard

        self._set_health(s, RECOVERING)

        def work():
            t0 = obs.now()
            sub, _ = restore_shard(
                self.manager,
                s,
                self.sa.n_shards,
                replicas=self.sa.replicas,
                step=self._ckpt_step,
            )
            with self._lock:
                self.restore_s.append(obs.now() - t0)
                self._ready[s] = sub

        if self.recover_async:
            t = threading.Thread(target=work, daemon=True)
            t.start()
            self._threads.append(t)
        else:
            work()

    def _admit_recovered(self) -> None:
        """Install restored sub-arenas at a batch boundary: re-slot and
        upload the slice (on this, the serving thread), rebuild the
        per-shard core, clear the dead mask, revive."""
        with self._lock:
            ready = list(self._ready.items())
            self._ready.clear()
        for s, sub in ready:
            sa, eng = self.sa, self.engine
            sa.install(s, sub)
            cores = getattr(eng, "_shard_cores", None)
            if cores:
                from ..core.engine_core import EngineCore

                # the rebuilt core reads the engine's one EngineConfig
                cfg = eng.config
                cores[s] = EngineCore(
                    sub,
                    backend=eng.backend,
                    device=eng.device,
                    cache_parts=cfg.cache_parts,
                    cache_bytes=cfg.cache_bytes,
                    stats=eng.stats,
                    shard_id=s,
                    injector=self.injector,
                )
            sa.dead[s] = False
            self._set_health(s, HEALTHY)
            self.failures[s] = 0
            if self.injector is not None:
                self.injector.revive(s)
            self.stats["recoveries"] += 1
            dt = obs.now() - self._death_t.pop(s)
            self.stats["recovery_s"].append(dt)
            obs.observe("resilient_recovery_ms", dt * 1e3, shard=str(s))

    def wait_recovered(self, timeout_s: float = 30.0) -> None:
        """Block until in-flight background restores finish (tests/drain)."""
        for t in self._threads:
            t.join(timeout_s)
        self._threads = [t for t in self._threads if t.is_alive()]

    # ------------------------------------------------------------------
    # supervised serving loop
    # ------------------------------------------------------------------
    def _preflight(self) -> None:
        """Health check: poke the injector for every shard believed live,
        so faults surface identically on every backend (the numpy backend
        has no routed dispatch to carry the in-band check)."""
        if self.injector is None:
            return
        for s in range(self.sa.n_shards):
            if self.health[s] in (HEALTHY, SUSPECT):
                self.injector.check(s)

    def _note_failure(self, s: int) -> None:
        self.stats["failures"] += 1
        self.failures[s] += 1
        if self.health[s] == HEALTHY:
            self._set_health(s, SUSPECT)

    def _note_success(self) -> None:
        for s in range(self.sa.n_shards):
            if self.health[s] == SUSPECT and (
                self.injector is None or s not in self.injector.dead
            ):
                self._set_health(s, HEALTHY)
                self.failures[s] = 0

    def _serve(self, attempt):
        """Run ``attempt`` under the health state machine; returns
        (result, ServeInfo).  ``attempt`` must re-read the live-list set
        each call (it changes as shards die/recover) and return
        ``(result, missing_lists)``."""
        if self.injector is not None:
            self.injector.begin_batch()
        self._admit_recovered()
        self.stats["batches"] += 1
        t0 = obs.now()
        retries = 0
        failed: list[int] = []
        while True:
            try:
                self._preflight()
                result, missing = attempt()
            except ShardFailure as e:
                s = e.shard
                failed.append(s)
                self._note_failure(s)
                expired = obs.now() - t0 >= self.deadline_s
                if (
                    self.health[s] == SUSPECT
                    and self.failures[s] < self.dead_after
                    and retries < self.max_retries
                    and not expired
                ):
                    retries += 1
                    self.stats["retries"] += 1
                    time.sleep(self.backoff_s * (2 ** (retries - 1)))
                    continue
                self._mark_dead(s)
                # a synchronous recovery has already restored by now:
                # re-admit immediately so THIS batch is served whole
                self._admit_recovered()
                continue
            self._note_success()
            info = ServeInfo(
                degraded=bool(missing.size),
                missing_lists=missing,
                retries=retries,
                failed_shards=failed,
            )
            if info.degraded:
                self.stats["degraded_batches"] += 1
                obs.count("resilient_degraded_answers", len(info.missing_lists))
            elif failed:
                self.stats["failovers"] += 1
                # failover latency: fault detection through served answer
                obs.observe("resilient_failover_ms", (obs.now() - t0) * 1e3)
            return result, info

    def _missing(self) -> np.ndarray:
        return self.sa.unserved_lists()

    # ------------------------------------------------------------------
    # engine entry points (degrading wrappers)
    # ------------------------------------------------------------------
    def search_batch(self, terms, probes):
        """(values, ranks, info): NextGEQ with unserved cursors at -1."""
        terms = np.asarray(terms, np.int64)
        probes = np.asarray(probes, np.int64)

        def attempt():
            missing = self._missing()
            hit = (
                np.isin(terms, missing) if missing.size else np.zeros(len(terms), bool)
            )
            if hit.any():
                v = np.full(len(terms), -1, np.int64)
                r = np.full(len(terms), -1, np.int64)
                vv, rr = self.engine.search_batch(terms[~hit], probes[~hit])
                v[~hit] = vv
                r[~hit] = rr
                return (v, r), np.unique(terms[hit])
            return self.engine.search_batch(terms, probes), np.zeros(0, np.int64)

        (values, ranks), info = self._serve(attempt)
        return values, ranks, info

    def intersect_batch(self, queries):
        """(results, info): AND queries restricted to live lists when
        degraded -- exactly the no-fault answers of the restricted
        queries."""

        def attempt():
            missing = self._missing()
            if missing.size:
                mset = set(missing.tolist())
                touched = sorted({int(t) for q in queries for t in q if int(t) in mset})
                if touched:
                    live = [[int(t) for t in q if int(t) not in mset] for q in queries]
                    return (
                        self.engine.intersect_batch(live),
                        np.asarray(touched, np.int64),
                    )
            return self.engine.intersect_batch(queries), np.zeros(0, np.int64)

        return self._serve(attempt)

    def topk_batch(self, queries, k: int = 10):
        """(results, info): ranked top-k over live lists when degraded."""

        def attempt():
            missing = self._missing()
            if missing.size:
                mset = set(missing.tolist())
                touched = sorted({int(t) for q in queries for t in q if int(t) in mset})
                if touched:
                    live = [[int(t) for t in q if int(t) not in mset] for q in queries]
                    return (
                        self.engine.topk_batch(live, k),
                        np.asarray(touched, np.int64),
                    )
            return self.engine.topk_batch(queries, k), np.zeros(0, np.int64)

        return self._serve(attempt)

    # ------------------------------------------------------------------
    # reporting
    # ------------------------------------------------------------------
    def recovery_p99_s(self) -> float:
        """p99 of observed death -> re-admit times (NaN if none yet)."""
        times = self.stats["recovery_s"]
        if not times:
            return float("nan")
        return obs.Histogram.percentile_of(times, 99)

    def health_summary(self) -> dict:
        return {
            "health": list(self.health),
            "dead": [int(s) for s in np.flatnonzero(self.sa.dead)],
            "unserved_lists": self.sa.unserved_lists().tolist(),
            **{
                k: (list(v) if isinstance(v, list) else v)
                for k, v in self.stats.items()
            },
        }
