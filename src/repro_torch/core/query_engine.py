"""Batched query engine over the block arena of a ``PartitionedIndex``.

Counterpart of ``repro/core/query_engine.py``.  The engine evaluates MANY
boolean-AND queries per call.  Two generations of the batched path coexist
(``fused=`` selects; both are exact):

**Fused path (default).**  The index's ``DeviceArena`` stores every
partition as whole 512-byte Stream-VByte tiles (or Elias-Fano tiles in a
multi-codec arena) with per-block sidecars.  NextGEQ for a whole batch is:

1. **locate** -- ONE searchsorted over ``block_keys`` finds, for every
   (term, probe) cursor at once, the arena row holding its answer;
2. **fuse**   -- the ``decode_search`` (or ``ef_search``) kernel decodes
   each located row and resolves the probe in registers, emitting only
   (next_geq_value, local_rank) per cursor;
3. **gather** -- results are masked for past-the-end cursors.

On ``backend="torch"`` the whole pipeline runs on ``device`` over the
once-uploaded arena, with one host sync per dispatch.  On
``backend="numpy"`` the same pipeline runs vectorized on the host.

**Sharded path (``shards=N``).**  The arena is list-hash-partitioned into
N per-shard sub-arenas (``core.shard.ShardedArena``).  Cursors route to
their owning shard on the host; each shard runs the SAME fused pipeline
over its sub-arena -- as one dispatch over a device list (one device per
shard) when ``shard_mesh`` gives one, else as a per-shard loop on the
engine's device -- and results merge on the host only at the result
boundary (values are absolute docIDs and ranks partition-local, so the
merge is a pure scatter).  A 1-shard ``ShardedArena`` is bit-identical to
the unsharded path.  Sharding is a device-PLACEMENT concept: the numpy
backend has no devices to place shards on, so it serves sharded engines
through the global flat mirror unrouted; the routed host path stays
available as ``_fused_sharded``.

**Partition-LRU path (``fused=False``).**  Partition-level location plus
an LRU cache of decoded partitions, bounded by decoded BYTES
(``cache_bytes``) and entry count (``cache_parts``).

Batched AND uses membership filtering: candidates are the smallest list of
each query, then every other term (in ascending size) filters the surviving
candidates -- exactly the set the scalar in-order NextGEQ loop produces, in
the same ascending order.
"""

from __future__ import annotations

import numpy as np

from .. import obs
from ..api import UNSET, coerce_config
from ..kernels.vbyte_decode.kernel import BLOCK_VALS
from .engine_core import EngineCore, group_cursors

TAG_VBYTE = 0
TAG_BITVECTOR = 1


def _concat_aranges(counts: np.ndarray) -> np.ndarray:
    """concatenate([arange(c) for c in counts]) without a Python loop.

    All counts must be >= 1.
    """
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    out = np.ones(total, np.int64)
    out[0] = 0
    ends = np.cumsum(counts)[:-1]
    out[ends] -= counts[:-1]
    np.cumsum(out, out=out)
    return out


class QueryEngine:
    """Batched NextGEQ / AND evaluation over one ``PartitionedIndex``.

    Parameters
    ----------
    index: the (immutable) PartitionedIndex to serve.
    backend: "auto" (= "torch") | "torch" | "numpy".
    device: torch device of the "torch" backend; "cuda" by default, and a
        machine without CUDA raises unless the caller passes "cpu".
    cache_parts / cache_bytes: LRU bounds (entries / decoded-value bytes);
        cache_bytes also budgets the fused path's flat mirror.
    fused: serve through the fused locate->decode_search pipeline
        (default); False selects the partition-LRU path.
    group: group duplicate (term, probe) cursors before the DEVICE
        dispatch, so each block row is gathered and decoded once.
    codec_policy: the arena codec policy ("svb" | "auto" | "ef").
    shards: list-hash-partition the arena into this many shards and route
        cursors per shard (requires ``fused=True``).  None = unsharded.
    shard_mesh: "auto" | None | a sequence of torch devices, one per shard.
        "auto" places shard i on ``cuda:i`` when the process sees enough
        cards (the one-dispatch path); None (or too few cards) serves
        shards as a host-side loop on ``device``.
    replicas: place each list on this many shards; routing prefers the
        primary, so R > 1 changes nothing until a shard is marked dead and
        its lists fail over to live replicas -- bit-identically.
    fault_injector: optional ``ShardFaultInjector`` consulted at every
        shard dispatch, normally wired by ``ResilientEngine``.
    """

    def __init__(
        self,
        index,
        backend=UNSET,
        device=UNSET,
        cache_parts=UNSET,
        cache_bytes=UNSET,
        fused=UNSET,
        group=UNSET,
        shards=UNSET,
        shard_mesh=UNSET,
        replicas=UNSET,
        fault_injector=UNSET,
        codec_policy=UNSET,
        config=None,
        **kwargs,
    ):
        cfg = coerce_config(
            "QueryEngine",
            config,
            dict(
                backend=backend, device=device, cache_parts=cache_parts,
                cache_bytes=cache_bytes, fused=fused, group=group,
                shards=shards, shard_mesh=shard_mesh, replicas=replicas,
                fault_injector=fault_injector, codec_policy=codec_policy,
            ),
            kwargs,
        )
        self.config = cfg
        self.index = index
        self.cache_parts = int(cfg.cache_parts)
        self.cache_bytes = int(cfg.cache_bytes)
        self.fused = bool(cfg.fused)
        self.group = bool(cfg.group)
        self.arena = index.arena_for(cfg.codec_policy)
        self.stats = obs.CounterDict(
            "engine",
            {
                "decoded_parts": 0,
                "decoded_rows": 0,
                "cache_hits": 0,
                "kernel_calls": 0,
                "evictions": 0,
                "fused_batches": 0,
                "grouped_cursors": 0,
                "sharded_batches": 0,
            },
            engine="query",
        )
        self.core = EngineCore(
            self.arena, backend=cfg.backend, device=cfg.device,
            cache_parts=self.cache_parts, cache_bytes=self.cache_bytes,
            stats=self.stats,
        )
        self.backend = self.core.backend
        self.device = self.core.device

        self.sharded = None
        self._shard_cores: list[EngineCore] = []
        self._smap_fn = None
        self.fault_injector = cfg.fault_injector
        if cfg.shards is not None:
            if not self.fused:
                raise ValueError("shards= requires the fused engine "
                                 "(fused=True)")
            from .shard import ShardedArena

            self.sharded = ShardedArena.build(
                self.arena, int(cfg.shards), mesh=cfg.shard_mesh,
                replicas=int(cfg.replicas), device=self.device,
            )

        a = self.arena
        self.stride = a.stride
        self.bases = a.bases
        self.part_list = a.part_list
        # partition-level location keys (partition-LRU path)
        self._keys = index.endpoints + a.part_list * a.stride

    # ------------------------------------------------------------------
    # shared-core delegation (flat mirror, LRU, fused pipelines)
    # ------------------------------------------------------------------
    @property
    def _cache(self):
        return self.core.cache

    @property
    def _cache_nbytes(self) -> int:
        return self.core.cache_nbytes

    @property
    def _flat_ok(self):
        return self.core.flat_ok

    @property
    def _flat_keys(self):
        return self.core.flat_keys

    @property
    def _flat_vals(self):
        return self.core.flat_vals

    def _flat_init(self) -> bool:
        return self.core.flat_init()

    def _rows_values(self, rows: np.ndarray) -> np.ndarray:
        return self.core.rows_values(rows)

    def partition_values(self, p: int) -> np.ndarray:
        """Absolute docIDs of partition p (decoded through the LRU cache)."""
        return self._fetch(np.asarray([p], dtype=np.int64))[int(p)]

    def _fetch(self, parts: np.ndarray) -> dict[int, np.ndarray]:
        """{partition: decoded docIDs} for every partition, via the cache.

        The returned dict PINS the working set: callers read from it, never
        from the cache afterwards.
        """
        out: dict[int, np.ndarray] = {}
        missing = []
        for p in parts:
            p = int(p)
            got = self.core.cache_get(p)
            if got is None:
                missing.append(p)
            else:
                out[p] = got
        if missing:
            out.update(self._decode_into_cache(np.asarray(missing, np.int64)))
        return out

    def _decode_into_cache(self, parts: np.ndarray) -> dict[int, np.ndarray]:
        """Decode the given (unique, sorted) partitions from the arena.

        One row decode over the union of their block rows; every partition
        is then a contiguous slice of the decoded tile.
        """
        a = self.arena
        nblk = a.n_blk[parts]
        rows = np.repeat(a.first_blk[parts], nblk) + _concat_aranges(nblk)
        urows = np.unique(rows)
        vals = self.core.decode_rows(urows)
        self.stats["kernel_calls"] += 1
        self.stats["decoded_parts"] += len(parts)
        flat = vals.reshape(-1)
        row0 = np.searchsorted(urows, a.first_blk[parts])
        dec: dict[int, np.ndarray] = {}
        for j, p in enumerate(parts):
            s = int(row0[j]) * BLOCK_VALS
            dec[int(p)] = flat[s : s + int(a.sizes[p])]
        for key, arr in dec.items():
            self.core.cache_put(key, arr)
        return dec

    # ------------------------------------------------------------------
    # fused locate -> decode_search -> gather (hot path)
    # ------------------------------------------------------------------
    @property
    def _use_device(self) -> bool:
        # shards share the global arena's stride, which the core's
        # constructor has already held to the device gate
        return self.core.use_device

    def _shard_core(self, s: int) -> EngineCore:
        """Per-shard EngineCores, materialized on first ROUTED dispatch
        (the numpy backend never routes, so it never pays for them)."""
        if not self._shard_cores:
            self._shard_cores = [
                EngineCore(
                    sub, backend=self.backend, device=self.device,
                    cache_parts=self.cache_parts,
                    cache_bytes=self.cache_bytes, stats=self.stats,
                    shard_id=i, injector=self.fault_injector,
                )
                for i, sub in enumerate(self.sharded.shards)
            ]
        return self._shard_cores[s]

    def _fused_sharded(self, terms, probes, with_rank: bool = True,
                       trusted: bool = False):
        """Route cursors to owning shards, dispatch per shard, merge.

        The merge is a pure scatter: values are absolute docIDs and ranks
        are partition-local, so neither needs rebasing across shards.  With
        a device list the ``ShardMapSearch`` dispatch stages each shard's
        run on its device and fetches after every shard is enqueued; the
        loop path serves each shard through its own ``EngineCore``.
        """
        from .shard import ShardMapSearch, ShardsUnavailable

        sa = self.sharded
        n = len(terms)
        self.stats["sharded_batches"] += 1
        owner, local, served = sa.route(terms)
        if not served.all():
            raise ShardsUnavailable(np.unique(np.asarray(terms)[~served]))
        order = np.argsort(owner, kind="stable")
        cuts = np.searchsorted(owner[order], np.arange(sa.n_shards + 1))
        value = np.full(n, -1, np.int64)
        rank = np.full(n, -1, np.int64) if with_rank else None
        past = np.ones(n, bool)
        # the device-list dispatch is single-codec (one decode_search per
        # shard): ShardedArena.build gives a multi-codec arena no mesh, so
        # it serves shards through the host loop, whose per-shard
        # EngineCores dispatch per codec
        if self._use_device and sa.mesh is not None:
            if self._smap_fn is None:
                self._smap_fn = ShardMapSearch(
                    sa, injector=self.fault_injector
                )
            v, r = self._smap_fn(local[order], probes[order], cuts)
            value[order] = v
            past[order] = v < 0
            if with_rank:
                rank[order] = r
            return value, rank, past
        for s in range(sa.n_shards):
            idx = order[cuts[s] : cuts[s + 1]]
            if len(idx) == 0:
                continue
            v, r, p = self._shard_core(s).fused_search(
                local[idx], probes[idx], with_rank, trusted
            )
            value[idx] = v
            past[idx] = p
            if with_rank and r is not None:
                rank[idx] = r
        return value, rank, past

    def _fused_raw(self, terms, probes, with_rank: bool = True,
                   trusted: bool = False):
        """One fused dispatch for every entry point: (value, rank, past)."""
        n = len(terms)
        if n == 0 or self.arena.n_blocks == 0:
            full = np.full(n, -1, np.int64)
            return full, full.copy(), np.ones(n, bool)
        self.stats["fused_batches"] += 1
        if self._use_device and self.group and n > 1:
            # group duplicate (term, probe) cursors: AND filters across
            # queries sharing terms re-probe the same pairs.  Grouping runs
            # BEFORE shard routing, so duplicates collapse across the whole
            # batch whatever shard they land on.
            with obs.span("group_cursors", path="member"):
                g = group_cursors(terms, probes, self.arena.stride)
            if g is not None:
                idx, inv = g
                self.stats["grouped_cursors"] += n - len(idx)
                value, rank, past = self._fused_raw_unique(
                    terms[idx], probes[idx], with_rank, trusted
                )
                rank = rank[inv] if rank is not None else None
                return value[inv], rank, past[inv]
        return self._fused_raw_unique(terms, probes, with_rank, trusted)

    def _fused_raw_unique(self, terms, probes, with_rank, trusted):
        # the numpy backend serves through the global flat mirror (no
        # devices to place shards on); the torch backend routes per shard
        if self.sharded is not None and self._use_device:
            return self._fused_sharded(terms, probes, with_rank, trusted)
        return self.core.fused_search(terms, probes, with_rank, trusted)

    def search_batch(self, terms, probes) -> tuple[np.ndarray, np.ndarray]:
        """Fused NextGEQ: (values, local ranks) per (term, probe) cursor.

        values[i] = smallest element of list terms[i] >= probes[i] (-1 past
        the end); ranks[i] = its index within the OWNING PARTITION (-1 past
        the end).  Always uses the fused pipeline, whatever ``self.fused``.
        """
        terms = np.asarray(terms, dtype=np.int64)
        probes = np.asarray(probes, dtype=np.int64)
        value, rank, past = self._fused_raw(terms, probes)
        return np.where(past, -1, value), np.where(past, -1, rank)

    # ------------------------------------------------------------------
    # vectorized partition location (partition-LRU path)
    # ------------------------------------------------------------------
    def locate(self, terms: np.ndarray, probes: np.ndarray) -> np.ndarray:
        """Partition holding NextGEQ(term, probe) per pair; -1 = past end."""
        with obs.span("locate", path="partition"):
            terms = np.asarray(terms, dtype=np.int64)
            probes = np.clip(np.asarray(probes, dtype=np.int64), 0, self.stride - 1)
            p = np.searchsorted(self._keys, probes + terms * self.stride, side="left")
            past = p >= self.index.list_part_offsets[terms + 1]
            return np.where(past, -1, p)

    def _resolve(self, parts: np.ndarray, probes: np.ndarray):
        """(values, found_exact) of NextGEQ inside already-located partitions."""
        uparts = np.unique(parts)
        fetched = self._fetch(uparts)
        vals = [fetched[int(p)] for p in uparts]
        sizes = np.asarray([len(v) for v in vals], dtype=np.int64)
        cat = np.concatenate(vals) if vals else np.zeros(0, np.int64)
        rank_per_val = np.repeat(np.arange(len(uparts), dtype=np.int64), sizes)
        keys = cat + rank_per_val * self.stride
        rank = np.searchsorted(uparts, parts)
        probe_keys = np.clip(probes, 0, self.stride - 1) + rank * self.stride
        k = np.searchsorted(keys, probe_keys, side="left")
        # locate() guarantees probe <= endpoint == last value, so k is inside
        # the partition's slice
        out = cat[np.minimum(k, len(cat) - 1)] if len(cat) else np.zeros(0, np.int64)
        exact = (k < len(keys)) & (keys[np.minimum(k, len(keys) - 1)] == probe_keys) if len(keys) else np.zeros(len(parts), bool)
        return out, exact

    # ------------------------------------------------------------------
    # public batched ops
    # ------------------------------------------------------------------
    def next_geq_batch(self, terms, probes) -> np.ndarray:
        """Vectorized NextGEQ over (term, probe) pairs; -1 past the end."""
        terms = np.asarray(terms, dtype=np.int64)
        probes = np.asarray(probes, dtype=np.int64)
        if self.fused:
            value, _, past = self._fused_raw(terms, probes, with_rank=False)
            return np.where(past, -1, value)
        p = self.locate(terms, probes)
        ok = p >= 0
        out = np.full(len(terms), -1, dtype=np.int64)
        if ok.any():
            vals, _ = self._resolve(p[ok], probes[ok])
            out[ok] = vals
        return out

    def member_batch(self, terms, probes) -> np.ndarray:
        """Vectorized membership test: probe in list(term)."""
        terms = np.asarray(terms, dtype=np.int64)
        probes = np.asarray(probes, dtype=np.int64)
        if self.fused:
            value, _, past = self._fused_raw(terms, probes, with_rank=False)
            return (value == probes) & ~past
        p = self.locate(terms, probes)
        ok = p >= 0
        member = np.zeros(len(terms), bool)
        if ok.any():
            # endpoints are always present -- resolve only the interior
            hit_end = probes[ok] == self.index.endpoints[p[ok]]
            inner = ok.copy()
            inner[ok] = ~hit_end
            member[ok] = hit_end
            if inner.any():
                _, exact = self._resolve(p[inner], probes[inner])
                member[inner] = exact
        return member

    def _member_in(self, terms: np.ndarray, probes: np.ndarray) -> np.ndarray:
        """Membership for the AND filter: probes are decoded docIDs."""
        obs.count("engine_member_cursors", len(terms))
        if not self.fused:
            return self.member_batch(terms, probes)
        value, _, past = self._fused_raw(
            terms, probes, with_rank=False, trusted=True
        )
        return (value == probes) & ~past

    def decode_list(self, t: int) -> np.ndarray:
        if self.fused:
            # always the global core: list decode is a HOST mirror op (the
            # candidate seed of the AND filter), not a shard dispatch
            return self.core.decode_list(t)
        sl = slice(
            int(self.index.list_part_offsets[t]),
            int(self.index.list_part_offsets[t + 1]),
        )
        parts = np.arange(sl.start, sl.stop, dtype=np.int64)
        fetched = self._fetch(parts)
        chunks = [fetched[int(p)] for p in parts]
        return np.concatenate(chunks) if chunks else np.zeros(0, np.int64)

    def intersect_batch(self, queries: list[list[int]]) -> list[np.ndarray]:
        """Boolean AND of each query's lists; equals the scalar NextGEQ loop.

        Candidates start as the smallest list of each query; every further
        term (ascending size) filters them with one vectorized membership
        pass across the WHOLE batch.
        """
        nq = len(queries)
        sizes = self.index.list_sizes
        order = [sorted(map(int, q), key=lambda t: int(sizes[t])) for q in queries]
        empty = np.zeros(0, np.int64)
        cand_chunks, qid_chunks = [], []
        with obs.span("gather", phase="seed_candidates"):
            for i, o in enumerate(order):
                if not o:
                    continue
                c = self.decode_list(o[0])
                cand_chunks.append(c)
                qid_chunks.append(np.full(len(c), i, np.int64))
        cand = np.concatenate(cand_chunks) if cand_chunks else empty
        qid = np.concatenate(qid_chunks) if qid_chunks else empty
        max_arity = max((len(o) for o in order), default=0)
        with obs.span("member_filter"):
            for layer in range(1, max_arity):
                term_of_q = np.asarray(
                    [o[layer] if len(o) > layer else -1 for o in order],
                    dtype=np.int64,
                )
                t = term_of_q[qid]
                sel = t >= 0
                if not sel.any():
                    continue
                if sel.all():
                    keep = self._member_in(t, cand)
                else:
                    keep = np.ones(len(cand), bool)
                    keep[sel] = self._member_in(t[sel], cand[sel])
                cand, qid = cand[keep], qid[keep]
        # qid stays sorted (boolean masking is stable) -> split by run
        cuts = np.searchsorted(qid, np.arange(nq + 1))
        return [cand[cuts[i] : cuts[i + 1]] for i in range(nq)]
