"""Sharded arena: list-hash partitioning over torch devices.

Counterpart of ``repro/core/shard.py``.  The block arena is one flat
address space in which the blocks of one list are consecutive rows, so a
shard is just a SUBSET of lists, and slicing the arena by owning list
yields a smaller arena with the same invariants:

* **list-hash partitioning**: list t lives on shard ``splitmix64(t) %
  n_shards`` -- ownership is a pure function of the list id, no routing
  table.
* **per-shard sub-arenas**: each shard's rows are gathered into a
  ``DeviceArena`` of its own, with list ids remapped to shard-local
  (ascending, so per-shard ``block_keys`` stay non-decreasing) and the SAME
  global ``stride`` -- probe keys equal the unsharded ones, which is what
  makes 1-shard sharding bit-identical.  The ranked sidecar slices the
  same way; multi-codec arenas slice per codec.
* **routing + merge contract**: cursors route to ``owner[term]`` on the
  host; results merge by PURE SCATTER, because the fused kernels emit
  absolute docIDs and partition-LOCAL ranks (a partition lives wholly
  inside one shard).  Nothing crosses shards mid-query.
* **placement**: ``shard_mesh`` is ``"auto"``, None, or a sequence of
  torch devices, one per shard (a device may repeat: several shards then
  share one card, the counterpart of the reference's forced host device
  count).  With a device list each shard's sub-arena -- and, for the
  ranked pivot, its bound tiles -- is uploaded ONCE to its device, and a
  batch runs as one dispatch over every shard (``ShardMapSearch``,
  ``ShardMapBM25``, ``ShardMapPivot``): each shard's run of cursors is
  staged on its device and the already-ported kernels launch there, every
  shard is enqueued before any is fetched, then the results scatter back.
  ``"auto"`` builds ``[cuda:0 .. cuda:S-1]`` when the process sees S cards
  and otherwise means None: the engines then serve shards as a host-side
  loop over per-shard ``EngineCore``\\ s on the engine's device -- same
  results, same routing.
* **replication + health**: with ``replicas=R`` replica r of list t lives
  on ``(splitmix64(t) + r) % n_shards``.  ``route()`` honours a mutable
  per-shard ``dead`` mask: the primary when live (so the no-fault path is
  byte-identical to R=1), else the first live replica; lists with no live
  replica come back unserved (``ShardsUnavailable``).

An empty shard (no lists hash to it) is a valid degenerate sub-arena: its
``list_blk_offsets`` are all zero and it never receives a cursor, so no
kernel is ever launched for it.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .. import obs
from ..api import shard_mesh_devices
from ..kernels.blockmax_pivot.kernel import QMIN_NONE
from ..kernels.bm25_score.kernel import bm25_score_probe
from ..kernels.vbyte_decode.kernel import BLOCK_VALS, decode_search
from .arena import CODEC_EF, DeviceArena, RankedSidecar

def shard_of_list(lists: np.ndarray, n_shards: int) -> np.ndarray:
    """Owning shard per list id: splitmix64 finalizer mod n_shards.

    A multiplicative bit-mix, not ``t % n_shards``: corpora routinely have
    structured list ids and a plain mod would pile hot lists onto one shard.
    """
    x = np.asarray(lists, dtype=np.uint64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    x = x ^ (x >> np.uint64(31))
    return (x % np.uint64(n_shards)).astype(np.int64)


class ShardsUnavailable(RuntimeError):
    """Raised when routing finds lists with NO live replica shard."""

    def __init__(self, lists):
        self.lists = np.asarray(lists, dtype=np.int64)
        super().__init__(f"no live replica serves lists {self.lists.tolist()}")


def replica_owners(n_lists: int, n_shards: int, replicas: int) -> np.ndarray:
    """[R, n_lists] owning shard of each list's replicas (row 0 = primary).

    Replica r of list t lives on ``(shard_of_list(t) + r) % n_shards`` -- a
    pure function of (t, r, S).
    """
    primary = shard_of_list(np.arange(n_lists, dtype=np.int64), n_shards)
    r = np.arange(replicas, dtype=np.int64)
    return (primary[None, :] + r[:, None]) % n_shards


def local_map_of(lists_s: np.ndarray, n_lists: int) -> np.ndarray:
    """Global -> shard-local list-id map for one shard's ascending lists."""
    m = np.zeros(n_lists, np.int64)
    m[lists_s] = np.arange(len(lists_s), dtype=np.int64)
    return m


def make_shard_mesh(n_shards: int, device="cuda"):
    """One CUDA device per shard, ``[cuda:0 .. cuda:S-1]``; None when the
    engine does not serve on CUDA or the process sees fewer than S cards
    (the engines then loop over shards instead)."""
    if device is None or torch.device(device).type != "cuda":
        return None
    if torch.cuda.device_count() < n_shards:
        return None
    return [torch.device("cuda", i) for i in range(n_shards)]


@dataclass
class ShardedArena:
    """The global arena list-hash-split into per-shard sub-arenas.

    Routing metadata (``owner`` / ``local_list`` / ``lists_of``) is built
    eagerly -- it is O(n_lists).  The sub-arena SLICES materialize lazily on
    first ``shards`` access: a numpy engine built with ``shards=N`` never
    routes, so it never pays for N arena copies either.  ``device`` is the
    engine's device (None on the numpy backend): where the host loop's
    per-shard tensors live.
    """

    n_shards: int
    arena: DeviceArena                  # the global (unsharded) arena
    owner: np.ndarray                   # [n_lists] primary shard per list
    local_list: np.ndarray              # [n_lists] id within the primary
    lists_of: list[np.ndarray]          # per shard: global list ids, asc
    mesh: list | None = None            # one torch device per shard, or None
    replicas: int = 1                   # copies of each list (R <= S)
    owner_r: np.ndarray | None = None   # [R, n_lists] replica owners
    local_r: np.ndarray | None = None   # [R, n_lists] local id per replica
    dead: np.ndarray | None = None      # [S] bool, honoured by route()
    device: object = None               # the host loop's device
    _shards: list | None = field(default=None, repr=False, compare=False)
    _dev_shards: list | None = field(default=None, repr=False, compare=False)
    _rows_of: list | None = field(default=None, repr=False, compare=False)
    _pchunks: list | None = field(default=None, repr=False, compare=False)
    _dev_pivots: list | None = field(default=None, repr=False, compare=False)

    @classmethod
    def build(cls, arena: DeviceArena, n_shards: int, mesh="auto",
              replicas: int = 1, device=None):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        # R > S would place two copies of a list on one shard: clamp
        replicas = min(int(replicas), n_shards)
        n_lists = len(arena.list_blk_offsets) - 1
        owner_r = replica_owners(n_lists, n_shards, replicas)
        local_r = np.zeros((replicas, n_lists), np.int64)
        lists_of = []
        for s in range(n_shards):
            lists_s = np.flatnonzero((owner_r == s).any(axis=0))
            lists_of.append(lists_s)
            for r in range(replicas):
                sel = np.flatnonzero(owner_r[r] == s)
                local_r[r, sel] = np.searchsorted(lists_s, sel)
        mesh = shard_mesh_devices(mesh, n_shards)
        if arena.block_codec is not None:
            # the device-list dispatch is single-codec: multi-codec arenas
            # serve shards through the host loop (per-shard EngineCores
            # dispatch per codec); an explicit device list cannot be met
            if mesh not in ("auto", None):
                raise ValueError("shard_mesh is single-codec; multi-codec "
                                 "arenas use the host shard loop "
                                 "(shard_mesh=None)")
            mesh = None
        if isinstance(mesh, str):
            mesh = make_shard_mesh(n_shards, device)
        return cls(
            n_shards=n_shards,
            arena=arena,
            owner=owner_r[0],
            local_list=local_r[0],
            lists_of=lists_of,
            mesh=mesh,
            replicas=replicas,
            owner_r=owner_r,
            local_r=local_r,
            dead=np.zeros(n_shards, bool),
            device=None if device is None else torch.device(device),
        )

    # ------------------------------------------------------------------
    # health-aware routing
    # ------------------------------------------------------------------
    def route(self, terms) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(owner, local, served) per term, honouring the ``dead`` mask.

        Picks each term's FIRST live replica (primary preferred, so the
        no-fault routing is byte-identical to ``replicas=1``); ``served``
        is False where no live replica exists.
        """
        terms = np.asarray(terms, dtype=np.int64)
        if self.owner_r is None or not self.dead.any():
            return self.owner[terms], self.local_list[terms], np.ones(len(terms), bool)
        own = self.owner_r[:, terms]
        alive = ~self.dead[own]
        served = alive.any(axis=0)
        pick = np.argmax(alive, axis=0)
        idx = np.arange(own.shape[1])
        return own[pick, idx], self.local_r[:, terms][pick, idx], served

    def route_one(self, t: int) -> tuple[int, int]:
        """Single-term routing; raises ``ShardsUnavailable`` if unserved."""
        owner, local, served = self.route(np.asarray([t], dtype=np.int64))
        if not served[0]:
            raise ShardsUnavailable([t])
        return int(owner[0]), int(local[0])

    def unserved_lists(self) -> np.ndarray:
        """Global list ids with NO live replica under the ``dead`` mask."""
        if self.owner_r is None or not self.dead.any():
            return np.zeros(0, np.int64)
        return np.flatnonzero(self.dead[self.owner_r].all(axis=0))

    @property
    def shards(self) -> list[DeviceArena]:
        """Per-shard sub-arenas (materialized on first access)."""
        n_lists = len(self.arena.list_blk_offsets) - 1
        if self._shards is None:
            self._shards = [
                _slice_arena(self.arena, lists_s, local_map_of(lists_s, n_lists))
                for lists_s in self.lists_of
            ]
        return self._shards

    @property
    def rows_of(self) -> list[np.ndarray]:
        """Per shard: the GLOBAL arena row of each shard-local row (the
        merge half of the pivot dispatch)."""
        if self._rows_of is None:
            lob = self.arena.part_list[self.arena.part_of_block]
            n_lists = len(self.arena.list_blk_offsets) - 1
            rows = []
            # membership, not owner equality: with replicas a global row
            # belongs to EVERY shard holding a copy of its list
            for lists_s in self.lists_of:
                in_s = np.zeros(n_lists, bool)
                in_s[lists_s] = True
                rows.append(np.flatnonzero(in_s[lob]))
            self._rows_of = rows
        return self._rows_of

    @property
    def pivot_chunks(self) -> list:
        """Per shard: the ``PivotChunks`` bound tiles of its sub-arena."""
        if self._pchunks is None:
            from .engine_core import build_pivot_chunks

            # an evicted (dead) shard keeps its hole
            self._pchunks = [None if sub is None else build_pivot_chunks(sub)
                             for sub in self.shards]
        return self._pchunks

    @property
    def all_device_ok(self) -> bool:
        """The reference's per-shard int32-key gate, from the routing
        metadata alone (the slices are not materialized).  Kept beside
        each sub-arena's ``device_ok`` for parity: the torch path locates
        over int64 keys and reads the shared stride's ``stride_ok``."""
        nl_m = max((len(f) for f in self.lists_of), default=0)
        return bool((nl_m + 1) * self.arena.stride < 2**31 - BLOCK_VALS - 2)

    def shard_nbytes(self) -> list[int]:
        return [sub.nbytes() for sub in self.shards]

    def shard_device_nbytes(self) -> list[int]:
        """Bytes each shard holds on its device (its sub-arena, plus its
        bound tiles where the pivot staged them); 0 off the device."""
        def held(*parts):
            return [t for p in parts if p is not None for t in vars(p).values()]

        out = []
        for s in range(self.n_shards):
            if self._dev_shards is not None:
                ts = held(self._dev_shards[s], self._dev_pivots
                          and self._dev_pivots[s])
            elif self.device is not None and self._shards is not None:
                sub = self._shards[s]
                pc = self._pchunks[s] if self._pchunks is not None else None
                ts = held(sub and sub._dev.get(str(self.device)),
                          pc and pc._dev.get(str(self.device)))
            else:
                ts = []
            out.append(sum(t.numel() * t.element_size() for t in ts))
        return out

    # ------------------------------------------------------------------
    # one-device-per-shard placement for the device-list dispatch
    # ------------------------------------------------------------------
    def device_shards(self) -> list:
        """Each shard's sub-arena tensors on its device, uploaded once.

        The host sub-arena slices existed only to feed the upload: on the
        device-list path nothing reads them afterwards, so they are
        released (the ``shards`` property rebuilds them on demand).
        """
        if self._dev_shards is None:
            if self.mesh is None:
                raise ValueError("device_shards() needs a device list")
            self._dev_shards = [
                None if sub is None else sub.on(dev)
                for sub, dev in zip(self.shards, self.mesh)
            ]
            self._shards = None
        return self._dev_shards

    def device_pivots(self) -> list:
        """Each shard's pivot bound tiles on its device, staged LAZILY and
        separately: only kernel-resident ranked engines read them."""
        if self._dev_pivots is None:
            if self.mesh is None:
                raise ValueError("device_pivots() needs a device list")
            self._dev_pivots = [
                None if pc is None else pc.on(dev)
                for pc, dev in zip(self.pivot_chunks, self.mesh)
            ]
            if self._dev_shards is not None:
                self._shards = None
        return self._dev_pivots

    # ------------------------------------------------------------------
    # loss and re-admission of one shard (ResilientEngine)
    # ------------------------------------------------------------------
    def evict(self, s: int) -> None:
        """Drop shard ``s``'s sub-arena, bound tiles and device tensors
        (routing never targets a dead shard, so the holes are unread)."""
        for lst in (self._shards, self._dev_shards, self._pchunks,
                    self._dev_pivots):
            if lst is not None:
                lst[s] = None

    def install(self, s: int, sub: DeviceArena) -> None:
        """Re-slot a restored host sub-arena and upload it (and its bound
        tiles, where they were staged) to the shard's device.  Called at a
        batch boundary on the serving thread."""
        if self._shards is not None:
            self._shards[s] = sub
        if self._pchunks is not None:
            from .engine_core import build_pivot_chunks

            self._pchunks[s] = build_pivot_chunks(sub)
        if self.mesh is not None:
            if self._dev_shards is not None:
                self._dev_shards[s] = sub.on(self.mesh[s])
            if self._dev_pivots is not None:
                self._dev_pivots[s] = self._pchunks[s].on(self.mesh[s])
        elif self.device is not None:
            sub.on(self.device)
            if self._pchunks is not None:
                self._pchunks[s].on(self.device)


def _slice_arena(
    a: DeviceArena, lists_s: np.ndarray, local_list: np.ndarray
) -> DeviceArena:
    """Sub-arena of the lists in ``lists_s`` (ascending global ids).

    Pure gathers: the payload bytes, sidecars and lane masks of a shard are
    row for row the global ones, so a 1-shard slice reproduces the global
    arena exactly.  Only the locate keys are recomputed -- same global
    ``stride``, shard-LOCAL list ids.  Multi-codec arenas slice per codec:
    the shard's SVB rows and EF tiles are gathered through ``codec_row``,
    and shard-local codec rows are renumbered in block order.
    """
    in_shard = np.zeros(len(a.list_blk_offsets) - 1, bool)
    in_shard[lists_s] = True
    list_of_block = a.part_list[a.part_of_block]
    rows_s = np.flatnonzero(in_shard[list_of_block])
    parts_s = np.flatnonzero(in_shard[a.part_list])
    n_blk_s = a.n_blk[parts_s]
    first_blk_s = np.zeros(len(parts_s), np.int64)
    if len(parts_s):
        first_blk_s[1:] = np.cumsum(n_blk_s)[:-1]
    part_list_s = local_list[a.part_list[parts_s]]
    part_of_block_s = np.repeat(np.arange(len(parts_s), dtype=np.int64), n_blk_s)
    block_last = a.block_keys[rows_s] - list_of_block[rows_s] * a.stride
    blk_counts = a.list_blk_offsets[lists_s + 1] - a.list_blk_offsets[lists_s]
    list_blk_offsets_s = np.zeros(len(lists_s) + 1, np.int64)
    np.cumsum(blk_counts, out=list_blk_offsets_s[1:])
    ranked = None
    if a.ranked is not None:
        r = a.ranked
        ranked = RankedSidecar(
            freq_lens=r.freq_lens[rows_s],
            freq_data=r.freq_data[rows_s],
            norm_q=r.norm_q[rows_s],
            block_max_q=r.block_max_q[rows_s],
            bound_scale=r.bound_scale,
            idf=r.idf[lists_s],
            list_ub=r.list_ub[lists_s],
            kmin=r.kmin,
            kstep=r.kstep,
            norm_table=r.norm_table,
            params=r.params,
        )
    block_codec_s = codec_row_s = ef_lo_s = ef_hi_s = ef_lbits_s = None
    if a.block_codec is None:
        lens_s, data_s = a.lens[rows_s], a.data[rows_s]
    else:
        block_codec_s = a.block_codec[rows_s]
        cr = a.codec_row[rows_s]
        ef_m = block_codec_s == CODEC_EF
        codec_row_s = np.zeros(len(rows_s), np.int64)
        codec_row_s[~ef_m] = np.arange(int((~ef_m).sum()))
        codec_row_s[ef_m] = np.arange(int(ef_m.sum()))
        lens_s, data_s = a.lens[cr[~ef_m]], a.data[cr[~ef_m]]
        ef_lo_s = a.ef_lo[cr[ef_m]]
        ef_hi_s = a.ef_hi[cr[ef_m]]
        ef_lbits_s = a.ef_lbits[cr[ef_m]]
    return DeviceArena(
        lens=lens_s,
        data=data_s,
        block_base=a.block_base[rows_s],
        block_keys=block_last + part_list_s[part_of_block_s] * a.stride,
        lane_valid=a.lane_valid[rows_s],
        part_of_block=part_of_block_s,
        first_blk=first_blk_s,
        n_blk=n_blk_s,
        sizes=a.sizes[parts_s],
        bases=a.bases[parts_s],
        part_list=part_list_s,
        list_blk_offsets=list_blk_offsets_s,
        stride=a.stride,
        n_blocks=len(rows_s),
        device_ok=bool((len(lists_s) + 1) * a.stride < 2**31 - BLOCK_VALS - 2),
        ranked=ranked,
        block_codec=block_codec_s,
        codec_row=codec_row_s,
        ef_lo=ef_lo_s,
        ef_hi=ef_hi_s,
        ef_lbits=ef_lbits_s,
    )


# --------------------------------------------------------------------------
# device-list dispatchers: every shard of a batch in one dispatch
# --------------------------------------------------------------------------
class _ShardMapDispatch:
    """Shared staging/merge for the device-list dispatchers.

    ``__call__(local_terms, probes, cuts)`` takes cursors PRE-SORTED by
    owning shard (``cuts`` delimiting each shard's run, as produced by the
    engines' stable argsort over owners).  Each shard's run is staged as
    int32 on that shard's device -- the int32 probe clip happens on the
    host, before staging -- and its kernels are launched there; every shard
    is enqueued before any result is fetched, and the fetched runs scatter
    back in cursor order.  No padding: a shard gets exactly its cursors,
    and a shard without cursors (or without blocks) gets no launch.
    """

    def __init__(self, sharded: ShardedArena, max_bucket: int | None = None,
                 injector=None):
        if sharded.mesh is None:
            raise ValueError("the device-list dispatch needs a shard_mesh "
                             "with one device per shard")
        self.sharded = sharded
        # shard-dispatch fault boundary: a ShardFaultInjector consulted per
        # dispatch for every shard that receives cursors -- the mirror of
        # the per-shard EngineCore check
        self.injector = injector
        self.stride = sharded.arena.stride
        # per-shard cursor cap PER DISPATCH: batches whose fullest shard
        # exceeds it run in rounds, so staged buffers stay bounded
        self.max_bucket = max_bucket

    def _clip_probes(self, p):
        # clip BEFORE the int32 staging cast (probes >= 2^31 must resolve
        # past-the-end after the merge, not wrap negative)
        return np.clip(p, 0, self.stride - 1)

    def _arrs(self, s: int):
        """Shard ``s``'s resident tensors this dispatcher reads, or None
        when the shard holds nothing to search."""
        sub_dev = self.sharded.device_shards()[s]
        return sub_dev if sub_dev.block_keys.shape[0] else None

    def _body(self, arrs, terms, probes) -> tuple:
        raise NotImplementedError

    def _empty(self, n: int) -> tuple:
        """Host results of ``n`` cursors on a shard with nothing to search."""
        raise NotImplementedError

    def _dispatch(self, local_terms, probes, cuts):
        pending = []
        for s, dev in enumerate(self.sharded.mesh):
            lo, hi = int(cuts[s]), int(cuts[s + 1])
            if lo == hi:
                continue
            arrs = self._arrs(s)
            if arrs is None:
                pending.append((lo, hi, None))
                continue
            t = torch.from_numpy(
                np.ascontiguousarray(local_terms[lo:hi], dtype=np.int32)
            ).to(dev)
            p = torch.from_numpy(
                np.ascontiguousarray(self._clip_probes(probes[lo:hi]),
                                     dtype=np.int32)
            ).to(dev)
            pending.append((lo, hi, self._body(arrs, t, p)))
        n = int(cuts[-1])
        outs = None
        for lo, hi, res in pending:
            host = (self._empty(hi - lo) if res is None
                    else [r.cpu().numpy() for r in res])
            if outs is None:
                outs = [np.empty((n,) + h.shape[1:], h.dtype) for h in host]
            for o, h in zip(outs, host):
                o[lo:hi] = h
        return outs if outs is not None else list(self._empty(0))

    def __call__(self, local_terms, probes, cuts):
        counts = np.diff(cuts)
        if self.injector is not None:
            self.injector.check_shards(np.flatnonzero(counts > 0))
        if obs.enabled():
            kind = type(self).__name__
            for s in np.flatnonzero(counts > 0):
                obs.count(
                    "shard_dispatch", shard=str(int(s)), path="shard_map", kind=kind
                )
        local_terms = np.asarray(local_terms)
        probes = np.asarray(probes)
        mb = self.max_bucket
        if mb is None or len(counts) == 0 or int(counts.max()) <= mb:
            return self._dispatch(local_terms, probes, cuts)
        # round r takes cursors [cuts[s] + r*mb, +mb) of EVERY shard, so no
        # dispatch stages more than max_bucket cursors per shard
        n = int(cuts[-1])
        outs = None
        for r in range(-(-int(counts.max()) // mb)):
            lo = np.minimum(cuts[:-1] + r * mb, cuts[1:])
            hi = np.minimum(lo + mb, cuts[1:])
            idx = np.concatenate([np.arange(int(a), int(b)) for a, b in zip(lo, hi)])
            sub_cuts = np.zeros(len(cuts), np.int64)
            np.cumsum(hi - lo, out=sub_cuts[1:])
            res = self._dispatch(local_terms[idx], probes[idx], sub_cuts)
            if outs is None:
                outs = [np.empty((n,) + o.shape[1:], o.dtype) for o in res]
            for o, ro in zip(outs, res):
                o[idx] = ro
        return outs


class ShardMapSearch(_ShardMapDispatch):
    """Fused locate -> decode_search over every shard in one dispatch.

    Returns (value, rank) int64 arrays aligned with the sorted cursor
    order; past-the-end cursors are pre-masked to -1 (the contract of the
    unsharded device pipeline).
    """

    def _body(self, d, terms, probes):
        from .engine_core import locate_graph

        nb = d.block_keys.shape[0]
        rows, pe, past = locate_graph(
            d.block_keys, d.list_blk_offsets, self.stride, nb, terms, probes
        )
        value, rank_in = decode_search(d.lens, d.data, d.block_base, rows, pe)
        part = d.part_of_block[rows.long()]
        rank = (rows - d.first_blk[part.long()]) * BLOCK_VALS + rank_in
        return torch.where(past, -1, value), torch.where(past, -1, rank)

    def _empty(self, n):
        return np.full(n, -1, np.int32), np.full(n, -1, np.int32)

    def __call__(self, local_terms, probes, cuts):
        value, rank = super().__call__(local_terms, probes, cuts)
        return value.astype(np.int64), rank.astype(np.int64)


class ShardMapBM25(_ShardMapDispatch):
    """Fused bm25 locate -> decode+score+match over every shard at once.

    Returns f32 contributions aligned with the sorted cursor order (0.0
    past the end / non-member, as the unsharded device pipeline).
    """

    def __init__(self, sharded, k1p1: float, max_bucket: int | None = None,
                 injector=None):
        if sharded.arena.ranked is None:
            raise ValueError("ShardMapBM25 needs a ranked arena")
        super().__init__(sharded, max_bucket=max_bucket, injector=injector)
        self.k1p1 = np.float32(k1p1)

    def _body(self, d, terms, probes):
        from .engine_core import locate_graph

        nb = d.block_keys.shape[0]
        rows, pe, past = locate_graph(
            d.block_keys, d.list_blk_offsets, self.stride, nb, terms, probes
        )
        contrib = bm25_score_probe(
            d.lens, d.data, d.block_base, None, d.freq_lens, d.freq_data,
            d.norm_q, d.idf, d.lob, d.norm_table, self.k1p1, rows, pe,
        )
        return (torch.where(past, 0.0, contrib),)

    def _empty(self, n):
        return (np.zeros(n, np.float32),)

    def __call__(self, local_terms, probes, cuts):
        (contrib,) = super().__call__(local_terms, probes, cuts)
        return contrib


class ShardMapPivot(_ShardMapDispatch):
    """Block-Max pivot selection over every shard in one dispatch.

    Cursors here are (shard-local chunk row, qmin tile) pairs -- the
    "probe" slot carries the per-(query, term) minimal admissible bound
    codes the host reduced from theta, so broadcasting a new theta to every
    shard is just staging fresh qmins.  Returns (compact [n, 128], count
    [n], pivot [n], maxq [n]) int64 aligned with the sorted cursor order;
    ``compact`` lists each cursor's surviving SHARD-LOCAL block lanes
    (callers map lane -> local row -> global row via ``PivotChunks.base``
    and ``ShardedArena.rows_of``).
    """

    PAD_PROBE = QMIN_NONE

    def __init__(self, sharded, max_bucket=None, injector=None):
        if sharded.arena.ranked is None:
            raise ValueError("ShardMapPivot needs a ranked arena")
        super().__init__(sharded, max_bucket=max_bucket, injector=injector)

    def _clip_probes(self, p):
        # qmins are bound codes in [0, QMIN_NONE], not docIDs: clip to the
        # code range (the docID clip could LOWER a qmin on tiny-stride
        # corpora and desync the sharded kept set from the unsharded one)
        return np.clip(p, 0, self.PAD_PROBE)

    def _arrs(self, s):
        # only the bound tiles, staged lazily and separately from the
        # search/bm25 tensors (ShardedArena.device_pivots)
        pcd = self.sharded.device_pivots()[s]
        return pcd if pcd.qb.shape[0] else None

    def _body(self, pcd, rows, qmins):
        from .engine_core import pivot_graph

        return pivot_graph(pcd, rows, qmins)

    def _empty(self, n):
        return (np.full((n, BLOCK_VALS), -1, np.int32), np.zeros(n, np.int32),
                np.full(n, -1, np.int32), np.zeros(n, np.int32))

    def __call__(self, local_rows, qmins, cuts):
        compact, count, pivot, maxq = super().__call__(local_rows, qmins, cuts)
        return (
            compact.astype(np.int64),
            count.astype(np.int64),
            pivot.astype(np.int64),
            maxq.astype(np.int64),
        )
