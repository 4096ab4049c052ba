"""Flat-mirror / locate / dispatch machinery of the batched engine.

Counterpart of ``repro/core/engine_core.py``.  A batch of (term, probe)
cursors is served by locating each cursor's arena row with ONE
searchsorted over globally monotone keys, then resolving the cursor
inside the located row.  The ranked engine adds the Block-Max pivot
halves (``pivot_graph``, ``pivot_score_graph``) over the bound-chunk
table (``PivotChunks``) and the per-lane impact mirror
(``lane_scores_fn`` -> ``flat_scores``).
One ``EngineCore`` serves ONE ``DeviceArena`` -- the sharded engines hold
a core per shard (see ``repro_torch.core.shard``) and route cursors
between them; ``shard_id`` / ``injector`` make such a core a shard
dispatch boundary for fault injection.

The subtleties, kept exactly as the reference has them:

* **padding clamp** (``flat_init``): the flat lane keys extend the arena's
  block keys to lane granularity as ``min(value, block_last) + owning_list *
  stride``.  Padding lanes keep ascending past the partition endpoint, so
  WITHOUT the ``min`` they would overtake the next partition's keys and
  break global monotonicity.

* **int32 probe clip** (``stage_cursors``): the device pipeline stages
  cursors as int32.  Probes are clipped to ``[0, stride - 1]`` BEFORE the
  cast -- an int64 probe >= 2^31 must resolve as past-the-end, not wrap
  negative and clip to probe 0.

* **int64 keys** (``locate_graph``): terms and probes fit int32 once the
  stride does (``DeviceArena.stride_ok``), but ``probe + term * stride``
  reaches ``(n_lists + 1) * stride``, so the locate forms its keys in
  int64 against the arena's int64 ``block_keys``.  The TPU reference keeps
  int32 keys (x64 off) and serves a wider index from the host.

* **sentinel lane** (``flat_init``): one extra lane (value -1, key int64
  max) keeps a past-the-end searchsorted result a valid gather index;
  callers mask with ``lane_end`` afterwards.

* **pow2 buckets** (``pow2_bucket``): device cursor counts are padded to
  power-of-two buckets, so batch shapes repeat; padding cursors probe list
  0 at docID 0 and are sliced away.

The ``"torch"`` backend keeps the arena resident on ``device`` and runs
locate -> decode_search / ef_search -> rank -> mask there, with exactly one
host sync per dispatch (the stacked result fetch).  On a CUDA device the
two search steps and every row decode are the hand-written kernels; on the
CPU their plain versions.  The ``"numpy"`` backend is the host mirror.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import obs
from ..api import resolve_backend, resolve_device
from ..kernels.blockmax_pivot.kernel import pivot_select
from ..kernels.ef_search.kernel import ef_search
from ..kernels.ef_search.ops import ef_decode_rows_np
from ..kernels.pivot_score.kernel import pivot_score
from ..kernels.vbyte_decode.kernel import BLOCK_VALS, BM, decode_blocks, decode_search
from ..kernels.vbyte_decode.ops import decode_blocks_np
from .arena import CODEC_EF

INT64_MAX = np.iinfo(np.int64).max


def pow2_bucket(n: int, floor: int = BM) -> int:
    """Power-of-two bucket holding ``n`` cursors (floor bounds the number
    of distinct batch shapes)."""
    return max(floor, 1 << (max(n, 1) - 1).bit_length())


def stage_cursors(terms, probes, stride: int, bucket: int):
    """Stage cursors into int32 host buffers of size ``bucket``.

    Padding cursors probe list 0 at docID 0.  The probe clip happens BEFORE
    the int32 cast (a probe >= 2^31 must clip to the maximum key and
    resolve past-the-end, not wrap negative).
    """
    n = len(terms)
    tp = np.zeros(bucket, np.int32)
    pp = np.zeros(bucket, np.int32)
    tp[:n] = terms
    pp[:n] = np.clip(probes, 0, stride - 1)
    return tp, pp


def group_cursors(terms, probes, stride: int):
    """Group duplicate (term, probe) cursors before a device dispatch.

    Returns ``(idx, inv)`` with ``terms[idx]`` the unique cursors and
    ``inv`` scattering results back, or ``None`` when every cursor is
    already unique.  The clip matches ``stage_cursors``.
    """
    key = np.clip(probes, 0, stride - 1) + terms * stride
    uk, idx, inv = np.unique(key, return_index=True, return_inverse=True)
    if len(uk) == len(terms):
        return None
    return idx, inv


def locate_graph(block_keys, list_blk_offsets, stride, nb, terms, probes):
    """Locate over resident int64 keys: ONE searchsorted.

    Maps int32 cursor tensors to ``(rows, pe, past)``: ``rows`` the int32
    arena row holding each cursor's answer (clamped in-range), ``pe`` the
    int32 effective probe (0 where past the end), ``past`` the past-the-end
    mask.  The keys are formed in int64: ``term * stride`` passes 2^31 on
    an index of more than ``2^31 / stride`` lists.
    """
    pc = probes.clamp(0, stride - 1)
    keys = pc.long() + terms.long() * stride
    k = torch.searchsorted(block_keys, keys, out_int32=True)
    past = k >= list_blk_offsets[terms.long() + 1]
    rows = k.clamp(max=nb - 1)
    pe = torch.where(past, 0, pc)
    return rows, pe, past


def pivot_graph(pc_dev, rows, qmins):
    """Block-Max pivot selection of chunk rows ``rows`` [n] int32 of the
    resident chunk table ``pc_dev`` (``PivotChunks.on``) against the
    per-cursor qmin tiles [n,128] int32 -> (compact, count, pivot, maxq),
    through the ``pivot_select`` kernel.  Integer contract."""
    return pivot_select(pc_dev.qb, pc_dev.nblk, qmins, rows)


def pivot_score_graph(pc_dev, dev, rows, qmins, k1p1):
    """Fused pivot + kept-slot scoring over the resident chunk table and
    the resident freq sidecar ``dev`` (``DeviceArena.on``): keep-test,
    compaction, pivot AND the scores of the first SCORE_SLOTS surviving
    blocks of every cursor come back from ONE ``pivot_score`` launch ->
    (compact, count, pivot, maxq, sscores)."""
    return pivot_score(
        pc_dev.qb, pc_dev.nblk, pc_dev.base, qmins, rows, dev.freq_lens,
        dev.freq_data, dev.norm_q, dev.idf, dev.lob, dev.norm_table, k1p1,
    )


@dataclass
class PivotChunks:
    """``block_max_q`` re-tiled into per-list 128-lane chunks.

    The pivot kernels consume bound CHUNKS -- up to 128 consecutive blocks
    of one list per row -- so the ranked sidecar's flat [n_blocks] u8
    array is re-tiled once per arena into a [n_chunks, 128] int32 table
    plus per-chunk metadata.  Chunks never span lists; a list with b
    blocks owns ceil(b / 128) consecutive chunk rows.
    """

    qb: np.ndarray  # [nc, 128] int32  block_max_q per lane (0 past nblk)
    nblk: np.ndarray  # [nc] int32  valid lanes in the chunk
    base: np.ndarray  # [nc] int64  arena row of lane 0
    offsets: np.ndarray  # [n_lists + 1] int64  chunk range per list
    _dev: dict = field(default_factory=dict, repr=False, compare=False)

    def on(self, device):
        """int32 tensors of the gatherable halves on ``device``, uploaded
        once per device."""
        device = torch.device(device)
        got = self._dev.get(str(device))
        if got is None:
            from types import SimpleNamespace

            def up(x):
                return torch.from_numpy(
                    np.ascontiguousarray(x, dtype=np.int32)
                ).to(device)

            got = SimpleNamespace(qb=up(self.qb), nblk=up(self.nblk),
                                  base=up(self.base))
            self._dev[str(device)] = got
        return got


def build_pivot_chunks(arena) -> PivotChunks:
    """Re-tile one arena's ``block_max_q`` into ``PivotChunks``."""
    r = arena.ranked
    if r is None:
        raise ValueError("pivot chunks need a ranked arena")
    counts = np.diff(arena.list_blk_offsets)
    nch = -(-counts // BLOCK_VALS)  # ceil: chunks per list
    offsets = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(nch, out=offsets[1:])
    nc = int(offsets[-1])
    if nc == 0:
        return PivotChunks(
            qb=np.zeros((0, BLOCK_VALS), np.int32),
            nblk=np.zeros(0, np.int32),
            base=np.zeros(0, np.int64),
            offsets=offsets,
        )
    list_of_chunk = np.repeat(np.arange(len(counts), dtype=np.int64), nch)
    k_in = np.arange(nc, dtype=np.int64) - offsets[list_of_chunk]
    base = arena.list_blk_offsets[list_of_chunk] + k_in * BLOCK_VALS
    nblk = np.minimum(
        counts[list_of_chunk] - k_in * BLOCK_VALS, BLOCK_VALS
    ).astype(np.int32)
    lane = np.arange(BLOCK_VALS, dtype=np.int64)
    rows = np.minimum(base[:, None] + lane[None, :], arena.n_blocks - 1)
    qb = np.where(
        lane[None, :] < nblk[:, None], r.block_max_q[rows], 0
    ).astype(np.int32)
    return PivotChunks(qb=qb, nblk=nblk, base=base, offsets=offsets)


def decode_rows_values(arena, rows, backend: str, device=None) -> np.ndarray:
    """[len(rows), 128] absolute docIDs of arena block rows, codec-aware.

    THE row decode of the stack: every flat-mirror build, row-cache miss
    and list decode funnels through here.  Stream-VByte rows decode with
    the host mirror (``"numpy"``) or the ``decode_blocks`` kernel on the
    resident arena (``"torch"``); EF tiles decode on the host, as in the
    reference.  Multi-codec arenas bucket the rows by ``block_codec`` and
    scatter back in row order.
    """
    a = arena
    rows = np.asarray(rows, dtype=np.int64)
    out = np.empty((len(rows), BLOCK_VALS), np.int64)
    if a.block_codec is None:
        svb_j, ef_j = np.arange(len(rows)), np.zeros(0, np.int64)
        sr = rows
    else:
        is_ef = a.block_codec[rows] == CODEC_EF
        svb_j, ef_j = np.nonzero(~is_ef)[0], np.nonzero(is_ef)[0]
        sr = a.codec_row[rows]
    if len(svb_j):
        r = sr[svb_j]
        base = a.block_base[rows[svb_j]]
        if backend == "numpy":
            gaps = decode_blocks_np(a.lens[r], a.data[r])
            out[svb_j] = base[:, None] + np.cumsum(gaps + 1, axis=1)
        else:
            dev = a.on(device)
            gaps = decode_blocks(
                dev.lens, dev.data,
                torch.from_numpy(r.astype(np.int32)).to(device),
            )
            vals = torch.cumsum(gaps.long() + 1, 1)
            vals += torch.from_numpy(base).to(device)[:, None]
            out[svb_j] = vals.cpu().numpy()
    if len(ef_j):
        r = sr[ef_j]
        out[ef_j] = ef_decode_rows_np(
            a.ef_lo[r], a.ef_hi[r], a.ef_lbits[r], a.block_base[rows[ef_j]]
        )
    return out


class EngineCore:
    """Flat-mirror / locate / dispatch machinery over ONE ``DeviceArena``.

    Parameters
    ----------
    arena: the ``DeviceArena`` to serve (global, or one shard's sub-arena).
    backend: "auto" (= "torch") | "torch" | "numpy".
    device: torch device of the "torch" backend (a CUDA device must exist
        when one is named).
    cache_parts / cache_bytes: bounds of the decoded-row LRU; cache_bytes
        also gates the flat mirror (None = unbudgeted, always build it).
    mirror_backend: backend used to DECODE the flat mirror (None = same as
        ``backend``; TopKEngine passes "numpy" -- values are exact ints and
        the mirror is a host structure whatever the scoring backend).
    lane_scores_fn: optional ``() -> [n_blocks, 128] float32`` scoring every
        arena lane; when given, ``flat_init`` masks padding lanes to 0 and
        keeps the flat per-lane score mirror (TopKEngine's impact mirror).
    stats: optional dict to count into; missing keys are created.
    shard_id / injector: when this core serves one shard of a
        ``ShardedArena``, the ``ShardFaultInjector`` consulted at every
        fused dispatch (the host-loop shard boundary).
    """

    def __init__(
        self,
        arena,
        backend: str = "auto",
        device="cuda",
        cache_parts: int = 32_768,
        cache_bytes: int | None = None,
        mirror_backend: str | None = None,
        lane_scores_fn=None,
        stats: dict | None = None,
        shard_id: int | None = None,
        injector=None,
    ):
        self.arena = arena
        # host-loop shard-dispatch fault boundary: the mirror of the
        # device-list dispatchers' check in core.shard
        self.shard_id = shard_id
        self.injector = injector
        self.backend = resolve_backend(backend)
        if self.backend not in ("torch", "numpy"):
            raise ValueError(f"unknown backend {backend!r}")
        self.device = None
        if self.backend == "torch":
            if not arena.stride_ok:
                raise RuntimeError(
                    f"arena.stride_ok is False: stride {arena.stride} (the "
                    "largest docID + 2) is not below 2^31 - 130, so the "
                    "kernels' int32 docIDs cannot hold this index and the "
                    "torch backend cannot serve it; use backend='numpy' for "
                    "the host path"
                )
            self.device = resolve_device(device)
        self.cache_parts = int(cache_parts)
        self.cache_bytes = None if cache_bytes is None else int(cache_bytes)
        self.mirror_backend = mirror_backend or self.backend
        self.lane_scores_fn = lane_scores_fn
        self.stats = stats if stats is not None else obs.CounterDict("engine")
        for key in ("decoded_rows", "kernel_calls", "cache_hits", "evictions"):
            self.stats.setdefault(key, 0)
        self.cache: OrderedDict = OrderedDict()
        self.cache_nbytes = 0
        # flat mirror: decoded lane values + global lane keys (+ scores)
        self.flat_vals: np.ndarray | None = None
        self.flat_keys: np.ndarray | None = None
        self.flat_scores: np.ndarray | None = None
        self.lane_end: np.ndarray | None = None
        self.flat_ok = None  # None = undecided, False = budget refused

    # ------------------------------------------------------------------
    # LRU cache (decoded rows / partitions / lists), byte- and count-bounded
    # ------------------------------------------------------------------
    def cache_get(self, key):
        """Cached array for ``key`` (LRU-touched, hit-counted) or None."""
        got = self.cache.get(key)
        if got is not None:
            self.cache.move_to_end(key)
            self.stats["cache_hits"] += 1
        return got

    def cache_put(self, key, arr: np.ndarray) -> None:
        old = self.cache.pop(key, None)
        if old is not None:
            self.cache_nbytes -= old.nbytes
        self.cache[key] = arr
        self.cache_nbytes += arr.nbytes
        limit = np.inf if self.cache_bytes is None else self.cache_bytes
        while self.cache and (
            len(self.cache) > self.cache_parts or self.cache_nbytes > limit
        ):
            _, ev = self.cache.popitem(last=False)
            self.cache_nbytes -= ev.nbytes
            self.stats["evictions"] += 1

    def decode_rows(self, rows) -> np.ndarray:
        """``decode_rows_values`` on this core's backend and device."""
        return decode_rows_values(self.arena, rows, self.backend, self.device)

    # ------------------------------------------------------------------
    # host flat mirror: decoded lane docIDs + lane keys
    # ------------------------------------------------------------------
    def flat_init(self) -> bool:
        """Decode the arena once into flat (values, lane keys[, scores]).

        Lane keys extend the arena's block keys to lane granularity with the
        padding clamp described in the module docstring; one searchsorted
        over them subsumes BOTH locate steps.  Gated on ``cache_bytes``
        (2 x 1 KiB per block) when a budget is set.
        """
        if self.flat_keys is None and self.flat_ok is None:
            a = self.arena
            if (
                self.cache_bytes is not None
                and 2 * a.n_blocks * BLOCK_VALS * 8 > self.cache_bytes
            ):
                self.flat_ok = False  # budget refused: per-call decode
                return False
            with obs.span("flat_init", backend=self.mirror_backend):
                vals = decode_rows_values(
                    a, np.arange(a.n_blocks, dtype=np.int64),
                    self.mirror_backend, self.device,
                )
            self.stats["kernel_calls"] += 1
            self.stats["decoded_rows"] += a.n_blocks
            # one sentinel lane so a past-the-end searchsorted result is
            # still a valid gather index (masked via lane_end afterwards)
            self.flat_vals = np.append(vals.reshape(-1), -1)
            list_of_block = a.part_list[a.part_of_block]
            self.flat_keys = np.append(
                np.minimum(
                    vals + (list_of_block * a.stride)[:, None],
                    a.block_keys[:, None],
                ).reshape(-1),
                INT64_MAX,
            )
            self.lane_end = a.list_blk_offsets * BLOCK_VALS
            if self.lane_scores_fn is not None and a.n_blocks:
                scores = np.where(
                    a.lane_valid, self.lane_scores_fn(), np.float32(0.0)
                )
                self.flat_scores = np.append(
                    scores.reshape(-1).astype(np.float32), np.float32(0.0)
                )
            if self.cache_bytes is not None:
                # the flat arrays spend part of the decoded-bytes budget:
                # LRU entries (decoded rows / lists) only get the remainder
                self.cache_nbytes += self.flat_vals.nbytes + self.flat_keys.nbytes
            self.flat_ok = True
        return bool(self.flat_ok)

    def rows_values(self, rows: np.ndarray) -> np.ndarray:
        """[len(rows), 128] absolute docIDs of the given (unique) rows.

        With the flat mirror refused (over ``cache_bytes``), decoded rows go
        through the byte-budgeted LRU under ``("row", r)`` keys.  Rows the
        budget cannot hold are decoded, served, and dropped, with every drop
        counted in ``stats["evictions"]``.
        """
        if self.flat_init():
            return self.flat_vals[:-1].reshape(-1, BLOCK_VALS)[rows]
        rows = np.asarray(rows, dtype=np.int64)
        out = np.empty((len(rows), BLOCK_VALS), np.int64)
        miss_j: list[int] = []
        for j, rr in enumerate(rows):
            got = self.cache_get(("row", int(rr)))
            if got is None:
                miss_j.append(j)
            else:
                out[j] = got
        if miss_j:
            miss_rows = rows[miss_j]
            vals = self.decode_rows(miss_rows)
            self.stats["kernel_calls"] += 1
            self.stats["decoded_rows"] += len(miss_rows)
            out[miss_j] = vals
            # cache at most a budget's worth of this batch's rows (the most
            # recently decoded): a larger miss set would evict every entry
            # before it could be re-hit.  copy(): a view would pin the whole
            # batch's vals and void the byte accounting.
            bb = self.cache_bytes if self.cache_bytes is not None else 0
            cap = max(int(bb // (BLOCK_VALS * 8)), 1)
            for j in range(max(len(miss_rows) - cap, 0), len(miss_rows)):
                self.cache_put(("row", int(miss_rows[j])), vals[j].copy())
        return out

    def decode_list(self, t: int) -> np.ndarray:
        """All real docIDs of list ``t``, via the LRU cache."""
        key = ("list", int(t))
        got = self.cache_get(key)
        if got is not None:
            return got
        a = self.arena
        r0 = int(a.list_blk_offsets[t])
        r1 = int(a.list_blk_offsets[t + 1])
        if r0 == r1:
            return np.zeros(0, np.int64)
        rows = np.arange(r0, r1, dtype=np.int64)
        vals = self.rows_values(rows)
        out = vals.reshape(-1)[a.lane_valid[r0:r1].reshape(-1)]
        self.cache_put(key, out)
        return out

    # ------------------------------------------------------------------
    # fused locate -> resolve, host (numpy) path
    # ------------------------------------------------------------------
    def search_np(self, terms, probes, with_rank: bool = True, trusted: bool = False):
        """Host (numpy) fused pipeline: one searchsorted per batch.

        Returns UNMASKED (value, rank, past): callers apply their own mask.
        ``trusted`` skips the probe clip for probes that are known decoded
        docIDs (the AND filter feeds candidates straight back in).
        """
        a = self.arena
        pc = probes if trusted else np.clip(probes, 0, a.stride - 1)
        pk = pc + terms * a.stride
        if self.flat_init():
            self.stats["cache_hits"] += len(terms)
            pos = np.searchsorted(self.flat_keys, pk, side="left")
            past = pos >= self.lane_end[terms + 1]
            value = self.flat_vals[pos]  # sentinel lane keeps pos in range
            rank = None
            if with_rank:
                rows = np.minimum(pos, len(self.flat_keys) - 2) >> 7
                rank = pos - (a.first_blk[a.part_of_block[rows]] << 7)
            return value, rank, past
        k = np.searchsorted(a.block_keys, pk, side="left")
        past = k >= a.list_blk_offsets[terms + 1]
        rows = np.minimum(k, a.n_blocks - 1)
        pe = np.where(past, 0, pc)
        urows, inv = np.unique(rows, return_inverse=True)
        vals_u = self.rows_values(urows)  # [U, 128]
        base_u = a.block_base[urows]
        # rebased lane values are in [1, stride + 127]; stride2 clears them
        stride2 = a.stride + BLOCK_VALS + 2
        lane_keys = (
            vals_u - base_u[:, None]
            + np.arange(len(urows), dtype=np.int64)[:, None] * stride2
        ).reshape(-1)
        probe_keys = np.maximum(pe - base_u[inv], 1) + inv * stride2
        pos = np.searchsorted(lane_keys, probe_keys, side="left")
        value = vals_u.reshape(-1)[pos]
        rank = None
        if with_rank:
            rank_in = pos - inv * BLOCK_VALS
            part = a.part_of_block[rows]
            rank = (rows - a.first_blk[part]) * BLOCK_VALS + rank_in
        return value, rank, past

    # ------------------------------------------------------------------
    # fused locate -> decode_search / ef_search, resident device path
    # ------------------------------------------------------------------
    def _dispatch(self, ef: bool, terms, probes):
        """Stage one cursor bucket and resolve it on the device.

        locate -> the codec's search kernel -> partition rank -> mask, all
        on ``self.device``; the stacked (value, rank) fetch is the one host
        sync.
        """
        a = self.arena
        n = len(terms)
        if n == 0 or a.n_blocks == 0:
            # nothing to locate in (an empty shard): every cursor is past
            # the end, and no kernel is launched
            return np.full(n, -1, np.int64), np.full(n, -1, np.int64)
        dev = a.on(self.device)
        with obs.span("dispatch_stage"):
            tp, pp = stage_cursors(terms, probes, a.stride, pow2_bucket(n))
            # padding cursors repeat the first cursor: list 0 at docID 0 may
            # locate a block of the other codec, whose codec_row does not
            # index this kernel's tiles
            tp[n:], pp[n:] = tp[0], pp[0]
            t = torch.from_numpy(tp).to(self.device)
            p = torch.from_numpy(pp).to(self.device)
        rows, pe, past = locate_graph(
            dev.block_keys, dev.list_blk_offsets, a.stride, a.n_blocks, t, p
        )
        # multi-codec arenas store each codec's tiles compacted: the kernels
        # gather through codec_row (every cursor reaching a kernel was
        # bucketed onto a block of its codec by the host pre-pass)
        codec_row = dev.codec_row if a.multi else None
        if ef:
            value, rank_in = ef_search(
                dev.ef_lo, dev.ef_hi, dev.ef_lbits, dev.block_base, rows, pe,
                codec_row,
            )
        else:
            value, rank_in = decode_search(
                dev.lens, dev.data, dev.block_base, rows, pe, codec_row
            )
        part = dev.part_of_block[rows.long()]
        rank = (rows - dev.first_blk[part.long()]) * BLOCK_VALS + rank_in
        out = torch.stack(
            [torch.where(past, -1, value), torch.where(past, -1, rank)]
        )[:, :n].cpu().numpy().astype(np.int64)
        return out[0], out[1]

    def search_device(self, terms, probes):
        """Resident device pipeline over the arena: (value, rank), -1 past
        the end.

        Multi-codec arenas add a HOST pre-pass: the same searchsorted the
        device pipeline opens with, run on the host to read each located
        block's ``block_codec`` tag, buckets the cursors per codec; then ONE
        dispatch per codec resolves its bucket.  The scatter back into batch
        order is pure indexing, so results do not depend on the split.
        """
        a = self.arena
        if a.block_codec is None or a.n_blocks == 0:
            return self._dispatch(False, terms, probes)
        with obs.span("codec_split"):
            terms = np.asarray(terms, dtype=np.int64)
            probes = np.asarray(probes, dtype=np.int64)
            pc = np.clip(probes, 0, a.stride - 1)
            k = np.searchsorted(a.block_keys, pc + terms * a.stride, side="left")
            codec = a.block_codec[np.minimum(k, a.n_blocks - 1)]
            ef_j = np.nonzero(codec == CODEC_EF)[0]
        n = len(terms)
        if not len(ef_j):
            return self._dispatch(False, terms, probes)
        if len(ef_j) == n:
            return self._dispatch(True, terms, probes)
        svb_j = np.nonzero(codec != CODEC_EF)[0]
        value = np.empty(n, np.int64)
        rank = np.empty(n, np.int64)
        value[svb_j], rank[svb_j] = self._dispatch(
            False, terms[svb_j], probes[svb_j]
        )
        value[ef_j], rank[ef_j] = self._dispatch(True, terms[ef_j], probes[ef_j])
        return value, rank

    @property
    def use_device(self) -> bool:
        return self.backend == "torch"

    def fused_search(
        self, terms, probes, with_rank: bool = True, trusted: bool = False
    ):
        """One fused dispatch over this arena: (value, rank, past).

        value/rank are meaningful only where ``~past`` (the device pipeline
        pre-masks them to -1, which is equivalent for every caller).
        """
        if self.injector is not None and self.shard_id is not None:
            self.injector.check(self.shard_id)
        if self.shard_id is not None:
            obs.count("shard_dispatch", shard=str(self.shard_id), path="host_loop")
        if self.use_device:
            with obs.span("decode_search", backend=self.backend):
                value, rank = self.search_device(terms, probes)
            return value, rank, value < 0
        with obs.span("decode_search", backend="numpy"):
            return self.search_np(terms, probes, with_rank, trusted)
