"""Batched Block-Max BM25 top-k engine over the ranked arena.

Counterpart of ``repro/ranked/topk_engine.py`` without sharding (that comes
with the sharding slice).  Serves MANY disjunctive top-k queries per call
with Block-Max WAND/MaxScore pruning over the arena's quantized per-block
score upper bounds, while guaranteeing results IDENTICAL to the
exhaustive-scoring oracle (``repro_torch.ranked.bm25.exhaustive_topk``):
same docIDs, same scores, ties broken by ascending docID.

Phases per batch (all bound arithmetic in float64 over the f32 contract
values, so it is exact):

1. **Seed.**  Per query, the docs of each term's ``seed_blocks``
   highest-bounded blocks are scored fully; theta = their k-th best true
   score.

2. **Generate** (the block-max pivot, batched).  For every block b of every
   query term t, an ALIGNED upper bound: own bound plus, per other term,
   the max bound of its blocks overlapping b's docID span (an O(1)
   sparse-table range-max).  Surviving blocks emit candidates, lane-exactly
   filtered on the true contributions.  Every doc with score >= theta
   provably survives through each block containing it.

3. **Rescore + select** (threshold+compact, two rounds).  ONE membership
   pass over the flat lane keys resolves every (term, candidate) pair and
   yields doc-aligned upper bounds.  Round A exact-scores the highest-UB
   docs and raises theta to their k-th true score; round B scores only the
   remaining docs whose UB clears the raised theta.  Per-doc sums
   accumulate in float64 -- exact and order-free -- then (score desc,
   docID asc) cuts to k.

Residency decides WHERE phases 2 and 3 score.  ``"mirror"`` scores the
whole arena ONCE (the ``bm25_score_rows`` kernel) into a host per-lane
impact mirror and prunes on the host.  ``"kernel"`` -- the HBM-resident
configuration -- keeps only compressed blocks and bound tiles resident:
theta and the per-term bounds reduce to one integer code per block on the
host (``qmin_for``, float64-exact), the ``pivot_select`` kernel keeps and
compacts candidate blocks, the fused ``pivot_score`` kernel also scores the
first kept blocks of each chunk, the ``bm25_score_rows`` kernel re-scores
touched rows into a bounded hot-block cache, and round A's theta raise and
round B's UB filter ride in one device round (``theta_round_mask``).
``contributions()`` serves point lookups through ``bm25_score_probe`` (SVB
blocks) and ``ef_search`` + ``bm25_score_rows`` (EF blocks).

The ``"torch"`` backend runs all of that on ``device`` (the CUDA kernels
on a card, their plain versions for ``device="cpu"``); ``"numpy"`` runs
the host mirrors.  Every device -> host copy goes through ``_fetch``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import obs
from ..api import UNSET, coerce_config, resolve_backend, resolve_device
from ..core.arena import CODEC_EF
from ..core.engine_core import (
    EngineCore,
    build_pivot_chunks,
    group_cursors,
    locate_graph,
    pivot_graph,
    pivot_score_graph,
    pow2_bucket,
    stage_cursors,
)
from ..kernels.blockmax_pivot.kernel import QMIN_NONE
from ..kernels.blockmax_pivot.ops import dequant_table, pivot_select_np, qmin_for
from ..kernels.bm25_score.kernel import bm25_score_probe, bm25_score_rows
from ..kernels.bm25_score.ops import score_rows_np
from ..kernels.ef_search.kernel import ef_search
from ..kernels.pivot_score.kernel import SCORE_SLOTS
from ..kernels.vbyte_decode.kernel import BLOCK_VALS
from .bm25 import topk_select


def theta_round_mask(scores, dinv, lanes, w, seg, base, ndocs, theta_lo, eps,
                     ub_hi, qid_b, k: int, cap: int):
    """Round-A tail on the device: pair scatter-add -> f32 LOWER BOUNDS of
    the exact per-doc scores -> k-th lower bound per query -> round-B UB
    mask (the reference's ``_build_theta_fn``, as torch ops).

    Float contract: the exact score of doc slot s is a float64 sum of f32
    contributions; the device sums the same values in f32 -- in no fixed
    order on a card, ``index_add_`` being atomic there -- plus an abs-sum
    slack ``asums * eps`` covering every f32 rounding on the path, so
    ``lb <= exact`` always.  With theta rounded DOWN and the round-B UBs
    rounded UP by the caller, the mask is a provable superset of the exact
    round-B selection {UB >= exact theta2}.
    """
    nqp = ndocs.shape[0]
    contrib = scores[dinv.long(), lanes.long()] * w
    segl = seg.long()
    sums = base.index_add(0, segl, contrib)
    asums = base.abs().index_add(0, segl, contrib.abs())
    lb = (sums - asums * eps)[:-1].reshape(nqp, cap)
    slot = torch.arange(cap, device=lb.device)[None, :]
    lb = torch.where(slot < ndocs[:, None], lb, -torch.inf)
    kth = torch.topk(lb, k, dim=1).values[:, k - 1]
    theta2 = torch.where(ndocs >= k, torch.maximum(theta_lo, kth), theta_lo)
    return ub_hi >= theta2[qid_b.long()]


class TopKEngine:
    """Batched BM25 top-k over one freq-carrying ``PartitionedIndex``.

    Parameters
    ----------
    index: a ``PartitionedIndex`` built with ``freqs=`` (the arena must
        carry the ranked sidecar).
    backend: "auto" (= "torch") | "torch" | "numpy".
    device: torch device of the "torch" backend; "cuda" by default, and a
        machine without CUDA raises unless the caller passes "cpu".
    seed_blocks: how many highest-bounded blocks of each query term seed
        the pruning threshold.
    resident: "mirror" | "kernel" | "auto" (see the module docstring);
        "auto" picks "kernel" on a CUDA device, "mirror" elsewhere.  Both
        return the oracle's exact top-k.
    codec_policy: the arena codec policy ("svb" | "auto" | "ef").
    shards / shard_mesh / replicas / fault_injector: accepted for config
        compatibility; non-default values raise NotImplementedError.
    """

    # largest single device dispatch: bigger batches are chunked to this
    # bucket so the staged cursors and scored rows stay bounded
    MAX_BUCKET = 16_384
    # fused pivot+score dispatches score SCORE_SLOTS freq rows per cursor
    # (~32 KB each), so they chunk smaller than MAX_BUCKET
    PIVOT_SCORE_BUCKET = 1_024
    # hot-block score cache bound (rows): 2^17 rows x 512 B = 64 MB max
    SCORE_CACHE_ROWS = 1 << 17

    def __init__(self, index, backend=UNSET, seed_blocks: int = 4,
                 resident=UNSET, device=UNSET, codec_policy=UNSET,
                 shards=UNSET, shard_mesh=UNSET, replicas=UNSET,
                 fault_injector=UNSET, config=None, **kwargs):
        cfg = coerce_config(
            "TopKEngine",
            config,
            dict(
                backend=backend, resident=resident, device=device,
                codec_policy=codec_policy, shards=shards,
                shard_mesh=shard_mesh, replicas=replicas,
                fault_injector=fault_injector,
            ),
            kwargs,
        )
        self.config = cfg
        self.index = index
        self.arena = index.arena_for(cfg.codec_policy)
        if self.arena.ranked is None:
            raise ValueError(
                "index has no ranked sidecar: build with freqs= "
                "(build_partitioned_index(lists, freqs=...))"
            )
        self.ranked = self.arena.ranked
        self.stats = obs.CounterDict(
            "ranked",
            {
                "batches": 0,
                "seed_pairs": 0,
                "scored_pairs": 0,
                "candidates": 0,
                "ub_filtered": 0,
                "scored_rows": 0,
                "blocks_kept": 0,
                "blocks_total": 0,
                "pivot_chunks": 0,
                "score_evictions": 0,  # hot-block score cache flushes (rows)
                "fused_pivot_chunks": 0,  # cursors through pivot_score
                "theta_device_rounds": 0,  # device-carried theta rounds
            },
            engine="topk",
        )
        a, r = self.arena, self.ranked
        self.k1p1 = np.float32(r.params.k1 + 1.0)
        self.lob = a.part_list[a.part_of_block]  # owning list per block
        self.bounds = r.block_bounds().astype(np.float64)  # [nb]
        self.list_ub = r.list_ub.astype(np.float64)        # [n_lists]
        resident = cfg.resident
        if resident == "auto":
            on_card = (
                resolve_backend(cfg.backend) == "torch"
                and resolve_device(cfg.device).type == "cuda"
            )
            resident = "kernel" if on_card else "mirror"
        if resident not in ("mirror", "kernel"):
            raise ValueError(f"unknown resident mode {resident!r}")
        self.resident = resident
        self.seed_blocks = int(seed_blocks)
        # shared flat-mirror/locate machinery: the doc/key mirror is a HOST
        # structure, decoded with the numpy mirror whatever the scoring
        # backend (values are exact ints); the per-lane impact mirror rides
        # along under resident="mirror"
        self.core = EngineCore(
            a, backend=cfg.backend, device=cfg.device, cache_bytes=None,
            mirror_backend="numpy",
            lane_scores_fn=(
                self._lane_scores if resident == "mirror" else None
            ),
            stats=self.stats,
        )
        self.backend = self.core.backend
        self.device = self.core.device
        # device-pivot state (resident="kernel"): bound-chunk tiles + the
        # f64 dequant table behind the exact theta -> qmin reduction
        self._deq64 = dequant_table(r.bound_scale)
        self._pchunks = None
        self._scache_rows = np.zeros(0, np.int64)  # sorted hot rows
        self._scache = np.zeros((0, BLOCK_VALS), np.float32)

    # ------------------------------------------------------------------
    # device plumbing
    # ------------------------------------------------------------------
    @property
    def _dev(self):
        """The arena's tensors on the engine's device (uploaded once)."""
        return self.arena.on(self.device)

    def _up(self, x: np.ndarray) -> torch.Tensor:
        """One staged host buffer to the engine's device."""
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _fetch(self, *arrays) -> list:
        """THE device->host materialization point of the ranked engine.

        Every fetch on the ranked hot path funnels through this one
        function -- a plain loop, deliberately not a comprehension, so every
        materialization has ONE stable site.  Each round fetches here
        exactly once per bucket, after the whole round has been launched.
        """
        out = []
        for a in arrays:
            out.append(a.cpu().numpy())
        return out

    @staticmethod
    def _note_theta(theta) -> None:
        """Theta-trajectory gauge: the batch's max raised threshold (the
        tightest pruning bound the two-round rescore reached)."""
        if theta is None or not obs.enabled():
            return
        finite = theta[np.isfinite(theta)]
        if len(finite):
            obs.set_gauge("ranked_theta_max", float(finite.max()))

    def _lane_scores(self) -> np.ndarray:
        """The impact mirror: every lane scored ONCE (one ``bm25_score_rows``
        launch over the whole resident arena on the torch backend)."""
        a, r = self.arena, self.ranked
        if self.core.use_device:
            d = self._dev
            out, = self._fetch(bm25_score_rows(
                d.freq_lens, d.freq_data, d.norm_q, d.idf, d.lob,
                d.norm_table, self.k1p1,
            ))
            return out
        nb = a.n_blocks
        return score_rows_np(r.freq_lens[:nb], r.freq_data[:nb], r.norm_q,
                             r.idf[self.lob], r.norm_table, self.k1p1)

    # ------------------------------------------------------------------
    # host flat mirror (shared EngineCore): decoded docIDs + lane scores
    # ------------------------------------------------------------------
    def _flat_init(self) -> None:
        self.core.flat_init()

    def _block_docs(self, rows: np.ndarray) -> np.ndarray:
        """Real docIDs of the given arena rows (flat mirror)."""
        self._flat_init()
        vals = self.core.flat_vals[:-1].reshape(-1, BLOCK_VALS)[rows]
        return vals[self.arena.lane_valid[rows]]

    def _block_docs_filtered(
        self, rows: np.ndarray, rest: np.ndarray, mult_t: float,
        theta: float, share: float,
    ) -> np.ndarray:
        """docIDs of the rows that can still reach theta, lane-exactly.

        With the impact mirror resident, the generating term's contribution
        per lane is KNOWN, and a candidate only materializes when BOTH
        admissible tests pass on its true contribution c = mult_t * score:

        * aligned-bound test: ``c + rest(row) >= theta`` with rest the
          co-located block-max bound of the other terms;
        * proportional-share test: ``c >= share`` where share =
          theta * ub_t / total_ub -- a doc with score >= theta must beat
          its proportional share in SOME term, and this generator runs
          once per term, so the doc materializes where it does.
        """
        self._flat_init()
        if len(rows) == 0:
            return np.zeros(0, np.int64)
        vals = self.core.flat_vals[:-1].reshape(-1, BLOCK_VALS)[rows]
        lv = self.arena.lane_valid[rows]
        scores = self.core.flat_scores
        if scores is None or not np.isfinite(theta):
            return vals[lv]
        c = mult_t * scores[:-1].reshape(-1, BLOCK_VALS)[rows]
        ok = lv & (c + rest[:, None] >= theta) & (c >= share)
        return vals[ok]

    # ------------------------------------------------------------------
    # range-max over block bounds (sparse table; built once per engine)
    # ------------------------------------------------------------------
    def _rmq_init(self) -> None:
        """st[l][i] = max(bounds[i : i + 2^l]) -- O(nb log nb) once, O(1)
        per range query; the structure behind the aligned pivot test."""
        if getattr(self, "_rmq", None) is not None:
            return
        nb = max(self.arena.n_blocks, 1)
        levels = max(int(nb - 1).bit_length(), 1)
        st = np.full((levels, nb), 0.0)
        st[0, : self.arena.n_blocks] = self.bounds
        for l in range(1, levels):
            half = 1 << (l - 1)
            st[l, : nb - (1 << l) + 1] = np.maximum(
                st[l - 1, : nb - (1 << l) + 1],
                st[l - 1, half : nb - (1 << l) + 1 + half],
            )
        self._rmq = st

    def _rmq_max(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        """max(bounds[lo:hi]) per element; 0.0 for empty ranges."""
        self._rmq_init()
        nb = self._rmq.shape[1]
        length = hi - lo
        ok = length > 0
        ln = np.maximum(length, 1)
        lvl = np.frexp(ln.astype(np.float64))[1] - 1  # floor(log2(len))
        lo_s = np.clip(lo, 0, nb - 1)
        hi_s = np.clip(np.maximum(hi - (1 << lvl), lo), 0, nb - 1)
        m = np.maximum(self._rmq[lvl, lo_s], self._rmq[lvl, hi_s])
        return np.where(ok, m, 0.0)

    def _aligned_rest(self, terms, mult):
        """Per term j: (rows, rest) over every block of list terms[j].

        ``rest[b] = sum_{j2 != j} mult[j2] * max bound of the terms[j2]-
        blocks overlapping b's docID span`` -- the range-aligned
        co-candidate bound behind BOTH residencies' pruning.  Every term of
        the sum is an exact float64 over f32 contract values, so the sum is
        exact and the two residencies prune bit-identically.
        """
        a = self.arena
        out = []
        for j, t in enumerate(terms):
            t = int(t)
            r0 = int(a.list_blk_offsets[t])
            r1 = int(a.list_blk_offsets[t + 1])
            rows = np.arange(r0, r1, dtype=np.int64)
            lo = a.block_base[rows] + 1  # first docID a block can hold
            hi = a.block_keys[rows] - t * a.stride  # last real docID
            rest = np.zeros(len(rows), np.float64)
            for j2, t2 in enumerate(terms):
                if j2 == j:
                    continue
                t2 = int(t2)
                s1 = int(a.list_blk_offsets[t2 + 1])
                ks = np.searchsorted(
                    a.block_keys, lo + t2 * a.stride, side="left"
                )
                ke = np.searchsorted(
                    a.block_keys, hi + t2 * a.stride, side="left"
                )
                rest += mult[j2] * self._rmq_max(ks, np.minimum(ke + 1, s1))
            out.append((rows, rest))
        return out

    # ------------------------------------------------------------------
    # hot-block score cache + resident row scorer (resident="kernel")
    # ------------------------------------------------------------------
    def _pivot_chunks_init(self):
        if self._pchunks is None:
            self._pchunks = build_pivot_chunks(self.arena)
        return self._pchunks

    def _cache_lookup(self, urows: np.ndarray):
        """Hot-block score cache lookup for UNIQUE SORTED arena rows.

        resident="kernel" holds no arena-wide impact mirror, but hot blocks
        recur across batches and phases, so scored rows live in a sorted
        array with vectorized lookups (one searchsorted per call).  Returns
        ``(out [n, 128] f32, hit mask)`` with only the hit rows of ``out``
        filled."""
        out = np.empty((len(urows), BLOCK_VALS), np.float32)
        n = len(self._scache_rows)
        if n:
            pos = np.minimum(
                np.searchsorted(self._scache_rows, urows), n - 1
            )
            hit = self._scache_rows[pos] == urows
            if hit.any():
                out[hit] = self._scache[pos[hit]]
        else:
            hit = np.zeros(len(urows), bool)
        if obs.enabled():
            nh = int(hit.sum())
            obs.count("ranked_score_cache_rows", nh, kind="hit")
            obs.count("ranked_score_cache_rows", len(urows) - nh, kind="miss")
        return out, hit

    def _cache_merge(self, mrows: np.ndarray, scored: np.ndarray) -> int:
        """Insert (SORTED UNIQUE rows, [n, 128] f32 scores) into the
        hot-block cache; rows already present are skipped (a re-score is
        bit-identical).  Past ``SCORE_CACHE_ROWS`` the cache is flushed
        (counted in ``stats["score_evictions"]``) and an over-budget insert
        set is truncated.  Returns the number of rows inserted."""
        n = len(self._scache_rows)
        if n:
            pos = np.minimum(np.searchsorted(self._scache_rows, mrows), n - 1)
            new = self._scache_rows[pos] != mrows
            if not new.all():
                mrows, scored = mrows[new], scored[new]
        if not len(mrows):
            return 0
        if n + len(mrows) > self.SCORE_CACHE_ROWS:
            self.stats["score_evictions"] += n
            keep = min(len(mrows), self.SCORE_CACHE_ROWS)
            self._scache_rows = mrows[:keep].copy()
            self._scache = scored[:keep].copy()
        else:
            rows2 = np.concatenate([self._scache_rows, mrows])
            order = np.argsort(rows2, kind="stable")
            self._scache_rows = rows2[order]
            self._scache = np.concatenate([self._scache, scored])[order]
        return len(mrows)

    def _rowscore_dev(self, mrows: np.ndarray) -> torch.Tensor:
        """ONE resident ``bm25_score_rows`` launch (pow2 row bucket; padding
        rows score row 0 and are sliced off by the caller).  Returns the
        DEVICE scores, so the device theta round consumes them without a
        sync."""
        b = pow2_bucket(len(mrows))
        rp = np.zeros(b, np.int32)
        rp[: len(mrows)] = mrows
        d = self._dev
        return bm25_score_rows(
            d.freq_lens, d.freq_data, d.norm_q, d.idf, d.lob, d.norm_table,
            self.k1p1, self._up(rp),
        )

    def _score_miss_rows(self, mrows: np.ndarray) -> np.ndarray:
        """Score UNIQUE SORTED cache-miss rows: resident launches on the
        torch backend, the numpy mirror otherwise."""
        if self.core.use_device:
            n = len(mrows)
            out = np.empty((n, BLOCK_VALS), np.float32)
            for s in range(0, n, self.MAX_BUCKET):
                e = min(s + self.MAX_BUCKET, n)
                res, = self._fetch(self._rowscore_dev(mrows[s:e]))
                out[s:e] = res[: e - s]
            return out
        r = self.ranked
        return score_rows_np(
            r.freq_lens[mrows], r.freq_data[mrows], r.norm_q[mrows],
            r.idf[self.lob[mrows]], r.norm_table, self.k1p1,
        )

    def _score_rows_batch(self, urows: np.ndarray) -> np.ndarray:
        """[len(urows), 128] f32 lane scores of UNIQUE SORTED arena rows,
        cached across batches (see ``_cache_lookup`` / ``_cache_merge``)."""
        out, hit = self._cache_lookup(urows)
        miss = ~hit
        if miss.any():
            mrows = urows[miss]
            self.stats["scored_rows"] += len(mrows)
            scored = self._score_miss_rows(mrows)
            out[miss] = scored
            self._cache_merge(mrows, scored)
        return out

    # ------------------------------------------------------------------
    # device Block-Max pivot (resident="kernel")
    # ------------------------------------------------------------------
    def _stage_pivot(self, rows, qmins, s, e):
        """pow2-bucketed (rows, qmins) of cursors s:e on the device; padding
        cursors name chunk 0 with qmin = QMIN_NONE and keep nothing."""
        b = pow2_bucket(e - s)
        rp = np.zeros(b, np.int32)
        qp = np.full((b, BLOCK_VALS), QMIN_NONE, np.int32)
        rp[: e - s] = rows[s:e]
        qp[: e - s] = qmins[s:e]
        return self._up(rp), self._up(qp)

    def _pivot_dev_on(self, rows, qmins):
        """``pivot_select`` launches over the resident chunk table, chunked
        at MAX_BUCKET.  Returns (kept lanes [n, 128], counts)."""
        pcd = self._pivot_chunks_init().on(self.device)
        n = len(rows)
        kept = np.empty((n, BLOCK_VALS), np.int64)
        cnt = np.empty(n, np.int64)
        for s in range(0, n, self.MAX_BUCKET):
            e = min(s + self.MAX_BUCKET, n)
            rp, qp = self._stage_pivot(rows, qmins, s, e)
            out, c, _, _ = pivot_graph(pcd, rp, qp)
            out_h, c_h = self._fetch(out, c)
            kept[s:e] = out_h[: e - s]
            cnt[s:e] = c_h[: e - s]
        return kept, cnt

    def _fusable_cursors(self, rows, cur_ij, theta, pc) -> np.ndarray:
        """FUSED-dispatch routing mask, per pivot cursor.

        A cursor takes the fused pivot+score path when its query's theta
        is finite (only finite-theta segments get lane-filtered, so only
        their slot scores will be read) AND its chunk still has blocks
        missing from the hot-block score cache.  A fully-cached chunk takes
        the plain pivot -- its lane scores come out of the cache for
        free."""
        fin = np.fromiter(
            (bool(np.isfinite(theta[i])) for i, _ in cur_ij),
            bool, len(cur_ij),
        )
        if not fin.any():
            return fin
        base = pc.base[rows]
        nblk = pc.nblk[rows].astype(np.int64)
        lo = np.searchsorted(self._scache_rows, base)
        hi = np.searchsorted(self._scache_rows, base + nblk)
        return fin & ((hi - lo) < nblk)

    def _pivot_score_dev_on(self, rows, qmins, pc):
        """``pivot_score`` launches: the bucketing of ``_pivot_dev_on``,
        but each fetch also carries the slot scores, which are folded into
        the hot-block cache so the candidate filter's ``_score_rows_batch``
        finds them already resident.  Returns (kept lanes [n, 128],
        counts)."""
        pcd = pc.on(self.device)
        d = self._dev
        n = len(rows)
        kept = np.empty((n, BLOCK_VALS), np.int64)
        cnt = np.empty(n, np.int64)
        for s in range(0, n, self.PIVOT_SCORE_BUCKET):
            e = min(s + self.PIVOT_SCORE_BUCKET, n)
            rp, qp = self._stage_pivot(rows, qmins, s, e)
            out, c, _, _, ss = pivot_score_graph(pcd, d, rp, qp, self.k1p1)
            out_h, c_h, ss_h = self._fetch(out, c, ss)
            kept[s:e] = out_h[: e - s]
            cnt[s:e] = c_h[: e - s]
            ke = out_h[: e - s, :SCORE_SLOTS]
            valid = ke >= 0
            if valid.any():
                grows = (pc.base[rows[s:e]][:, None] + ke)[valid]
                sc = ss_h[: e - s].reshape(-1, BLOCK_VALS)[valid.reshape(-1)]
                u, first = np.unique(grows, return_index=True)
                self.stats["scored_rows"] += self._cache_merge(u, sc[first])
        self.stats["fused_pivot_chunks"] += n
        return kept, cnt

    def _pivot_select(self, specs, theta, want_scores: bool = False):
        """Emission + ONE device pivot round for a whole batch.

        The host reduces the float admissibility envelope to u8 codes in
        float64 -- per block b of term t,

          ``mult_t * bound(b) + rest(b) >= theta``   (aligned bound) and
          ``mult_t * bound(b) >= theta * ub_t / total_ub``  (share floor)

        <=> ``block_max_q[b] >= qmin[b]`` exactly.  Every chunk of every
        surviving term then goes through the pivot over the resident bound
        tiles.  Admissible by construction: a block whose bound clears the
        envelope always comes back, on every backend.

        Returns ``(segments, params)``: ``segments[(i, j)] = (kept global
        rows, aligned rest of those rows)`` per query i / term slot j;
        ``params[(i, j)] = (mult_j, share_j)``.
        """
        use_dev = self.core.use_device
        pc = self._pivot_chunks_init()
        segments: dict = {}
        params: dict = {}
        rests: dict = {}
        # ---- collect every (query, term) pair, then ONE batched qmin
        # reduction over all their blocks
        pair_meta, rest_l, mult_l, theta_l, share_l = [], [], [], [], []
        for i, (terms, mult) in enumerate(specs):
            if len(terms) == 0:
                continue
            ub = mult * self.list_ub[terms]
            total_ub = float(ub.sum())
            aligned = self._aligned_rest(terms, mult)
            for j, (rows_t, rest) in enumerate(aligned):
                nb_t = len(rows_t)
                self.stats["blocks_total"] += nb_t
                if nb_t == 0:
                    continue
                share = (
                    float(theta[i]) * float(ub[j]) / total_ub
                    if total_ub > 0 and np.isfinite(theta[i])
                    else -np.inf
                )
                pair_meta.append((i, j, int(terms[j]), nb_t))
                rest_l.append(rest)
                mult_l.append(float(mult[j]))
                theta_l.append(float(theta[i]))
                share_l.append(share)
                params[(i, j)] = (float(mult[j]), share)
                rests[(i, j)] = (int(rows_t[0]), rest)
        if not pair_meta:
            return segments, params
        sizes = np.array([m[3] for m in pair_meta])
        qmin_all = qmin_for(
            np.repeat(mult_l, sizes),
            np.concatenate(rest_l),
            np.repeat(theta_l, sizes),
            self._deq64,
        )
        # the proportional-share floor, one bisection over the pairs
        q_share = qmin_for(
            np.asarray(mult_l), np.zeros(len(pair_meta)),
            np.asarray(share_l), self._deq64,
        )
        qmin_all = np.maximum(qmin_all, np.repeat(q_share, sizes))

        rows_l, qmin_l, cur_ij = [], [], []
        pair_cuts = np.zeros(len(pair_meta) + 1, np.int64)
        np.cumsum(sizes, out=pair_cuts[1:])
        for p, (i, j, t, nb_t) in enumerate(pair_meta):
            qmin_b = qmin_all[pair_cuts[p] : pair_cuts[p + 1]]
            if qmin_b.min() >= QMIN_NONE:
                del params[(i, j)], rests[(i, j)]
                continue  # no block of this term can reach theta
            c0, c1 = int(pc.offsets[t]), int(pc.offsets[t + 1])
            tile = np.full(((c1 - c0) * BLOCK_VALS,), QMIN_NONE, np.int64)
            tile[:nb_t] = qmin_b
            rows_l.append(np.arange(c0, c1, dtype=np.int64))
            qmin_l.append(tile.reshape(c1 - c0, BLOCK_VALS))
            cur_ij.extend([(i, j)] * (c1 - c0))
        if not rows_l:
            return segments, params
        rows = np.concatenate(rows_l)
        qmins_c = np.concatenate(qmin_l)
        self.stats["pivot_chunks"] += len(rows)

        # ---- the pivot round
        if not use_dev:
            kept, cnt, _, _ = pivot_select_np(
                pc.qb[rows], qmins_c, pc.nblk[rows]
            )
        else:
            # cursors whose slot scores will be read AND whose chunk is not
            # already hot take the fused pivot+score launch; the rest take
            # the plain pivot (same kept blocks either way)
            fuse = (
                self._fusable_cursors(rows, cur_ij, theta, pc)
                if want_scores
                else np.zeros(len(rows), bool)
            )
            kept = np.empty((len(rows), BLOCK_VALS), np.int64)
            cnt = np.empty(len(rows), np.int64)
            plain = ~fuse
            if plain.any():
                kept[plain], cnt[plain] = self._pivot_dev_on(
                    rows[plain], qmins_c[plain]
                )
            if fuse.any():
                kept[fuse], cnt[fuse] = self._pivot_score_dev_on(
                    rows[fuse], qmins_c[fuse], pc
                )
        grows = (pc.base[rows][:, None] + kept)[kept >= 0]
        self.stats["blocks_kept"] += int(cnt.sum())
        gcuts = np.zeros(len(rows) + 1, np.int64)
        np.cumsum(cnt, out=gcuts[1:])

        # ---- group surviving rows into per-(query, term) segments with
        # their aligned rest values (cursors of one term are contiguous)
        acc: dict = {}
        for c, ij in enumerate(cur_ij):
            sl = slice(int(gcuts[c]), int(gcuts[c + 1]))
            if sl.start != sl.stop:
                acc.setdefault(ij, []).append(grows[sl])
        for ij, chunks in acc.items():
            rows_k = np.concatenate(chunks)
            r0, rest = rests[ij]
            segments[ij] = (rows_k, rest[rows_k - r0])
        return segments, params

    def _pivot_rows(self, specs, theta) -> list[np.ndarray]:
        """Per query: ALL arena rows (blocks) surviving the device pivot at
        the query's theta (the block-level keep-set)."""
        segments, _ = self._pivot_select(specs, theta)
        out = [np.zeros(0, np.int64) for _ in specs]
        by_q: dict = {}
        for (i, _), (rows_k, _) in sorted(segments.items()):
            by_q.setdefault(i, []).append(rows_k)
        for i, chunks in by_q.items():
            out[i] = np.concatenate(chunks)
        return out

    def _pivot_candidates(self, specs, theta) -> list[np.ndarray]:
        """Per query: candidate docIDs from the surviving blocks, lane-
        exactly filtered on their true contributions (the same two
        admissible tests as the mirror path's ``_block_docs_filtered``,
        with the lane scores from the hot-block cache / row scorer)."""
        segments, params = self._pivot_select(specs, theta, want_scores=True)
        self._flat_init()
        a = self.arena
        out: list[list[np.ndarray]] = [[] for _ in specs]
        # only finite-theta segments get lane-filtered, so only THEIR rows
        # are worth scoring
        fin = [
            rows_k
            for (i, _), (rows_k, _) in segments.items()
            if np.isfinite(theta[i])
        ]
        scores_u = None
        if fin:
            urows = np.unique(np.concatenate(fin))
            scores_u = self._score_rows_batch(urows)
        for (i, j), (rows_k, rest_k) in sorted(segments.items()):
            vals = self.core.flat_vals[:-1].reshape(-1, BLOCK_VALS)[rows_k]
            lv = a.lane_valid[rows_k]
            if scores_u is None or not np.isfinite(theta[i]):
                out[i].append(vals[lv])
                continue
            mult_t, share = params[(i, j)]
            pos = np.searchsorted(urows, rows_k)
            c = mult_t * scores_u[pos]
            ok = lv & (c + rest_k[:, None] >= theta[i]) & (c >= share)
            out[i].append(vals[ok])
        return [
            np.concatenate(chunks) if chunks else np.zeros(0, np.int64)
            for chunks in out
        ]

    # ------------------------------------------------------------------
    # batched per-(term, doc) contributions
    # ------------------------------------------------------------------
    def _contrib_np(self, terms: np.ndarray, docs: np.ndarray) -> np.ndarray:
        """Host path: one searchsorted over the flat keys per batch."""
        self._flat_init()
        a, core = self.arena, self.core
        key = np.clip(docs, 0, a.stride - 1) + terms * a.stride
        pos = np.searchsorted(core.flat_keys, key, "left")
        past = pos >= core.lane_end[terms + 1]
        hit = (core.flat_vals[pos] == docs) & ~past
        if core.flat_scores is None:  # resident="kernel": no score mirror
            rows_n = np.minimum(pos, a.n_blocks * BLOCK_VALS - 1) >> 7
            urows, inv = np.unique(rows_n[hit], return_inverse=True)
            r = self.ranked
            row_scores = score_rows_np(
                r.freq_lens[urows], r.freq_data[urows], r.norm_q[urows],
                r.idf[self.lob[urows]], r.norm_table, self.k1p1,
            )
            out = np.zeros(len(terms), np.float32)
            out[hit] = row_scores[inv, (pos[hit] & (BLOCK_VALS - 1))]
            return out
        return np.where(hit, core.flat_scores[pos], np.float32(0.0))

    def _contrib_dev_on(self, ef: bool, terms, docs) -> np.ndarray:
        """One codec's wave of device contributions, chunked at MAX_BUCKET:
        locate -> ``bm25_score_probe`` (SVB blocks) or ``ef_search`` +
        ``bm25_score_rows`` + lane select (EF blocks).

        pow2 padding cursors repeat the wave's first cursor: list 0 at
        docID 0 may locate a block of the other codec, whose ``codec_row``
        does not index this wave's tiles.
        """
        a, d = self.arena, self._dev
        cr = d.codec_row if a.multi else None
        n = len(terms)
        out = np.empty(n, np.float32)
        for s in range(0, n, self.MAX_BUCKET):
            e = min(s + self.MAX_BUCKET, n)
            tp, pp = stage_cursors(
                terms[s:e], docs[s:e], a.stride, pow2_bucket(e - s)
            )
            tp[e - s :], pp[e - s :] = tp[0], pp[0]
            rows, pe, past = locate_graph(
                d.block_keys, d.list_blk_offsets, a.stride, a.n_blocks,
                self._up(tp), self._up(pp),
            )
            if ef:
                value, rank_in = ef_search(
                    d.ef_lo, d.ef_hi, d.ef_lbits, d.block_base, rows, pe, cr
                )
                row_scores = bm25_score_rows(
                    d.freq_lens, d.freq_data, d.norm_q, d.idf, d.lob,
                    d.norm_table, self.k1p1, rows,
                )
                rc = rank_in.clamp(max=BLOCK_VALS - 1).long()[:, None]
                contrib = row_scores.gather(1, rc)[:, 0]
                hit = (value == pe) & ~past
            else:
                contrib = bm25_score_probe(
                    d.lens, d.data, d.block_base, cr, d.freq_lens,
                    d.freq_data, d.norm_q, d.idf, d.lob, d.norm_table,
                    self.k1p1, rows, pe,
                )
                hit = ~past
            res_h, = self._fetch(torch.where(hit, contrib, 0.0))
            out[s:e] = res_h[: e - s]
        return out

    def _contrib_dev(self, terms: np.ndarray, docs: np.ndarray) -> np.ndarray:
        """Device contributions, bucketed per codec: a multi-codec arena
        runs the host codec pre-pass (the same searchsorted the device
        re-runs, read only for ``block_codec``) and launches ONE wave per
        codec, scattering back in batch order."""
        a = self.arena
        if a.block_codec is None:
            return self._contrib_dev_on(False, terms, docs)
        pc = np.clip(docs, 0, a.stride - 1)
        k = np.searchsorted(a.block_keys, pc + terms * a.stride, side="left")
        codec = a.block_codec[np.minimum(k, a.n_blocks - 1)]
        ef_j = np.nonzero(codec == CODEC_EF)[0]
        if not len(ef_j):
            return self._contrib_dev_on(False, terms, docs)
        if len(ef_j) == len(terms):
            return self._contrib_dev_on(True, terms, docs)
        svb_j = np.nonzero(codec != CODEC_EF)[0]
        out = np.empty(len(terms), np.float32)
        out[svb_j] = self._contrib_dev_on(False, terms[svb_j], docs[svb_j])
        out[ef_j] = self._contrib_dev_on(True, terms[ef_j], docs[ef_j])
        return out

    def contributions(self, terms, docs) -> np.ndarray:
        """f32 BM25 contribution of doc in list(term), 0.0 when absent.

        On the device path, duplicate (term, doc) cursors are grouped
        first so each one costs a single kernel row.
        """
        terms = np.asarray(terms, dtype=np.int64)
        docs = np.asarray(docs, dtype=np.int64)
        if len(terms) == 0:
            return np.zeros(0, np.float32)
        if self.core.use_device:
            g = group_cursors(terms, docs, self.arena.stride)
            if g is not None:
                idx, inv = g
                out = self._contrib_dev(terms[idx], docs[idx])[inv]
            else:
                out = self._contrib_dev(terms, docs)
            # the device staging clip maps out-of-range docs onto real
            # probes (e.g. -1 -> docID 0); they can never be members
            out[(docs < 0) | (docs >= self.arena.stride)] = 0.0
            return out
        return self._contrib_np(terms, docs)

    # ------------------------------------------------------------------
    # device-carried theta: the round-A theta raise + round-B UB filter
    # ride in the round-A scoring launch
    # ------------------------------------------------------------------
    def _theta_round_dev(
        self, specs, sel_a, cap, k, theta, ubs,
        idx_l, col_l, w_l, out_u, hit, inv, lanes, miss, mrows,
    ) -> np.ndarray:
        """Round A in one device round: score the cache-miss rows
        resident, scatter the pair contributions into per-(query, doc-slot)
        f32 lower bounds, raise theta on the device and emit the round-B
        UB mask -- all fetched together (one ``_fetch``).

        Fills the miss rows of ``out_u`` (and the hot-block cache) with
        the fetched scores; returns the mask over the concatenated
        not-round-A doc slots of every query."""
        self.stats["theta_device_rounds"] += 1
        self.stats["scored_rows"] += len(mrows)
        nq = len(specs)
        counts = np.array([int(s.sum()) for s in sel_a], np.int64)
        capm = int(pow2_bucket(max(int(counts.max()), k)))
        nqp = int(pow2_bucket(nq, 1))
        nslot = nqp * capm + 1  # +1: dump slot for padding pairs

        # pair segments: slot = query * capm + compacted doc column
        qid = np.repeat(
            np.arange(nq, dtype=np.int64), [len(ix) for ix in idx_l]
        )
        col = np.concatenate(col_l) if len(qid) else np.zeros(0, np.int64)
        w = np.concatenate(w_l) if len(qid) else np.zeros(0, np.float64)
        seg = qid * capm + col
        # pairs over CACHED rows accumulate on the host in exact f64 and
        # enter the device sum as one f32 base term per slot
        pair_hit = hit[inv]
        bs64 = np.zeros(nslot, np.float64)
        if pair_hit.any():
            hp = np.flatnonzero(pair_hit)
            np.add.at(
                bs64, seg[hp],
                w[hp] * out_u[inv[hp], lanes[hp]].astype(np.float64),
            )
        # pairs over rows being scored THIS round stay on the device
        dp = np.flatnonzero(~pair_hit)
        miss_pos = np.cumsum(miss) - 1  # urows index -> mrows index
        P = int(pow2_bucket(max(len(dp), 1)))
        dinv = np.zeros(P, np.int32)
        dlan = np.zeros(P, np.int32)
        dw = np.zeros(P, np.float32)
        dseg = np.full(P, nslot - 1, np.int32)
        dinv[: len(dp)] = miss_pos[inv[dp]]
        dlan[: len(dp)] = lanes[dp]
        dw[: len(dp)] = w[dp].astype(np.float32)
        dseg[: len(dp)] = seg[dp].astype(np.int32)

        # f32 envelope: theta rounded DOWN, round-B UBs rounded UP
        ndocs = np.zeros(nqp, np.int32)
        ndocs[:nq] = np.minimum(counts, capm)
        theta32 = np.full(nqp, -np.inf, np.float32)
        theta32[:nq] = np.nextafter(
            theta.astype(np.float32), np.float32(-np.inf)
        )
        ub_l, qid_l = [], []
        for i in range(nq):
            nb_i = ~sel_a[i]
            u = ubs[i][nb_i].astype(np.float32)
            ub_l.append(np.nextafter(u, np.float32(np.inf)))
            qid_l.append(np.full(int(nb_i.sum()), i, np.int32))
        ub_b = np.concatenate(ub_l)
        n_b = len(ub_b)
        Bn = int(pow2_bucket(max(n_b, 1)))
        ubp = np.full(Bn, -np.inf, np.float32)
        ubp[:n_b] = ub_b
        qbp = np.zeros(Bn, np.int32)
        qbp[:n_b] = np.concatenate(qid_l)
        # abs-sum slack: <= tmax pair adds + products + base cast per
        # slot, each <= 1 ulp of a partial bounded by the abs-sum; 4x op
        # count in f32 ulps covers any evaluation order
        tmax = max((len(t) for t, _, _ in specs), default=1)
        eps = np.float32(4.0 * (tmax + 4.0) * 2.0 ** -23)

        scores_dev = self._rowscore_dev(mrows)
        mask_dev = theta_round_mask(
            scores_dev, self._up(dinv), self._up(dlan), self._up(dw),
            self._up(dseg), self._up(bs64.astype(np.float32)),
            self._up(ndocs), self._up(theta32),
            torch.tensor(float(eps), dtype=torch.float32, device=self.device), self._up(ubp),
            self._up(qbp), k=k, cap=capm,
        )
        miss_sc, mask_h = self._fetch(scores_dev, mask_dev)
        miss_sc = miss_sc[: len(mrows)]
        out_u[miss] = miss_sc
        self._cache_merge(mrows, miss_sc)
        return mask_h[:n_b]

    # ------------------------------------------------------------------
    # batched bound-filter + exact scoring of per-query candidate sets
    # ------------------------------------------------------------------
    def _score_specs(
        self,
        specs: list[tuple[np.ndarray, np.ndarray, np.ndarray]],
        theta: np.ndarray | None = None,
        k: int | None = None,
    ) -> tuple[list[tuple[np.ndarray, np.ndarray]], np.ndarray | None]:
        """specs: per query (unique terms, multiplicities, candidate docs).
        Returns (per query (surviving docs, exact f64 scores), the raised
        per-query theta -- None when no threshold pass ran).  The raised
        theta is monotone: never below the theta passed in.

        One membership pass over the flat lane mirror resolves EVERY
        (term, doc) pair of the batch at once.  Only MEMBER pairs of
        surviving docs are ever scored -- a gather from the impact mirror
        under resident="mirror", the row scorer over the unique touched
        rows under resident="kernel".  Scores accumulate per doc in
        float64 (exact, order-free).

        With ``theta``/``k`` set, scoring is TWO-ROUND threshold+compact:
        round A exact-scores the max(4k, 64) highest-UB docs per query and
        raises theta to their k-th true score; round B scores only the
        remaining docs whose UB clears the raised theta.
        """
        self._flat_init()
        a, core = self.arena, self.core
        nq = len(specs)
        t_chunks, d_chunks, cuts = [], [], [0]
        for terms, _, docs in specs:
            t_chunks.append(np.repeat(terms, len(docs)))
            d_chunks.append(np.tile(docs, len(terms)))
            cuts.append(cuts[-1] + len(terms) * len(docs))
        if cuts[-1] == 0:
            return [
                (np.zeros(0, np.int64), np.zeros(0, np.float64))
                for _ in specs
            ], (None if theta is None else theta.copy())
        t_rep = np.concatenate(t_chunks)
        d_til = np.concatenate(d_chunks)
        pos = np.searchsorted(core.flat_keys, d_til + t_rep * a.stride, "left")
        past = pos >= core.lane_end[t_rep + 1]
        member = (core.flat_vals[pos] == d_til) & ~past
        row = np.minimum(pos, a.n_blocks * BLOCK_VALS - 1) >> 7

        need_ub = theta is not None
        mems, ubs = [], []
        for i, (terms, mult, docs) in enumerate(specs):
            T, D = len(terms), len(docs)
            if T == 0 or D == 0:
                mems.append(np.zeros((T, D), bool))
                ubs.append(np.zeros(D, np.float64))
                continue
            sl = slice(cuts[i], cuts[i + 1])
            mem = member[sl].reshape(T, D)
            mems.append(mem)
            if need_ub:
                ubs.append(
                    (
                        mult[:, None]
                        * np.where(
                            mem, self.bounds[row[sl].reshape(T, D)], 0.0
                        )
                    ).sum(axis=0)
                )
            else:
                ubs.append(None)

        def pairs_for(sels: list[np.ndarray]):
            """Member-pair segments of the selected doc slots: per query
            (flat pair index, compacted doc column, multiplicity)."""
            idx_l, col_l, w_l = [], [], []
            for i, (terms, mult, docs) in enumerate(specs):
                sel = sels[i]
                D = len(docs)
                if D == 0 or len(terms) == 0 or not sel.any():
                    idx_l.append(np.zeros(0, np.int64))
                    col_l.append(np.zeros(0, np.int64))
                    w_l.append(np.zeros(0, np.float64))
                    continue
                colmap = np.cumsum(sel) - 1
                pr, pc = np.nonzero(mems[i] & sel[None, :])
                idx_l.append(cuts[i] + pr * D + pc)
                col_l.append(colmap[pc])
                w_l.append(mult[pr])
            return idx_l, col_l, w_l, np.concatenate(idx_l)

        def accumulate(idx_l, col_l, w_l, sels, contrib):
            """Per-doc exact scores: float64 scatter-add (order-free)."""
            out, start = [], 0
            for i in range(nq):
                n_i = len(idx_l[i])
                sc = np.zeros(int(sels[i].sum()), np.float64)
                np.add.at(
                    sc, col_l[i],
                    w_l[i] * contrib[start : start + n_i].astype(np.float64),
                )
                out.append(sc)
                start += n_i
            return out

        def score_subset(sels: list[np.ndarray]):
            """Exact f64 scores of the selected doc slots of every query,
            via ONE batched contribution pass over the member pairs."""
            idx_l, col_l, w_l, g_idx = pairs_for(sels)
            self.stats["scored_pairs"] += len(g_idx)
            if self.resident == "kernel":
                # member pairs pin exact (row, lane) coordinates, so the
                # batch's contributions cost ONE all-lane scoring pass over
                # the UNIQUE touched rows
                g_pos = pos[g_idx]
                rows_n, lanes = g_pos >> 7, g_pos & (BLOCK_VALS - 1)
                urows, inv = np.unique(rows_n, return_inverse=True)
                row_scores = self._score_rows_batch(urows)
                contrib = row_scores[inv, lanes]
            else:
                contrib = core.flat_scores[pos[g_idx]]
            return accumulate(idx_l, col_l, w_l, sels, contrib)

        if theta is None or k is None:
            sels = [np.ones(len(docs), bool) for _, _, docs in specs]
            scores = score_subset(sels)
            return [
                (docs, sc) for (_, _, docs), sc in zip(specs, scores)
            ], None

        # ---- round A: the max(4k, 64) highest-UB docs, scored exactly
        obs.count("ranked_rescore_rounds", 2)
        cap = max(4 * k, 64)
        sel_a = []
        for i, (_, _, docs) in enumerate(specs):
            sel = np.zeros(len(docs), bool)
            if len(docs) > cap:
                sel[np.argpartition(-ubs[i], cap - 1)[:cap]] = True
            elif len(docs):
                sel[:] = True
            sel_a.append(sel)

        # ---- round A launch; on the resident torch backend the theta
        # raise rides in the SAME round as the round-A scoring: an f32
        # lower-bound top-k on the device emits the round-B UB mask.  The
        # authoritative theta2 is still the exact f64 host value below --
        # the device mask is only a provable SUPERSET filter.
        idx_l, col_l, w_l, g_idx = pairs_for(sel_a)
        self.stats["scored_pairs"] += len(g_idx)
        mask_b = None
        if self.resident == "kernel":
            g_pos = pos[g_idx]
            rows_n, lanes = g_pos >> 7, g_pos & (BLOCK_VALS - 1)
            urows, inv = np.unique(rows_n, return_inverse=True)
            out_u, hit = self._cache_lookup(urows)
            miss = ~hit
            mrows = urows[miss]
            if self.core.use_device and 0 < len(mrows) <= self.MAX_BUCKET:
                mask_b = self._theta_round_dev(
                    specs, sel_a, cap, k, theta, ubs,
                    idx_l, col_l, w_l, out_u, hit, inv, lanes, miss, mrows,
                )
            elif miss.any():
                self.stats["scored_rows"] += len(mrows)
                scored = self._score_miss_rows(mrows)
                out_u[miss] = scored
                self._cache_merge(mrows, scored)
            contrib = out_u[inv, lanes]
        else:
            contrib = core.flat_scores[pos[g_idx]]
        scores_a = accumulate(idx_l, col_l, w_l, sel_a, contrib)

        # ---- raise theta to the k-th true score of round A (exact f64:
        # the returned theta2 is bit-identical on every path)
        theta2 = theta.copy()
        for i, sc in enumerate(scores_a):
            if len(sc) >= k:
                kth = np.partition(sc, len(sc) - k)[len(sc) - k]
                theta2[i] = max(theta2[i], kth)

        # ---- round B: remaining docs whose UB clears the raised theta.
        # The device mask keeps a superset of {UB >= exact theta2}, and
        # every kept doc is scored exactly below.
        sel_b = []
        if mask_b is not None:
            off = 0
            for i, (_, _, docs) in enumerate(specs):
                nb_i = np.flatnonzero(~sel_a[i])
                m = mask_b[off : off + len(nb_i)]
                off += len(nb_i)
                sel = np.zeros(len(docs), bool)
                sel[nb_i[m]] = True
                self.stats["ub_filtered"] += int(len(nb_i) - sel.sum())
                sel_b.append(sel)
        else:
            for i, (_, _, docs) in enumerate(specs):
                sel = ~sel_a[i] & (ubs[i] >= theta2[i])
                self.stats["ub_filtered"] += int(
                    (~sel_a[i]).sum() - sel.sum()
                )
                sel_b.append(sel)
        scores_b = score_subset(sel_b)

        out = []
        for i, (_, _, docs) in enumerate(specs):
            docs_i = np.concatenate([docs[sel_a[i]], docs[sel_b[i]]])
            sc_i = np.concatenate([scores_a[i], scores_b[i]])
            out.append((docs_i, sc_i))
        return out, theta2

    # ------------------------------------------------------------------
    # the Block-Max MaxScore batch loop
    # ------------------------------------------------------------------
    def _query_spec(self, q) -> tuple[np.ndarray, np.ndarray]:
        """(unique terms with non-empty lists, multiplicities as f64)."""
        terms, mult = np.unique(np.asarray(q, dtype=np.int64), return_counts=True)
        keep = self.index.list_sizes[terms] > 0
        return terms[keep], mult[keep].astype(np.float64)

    def topk_batch(
        self, queries: list[list[int]], k: int
    ) -> list[tuple[np.ndarray, np.ndarray]]:
        """Exact BM25 top-k of each query; (docIDs, f64 scores) per query,
        sorted by (score desc, docID asc) -- identical to the exhaustive
        oracle, including the tie-break."""
        a = self.arena
        self.stats["batches"] += 1
        specs = [self._query_spec(q) for q in queries]

        # ---- phase 1: seed theta from every term's best-bounded blocks
        with obs.span("seed", path="ranked"):
            self._flat_init()
            seed_specs, seed_qids = [], []
            for i, (terms, mult) in enumerate(specs):
                if len(terms) == 0:
                    continue
                chunks = []
                for t in terms:
                    r0 = int(a.list_blk_offsets[int(t)])
                    r1 = int(a.list_blk_offsets[int(t) + 1])
                    rows = np.arange(r0, r1, dtype=np.int64)
                    top = rows[np.argsort(-self.bounds[rows], kind="stable")]
                    chunks.append(self._block_docs(top[: self.seed_blocks]))
                docs = np.unique(np.concatenate(chunks))
                seed_specs.append((terms, mult, docs))
                seed_qids.append(i)
            seed_scored, _ = self._score_specs(seed_specs)
            self.stats["seed_pairs"] += sum(
                len(t) * len(d) for t, _, d in seed_specs
            )
            theta = np.full(len(queries), -np.inf)
            seeds: dict[int, np.ndarray] = {}
            for (terms, mult, docs), (_, sc), i in zip(
                seed_specs, seed_scored, seed_qids
            ):
                seeds[i] = docs
                if len(docs) >= k:
                    theta[i] = np.partition(sc, len(sc) - k)[len(sc) - k]

        # ---- phase 2, resident="kernel": the device Block-Max pivot.
        # Theta reduces to one qmin per block on the host; the pivot
        # kernels keep/compact candidate blocks over the resident bound
        # tiles.  Admissible, so phase 3's exact rescore still reproduces
        # the oracle bit for bit.
        if self.resident == "kernel":
            with obs.span("pivot", path="ranked", resident="kernel"):
                cand_docs = self._pivot_candidates(specs, theta)
                final_specs = []
                for i, (terms, mult) in enumerate(specs):
                    if len(terms) == 0:
                        final_specs.append(
                            (terms, mult, np.zeros(0, np.int64))
                        )
                        continue
                    cand_chunks = [seeds[i]] if i in seeds else []
                    if len(cand_docs[i]):
                        cand_chunks.append(cand_docs[i])
                    cand = (
                        np.unique(np.concatenate(cand_chunks))
                        if cand_chunks
                        else np.zeros(0, np.int64)
                    )
                    self.stats["candidates"] += len(cand)
                    final_specs.append((terms, mult, cand))
            with obs.span("rescore", path="ranked"):
                final_scored, theta2 = self._score_specs(final_specs, theta, k)
            self._note_theta(theta2)
            return [topk_select(docs, sc, k) for docs, sc in final_scored]

        # ---- phase 2, resident="mirror": range-aligned block pivot
        # (Block-Max WAND) on the host.  A block whose aligned upper bound
        # misses theta generates no candidates -- and any doc with score
        # >= theta survives through EVERY block that contains it.
        with obs.span("pivot", path="ranked", resident="mirror"):
            final_specs = []
            for i, (terms, mult) in enumerate(specs):
                if len(terms) == 0:
                    final_specs.append((terms, mult, np.zeros(0, np.int64)))
                    continue
                ub = mult * self.list_ub[terms]
                total_ub = float(ub.sum())
                cand_chunks = [seeds[i]] if i in seeds else []
                aligned = self._aligned_rest(terms, mult)
                for j, (rows, rest) in enumerate(aligned):
                    keep = mult[j] * self.bounds[rows] + rest >= theta[i]
                    self.stats["blocks_kept"] += int(keep.sum())
                    self.stats["blocks_total"] += len(rows)
                    share = (
                        float(theta[i]) * float(ub[j]) / total_ub
                        if total_ub > 0 and np.isfinite(theta[i])
                        else -np.inf
                    )
                    cand_chunks.append(
                        self._block_docs_filtered(
                            rows[keep], rest[keep], float(mult[j]),
                            float(theta[i]), share,
                        )
                    )
                cand = (
                    np.unique(np.concatenate(cand_chunks))
                    if cand_chunks
                    else np.zeros(0, np.int64)
                )
                self.stats["candidates"] += len(cand)
                final_specs.append((terms, mult, cand))

        # ---- phase 3: doc-aligned block-max pivot filter (UB >= theta) +
        # two-round threshold+compact rescore + (score desc, docID asc) cut
        with obs.span("rescore", path="ranked"):
            final_scored, theta2 = self._score_specs(final_specs, theta, k)
        self._note_theta(theta2)
        return [topk_select(docs, sc, k) for docs, sc in final_scored]
