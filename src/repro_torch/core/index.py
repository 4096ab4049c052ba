"""2-level partitioned inverted index (paper Section 2) + query processing.

Layout (arena style, all flat numpy arrays -> directly shardable / shippable
to device):

  L1 (per partition): ``endpoints`` (last docID), ``sizes``, ``tags``
      (0 = VByte, 1 = bit-vector, 2 = Elias-Fano), ``offsets`` (byte offset
      into L2).
  L2: one concatenated ``uint8`` payload buffer.
  Per list: ``list_part_offsets`` slicing the L1 arrays, plus the list length.

VByte partitions store the plain-VByte bytes of ``gap - 1`` (see costs.py);
bit-vector partitions store the packed characteristic bitmap of the re-based
values over ``universe = sum(gaps)`` bits; Elias-Fano partitions store the
high/low split of ``core.eliasfano`` (DESIGN.md §14).  The DP partitioner is
codec-agnostic (the paper's point): with ``codecs="auto"`` each partition
independently picks the codec with the smallest EXACT serialized payload
(ties prefer VByte, then bitvector -- deterministic), still in linear time;
``codecs="svb"`` (default) keeps the legacy 2-way VByte/bitvector choice
byte-identically, and ``codecs="ef"`` prefers Elias-Fano wherever the
partition is EF-eligible (universe < 2^23; see ``core.eliasfano``).

Ranked retrieval (DESIGN.md §5) adds an OPTIONAL second payload stream:
per-posting term frequencies, VByte-encoded (``tf - 1``) per partition into
``freq_payload`` / ``freq_offsets`` -- the same partition boundaries as the
docID stream, whatever the docID codec -- plus ``doc_lens`` (document length
per docID) and the collection stats BM25 needs (``n_docs_real``, ``avg_dl``).
Pass ``freqs=`` to ``build_partitioned_index`` to populate it.

Query ops: ``decode_list``, ``next_geq`` and ``intersect`` (boolean AND, the
paper's Tables 5/8 workload).  They delegate to the batched
``repro_torch.core.query_engine.QueryEngine``, whose default path is the
FUSED device pipeline over the block arena exposed by ``.arena`` (one
locate searchsorted + the decode+NextGEQ kernels); the original per-query
NextGEQ loop survives as ``intersect_scalar`` -- the reference the engine
is tested against.  That loop reads partitions through a host (numpy)
engine, so it stays independent of the CUDA kernels it checks.

Counterpart of ``repro/core/index.py``: the same build functions give
byte-identical arrays for the same corpus.

The un-partitioned baseline (``UnpartitionedIndex``) encodes each list as one
VByte stream chopped into skip-blocks of 128 postings (the paper's baseline:
"a posting list is split into blocks of 128 postings ... encoded separately").
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .bitvector import bitvector_decode, bitvector_encode
from .costs import DEFAULT_F, bit_length_np, gaps_from_sorted
from .eliasfano import (
    EF_UNIVERSE_MAX,
    ef_decode,
    ef_encode,
    ef_payload_bytes,
)
from .partition import (
    optimal_partitioning,
    partition_payload_costs,
    uniform_partitioning,
)
from .vbyte import vbyte_decode, vbyte_encode

TAG_VBYTE = 0
TAG_BITVECTOR = 1
TAG_EF = 2

CODEC_POLICIES = ("svb", "auto", "ef")


@dataclass
class PartitionedIndex:
    n_lists: int = 0
    list_part_offsets: np.ndarray = field(default_factory=lambda: np.zeros(1, np.int64))
    list_sizes: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    endpoints: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    sizes: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    tags: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int8))
    offsets: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    payload: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))
    F: int = DEFAULT_F
    # ranked-retrieval payload stream (optional; DESIGN.md §5): per-posting
    # term frequencies, VByte(tf - 1) per partition, + document lengths
    freq_offsets: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    freq_payload: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))
    doc_lens: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    # codec-choice policy the build used for the L2 payloads ("svb" =
    # legacy 2-way VByte/bitvector, "auto"/"ef" may tag TAG_EF partitions)
    codecs: str = "svb"
    _engine: object = field(default=None, repr=False, compare=False)
    _host_engine: object = field(default=None, repr=False, compare=False)
    _arena: object = field(default=None, repr=False, compare=False)
    _arena_cache: dict = field(
        default_factory=dict, repr=False, compare=False
    )
    # policy-independent half of the arena transcode (see core.arena)
    _transcode: object = field(default=None, repr=False, compare=False)

    @property
    def has_freqs(self) -> bool:
        return self.doc_lens.size > 0

    @property
    def n_docs_real(self) -> int:
        """Documents that actually occur in some list (idf's N)."""
        return int(np.count_nonzero(self.doc_lens))

    @property
    def avg_dl(self) -> float:
        """Mean length of the REAL documents (BM25's avgdl)."""
        n = self.n_docs_real
        return float(self.doc_lens.sum()) / n if n else 1.0

    @property
    def engine(self):
        """Lazily-built batched query engine over this (immutable) arena."""
        if self._engine is None:
            from .query_engine import QueryEngine

            self._engine = QueryEngine(self)
        return self._engine

    @property
    def host_engine(self):
        """Host (numpy) engine behind the scalar reference loop."""
        if self._host_engine is None:
            from .query_engine import QueryEngine

            self._host_engine = QueryEngine(self, backend="numpy")
        return self._host_engine

    @property
    def arena(self):
        """Block-aligned device arena (built once, shared by all engines).

        Every partition transcoded into the fixed 512-byte Stream-VByte
        tiles of ``repro_torch.kernels.vbyte_decode`` plus the per-block
        sidecars (base docIDs, rebased endpoint keys) the fused device query
        path searches over -- see ``repro_torch.core.arena``.
        """
        if self._arena is None:
            self._arena = self.arena_for("auto")
        return self._arena

    def arena_for(self, codec_policy: str = "auto"):
        """The block arena under one codec policy, cached per policy.

        ``"auto"`` follows the index's partition tags (an all-SVB arena
        for legacy indexes -- byte-identical to the pre-multi-codec
        build); ``"svb"`` forces every partition into Stream-VByte tiles
        (the single-codec baseline the Pareto bench compares against);
        ``"ef"`` forces EF tiles wherever the block is EF-eligible.
        """
        if codec_policy not in CODEC_POLICIES:
            raise ValueError(
                f"unknown codec policy {codec_policy!r}: "
                f"expected one of {CODEC_POLICIES}"
            )
        got = self._arena_cache.get(codec_policy)
        if got is None:
            from .arena import build_arena

            got = build_arena(self, codec_policy=codec_policy)
            self._arena_cache[codec_policy] = got
        return got

    # ---------------- stats ----------------
    def space_bits(self) -> int:
        """Total space accounted the paper's way: F bits per partition + L2."""
        return int(len(self.endpoints) * self.F + self.payload.size * 8)

    def bits_per_int(self) -> float:
        n = int(self.list_sizes.sum())
        return self.space_bits() / max(n, 1)

    # ---------------- access ----------------
    def _list_slice(self, t: int) -> slice:
        return slice(int(self.list_part_offsets[t]), int(self.list_part_offsets[t + 1]))

    def decode_list(self, t: int) -> np.ndarray:
        return self.engine.decode_list(t)

    def _decode_partition(self, p: int, base: int) -> np.ndarray:
        """Raw single-partition decode (reference path; the engine caches)."""
        off = int(self.offsets[p])
        end = int(self.offsets[p + 1]) if p + 1 < len(self.offsets) else self.payload.size
        size = int(self.sizes[p])
        if self.tags[p] == TAG_VBYTE:
            gaps = vbyte_decode(self.payload[off:end], size).astype(np.int64) + 1
            return base + np.cumsum(gaps)
        if self.tags[p] == TAG_EF:
            return ef_decode(self.payload[off:end], size) + base + 1
        universe = int(self.endpoints[p]) - base
        rebased = bitvector_decode(self.payload[off:end], universe)
        return rebased + base + 1

    def _decode_partition_freqs(self, p: int) -> np.ndarray:
        """Per-posting term frequencies of partition p (tf >= 1)."""
        off = int(self.freq_offsets[p])
        end = (
            int(self.freq_offsets[p + 1])
            if p + 1 < len(self.freq_offsets)
            else self.freq_payload.size
        )
        return (
            vbyte_decode(self.freq_payload[off:end], int(self.sizes[p])).astype(
                np.int64
            )
            + 1
        )

    def decode_list_freqs(self, t: int) -> np.ndarray:
        """Term frequencies of list t, aligned with ``decode_list(t)``."""
        if not self.has_freqs:
            raise ValueError("index was built without a freq stream")
        sl = self._list_slice(t)
        chunks = [self._decode_partition_freqs(p) for p in range(sl.start, sl.stop)]
        return np.concatenate(chunks) if chunks else np.zeros(0, np.int64)

    def next_geq(self, t: int, x: int, cursor: int | None = None) -> tuple[int, int]:
        """Smallest element >= x in list t (and the partition cursor).

        Returns (value, cursor); value == -1 when x exceeds the list.
        ``cursor`` lets callers resume forward scans (the AND loop).  Thin
        scalar wrapper over the host engine's decoded-partition cache.
        """
        sl = self._list_slice(t)
        lo = sl.start if cursor is None else max(cursor, sl.start)
        eps = self.endpoints[lo : sl.stop]
        k = int(np.searchsorted(eps, x, side="left"))
        p = lo + k
        if p >= sl.stop:
            return -1, sl.stop
        vals = self.host_engine.partition_values(p)
        k = int(np.searchsorted(vals, x, side="left"))
        return int(vals[k]), p  # k < len(vals) because x <= endpoint

    def intersect(self, terms: list[int]) -> np.ndarray:
        """Boolean AND of the given lists (batched engine, single query)."""
        return self.engine.intersect_batch([list(terms)])[0]

    def intersect_scalar(self, terms: list[int]) -> np.ndarray:
        """Boolean AND via the per-query in-order NextGEQ loop.

        The paper-faithful scalar algorithm, kept as the reference/baseline
        the batched engine is validated and benchmarked against.
        """
        if not terms:
            return np.zeros(0, np.int64)
        order = sorted(terms, key=lambda t: int(self.list_sizes[t]))
        out = []
        cursors: dict[int, int | None] = {t: None for t in order}
        cand, cursors[order[0]] = self.next_geq(order[0], 0)
        while cand >= 0:
            matched = True
            for t in order[1:]:
                v, cursors[t] = self.next_geq(t, cand, cursors[t])
                if v < 0:
                    return np.asarray(out, dtype=np.int64)
                if v != cand:
                    cand = v
                    matched = False
                    break
            if matched:
                out.append(cand)
                cand, cursors[order[0]] = self.next_geq(
                    order[0], cand + 1, cursors[order[0]]
                )
            else:
                v, cursors[order[0]] = self.next_geq(order[0], cand, cursors[order[0]])
                if v < 0:
                    break
                cand = v
        return np.asarray(out, dtype=np.int64)


def _choose_codec(n: int, u_ef: int, ce_: int, cb_: int, codecs: str) -> int:
    """Per-partition codec tag under one policy; EXACT serialized bytes.

    ``u_ef = endpoint - base - 1`` (the largest rebased value), ``ce_`` /
    ``cb_`` the VByte / bitvector payload BIT costs from
    ``partition_payload_costs``.  The 3-way choice compares serialized
    byte sizes (what actually lands in L2) and breaks ties
    deterministically: VByte first (matching the legacy ``ce <= cb``
    preference), then bitvector -- so a dense partition where EF and
    bitvector cost the same stays a bitvector.
    """
    if codecs == "svb":
        return TAG_VBYTE if ce_ <= cb_ else TAG_BITVECTOR
    eligible = 0 <= u_ef < EF_UNIVERSE_MAX
    if codecs == "ef" and eligible:
        return TAG_EF
    vb = ce_ // 8
    bv = (cb_ + 7) // 8
    ef = ef_payload_bytes(n, u_ef) if eligible else None
    if vb <= bv and (ef is None or vb <= ef):
        return TAG_VBYTE
    if ef is None or bv <= ef:
        return TAG_BITVECTOR
    return TAG_EF


def _encode_partitions(seq: np.ndarray, P: np.ndarray, F: int,
                       codecs: str = "svb"):
    """Encode one list given endpoints P; returns per-partition arrays."""
    gaps = gaps_from_sorted(seq)
    pe, pb = partition_payload_costs(gaps, P)
    starts = np.concatenate([[0], P[:-1]])
    endpoints, sizes, tags, payloads = [], [], [], []
    base = -1
    for s, r, ce_, cb_ in zip(starts, P, pe, pb):
        part = seq[s:r]
        endpoints.append(int(part[-1]))
        sizes.append(int(r - s))
        tag = _choose_codec(
            int(r - s), int(part[-1]) - base - 1, int(ce_), int(cb_), codecs
        )
        tags.append(tag)
        if tag == TAG_VBYTE:
            g = gaps[s:r] - 1
            payloads.append(vbyte_encode(g.astype(np.uint64)))
        elif tag == TAG_EF:
            universe = int(part[-1]) - base - 1
            payloads.append(ef_encode(part - base - 1, universe))
        else:
            universe = int(part[-1]) - base
            payloads.append(bitvector_encode(part - base - 1, universe))
        base = int(part[-1])
    return endpoints, sizes, tags, payloads


def build_partitioned_index(
    lists: list[np.ndarray],
    strategy: str = "optimal",
    F: int = DEFAULT_F,
    uniform_block: int = 128,
    partitioner=None,
    freqs: list[np.ndarray] | None = None,
    codecs: str = "svb",
) -> PartitionedIndex:
    """strategy in {"optimal", "uniform", "eps", "single"} or pass partitioner.

    ``freqs`` (one tf >= 1 array per list, aligned with the docIDs) attaches
    the ranked-retrieval payload stream: per-partition VByte(tf - 1) plus the
    implied document lengths / collection stats (DESIGN.md §5).

    ``codecs`` in {"svb", "auto", "ef"}: the per-partition codec-choice
    policy (see the module docstring).  The default keeps the legacy 2-way
    VByte/bitvector build byte-identical; the freq stream is VByte(tf - 1)
    per partition whatever the docID codec.
    """
    from .partition import eps_optimal

    if codecs not in CODEC_POLICIES:
        raise ValueError(
            f"unknown codecs policy {codecs!r}: expected one of "
            f"{CODEC_POLICIES}"
        )

    all_ep, all_sz, all_tag, all_pay = [], [], [], []
    all_fpay: list[np.ndarray] = []
    lp_off = [0]
    list_sizes = []
    for li, seq in enumerate(lists):
        seq = np.asarray(seq, dtype=np.int64)
        if seq.size == 0:
            # an empty list would produce an empty partition, which no codec
            # can serialize (every partition stores its endpoint); fail at
            # build time instead of deep inside the encoder
            raise ValueError(
                f"lists[{li}] is empty: posting lists must be non-empty"
            )
        gaps = gaps_from_sorted(seq)
        if partitioner is not None:
            P = partitioner(gaps)
        elif strategy == "optimal":
            P = optimal_partitioning(gaps, F)
        elif strategy == "uniform":
            P = uniform_partitioning(len(seq), uniform_block)
        elif strategy == "eps":
            P = eps_optimal(gaps, F)
        elif strategy == "single":
            P = np.array([len(seq)], dtype=np.int64)
        else:
            raise ValueError(strategy)
        ep, sz, tag, pay = _encode_partitions(seq, P, F, codecs=codecs)
        all_ep += ep
        all_sz += sz
        all_tag += tag
        all_pay += pay
        if freqs is not None:
            tf = np.asarray(freqs[li], dtype=np.int64)
            if tf.shape != seq.shape or (len(tf) and tf.min() < 1):
                raise ValueError(f"freqs[{li}] must be tf >= 1 aligned with the list")
            starts = np.concatenate([[0], P[:-1]])
            all_fpay += [
                vbyte_encode((tf[s:r] - 1).astype(np.uint64))
                for s, r in zip(starts, P)
            ]
        lp_off.append(lp_off[-1] + len(ep))
        list_sizes.append(len(seq))

    offsets = np.zeros(len(all_pay), dtype=np.int64)
    lens = np.array([p.size for p in all_pay], dtype=np.int64)
    if len(lens):
        offsets[1:] = np.cumsum(lens)[:-1]
    payload = np.concatenate(all_pay) if all_pay else np.zeros(0, np.uint8)
    freq_offsets = np.zeros(0, np.int64)
    freq_payload = np.zeros(0, np.uint8)
    doc_lens = np.zeros(0, np.int64)
    if freqs is not None:
        from ..data.postings import doc_lengths

        freq_offsets = np.zeros(len(all_fpay), dtype=np.int64)
        flens = np.array([p.size for p in all_fpay], dtype=np.int64)
        if len(flens):
            freq_offsets[1:] = np.cumsum(flens)[:-1]
        freq_payload = (
            np.concatenate(all_fpay) if all_fpay else np.zeros(0, np.uint8)
        )
        doc_lens = doc_lengths(lists, freqs)
    return PartitionedIndex(
        n_lists=len(lists),
        list_part_offsets=np.asarray(lp_off, dtype=np.int64),
        list_sizes=np.asarray(list_sizes, dtype=np.int64),
        endpoints=np.asarray(all_ep, dtype=np.int64),
        sizes=np.asarray(all_sz, dtype=np.int64),
        tags=np.asarray(all_tag, dtype=np.int8),
        offsets=offsets,
        payload=payload,
        F=F,
        freq_offsets=freq_offsets,
        freq_payload=freq_payload,
        doc_lens=doc_lens,
        codecs=codecs,
    )


def build_unpartitioned_index(lists: list[np.ndarray], F: int = DEFAULT_F) -> PartitionedIndex:
    """The paper's baseline: VByte in skip-blocks of 128 postings.

    Reuses the PartitionedIndex container with every partition tagged VByte
    and uniform 128-boundaries -- equivalent to the classic blocked layout.
    """
    return _build_vbyte_blocked(lists, F)


def _build_vbyte_blocked(lists: list[np.ndarray], F: int) -> PartitionedIndex:
    all_ep, all_sz, all_tag, all_pay = [], [], [], []
    lp_off = [0]
    list_sizes = []
    for seq in lists:
        seq = np.asarray(seq, dtype=np.int64)
        gaps = gaps_from_sorted(seq)
        P = uniform_partitioning(len(seq), 128)
        starts = np.concatenate([[0], P[:-1]])
        # VByte codes value by value, so one list-wide stream cut at the
        # block boundaries is byte for byte the per-block streams
        nbytes = np.cumsum((bit_length_np(gaps - 1) + 6) // 7)
        cuts = np.concatenate([[0], nbytes[P - 1]])
        stream = vbyte_encode((gaps - 1).astype(np.uint64))
        all_ep += seq[P - 1].tolist()
        all_sz += (P - starts).tolist()
        all_tag += [TAG_VBYTE] * len(P)
        all_pay += [stream[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
        lp_off.append(lp_off[-1] + len(P))
        list_sizes.append(len(seq))
    offsets = np.zeros(len(all_pay), dtype=np.int64)
    lens = np.array([p.size for p in all_pay], dtype=np.int64)
    if len(lens):
        offsets[1:] = np.cumsum(lens)[:-1]
    payload = np.concatenate(all_pay) if all_pay else np.zeros(0, np.uint8)
    return PartitionedIndex(
        n_lists=len(lists),
        list_part_offsets=np.asarray(lp_off, dtype=np.int64),
        list_sizes=np.asarray(list_sizes, dtype=np.int64),
        endpoints=np.asarray(all_ep, dtype=np.int64),
        sizes=np.asarray(all_sz, dtype=np.int64),
        tags=np.asarray(all_tag, dtype=np.int8),
        offsets=offsets,
        payload=payload,
        F=F,
    )
