"""Block-aligned device arena over a ``PartitionedIndex``.

Counterpart of ``repro/core/arena.py``; the host arrays are byte-identical
to the reference's.  The on-disk layout of the index (plain-VByte,
bit-vector or Elias-Fano payloads at byte offsets) is great for space but
hostile to a device hot path, so every partition is transcoded ONCE into
the fixed-block Stream-VByte layout of ``repro_torch.kernels.vbyte_decode``:

  * 128 values / 512 data bytes per block (``BLOCK_VALS`` / ``BLOCK_BYTES``),
  * each partition padded to WHOLE blocks (pad gap-1 = 0, so padded lanes
    keep ascending past the partition endpoint -- they can never win a
    NextGEQ whose probe is <= the endpoint),
  * blocks of one partition are consecutive rows, partitions of one list are
    consecutive runs, lists are laid out in id order.

Per-block sidecars make every block self-decoding and directly searchable:

  * ``block_base[b]``  -- absolute docID preceding the block's first value;
  * ``block_keys[b]``  -- ``last_real_value + list_of_block * stride`` with
    ``stride > max docID + 1``: globally non-decreasing, so ONE searchsorted
    over all blocks locates the block holding NextGEQ(term, probe) for
    every cursor of a batch at once;
  * ``lane_valid[b, i]`` -- mask of real (non-padding) lanes.

``on(device)`` uploads the arrays to a torch device once.  The block keys
stay int64 there, so one searchsorted locates a cursor whatever the list
count; every other sidecar is narrowed to int32 as the reference narrows
its device copies.  ``stride_ok`` is the one device gate: the kernels'
int32 docIDs must hold ``probe <= stride - 1``, ``value + 128`` and the
``2^31 - 1`` sentinel.  ``device_ok`` keeps the reference's meaning (its
int32 keys hold ``(n_lists + 1) * stride``), recorded for checkpoints and
comparisons only: the torch backend does not read it.

MULTI-CODEC arenas: under ``codec_policy="auto"`` blocks of Elias-Fano
partitions (under ``"ef"`` every eligible block) are stored as EF tiles
(``ef_lo`` / ``ef_hi`` / ``ef_lbits``, 308 bytes per block) served by
``repro_torch.kernels.ef_search``.  ``block_codec[b]`` tags each block
(0 = SVB, 1 = EF) and ``codec_row[b]`` gives its row WITHIN its codec's
arrays.  Single-codec arenas keep ``block_codec = None``.

The policy-independent half of the transcode (decoding every partition
into padded block gaps and sidecars) is cached on the index, so building
the arena of a second policy over the same index only re-splits codecs.

When the index carries a freq stream (``index.has_freqs``), the arena also
carries the RANKED sidecar (``RankedSidecar``): the per-posting term
frequencies re-encoded into PARALLEL Stream-VByte blocks (``freq_lens`` /
``freq_data``, lane-aligned with the docID blocks and per BLOCK whatever
the docID codec), an 8-bit quantized length-norm code per lane
(``norm_q``), and the block-max structure: ``block_max_q[b]``, an
upper-bound-safe u8 quantization of the true maximum contract score inside
block b, plus per-list upper bounds and idf.  Quantization rounds UP (and
is then verified lane-exactly), so no block's true max ever exceeds its
dequantized bound -- the admissibility invariant Block-Max pruning rests
on.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from types import SimpleNamespace

import numpy as np
import torch

from ..kernels.vbyte_decode.kernel import BLOCK_VALS

TAG_VBYTE = 0
TAG_EF = 2  # mirrors repro_torch.core.index (which imports this module)

CODEC_SVB = 0  # block_codec values
CODEC_EF = 1
CODEC_POLICIES = ("svb", "auto", "ef")
# the kernels' int32 docIDs hold probe <= stride - 1, value + 128 and the
# 2^31 - 1 sentinel while stride stays under this
STRIDE_LIMIT = 2**31 - BLOCK_VALS - 2


@dataclass
class RankedSidecar:
    """Freq blocks + BM25 block-max structure riding the arena."""

    freq_lens: np.ndarray    # [nb_padded, 128] int32  (VByte of tf - 1)
    freq_data: np.ndarray    # [nb_padded, 512] uint8
    norm_q: np.ndarray       # [n_blocks, 128] uint8  quantized doc-norm code
    block_max_q: np.ndarray  # [n_blocks] uint8  quantized score upper bound
    bound_scale: np.float32  # dequant: bound(b) = block_max_q[b] * bound_scale
    idf: np.ndarray          # [n_lists] float32
    list_ub: np.ndarray      # [n_lists] float32  max block bound per list
    kmin: np.float32         # norm dequant grid (repro_torch.ranked.bm25)
    kstep: np.float32
    norm_table: np.ndarray   # [256] float32  gathered (never recomputed)
    params: object           # BM25Params the sidecar was built with

    def block_bounds(self) -> np.ndarray:
        """Dequantized per-block score upper bounds, float32 (admissible)."""
        return (
            self.block_max_q.astype(np.float32) * np.float32(self.bound_scale)
        )

    def nbytes(self) -> int:
        return int(
            self.freq_lens.nbytes + self.freq_data.nbytes + self.norm_q.nbytes
            + self.block_max_q.nbytes
        )


@dataclass
class DeviceArena:
    # per block (lens/data are padded by pack_blocks to a multiple of BM rows;
    # the sidecars below cover only the n_blocks real rows)
    lens: np.ndarray          # [nb_padded, 128] int32  control lengths
    data: np.ndarray          # [nb_padded, 512] uint8  data bytes
    block_base: np.ndarray    # [n_blocks] int64  docID before the block
    block_keys: np.ndarray    # [n_blocks] int64  last real value + list*stride
    lane_valid: np.ndarray    # [n_blocks, 128] bool  real-lane mask
    part_of_block: np.ndarray  # [n_blocks] int64
    # per partition
    first_blk: np.ndarray     # [n_parts] int64
    n_blk: np.ndarray         # [n_parts] int64
    sizes: np.ndarray         # [n_parts] int64  (values per partition)
    bases: np.ndarray         # [n_parts] int64  docID before the partition
    part_list: np.ndarray     # [n_parts] int64  owning list
    # per list
    list_blk_offsets: np.ndarray  # [n_lists + 1] int64
    stride: int = 0
    n_blocks: int = 0
    device_ok: bool = True
    ranked: RankedSidecar | None = None
    # multi-codec layout (None on single-codec arenas)
    block_codec: np.ndarray | None = None  # [n_blocks] uint8  0=SVB 1=EF
    codec_row: np.ndarray | None = None    # [n_blocks] int64  row in codec
    ef_lo: np.ndarray | None = None        # [n_ef, 128] uint16 low bits
    ef_hi: np.ndarray | None = None        # [n_ef, 24] uint16  high words
    ef_lbits: np.ndarray | None = None     # [n_ef] uint8  l per tile
    _dev: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def multi(self) -> bool:
        """True when blocks mix codecs (lens/data hold SVB rows only)."""
        return self.block_codec is not None

    @property
    def stride_ok(self) -> bool:
        """Whether the torch backend can serve this arena on a device: the
        docIDs, not the keys, must fit the kernels' int32."""
        return self.stride < STRIDE_LIMIT

    def on(self, device) -> SimpleNamespace:
        """Tensors of the arena on ``device``, uploaded once per device.

        ``block_keys`` stays int64 (``(n_lists + 1) * stride`` may pass
        2^31); the rest is int32, as the reference narrows its device
        copies: the int64 sidecars are cast, and the EF tiles widen from
        uint16/uint8.
        A ranked arena adds its freq tiles, the norm codes (kept uint8),
        idf per list, the norm table (float32) and ``lob``, the owning list
        of every block (int32), through which the kernels reach idf.
        """
        device = torch.device(device)
        got = self._dev.get(str(device))
        if got is None:
            def up(x, dtype=np.int32):
                return torch.from_numpy(
                    np.ascontiguousarray(x).astype(dtype, copy=False)
                ).to(device)

            got = SimpleNamespace(
                lens=up(self.lens),
                data=up(self.data, np.uint8),
                block_base=up(self.block_base),
                block_keys=up(self.block_keys, np.int64),
                part_of_block=up(self.part_of_block),
                first_blk=up(self.first_blk),
                list_blk_offsets=up(self.list_blk_offsets),
            )
            if self.block_codec is not None:
                got.block_codec = up(self.block_codec)
                got.codec_row = up(self.codec_row)
                got.ef_lo = up(self.ef_lo)
                got.ef_hi = up(self.ef_hi)
                got.ef_lbits = up(self.ef_lbits)
            r = self.ranked
            if r is not None:
                got.freq_lens = up(r.freq_lens)
                got.freq_data = up(r.freq_data, np.uint8)
                got.norm_q = up(r.norm_q, np.uint8)
                got.idf = up(r.idf, np.float32)
                got.norm_table = up(r.norm_table, np.float32)
                got.lob = up(self.part_list[self.part_of_block])
            self._dev[str(device)] = got
        return got

    def nbytes(self) -> int:
        """Host bytes of the arena, counted as the reference counts them."""
        total = int(
            self.lens.nbytes + self.data.nbytes + self.block_base.nbytes
            + self.block_keys.nbytes + self.lane_valid.nbytes
        ) + (self.ranked.nbytes() if self.ranked is not None else 0)
        if self.block_codec is not None:
            total += int(
                self.block_codec.nbytes + self.codec_row.nbytes
                + self.ef_lo.nbytes + self.ef_hi.nbytes
                + self.ef_lbits.nbytes
            )
        return total

    def device_nbytes(self, device) -> int:
        """Bytes the arena's tensors hold on ``device``."""
        dev = self.on(device)
        return sum(t.numel() * t.element_size() for t in vars(dev).values())


def _transcode(index) -> SimpleNamespace:
    """Decode every partition into padded block gaps + per-block sidecars.

    The policy-independent half of ``build_arena``, cached on the index.
    The ranked sidecar is per BLOCK whatever the docID codec, so it is
    built here too, once per index.
    """
    from .bitvector import bitvector_decode
    from .eliasfano import ef_decode
    from .vbyte import vbyte_decode

    cached = index._transcode
    if cached is not None:
        return cached
    n_parts = len(index.endpoints)
    sizes = index.sizes.astype(np.int64)
    part_counts = np.diff(index.list_part_offsets)
    part_list = np.repeat(np.arange(index.n_lists, dtype=np.int64), part_counts)
    # base docID per partition: endpoint of the previous partition of the
    # SAME list, -1 for the first partition of each list
    bases = np.empty(n_parts, np.int64)
    if n_parts:
        bases[0] = -1
        bases[1:] = index.endpoints[:-1]
        bases[index.list_part_offsets[:-1][part_counts > 0]] = -1

    n_blk = (sizes + BLOCK_VALS - 1) // BLOCK_VALS
    first_blk = np.zeros(n_parts, np.int64)
    if n_parts:
        first_blk[1:] = np.cumsum(n_blk)[:-1]
    nb = int(n_blk.sum())

    ranked_on = bool(getattr(index, "has_freqs", False))
    gaps_m1 = np.zeros(nb * BLOCK_VALS, np.uint32)
    block_base = np.zeros(nb, np.int64)
    block_last = np.zeros(nb, np.int64)
    lane_valid = np.zeros((nb, BLOCK_VALS), bool)
    tf_m1 = np.zeros(nb * BLOCK_VALS, np.uint32) if ranked_on else None
    norm_q = np.zeros(nb * BLOCK_VALS, np.uint8) if ranked_on else None
    if ranked_on:
        from ..ranked.bm25 import DEFAULT_BM25, quantize_norms

        q_norms, kmin, kstep = quantize_norms(
            index.doc_lens, index.avg_dl, DEFAULT_BM25
        )
    payload_end = index.offsets[1:].tolist() + [index.payload.size]
    for p in range(n_parts):
        off, end = int(index.offsets[p]), int(payload_end[p])
        size, base = int(sizes[p]), int(bases[p])
        if index.tags[p] == TAG_VBYTE:
            g = vbyte_decode(index.payload[off:end], size).astype(np.int64)
            vals = base + np.cumsum(g + 1)
        elif index.tags[p] == TAG_EF:
            vals = ef_decode(index.payload[off:end], size) + base + 1
            g = np.diff(vals, prepend=base) - 1
        else:
            universe = int(index.endpoints[p]) - base
            vals = bitvector_decode(index.payload[off:end], universe) + base + 1
            g = np.diff(vals, prepend=base) - 1
        b0, k = int(first_blk[p]), int(n_blk[p])
        s = b0 * BLOCK_VALS
        gaps_m1[s : s + size] = g
        block_base[b0] = base
        block_base[b0 + 1 : b0 + k] = vals[BLOCK_VALS - 1 :: BLOCK_VALS][: k - 1]
        block_last[b0 : b0 + k] = vals[
            np.minimum(np.arange(1, k + 1) * BLOCK_VALS, size) - 1
        ]
        lv = lane_valid[b0 : b0 + k].reshape(-1)
        lv[:size] = True
        if ranked_on:
            tf_m1[s : s + size] = index._decode_partition_freqs(p) - 1
            norm_q[s : s + size] = q_norms[vals]
    ranked = None
    if ranked_on:
        ranked = _build_ranked_sidecar(
            index, tf_m1, norm_q, lane_valid, part_list, n_blk, nb,
            kmin, kstep,
        )
    index._transcode = SimpleNamespace(
        n_parts=n_parts, sizes=sizes, part_list=part_list, bases=bases,
        n_blk=n_blk, first_blk=first_blk, nb=nb, gaps_m1=gaps_m1,
        block_base=block_base, block_last=block_last, lane_valid=lane_valid,
        ranked=ranked,
    )
    return index._transcode


def build_arena(index, codec_policy: str = "auto") -> DeviceArena:
    """Transcode every partition of ``index`` into the block arena.

    ``codec_policy`` picks the per-BLOCK storage codec: ``"svb"`` forces
    the all-Stream-VByte layout; ``"auto"`` stores the blocks of
    Elias-Fano-TAGGED partitions as EF tiles where block-eligible;
    ``"ef"`` stores EVERY eligible block as an EF tile.  When no block ends
    up EF, the arena is returned in the single-codec layout
    (``block_codec is None``).
    """
    from ..kernels.vbyte_decode.ops import pack_blocks

    if codec_policy not in CODEC_POLICIES:
        raise ValueError(
            f"codec_policy must be one of {CODEC_POLICIES}, got "
            f"{codec_policy!r}"
        )
    t = _transcode(index)
    nb, block_base, gaps_m1 = t.nb, t.block_base, t.gaps_m1

    # per-BLOCK codec split: EF tiles where the policy + per-block
    # eligibility allow, Stream-VByte rows (compacted) for the rest
    block_codec = codec_row = ef_lo = ef_hi = ef_lbits = None
    svb_gaps = gaps_m1
    if codec_policy != "svb" and nb:
        from ..kernels.ef_search.ops import ef_block_eligible, ef_pack_blocks

        blk_vals = block_base[:, None] + np.cumsum(
            gaps_m1.reshape(nb, BLOCK_VALS).astype(np.int64) + 1, axis=1
        )
        want = (
            np.repeat(np.asarray(index.tags) == TAG_EF, t.n_blk)
            if codec_policy == "auto"
            else np.ones(nb, bool)
        )
        ef_mask = want & ef_block_eligible(blk_vals, block_base)
        if ef_mask.any():
            block_codec = np.where(ef_mask, CODEC_EF, CODEC_SVB).astype(
                np.uint8
            )
            # row of each block WITHIN its codec's arrays (rows stay in
            # block order per codec, so gathered rows remain ascending)
            codec_row = np.zeros(nb, np.int64)
            codec_row[~ef_mask] = np.arange(int((~ef_mask).sum()))
            codec_row[ef_mask] = np.arange(int(ef_mask.sum()))
            ef_lo, ef_hi, ef_lbits = ef_pack_blocks(
                blk_vals[ef_mask], block_base[ef_mask]
            )
            svb_gaps = gaps_m1.reshape(nb, BLOCK_VALS)[~ef_mask].reshape(-1)
    lens, data, _ = pack_blocks(svb_gaps)

    n_parts = t.n_parts
    stride = int(index.endpoints.max()) + 2 if n_parts else 2
    part_of_block = np.repeat(np.arange(n_parts, dtype=np.int64), t.n_blk)
    block_keys = t.block_last + t.part_list[part_of_block] * stride
    list_blk_offsets = np.zeros(index.n_lists + 1, np.int64)
    if n_parts:
        list_blk_offsets[:] = np.concatenate(
            [t.first_blk, [nb]]
        )[index.list_part_offsets]
    # the reference's gate: its int32 device keys hold probe + term*stride
    # and value + 128 (the port's device path reads stride_ok instead)
    device_ok = (index.n_lists + 1) * stride < 2**31 - BLOCK_VALS - 2

    return DeviceArena(
        lens=lens,
        data=data,
        block_base=block_base,
        block_keys=block_keys,
        lane_valid=t.lane_valid,
        part_of_block=part_of_block,
        first_blk=t.first_blk,
        n_blk=t.n_blk,
        sizes=t.sizes,
        bases=t.bases,
        part_list=t.part_list,
        list_blk_offsets=list_blk_offsets,
        stride=stride,
        n_blocks=nb,
        device_ok=bool(device_ok),
        ranked=t.ranked,
        block_codec=block_codec,
        codec_row=codec_row,
        ef_lo=ef_lo,
        ef_hi=ef_hi,
        ef_lbits=ef_lbits,
    )


def _build_ranked_sidecar(
    index, tf_m1, norm_q, lane_valid, part_list, n_blk, nb, kmin, kstep
) -> RankedSidecar:
    """Freq blocks + admissible block-max bounds (see module docstring)."""
    from ..kernels.vbyte_decode.ops import pack_blocks
    from ..ranked.bm25 import (
        DEFAULT_BM25,
        dequant_norm,
        idf,
        norm_table,
        score_tf,
    )

    freq_lens, freq_data, _ = pack_blocks(tf_m1)
    idf_list = idf(index.n_docs_real, np.maximum(index.list_sizes, 1)).astype(
        np.float32
    )
    # true per-lane contract scores (build-time only; never materialized at
    # query time on the device)
    list_of_block = part_list[np.repeat(np.arange(len(n_blk)), n_blk)] \
        if len(n_blk) else np.zeros(0, np.int64)
    lane_idf = np.repeat(idf_list[list_of_block], BLOCK_VALS) \
        if nb else np.zeros(0, np.float32)
    k_hat = dequant_norm(norm_q, kmin, kstep)
    sc = score_tf(tf_m1.astype(np.int64) + 1, k_hat, lane_idf, DEFAULT_BM25)
    sc = np.where(lane_valid.reshape(-1), sc, np.float32(0.0))
    block_true_max = sc.reshape(nb, BLOCK_VALS).max(axis=1) if nb \
        else np.zeros(0, np.float32)
    # upper-bound-safe u8 quantization: ceil onto a 255-level grid, then
    # verify in the contract's float32 and bump where rounding undershot
    scale = float(block_true_max.max()) if nb else 0.0
    bound_scale = np.float32(scale / 255.0) if scale > 0 else np.float32(0.0)
    # f32(255) * bound_scale can round BELOW scale, leaving the q=255 block
    # inadmissible with no room to bump: nudge the scale up until it covers
    while scale > 0 and np.float32(255.0) * bound_scale < np.float32(scale):
        bound_scale = np.nextafter(bound_scale, np.float32(np.inf),
                                   dtype=np.float32)
    if scale > 0:
        q = np.ceil(
            block_true_max.astype(np.float64) / float(bound_scale) - 1e-9
        ).astype(np.int64)
        q = np.clip(q, 0, 255)
        for _ in range(3):  # f32 dequant may still round below the true max
            low = (q.astype(np.float32) * bound_scale) < block_true_max
            if not low.any():
                break
            q[low] = np.minimum(q[low] + 1, 255)
        q = q.astype(np.uint8)
        assert np.all(q.astype(np.float32) * bound_scale >= block_true_max)
    else:
        q = np.zeros(nb, np.uint8)
    bounds = q.astype(np.float32) * bound_scale
    list_ub = np.zeros(index.n_lists, np.float32)
    if nb:
        np.maximum.at(list_ub, list_of_block, bounds)
    return RankedSidecar(
        freq_lens=freq_lens,
        freq_data=freq_data,
        norm_q=norm_q.reshape(nb, BLOCK_VALS),
        block_max_q=q,
        bound_scale=bound_scale,
        idf=idf_list,
        list_ub=list_ub,
        kmin=kmin,
        kstep=kstep,
        norm_table=norm_table(kmin, kstep),
        params=DEFAULT_BM25,
    )
