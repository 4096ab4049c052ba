"""Host packer, numpy mirrors and numpy-in/numpy-out dispatch of the
Elias-Fano NextGEQ tile family.

Counterpart of ``repro/kernels/ef_search/ops.py``.  The arena stores every
EF block as a fixed-width tile: 128 uint16 low-bit lanes, 24 uint16
high-stream words (384 unary bits: 128 ones + up to 256 zeros) and one
uint8 ``l`` -- 308 bytes against the 1024 of a Stream-VByte row.  Values
are rebased per block (``r = value - block_base - 1``); a block is
EF-eligible iff its rebased universe stays below 2^23, which caps ``l``
at 15 (uint16 lanes) and ``high`` at 255 (the 384-bit stream).
"""

from __future__ import annotations

import numpy as np
import torch

from ..vbyte_decode.kernel import BLOCK_VALS
from ..vbyte_decode.ops import BACKENDS
from .kernel import EF_HI_WORDS, ef_search as ef_search_dev

# largest per-BLOCK rebased universe an EF tile can hold: l = bitlen - 8
# keeps the high part < 256 (384-bit unary stream) and l <= 15 keeps the
# low bits inside uint16 lanes
EF_BLOCK_UNIVERSE_MAX = 1 << 23


def ef_block_eligible(vals: np.ndarray, bases: np.ndarray) -> np.ndarray:
    """[n] bool: can each row of block values become an EF tile?

    vals: [n, 128] absolute ascending docIDs (padding lanes included);
    bases: [n] the block's ``block_base`` sidecar.
    """
    u = vals[:, -1] - bases - 1
    return (u >= 0) & (u < EF_BLOCK_UNIVERSE_MAX)


def ef_pack_blocks(
    vals: np.ndarray, bases: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack rows of 128 ascending docIDs into EF tiles.

    vals: [n, 128] absolute values; bases: [n] block_base per row.  Every
    row must be ``ef_block_eligible``.  Returns ``(lo [n,128] uint16,
    hi [n,24] uint16, lbits [n] uint8)``.
    """
    # lazy: repro_torch.core imports the engines, which import this module
    from ...core.costs import bit_length_np

    vals = np.asarray(vals, dtype=np.int64)
    bases = np.asarray(bases, dtype=np.int64)
    n = vals.shape[0]
    if n == 0:
        return (
            np.zeros((0, BLOCK_VALS), np.uint16),
            np.zeros((0, EF_HI_WORDS), np.uint16),
            np.zeros(0, np.uint8),
        )
    r = vals - bases[:, None] - 1
    u = r[:, -1]
    if not ((u >= 0) & (u < EF_BLOCK_UNIVERSE_MAX)).all():
        raise ValueError("block universe out of EF tile range")
    lbits = np.maximum(bit_length_np(u) - 8, 0).astype(np.int64)
    lo = (r & ((1 << lbits)[:, None] - 1)).astype(np.uint16)
    hi_val = r >> lbits[:, None]  # [n, 128] <= 255 by construction
    ones_pos = hi_val + np.arange(BLOCK_VALS, dtype=np.int64)  # < 384
    bits = np.zeros((n, EF_HI_WORDS * 16), np.uint16)
    bits[np.arange(n)[:, None], ones_pos] = 1
    weights = (1 << np.arange(16, dtype=np.uint32)).astype(np.uint32)
    hi = (
        (bits.reshape(n, EF_HI_WORDS, 16).astype(np.uint32) * weights)
        .sum(axis=2)
        .astype(np.uint16)
    )
    return lo, hi, lbits.astype(np.uint8)


def ef_decode_rows_np(
    lo_rows: np.ndarray, hi_rows: np.ndarray, lbits_rows: np.ndarray,
    bases: np.ndarray,
) -> np.ndarray:
    """[n, 128] absolute int64 docIDs of gathered EF tiles (host decode).

    Every row holds exactly 128 one-bits, so ``np.nonzero`` over the
    expanded bit tile yields each lane's high part directly.
    """
    lo_rows = np.asarray(lo_rows, dtype=np.int64)
    hi_rows = np.asarray(hi_rows, dtype=np.int64)
    n = lo_rows.shape[0]
    if n == 0:
        return np.zeros((0, BLOCK_VALS), np.int64)
    j = np.arange(EF_HI_WORDS * 16, dtype=np.int64)
    bits = (hi_rows[:, j >> 4] >> (j & 15)) & 1
    ones_pos = np.nonzero(bits)[1].reshape(n, BLOCK_VALS)
    high = ones_pos - np.arange(BLOCK_VALS, dtype=np.int64)
    l = np.asarray(lbits_rows, dtype=np.int64)[:, None]
    return np.asarray(bases, np.int64)[:, None] + 1 + ((high << l) | lo_rows)


def ef_search_np(
    lo: np.ndarray, hi: np.ndarray, lbits: np.ndarray,
    block_base: np.ndarray, rows: np.ndarray, probes: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized-numpy fused EF search; duplicate rows are decoded once.

    Returns (value [C] int64, rank [C] int64) exactly as
    ``vbyte_decode.ops.decode_search_np`` (value of the LAST lane when
    none qualifies; callers mask past-the-end cursors).
    """
    rows = np.asarray(rows, dtype=np.int64)
    probes = np.asarray(probes, dtype=np.int64)
    urows, inv = np.unique(rows, return_inverse=True)
    uvals = ef_decode_rows_np(
        lo[urows], hi[urows], np.asarray(lbits)[urows],
        np.asarray(block_base, np.int64)[urows],
    )
    vals = uvals[inv]  # [C, 128]
    rank = (vals < probes[:, None]).sum(axis=1)
    value = vals[np.arange(len(rows)), np.minimum(rank, BLOCK_VALS - 1)]
    return value, rank


def ef_search(
    lo, hi, lbits, block_base, rows, probes, backend: str = "numpy",
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Fused EF NextGEQ over arena tiles; numpy in/out, both backends.

    lo [nb,128] uint16 / hi [nb,24] uint16 / lbits [nb] uint8 /
    block_base [nb]: the EF half of a multi-codec arena.  rows [C]: the
    tile row located for each cursor.  probes [C]: absolute probe docIDs
    (staged as int32).  Returns (value [C] int64, rank [C] int64).
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: expected one of {BACKENDS}")
    if backend == "numpy":
        return ef_search_np(lo, hi, lbits, block_base, rows, probes)

    def dev(x):
        return torch.as_tensor(np.asarray(x).astype(np.int32), device=device)

    value, rank = ef_search_dev(
        dev(lo), dev(hi), dev(lbits), dev(block_base), dev(rows), dev(probes)
    )
    out = torch.stack([value, rank]).cpu().numpy().astype(np.int64)
    return out[0], out[1]
