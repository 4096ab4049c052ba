"""Point-wise cost functions for the two encoders of the paper.

The paper's framework needs, per element, the cost in bits under

  * ``E`` -- the point-wise encoder (VByte): ``8 * ceil(bits(x)/7)`` where
    ``x`` is the value actually written.  For a strictly increasing sequence
    we write ``gap - 1`` (gaps are >= 1), which makes the cost *exactly*
    split-invariant: the first element of a partition re-based by
    ``u_prev + 1`` equals its ``gap - 1``, identical to the interior d-gap
    encoding.
  * ``B`` -- the characteristic bit-vector: each element contributes its gap
    to the bitmap length, so ``B_k = gap_k`` bits.

Counterpart of ``repro/core/costs.py`` (its numpy half): these are the
costs the host partitioners and the index build use.
"""

from __future__ import annotations

import numpy as np

# Fixed per-partition header cost, in bits (paper section 4: F = 64).
DEFAULT_F = 64


def bit_length_np(x: np.ndarray) -> np.ndarray:
    """Number of bits in the binary representation of x (>=1 for x == 0)."""
    x = np.asarray(x, dtype=np.uint64)
    out = np.zeros(x.shape, dtype=np.int64)
    nz = x > 0
    # np.log2 is unsafe near powers of two for big ints; use frexp-free trick.
    out[nz] = np.floor(np.log2(x[nz].astype(np.float64))).astype(np.int64) + 1
    # Correct the (rare) boundary errors from float rounding.
    too_big = (np.uint64(1) << np.clip(out - 1, 0, 63).astype(np.uint64)) > x
    out[nz & too_big] -= 1
    too_small = out < 63
    lo = (np.uint64(1) << np.clip(out + 1, 0, 63).astype(np.uint64)) <= x
    out[nz & too_small & lo] += 1
    out[~nz] = 1
    return out


def vbyte_cost_bits_np(values: np.ndarray) -> np.ndarray:
    """VByte cost in bits of each *value* (the integer actually written)."""
    bits = bit_length_np(values)
    return 8 * ((bits + 6) // 7)


def gaps_from_sorted(seq: np.ndarray, base: int = -1) -> np.ndarray:
    """d-gaps of a strictly increasing sequence, first gap measured from base."""
    seq = np.asarray(seq, dtype=np.int64)
    if seq.size == 0:
        return np.zeros(0, dtype=np.int64)
    gaps = np.empty(seq.shape, dtype=np.int64)
    gaps[0] = seq[0] - base
    np.subtract(seq[1:], seq[:-1], out=gaps[1:])
    if not (gaps > 0).all():
        raise ValueError("sequence must be strictly increasing (gaps >= 1)")
    return gaps


def elem_costs_np(gaps: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(E_k, B_k) per-element bit costs from d-gaps.

    E_k = VByte cost of (gap_k - 1); B_k = gap_k (bitmap span).
    """
    gaps = np.asarray(gaps, dtype=np.int64)
    e = vbyte_cost_bits_np(gaps - 1)
    b = gaps.copy()
    return e, b


def gain_deltas_np(gaps: np.ndarray) -> np.ndarray:
    """Per-element gain increments: E_k - B_k (Definition 1 of the paper)."""
    e, b = elem_costs_np(gaps)
    return e - b
