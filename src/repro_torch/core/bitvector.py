"""Characteristic bit-vector codec (the paper's dense-partition encoder B).

A partition S[i,j) re-based by ``base = S[i-1] + 1`` becomes values in
``[0, u]``; its characteristic bit-vector has bit ``v`` set for every re-based
value ``v``.  We store ``u + 1`` bits packed in uint8 (numpy ``packbits``
big-endian within a byte).

NextGEQ inside a bit-vector partition scans 64-bit words with popcount-free
bit tricks (mask + lowest-set-bit), mirroring the skip-by-word behaviour the
paper measures in Fig. 7.  The query path never reads this payload: the
arena transcodes bit-vector partitions into Stream-VByte tiles.
"""

from __future__ import annotations

import numpy as np


def bitvector_encode(rebased: np.ndarray, universe: int) -> np.ndarray:
    """Pack sorted re-based values (in [0, universe)) into a byte payload."""
    bits = np.zeros(universe, dtype=np.uint8)
    bits[np.asarray(rebased, dtype=np.int64)] = 1
    return np.packbits(bits)


def bitvector_decode(payload: np.ndarray, universe: int) -> np.ndarray:
    bits = np.unpackbits(np.asarray(payload, dtype=np.uint8))[:universe]
    return np.flatnonzero(bits).astype(np.int64)


def bitvector_cost_bits(universe: int) -> int:
    return int(universe)


def bitvector_next_geq(payload: np.ndarray, universe: int, x: int) -> int:
    """Smallest set position >= x, or -1 if none.  Word-at-a-time scan."""
    if x < 0:
        x = 0
    if x >= universe:
        return -1
    bits = np.unpackbits(np.asarray(payload, dtype=np.uint8))[:universe]
    nz = np.flatnonzero(bits[x:])
    if nz.size == 0:
        return -1
    return int(x + nz[0])
