"""Elias-Fano encoding of one partition's rebased docIDs (``repro/core/eliasfano.py``).

The quasi-succinct layout (Vigna 2013) over n strictly-increasing values
``r_0 < ... < r_{n-1}`` in ``[0, u]``: each value splits into ``l =
max(0, floor(log2(u / n)))`` explicit LOW bits and a HIGH part ``r >> l``
stored in unary -- for bucket ``b = 0, 1, ...`` the high-bit stream holds
one 1-bit per value with ``r >> l == b``, then a 0-bit.  Total cost is
``n*l + n + (u >> l) + 1`` bits, within half a bit per value of the
information-theoretic minimum -- the ``2 + ceil(log2(u/n))`` bits/value
the paper's codec-aware cost model charges.

Serialized partition payload (the index's ``TAG_EF`` branch)::

    [ l : 1 byte ][ low bits : ceil(n*l/8) bytes ][ high bits : rest ]

Both bit regions pack LSB-first (``np.packbits(bitorder="little")``) and
pad independently to a byte boundary, so decode needs only ``n`` (stored
in the index sidecars, like every codec).  The in-register NextGEQ over
the same split lives in ``kernels/ef_search``; this module is the host
codec the index build and the scalar decode path share.
"""

from __future__ import annotations

import numpy as np

# EF partitions are only eligible below this universe: the arena re-splits
# them into per-block tiles whose low bits must fit uint16 lanes (see
# kernels/ef_search/ops.ef_pack_blocks), and a partition universe < 2^23
# bounds every block's l at 15
EF_UNIVERSE_MAX = 1 << 23


def ef_choose_l(n: int, u: int) -> int:
    """The canonical low-bit width: ``max(0, floor(log2(u / n)))``."""
    if n <= 0 or u <= 0:
        return 0
    q = u // n
    return q.bit_length() - 1 if q >= 1 else 0


def ef_cost_bits(n: int, u: int) -> int:
    """Exact bit cost of the high/low split (header byte excluded)."""
    l = ef_choose_l(n, u)
    return n * l + n + (u >> l) + 1


def ef_payload_bytes(n: int, u: int) -> int:
    """Exact serialized payload size in bytes, header byte INCLUDED."""
    l = ef_choose_l(n, u)
    return 1 + (n * l + 7) // 8 + (n + (u >> l) + 1 + 7) // 8


def ef_encode(rebased: np.ndarray, universe: int) -> np.ndarray:
    """Encode strictly-increasing rebased values in [0, universe] -> uint8.

    ``rebased`` is the partition's ``values - base - 1`` (the same rebase
    the bitvector codec uses); ``universe`` is the largest representable
    rebased value (``endpoint - base - 1``, i.e. ``rebased[-1]``).
    """
    r = np.asarray(rebased, dtype=np.int64)
    n = int(r.size)
    u = int(universe)
    l = ef_choose_l(n, u)
    if l:
        low = (r & ((1 << l) - 1)).astype(np.uint8 if l <= 8 else np.uint32)
        bitpos = np.arange(n * l, dtype=np.int64)
        lowbits = ((r[bitpos // l] >> (bitpos % l)) & 1).astype(np.uint8)
        low_bytes = np.packbits(lowbits, bitorder="little")
    else:
        low_bytes = np.zeros(0, np.uint8)
    hi = r >> l
    nhigh = n + (u >> l) + 1
    highbits = np.zeros(nhigh, np.uint8)
    highbits[hi + np.arange(n, dtype=np.int64)] = 1
    high_bytes = np.packbits(highbits, bitorder="little")
    return np.concatenate(
        [np.asarray([l], np.uint8), low_bytes, high_bytes]
    )


def ef_decode(payload: np.ndarray, n: int) -> np.ndarray:
    """Decode ``ef_encode``'s payload back to the rebased int64 values."""
    payload = np.asarray(payload, dtype=np.uint8)
    n = int(n)
    if n == 0:
        return np.zeros(0, np.int64)
    l = int(payload[0])
    nlow_bytes = (n * l + 7) // 8
    if l:
        lowbits = np.unpackbits(
            payload[1 : 1 + nlow_bytes], bitorder="little"
        )[: n * l].astype(np.int64)
        low = (lowbits.reshape(n, l) << np.arange(l, dtype=np.int64)).sum(
            axis=1
        )
    else:
        low = np.zeros(n, np.int64)
    highbits = np.unpackbits(payload[1 + nlow_bytes :], bitorder="little")
    ones = np.flatnonzero(highbits)[:n].astype(np.int64)
    hi = ones - np.arange(n, dtype=np.int64)
    return (hi << l) | low
