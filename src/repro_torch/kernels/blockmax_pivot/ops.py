"""Host reduction and numpy mirror of the Block-Max pivot kernel.

Counterpart of ``repro/kernels/blockmax_pivot/ops.py``.  The float ->
integer reduction lives here (``dequant_table``, ``qmin_for``, float64
host code copied exactly from the reference): the engine folds the
admissibility envelope -- theta, the per-term multiplicity, and a
per-block co-candidate rest bound -- into the minimal admissible u8 bound
code per block, and the per-lane test the device then runs
(``block_max_q >= qmin``) is EXACTLY the host's float test
``mult * bound(b) + rest(b) >= theta``.  The numpy mirror is the host
path of ``TopKEngine(backend="numpy")``.
"""

from __future__ import annotations

import numpy as np

from ..vbyte_decode.kernel import BLOCK_VALS
from .kernel import QMIN_NONE

_I32_MAX = 2**31 - 1


# The family's identity and the signatures of its numpy / plain / CUDA
# triple, checked without importing anything by
# ``repro_torch.analyze.contracts``.  Outputs are the CUDA wrapper's (the
# numpy mirror widens them to int64).
CONTRACT = {
    "family": "blockmax_pivot",
    "identity": "integer",
    "ops": {
        "pivot_select": {
            "roles": ["qb", "qmin", "nblk"],
            "out": [
                "compact:int32[nr,128]",
                "count:int32[nr]",
                "pivot:int32[nr]",
                "maxq:int32[nr]",
            ],
            "backends": {
                "numpy": {
                    "module": "ops",
                    "fn": "pivot_select_np",
                    "params": ["qb:qb", "qmins:qmin", "nblks:nblk"],
                },
                "ref": {
                    "module": "ref",
                    "fn": "pivot_select_ref",
                    "params": ["qb:qb", "nblk:nblk", "qmin:qmin", "rows:gather"],
                },
                "cuda": {
                    "module": "kernel",
                    "fn": "pivot_select",
                    "source": "csrc/blockmax_pivot.cu",
                    "params": ["qb:qb", "nblk:nblk", "qmin:qmin", "rows:gather"],
                },
            },
        },
    },
}


def _qmin_2d(qmins, n: int) -> np.ndarray:
    """Accept per-row scalars or per-lane tiles; always return [n, 128]."""
    q = np.asarray(qmins, np.int64)
    if q.ndim == 1:
        q = np.broadcast_to(q[:, None], (n, BLOCK_VALS))
    return q


def dequant_table(bound_scale) -> np.ndarray:
    """[256] float64 dequantized bound per u8 code, via the f32 contract.

    Entry q is ``float64(float32(q) * bound_scale)`` -- the exact value
    ``RankedSidecar.block_bounds()`` assigns a block with code q, so float
    tests against these entries reproduce the engine's bound math bit for
    bit.
    """
    return (
        np.arange(QMIN_NONE, dtype=np.float32) * np.float32(bound_scale)
    ).astype(np.float64)


def qmin_for(mult, rest, theta, deq64: np.ndarray) -> np.ndarray:
    """Minimal admissible bound code per block: the smallest q with
    ``mult[b] * deq64[q] + rest[b] >= theta[b]`` (QMIN_NONE when none
    passes).

    rest: [B] float64 per-block co-candidate upper bound; mult / theta:
    per-block term multiplicity and threshold, scalars or [B] vectors (a
    ``theta[b] = -inf`` block keeps everything).  All math float64: exact
    over the f32 contract values.  ``deq64`` ascends with q and mult > 0,
    so the predicate is monotone in q and an 8-step vectorized bisection
    (the EXACT predicate at every probe) pins the minimal code per block.
    """
    rest = np.asarray(rest, np.float64)
    mult = np.asarray(mult, np.float64)
    theta = np.asarray(theta, np.float64)
    lo = np.zeros(len(rest), np.int64)
    hi = np.full(len(rest), QMIN_NONE, np.int64)  # 256 = "no code passes"
    while True:
        open_ = hi > lo
        if not open_.any():
            return lo
        mid = (lo + hi) >> 1  # open rows: < hi <= 256, a real code
        # resolved rows may sit at lo == hi == 256; clamp their (unused)
        # probe index and let the open_ mask discard the result
        ok = mult * deq64[np.minimum(mid, QMIN_NONE - 1)] + rest >= theta
        hi = np.where(open_ & ok, mid, hi)
        lo = np.where(open_ & ~ok, mid + 1, lo)


def pivot_select_np(qb, qmins, nblks):
    """Numpy mirror of the pivot kernel over gathered chunk rows.

    qb: [nr, 128] bound codes; qmins: [nr, 128] per-lane codes (or [nr]
    scalars, broadcast); nblks: [nr].  Returns (compact [nr, 128],
    count [nr], pivot [nr], maxq [nr]) int64 with the kernel contract
    (compact = kept lane indices ascending, -1 padded).
    """
    qb = np.asarray(qb, np.int64)
    nr = qb.shape[0]
    lane = np.arange(BLOCK_VALS, dtype=np.int64)
    keep = (qb >= _qmin_2d(qmins, nr)) & (
        lane[None, :] < np.asarray(nblks, np.int64)[:, None]
    )
    count = keep.sum(axis=1)
    compact = np.full((nr, BLOCK_VALS), -1, np.int64)
    rows_i, lanes_i = np.nonzero(keep)
    if len(rows_i):
        pos = (np.cumsum(keep, axis=1) - 1)[rows_i, lanes_i]
        compact[rows_i, pos] = lanes_i
    maxq = np.where(keep, qb, -1).max(axis=1) if nr else np.zeros(0, np.int64)
    pivot = np.where(keep & (qb == maxq[:, None]), lane[None, :], _I32_MAX).min(axis=1)
    pivot = np.where(count > 0, pivot, -1)
    return compact, count, pivot, maxq
