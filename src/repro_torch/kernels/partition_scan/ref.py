"""Plain version of the partitioner's scan state machine.

Counterpart of the ``lax.scan`` in ``repro/core/partition.py::
optimal_partitioning_jax``: the same step, with its ``jnp.where`` logic,
over python ints held to int32 (the carry of the reference is int32).  A
loop over the deltas' ``.tolist()``: fine at test sizes, and what the card
holds the CUDA kernel of ``kernel.py`` against.
"""

from __future__ import annotations

import torch


def _i32(x: int) -> int:
    """Wrap a python int to int32, as the reference's int32 carry does."""
    return (x + 2**31) % 2**32 - 2**31


def partition_scan_ref(deltas: torch.Tensor, F: int):
    """deltas [n] int32 -> (carry [7], mask [n] bool, pos [n]) int32 on the
    deltas' device; carry is (T, i, j, g, mn, mx, k) after the last step,
    mask[k] says step k emitted a boundary and pos[k] which."""
    F2 = _i32(2 * F)
    T, i, j, g, mn, mx, k = F, 0, 0, 0, 0, 0, 0
    mask, pos = [], []
    for dk in deltas.tolist():
        k1 = _i32(k + 1)
        g = _i32(g + dk)
        nondec = dk >= 0

        # non-decreasing branch
        up = nondec and g > mx
        new_mx = g if up else mx
        new_i = k1 if up else i
        emit_e = nondec and mn < _i32(-T) and _i32(mn - g) < -F2

        # decreasing branch
        down = not nondec and g < mn
        new_mn = g if down else mn
        new_j = k1 if down else j
        emit_b = not nondec and mx > T and _i32(mx - g) > F2

        emit = emit_e or emit_b
        mask.append(emit)
        pos.append(new_j if emit_e else new_i)

        # apply update() effects
        T = F2 if emit else T
        g = _i32(g - new_mn) if emit_e else (_i32(g - new_mx) if emit_b else g)
        mn = 0 if emit_e else (g if emit_b else new_mn)
        mx = g if emit_e else (0 if emit_b else new_mx)
        i = k1 if emit_e else new_i
        j = k1 if emit_b else new_j
        k = k1
    dev = deltas.device
    return (
        torch.tensor([T, i, j, g, mn, mx, k], dtype=torch.int32, device=dev),
        torch.tensor(mask, dtype=torch.bool, device=dev),
        torch.tensor(pos, dtype=torch.int32, device=dev),
    )
