"""Plain PyTorch version of the gain-function scan (paper Definition 1).

Counterpart of ``repro/kernels/gain_scan/ref.py``: the CPU runs it, and the
card holds the CUDA kernel of ``kernel.py`` against it.
"""

from __future__ import annotations

import torch


def vbyte_cost_bits(values: torch.Tensor) -> torch.Tensor:
    """8 * ceil(bits(v)/7) without clz: threshold comparisons (v < 2^31)."""
    v = values
    nbytes = (
        1
        + (v >= 128).int()
        + (v >= 16384).int()
        + (v >= 2097152).int()
        + (v >= 268435456).int()
    )
    return 8 * nbytes


def gain_scan_ref(gaps: torch.Tensor, block: int = 1024):
    """gaps: [n] int32 (n % block == 0).

    Returns (g [n] int32 cumulative gain, block_min [nb], block_max [nb]),
    where g(i) = sum_{k<=i} (E_k - B_k), E_k = vbyte bits of (gap_k - 1),
    B_k = gap_k.
    """
    deltas = vbyte_cost_bits(torch.clamp_min(gaps - 1, 0)) - gaps
    g = torch.cumsum(deltas.long(), 0).int()
    gb = g.view(gaps.shape[0] // block, block)
    return g, gb.amin(1), gb.amax(1)
