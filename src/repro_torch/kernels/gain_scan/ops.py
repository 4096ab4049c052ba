"""Gain scan on the card + host dominating-point stitching.

Counterpart of ``repro/kernels/gain_scan/ops.py``.
``optimal_partitioning_blocked(gaps)`` reproduces the paper's exact
partitioning (tested against ``core.partition.optimal_partitioning``) but
evaluates all per-element costs in the gain-scan kernel; only the
O(1)-state decision machine stays scalar, on the host.

Both entry points run on the card unless the caller passes
``device="cpu"`` (then the kernel's plain version serves); there is no
silent fallback.  ``use_kernel=False`` runs the plain version on the
chosen device, as the reference's keyword does.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import obs
from ...api import resolve_device
from ...core.costs import DEFAULT_F
from ...core.partition import _state_machine
from .kernel import BLOCK, gain_scan
from .ref import gain_scan_ref


def check_range(n: int, gap_sum: int) -> None:
    """int32 range check: |g| is bounded by max(sum gaps, 40n), so the scan
    takes universe < 2^31 and 40n < 2^31 (n <= 53,687,091) -- the paper's
    32-bit docID regime always fits; anything wider is refused up front."""
    if n and (gap_sum >= 2**31 or 40 * n >= 2**31):
        raise ValueError(
            "gain_scan kernel requires universe < 2^31 and 40n < 2^31, "
            "n <= 53,687,091 (32-bit docID regime); split the sequence first"
        )


def gain_prefix(gaps: np.ndarray, use_kernel: bool = True, device="cuda"):
    """(g [n], block_min [nb], block_max [nb]) as numpy int32 arrays.

    The sequence is padded with gap 1 (delta 7) to a multiple of 1024; g is
    cut back to n, while block_min / block_max cover the padded blocks, pad
    elements included.  ``use_kernel`` runs the ``gain_scan`` wrapper (the
    CUDA kernel on a card, its plain version on the CPU), else the plain
    version itself on ``device``.
    """
    n = len(gaps)
    check_range(n, int(np.sum(gaps, dtype=np.int64)))
    n_pad = ((n + BLOCK - 1) // BLOCK) * BLOCK
    gp = np.ones(n_pad, np.int32)  # pad gap=1 -> delta 7 (harmless, sliced off)
    gp[:n] = gaps
    t = torch.from_numpy(gp).to(resolve_device(device))
    g, mn, mx = gain_scan(t) if use_kernel else gain_scan_ref(t, BLOCK)
    return g.cpu().numpy()[:n], mn.cpu().numpy(), mx.cpu().numpy()


def optimal_partitioning_blocked(
    gaps: np.ndarray, F: int = DEFAULT_F, use_kernel: bool = True,
    device="cuda",
) -> np.ndarray:
    """Exact paper partitioning, gain phase on the kernel.

    The decision machine consumes the precomputed absolute gain array (the
    deltas are recovered as first differences), so the per-element cost
    evaluation never runs on the host.  The ``gain_prefix`` and
    ``state_machine`` spans of ``repro_torch.obs`` time the two halves.
    """
    with obs.span("gain_prefix"):
        g, _mn, _mx = gain_prefix(np.asarray(gaps, np.int32),
                                  use_kernel=use_kernel, device=device)
    with obs.span("state_machine"):
        deltas = np.diff(np.concatenate([[0], g.astype(np.int64)]))
        return _state_machine(deltas, F, len(gaps))
