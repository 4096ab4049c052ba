"""Wrapper of the CUDA partitioner scan (``csrc/partition_scan.cu``).

Replaces the ``lax.scan`` of ``repro/core/partition.py::
optimal_partitioning_jax`` (an XLA loop, not a Pallas kernel).  Same
dispatch rule as ``vbyte_decode.kernel``: the plain version (``ref.py``)
for CPU tensors, the kernel or an exception for CUDA tensors.
``partition_scan`` returns every step's mask and pos;
``partition_scan_bounds`` runs the same kernel for the emitted boundaries
alone, and both add to ``partition_scan.launches``.
"""

from __future__ import annotations

import torch

from .. import _build
from ..vbyte_decode.kernel import on_cpu, require
from . import ref


def _check_F(F: int) -> None:
    if not 0 <= F < 2**30:
        raise ValueError(f"F must lie in [0, 2^30) for the int32 carry, got {F}")


def _launch(deltas, F: int, mask, pos, bounds):
    """One launch; returns the kernel's carry [8] (the carry, then the
    number of emissions)."""
    carry = torch.empty(8, dtype=torch.int32, device=deltas.device)
    fn = _build.bind(_build.load("partition_scan"), "partition_scan", 5, 2)
    _build.launch(fn, "partition_scan", deltas.device, deltas.data_ptr(),
                  _build.ptr(mask), _build.ptr(pos), _build.ptr(bounds),
                  carry.data_ptr(), deltas.shape[0], F)
    partition_scan.launches += 1
    return carry


def partition_scan(deltas, F: int):
    """deltas [n] int32 -> (carry [7], mask [n] bool, pos [n] int32): the
    dominating-point machine run over the deltas from its initial state
    (T=F, the rest 0); carry is (T, i, j, g, mn, mx, k) after the last
    step, mask[k] whether step k emitted a boundary, pos[k] the boundary it
    would emit."""
    _check_F(F)
    if on_cpu(deltas):
        return ref.partition_scan_ref(deltas, F)
    require(deltas, "deltas", torch.int32, ndim=1, align=16)
    n = deltas.shape[0]
    mask = torch.empty(n, dtype=torch.bool, device=deltas.device)
    pos = torch.empty(n, dtype=torch.int32, device=deltas.device)
    carry = _launch(deltas, F, mask, pos, None)
    return carry[:7], mask, pos


def partition_scan_bounds(deltas, F: int):
    """deltas [n] int32 -> (carry [8], bounds [n]) int32: carry[:7] is
    ``partition_scan``'s carry, carry[7] the number m of emitted
    boundaries, and bounds[:m] those boundaries in order (``pos[mask]``);
    the entries past m are unspecified.  Nothing is synchronised: the
    caller reads m before it cuts bounds."""
    _check_F(F)
    if on_cpu(deltas):
        carry, mask, pos = ref.partition_scan_ref(deltas, F)
        bounds = torch.zeros_like(pos)
        found = pos[mask]
        bounds[: found.numel()] = found
        return torch.cat([carry, carry.new_tensor([found.numel()])]), bounds
    require(deltas, "deltas", torch.int32, ndim=1, align=16)
    bounds = torch.empty(deltas.shape[0], dtype=torch.int32, device=deltas.device)
    return _launch(deltas, F, None, None, bounds), bounds


partition_scan.launches = 0
