"""Wrapper of the CUDA partitioner scan (``csrc/partition_scan.cu``).

Replaces the ``lax.scan`` of ``repro/core/partition.py::
optimal_partitioning_jax`` (an XLA loop, not a Pallas kernel).  Same
dispatch rule as ``vbyte_decode.kernel``: the plain version (``ref.py``)
for CPU tensors, the kernel or an exception for CUDA tensors.
"""

from __future__ import annotations

import torch

from .. import _build
from ..vbyte_decode.kernel import on_cpu, require
from . import ref


def partition_scan(deltas, F: int):
    """deltas [n] int32 -> (carry [7], mask [n] bool, pos [n] int32): the
    dominating-point machine run over the deltas from its initial state
    (T=F, the rest 0); carry is (T, i, j, g, mn, mx, k) after the last
    step, mask[k] whether step k emitted a boundary, pos[k] the boundary it
    would emit."""
    if not 0 <= F < 2**30:
        raise ValueError(f"F must lie in [0, 2^30) for the int32 carry, got {F}")
    if on_cpu(deltas):
        return ref.partition_scan_ref(deltas, F)
    require(deltas, "deltas", torch.int32, ndim=1, align=16)
    n = deltas.shape[0]
    carry = torch.empty(7, dtype=torch.int32, device=deltas.device)
    mask = torch.empty(n, dtype=torch.bool, device=deltas.device)
    pos = torch.empty(n, dtype=torch.int32, device=deltas.device)
    fn = _build.bind(_build.load("partition_scan"), "partition_scan", 4, 2)
    _build.check(
        fn(deltas.data_ptr(), mask.data_ptr(), pos.data_ptr(),
           carry.data_ptr(), n, F,
           torch.cuda.current_stream(deltas.device).cuda_stream),
        "partition_scan",
    )
    partition_scan.launches += 1
    return carry, mask, pos


partition_scan.launches = 0
