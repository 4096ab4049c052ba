"""Cost walker over the ATen ops that torch dispatches.

Counterpart of ``repro/launch/hlo_walker.py``, which walks XLA's optimized
HLO text.  The port has no HLO: this walker reads the DISPATCHED ops, one
``TorchDispatchMode`` over a run (on fake tensors in the dry run, so
nothing is allocated), and returns the reference's ``WalkStats``:

  * ``dot_flops`` -- FLOPs of the matmul-like ops, from
    ``torch.utils.flop_counter``'s formulas (``FlopCounterMode``'s
    registry: mm, bmm, addmm, baddbmm, convolution, attention);
  * ``hbm_bytes`` -- operand + result bytes of every op that is not a view
    (eager torch materializes each op's result, so this is the op-by-op
    traffic, the counterpart of the reference's fusion granularity);
  * ``hbm_bytes_ideal`` -- only the ops whose operands and results must
    stream through HBM even with perfect fusion: matmuls and convolutions
    (operands + result), gathers (2 x the gathered rows, never the
    table), scatters (3 x the update rows: read-modify-write), slice
    writes (2 x the slice), sorts, and collectives (2 x their payload);
  * ``coll_counts`` / ``coll_result_bytes`` / ``coll_wire_bytes`` -- the
    ``_c10d_functional`` collectives (the mesh paths' explicit ones and
    DTensor's redistributions), under the reference's HLO names, with the
    ring factors of ``launch/analysis.py``: all-gather result x (g-1)/g,
    all-reduce 2 x result x (g-1)/g, reduce-scatter result x (g-1),
    all-to-all result x (g-1)/g, g the group's size.

Eager execution runs every loop iteration, so a loop's work is counted
once an iteration with no trip-count analysis: ``while_trip_counts``
stays empty.  Ops that DTensor dispatches on its local tensors are
counted (a device's share); DTensor's own shape propagation, which runs
ops on global fake tensors of another fake mode, is not.

``peak_bytes`` follows the live bytes of non-view op results over the run
(a view's base is counted once; a result freed while a view of it lives
stops counting).
"""

from __future__ import annotations

import sys
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

_DOT = {"mm", "bmm", "addmm", "baddbmm", "convolution", "_convolution",
        "convolution_backward"}
_GATHER = {"index_select", "index", "embedding", "gather", "take",
           "embedding_dense_backward"}
_SCATTER = {"index_add", "index_add_", "index_put", "index_put_", "scatter",
            "scatter_", "scatter_add", "scatter_add_", "_index_put_impl_",
            "index_copy", "index_copy_", "scatter_reduce", "scatter_reduce_"}
_SLICE_WRITE = {"slice_scatter", "select_scatter", "copy_"}
_SORT = {"sort", "topk", "argsort"}
_NO_TRAFFIC = {"wait_tensor", "detach", "empty", "empty_strided", "empty_like",
               "zeros_like", "ones_like", "lift_fresh", "alias",
               "_local_scalar_dense", "device", "sym_size", "sym_numel",
               "sym_stride", "is_same_size"}


@dataclass
class WalkStats:
    dot_flops: float = 0.0
    hbm_bytes: float = 0.0  # every materializing op's operands + result
    hbm_bytes_ideal: float = 0.0  # matmul/gather/scatter/slice/sort/collective only
    coll_wire_bytes: float = 0.0
    coll_counts: dict = field(default_factory=dict)
    coll_result_bytes: dict = field(default_factory=dict)
    while_trip_counts: list = field(default_factory=list)
    peak_bytes: float = 0.0
    coll_records: list = field(default_factory=list)  # (op, result bytes, group size)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _group_size(name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(name).size()


def wire_bytes(op: str, size: float, g: int) -> float:
    """Bytes on the wire a participating device, ring algorithms."""
    frac = (g - 1) / g if g > 1 else 0.0
    if op == "all-reduce":
        return 2 * size * frac
    if op == "reduce-scatter":
        return size * (g - 1)
    if op == "collective-permute":
        return size
    return size * frac  # all-gather, all-to-all


def _in_shape_propagation() -> bool:
    """Inside DTensor's output-shape propagation, which runs an op once on
    global fake tensors (in the active fake mode, where there is one)."""
    f = sys._getframe(2)
    for _ in range(48):
        if f is None:
            return False
        if f.f_code.co_name.startswith("_propagate_tensor_meta"):
            return True
        f = f.f_back
    return False


class Walker(TorchDispatchMode):
    """``with Walker(fake_mode) as w: ...`` -- ``w.stats`` after.  With a
    ``fake_mode``, fake tensors of any other mode (DTensor's shape
    propagation) are not counted."""

    def __init__(self, fake_mode=None):
        super().__init__()
        self.stats = WalkStats()
        self.fake_mode = fake_mode
        self._live = 0

    def _free(self, n: int) -> None:
        self._live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs local ops: counted below
        out = func(*args, **kwargs)
        if _in_shape_propagation():
            return out
        if self.fake_mode is not None:
            modes = {getattr(t, "fake_mode", None) for t in _tensors((args, kwargs))}
            if any(m is not None and m is not self.fake_mode for m in modes):
                return out
        self._record(func, args, kwargs, out)
        return out

    def _record(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry

        st = self.stats
        packet = func.overloadpacket
        name = packet.__name__
        if packet in flop_registry:
            st.dot_flops += flop_registry[packet](*args, **kwargs, out_val=out)
        ns = func.namespace
        if ns == "_c10d_functional" and name in _COLLECTIVES:
            op = _COLLECTIVES[name]
            size = _nbytes(out)
            g = _group_size(args[-1] if isinstance(args[-1], str) else kwargs["group_name"])
            st.coll_counts[op] = st.coll_counts.get(op, 0) + 1
            st.coll_result_bytes[op] = st.coll_result_bytes.get(op, 0) + size
            st.coll_wire_bytes += wire_bytes(op, size, g)
            st.coll_records.append((op, size, g))
            st.hbm_bytes += _nbytes(args[0]) + size
            st.hbm_bytes_ideal += 2.0 * size
            self._track(out)
            return
        if ns not in ("aten", "prims") or name in _NO_TRAFFIC or func.is_view:
            return
        out_b = _nbytes(out)
        in_b = _nbytes((args, kwargs))
        st.hbm_bytes += out_b + in_b
        if name in _DOT:
            st.hbm_bytes_ideal += out_b + in_b
        elif name in _GATHER:
            st.hbm_bytes_ideal += 2.0 * out_b
        elif name in _SCATTER:
            upd = [t for t in _tensors(args[1:]) if t.is_floating_point()]
            st.hbm_bytes_ideal += 3.0 * (_nbytes(upd[-1]) if upd else out_b)
        elif name in _SLICE_WRITE:
            src = list(_tensors(args[1:2]))
            st.hbm_bytes_ideal += 2.0 * (_nbytes(src) if src else out_b)
        elif name in _SORT:
            st.hbm_bytes_ideal += out_b + in_b
        if not name.endswith("_"):
            self._track(out)

    def _track(self, out) -> None:
        for t in _tensors(out):
            n = t.numel() * t.element_size()
            self._live += n
            self.stats.peak_bytes = max(self.stats.peak_bytes, self._live)
            try:
                weakref.finalize(t, self._free, n)
            except TypeError:  # no weak references to this tensor
                self._live -= n


def walk(fn, *args, fake_mode=None, **kwargs) -> WalkStats:
    """Run ``fn(*args, **kwargs)`` under a ``Walker``; -> its stats."""
    with Walker(fake_mode) as w:
        fn(*args, **kwargs)
    return w.stats
