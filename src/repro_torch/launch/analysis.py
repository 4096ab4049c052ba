"""Roofline terms of a traced (dry-run) step.

Counterpart of ``repro/launch/analysis.py``.  The reference reads a
compiled executable (``cost_analysis``, ``memory_analysis`` and the
optimized HLO); the port reads the ``launch.hlo_walker`` stats of one step
run on fake tensors over a fake process group:

 * FLOPs and bytes a device from the walker (``dot_flops``,
   ``hbm_bytes_ideal``, ``hbm_bytes``); nothing else reports them, so the
   ``reported_*`` fields repeat the walker's (the reference keeps XLA's
   own, which count a ``while`` body once);
 * the collectives from the walker's records of the ``_c10d_functional``
   ops, with the ring factors a participating device:
   all-gather      result_bytes * (g-1)/g
   all-reduce      2 * result_bytes * (g-1)/g
   reduce-scatter  result_bytes * (g-1)
   all-to-all      result_bytes * (g-1)/g
   collective-permute  result_bytes
   where g = the group's size;
 * memory: the local shards' bytes of the arguments and of the outputs,
   and the peak of the walker's live op results (``mem_temp_bytes``).

The roofline constants are one NVIDIA H100 80GB HBM3's (``launch.mesh``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .hlo_walker import wire_bytes


@dataclass
class CollectiveStats:
    counts: dict = field(default_factory=dict)
    result_bytes: dict = field(default_factory=dict)
    wire_bytes_per_device: float = 0.0

    def total_result_bytes(self) -> float:
        return float(sum(self.result_bytes.values()))


def parse_collectives(records) -> CollectiveStats:
    """``(op, result bytes, group size)`` records (``WalkStats.
    coll_records``) -> counts, result bytes and wire bytes a device."""
    stats = CollectiveStats()
    for op, size, g in records:
        stats.counts[op] = stats.counts.get(op, 0) + 1
        stats.result_bytes[op] = stats.result_bytes.get(op, 0) + size
        stats.wire_bytes_per_device += wire_bytes(op, size, g)
    return stats


def summarize(stats, n_devices: int, args_bytes: int = 0,
              output_bytes: int = 0) -> dict:
    """Roofline inputs from the walker's stats, under the keys of the
    reference's ``summarize_compiled``."""
    coll = parse_collectives(stats.coll_records)
    return {
        "n_devices": n_devices,
        "flops_per_device": float(stats.dot_flops),
        "bytes_per_device": float(stats.hbm_bytes_ideal),
        "bytes_per_device_fusion_granularity": float(stats.hbm_bytes),
        "reported_flops_per_device": float(stats.dot_flops),
        "reported_bytes_per_device": float(stats.hbm_bytes),
        "mem_args_bytes": int(args_bytes),
        "mem_output_bytes": int(output_bytes),
        "mem_temp_bytes": int(stats.peak_bytes),
        "mem_code_bytes": 0,
        "while_trip_counts": list(stats.while_trip_counts),
        "collective_counts": coll.counts,
        "collective_result_bytes": coll.result_bytes,
        "collective_wire_bytes_per_device": coll.wire_bytes_per_device,
    }


def roofline_terms(summary: dict, model_flops_total: float = 0.0) -> dict:
    """The three roofline times (seconds) + dominant term."""
    from .mesh import HBM_BW, ICI_BW, PEAK_FLOPS_BF16

    t_compute = summary["flops_per_device"] / PEAK_FLOPS_BF16
    t_memory = summary["bytes_per_device"] / HBM_BW
    t_collective = summary["collective_wire_bytes_per_device"] / ICI_BW
    dominant = max(
        ("compute", t_compute), ("memory", t_memory), ("collective", t_collective),
        key=lambda kv: kv[1],
    )[0]
    out = {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "dominant": dominant,
        "bound_step_time_s": max(t_compute, t_memory, t_collective),
    }
    if model_flops_total:
        total = summary["flops_per_device"] * summary["n_devices"]
        out["model_flops_total"] = model_flops_total
        out["hlo_flops_total"] = total
        out["useful_flops_ratio"] = model_flops_total / total if total else 0.0
        # fraction of the compute roofline reached if the step ran at the
        # bound: useful FLOPs / (devices * peak * step time)
        denom = summary["n_devices"] * PEAK_FLOPS_BF16 * out["bound_step_time_s"]
        out["roofline_fraction"] = model_flops_total / denom if denom else 0.0
    return out
