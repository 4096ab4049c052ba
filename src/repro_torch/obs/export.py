"""Exporters: Prometheus text exposition + JSON snapshot (+ diff).

Both render from the live registry with no extra deps.  The JSON
snapshot is what ``launch.serve --metrics-dump`` writes and
``/metrics.json`` serves.  Counterpart of ``repro/obs/export.py``: the
same keys, label rendering and text format.
"""

from __future__ import annotations

import json
import math

from . import metrics as _m
from . import trace as _t

__all__ = ["diff", "render_prometheus", "snapshot", "write_snapshot"]


def _render_labels(labels: tuple) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


def _key(name: str, labels: tuple) -> str:
    return name + _render_labels(labels)


def snapshot(registry: _m.Registry | None = None, events: bool = True) -> dict:
    """JSON-serialisable snapshot: counters, gauges, histogram summaries
    and (optionally) the recent trace-event ring."""
    reg = registry or _m.REGISTRY
    out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
    for (kind, name, labels), m in reg.items():
        k = _key(name, labels)
        if kind == "Counter":
            out["counters"][k] = m.value
        elif kind == "Gauge":
            out["gauges"][k] = m.value
        else:
            out["histograms"][k] = m.summary()
    if events:
        out["events"] = _t.events()
    return out


def write_snapshot(
    path: str, registry: _m.Registry | None = None, events: bool = True
) -> dict:
    snap = snapshot(registry, events=events)
    with open(path, "w") as f:
        json.dump(snap, f, indent=2, sort_keys=True, default=str)
        f.write("\n")
    return snap


def render_prometheus(registry: _m.Registry | None = None) -> str:
    """Prometheus text exposition format (version 0.0.4)."""
    reg = registry or _m.REGISTRY
    lines: list = []
    seen_type: set = set()
    for (kind, name, labels), m in reg.items():
        if kind == "Counter":
            if name not in seen_type:
                lines.append(f"# TYPE {name} counter")
                seen_type.add(name)
            lines.append(f"{_key(name, labels)} {m.value}")
        elif kind == "Gauge":
            if name not in seen_type:
                lines.append(f"# TYPE {name} gauge")
                seen_type.add(name)
            lines.append(f"{_key(name, labels)} {m.value}")
        else:
            if name not in seen_type:
                lines.append(f"# TYPE {name} histogram")
                seen_type.add(name)
            for le, cum in m.buckets():
                le_s = "+Inf" if math.isinf(le) else f"{le:.6g}"
                blabels = labels + (("le", le_s),)
                lines.append(f"{name}_bucket{_render_labels(blabels)} {cum}")
            lines.append(f"{name}_sum{_render_labels(labels)} {m.sum:.6g}")
            lines.append(f"{name}_count{_render_labels(labels)} {m.count}")
    return "\n".join(lines) + "\n"


def diff(new: dict, old: dict) -> dict:
    """Delta between two JSON snapshots (new - old).

    Counters and gauges subtract numerically; histograms report
    count/sum deltas with the *new* percentiles (percentiles do not
    subtract meaningfully).  Keys only present in ``new`` pass through.
    """
    out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
    for sect in ("counters", "gauges"):
        olds = old.get(sect, {})
        for k, v in new.get(sect, {}).items():
            out[sect][k] = v - olds.get(k, 0)
    oldh = old.get("histograms", {})
    for k, h in new.get("histograms", {}).items():
        prev = oldh.get(k, {})
        d = dict(h)
        d["count"] = h.get("count", 0) - prev.get("count", 0)
        d["sum"] = h.get("sum", 0.0) - prev.get("sum", 0.0)
        out["histograms"][k] = d
    return out
