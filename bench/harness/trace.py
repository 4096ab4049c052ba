"""The traced run: ``torch.profiler`` over the window, the program's own
spans, and probes on the kernel wrappers a metric reads.

Everything here is read after the window has closed.  The window is marked
in the profiler's clock by a ``record_function`` around it, and the
program's spans (``repro_torch.obs``, armed only in a traced run) are put
on the same clock through one span the harness opens itself.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import tempfile
from collections import defaultdict, deque

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_MARK = "bench_window"
SPAN_RING = 1 << 20


class Probes:
    """Records the arguments of every call of the functions a metric
    names, as ``{name: [(args, kwargs), ...]}``; ``install`` wraps
    ``module.name`` for each (module, name), ``restore`` undoes it."""

    def __init__(self, wanted: dict[str, list[str]]):
        self.wanted = wanted
        self.calls: dict[str, list] = defaultdict(list)
        self._saved: list = []

    def install(self) -> None:
        for name, modules in self.wanted.items():
            for modname in modules:
                mod = importlib.import_module(modname)
                fn = getattr(mod, name)
                self._saved.append((mod, name, fn))
                setattr(mod, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        calls = self.calls[name]

        def probe(*args, **kwargs):
            calls.append((args, kwargs))
            return fn(*args, **kwargs)

        return probe

    def restore(self) -> None:
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        self._saved.clear()


class Trace:
    """What a traced window left: device events, the window on the
    profiler's clock, the program's spans on the same clock."""

    def __init__(self, events, spans, w0_us: float, w1_us: float):
        self.events = events  # device events: (name, ts_us, dur_us)
        self.spans = spans    # program spans (dicts), None if not read
        self.w0, self.w1 = w0_us, w1_us

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) / 1e6

    def busy_intervals(self) -> list[tuple[float, float]]:
        """Merged device-busy intervals inside the window (us)."""
        iv = sorted((max(ts, self.w0), min(ts + d, self.w1))
                    for _, ts, d in self.events)
        out: list[list[float]] = []
        for a, b in iv:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def kernel_s(self, fragment: str) -> float:
        """Device seconds of the events whose name holds ``fragment``."""
        return sum(d for n, ts, d in self.events if fragment in n) / 1e6

    def device_ops(self, n: int = 10) -> list:
        by = defaultdict(float)
        for name, _, d in self.events:
            by[name[:96]] += d / 1e6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """Idle device time inside the window, by the innermost program
        span the host was in at each gap's middle ("no span" outside)."""
        busy = self.busy_intervals()
        gaps, t = [], self.w0
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.w1 > t:
            gaps.append((t, self.w1))
        by = defaultdict(float)
        for a, b in gaps:
            mid = (a + b) / 2
            inner = [s for s in self.spans or ()
                     if s["ts_us"] <= mid <= s["ts_us"] + s["dur_us"]]
            name = (max(inner, key=lambda s: s["depth"])["name"] if inner
                    else "no span")
            by[name] += (b - a) / 1e6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]

    def self_s(self, name: str) -> float | None:
        """Summed self time of the program's spans ``name`` in the window:
        each span's time less what its child spans cover (None where
        there is no such span)."""
        mine = [s for s in self.spans or () if s["name"] == name]
        if not mine:
            return None
        total = 0.0
        for s in mine:
            a, b = s["ts_us"], s["ts_us"] + s["dur_us"]
            kids = sum(c["dur_us"] for c in self.spans
                       if c["thread"] == s["thread"]
                       and c["depth"] == s["depth"] + 1
                       and a <= c["ts_us"] and c["ts_us"] + c["dur_us"] <= b)
            total += s["dur_us"] - kids
        return total / 1e6


@contextlib.contextmanager
def traced(device):
    """Profile the body: yields a dict that holds the ``Trace`` once the
    body has ended (the device synchronised inside the window)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch import obs
    from repro_torch.obs import trace as obs_trace

    on_card = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    obs.reset()
    # the span ring holds 4,096 records; a window of many small batches
    # can leave more, so the traced run gives it room (a ring that still
    # fills up is reported as no spans)
    obs_trace.__dict__["_RING"] = deque(maxlen=SPAN_RING)
    obs.enable()
    box: dict = {}
    with profile(activities=acts) as prof:
        with record_function(WINDOW_MARK):
            with obs.span(WINDOW_MARK):
                pass
            yield box
            if on_card:
                torch.cuda.synchronize(device)
    obs.enable(False)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            raw = json.load(fh)
    finally:
        os.remove(path)
    evs = raw["traceEvents"] if isinstance(raw, dict) else raw
    mark = [e for e in evs if e.get("name") == WINDOW_MARK
            and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    if not mark:
        raise RuntimeError("the profiler's trace holds no window mark")
    w0 = float(mark[0]["ts"])
    w1 = w0 + float(mark[0]["dur"])
    device_evs = [(e.get("name", ""), float(e["ts"]), float(e.get("dur", 0)))
                  for e in evs if e.get("ph") == "X"
                  and e.get("cat") in DEVICE_CATS]
    # program spans: the harness's own span opened with the window maps
    # the obs clock onto the profiler's
    ring = obs.events()
    recs = [r for r in ring if r.get("kind") == "span"]
    mine = [r for r in recs if r["name"] == WINDOW_MARK]
    spans = None
    if mine and len(ring) < SPAN_RING:
        shift_us = w0 - mine[0]["start_s"] * 1e6
        spans = [{"name": r["name"], "ts_us": r["start_s"] * 1e6 + shift_us,
                  "dur_us": r["dur_ms"] * 1e3, "depth": r["depth"],
                  "thread": r["thread"]}
                 for r in recs if r["name"] != WINDOW_MARK]
    box["trace"] = Trace(device_evs, spans, w0, w1)
