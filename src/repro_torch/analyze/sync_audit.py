"""Host-sync auditor (checker 3 of ``repro_torch.analyze``).

Counterpart of ``repro/analyze/sync_audit.py``.  The port's serving is
host-bound (its card idles through most of a batch), and every round
trip between host and device is a place where the host waits on the
card; this auditor is the instrument that counts them, and
``sync_baseline.json`` beside it is the ratchet that stops new ones
sneaking in while they are being removed.

**What is counted.**  A *sync site* is a unique ``(repo-relative file,
function)`` of ``src/repro_torch/`` (outside ``analyze/``) that
materializes a tensor on the host during one steady-state batch: after a
warm batch -- every one-time set-up done -- but data-cold -- the ranked
engine's hot-block score cache misses (see ``workload``).  Sites, not
events: one site may fetch once per codec or per chunk, so event counts
scale with batch shape while site counts are a property of the CODE,
which is what a ratchet must measure.  Two traps:

* ``trap_host_reads`` (every device): a ``TorchFunctionMode`` that sees
  ``.cpu()``, ``.numpy()``, ``.item()``, ``.tolist()``, ``__array__``
  (``np.asarray(t)``), ``__bool__`` / ``__int__`` / ``__float__`` /
  ``__index__`` on a tensor, and ``.to()`` of a tensor on another device
  to the CPU (``.to(dtype)`` is no site; on the CPU a ``.to(cpu)`` is an
  upload to the serving device as often as a fetch, so only a tensor
  from another device counts).  Its ``syncs`` must equal the reference's.
* ``trap_card_syncs`` (``device="cuda"`` only): the batch runs under
  ``torch.cuda.set_sync_debug_mode("warn")``, which warns at every
  operation that makes the host wait for the card -- the explicit fetches
  above, but also what the first trap cannot see: ``nonzero``, a
  boolean-mask index, ``repeat_interleave`` without ``output_size``, and
  a blocking upload from pageable memory.  Each warning is attributed by
  walking the Python stack from a ``warnings.showwarning`` hook (the
  warning itself may name a frame inside torch) and keyed by its site
  AND its kind, the torch function in flight when it fired (a
  ``TorchFunctionMode`` tracks it; ``?`` when none was).  The card's
  (site, kind) pairs that no explicit read of the first trap accounts
  for are ``hidden_syncs`` -- the port's counterpart of the reference's
  ``callbacks``, a host round trip hidden inside a device operation; so
  a ``nonzero`` added beside an explicit fetch still counts.  On the CPU
  it is ``None`` (unmeasured).

**The ratchet.**  ``compare_baseline`` fails a hot path whose measured
sync or hidden-sync count EXCEEDS the committed baseline; equal or lower
passes (lower prints a hint to re-baseline); an unmeasured count
(``None``) is not compared.  ``python -m repro_torch.analyze
--update-baseline`` rewrites the file, refusing to raise counts without
``--force``.
"""

from __future__ import annotations

import contextlib
import json
import os
import pathlib
import sys
import warnings

import torch
from torch.overrides import TorchFunctionMode

from .discovery import REPO_ROOT, canon_frame_filename, is_repro_torch_frame
from .report import Finding

BASELINE = pathlib.Path(__file__).resolve().parent / "sync_baseline.json"
BACKEND = "torch"  # the engines' resident pipeline, the one audited
SYNC_WARNING = "called a synchronizing CUDA operation"

_ANALYZE_DIR = os.sep + "analyze" + os.sep
_T = torch.Tensor
_HOST_READS = frozenset((
    _T.cpu, _T.numpy, _T.item, _T.tolist, _T.__array__,
    _T.__bool__, _T.__int__, _T.__float__, _T.__index__,
))


def _site_of(frame):
    """(repo-relative file, function) of the innermost repro_torch frame
    outside ``analyze/`` at or above ``frame``; None when there is none."""
    while frame is not None:
        filename = canon_frame_filename(frame.f_code.co_filename)
        if is_repro_torch_frame(filename) and _ANALYZE_DIR not in filename:
            rel = os.path.relpath(filename, str(REPO_ROOT))
            return rel.replace(os.sep, "/"), frame.f_code.co_name
        frame = frame.f_back
    return None


def _fetches_to_host(func, args, kwargs) -> bool:
    if func in _HOST_READS:
        return True
    if func is not _T.to or not args or args[0].device.type == "cpu":
        return False
    for a in (*args[1:], kwargs.get("device")):
        if isinstance(a, (str, torch.device)):
            return torch.device(a).type == "cpu"
        if isinstance(a, torch.Tensor):
            return a.device.type == "cpu"
    return False


def _kind_of(func) -> str:
    return getattr(func, "__name__", None) or repr(func)


class _HostReadTrap(TorchFunctionMode):
    def __init__(self, sites: set, reads: set | None):
        super().__init__()
        self.sites = sites
        self.reads = reads

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _fetches_to_host(func, args, kwargs):
            site = _site_of(sys._getframe(1))
            if site is not None:
                self.sites.add(site)
                if self.reads is not None:
                    self.reads.add((*site, _kind_of(func)))
        return func(*args, **kwargs)


@contextlib.contextmanager
def trap_host_reads(sites: set, reads: set | None = None):
    """Record the (file, fn) of every host materialization of a tensor
    in ``sites``, and its (file, fn, kind) in ``reads`` when given."""
    with _HostReadTrap(sites, reads):
        yield sites


class _KindTracker(TorchFunctionMode):
    """Names the torch function in flight (``kind``; None between calls)."""

    kind = None

    def __torch_function__(self, func, types, args=(), kwargs=None):
        outer, self.kind = self.kind, _kind_of(func)
        try:
            return func(*args, **(kwargs or {}))
        finally:
            self.kind = outer


@contextlib.contextmanager
def trap_card_syncs(sites: set):
    """Record the (file, fn, kind) of every operation that synchronizes
    the host with the card, under ``torch.cuda.set_sync_debug_mode("warn")``.

    Yields a one-entry dict whose ``"events"`` counts the attributed
    synchronizations (every one: the filter is ``"always"``, since the
    default shows each location once).  Other warnings pass through.
    """
    counts = {"events": 0}
    prev_mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        # torch's notice that the mode is a prototype that "does not yet
        # detect all synchronizing operations", shown at every switch
        warnings.filterwarnings("ignore", message="Synchronization debug mode")
        shown = warnings.showwarning
        tracker = _KindTracker()

        def hook(message, category, filename, lineno, file=None, line=None):
            if SYNC_WARNING not in str(message):
                shown(message, category, filename, lineno, file, line)
                return
            site = _site_of(sys._getframe(1))
            if site is not None:
                sites.add((*site, tracker.kind or "?"))
                counts["events"] += 1

        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with tracker:
                yield counts
        finally:
            torch.cuda.set_sync_debug_mode(prev_mode)


def site_names(sites) -> list[str]:
    """``file::fn`` of each (file, fn) site; ``file::fn [kind]`` of each
    (file, fn, kind) sync."""
    return sorted(
        f"{s[0]}::{s[1]}" + (f" [{s[2]}]" if len(s) > 2 else "")
        for s in sites)


def audit_hot_paths(device="cuda") -> dict:
    """Measure each hot path's sync sites (and, on the card, its hidden
    syncs) over the tiny workload.

    Returns the baseline-file shape: ``{"backend": "torch", "hot_paths":
    {name: {"syncs": int, "sync_sites": [...], "hidden_syncs": int |
    None, "hidden_sites": [...] | None}}}``.  ``device`` follows
    ``api.resolve_device``: the card by default, raising without one.
    """
    from ..api import EngineConfig, make_query_engine, make_topk_engine, resolve_device
    from .workload import AUDIT_QUERIES, WARM_QUERIES, tiny_ranked_index

    on_card = resolve_device(device).type == "cuda"
    index = tiny_ranked_index()
    cfg = EngineConfig(device=str(device))
    qe = make_query_engine(index, cfg)
    te = make_topk_engine(index, cfg.replace(resident="kernel"))
    qe.intersect_batch(WARM_QUERIES)
    te.topk_batch(WARM_QUERIES, k=5)

    hot_paths = {}
    for name, run in (
        ("boolean_and", lambda: qe.intersect_batch(AUDIT_QUERIES)),
        ("ranked_topk", lambda: te.topk_batch(AUDIT_QUERIES, k=5)),
    ):
        sites: set = set()
        reads: set = set()
        card: set = set()
        with contextlib.ExitStack() as stack:
            if on_card:
                stack.enter_context(trap_card_syncs(card))
            stack.enter_context(trap_host_reads(sites, reads))
            run()
        hidden = site_names(card - reads) if on_card else None
        hot_paths[name] = {
            "syncs": len(sites),
            "sync_sites": site_names(sites),
            "hidden_syncs": None if hidden is None else len(hidden),
            "hidden_sites": hidden,
        }
    return {"backend": BACKEND, "hot_paths": hot_paths}


def load_baseline(path=BASELINE) -> dict | None:
    try:
        return json.loads(pathlib.Path(path).read_text())
    except (OSError, ValueError):
        return None


def with_baseline_hidden(measured: dict, baseline: dict | None) -> dict:
    """``measured`` with each unmeasured (``None``) hidden-sync field taken
    from ``baseline``: a CPU re-baseline keeps what the card recorded."""
    out = json.loads(json.dumps(measured))
    base_paths = (baseline or {}).get("hot_paths", {})
    for path, m in out["hot_paths"].items():
        b = base_paths.get(path, {})
        if m["hidden_syncs"] is None:
            m["hidden_syncs"] = b.get("hidden_syncs")
            m["hidden_sites"] = b.get("hidden_sites")
    return out


def compare_baseline(measured: dict, baseline: dict | None) -> list[Finding]:
    """Ratchet: a hot path may not exceed its baselined counts."""
    if not baseline:
        return [
            Finding(
                "sync",
                "missing-baseline",
                "src/repro_torch/analyze/sync_baseline.json",
                "no committed sync baseline; run python -m repro_torch.analyze "
                "--update-baseline and commit the file",
            )
        ]
    findings = []
    base_paths = baseline.get("hot_paths", {})
    for path, m in measured.get("hot_paths", {}).items():
        b = base_paths.get(path)
        if b is None:
            continue  # a new hot path baselines on the next --update-baseline
        if m["syncs"] > b.get("syncs", 0):
            findings.append(
                Finding(
                    "sync",
                    "sync-regression",
                    path,
                    f"{m['syncs']} sync sites > baseline {b.get('syncs', 0)} "
                    f"(measured: {', '.join(m['sync_sites'])})",
                )
            )
        hidden, b_hidden = m.get("hidden_syncs"), b.get("hidden_syncs")
        if hidden is not None and b_hidden is not None and hidden > b_hidden:
            findings.append(
                Finding(
                    "sync",
                    "hidden-sync-regression",
                    path,
                    f"{hidden} hidden sync sites > baseline {b_hidden} "
                    f"(measured: {', '.join(m['hidden_sites'])})",
                )
            )
    return findings


def improvements(measured: dict, baseline: dict | None) -> list[str]:
    """Hot paths now BELOW baseline -- candidates for a ratchet-down."""
    if not baseline:
        return []
    out = []
    for path, m in measured.get("hot_paths", {}).items():
        b = baseline.get("hot_paths", {}).get(path)
        if not b:
            continue
        if m["syncs"] < b.get("syncs", 0):
            out.append(
                f"{path}: {m['syncs']} sync sites < baseline "
                f"{b['syncs']} -- ratchet down with --update-baseline"
            )
        hidden, b_hidden = m.get("hidden_syncs"), b.get("hidden_syncs")
        if hidden is not None and b_hidden is not None and hidden < b_hidden:
            out.append(
                f"{path}: {hidden} hidden sync sites < baseline {b_hidden} "
                "-- ratchet down with --update-baseline --device cuda"
            )
    return out
