"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration and a traffic mix; the
harness reads ``bench/configs/<config>.json`` (the configuration's entry in
``configs`` gives its file), ``bench/traffic/<traffic>.json`` (and
``bench/traffic/<traffic>.py`` where the mix brings code), and for a
traced run ``bench/metrics/<metric>.py`` for each per-layer metric the cell
reports.  Adding a configuration, a mix or a metric means adding files and
entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP_KEYS = ["command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"]
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
WORKLOAD_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _line(s) -> bool:
    return (isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s
            and "\t" not in s)


def problems(spec: dict) -> list[str]:
    """What in ``spec`` breaks the contract's rules of form (names, units,
    keys, references between entries); empty when it keeps them all."""
    out = []
    if list(spec) != TOP_KEYS:
        out.append(f"top-level keys {list(spec)} != {TOP_KEYS}")
    names = {}
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in spec.get(kind, []):
            n = e.get("name")
            if not isinstance(n, str) or not NAME.match(n):
                out.append(f"{kind}: bad name {n!r}")
            names.setdefault(kind, []).append(n)
    for kind in ("configs", "workloads"):
        if len(set(names.get(kind, []))) != len(names.get(kind, [])):
            out.append(f"{kind}: a name repeats")
    metrics = names.get("end_to_end", []) + names.get("per_layer", [])
    if len(set(metrics)) != len(metrics):
        out.append("metrics: a name repeats")
    cfgs = set(names.get("configs", []))
    cells = set(names.get("workloads", []))
    for c in spec.get("configs", []):
        if set(c) != CONFIG_KEYS:
            out.append(f"config {c.get('name')}: keys {sorted(c)}")
        if not _line(c.get("source")) or not _line(c.get("why", "x")):
            out.append(f"config {c.get('name')}: source or why")
        if not all(NAME.match(k) for k in c.get("reduced", [])):
            out.append(f"config {c.get('name')}: a reduced key")
        if not os.path.normpath(c.get("file", "")).startswith("bench/configs"):
            out.append(f"config {c.get('name')}: file outside bench/configs")
    pairs = set()
    for w in spec.get("workloads", []):
        if set(w) != WORKLOAD_KEYS:
            out.append(f"workload {w.get('name')}: keys {sorted(w)}")
        if w.get("config") not in cfgs:
            out.append(f"workload {w.get('name')}: unknown config")
        if not NAME.match(str(w.get("traffic"))):
            out.append(f"workload {w.get('name')}: bad traffic name")
        if w.get("chips") not in (1, 4):
            out.append(f"workload {w.get('name')}: chips")
        if not _line(w.get("why")):
            out.append(f"workload {w.get('name')}: why")
        pair = (w.get("config"), w.get("traffic"))
        if pair in pairs:
            out.append(f"workload {w.get('name')}: config and traffic repeat")
        pairs.add(pair)
    e2e = {}
    for m in spec.get("end_to_end", []):
        if set(m) - {"workloads"} != E2E_KEYS:
            out.append(f"metric {m.get('name')}: keys {sorted(m)}")
        if m.get("source") not in ("host_clock", "device_trace"):
            out.append(f"metric {m.get('name')}: source")
        if not 0.01 <= m.get("bound", 0) <= 0.25:
            out.append(f"metric {m.get('name')}: bound")
        e2e[m.get("name")] = set(m.get("workloads", cells))
    if "setup_s" not in e2e:
        out.append("no setup_s")
    for m in spec.get("per_layer", []):
        if set(m) - {"workloads"} != LAYER_KEYS:
            out.append(f"metric {m.get('name')}: keys {sorted(m)}")
        if m.get("source") not in ("device_trace", "program_span",
                                   "program_counter", "host_clock"):
            out.append(f"metric {m.get('name')}: source")
        if not _line(m.get("layer")):
            out.append(f"metric {m.get('name')}: layer")
        moves = m.get("moves")
        where = set(m.get("workloads", cells))
        if moves not in e2e or not where <= e2e[moves]:
            out.append(f"metric {m.get('name')}: moves {moves!r} is not "
                       "reported wherever it is")
    for m in spec.get("end_to_end", []) + spec.get("per_layer", []):
        if not isinstance(m.get("unit"), str) or not UNIT.match(m["unit"]):
            out.append(f"metric {m.get('name')}: unit {m.get('unit')!r}")
        if m.get("better") not in ("lower", "higher"):
            out.append(f"metric {m.get('name')}: better")
        if not set(m.get("workloads", [])) <= cells:
            out.append(f"metric {m.get('name')}: unknown workload")
    return out


def workload(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(spec: dict, name: str, root: str = ROOT) -> dict:
    """The configuration ``name`` as its file holds it."""
    for c in spec["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as fh:
                return json.load(fh)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, root: str = ROOT) -> dict:
    """The traffic mix ``bench/traffic/<name>.json``."""
    with open(os.path.join(root, "bench", "traffic", f"{name}.json")) as fh:
        return json.load(fh)


def metrics_of(spec: dict, cell: str, kind: str) -> list[dict]:
    """The ``kind`` metrics (``end_to_end`` or ``per_layer``) ``cell``
    reports: those that list it, and those that list no cell."""
    return [m for m in spec[kind] if cell in m.get("workloads", [cell])]


def _module(path: str, name: str):
    mod_spec = importlib.util.spec_from_file_location(
        name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reader(name: str, root: str = ROOT):
    """The module ``bench/metrics/<name>.py`` (a per-layer metric's
    reader), loaded by its path."""
    return _module(os.path.join(root, "bench", "metrics", f"{name}.py"),
                   f"bench_metric_{name}")


def traffic_code(name: str, root: str = ROOT):
    """The module ``bench/traffic/<name>.py`` of a mix that brings code of
    its own (its pool, its driver), or None."""
    path = os.path.join(root, "bench", "traffic", f"{name}.py")
    return _module(path, f"bench_traffic_{name}") if os.path.exists(
        path) else None
