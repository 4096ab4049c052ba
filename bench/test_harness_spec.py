"""``BENCHMARK.json`` keeps the contract's rules of form, and the harness
finds every piece of a cell by its name: a cell added as files and entries
alone runs without an edit to the harness."""

import json
import os

import pytest

from bench.conftest import ROOT, make_tiny_root
from bench.harness import cell, spec


def test_benchmark_json_keeps_the_rules_of_form():
    bm = spec.load(ROOT)
    assert spec.problems(bm) == []
    assert len(json.dumps(bm)) <= 64 * 1024
    assert bm["paths"] == ["bench"]
    assert all(w["chips"] == 1 for w in bm["workloads"])


@pytest.mark.parametrize("edit, fragment", [
    (lambda b: b["workloads"][0].update(name="gov2 topk"), "bad name"),
    (lambda b: b["end_to_end"][0].update(unit="queries per s"), "unit"),
    (lambda b: b["per_layer"][0].update(moves="nothing"), "moves"),
    (lambda b: b["end_to_end"][0].update(bound=0.3), "bound"),
    (lambda b: b["workloads"].append(dict(b["workloads"][0], name="x")),
     "repeat"),
    (lambda b: b["per_layer"][0].update(why="extra"), "keys"),
])
def test_problems_names_what_breaks_a_rule(edit, fragment):
    bm = spec.load(ROOT)
    edit(bm)
    assert any(fragment in p for p in spec.problems(bm))


@pytest.mark.parametrize("cell_name", [
    w["name"] for w in spec.load(ROOT)["workloads"]])
def test_every_piece_of_a_cell_is_found_by_name(cell_name):
    bm = spec.load(ROOT)
    w = spec.workload(bm, cell_name)
    cfg = spec.config(bm, w["config"])
    mix = spec.traffic(w["traffic"])
    assert cfg["name"] == w["config"]
    assert mix["op"] in ("and", "topk")
    layer = spec.metrics_of(bm, cell_name, "per_layer")
    e2e = {m["name"] for m in spec.metrics_of(bm, cell_name, "end_to_end")}
    assert layer and "setup_s" in e2e and len(e2e) >= 2
    for m in layer:
        assert callable(spec.reader(m["name"]).read)
        assert m["moves"] in e2e


def test_a_cell_added_as_files_alone_runs(tmp_path):
    root = make_tiny_root(tmp_path)
    with open(os.path.join(root, "bench", "configs", "fixture.json"), "w") as fh:
        json.dump(dict(spec.config(spec.load(root), "gov2", root),
                       name="fixture", n_lists=6), fh)
    with open(os.path.join(root, "bench", "traffic", "and-b4.json"), "w") as fh:
        json.dump(dict(spec.traffic("and-b64", root), batch=4), fh)
    with open(os.path.join(root, "bench", "metrics", "fixture.calls.py"),
              "w") as fh:
        fh.write("def read(ctx):\n    return ctx.window.units\n")
    bm = spec.load(root)
    bm["configs"].append(dict(bm["configs"][0], name="fixture",
                              file="bench/configs/fixture.json"))
    bm["workloads"].append({"name": "fixture.and-b4", "config": "fixture",
                            "traffic": "and-b4", "chips": 1,
                            "why": "a fixture cell"})
    bm["per_layer"].append({"name": "fixture.calls", "unit": "calls",
                            "better": "higher", "source": "host_clock",
                            "layer": "boolean engine", "moves": "qps",
                            "workloads": ["fixture.and-b4"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bm, fh)
    assert spec.problems(bm) == []
    out = cell.run_cell("fixture.and-b4", 3, 0.2, True, 0.0, root=root,
                        device="cpu", log=open(os.devnull, "w"))
    assert out["correct"]
    assert out["metrics"]["fixture.calls"]["value"] >= 1
    assert out["attempted"] % 4 == 0
