"""Nothing of the benchmark imports JAX or the JAX package (``repro``),
compared by whole top-level names, or reads the JAX package's benchmark
folder; the reference imports nothing of the program; a run refuses to
print a result without a card, without the program, or with JAX loaded."""

import ast
import io
import json
import os
import shutil
import subprocess
import sys


from bench import run
from bench.conftest import HERE, ROOT
from bench.harness import cell

THEIR_FOLDER = "bench" + "marks"  # the JAX package's drivers


def _sources(sub=""):
    for d, _, fs in os.walk(os.path.join(HERE, sub)):
        for f in sorted(fs):
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    names = []
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def _top(names):
    return {n.split(".")[0] for n in names}


def test_no_source_imports_jax_or_the_jax_package():
    found = {}
    for f in _sources():
        if os.path.basename(f).startswith("test_harness_"):
            continue
        bad = _top(_imports(f)) & set(cell.FORBIDDEN)
        if bad:
            found[os.path.relpath(f, HERE)] = bad
    assert found == {}


def test_the_reference_imports_nothing_of_the_program():
    for f in _sources("reference"):
        assert _top(_imports(f)) <= {"__future__", "numpy", "torch"}, f


def test_no_source_reads_the_jax_benchmark_folder():
    for f in _sources():
        if os.path.basename(f).startswith("test_harness_"):
            continue
        text = open(f).read()
        assert THEIR_FOLDER not in text, f
        assert THEIR_FOLDER not in _top(_imports(f)), f


def test_forbidden_modules_compares_whole_top_level_names():
    fine = ["repro_torch", "repro_torch.core", "jaxtyping", "reproduce",
            "flax_like", "numpy"]
    assert cell.forbidden_modules(fine) == []
    bad = ["repro.core.index", "jax", "jaxlib.xla", "flax", "repro"]
    assert cell.forbidden_modules(fine + bad) == sorted(bad)


def _main(monkeypatch, argv):
    monkeypatch.setattr(run, "_env", lambda: None)
    out = io.StringIO()
    monkeypatch.setattr(sys, "stdout", out)
    monkeypatch.setattr(sys, "stderr", io.StringIO())
    return run.main(argv), out.getvalue()


ARGV = ["--workload", "gov2.and-b64", "--seed", "1", "--seconds", "1"]


def test_no_card_no_result(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out = _main(monkeypatch, ARGV)
    assert rc != 0 and out == ""


def test_jax_loaded_after_the_window_no_result(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    fake = {"correct": True, "attempted": 1, "failed": 0, "metrics": {},
            "device": {}, "checks": {}}
    monkeypatch.setattr(cell, "run_cell", lambda *a, **k: fake)
    monkeypatch.setattr(cell, "forbidden_modules", lambda: ["repro"])
    rc, out = _main(monkeypatch, ARGV)
    assert rc != 0 and out == ""
    monkeypatch.setattr(cell, "forbidden_modules", lambda: [])
    rc, out = _main(monkeypatch, ARGV)
    assert rc == 0 and json.loads(out.splitlines()[-1]) == fake


def test_a_folder_of_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copytree(HERE, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "bench/run.py", *ARGV],
                          cwd=tmp_path, capture_output=True, text=True,
                          env=env, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
