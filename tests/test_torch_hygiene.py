"""Import hygiene of the port: ``repro_torch`` never imports ``jax`` or the
``repro`` reference package, statically or at run time."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
PKG = os.path.join(ROOT, "src", "repro_torch")
FORBIDDEN = ("jax", "repro")


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _forbidden_imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [n for n in names if n.split(".")[0] in FORBIDDEN]
    return bad


def test_static_scan_finds_no_jax_or_repro_import():
    files = list(_sources())
    assert len(files) >= 17
    found = {os.path.relpath(f, PKG): b for f in files if (b := _forbidden_imports(f))}
    assert found == {}


def test_scanner_flags_what_it_must(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import jax.numpy as jnp\nfrom repro.core import index\n"
                   "from repro_torch import api\nfrom . import repro\n")
    assert _forbidden_imports(str(bad)) == ["jax.numpy", "repro.core"]


@pytest.mark.parametrize("module", [
    "repro_torch.launch.serve", "repro_torch.convert",
    "repro_torch.examples.train_recsys", "repro_torch.launch.cells",
    "repro_torch.serving", "repro_torch.obs.server", "repro_torch.obs.export",
    "repro_torch.configs.optvb_index", "repro_torch.core.shard",
    "repro_torch.core.arena_ckpt", "repro_torch.checkpoint",
    "repro_torch.distributed", "repro_torch.analyze",
    "repro_torch.analyze.sync_audit", "repro_torch.core.competitors",
    "repro_torch.launch.train", "repro_torch.core.jax_engine",
    "repro_torch.examples.quickstart", "repro_torch.examples.index_serving",
    "repro_torch.models.transformer", "repro_torch.data.lm_data",
    "repro_torch.configs.qwen1_5_0_5b", "repro_torch.configs.qwen3_0_6b",
    "repro_torch.configs.command_r_35b", "repro_torch.configs.mixtral_8x22b",
    "repro_torch.configs.moonshot_v1_16b_a3b", "repro_torch.examples.train_lm",
])
def test_import_leaves_no_jax_or_repro_module(module):
    code = (
        f"import sys, {module}\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        f"assert {module!r} in sys.modules\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


@pytest.mark.parametrize("name", ["discovery", "report"])
def test_stdlib_only_analyze_module_loads_by_path_without_torch(name):
    """``analyze/discovery.py`` and ``analyze/report.py`` load by file path
    (as a tool does before anything imports the package) and import no
    torch, numpy or reference module."""
    path = os.path.join(PKG, "analyze", f"{name}.py")
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('m', {path!r})\n"
        "mod = sys.modules['m'] = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('torch', 'numpy', 'jax', 'repro', 'repro_torch')))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
