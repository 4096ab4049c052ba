"""repro_torch.analyze: each checker fires on an injected violation and
stays silent on the clean tree, and the host-sync audit counts what the
reference's audit counts on the same workload (mirrors
``tests/test_analyze.py``, less its HLO and jaxpr cases, plus the port's
kernel-source rules and its CLI)."""

import json
import os
import shutil
import subprocess
import sys
import textwrap
import warnings

import pytest
import torch

from repro.analyze import sync_audit as ref_sync_audit

from repro_torch.analyze import contracts, idiom_lint, kernel_check, sync_audit
from repro_torch.analyze import __main__ as cli
from repro_torch.analyze.discovery import (
    REPO_ROOT,
    SRC_ROOT,
    is_repro_torch_frame,
    repro_torch_source_files,
)


def _baseline():
    return json.loads(sync_audit.BASELINE.read_text())


# ---------------------------------------------------------------- discovery
def test_discovery_agrees_with_tree():
    files = repro_torch_source_files()
    assert SRC_ROOT == REPO_ROOT / "src" / "repro_torch"
    assert SRC_ROOT / "core" / "engine_core.py" in files
    assert SRC_ROOT / "analyze" / "sync_audit.py" in files
    assert all(f.suffix == ".py" for f in files)
    assert repro_torch_source_files("ranked") == sorted(
        (SRC_ROOT / "ranked").glob("*.py"))
    assert is_repro_torch_frame(str(SRC_ROOT / "core" / "engine_core.py"))
    # the unnormalized prefix tests/conftest.py puts on sys.path
    assert is_repro_torch_frame(
        str(REPO_ROOT / "tests" / ".." / "src" / "repro_torch" / "api.py"))
    assert not is_repro_torch_frame(str(REPO_ROOT / "src" / "repro" / "api.py"))
    assert not is_repro_torch_frame(str(REPO_ROOT / "chip_smoke.py"))


# ------------------------------------------------------- contracts: checker 1
def test_contracts_clean_repo():
    assert contracts.check_contracts() == []


def test_contracts_cover_the_reference_families():
    declared = {
        d.name for d in (SRC_ROOT / "kernels").iterdir()
        if (d / "ops.py").exists()
        and contracts.load_contract(d / "ops.py")[0] is not None
    }
    assert declared == {"vbyte_decode", "ef_search", "bm25_score",
                        "blockmax_pivot", "pivot_score"}
    assert set(contracts.REQUIRED_FAMILIES) <= declared


def _write_family(tmp_path, ref_params="a, b", source="csrc/fake_fam.cu"):
    kernels = tmp_path / "kernels"
    fam = kernels / "fake_fam"
    fam.mkdir(parents=True)
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "fake_fam.cu").write_text("// a kernel\n")
    (fam / "ops.py").write_text(
        textwrap.dedent(
            f"""
            CONTRACT = {{
                "family": "fake_fam",
                "identity": "integer",
                "ops": {{
                    "op1": {{
                        "roles": ["x", "y"],
                        "out": ["vals:int32[nr]"],
                        "backends": {{
                            "numpy": {{
                                "module": "ops",
                                "fn": "f_np",
                                "params": ["a:x", "b:y"],
                            }},
                            "ref": {{
                                "module": "ref",
                                "fn": "f_ref",
                                "params": ["a:x", "b:y"],
                            }},
                            "cuda": {{
                                "module": "kernel",
                                "fn": "f_k",
                                "source": "{source}",
                                "params": [
                                    "a:x",
                                    "meta:staging=y",
                                    "rows:gather",
                                ],
                            }},
                        }},
                    }},
                }},
            }}


            def f_np(a, b):
                return a
            """
        )
    )
    (fam / "ref.py").write_text(f"def f_ref({ref_params}):\n    return a\n")
    (fam / "kernel.py").write_text(
        "def f_k(a, meta, rows=None):\n    return a\n"
    )
    return kernels


def test_contracts_fixture_clean(tmp_path):
    kernels = _write_family(tmp_path)
    assert contracts.check_contracts(kernels_root=kernels) == []


def test_contracts_signature_drift_fires(tmp_path):
    # the plain version renamed/reordered a parameter without updating the
    # contract
    kernels = _write_family(tmp_path, ref_params="a, probes")
    findings = contracts.check_contracts(kernels_root=kernels)
    assert any(f.rule == "signature-mismatch" for f in findings)


def test_contracts_missing_required_fires(tmp_path):
    (tmp_path / "bare_fam").mkdir()
    (tmp_path / "bare_fam" / "ops.py").write_text("X = 1\n")
    findings = contracts.check_contracts(
        kernels_root=tmp_path, required=("bare_fam",)
    )
    assert any(f.rule == "missing-contract" for f in findings)


def test_contracts_integer_float_out_fires(tmp_path):
    kernels = _write_family(tmp_path)
    ops = kernels / "fake_fam" / "ops.py"
    ops.write_text(ops.read_text().replace('"vals:int32[nr]"', '"vals:float32[nr]"'))
    findings = contracts.check_contracts(kernels_root=kernels)
    assert any(f.rule == "integer-float-out" for f in findings)


@pytest.mark.parametrize("source", ["csrc/gone.cu", "fake_fam.cu", ""])
def test_contracts_cuda_source_must_exist(tmp_path, source):
    kernels = _write_family(tmp_path, source=source)
    findings = contracts.check_contracts(kernels_root=kernels)
    assert [f.rule for f in findings] == ["missing-source"]
    assert findings[0].where == "fake_fam/op1[cuda]"


def test_contracts_missing_backend_fires(tmp_path):
    kernels = _write_family(tmp_path)
    ops = kernels / "fake_fam" / "ops.py"
    ops.write_text(ops.read_text().replace('"cuda": {', '"pallas": {'))
    rules = {f.rule for f in contracts.check_contracts(kernels_root=kernels)}
    assert "missing-backend" in rules and "unknown-module" not in rules


# -------------------------------------------------- kernel sources: checker 2
def test_kernel_check_clean_repo():
    assert kernel_check.check_kernels() == []


def _fixture_csrc(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(kernel_check.CSRC, csrc)
    build_py = tmp_path / "_build.py"
    shutil.copy(kernel_check.BUILD_PY, build_py)
    return csrc, build_py


@pytest.mark.parametrize("target,append,rule", [
    ("csrc/ef_search.cu", "\n__device__ float leak(int x) { return x * 1.5f; }\n",
     "float-in-integer-kernel"),
    ("csrc/svb_tile.cuh", "\n__device__ double wide;\n",
     "float-in-integer-kernel"),
    ("csrc/bm25_tile.cuh", "\n__device__ float f(float a, float b, float c)"
     " { return fmaf(a, b, c); }\n", "approx-intrinsic"),
    ("csrc/bm25_score.cu", "\n__device__ float q(float a, float b)"
     " { return __fdividef(a, b); }\n", "approx-intrinsic"),
    ("csrc/embedding_bag.cu", "\n__device__ float s(float a, float b)"
     " { return __fadd_rz(a, b); }\n", "approx-intrinsic"),
    ("csrc/pivot_score.cu", "\n__device__ float m(float a, float b, float c)"
     " { return __fmaf_rn(a, b, c); }\n", "approx-intrinsic"),
    ("_build.py", '\nEXTRA = ["--use_fast_math"]\n', "fast-math"),
    ("_build.py", '\nEXTRA = ["-ftz=true", "-prec-div=false"]\n', "fast-math"),
    ("_build.py", '\nEXTRA = ["--prec-sqrt=false"]\n', "fast-math"),
    ("csrc/new_kernel.cu", "// no rule reads me\n", "unclassified-source"),
])
def test_kernel_check_rules_fire(tmp_path, target, append, rule):
    csrc, build_py = _fixture_csrc(tmp_path)
    path = tmp_path / target
    path.write_text((path.read_text() if path.exists() else "") + append)
    findings = kernel_check.check_kernels(csrc, build_py)
    assert findings and {f.rule for f in findings} == {rule}
    if rule != "unclassified-source":
        lineno = len(path.read_text().splitlines())
        assert all(f.where.endswith(f"{path.name}:{lineno}") for f in findings)


def test_kernel_check_ignores_comments(tmp_path):
    csrc, build_py = _fixture_csrc(tmp_path)
    path = csrc / "gain_scan.cu"
    path.write_text(path.read_text() + "\n// a float here is prose\n"
                    "/* so is a double\n   across lines */\n")
    assert kernel_check.check_kernels(csrc, build_py) == []
    assert kernel_check.strip_comments("a /* x\ny */ b // c\nd") == "a \n b \nd"


def test_kernel_check_ptx_rule():
    clean = "div.rn.f32 %f3, %f1, %f2;\nmul.rn.f32 %f4, %f3, %f3;\n"
    findings, divs = kernel_check.check_ptx(lambda name: clean)
    assert findings == [] and divs == dict.fromkeys(kernel_check.F32_LIBS, 1)
    for bad in kernel_check.PTX_FORBIDDEN:
        texts = {"pivot_score": clean + f"{bad} %f5, %f1, %f2;\n"}
        findings, _ = kernel_check.check_ptx(lambda n: texts.get(n, clean))
        assert [(f.rule, f.where) for f in findings] == [
            ("ptx-f32-contract", "csrc/pivot_score.cu")]


# ------------------------------------------------------------ sync: checker 3
def test_sync_audit_matches_baseline_and_reference():
    measured = sync_audit.audit_hot_paths(device="cpu")
    paths = measured["hot_paths"]
    assert paths["boolean_and"]["sync_sites"] == [
        "src/repro_torch/core/engine_core.py::_dispatch"]
    assert paths["ranked_topk"]["sync_sites"] == [
        "src/repro_torch/ranked/topk_engine.py::_fetch"]
    assert all(m["hidden_syncs"] is None for m in paths.values())
    assert sync_audit.compare_baseline(measured, _baseline()) == []
    base = _baseline()["hot_paths"]
    for name, m in paths.items():
        assert (m["syncs"], m["sync_sites"]) == (
            base[name]["syncs"], base[name]["sync_sites"])
    # the reference's audit on the same corpus and queries counts the same
    want = ref_sync_audit.audit_hot_paths(backend="ref")["hot_paths"]
    assert {k: m["syncs"] for k, m in paths.items()} == {
        k: m["syncs"] for k, m in want.items()} == {
        "boolean_and": 1, "ranked_topk": 1}


def test_sync_injected_fetch_fires(monkeypatch):
    # a refactor adds a device fetch to the ranked batch entry: the audited
    # site set grows past the baseline and the ratchet trips
    from repro_torch.ranked import topk_engine

    leak = torch.arange(8)
    orig = topk_engine.TopKEngine._query_spec

    def leaky(self, terms):
        leak.cpu()
        return orig(self, terms)

    monkeypatch.setattr(topk_engine.TopKEngine, "_query_spec", leaky)
    measured = sync_audit.audit_hot_paths(device="cpu")
    assert measured["hot_paths"]["boolean_and"]["syncs"] == 1
    findings = sync_audit.compare_baseline(measured, _baseline())
    assert [(f.rule, f.where) for f in findings] == [
        ("sync-regression", "ranked_topk")]
    # the fetch attributes to the innermost repro_torch frame: the caller
    # (the batch's body, under the span that ``topk_batch`` opens)
    assert "src/repro_torch/ranked/topk_engine.py::_topk_batch" \
        in findings[0].message


@pytest.mark.parametrize("expr,counted", [
    ("t.cpu()", True), ("t.numpy()", True), ("t.item()", True),
    ("t.tolist()", True), ("np.asarray(t)", True), ("bool(t)", True),
    ("int(t)", True), ("float(t)", True), ("[0, 1, 2, 3][t]", True),
    ("t.to(torch.float32)", False), ("t.to('cpu')", False),
    ("t + 1", False), ("t.sum()", False),
])
def test_host_read_trap_sees_each_materialization(expr, counted):
    # compiled under a repro_torch file name, so the site attributes there
    fake = SRC_ROOT / "core" / "fake_engine.py"
    code = compile(f"def fetch(t):\n    return {expr}\n", str(fake), "exec")
    scope = {"np": __import__("numpy"), "torch": torch}
    exec(code, scope)
    sites, reads = set(), set()
    with sync_audit.trap_host_reads(sites, reads):
        scope["fetch"](torch.tensor(3))
    assert sites == ({("src/repro_torch/core/fake_engine.py", "fetch")}
                     if counted else set())
    # each read also names its kind, the torch function that made it
    assert {r[:2] for r in reads} == sites
    assert all(isinstance(r[2], str) and r[2] for r in reads)


def test_card_trap_attributes_through_torch_frames(monkeypatch):
    # on the card the warning comes from torch's C++ (or a torch Python
    # wrapper); the hook walks out to the innermost repro_torch frame and
    # counts every event, not each location once
    mode = {"now": 0}
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: mode["now"])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda m: mode.__setitem__("now", m))
    torch_file = os.path.join(os.path.dirname(torch.__file__), "_fake.py")
    inner = compile(
        "import warnings\n"
        "def sync(msg):\n"
        "    warnings.warn(msg)\n", torch_file, "exec")
    outer = compile(
        "def batch(sync, msg):\n"
        "    for _ in range(3):\n"
        "        sync(msg)\n", str(SRC_ROOT / "ranked" / "fake_topk.py"), "exec")
    ti, to = {}, {}
    exec(inner, ti)
    exec(outer, to)
    sites = set()
    with warnings.catch_warnings(record=True) as shown:
        with sync_audit.trap_card_syncs(sites) as counts:
            assert mode["now"] == "warn"
            to["batch"](ti["sync"], sync_audit.SYNC_WARNING)
            warnings.warn("unrelated")
    assert mode["now"] == 0
    # the syncs are consumed; any other warning passes through
    assert [str(w.message) for w in shown] == ["unrelated"]
    # no torch function was in flight: the kind is unknown
    assert sites == {("src/repro_torch/ranked/fake_topk.py", "batch", "?")}
    assert counts["events"] == 3


def test_card_syncs_are_keyed_by_site_and_kind(monkeypatch):
    # a sync fired inside a torch function is keyed by that function's
    # name; an implicit sync beside an explicit fetch in the same function
    # is still hidden, since the explicit read accounts only for its kind
    mode = {"now": 0}
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: mode["now"])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda m: mode.__setitem__("now", m))
    torch_file = os.path.join(os.path.dirname(torch.__file__), "_fake_ops.py")
    ops = compile(textwrap.dedent("""\
        import warnings
        from torch.overrides import handle_torch_function, has_torch_function_unary

        def _op(name):
            def op(t, msg):
                if has_torch_function_unary(t):
                    return handle_torch_function(op, (t,), t, msg)
                warnings.warn(msg)
                return t
            op.__name__ = name
            return op

        cpu, nonzero = _op("cpu"), _op("nonzero")
        """), torch_file, "exec")
    engine = compile(textwrap.dedent("""\
        def fetch(ops, t, msg):
            host = t.cpu()          # the explicit read
            ops["cpu"](t, msg)      # ... and the card's sync for it
            ops["nonzero"](t, msg)  # an implicit sync in the same function
            return host
        """), str(SRC_ROOT / "ranked" / "fake_topk.py"), "exec")
    fake_ops, scope = {}, {}
    exec(ops, fake_ops)
    exec(engine, scope)
    sites, reads, card = set(), set(), set()
    with sync_audit.trap_card_syncs(card) as counts:
        with sync_audit.trap_host_reads(sites, reads):
            scope["fetch"](fake_ops, torch.arange(4), sync_audit.SYNC_WARNING)
    where = ("src/repro_torch/ranked/fake_topk.py", "fetch")
    assert sites == {where}
    assert reads == {(*where, "cpu")}
    assert card == {(*where, "cpu"), (*where, "nonzero")}
    assert counts["events"] == 2
    assert sync_audit.site_names(card - reads) == [
        "src/repro_torch/ranked/fake_topk.py::fetch [nonzero]"]


def test_sync_ratchet_semantics():
    baseline = _baseline()
    for m in baseline["hot_paths"].values():
        m["hidden_syncs"], m["hidden_sites"] = 0, []
    worse = json.loads(json.dumps(baseline))
    worse["hot_paths"]["boolean_and"]["syncs"] += 1
    worse["hot_paths"]["ranked_topk"]["hidden_syncs"] += 1
    worse["hot_paths"]["ranked_topk"]["hidden_sites"] = ["x.py::f"]
    findings = sync_audit.compare_baseline(worse, baseline)
    assert {f.rule for f in findings} == {
        "sync-regression",
        "hidden-sync-regression",
    }
    # equal-to-baseline passes; missing baseline is itself a finding
    assert sync_audit.compare_baseline(baseline, baseline) == []
    missing = sync_audit.compare_baseline(baseline, None)
    assert [f.rule for f in missing] == ["missing-baseline"]
    # below-baseline is not a failure, just a ratchet-down hint
    better = json.loads(json.dumps(baseline))
    better["hot_paths"]["ranked_topk"]["syncs"] = 0
    assert sync_audit.compare_baseline(better, baseline) == []
    assert sync_audit.improvements(better, baseline)
    # an unmeasured (CPU) hidden count is never compared
    cpu = json.loads(json.dumps(worse))
    for m in cpu["hot_paths"].values():
        m["hidden_syncs"] = m["hidden_sites"] = None
    assert [f.rule for f in sync_audit.compare_baseline(cpu, baseline)] == [
        "sync-regression"]


def test_cpu_rebaseline_keeps_the_cards_hidden_counts():
    measured = sync_audit.audit_hot_paths(device="cpu")
    card = json.loads(json.dumps(measured))
    card["hot_paths"]["ranked_topk"]["hidden_syncs"] = 2
    card["hot_paths"]["ranked_topk"]["hidden_sites"] = ["a.py::f", "b.py::g"]
    card["hot_paths"]["boolean_and"]["hidden_syncs"] = 0
    card["hot_paths"]["boolean_and"]["hidden_sites"] = []
    assert sync_audit.with_baseline_hidden(measured, card) == card
    assert sync_audit.with_baseline_hidden(measured, None) == measured
    assert sync_audit.with_baseline_hidden(card, measured) == card


# ----------------------------------------------------------- idiom: checker 4
def test_idiom_clean_repo():
    assert idiom_lint.lint_repo() == []


@pytest.mark.parametrize(
    "src,rel,rule",
    [
        (
            "import numpy as np\n\n\ndef f(x):\n"
            "    return x * np.float32(1.5)\n",
            "src/repro_torch/ranked/fake.py",
            "ranked-f32-math",
        ),
        (
            "import torch\n\n\ndef f(x):\n"
            "    return torch.tensor(2.0, dtype=torch.float32) + x\n",
            "src/repro_torch/ranked/fake.py",
            "ranked-f32-math",
        ),
        (
            'import os\n\nBACKEND = os.environ.get("REPRO_BACKEND", "torch")\n',
            "src/repro_torch/core/fake.py",
            "backend-route",
        ),
        (
            "import torch\n\nDEV = 'cuda' if torch.cuda.is_available() else 'cpu'\n",
            "src/repro_torch/launch/fake.py",
            "backend-route",
        ),
        (
            "import time\n\nt0 = time.perf_counter()\n",
            "src/repro_torch/core/fake.py",
            "obs-timers",
        ),
        (
            "import time\n\nnow = time.time()\n",
            "src/repro_torch/distributed/fake.py",
            "obs-timers",
        ),
        (
            "import time\n\nnow = time.monotonic()\n",
            "src/repro_torch/serving/fake.py",
            "obs-timers",
        ),
    ],
)
def test_idiom_rules_fire(src, rel, rule):
    findings = idiom_lint.lint_source(src, rel)
    assert [f.rule for f in findings] == [rule]
    assert findings[0].where == f"{rel}:{len(src.splitlines())}"


def test_idiom_scoping_and_suppression():
    # same constructs are fine outside the scoped tree / on the authority
    f32 = (
        "import numpy as np\n\n\ndef f(x):\n"
        "    return x * np.float32(1.5)\n"
    )
    assert idiom_lint.lint_source(f32, "src/repro_torch/models/fake.py") == []
    assert idiom_lint.lint_source(f32, idiom_lint.F32_AUTHORITY) == []
    # a float32 constant that is not an operand is fine in ranked/ too
    value = "import numpy as np\n\nK = np.float32(1.5)\nf(np.float32(2.0))\n"
    assert idiom_lint.lint_source(value, "src/repro_torch/ranked/fake.py") == []
    env = 'import os\n\nB = os.environ.get("REPRO_BACKEND", "torch")\n'
    assert idiom_lint.lint_source(env, idiom_lint.BACKEND_AUTHORITY) == []
    suppressed = (
        "import torch\n\n"
        "ok = torch.cuda.is_available()  # analyze: allow\n"
    )
    assert idiom_lint.lint_source(suppressed, "src/repro_torch/obs/fake.py") == []


def test_idiom_obs_timers_scoping():
    clock = "import time\n\nt0 = time.perf_counter()\n"
    # the clock's home and everything outside src/repro_torch/ are exempt
    assert idiom_lint.lint_source(clock, "src/repro_torch/obs/trace.py") == []
    assert idiom_lint.lint_source(clock, "src/repro/core/fake.py") == []
    assert idiom_lint.lint_source(clock, "chip_smoke.py") == []
    # non-timing uses of the time module and a clock REFERENCE never fire
    sleep = (
        "import time\n\ntime.sleep(0.1)\nstamp = time.time_ns()\n\n\n"
        "def f(clock=time.monotonic):\n    return clock\n"
    )
    assert idiom_lint.lint_source(sleep, "src/repro_torch/serving/fake.py") == []
    suppressed = (
        "import time\n\n"
        "t0 = time.perf_counter()  # analyze: allow\n"
    )
    assert idiom_lint.lint_source(suppressed, "src/repro_torch/core/fake.py") == []


# ---------------------------------------------------------------------- CLI
def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analyze", *args],
        capture_output=True, text=True, env=env, timeout=300,
    )


def test_cli_check_on_the_cpu():
    proc = _cli("--check", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    for line in ("[analyze] contracts: 0 finding(s)",
                 "[analyze] idiom lint: 0 finding(s)",
                 "[analyze] kernel sources: 0 finding(s)",
                 "[analyze] kernel PTX: skipped on --device cpu",
                 "[analyze] sync audit (cpu): boolean_and=1",
                 "[analyze] OK"):
        assert line in out
    assert out.rstrip().endswith("[analyze] OK")


def test_cli_update_baseline_reproduces_the_committed_file(tmp_path):
    # a CPU measurement keeps the hidden counts the card recorded, so the
    # committed file comes back byte for byte
    tmp = tmp_path / "baseline.json"
    shutil.copy(sync_audit.BASELINE, tmp)
    proc = _cli("--update-baseline", "--device", "cpu", "--baseline", str(tmp))
    assert proc.returncode == 0, proc.stderr
    assert tmp.read_bytes() == sync_audit.BASELINE.read_bytes()


def test_cli_refuses_to_raise_the_baseline(tmp_path):
    lower = _baseline()
    lower["hot_paths"]["ranked_topk"]["syncs"] = 0
    tmp = tmp_path / "baseline.json"
    tmp.write_text(json.dumps(lower))
    proc = _cli("--update-baseline", "--device", "cpu", "--baseline", str(tmp))
    assert proc.returncode == 1 and "refusing to RAISE" in proc.stdout
    assert json.loads(tmp.read_text()) == lower
    proc = _cli("--update-baseline", "--device", "cpu", "--force",
                "--baseline", str(tmp))
    assert proc.returncode == 0, proc.stderr
    assert json.loads(tmp.read_text())["hot_paths"]["ranked_topk"]["syncs"] == 1


def test_cli_fails_on_an_injected_fetch(monkeypatch, capsys):
    from repro_torch.ranked import topk_engine

    orig = topk_engine.TopKEngine._query_spec

    def leaky(self, terms):
        torch.arange(4).cpu()
        return orig(self, terms)

    monkeypatch.setattr(topk_engine.TopKEngine, "_query_spec", leaky)
    assert cli.main(["--check", "--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert "[sync/sync-regression] ranked_topk" in err
    assert "boolean_and" not in err


def test_cli_without_a_card_never_falls_back(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["--check"]) == 2
    assert "CUDA is not available" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sync_audit.audit_hot_paths()
