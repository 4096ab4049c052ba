"""The port's serving entry point: it runs end to end on the CPU only when
asked to, and checks its batched answers against the scalar loop."""

import json
import os
import subprocess
import sys

import pytest

from repro_torch.launch import serve

ROOT = os.path.join(os.path.dirname(__file__), "..")
TINY = ["--n-lists", "6", "--min-len", "300", "--max-len", "3000",
        "--queries", "24", "--batch", "8", "--seed", "1"]


@pytest.mark.parametrize(
    "extra",
    [["--codec", "auto"], ["--codec", "ef", "--no-fused"],
     ["--codec", "svb", "--backend", "numpy"]],
    ids=["auto", "ef-partition-lru", "numpy"],
)
def test_serve_cpu_compare_scalar(extra, capsys):
    assert serve.main(TINY + extra + ["--device", "cpu", "--compare-scalar"]) == 0
    out = capsys.readouterr().out
    assert "results identical" in out
    assert "q/s" in out and "p99" in out


def test_serve_config_file_and_run_summary(tmp_path):
    cfg = tmp_path / "engine.json"
    cfg.write_text(json.dumps({"device": "cpu", "codec_policy": "ef",
                               "cache_bytes": 1 << 16}))
    args = serve.parse_args(TINY + ["--config", str(cfg), "--codec", "auto"])
    assert args.cfg.codec_policy == "auto" and args.cfg.cache_bytes == 1 << 16
    got = serve.run(args)
    assert got["engine"].arena is got["index"].arena_for("auto")
    assert got["n_postings"] == sum(got["index"].list_sizes)
    assert got["qps"] > 0 and got["batch_p99_s"] >= got["batch_p50_s"] > 0
    assert got["arena_device_bytes"] == got["engine"].arena.device_nbytes("cpu")
    assert len(got["results"]) == 24


def test_serve_default_device_needs_cuda():
    """Without a card the default device refuses to start: no silent run on
    the CPU."""
    if __import__("torch").cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *TINY],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120,
    )
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
    assert "batched AND" not in proc.stdout


RANKED = ["--ranked", "--n-lists", "12", "--min-len", "300", "--max-len",
          "4000", "--queries", "32", "--batch", "16", "--seed", "2"]


@pytest.mark.parametrize("resident", ["kernel", "mirror"])
def test_serve_ranked_cpu_compare_scalar(resident, capsys):
    """--ranked serves BM25 top-k and --compare-scalar holds every result to
    the exhaustive oracle (identical docIDs and scores)."""
    args = serve.parse_args(RANKED + ["--resident", resident, "--device",
                                      "cpu", "--compare-scalar"])
    assert args.cfg.resident == resident
    got = serve.run(args)
    out = capsys.readouterr().out
    assert "identical top-k" in out and f"torch/{resident}" in out
    assert got["engine"].resident == resident
    assert len(got["results"]) == 32 and got["oracle_s"] > 0
    assert all(len(d) == 10 for d, _ in got["results"])
    assert got["arena_device_bytes"] == got["engine"].arena.device_nbytes("cpu")


def test_serve_ranked_default_device_needs_cuda():
    if __import__("torch").cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *RANKED],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120,
    )
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
    assert "ranked top-" not in proc.stdout
