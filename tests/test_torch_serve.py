"""The port's serving entry point: it runs end to end on the CPU only when
asked to, and checks its batched answers against the scalar loop."""

import json
import os
import subprocess
import sys

import numpy as np
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


def test_build_ranked_then_serve_ranked_is_run_ranked():
    """``run --ranked`` is its two halves: ``build_ranked`` (host only) then
    ``serve_ranked`` -- the same index, queries and top-k."""
    args = serve.parse_args(RANKED + ["--device", "cpu"])
    whole = serve.run(args)
    built = serve.build_ranked(args)
    assert set(built) == {"index", "queries", "n_postings", "freqs_s", "build_s",
                          "bpi"}
    assert built["queries"] == whole["queries"]
    assert built["n_postings"] == whole["n_postings"] and built["bpi"] == whole["bpi"]
    for a, b in zip((whole["index"].payload, whole["index"].freq_payload),
                    (built["index"].payload, built["index"].freq_payload)):
        np.testing.assert_array_equal(a, b)
    served = serve.serve_ranked(args, built["index"], built["queries"])
    for (gd, gs), (wd, ws) in zip(served["results"], whole["results"]):
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gs, ws)


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


LOOP = RANKED + ["--loop", "--device", "cpu", "--batch", "8",
                 "--offered-qps", "300", "--duration", "0.5"]


def test_serve_ranked_loop_cpu_matches_direct_batches(capsys):
    """--ranked --loop serves Poisson arrivals through the continuous-
    batching server: its three report lines, and every served result equal
    to a direct topk_batch of the same query."""
    got = serve.run(serve.parse_args(LOOP))
    out = capsys.readouterr().out
    for line in ("[serve] loop: offered 300 q/s", "[serve] loop latency: p50",
                 "[serve] loop waves:"):
        assert line in out
    loop = got["loop"]
    assert "results" not in got and loop["served"] == len(loop["results"]) > 0
    assert loop["expired"] == loop["shed"] == loop["late"] == 0
    # arrivals run on an absolute Poisson schedule from default_rng(seed
    # + 1): their count is the schedule's, however late the driver ran
    rng, t, n = np.random.default_rng(2 + 1), 0.0, 0
    while t < 0.5:
        n += 1
        t += rng.exponential(1.0 / 300)
    assert loop["arrivals"] == n == loop["served"]
    assert loop["arrived_qps"] == n / 0.5
    assert loop["driver_lag_p99_ms"] >= 0
    assert loop["sustained_qps"] > 0 and loop["waves"] >= 1
    assert loop["p999_ms"] >= loop["p99_ms"] >= loop["p50_ms"] > 0
    queries = got["queries"]
    idx = sorted({i for i, _ in loop["results"]})
    want = dict(zip(idx, got["engine"].topk_batch([queries[i] for i in idx],
                                                  10)))
    for i, res in loop["results"]:
        assert not res.expired
        assert np.array_equal(res.docs, want[i][0])
        assert np.array_equal(res.scores, want[i][1])


def test_serve_loop_needs_ranked(capsys):
    with pytest.raises(SystemExit) as e:
        serve.parse_args(TINY + ["--loop", "--device", "cpu"])
    assert e.value.code == 2
    assert "--loop serves ranked top-k; add --ranked" in capsys.readouterr().err


@pytest.fixture
def obs_restored():
    from repro_torch import obs

    was = obs.enabled()
    obs.reset()
    yield obs
    obs.reset()
    obs.enable(was)


def test_serve_loop_metrics_dump(tmp_path, obs_restored, capsys):
    path = tmp_path / "snap.json"
    assert serve.main(LOOP + ["--metrics-dump", str(path)]) == 0
    snap = json.loads(path.read_text())
    h = snap["histograms"]["serve_request_ms"]
    served = snap["counters"]['serve_requests{kind="done"}']
    assert h["count"] == served > 0 and h["p99"] >= h["p50"] > 0
    assert snap["histograms"]['serve_wave_ms{engine="topk"}']["count"] >= 1
    assert "serve_queue_depth" in snap["gauges"]
    assert any(e["name"] == "seed" for e in snap["events"])
    assert f"metrics snapshot -> {path}" in capsys.readouterr().out


def test_serve_boolean_metrics_port_and_dump(tmp_path, obs_restored, capsys):
    """--metrics-port and --metrics-dump arm obs on the boolean path too."""
    path = tmp_path / "snap.json"
    assert serve.main(TINY + ["--device", "cpu", "--metrics-port", "0",
                              "--metrics-dump", str(path)]) == 0
    out = capsys.readouterr().out
    assert "[serve] metrics: http://127.0.0.1:" in out
    snap = json.loads(path.read_text())
    assert snap["histograms"]['serve_batch_ms{path="boolean_and"}']["count"] == 3


# ----------------------------------------------------------------------
# sharded and fault-injected serving
# ----------------------------------------------------------------------
@pytest.mark.parametrize("ranked", [False, True], ids=["boolean", "ranked"])
def test_serve_sharded_compare_scalar(ranked, capsys):
    """--shards 4 serves through the host shard loop on the CPU and
    --compare-scalar still holds every answer to the oracle (ranked: the
    kernel residency, whose pivot rounds route per shard)."""
    base = RANKED + ["--resident", "kernel"] if ranked else TINY
    got = serve.run(serve.parse_args(base + ["--device", "cpu", "--shards",
                                             "4", "--compare-scalar"]))
    out = capsys.readouterr().out
    assert "[serve] shards: 4 (host loop (too few devices for a mesh))" in out
    assert ("identical top-k" if ranked else "results identical") in out
    eng = got["engine"]
    assert eng.sharded is not None and eng.sharded.n_shards == 4
    assert got["faults"] is None and got["arena_device_bytes"] is None
    assert len(got["shard_device_bytes"]) == 4
    assert sum(got["shard_device_bytes"]) > 0


@pytest.mark.parametrize("ranked", [False, True], ids=["boolean", "ranked"])
def test_serve_replica_failover(ranked, capsys):
    base = RANKED + ["--resident", "kernel"] if ranked else TINY
    got = serve.run(serve.parse_args(
        base + ["--device", "cpu", "--shards", "4", "--replicas", "2",
                "--faults", "1"]))
    out = capsys.readouterr().out
    assert "[serve] faults: availability 1.0000" in out
    assert "failovers 1," in out
    assert "DEAD" in out.split("[serve] shard health:")[1].splitlines()[0]
    assert got["faults"]["failovers"] == 1
    assert got["faults"]["availability"] == 1.0


def test_serve_checkpoint_recovery(capsys):
    got = serve.run(serve.parse_args(
        TINY + ["--device", "cpu", "--shards", "4", "--faults", "1",
                "--recover"]))
    out = capsys.readouterr().out
    assert "recoveries 1 (p99 " in out and "(p99 n/a)" not in out
    assert "[serve] shard health: ['HEALTHY', 'HEALTHY', 'HEALTHY', " \
           "'HEALTHY']" in out
    assert "[serve] arena checkpoint: " in out
    f = got["faults"]
    assert f["recoveries"] == 1 and f["availability"] == 1.0
    assert f["checkpoint_bytes"] > 0 and len(f["restore_s"]) == 1
    # the checkpoint tempdir goes when serving ends
    assert not got["resilient"].manager.dir.exists()
    # recovered answers are the no-fault answers
    idx = got["index"]
    for q, r in zip(got["queries"], got["results"]):
        assert np.array_equal(r, idx.intersect_scalar(q)), q


@pytest.mark.parametrize("argv,msg", [
    (["--shards", "2", "--no-fused"], "--shards requires the fused engine"),
    (["--faults", "1"], "--faults/--fault-prob require --shards"),
    (["--ranked", "--loop", "--shards", "2", "--faults", "1"],
     "--loop and fault injection are separate lanes"),
], ids=["shards-no-fused", "faults-no-shards", "loop-faults"])
def test_serve_sharding_refusals(argv, msg, capsys):
    with pytest.raises(SystemExit) as e:
        serve.parse_args(TINY + ["--device", "cpu"] + argv)
    assert e.value.code == 2
    assert msg in capsys.readouterr().err
