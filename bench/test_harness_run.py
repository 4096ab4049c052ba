"""Whole runs of the harness at a small size on the CPU (the look for a
card skipped): the result line's keys, and ``correct`` coming out false
when the timed path is broken underneath, with an answer altered where it
is produced.  The card test runs a cell through ``bench/run.py``."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from bench.conftest import ROOT, make_tiny_root
from bench.harness import cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("bench"))


def _run(root, name, trace=False, seed=2**31 + 17):
    with open(os.devnull, "w") as log:
        return cell.run_cell(name, seed, 0.3, trace, 0.0, root=root,
                             device="cpu", log=log)


@pytest.mark.parametrize("name, trace", [
    ("gov2.and-b64", False), ("gov2.topk10-c64", False),
    ("gov2.topk10-c64", True), ("gov2.and-b64", True),
])
def test_the_result_line_has_the_contracts_keys(root, name, trace):
    out = _run(root, name, trace)
    line = json.loads(json.dumps(out))
    keys = list(line)
    assert keys[:5] == KEYS and keys[-1] == "checks"
    assert set(keys) <= set(KEYS) | {"breakdown", "checks"}
    assert ("breakdown" in keys) == trace
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    if not trace:
        assert {"setup_s", "qps"} <= set(line["metrics"])
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


def _alter_and(monkeypatch):
    from repro_torch.core.query_engine import QueryEngine

    real = QueryEngine.intersect_batch

    def broken(self, queries):
        out = real(self, queries)
        out[0] = np.append(out[0], 10**9)  # one docID too many
        return out

    monkeypatch.setattr(QueryEngine, "intersect_batch", broken)


def _alter_topk(monkeypatch):
    from repro_torch.ranked.topk_engine import TopKEngine

    real = TopKEngine.topk_batch

    def broken(self, queries, k):
        out = real(self, queries, k)
        docs, scores = out[0]
        out[0] = (docs, np.nextafter(scores, np.inf))  # one ulp high
        return out

    monkeypatch.setattr(TopKEngine, "topk_batch", broken)


@pytest.mark.parametrize("name, alter", [
    ("gov2.and-b64", _alter_and), ("gov2.topk10-c64", _alter_topk),
])
def test_an_answer_altered_where_it_is_produced_is_not_correct(
        root, monkeypatch, name, alter):
    alter(monkeypatch)
    out = _run(root, name)
    assert out["correct"] is False
    assert out["checks"]["wrong_answers"]["value"] > 0
    assert out["failed"] == out["checks"]["wrong_answers"]["value"]


def test_a_request_that_never_comes_is_not_correct(root, monkeypatch):
    from bench.harness import drivers

    real = drivers.batches

    def lossy(call, pool, batch, seconds):
        w = real(call, pool, batch, seconds)
        w.qidx.pop(), w.answers.pop()
        return w

    monkeypatch.setattr(drivers, "batches", lossy)
    out = _run(root, "gov2.and-b64")
    assert out["correct"] is False
    assert out["checks"]["unanswered"]["value"] == 1


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "gov2.and-b64",
         "--seed", str(2**31 + 99), "--seconds", "5", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.splitlines()[-1])
    assert line["correct"] is True and list(line)[:5] == KEYS


OPEN_LOOP = """
import asyncio, time
import numpy as np
from bench.harness import drivers


def serve(engine, mix, pool, warm, seconds, seed, around):
    w = drivers.Window()
    rng = np.random.default_rng([int(seed), 2])

    async def run():
        async with drivers.make_server(engine, mix) as server:
            await asyncio.gather(*(server.submit(q) for q in warm))
            tasks = []

            async def client(j, due):
                r = await server.submit(pool[j % len(pool)])
                w.qidx.append(j % len(pool))
                w.answers.append((r.docs, r.scores))
                w.latency_s.append(time.perf_counter() - due)
                w.wait_s.append(r.wait_s)

            with around():
                w.t0 = t = time.perf_counter()
                while t < w.t0 + seconds:
                    await asyncio.sleep(max(0.0, t - time.perf_counter()))
                    tasks.append(asyncio.ensure_future(client(len(tasks), t)))
                    t += rng.exponential(1.0 / mix["rate"])
                w.attempted = len(tasks)
                await asyncio.gather(*tasks)
                w.t1 = time.perf_counter()
            w.units = len(tasks)

    asyncio.run(run())
    return w
"""


def test_an_open_loop_mix_runs_as_data_alone(root, tmp_path):
    """A mix of Poisson arrivals through the serving loop, added as files
    alone (its data and ``bench/traffic/<mix>.py`` with its driver): every
    arrival answered and checked, no file of the harness edited."""
    import shutil

    from bench.harness import spec

    mine = os.path.join(tmp_path, "open")
    shutil.copytree(root, mine)
    mix = dict(spec.traffic("topk10-c64", mine), mode="open_loop", rate=200.0)
    with open(os.path.join(mine, "bench", "traffic", "topk10-p200.json"),
              "w") as fh:
        json.dump(mix, fh)
    with open(os.path.join(mine, "bench", "traffic", "topk10-p200.py"),
              "w") as fh:
        fh.write(OPEN_LOOP)
    bm = spec.load(mine)
    bm["workloads"].append({"name": "gov2.topk10-p200", "config": "gov2",
                            "traffic": "topk10-p200", "chips": 1,
                            "why": "open loop"})
    with open(os.path.join(mine, "BENCHMARK.json"), "w") as fh:
        json.dump(bm, fh)
    out = _run(mine, "gov2.topk10-p200")
    assert out["correct"] is True
    assert out["attempted"] > 10
    assert out["metrics"]["qps"]["value"] > 0


def test_a_mix_brings_its_own_pool_as_a_file(root, tmp_path, monkeypatch):
    """``pool(seed, cfg, mix)`` in ``bench/traffic/<mix>.py`` replaces the
    uniform draw: here every query asks for lists 0 and 1."""
    import shutil

    from bench.harness import spec

    mine = os.path.join(tmp_path, "pool")
    shutil.copytree(root, mine)
    with open(os.path.join(mine, "bench", "traffic", "and-hot.json"),
              "w") as fh:
        json.dump(spec.traffic("and-b64", mine), fh)
    with open(os.path.join(mine, "bench", "traffic", "and-hot.py"),
              "w") as fh:
        fh.write("def pool(seed, cfg, mix):\n"
                 "    return [[0, 1]] * mix['pool']\n")
    bm = spec.load(mine)
    bm["workloads"].append({"name": "gov2.and-hot", "config": "gov2",
                            "traffic": "and-hot", "chips": 1,
                            "why": "one hot pair"})
    with open(os.path.join(mine, "BENCHMARK.json"), "w") as fh:
        json.dump(bm, fh)
    seen = []
    from repro_torch.core.query_engine import QueryEngine

    real = QueryEngine.intersect_batch

    def spy(self, queries):
        seen.extend(tuple(q) for q in queries)
        return real(self, queries)

    monkeypatch.setattr(QueryEngine, "intersect_batch", spy)
    out = _run(mine, "gov2.and-hot")
    assert out["correct"] is True
    assert out["attempted"] > 0 and seen.count((0, 1)) >= out["attempted"]
