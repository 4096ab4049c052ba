"""The spans and counters inside the port's two engines, on the CPU.

One armed ``topk_batch`` (torch backend, ``resident="kernel"``) records
the wave's ``topk_batch`` span and, under the phases, the pivot's
``pivot_emit``, ``pivot_round``, ``lane_filter`` and ``candidate_union``
and the rescore's ``rescore_member``: each inside its parent, on its
thread, one level down, the children of one parent apart.  One armed
``intersect_batch`` records ``group_cursors`` under ``member_filter`` and,
``decode_search`` its ``dispatch_stage`` for each codec bucket and, on a
multi-codec arena, ``codec_split``.  The counters ``ranked_fetches`` and
``engine_member_cursors`` count what they name.  Then the port's own
catalogue (``repro_torch/obs/catalogue.md``) against every name the port
registers, and the benchmark harness's clock: a program span lands on the
profiler's timeline between its event less the anchor's opening and its
event plus its own opening, at the start of a window and 2 s into it.
"""

import json
import os
import subprocess
import sys

import pytest

from repro_torch import obs
from repro_torch.core.engine_core import EngineCore
from repro_torch.core.query_engine import QueryEngine
from repro_torch.ranked.topk_engine import TopKEngine

from test_torch_obs import obs_state, ranked_index  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [p for p in (ROOT, os.path.join(ROOT, "tools"))
                if p not in sys.path]

import check_docs  # noqa: E402

# 1 ns of slack on the span bounds (seconds and milliseconds round apart)
EPS_S = 1e-9


def _spans():
    return [e for e in obs.events() if e["kind"] == "span"]


def _end(s):
    return s["start_s"] + s["dur_ms"] / 1e3


def _one(spans, name):
    mine = [s for s in spans if s["name"] == name]
    assert len(mine) == 1, (name, len(mine))
    return mine[0]


def _hold_children(spans, parent, names):
    """``parent`` once, and under it exactly the spans ``names`` (a name
    may repeat): its thread, one level down, within its bounds; in time
    order, none overlapping the next."""
    p = _one(spans, parent)
    kids = sorted((s for s in spans
                   if s["thread"] == p["thread"]
                   and s["depth"] == p["depth"] + 1
                   and s["start_s"] >= p["start_s"] - EPS_S
                   and _end(s) <= _end(p) + EPS_S),
                  key=lambda s: s["start_s"])
    assert sorted(c["name"] for c in kids) == sorted(names), parent
    for a, b in zip(kids, kids[1:]):
        assert _end(a) <= b["start_s"] + EPS_S, (a["name"], b["name"])


def _counter(name):
    return obs.snapshot(events=False)["counters"].get(name, 0)


def test_a_ranked_wave_records_its_phases_and_fetches(ranked_index,
                                                      monkeypatch):
    idx, queries = ranked_index
    eng = TopKEngine(idx, backend="torch", resident="kernel", device="cpu",
                     seed_blocks=2)
    obs.enable(False)
    eng.topk_batch(queries, 10)  # the flat mirror, built outside the count
    fetches = []
    real = TopKEngine._fetch

    def counted(self, *arrays):
        fetches.append(len(arrays))
        return real(self, *arrays)

    monkeypatch.setattr(TopKEngine, "_fetch", counted)
    obs.enable(True)
    obs.reset()
    eng.topk_batch(queries, 10)
    spans = _spans()
    _hold_children(spans, "topk_batch", ["seed", "pivot", "rescore"])
    assert _one(spans, "topk_batch")["path"] == "ranked"
    _hold_children(spans, "pivot", ["pivot_emit", "pivot_round",
                                    "lane_filter", "candidate_union"])
    _hold_children(spans, "rescore", ["rescore_member"])
    assert fetches and _counter("ranked_fetches") == len(fetches)


@pytest.mark.parametrize("codec_policy", ["svb", "ef"])
def test_an_and_batch_records_its_grouping_and_codec_split(
        ranked_index, monkeypatch, codec_policy):
    idx, queries = ranked_index
    eng = QueryEngine(idx, device="cpu", codec_policy=codec_policy)
    sent, buckets = [], []
    real_in, real_dispatch = QueryEngine._member_in, EngineCore._dispatch

    def counted(self, terms, probes):
        sent.append(len(terms))
        return real_in(self, terms, probes)

    def dispatched(self, ef, terms, probes):
        buckets.append(len(terms))
        return real_dispatch(self, ef, terms, probes)

    monkeypatch.setattr(QueryEngine, "_member_in", counted)
    monkeypatch.setattr(EngineCore, "_dispatch", dispatched)
    eng.intersect_batch(queries)
    spans = _spans()
    _hold_children(spans, "member_filter", ["group_cursors", "decode_search"])
    assert _one(spans, "group_cursors")["path"] == "member"
    multi = eng.arena.block_codec is not None
    assert multi == (codec_policy == "ef")
    staged = ["dispatch_stage"] * sum(1 for n in buckets if n)
    assert staged
    _hold_children(spans, "decode_search",
                   (["codec_split"] if multi else []) + staged)
    assert sum(sent) > 0 and _counter("engine_member_cursors") == sum(sent)


def test_every_name_the_port_registers_is_in_the_catalogue(monkeypatch):
    """``tools/check_docs.py``'s scan of literal ``obs.<fn>("name")``
    calls: every name registered under ``src/repro_torch`` and not under
    the reference's ``src/repro`` is in the port's catalogue, and the
    catalogue lists no other."""
    ref = set().union(*check_docs.all_metrics().values())
    monkeypatch.setattr(check_docs, "METRIC_ROOT", "src/repro_torch")
    port = set().union(*check_docs.all_metrics().values())
    own = port - ref
    assert {"topk_batch", "pivot_emit", "pivot_round", "lane_filter",
            "candidate_union", "rescore_member", "group_cursors",
            "codec_split", "dispatch_stage", "ranked_fetches",
            "engine_member_cursors"} <= own
    md = (check_docs.ROOT / "src" / "repro_torch" / "obs"
          / "catalogue.md").read_text()
    listed = {line.split("`")[1] for line in md.splitlines()
              if line.startswith("| `")}
    assert listed == own


# Run in a fresh process, as the harness's traced run is: the window's
# anchor is then the process's first ``record_function``.  Each
# ``record_function`` is wrapped to read ``perf_counter`` just before it
# opens, which bounds when its event started on the program's clock.
CLOCK_PROBE = """
import json, time
import torch, torch.profiler
from repro_torch import obs
from repro_torch.obs import trace as obs_trace
from bench.harness import trace

opened = {}

class stamped(torch.profiler.record_function):
    def __enter__(self):
        opened[self.name] = time.perf_counter()
        return super().__enter__()

torch.profiler.record_function = stamped
trace.DEVICE_CATS += ("user_annotation",)

def pair(name):
    with torch.profiler.record_function(name):
        with obs.span(name):
            torch.ones(8).sum()

with trace.traced(torch.device("cpu")) as box:
    pair("clock_first")
    time.sleep(2.0)
    pair("clock_later")
tr = box["trace"]
ring = {r["name"]: r for r in obs.events() if r.get("kind") == "span"}
out = {"window_s": tr.window_s}
for name in (trace.WINDOW_MARK, "clock_first", "clock_later"):
    t0 = ring[name]["start_s"] + obs_trace._EPOCH
    out[name] = {"open_us": (t0 - opened[name]) * 1e6,
                 "prof_us": [ts for n, ts, _ in tr.events if n == name],
                 "mine_us": [s["ts_us"] for s in tr.spans or ()
                             if s["name"] == name]}
print(json.dumps(out))
"""

# the profiler's microsecond stamps against perf_counter's
CLOCK_SLACK_US = 50.0


def test_program_spans_map_onto_the_profilers_clock():
    """The harness puts the program's spans on the profiler's clock through
    one anchor span opened inside the window's ``record_function``.  The
    anchor starts late by the time that annotation takes to open (a
    process's first: about 1 ms on a CPU), so every span maps early by
    that much: a span opened just inside a ``record_function`` of its name
    lands no earlier than its event less the anchor's opening and no later
    than its event plus its own opening.  The same holds 2 s on, and the
    two offsets differ by no more than the two pairs' openings allow, so
    the single anchor does not drift across the window."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT] + [env["PYTHONPATH"]]
        * bool(env.get("PYTHONPATH")))
    run = subprocess.run([sys.executable, "-c", CLOCK_PROBE], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    assert got["window_s"] >= 2.0
    anchor = got["bench_window"]["open_us"]
    offs = []
    for name in ("clock_first", "clock_later"):
        rec = got[name]
        assert len(rec["prof_us"]) == 1 and len(rec["mine_us"]) == 1, name
        d = rec["mine_us"][0] - rec["prof_us"][0]
        assert -anchor - CLOCK_SLACK_US <= d \
            <= rec["open_us"] + CLOCK_SLACK_US, (name, d, got)
        offs.append(d)
    assert -got["clock_first"]["open_us"] - CLOCK_SLACK_US \
        <= offs[1] - offs[0] \
        <= got["clock_later"]["open_us"] + CLOCK_SLACK_US, (offs, got)
