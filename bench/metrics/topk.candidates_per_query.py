"""Candidate docIDs the ranked engine rescored a query in the window: the
program's ``ranked_candidates`` counter over the queries the window's
waves served."""

from repro_torch import obs


def read(ctx):
    n = [v for k, v in obs.snapshot(events=False)["counters"].items()
         if k.split("{")[0] == "ranked_candidates"]
    if not n or not ctx.window.answers:
        return None
    return sum(n) / len(ctx.window.answers)
