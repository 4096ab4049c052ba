"""Membership cursors the boolean engine's AND filter sent a query in the
window, before grouping: the program's ``engine_member_cursors`` counter
over the window's queries."""

from repro_torch import obs


def read(ctx):
    n = [v for k, v in obs.snapshot(events=False)["counters"].items()
         if k.split("{")[0] == "engine_member_cursors"]
    if not n or not ctx.window.answers:
        return None
    return sum(n) / len(ctx.window.answers)
