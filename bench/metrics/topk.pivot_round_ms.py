"""Self time of the program's ``pivot_round`` spans in the window, ms per
engine call (a ranked engine wave): the span's time less its child spans'."""


def read(ctx):
    s = ctx.trace.self_s("pivot_round") if ctx.trace else None
    if s is None or not ctx.window.units:
        return None
    return s * 1e3 / ctx.window.units
