"""Self time of the program's ``codec_split`` spans in the window, ms per
engine call (a boolean batch): the span's time less its child spans'."""


def read(ctx):
    s = ctx.trace.self_s("codec_split") if ctx.trace else None
    if s is None or not ctx.window.units:
        return None
    return s * 1e3 / ctx.window.units
