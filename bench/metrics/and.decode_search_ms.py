"""Self time of the program's ``decode_search`` spans in the window, ms per
engine call (a boolean batch): the span's time less its child spans'
(``codec_split``, ``dispatch_stage``), so the locate and search launches,
each bucket's fetch and the scatter into batch order."""


def read(ctx):
    s = ctx.trace.self_s("decode_search") if ctx.trace else None
    if s is None or not ctx.window.units:
        return None
    return s * 1e3 / ctx.window.units
