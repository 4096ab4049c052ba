"""Self time of the program's ``dispatch_stage`` spans in the window, ms per
engine call (a boolean batch): staging each codec bucket's cursors and
uploading them."""


def read(ctx):
    s = ctx.trace.self_s("dispatch_stage") if ctx.trace else None
    if s is None or not ctx.window.units:
        return None
    return s * 1e3 / ctx.window.units
