"""95th percentile of the window's request latencies through the serving
loop, submission to answer as the client sees it, ms.  A closed loop that
keeps every wave full runs at capacity, where a tail swings with the
smallest change: it is read here, beside the cell's throughput, and not
held to a bound."""

import numpy as np


def read(ctx):
    w = ctx.window.latency_s
    return float(np.percentile(w, 95)) * 1e3 if w else None
