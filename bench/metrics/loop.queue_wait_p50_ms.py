"""Median queue wait of the window's requests at the serving loop
(``ServeResult.wait_s``: admission to wave formation), ms."""

import numpy as np


def read(ctx):
    w = ctx.window.wait_s
    return float(np.median(w)) * 1e3 if w else None
