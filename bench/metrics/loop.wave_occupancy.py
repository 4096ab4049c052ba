"""Share of wave slots the window's waves filled: requests served over
waves times ``max_batch`` (``AsyncTopKServer`` and ``BatchFormer``
counters), %."""


def read(ctx):
    st = ctx.window.server_stats
    if not st or not st["waves"]:
        return None
    return 100.0 * st["served"] / (st["waves"] * st["max_batch"])
