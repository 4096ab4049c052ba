"""``bm25_score_rows``'s share of its roofline in the window: the bytes
its launches' answers need (``_bounds.score_rows_bytes``) at the card's
memory rate, over the profiler's device time of ``score_rows_kernel``, %."""

from bench.metrics._bounds import roofline_pct, score_rows_bytes

# the wrapper, where the ranked engine calls it
PROBES = {"bm25_score_rows": ["repro_torch.ranked.topk_engine"]}


def read(ctx):
    calls = ctx.probes.get("bm25_score_rows", [])
    if ctx.trace is None or not calls:
        return None
    nbytes = sum(score_rows_bytes(a, k) for a, k in calls)
    return roofline_pct(nbytes, ctx.trace.kernel_s("score_rows_kernel"),
                        ctx.hbm_bytes_per_s)
