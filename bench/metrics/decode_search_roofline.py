"""``decode_search``'s share of its roofline in the window: the bytes its
launches' answers need (``_bounds.decode_search_bytes``) at the card's
memory rate, over the profiler's device time of ``decode_search_kernel``,
%."""

from bench.metrics._bounds import decode_search_bytes, roofline_pct

# the wrapper, where the boolean engine and the shard dispatch call it
PROBES = {"decode_search": ["repro_torch.core.engine_core",
                            "repro_torch.core.shard"]}


def read(ctx):
    calls = ctx.probes.get("decode_search", [])
    if ctx.trace is None or not calls:
        return None
    nbytes = sum(decode_search_bytes(a, k) for a, k in calls)
    return roofline_pct(nbytes, ctx.trace.kernel_s("decode_search_kernel"),
                        ctx.hbm_bytes_per_s)
