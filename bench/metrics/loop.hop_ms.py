"""Time a wave spends between the serving loop and the ranked engine in
the window, ms per wave: the program's ``serve_wave_ms{engine="topk"}``
(the loop's timer around ``asyncio.to_thread(topk_batch)``) less its
``topk_batch`` spans (the call on the engine's thread), summed; the
thread hop there and back, and the event loop's turn to resume."""

from repro_torch import obs


def read(ctx):
    hists = obs.snapshot(events=False)["histograms"]
    wave = [h["sum"] for k, h in hists.items()
            if k.split("{")[0] == "serve_wave_ms" and 'engine="topk"' in k]
    call = [h["sum"] for k, h in hists.items()
            if k.split("{")[0] == "span_ms" and 'span="topk_batch"' in k]
    if not wave or not call or not ctx.window.units:
        return None
    return (sum(wave) - sum(call)) / ctx.window.units
