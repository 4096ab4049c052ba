"""Device-to-host syncs of the ranked engine a wave in the window: the
program's ``ranked_fetches`` counter (one a ``TopKEngine._fetch`` call)
over its ``ranked_batches`` (one a ``topk_batch`` call)."""

from repro_torch import obs


def read(ctx):
    counters = obs.snapshot(events=False)["counters"]

    def total(name):
        return sum(v for k, v in counters.items() if k.split("{")[0] == name)

    fetches, waves = total("ranked_fetches"), total("ranked_batches")
    if not fetches or not waves:
        return None
    return fetches / waves
