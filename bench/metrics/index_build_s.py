"""Seconds of the index build in set-up: ``build_partitioned_index``, the
arena's transcode and, unsharded, the arena's upload to the card (the
harness's clock, synchronised)."""


def read(ctx):
    return ctx.facts.get("index_build_s")
