"""Ranked retrieval: Block-Max BM25 top-k over the freq-carrying arena.

Counterpart of ``repro/ranked``.  ``bm25`` holds the float32 scoring
contract (idf, quantized length norms, per-posting contributions) shared by
every backend and by the exhaustive oracle; ``topk_engine`` drives
Block-Max MaxScore/WAND top-k over the block arena, resident on the card.
"""

from .bm25 import BM25Params, exhaustive_topk  # noqa: F401


def __getattr__(name):  # lazy: bm25 must stay importable from core.arena
    if name == "TopKEngine":
        from .topk_engine import TopKEngine

        return TopKEngine
    raise AttributeError(name)
