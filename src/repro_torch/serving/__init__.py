"""repro_torch.serving -- continuous-batching async serving loop.

Counterpart of ``repro.serving``.  The batch engines (``QueryEngine`` /
``TopKEngine``) are throughput machines: one call, one batch, one set of
fused dispatches.  This package turns them into a SERVICE: requests
arrive one at a time on an asyncio loop, a deadline-aware
:class:`BatchFormer` coalesces them into waves (pow2-bucketed so the
engine sees a handful of batch shapes), and :class:`AsyncTopKServer` runs
the waves back to back -- continuous batching: admission never waits for
the previous wave to drain, and a wave forms from whatever is queued the
moment the engine is free.

Quick tour::

    from repro_torch.serving import AsyncTopKServer

    server = AsyncTopKServer(engine, k=10, max_batch=64)
    async with server:
        res = await server.submit([3, 17])   # ServeResult
        print(res.docs, res.scores, res.wait_s)

Operator knobs and metric names: the reference's docs/serving.md and
docs/metrics.md, which the port follows flag for flag and name for name.
"""

from .batcher import BatchFormer, Request
from .loop import AsyncTopKServer, QueueFull, ServeResult

__all__ = [
    "AsyncTopKServer",
    "BatchFormer",
    "QueueFull",
    "Request",
    "ServeResult",
]
