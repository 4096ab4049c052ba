"""Error-feedback int8 gradient compression for the data-parallel all-reduce.

Counterpart of ``repro/optim/compress.py``.  The data-axis gradient
all-reduce runs on int8-quantized tensors (4x fewer wire bytes than f32,
carried as int32 on the wire as in the reference) with per-tensor scales;
the quantization error is carried to the next step (error feedback, Seide
et al. / EF-SGD), preserving convergence.  The collectives are explicit
(``launch.mesh.psum`` over the mesh's data group), so the wire format is
the code's, not a library's.

Usage:
    state = ef_init(grads)
    grads_sync, state = compressed_psum(grads_local, state, mesh, ("data",))
"""

from __future__ import annotations

import torch

from ..launch.mesh import P, axis_size, psum, shard_map
from ..models.common import tree_map


def _map2(fn, a, b):
    """``fn(a_leaf, b_leaf) -> (x, y)`` over two trees of one structure ->
    (the tree of x, the tree of y)."""
    if isinstance(a, dict):
        pairs = {k: _map2(fn, v, b[k]) for k, v in a.items()}
        return ({k: p[0] for k, p in pairs.items()},
                {k: p[1] for k, p in pairs.items()})
    if type(a) in (list, tuple):
        pairs = [_map2(fn, x, y) for x, y in zip(a, b)]
        return type(a)(p[0] for p in pairs), type(a)(p[1] for p in pairs)
    return fn(a, b)


def ef_init(params):
    """Zero residuals, f32, in the tree's structure."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _quantize(x):
    scale = torch.clamp_min(x.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_psum(grads, ef_state, mesh, axes=("data",)):
    """All-reduce ``grads`` over ``axes`` in int8 with error feedback.

    Each rank passes its LOCAL gradient contribution (a tree of f32
    tensors) and its residuals; every rank gets the averaged gradient,
    ``qsum * (ssum / n) / n``, and its new residuals ``x - q * scale``,
    in the reference's order of operations.
    """
    n = 1
    for a in axes:
        n *= axis_size(mesh, a)

    def body(g, e):
        def one(gl, el):
            x = gl + el
            q, scale = _quantize(x)
            err = x - q.to(torch.float32) * scale
            qsum = psum(q.to(torch.int32), axes)
            ssum = psum(scale, axes)  # scalar; scales averaged
            g_sync = qsum.to(torch.float32) * (ssum / n) / n
            return g_sync, err

        return _map2(one, g, e)

    with torch.no_grad():
        return shard_map(body, mesh, (P(), P()), (P(), P()))(grads, ef_state)
