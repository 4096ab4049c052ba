"""Shared model utilities: norms, initialisers, parameter-tree helpers.

Counterpart of ``repro/models/common.py``.  JAX's keys become explicit
``torch.Generator``s: the same seed gives other numbers than JAX's, so the
tests carry parameters across instead of drawing them twice.
"""

from __future__ import annotations

import math

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def dense_init(gen: torch.Generator, shape, scale: float | None = None,
               dtype=torch.float32) -> torch.Tensor:
    """Truncated-normal fan-in init: a standard normal cut to [-2, 2], times
    ``scale`` or 1/sqrt(fan_in), drawn on the generator's device."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(std).to(dtype)


def split_keys(gen: torch.Generator, names) -> dict[str, torch.Generator]:
    """One generator per name, on ``gen``'s device, each seeded by a draw
    from ``gen``."""
    seeds = torch.randint(0, 2**62, (len(names),), generator=gen,
                          device=gen.device).tolist()
    out = {}
    for name, s in zip(names, seeds):
        g = torch.Generator(device=gen.device)
        g.manual_seed(s)
        out[name] = g
    return out


def _leaves(tree):
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def tree_size(tree) -> int:
    """Elements in a module's parameters or a nest of tensors."""
    return sum(x.numel() for x in _leaves(tree))


def tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in _leaves(tree))


def cast_tree(tree, dtype):
    """The tree (nested dicts, lists and tuples of tensors) with every
    floating leaf cast to ``dtype``; other leaves as they are."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_tree(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def _key_path(name: str):
    return tuple(int(p) if p.isdigit() else p for p in name.split("."))


def unflatten(flat: dict) -> dict:
    """Dotted names -> the reference's nest of dicts and lists (a numeric
    part is a list index)."""
    tree: dict = {}
    for name, v in flat.items():
        *head, last = _key_path(name)
        node = tree
        for k, nxt in zip(head, [*head[1:], last]):
            if isinstance(node, list):
                while len(node) <= k:
                    node.append(None)
                if node[k] is None:
                    node[k] = [] if isinstance(nxt, int) else {}
                node = node[k]
            else:
                node = node.setdefault(k, [] if isinstance(nxt, int) else {})
        if isinstance(node, list):
            while len(node) <= last:
                node.append(None)
        node[last] = v
    return tree


def flatten(tree, prefix: str = "") -> dict:
    """The inverse of ``unflatten``: the leaves by dotted name."""
    if isinstance(tree, dict):
        items = tree.items()
    elif type(tree) in (list, tuple):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def tree_map(fn, tree):
    """``fn`` over every leaf of a nest of dicts, lists and tuples (a
    tuple's subclass, such as a ``PartitionSpec``, is a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if type(tree) in (list, tuple):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def meta(shape, dtype=torch.float32) -> torch.Tensor:
    """A tensor on the ``meta`` device: a shape and a dtype, no storage
    (jax's ``ShapeDtypeStruct``)."""
    return torch.empty(shape, dtype=dtype, device="meta")


def meta_tree(shapes: dict, dtype=torch.float32) -> dict:
    """Dotted names and shapes -> the nested tree of ``meta`` tensors
    (jax's ``eval_shape``)."""
    return unflatten({k: meta(s, dtype) for k, s in shapes.items()})


def param_dict(module: torch.nn.Module) -> dict[str, torch.Tensor]:
    """A module's parameters by dotted name, in the order
    ``jax.tree_util.tree_leaves`` gives the reference's tree (dict keys
    sorted, list items in order), so sums over the leaves run alike."""
    named = dict(module.named_parameters())
    return {k: named[k] for k in sorted(named, key=_key_path)}
