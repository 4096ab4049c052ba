"""Carry an index built by the JAX package over to the port.

For this system the index plays the role weights play for a model: it is
the state an engine serves.  ``index_arrays`` and ``index_from_arrays``
move it as a plain dict of numpy arrays (the ``PartitionedIndex`` fields
of ``repro.core.index``), so an index built once by either package is
served by the other without a rebuild.  The port's own build gives
byte-identical arrays for the same corpus, so both routes meet.

A model's parameters move the same way: ``recsys_params_to_arrays`` and
``recsys_params_from_arrays`` turn the port's recsys module into the
reference's tree of arrays and back, ``lm_params_to_arrays`` and
``lm_tree_from_arrays`` an LM's (``models.transformer``).
"""

from __future__ import annotations

import numpy as np
import torch

from .core.index import PartitionedIndex

ARRAY_FIELDS = (
    "list_part_offsets", "list_sizes", "endpoints", "sizes", "tags",
    "offsets", "payload", "freq_offsets", "freq_payload", "doc_lens",
)
SCALAR_FIELDS = ("n_lists", "F", "codecs")
DTYPES = {"tags": np.int8, "payload": np.uint8, "freq_payload": np.uint8}


def index_arrays(index) -> dict:
    """The serializable fields of a ``PartitionedIndex`` (either package)."""
    d = {k: np.asarray(getattr(index, k)) for k in ARRAY_FIELDS}
    d.update({k: getattr(index, k) for k in SCALAR_FIELDS})
    return d


def index_from_arrays(d: dict) -> PartitionedIndex:
    """A port ``PartitionedIndex`` from the reference's fields.

    ``d`` maps field names to numpy arrays (and ``n_lists`` / ``F`` /
    ``codecs`` to scalars); absent optional fields (the freq stream) take
    their defaults.  ``n_lists`` defaults to ``len(list_sizes)``.
    """
    kw = {}
    for k in ARRAY_FIELDS:
        if k in d:
            kw[k] = np.asarray(d[k], dtype=DTYPES.get(k, np.int64)).copy()
    missing = {"endpoints", "sizes", "tags", "offsets", "payload",
               "list_part_offsets", "list_sizes"} - set(kw)
    if missing:
        raise ValueError(f"index arrays missing: {sorted(missing)}")
    kw["n_lists"] = int(d.get("n_lists", len(kw["list_sizes"])))
    kw["F"] = int(d.get("F", 64))
    kw["codecs"] = str(d.get("codecs", "svb"))
    return PartitionedIndex(**kw)


def recsys_tree_from_arrays(tree: dict, cfg, device="cuda") -> dict:
    """The reference's parameter tree (``repro.models.recsys.init_params``
    as numpy arrays) as the same tree of f32 tensors on ``device``, checked
    leaf for leaf against ``cfg``'s shapes.  Lists of layers (``cross``,
    ``mlp``, ``attn``, ``bot``, ``top``) and BST's ``blocks`` (six leaves
    a block) keep their structure; each leaf is a copy."""
    from .api import resolve_device
    from .models.recsys import Recsys, param_shapes

    dev = resolve_device(device)

    def leaf(x):
        return torch.tensor(np.asarray(x), dtype=torch.float32, device=dev)

    params = {k: ([{n: leaf(v) for n, v in layer.items()} for layer in x]
                  if isinstance(x, (list, tuple)) else leaf(x))
              for k, x in tree.items()}
    got = {k: tuple(p.shape) for k, p in Recsys(cfg, params).named_parameters()}
    want = param_shapes(cfg)
    if got != want:
        raise ValueError(f"parameter tree does not fit {cfg.name}: "
                         f"{sorted(set(got.items()) ^ set(want.items()))}")
    return params


def recsys_params_from_arrays(tree: dict, cfg, device="cuda"):
    """The port's ``Recsys`` module from the reference's parameter tree
    (see ``recsys_tree_from_arrays``) on ``device``."""
    from .models.recsys import Recsys

    return Recsys(cfg, recsys_tree_from_arrays(tree, cfg, device))


def recsys_params_to_arrays(model) -> dict:
    """The reference's parameter tree (nested dicts and lists of numpy f32
    arrays) from the port's ``Recsys`` module, of any of the four kinds
    (``blocks.0.wqkv`` becomes ``tree["blocks"][0]["wqkv"]``)."""
    tree: dict = {}
    for name, p in model.named_parameters():
        x = p.detach().cpu().numpy()
        parts = name.split(".")
        if len(parts) == 1:
            tree[name] = x
        else:
            key, i, leaf = parts
            layers = tree.setdefault(key, [])
            while len(layers) <= int(i):
                layers.append({})
            layers[int(i)][leaf] = x
    return tree


def lm_tree_from_arrays(tree: dict, cfg, device="cuda") -> dict:
    """The reference's LM parameter tree (``repro.models.transformer.
    init_params`` as numpy arrays: ``embed``, ``final_ln``, ``lm_head`` and
    the stacked ``layers`` dict) as the same tree of ``cfg.param_dtype``
    tensors on ``device``, checked leaf for leaf against ``cfg``'s shapes;
    ``Transformer(cfg, tree)`` holds it.  Each leaf is a copy."""
    from .api import resolve_device
    from .models.transformer import Transformer, param_shapes

    dev = resolve_device(device)

    def leaf(x):
        return torch.tensor(np.asarray(x, dtype=np.float32),
                            device=dev).to(cfg.param_dtype)

    params = {k: ({n: leaf(v) for n, v in x.items()} if k == "layers" else leaf(x))
              for k, x in tree.items()}
    got = {k: tuple(p.shape)
           for k, p in Transformer(cfg, params).named_parameters()}
    want = param_shapes(cfg)
    if got != want:
        raise ValueError(f"parameter tree does not fit {cfg.name}: "
                         f"{sorted(set(got.items()) ^ set(want.items()))}")
    return params


def lm_params_to_arrays(model) -> dict:
    """The reference's LM parameter tree (numpy arrays) from the port's
    ``Transformer`` (``layers.wq`` becomes ``tree["layers"]["wq"]``)."""
    tree: dict = {}
    for name, p in model.named_parameters():
        x = p.detach().cpu().numpy()
        key, _, leaf = name.partition(".")
        if leaf:
            tree.setdefault(key, {})[leaf] = x
        else:
            tree[key] = x
    return tree
