"""Architecture registry of the port: the recsys archs ported so far.

Counterpart of ``repro/configs/__init__.py``.  Each arch module defines an
``ArchBundle`` with the full config of the reference, its reduced smoke
config and its shape set; ``get_arch(id)`` and ``all_arch_ids()`` load
only the archs the port runs (dcn-v2, dlrm-rm2).
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode | fullbatch | sampled | molecule | serve | retrieval
    seq_len: int = 0
    batch: int = 0
    n_nodes: int = 0
    n_edges: int = 0
    d_feat: int = 0
    n_graphs: int = 0
    n_candidates: int = 0
    skip: str = ""  # non-empty => cell is skipped, with this reason


@dataclasses.dataclass(frozen=True)
class ArchBundle:
    arch_id: str
    family: str  # lm | gnn | recsys
    full: Any
    smoke: Any
    shapes: tuple[ShapeSpec, ...]
    notes: str = ""


_REGISTRY: dict[str, ArchBundle] = {}


def register(bundle: ArchBundle) -> ArchBundle:
    _REGISTRY[bundle.arch_id] = bundle
    return bundle


def get_arch(arch_id: str) -> ArchBundle:
    _load_all()
    return _REGISTRY[arch_id]


def all_arch_ids() -> list[str]:
    _load_all()
    return sorted(_REGISTRY)


_LOADED = False


def _load_all() -> None:
    global _LOADED
    if _LOADED:
        return
    from . import dcn_v2, dlrm_rm2  # noqa: F401
    _LOADED = True


RECSYS_SHAPES = (
    ShapeSpec("train_batch", "train", batch=65_536),
    ShapeSpec("serve_p99", "serve", batch=512),
    ShapeSpec("serve_bulk", "serve", batch=262_144),
    ShapeSpec("retrieval_cand", "retrieval", batch=1, n_candidates=1_000_000),
)
