"""Architecture registry of the port: the archs ported so far.

Counterpart of ``repro/configs/__init__.py``.  Each arch module defines an
``ArchBundle`` with the full config of the reference, its reduced smoke
config and its shape set; ``get_arch(id)`` and ``all_arch_ids()`` load
every arch of the reference: the four recsys archs (bst, dcn-v2, din,
dlrm-rm2), the five LM archs (command-r-35b, mixtral-8x22b,
moonshot-v1-16b-a3b, qwen1.5-0.5b, qwen3-0.6b) and the GNN arch (gin-tu).
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
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def all_arch_ids() -> list[str]:
    _load_all()
    return sorted(_REGISTRY)


_LOADED = False


def _load_all() -> None:
    global _LOADED
    if _LOADED:
        return
    from . import (  # noqa: F401
        bst,
        command_r_35b,
        dcn_v2,
        din,
        dlrm_rm2,
        gin_tu,
        mixtral_8x22b,
        moonshot_v1_16b_a3b,
        qwen1_5_0_5b,
        qwen3_0_6b,
    )
    _LOADED = True


# Shared LM shape set (seq_len x global_batch per the assignment).
def lm_shapes(full_attention_only: bool) -> tuple[ShapeSpec, ...]:
    long = ShapeSpec("long_500k", "decode", seq_len=524_288, batch=1)
    if full_attention_only:
        long = dataclasses.replace(
            long,
            skip="pure full-attention arch: 500k decode needs sub-quadratic "
            "attention (see DESIGN.md section 5)",
        )
    return (
        ShapeSpec("train_4k", "train", seq_len=4_096, batch=256),
        ShapeSpec("prefill_32k", "prefill", seq_len=32_768, batch=32),
        ShapeSpec("decode_32k", "decode", seq_len=32_768, batch=128),
        long,
    )


RECSYS_SHAPES = (
    ShapeSpec("train_batch", "train", batch=65_536),
    ShapeSpec("serve_p99", "serve", batch=512),
    ShapeSpec("serve_bulk", "serve", batch=262_144),
    ShapeSpec("retrieval_cand", "retrieval", batch=1, n_candidates=1_000_000),
)
