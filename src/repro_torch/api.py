"""Engine-construction facade: one frozen record of every engine option.

Counterpart of ``repro/api.py``.  ``EngineConfig`` gains ``device`` (the
torch device the engine serves on, default ``"cuda"``), and ``backend``
takes ``"auto"`` (= ``"torch"``), ``"torch"`` (the resident device
pipeline: CUDA kernels on a card, their plain versions for
``device="cpu"``) or ``"numpy"`` (the host mirror, only when asked for).

Legacy keywords keep working through one coercion point
(``coerce_config``): keywords alone are lifted into a config; a keyword
that CONFLICTS with an explicit ``config=`` wins with a
``DeprecationWarning``; an unknown keyword raises ``TypeError``.
Sharding, replicas and fault injection keep their fields, so a config
file of the reference still loads, but a non-default value raises
``NotImplementedError`` until the sharding slice of the port lands.
"""

from __future__ import annotations

import dataclasses
import json
import warnings
from dataclasses import dataclass

import torch

#: sentinel distinguishing "caller passed this keyword" from "default"
UNSET = type("_Unset", (), {"__repr__": lambda s: "UNSET"})()

CODEC_POLICIES = ("svb", "auto", "ef")
BACKENDS = ("auto", "torch", "numpy")


@dataclass(frozen=True)
class EngineConfig:
    """Every engine-construction option, in one frozen record."""

    backend: str = "auto"          # "auto" (= "torch") | "torch" | "numpy"
    device: str = "cuda"           # torch device of the "torch" backend
    fused: bool = True             # fused locate->decode_search path
    group: bool = True             # group duplicate cursors
    resident: str = "auto"         # ranked residency: "auto" | "mirror" | "kernel"
    codec_policy: str = "auto"     # arena codec: "svb" | "auto" | "ef"
    shards: int | None = None      # list-hash shard count (sharding slice)
    shard_mesh: object = "auto"    # (sharding slice)
    replicas: int = 1              # replica placement factor (sharding slice)
    cache_parts: int = 32_768      # LRU entry bound
    cache_bytes: int = 256 << 20   # LRU / flat-mirror byte budget
    fault_injector: object = None  # (sharding slice; never serialized)

    def __post_init__(self):
        if self.codec_policy not in CODEC_POLICIES:
            raise ValueError(
                f"codec_policy must be one of {CODEC_POLICIES}, got "
                f"{self.codec_policy!r}"
            )
        if self.backend not in BACKENDS:
            raise ValueError(
                f"backend must be one of {BACKENDS}, got {self.backend!r}"
            )

    def replace(self, **updates) -> "EngineConfig":
        """A copy with the given fields replaced (frozen-dataclass update)."""
        return dataclasses.replace(self, **updates)

    def to_json(self) -> str:
        if self.fault_injector is not None:
            raise ValueError(
                "fault_injector is a live object and cannot be serialized"
            )
        if self.shard_mesh not in ("auto", None):
            raise ValueError("an explicit shard_mesh cannot be serialized")
        d = dataclasses.asdict(self)
        del d["fault_injector"]
        return json.dumps(d, indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "EngineConfig":
        d = json.loads(text)
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(
                f"unknown EngineConfig field(s) in JSON: {sorted(unknown)}"
            )
        if "fault_injector" in d:
            raise ValueError("fault_injector cannot come from JSON")
        return cls(**d)

    @classmethod
    def from_args(cls, ns) -> "EngineConfig":
        """Lift an argparse namespace (``launch.serve`` flags) into a config.

        A ``--config FILE`` JSON (``ns.config``) supplies the base; any
        recognized flag present on the namespace overrides its field.
        ``--codec`` maps to ``codec_policy``.
        """
        base = cls()
        path = getattr(ns, "config", None)
        if path:
            with open(path) as fh:
                base = cls.from_json(fh.read())
        updates = {}
        for name in ("backend", "device", "fused", "group", "resident",
                     "cache_parts", "cache_bytes"):
            val = getattr(ns, name, None)
            if val is not None:
                updates[name] = val
        codec = getattr(ns, "codec", None)
        if codec is not None:
            updates["codec_policy"] = codec
        return base.replace(**updates) if updates else base


def coerce_config(engine: str, config, explicit: dict, extra: dict):
    """Resolve ``config=`` plus legacy keywords into one ``EngineConfig``."""
    if extra:
        bad = ", ".join(sorted(extra))
        raise TypeError(
            f"{engine} got unexpected keyword argument(s): {bad}. Engine "
            "options are the fields of repro_torch.api.EngineConfig"
        )
    cfg = config if config is not None else EngineConfig()
    updates = {}
    for name, val in explicit.items():
        if val is UNSET:
            continue
        if config is not None and val != getattr(cfg, name):
            warnings.warn(
                f"{engine}: keyword {name}={val!r} overrides "
                f"config.{name}={getattr(cfg, name)!r}; passing both is "
                "deprecated -- put the value in the EngineConfig",
                DeprecationWarning,
                stacklevel=3,
            )
        updates[name] = val
    cfg = cfg.replace(**updates) if updates else cfg
    check_slice(cfg)
    return cfg


def check_slice(cfg: EngineConfig) -> None:
    """Refuse the options whose slice of the port has not landed yet."""
    if cfg.shards is not None:
        raise NotImplementedError(
            "shards: sharded serving comes with the sharding slice of the port"
        )
    if cfg.replicas != 1:
        raise NotImplementedError(
            "replicas: replica placement comes with the sharding slice"
        )
    if cfg.fault_injector is not None:
        raise NotImplementedError(
            "fault_injector: fault-tolerant serving comes with the sharding "
            "slice"
        )


def resolve_backend(backend: str) -> str:
    """``"auto"`` means the resident torch pipeline."""
    return "torch" if backend == "auto" else backend


def resolve_device(device) -> torch.device:
    """The torch device to serve on; a CUDA device must exist.

    No quiet fallback: without a card the default ``"cuda"`` raises, and
    the caller asks for the CPU explicitly (``device="cpu"``).
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: repro_torch serves on the card by "
            "default; pass device='cpu' (--device cpu) to run the plain "
            "PyTorch versions of the kernels on the CPU"
        )
    return dev


def make_query_engine(index, config: EngineConfig | None = None):
    """Boolean/NextGEQ engine over ``index`` from one ``EngineConfig``."""
    from .core.query_engine import QueryEngine

    return QueryEngine(index, config=config or EngineConfig())


def make_topk_engine(index, config: EngineConfig | None = None):
    """Ranked BM25 top-k engine over a freq-carrying ``index`` from one
    ``EngineConfig``."""
    from .ranked.topk_engine import TopKEngine

    return TopKEngine(index, config=config or EngineConfig())
