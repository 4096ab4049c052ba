"""The port's EngineConfig facade against the JAX package's.

Ports ``tests/test_api.py`` case for case: one frozen record of every
engine option, its JSON round-trip for ``--config`` files, argparse
lifting for ``launch.serve``, and the single coercion point the engines
call (legacy keywords lift silently, conflicts warn and the keyword wins,
unknown keywords raise naming EngineConfig).  The reference's ``"ref"``
backend reads as the port's ``"torch"``, run on the CPU (the kernels'
plain versions).  Where a case compares engines, the port's answers are
held to the reference's ``ref`` engines on the same index, exactly.
"""

import argparse
import dataclasses
import json
import warnings

import numpy as np
import pytest

from repro.api import EngineConfig as RefConfig
from repro.api import make_query_engine as ref_make_query_engine
from repro.api import make_topk_engine as ref_make_topk_engine
from repro.core.index import build_partitioned_index as ref_build
from repro.data.postings import make_freqs

from repro_torch.api import (
    CODEC_POLICIES,
    EngineConfig,
    UNSET,
    coerce_config,
    make_query_engine,
    make_topk_engine,
)
from repro_torch.convert import index_arrays, index_from_arrays
from repro_torch.core.query_engine import QueryEngine
from repro_torch.ranked.topk_engine import TopKEngine

_IDX = {}


def _tiny_index(freqs=False, codecs="svb"):
    """(the reference's index, the port's index carried over from it)."""
    key = (freqs, codecs)
    if key not in _IDX:
        rng = np.random.default_rng(0)
        corpus = [
            np.cumsum(rng.choice([1, 2, 6, 10, 20, 30], size=800)).astype(
                np.int64
            )
            - 1
            for _ in range(4)
        ]
        f = make_freqs(rng, corpus) if freqs else None
        ref = ref_build(corpus, "optimal", freqs=f, codecs=codecs)
        _IDX[key] = (ref, index_from_arrays(index_arrays(ref)))
    return _IDX[key]


# ----------------------------------------------------------------------
# the config record
# ----------------------------------------------------------------------
def test_json_roundtrip():
    cfg = EngineConfig(
        backend="torch",
        fused=False,
        resident="kernel",
        codec_policy="ef",
        shards=4,
        replicas=2,
        cache_bytes=1 << 20,
    )
    assert EngineConfig.from_json(cfg.to_json()) == cfg
    # defaults round-trip too
    assert EngineConfig.from_json(EngineConfig().to_json()) == EngineConfig()


def test_json_rejects_unknown_fields_and_live_objects():
    with pytest.raises(ValueError, match="unknown EngineConfig field"):
        EngineConfig.from_json('{"backnd": "torch"}')
    with pytest.raises(ValueError, match="fault_injector"):
        EngineConfig.from_json('{"fault_injector": null}')
    with pytest.raises(ValueError, match="fault_injector"):
        EngineConfig(fault_injector=object()).to_json()
    with pytest.raises(ValueError, match="shard_mesh"):
        EngineConfig(shard_mesh=object()).to_json()


def test_codec_policy_validated():
    assert CODEC_POLICIES == ("svb", "auto", "ef")
    with pytest.raises(ValueError, match="codec_policy"):
        EngineConfig(codec_policy="lz77")


def test_replace_is_frozen_update():
    cfg = EngineConfig()
    cfg2 = cfg.replace(backend="numpy", shards=2)
    assert (cfg2.backend, cfg2.shards) == ("numpy", 2)
    assert cfg == EngineConfig()  # original untouched
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.backend = "numpy"


# ----------------------------------------------------------------------
# argparse lifting (launch.serve --config / flags)
# ----------------------------------------------------------------------
def test_from_args_config_file_base_plus_flag_overrides(tmp_path):
    base = EngineConfig(backend="numpy", codec_policy="ef", shards=2)
    path = tmp_path / "engine.json"
    path.write_text(base.to_json())
    ns = argparse.Namespace(
        config=str(path),
        backend="torch",  # explicit flag overrides the file
        fused=None,  # un-passed flags (None) leave the file's value
        codec=None,
        shards=None,
        replicas=None,
    )
    cfg = EngineConfig.from_args(ns)
    assert cfg.backend == "torch"
    assert cfg.codec_policy == "ef"
    assert cfg.shards == 2
    assert json.loads(path.read_text())["backend"] == "numpy"


def test_from_args_codec_maps_to_codec_policy():
    ns = argparse.Namespace(config=None, codec="auto", backend=None)
    assert EngineConfig.from_args(ns).codec_policy == "auto"
    assert EngineConfig.from_args(argparse.Namespace()) == EngineConfig()


# ----------------------------------------------------------------------
# coercion: legacy keywords vs config=
# ----------------------------------------------------------------------
def test_legacy_keywords_lift_silently():
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # any DeprecationWarning fails
        cfg = coerce_config(
            "QueryEngine",
            None,
            dict(backend="torch", fused=False, group=UNSET),
            {},
        )
    assert (cfg.backend, cfg.fused, cfg.group) == ("torch", False, True)


def test_keyword_conflicting_with_config_warns_and_wins():
    with pytest.warns(DeprecationWarning, match="backend"):
        cfg = coerce_config(
            "TopKEngine",
            EngineConfig(backend="numpy"),
            dict(backend="torch"),
            {},
        )
    assert cfg.backend == "torch"
    # a keyword AGREEING with the config does not warn
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        coerce_config(
            "TopKEngine", EngineConfig(backend="torch"),
            dict(backend="torch"), {}
        )


@pytest.mark.parametrize("engine_cls", [QueryEngine, TopKEngine])
def test_unknown_kwarg_raises_naming_engineconfig(engine_cls):
    _, idx = _tiny_index(freqs=engine_cls is TopKEngine)
    with pytest.raises(TypeError, match="EngineConfig") as ei:
        engine_cls(idx, bakend="torch")
    assert "bakend" in str(ei.value)


# ----------------------------------------------------------------------
# factories build working engines
# ----------------------------------------------------------------------
def test_factories_and_legacy_paths_agree():
    ref_idx, idx = _tiny_index(freqs=True, codecs="auto")
    cfg = EngineConfig(backend="torch", device="cpu", codec_policy="auto")
    ref_cfg = RefConfig(backend="ref", codec_policy="auto")
    queries = [[0, 1], [2, 3], [1, 3]]

    via_factory = make_query_engine(idx, cfg).intersect_batch(queries)
    via_kwargs = QueryEngine(
        idx, backend="torch", device="cpu", codec_policy="auto"
    ).intersect_batch(queries)
    want = ref_make_query_engine(ref_idx, ref_cfg).intersect_batch(queries)
    for w, g, k in zip(want, via_factory, via_kwargs):
        assert np.array_equal(w, g) and np.array_equal(w, k)

    tk = make_topk_engine(idx, cfg, seed_blocks=2)
    assert tk.config == cfg and tk.seed_blocks == 2
    legacy = TopKEngine(idx, backend="torch", device="cpu",
                        codec_policy="auto", seed_blocks=2)
    ref_tk = ref_make_topk_engine(ref_idx, ref_cfg, seed_blocks=2)
    assert ref_tk.seed_blocks == 2
    for (wd, ws), (gd, gs), (kd, ks) in zip(
        ref_tk.topk_batch(queries, 5), tk.topk_batch(queries, 5),
        legacy.topk_batch(queries, 5),
    ):
        assert np.array_equal(wd, gd) and np.array_equal(wd, kd)
        assert np.array_equal(ws, gs) and np.array_equal(ws, ks)


def test_engines_expose_their_config():
    _, idx = _tiny_index()
    eng = make_query_engine(idx, EngineConfig(backend="numpy"))
    assert eng.config.backend == "numpy"
    assert eng.config == EngineConfig(backend="numpy")


def test_make_topk_engine_passes_engine_knobs_through():
    """Closed fault: the factory dropped the reference's ``**kwargs``."""
    _, idx = _tiny_index(freqs=True)
    cfg = EngineConfig(backend="numpy", device="cpu")
    tk = make_topk_engine(idx, cfg, seed_blocks=2)
    assert tk.seed_blocks == 2 and tk.config == cfg
    assert make_topk_engine(idx, cfg).seed_blocks == TopKEngine(
        idx, config=cfg).seed_blocks
    with pytest.raises(TypeError, match="EngineConfig"):
        make_topk_engine(idx, cfg, bakend="torch")
