"""Every kernel wrapper of the port launches under its tensors' device.

The C entry points set no CUDA device: a wrapper must make the tensors'
card current (``torch.cuda.device``) around the launch, or a launch for a
tensor on ``cuda:1`` while ``cuda:0`` is current fails or reads the wrong
memory.  Here, on the CPU, each wrapper is driven down its CUDA branch
with the checks and the CUDA runtime stubbed out: ``_build.load`` hands
back a library whose entry points record the device that is current when
they are called, and the test holds that to the inputs' device.
"""

import contextlib
import types

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.blockmax_pivot import kernel as pk
from repro_torch.kernels.bm25_score import kernel as bk
from repro_torch.kernels.ef_search import kernel as efk
from repro_torch.kernels.embedding_bag import kernel as ebk
from repro_torch.kernels.gain_scan import kernel as gk
from repro_torch.kernels.partition_scan import kernel as psk
from repro_torch.kernels.pivot_score import kernel as sk
from repro_torch.kernels.vbyte_decode import kernel as vk

MODULES = (pk, bk, efk, ebk, gk, psk, sk, vk)


@pytest.fixture
def recorder(monkeypatch):
    """The list of (entry point, current device) of every stubbed launch."""
    state = {"current": None}
    calls = []

    @contextlib.contextmanager
    def fake_device(dev):
        prev, state["current"] = state["current"], torch.device(dev)
        try:
            yield
        finally:
            state["current"] = prev

    class Lib:
        def __getattr__(self, name):
            def entry(*args):
                calls.append((name, state["current"]))
                return 0

            entry.argtypes = None
            return entry

    monkeypatch.setattr(torch.cuda, "device", fake_device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(_build, "load", lambda name: Lib())
    monkeypatch.setattr(pk, "_ENTRY", None)
    for m in MODULES:
        monkeypatch.setattr(m, "on_cpu", lambda *ts: False)
        monkeypatch.setattr(m, "require", lambda *a, **k: None, raising=False)
    return calls


def _i32(*shape):
    return torch.zeros(shape, dtype=torch.int32)


def _u8(*shape):
    return torch.zeros(shape, dtype=torch.uint8)


def _sidecar(nb=8):
    return (_i32(nb, 128), _u8(nb, 512), _u8(nb, 128),
            torch.zeros(4, dtype=torch.float32), _i32(nb),
            torch.zeros(256, dtype=torch.float32), 2.2)


LAUNCHES = {
    "vbyte_decode_blocks": lambda: vk.decode_blocks(_i32(8, 128), _u8(8, 512),
                                                    _i32(3)),
    "vbyte_decode_search": lambda: vk.decode_search(
        _i32(8, 128), _u8(8, 512), _i32(8), _i32(5), _i32(5)),
    "ef_search": lambda: efk.ef_search(_i32(8, 128), _i32(8, 24), _i32(8),
                                       _i32(8), _i32(5), _i32(5)),
    "bm25_score_rows": lambda: bk.bm25_score_rows(*_sidecar(), _i32(3)),
    "bm25_score_probe": lambda: bk.bm25_score_probe(
        _i32(8, 128), _u8(8, 512), _i32(8), None, *_sidecar(), _i32(5),
        _i32(5)),
    "blockmax_pivot_select": lambda: pk.pivot_select(
        _i32(4, 128), _i32(4), _i32(5, 128), _i32(5)),
    "pivot_score": lambda: sk.pivot_score(
        _i32(4, 128), _i32(4), _i32(4), _i32(5, 128), _i32(5), *_sidecar()),
    "gain_scan": lambda: gk.gain_scan(_i32(2048)),
    "partition_scan": lambda: (psk.partition_scan(_i32(64), 3),
                               psk.partition_scan_bounds(_i32(64), 3)),
    "embedding_bag_f32": lambda: ebk.embedding_bag(
        torch.zeros((16, 4)), _i32(3, 2), torch.ones((3, 2))),
    "embedding_bag_bf16": lambda: ebk.embedding_bag(
        torch.zeros((16, 4), dtype=torch.bfloat16), _i32(3, 2),
        torch.ones((3, 2))),
}


@pytest.mark.parametrize("entry", sorted(LAUNCHES))
def test_launch_runs_under_the_inputs_device(recorder, entry):
    LAUNCHES[entry]()
    assert recorder, f"{entry}: the wrapper launched nothing"
    for name, current in recorder:
        # the entry point ran inside torch.cuda.device(<inputs' device>)
        assert current == torch.device("cpu"), (name, current)
    assert {name for name, _ in recorder} == {entry}


def test_every_wrapper_module_is_covered():
    """A wrapper module added without a case here fails this test."""
    import pkgutil

    import repro_torch.kernels as kernels

    found = {m.name for m in pkgutil.iter_modules(kernels.__path__)
             if m.ispkg}
    assert found == {m.__name__.split(".")[-2] for m in MODULES}


def test_launch_helper_raises_on_a_failed_launch(recorder):
    with pytest.raises(RuntimeError, match="cudaError 9"):
        _build.launch(lambda *a: 9, "probe", torch.device("cpu"), 1, 2)
