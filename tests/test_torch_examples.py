"""The paper's two examples on the port, and ``DeviceList`` with the block
decoder's ``decode`` / ``decode_sorted`` under them, against the JAX
package.  Every comparison is exact: integers, and the numbers the
examples print (partitions, bits per integer, result counts), timings
excepted.
"""

import os
import re
import runpy

import numpy as np
import pytest
import torch

from repro.core.jax_engine import DeviceList as RefDeviceList
from repro.kernels.vbyte_decode import ops as rops
from repro.kernels.vbyte_decode import ref as rref

from repro_torch.core.jax_engine import DeviceList
from repro_torch.examples import index_serving, quickstart, train_lm
from repro_torch.kernels.vbyte_decode import kernel as tk
from repro_torch.kernels.vbyte_decode import ops as tops
from repro_torch.kernels.vbyte_decode import ref as tref

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _lists(n, seed):
    """Two seeded sorted lists sharing about a third of their ids: one of
    ``n`` ids, one of about 2n."""
    rng = np.random.default_rng(seed)
    a = np.unique(rng.integers(0, 12 * n + 12, 3 * n))[:n]
    b = np.unique(np.concatenate([rng.choice(a, (n + 2) // 3),
                                  rng.integers(0, 12 * n + 12, 2 * n)]))
    return a.astype(np.int64), b.astype(np.int64)


def _probes(rng, a):
    """Edge probes (0, each end, one past the end, far past it) and 256
    drawn over the list's range and a little beyond."""
    edges = [0, a[0], a[0] + 1, a[-1] - 1, a[-1], a[-1] + 1, a[-1] + 10**6]
    return np.concatenate([edges, rng.integers(0, a[-1] + 5, 256)]).astype(np.int64)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("n", [1, 127, 128, 129, 5000])
def test_device_list_matches_the_reference(n, use_kernel):
    """``use_kernel=True``: the reference's Pallas ``decode_blocks`` in
    interpret mode against the port's wrapper (its plain version on the
    CPU); ``False``: the two plain versions."""
    a, b = _lists(n, seed=n)
    ref_a, ref_b = RefDeviceList(a, use_kernel), RefDeviceList(b, use_kernel)
    got_a = DeviceList(a, use_kernel, device="cpu")
    got_b = DeviceList(b, use_kernel, device="cpu")
    assert np.array_equal(got_a.lens.numpy(), np.asarray(ref_a.lens))
    assert np.array_equal(got_a.data.numpy(), np.asarray(ref_a.data))
    assert got_a.n == ref_a.n == n
    dec = got_a.decode()
    assert dec.dtype == torch.int64 and np.array_equal(dec.numpy(), a)
    assert np.array_equal(dec.numpy(), np.asarray(ref_a.decode()))
    for x, y in ((got_a, got_b), (got_b, got_a)):
        rx, ry = (ref_a, ref_b) if x is got_a else (ref_b, ref_a)
        hits = x.intersect(y).numpy()
        assert np.array_equal(hits, np.asarray(rx.intersect(ry)))
        assert np.array_equal(hits[hits >= 0], np.intersect1d(a, b))
    probes = _probes(np.random.default_rng(n + 1), a)
    got = got_a.next_geq_batch(probes).numpy()
    assert np.array_equal(got, np.asarray(ref_a.next_geq_batch(probes)))
    ks = np.searchsorted(a, probes)
    assert np.array_equal(got, np.where(ks < n, a[np.minimum(ks, n - 1)], -1))
    assert got[-257] == -1  # far past the end


@pytest.mark.parametrize("use_kernel", [True, False])
def test_decode_and_decode_sorted_match_the_reference(use_kernel):
    """The inputs of ``test_kernels.py::test_vbyte_decode_sorted_ids``."""
    rng = np.random.default_rng(3)
    seq = np.cumsum(rng.integers(1, 5000, 4000)) - 1
    gaps = np.diff(np.concatenate([[-1], seq]))
    lens, data, n = tops.pack_blocks((gaps - 1).astype(np.uint32))
    vals = tops.decode(lens, data, n, use_kernel=use_kernel, device="cpu")
    assert vals.dtype == torch.int32 and np.array_equal(vals.numpy(), gaps - 1)
    assert np.array_equal(vals.numpy(), np.asarray(rops.decode(
        lens, data, n, use_kernel=use_kernel)))
    dec = tops.decode_sorted(lens, data, n, use_kernel=use_kernel, device="cpu")
    assert dec.dtype == torch.int64 and np.array_equal(dec.numpy(), seq)
    assert np.array_equal(dec.numpy(), np.asarray(rops.decode_sorted(
        lens, data, n, use_kernel=use_kernel)))
    for base in (-1, 1000):
        full = tref.decode_sorted_ref(torch.from_numpy(lens), torch.from_numpy(data), base)
        want = np.asarray(rref.decode_sorted_ref(lens, data, base))
        assert full.shape == (lens.size,) and np.array_equal(full.numpy(), want)
        assert np.array_equal(full[:n].numpy(), seq + base + 1)
    # a tensor argument is decoded where it lies
    t = tops.decode(torch.from_numpy(lens), torch.from_numpy(data), n,
                    use_kernel=use_kernel, device="not-a-device")
    assert np.array_equal(t.numpy(), gaps - 1)


def _numbers(text: str) -> list[list[str]]:
    """The numbers of each printed line, its timings (``0.12s``, ``34.46
    ms/query``) taken out."""
    out = []
    for line in text.strip().splitlines():
        line = re.sub(r"\d+\.\d+ ?(ms/query|s\b)", "", line)
        out.append(re.findall(r"\d[\d,]*(?:\.\d+)?", line))
    return out


@pytest.mark.parametrize("name,module", [("quickstart", quickstart),
                                         ("index_serving", index_serving)])
def test_examples_print_the_reference_numbers(name, module, capsys):
    runpy.run_path(os.path.join(ROOT, "examples", f"{name}.py"), run_name="__main__")
    want = capsys.readouterr().out
    res = module.run(device="cpu")
    got = capsys.readouterr().out
    assert len(got.strip().splitlines()) == len(want.strip().splitlines())
    assert _numbers(got) == _numbers(want)
    assert res and all(v is not None for v in res.values())


@pytest.mark.parametrize("call", [
    lambda: DeviceList(np.arange(10)),
    lambda: quickstart.main([]),
    lambda: index_serving.main([]),
    lambda: train_lm.main(["--steps", "1"]),
    lambda: tops.decode(np.ones((8, 128), np.int32), np.zeros((8, 512), np.uint8), 5),
])
def test_examples_need_a_card_unless_told_cpu(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def test_train_lm_config_is_the_reference_examples():
    """``train_lm.CFG`` holds the keywords of the reference script's
    ``T.TransformerConfig(...)``, read from its source."""
    import ast
    import dataclasses

    tree = ast.parse(open(os.path.join(ROOT, "examples", "train_lm.py")).read())
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "attr", None) == "TransformerConfig"]
    assert len(calls) == 1
    want = {k.arg: ast.literal_eval(k.value) for k in calls[0].keywords}
    got = dataclasses.asdict(train_lm.CFG)
    assert {k: got[k] for k in want} == want
    from repro.models.transformer import TransformerConfig

    # the script's "~100M" is 59,253,248 by the config's own count
    assert train_lm.CFG.param_count() == TransformerConfig(**want).param_count() == 59_253_248


def test_train_lm_restarts_once_and_the_loss_falls(capsys):
    """The example's loop at a narrow config on the CPU: 40 steps, the
    failure at step 20 restores the step-0 checkpoint (one every 50
    steps), and the last losses are below the first; the shard index
    prints the reference loader's bytes."""
    import dataclasses

    from repro.data import lm_data as R

    cfg = dataclasses.replace(train_lm.CFG, n_layers=2, d_model=64, n_heads=4,
                              n_kv_heads=4, d_head=16, d_ff=128, vocab=512,
                              attn_chunk=16, loss_chunk=16)
    res = train_lm.run(40, 4, 32, device="cpu", cfg=cfg)
    out = capsys.readouterr().out
    st = res["stats"]
    assert (st.restarts, st.wasted_steps, st.steps_completed) == (1, 20, 60)
    assert int(res["state"][1]["count"]) == 40
    assert "[train] RESTART #1 from step 0" in out
    losses = res["losses"]
    assert len(losses) == 60 and np.mean(losses[-5:]) < np.mean(losses[:5])
    ref = R.ShardedBatchLoader(R.TokenStream(512, 32 * 4 * 256 + 1), 4, 32)
    assert (f"compressed shard index: {ref.compressed_index_bytes:,} bytes (OptVB) "
            f"vs {ref.offsets().size * 8:,} raw") in out
    assert f"params: {cfg.param_count():,}" in out


@pytest.mark.cuda
def test_cuda_device_list_launches_decode_blocks():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode_blocks kernel runs only there")
    a, b = _lists(5000, seed=7)
    before = tk.decode_blocks.launches
    x, y = DeviceList(a), DeviceList(b)
    hits = x.intersect(y).cpu().numpy()
    assert tk.decode_blocks.launches == before + 2
    assert np.array_equal(hits[hits >= 0], np.intersect1d(a, b))
    probes = _probes(np.random.default_rng(8), a)
    got = x.next_geq_batch(probes).cpu().numpy()
    ks = np.searchsorted(a, probes)
    assert np.array_equal(got, np.where(ks < len(a), a[np.minimum(ks, len(a) - 1)], -1))
