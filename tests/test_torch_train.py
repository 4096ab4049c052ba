"""The port's training launcher and sparse-update step against the JAX
package, at the smoke configs.

Tolerances and why: losses and gradient norms rtol 1e-5 (f32 sums in
another order); the rowwise-Adagrad accumulator rtol 1e-5 + atol 1e-10 and
the table atol 1e-7 + rtol 1e-5 (sums of squares and a scatter of rows,
each rounded once more or less); table rows no batch touched exactly; the
AdamW-trained parameters atol 1e-5 + rtol 1e-4 on every element
(``test_torch_recsys._assert_params_close`` without its allowance); batches, run
statistics, checkpoints read back and a restarted run against an
unbroken one exactly.
"""

import dataclasses
import re
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as ref_get_arch
from repro.data import recsys_data as rdata
from repro.launch import train as rtrain
from repro.launch.cells import make_sparse_recsys_train_step as ref_sparse_step
from repro.launch.cells import make_train_step as ref_make_train_step
from repro.models import recsys as R
from repro.optim import adamw as radamw

from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import tree_flatten
from repro_torch.configs import get_arch
from repro_torch.launch import train as ttrain
from repro_torch.launch.cells import make_sparse_recsys_train_step, sparse_opt_init
from repro_torch.models.common import param_dict

from test_torch_recsys import _assert_params_close, _flat

ARCHS = ["bst", "dcn-v2", "din", "dlrm-rm2"]


def _ref_init(arch, seed=0):
    params = R.init_params(jax.random.PRNGKey(seed), ref_get_arch(arch).smoke)
    return params, jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("arch", ["dcn-v2", "dlrm-rm2"])
def test_sparse_step_matches_the_jitted_jax_step(arch):
    rcfg, tcfg = ref_get_arch(arch).smoke, get_arch(arch).smoke
    params, arrays = _ref_init(arch)
    model = convert.recsys_params_from_arrays(arrays, tcfg, "cpu")
    rstep = jax.jit(ref_sparse_step(rcfg))
    other = {k: v for k, v in params.items() if k != "table"}
    ropt = {"mlp": radamw.adamw_init(other),
            "table_acc": jnp.zeros((rcfg.table_rows,), jnp.float32)}
    tstep, topt = make_sparse_recsys_train_step(tcfg), sparse_opt_init(model)
    assert list(topt["mlp"]["m"]) == [k for k in param_dict(model) if k != "table"]
    table0 = model.table.detach().clone()
    touched = np.zeros(rcfg.table_rows, bool)
    for s in range(4):
        b = rdata.make_ctr_batch(np.random.default_rng(10 + s), rcfg, 16)
        ids = (b["sparse"] + np.arange(rcfg.n_sparse) * rcfg.rows_per_field).reshape(-1)
        assert len(np.unique(ids)) < len(ids)  # Zipf ids repeat in a batch
        touched[ids] = True
        params, ropt, rm = rstep(params, ropt, b)
        _, topt, tm = tstep(model, topt, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(rm["grad_norm"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(topt["table_acc"].numpy(),
                                   np.asarray(ropt["table_acc"]), rtol=1e-5, atol=1e-10)
        np.testing.assert_allclose(model.table.detach().numpy(), np.asarray(params["table"]),
                                   rtol=1e-5, atol=1e-7)
    assert topt["mlp"]["count"] == int(ropt["mlp"]["count"]) == 4
    table = model.table.detach()
    assert torch.equal(table[~touched], table0[~touched])
    assert np.array_equal(table[~touched].numpy(), np.asarray(params["table"])[~touched])
    assert not torch.equal(table[touched], table0[touched])
    assert float(topt["table_acc"][~touched].abs().max()) == 0.0
    tree = {k: v for k, v in params.items() if k != "table"}
    got = {k: v for k, v in param_dict(model).items() if k != "table"}
    _assert_params_close(got, tree, atol=1e-5, rtol=1e-4)


def test_sparse_step_waits_for_the_mesh_and_takes_dcn_or_dlrm():
    cfg = get_arch("dcn-v2").smoke
    with pytest.raises(NotImplementedError, match="A7e"):
        make_sparse_recsys_train_step(cfg, mesh=object())
    with pytest.raises(ValueError, match="dcn or dlrm"):
        make_sparse_recsys_train_step(get_arch("din").smoke)


@pytest.mark.parametrize("arch", ARCHS)
def test_build_training_matches_the_reference(arch):
    rstate, rstep, rbatches, rcfg = rtrain.build_training(arch, True, 8, 128)
    arrays = jax.tree_util.tree_map(np.asarray, rstate[0])
    state, step, batches, cfg = ttrain.build_training(arch, True, 8, 128,
                                                      device="cpu", params=arrays)
    assert cfg == get_arch(arch).smoke
    for s in range(5):
        rb, tb = rbatches(s), batches(s)
        assert rb.keys() == tb.keys()
        for k in rb:
            assert np.array_equal(tb[k].numpy(), rb[k]), k
        rstate, rm = rstep(rstate, rb)
        state, m = step(state, tb)
        np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]), rtol=1e-5)
    assert state[1]["count"] == int(rstate[1]["count"]) == 5
    model = convert.recsys_params_from_arrays(
        jax.tree_util.tree_map(np.asarray, state[0]), cfg, "cpu")
    _assert_params_close(model, rstate[0], atol=1e-5, rtol=1e-4)


def _ref_main(monkeypatch, capsys, flags):
    monkeypatch.setattr(sys, "argv", ["train", *flags])
    rtrain.main()
    out = capsys.readouterr().out
    return re.search(r"\[train\] done: (RunStats\(.*\))", out).group(1)


def test_main_with_a_failure_reports_the_reference_run(monkeypatch, capsys, tmp_path):
    flags = ["--arch", "din", "--smoke", "--steps", "6", "--save-every", "2",
             "--fail-at", "3"]
    ref_stats = _ref_main(monkeypatch, capsys, [*flags, "--ckpt-dir", str(tmp_path / "ref")])
    _, arrays = _ref_init("din")
    state, stats = ttrain.main([*flags, "--ckpt-dir", str(tmp_path / "port"),
                                "--device", "cpu"], params=arrays)
    out = capsys.readouterr().out
    assert repr(stats) == ref_stats
    assert (stats.restarts, stats.wasted_steps, stats.steps_completed) == (1, 1, 7)
    assert "[train] RESTART #1 from step 2" in out
    assert "[train] arch=din params=30,025" in out
    # the reference's final checkpoint, read into the port's state
    ref_state, at = CheckpointManager(str(tmp_path / "ref")).restore(state)
    assert at == 6 and int(ref_state[1]["count"]) == state[1]["count"] == 6
    model = convert.recsys_params_from_arrays(
        jax.tree_util.tree_map(np.asarray, state[0]), get_arch("din").smoke, "cpu")
    _assert_params_close(model, ref_state[0], atol=1e-5, rtol=1e-4)
    # the same steps without the failure: the restart lost nothing
    clean, clean_stats = ttrain.main(
        ["--arch", "din", "--smoke", "--steps", "6", "--save-every", "2",
         "--ckpt-dir", str(tmp_path / "clean"), "--device", "cpu"], params=arrays)
    assert (clean_stats.restarts, clean_stats.steps_completed) == (0, 6)
    for a, b in zip(tree_flatten(state)[0], tree_flatten(clean)[0]):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("arch", ["dcn-v2", "bst"])
def test_reference_checkpoint_restores_into_the_port_state(arch, monkeypatch, capsys,
                                                           tmp_path):
    ckpt = tmp_path / "ref"
    _ref_main(monkeypatch, capsys, ["--arch", arch, "--smoke", "--steps", "2",
                                    "--save-every", "2", "--ckpt-dir", str(ckpt)])
    state, step, batches, cfg = ttrain.build_training(arch, True, 8, device="cpu")
    restored, at = CheckpointManager(str(ckpt)).restore(state)
    assert at == 2
    rstate, rstep, rbatches, _ = rtrain.build_training(arch, True, 8, 128)
    want, _ = CheckpointManager(str(ckpt)).restore(rstate)  # numpy leaves
    got_leaves, got_def = tree_flatten(restored)
    want_leaves, want_def = tree_flatten(want)
    assert str(got_def) == str(want_def)
    for g, w in zip(got_leaves, want_leaves):
        assert np.array_equal(np.asarray(g), np.asarray(w))
    assert all(isinstance(x, torch.Tensor) for x in tree_flatten(restored[0])[0])
    # one more step from the restored state, in both packages
    jstate = jax.tree_util.tree_map(jnp.asarray, want)
    jstate, rm = rstep(jstate, rbatches(2))
    restored, m = step(restored, batches(2))
    np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]), rtol=1e-5)
    assert restored[1]["count"] == int(jstate[1]["count"]) == 3


def test_named_leaves_follow_the_checkpoint_flatten():
    for arch in ARCHS:
        state, *_ = ttrain.build_training(arch, True, 4, device="cpu")
        named = ttrain.named_leaves(state[0])
        assert list(named) == list(param_dict(
            convert.recsys_params_from_arrays(
                jax.tree_util.tree_map(np.asarray, state[0]), get_arch(arch).smoke,
                "cpu")))
        assert [id(x) for x in named.values()] == [id(x) for x in tree_flatten(state[0])[0]]
        assert list(named) == list(_flat(_ref_init(arch)[0]))


@pytest.mark.parametrize("call", [
    lambda: ttrain.build_training("din", True, 4),
    lambda: ttrain.build_training("qwen3-0.6b", True, 4),
    lambda: ttrain.main(["--arch", "bst", "--smoke", "--steps", "1"]),
])
def test_launcher_needs_a_card_unless_told_cpu(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


# --------------------------------------------------------------------------
# the LM half (models.transformer, data.lm_data) against the reference
# --------------------------------------------------------------------------

LM_ARCHS = ["command-r-35b", "mixtral-8x22b", "moonshot-v1-16b-a3b", "qwen1.5-0.5b",
            "qwen3-0.6b"]


def _lm_arrays(arch, seed=0, rcfg=None):
    from repro.models import transformer as RT

    params = RT.init_params(jax.random.PRNGKey(seed), rcfg or ref_get_arch(arch).smoke)
    return params, jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "qwen3-0.6b"])
def test_lm_steps_match_the_jitted_jax_step_f32(arch):
    """Three ``make_train_step`` steps of ``lm_loss`` at compute_dtype f32,
    a dense arch (GQA, qk-norm) and an MoE one (sliding window): losses
    and gradient norms rtol 1e-5, parameters atol 1e-5 + rtol 1e-4 on every
    element (each arch's gradients are held leaf by leaf in
    ``test_torch_transformer.py``)."""
    from repro.models import transformer as RT
    from repro_torch.launch.cells import make_train_step
    from repro_torch.models import transformer as TT
    from repro_torch.optim import adamw_init

    rcfg = dataclasses.replace(ref_get_arch(arch).smoke, compute_dtype=jnp.float32)
    tcfg = dataclasses.replace(get_arch(arch).smoke, compute_dtype=torch.float32)
    params, arrays = _lm_arrays(arch, rcfg=rcfg)
    model = TT.Transformer(tcfg, convert.lm_tree_from_arrays(arrays, tcfg, "cpu"))

    def rloss(p, b, c):
        return RT.lm_loss(p, b["tokens"], b["labels"], c)

    rstep = jax.jit(ref_make_train_step(rloss, rcfg))
    ropt = radamw.adamw_init(params)
    tstep, topt = make_train_step(TT.loss_fn, tcfg), adamw_init(param_dict(model))
    rng = np.random.default_rng(1)
    for _ in range(3):
        b = {k: rng.integers(0, rcfg.vocab, (2, 32)).astype(np.int32)
             for k in ("tokens", "labels")}
        params, ropt, rm = rstep(params, ropt, b)
        _, topt, tm = tstep(model, topt, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(rm["grad_norm"]),
                                   rtol=1e-5)
    _assert_params_close(model, params, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_build_training_matches_the_reference(arch):
    """The launcher's LM half at the smoke configs (bf16): the batches bit
    for bit; losses rtol 2e-3 and gradient norms rtol 3e-2 (every bf16 op
    rounds to 8 bits, and a near-tie in the router may send a token to
    another expert); the parameters' updates (after - before) within the
    reference's in relative L2 to 0.1, 0.25 for the MoE archs (AdamW's
    m / sqrt(v) turns the gradients' bf16 differences into flipped steps
    where a gradient is near zero: 3.5-4.2% dense, 7.2-10.7% MoE on the
    CPU; the f32 test above holds the step itself to 1e-4)."""
    rstate, rstep, rbatches, rcfg = rtrain.build_training(arch, True, 4, 32)
    arrays = jax.tree_util.tree_map(np.asarray, rstate[0])
    state, step, batches, cfg = ttrain.build_training(arch, True, 4, 32, device="cpu",
                                                      params=arrays)
    assert cfg == get_arch(arch).smoke
    for s in range(3):
        rb, tb = rbatches(s), batches(s)
        assert rb.keys() == tb.keys() == {"tokens", "labels"}
        for k in rb:
            assert np.array_equal(tb[k].numpy(), rb[k]), k
        rstate, rm = rstep(rstate, rb)
        state, m = step(state, tb)
        np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]), rtol=2e-3)
        np.testing.assert_allclose(float(m["grad_norm"]), float(rm["grad_norm"]),
                                   rtol=3e-2)
    assert state[1]["count"] == int(rstate[1]["count"]) == 3
    got = ttrain.named_leaves(state[0])
    want, init = _flat(rstate[0]), _flat(arrays)
    assert list(got) == list(want)
    du = np.concatenate([(got[k].detach().numpy() - init[k]).ravel() for k in want])
    dw = np.concatenate([(want[k] - init[k]).ravel() for k in want])
    bound = 0.25 if cfg.is_moe else 0.1
    assert np.linalg.norm(du - dw) < bound * np.linalg.norm(dw)


def test_lm_model_scale_matches_the_reference():
    *_, rcfg = rtrain.build_training("qwen3-0.6b", True, 2, 16, model_scale=2)
    state, *_, cfg = ttrain.build_training("qwen3-0.6b", True, 2, 16, model_scale=2,
                                           device="cpu")
    from test_torch_transformer import _port_cfg

    assert cfg == _port_cfg(rcfg)
    assert (cfg.n_layers, cfg.d_model, cfg.d_head, cfg.vocab) == (4, 128, 32, 32768)
    assert sum(x.numel() for x in ttrain.named_leaves(state[0]).values()) == cfg.param_count()


def test_lm_training_reduces_loss(tmp_path):
    """``test_system.py::test_lm_training_reduces_loss`` on the port: 30
    steps of the smoke qwen1.5-0.5b through the runner with a failure at
    step 12 restart once, and the loss falls."""
    state, step, batches, cfg = ttrain.build_training(
        "qwen1.5-0.5b", smoke=True, batch=8, seq_len=64, device="cpu")
    mgr = CheckpointManager(tmp_path, async_save=False)
    runner = ttrain.FaultTolerantRunner(step, mgr, save_every=10)
    losses = []

    def wrapped(state, b):
        s, m = step(state, b)
        losses.append(float(m["loss"]))
        return s, m

    runner.step_fn = wrapped
    runner.run(state, batches, 30, failure=ttrain.SimulatedFailure(at_steps=(12,)))
    assert runner.stats.restarts == 1
    first = np.mean(losses[:5])
    last = np.mean(losses[-5:])
    assert last < first, (first, last)


def test_lm_main_with_a_failure_reports_the_reference_run(monkeypatch, capsys, tmp_path):
    flags = ["--arch", "qwen3-0.6b", "--smoke", "--steps", "6", "--save-every", "2",
             "--fail-at", "3", "--batch", "2", "--seq-len", "32"]
    ref_stats = _ref_main(monkeypatch, capsys, [*flags, "--ckpt-dir", str(tmp_path / "ref")])
    _, arrays = _lm_arrays("qwen3-0.6b")
    state, stats = ttrain.main([*flags, "--ckpt-dir", str(tmp_path / "port"),
                                "--device", "cpu"], params=arrays)
    out = capsys.readouterr().out
    assert repr(stats) == ref_stats
    assert (stats.restarts, stats.wasted_steps, stats.steps_completed) == (1, 1, 7)
    assert "[train] RESTART #1 from step 2" in out
    n = get_arch("qwen3-0.6b").smoke.param_count()
    assert f"[train] arch=qwen3-0.6b params={n:,}" in out
    # the reference's final checkpoint reads into the port's state
    ref_state, at = CheckpointManager(str(tmp_path / "ref")).restore(state)
    assert at == 6 and int(ref_state[1]["count"]) == state[1]["count"] == 6
    # the same steps without the failure: the restart lost nothing
    clean, clean_stats = ttrain.main(
        ["--arch", "qwen3-0.6b", "--smoke", "--steps", "6", "--save-every", "2",
         "--batch", "2", "--seq-len", "32", "--ckpt-dir", str(tmp_path / "clean"),
         "--device", "cpu"], params=arrays)
    assert (clean_stats.restarts, clean_stats.steps_completed) == (0, 6)
    for a, b in zip(tree_flatten(state)[0], tree_flatten(clean)[0]):
        assert np.array_equal(np.asarray(a), np.asarray(b))
