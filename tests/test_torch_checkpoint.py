"""The port's checkpointing, fault-tolerant runner and straggler watchdog.

Ports the oracles of ``tests/test_checkpoint_and_ft.py`` with step
functions over torch tensors: OptVB packing (byte-equal to the
reference's), atomic publish and retention, async save, restart
determinism, the step-0 checkpoint, fallback past corrupt steps, the
deduplicated final save, ``RunStats``, seeded failures and the watchdog.
The pytree flatten is held to jax's: leaf order and the manifest's
``treedef`` string, so either package reads the other's checkpoints.
"""

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefManager
from repro.checkpoint import pack_sorted_int_array as ref_pack
from repro.distributed import SimulatedFailure as RefFailure

from repro_torch.checkpoint import (
    CheckpointManager,
    pack_sorted_int_array,
    unpack_sorted_int_array,
)
from repro_torch.checkpoint.manager import tree_flatten
from repro_torch.distributed import (
    FaultTolerantRunner,
    SimulatedFailure,
    StragglerWatchdog,
)


def test_optvb_pack_roundtrip_and_byte_equal_to_reference():
    rng = np.random.default_rng(0)
    arr = np.cumsum(rng.integers(1, 100, 5000)).astype(np.int64)
    packed = pack_sorted_int_array(arr)
    out = unpack_sorted_int_array(packed)
    assert np.array_equal(out, arr)
    raw = arr.size * 8
    comp = packed["payload"].size + 8 * len(packed["endpoints"])
    assert comp < raw  # compression actually happened
    want = ref_pack(arr)
    assert packed.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert packed[k].dtype == v.dtype, k
            assert packed[k].tobytes() == v.tobytes(), k
        else:
            assert packed[k] == v, k


@pytest.mark.parametrize("tree", [
    {"b": 1, "a": [1, (2, 3)], "c": None, "d": {}, "e": [], "f": ()},
    {"w": np.zeros(3), "x": {"z": 1, "y": (np.ones(2),)}},
    [None, 2, {"k": 3}],
    np.int32(3),
])
def test_flatten_matches_jax(tree):
    leaves, treedef = tree_flatten(tree)
    want_leaves, want_def = jax.tree_util.tree_flatten(tree)
    assert str(treedef) == str(want_def)
    assert len(leaves) == len(want_leaves)
    for a, b in zip(leaves, want_leaves):
        assert a is b
    assert str(tree_flatten(treedef.unflatten(leaves))[1]) == str(treedef)


def test_checkpoint_roundtrip_and_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=False)
    tree = {
        "w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "ids": np.cumsum(np.ones(100, np.int64) * 3),  # strictly increasing
        "count": torch.tensor(7, dtype=torch.int32),
    }
    for step in (10, 20, 30):
        mgr.save(step, tree)
    assert mgr.latest_step() == 30
    ckpts = sorted(p.name for p in tmp_path.glob("step_*"))
    assert len(ckpts) == 2  # retention
    restored, step = mgr.restore(tree)
    assert step == 30
    assert isinstance(restored["w"], torch.Tensor)  # the target's kind
    assert torch.equal(restored["w"], tree["w"])
    assert np.array_equal(restored["ids"], tree["ids"])
    assert int(restored["count"]) == 7
    # restore onto an explicit device: every leaf a tensor there
    placed, _ = mgr.restore(tree, devices="cpu")
    assert all(isinstance(v, torch.Tensor) for v in placed.values())
    # the reference reads the port's checkpoint, leaf for leaf
    ref_tree = {"w": np.zeros((3, 4), np.float32), "ids": np.zeros(1),
                "count": np.int32(0)}
    got, step = RefManager(tmp_path, async_save=False).restore(ref_tree)
    assert step == 30 and np.array_equal(got["w"], tree["w"].numpy())
    assert np.array_equal(got["ids"], tree["ids"])


def test_restore_keeps_every_leaf_shape(tmp_path):
    """0-d leaves (GIN's ``eps``, a step count) come back 0-d, on the
    target's device and placed on an explicit one, as do (1,), (0,) and
    [2, 3] leaves."""
    mgr = CheckpointManager(tmp_path, async_save=False)
    tree = {"eps": torch.tensor(0.25), "count": torch.tensor(3, dtype=torch.int32),
            "one": torch.ones(1), "none": torch.zeros(0), "w": torch.ones(2, 3),
            "host": np.float32(2.0)}
    mgr.save(1, tree)
    for devices in (None, "cpu"):
        got, _ = mgr.restore(tree, devices=devices)
        for k, v in tree.items():
            assert tuple(got[k].shape) == tuple(np.shape(v)), k
            assert np.array_equal(np.asarray(got[k]), np.asarray(v)), k
        assert isinstance(got["eps"], torch.Tensor)


def test_checkpoint_async(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=1, async_save=True)
    tree = {"x": torch.ones((8, 8))}
    mgr.save(1, tree)
    mgr.wait()
    restored, _ = mgr.restore(tree)
    assert torch.equal(restored["x"], torch.ones((8, 8)))


def test_save_snapshots_tensors_updated_in_place_after_it(tmp_path):
    """A step that updates the state in place right after an async
    ``save`` (as the launcher's does) must not change what the save
    writes: the leaves are copied when ``save`` is called, also for CPU
    tensors, whose ``.numpy()`` would share their memory.  The writer is
    held until the update is done."""
    import threading

    mgr = CheckpointManager(tmp_path, keep=1, async_save=True)
    go = threading.Event()
    write = mgr._save_sync
    mgr._save_sync = lambda step, host_tree: (go.wait(10), write(step, host_tree))
    x = torch.arange(1 << 16, dtype=torch.float32)
    tree = {"x": x, "count": np.array(3, np.int32)}
    mgr.save(1, tree)
    x.mul_(-1.0)
    tree["count"] += 1
    go.set()
    mgr.wait()
    restored, _ = mgr.restore(tree)
    assert torch.equal(restored["x"], torch.arange(1 << 16, dtype=torch.float32))
    assert int(restored["count"]) == 3


def test_fault_tolerant_runner_determinism(tmp_path):
    """Training with a mid-run crash reaches the exact state of an
    uninterrupted run (checkpoint + deterministic data replay)."""

    def make(run_dir):
        def step(state, batch):
            new = {k: v + batch for k, v in state.items()}
            return new, {"loss": torch.tensor(float(batch))}

        mgr = CheckpointManager(run_dir, keep=2, async_save=False)
        return FaultTolerantRunner(step, mgr, save_every=5), {
            "w": torch.zeros(3)}

    def batches(step):
        return torch.tensor(float(step + 1))

    r1, s1 = make(tmp_path / "a")
    out1 = r1.run(s1, batches, 23)
    r2, s2 = make(tmp_path / "b")
    out2 = r2.run(s2, batches, 23, failure=SimulatedFailure(at_steps=(7, 13)))
    assert r2.stats.restarts == 2
    assert torch.equal(out1["w"], out2["w"])
    assert torch.equal(out1["w"], torch.full((3,), float(sum(range(1, 24)))))


def test_runner_restarts_from_step0_checkpoint(tmp_path):
    """A crash before the first periodic save restores the step-0 state."""

    def step(state, batch):
        return state + 1, {"loss": torch.tensor(0.0)}

    mgr = CheckpointManager(tmp_path, async_save=False)
    runner = FaultTolerantRunner(step, mgr, save_every=100)
    out = runner.run(torch.tensor(0, dtype=torch.int32), lambda s: None, 10,
                     failure=SimulatedFailure(at_steps=(3,)))
    assert int(out) == 10
    assert runner.stats.restarts == 1
    assert runner.stats.wasted_steps == 3


def test_restore_falls_back_past_corrupt_latest(tmp_path, capsys):
    mgr = CheckpointManager(tmp_path, keep=3, async_save=False)
    tree = {"w": np.arange(64, dtype=np.float32), "n": np.int64(0)}
    for step in (1, 2, 3):
        mgr.save(step, {"w": tree["w"] + step, "n": np.int64(step)})
    npz = tmp_path / "step_0000000003" / "arrays.npz"
    npz.write_bytes(npz.read_bytes()[:25])
    (tmp_path / "step_0000000002" / "manifest.json").write_text("{not json")
    restored, step = mgr.restore(tree)
    assert step == 1
    assert int(restored["n"]) == 1
    assert np.array_equal(np.asarray(restored["w"]), tree["w"] + 1)
    err = capsys.readouterr().err
    assert err.count("unreadable") == 2  # one warning per skipped step


def test_restore_explicit_step_does_not_fall_back(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3, async_save=False)
    tree = {"w": np.ones(8)}
    mgr.save(1, tree)
    mgr.save(2, tree)
    npz = tmp_path / "step_0000000002" / "arrays.npz"
    npz.write_bytes(npz.read_bytes()[:25])
    with pytest.raises(Exception):
        mgr.restore(tree, step=2)


def test_restore_raises_when_nothing_intact(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    tree = {"w": np.ones(4)}
    mgr.save(5, tree)
    (tmp_path / "step_0000000005" / "arrays.npz").write_bytes(b"junk")
    with pytest.raises(FileNotFoundError, match="no intact"):
        mgr.restore(tree)


def test_runner_final_save_dedupes(tmp_path):
    saves = []

    class CountingManager(CheckpointManager):
        def save(self, step, tree):
            saves.append(step)
            super().save(step, tree)

    def step(state, batch):
        return state + 1, {"loss": torch.tensor(0.0)}

    mgr = CountingManager(tmp_path, async_save=False)
    runner = FaultTolerantRunner(step, mgr, save_every=5)
    out = runner.run(torch.tensor(0, dtype=torch.int32), lambda s: None, 10)
    assert int(out) == 10
    assert saves == [0, 5, 10]


def test_run_stats_as_dict(tmp_path):
    def step(state, batch):
        return state + 1, {"loss": torch.tensor(0.0)}

    mgr = CheckpointManager(tmp_path, async_save=False)
    runner = FaultTolerantRunner(step, mgr, save_every=4)
    runner.run(torch.tensor(0, dtype=torch.int32), lambda s: None, 6,
               failure=SimulatedFailure(at_steps=(5,)))
    d = runner.stats.as_dict()
    assert d == {
        "steps_completed": 7,  # 6 forward + 1 replayed after the crash
        "restarts": 1,
        "wasted_steps": 1,
        "straggler_events": d["straggler_events"],
    }
    assert isinstance(d["straggler_events"], int)


def test_simulated_failure_probability_is_seeded():
    def fires(cls, seed):
        f = cls(probability=0.3, seed=seed)
        return [s for s in range(200) if f.should_fire(s)]

    a, b = fires(SimulatedFailure, 3), fires(SimulatedFailure, 3)
    assert a == b == fires(RefFailure, 3)  # the reference's schedule
    assert 20 < len(a) < 100
    assert fires(SimulatedFailure, 4) != a


def test_straggler_watchdog():
    wd = StragglerWatchdog(window=16, threshold=3.0)
    flagged = []
    for step in range(30):
        dt = 1.0 if step != 20 else 10.0
        if wd.record(step, dt):
            flagged.append(step)
    assert flagged == [20]
    assert wd.median == 1.0


def test_port_lm_checkpoint_restores_in_the_reference(tmp_path):
    """An LM launcher state (smoke qwen3-0.6b, two steps) saved by the port
    restores through the reference's ``CheckpointManager`` into the
    reference's state tree: every leaf equal, names and order included."""
    from repro.launch import train as rtrain

    from repro_torch.launch import train as ttrain

    state, step, batches, _ = ttrain.build_training("qwen3-0.6b", True, 2, 16,
                                                    device="cpu")
    for s in range(2):
        state, _ = step(state, batches(s))
    CheckpointManager(str(tmp_path), async_save=False).save(2, state)
    rstate, *_ = rtrain.build_training("qwen3-0.6b", True, 2, 16)
    restored, at = RefManager(str(tmp_path)).restore(rstate)
    assert at == 2 and int(restored[1]["count"]) == 2
    got, treedef = tree_flatten(state)
    want, ref_def = jax.tree_util.tree_flatten(restored)
    assert str(treedef) == str(ref_def)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))


def test_runner_keeps_no_state_alive_after_a_failure(tmp_path):
    """A run with a simulated failure holds no reference to its state once
    it returns: the exception's traceback (which holds the run's frame)
    is dropped, so no reference cycle keeps the state alive until a gc
    pass (on the card that is the whole training state)."""
    import gc
    import weakref

    def step(state, batch):
        return {"w": state["w"] + batch}, {"loss": state["w"].sum()}

    runner = FaultTolerantRunner(step, CheckpointManager(tmp_path, async_save=False),
                                 save_every=2)
    gc.disable()
    try:
        out = runner.run({"w": torch.zeros(4)}, lambda s: torch.ones(4), 4,
                         failure=SimulatedFailure(at_steps=(3,)))
        ref = weakref.ref(out["w"])
        del out
        assert ref() is None
    finally:
        gc.enable()
    assert runner.stats.restarts == 1


def test_tree_flatten_leaves_no_reference_cycle():
    """Flattening keeps no reference to the tree's leaves once its result
    is dropped (a recursive closure would, until a gc pass)."""
    import gc
    import weakref

    leaf = torch.zeros(3)
    ref = weakref.ref(leaf)
    gc.disable()
    try:
        out = tree_flatten({"a": [leaf, {"b": (leaf,)}]})
        del out, leaf
        assert ref() is None
    finally:
        gc.enable()
