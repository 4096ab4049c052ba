"""The port's mesh layer against the JAX package, in this process: the
partition specs, the spec functions of the three model families, every
cell of ``launch.cells.build_cell`` on the two production meshes (abstract:
no devices), the dispatch walker (``test_hlo_walker.py``'s four cases),
the collectives' wire bytes on a fake 8-rank mesh, the roofline constants
and the dry-run CLI.  The several-rank runs are in
``test_torch_mesh_paths.py``.

Everything here is compared exactly: specs entry for entry, FLOP
estimates, metas, shapes and dtypes.
"""

import contextlib
import dataclasses
import datetime
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, AxisType
from jax.sharding import PartitionSpec as JP

from repro.configs import all_arch_ids as ref_all_arch_ids
from repro.configs import get_arch as ref_get_arch
from repro.launch import mesh as ref_mesh
from repro.launch.cells import build_cell as ref_build_cell
from repro.models import gnn as RG
from repro.models import recsys as RR
from repro.models import transformer as RT

from repro_torch.configs import all_arch_ids, get_arch
from repro_torch.launch import analysis, dryrun, hlo_walker
from repro_torch.launch import mesh as M
from repro_torch.launch.cells import build_cell
from repro_torch.models import gnn as TG
from repro_torch.models import recsys as TR
from repro_torch.models import transformer as TT

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
CELLS = [(a, s.name) for a in ref_all_arch_ids() for s in ref_get_arch(a).shapes
         if not s.skip]


def _norm(t):
    """Spec trees as plain nests: a spec (either package's) as its entries."""
    if isinstance(t, (JP, M.PartitionSpec)):
        return ("P", tuple(t))
    if isinstance(t, dict):
        return {k: _norm(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_norm(v) for v in t]
    return t


def _shapes(t):
    """Shape/dtype trees as plain nests of (shape, dtype name)."""
    if isinstance(t, dict):
        return {k: _shapes(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_shapes(v) for v in t]
    return (tuple(t.shape), str(t.dtype).replace("torch.", ""))


@contextlib.contextmanager
def one_rank_mesh(tmp_path):
    """A 1 x 1 host mesh over a 1-rank ``gloo`` group (a ``FileStore``
    under ``tmp_path``), destroyed after."""
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield M.make_host_mesh(1, 1)
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def fake_group(world: int):
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# specs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("entries", [(), (None,), ("data",), (("data",), None),
                                     (None, ("pod", "data"), "model"),
                                     (("model", "data"), None), ((), "model")])
def test_partition_spec_prints_and_normalises_as_jax(entries):
    got, want = M.P(*entries), JP(*entries)
    assert repr(got) == repr(want) and str(got) == str(want)
    assert tuple(got) == tuple(want)


def test_mesh_helpers_match_the_reference():
    for sizes, names in MESHES.values():
        rm = AbstractMesh(sizes, names, axis_types=(AxisType.Auto,) * len(names))
        tm = M.Mesh(sizes, names)
        assert M.data_axes(tm) == ref_mesh.data_axes(rm)
        assert M.data_size(tm) == ref_mesh.data_size(rm)
        assert M.tp_size(tm) == ref_mesh.tp_size(rm)
        assert [M.axis_size(tm, a) for a in names] == list(sizes)
    assert M.tp_size(M.Mesh((4,), ("data",))) == 1
    assert M.keep_axes(M.P(("pod", "data"), None, "model"),
                       M.Mesh((16, 16), ("data", "model"))) == M.P("data", None, "model")
    with pytest.raises(ValueError, match="abstract"):
        M.Mesh((2,), ("data",)).coordinate()


def test_roofline_constants_are_the_cards():
    # NVIDIA H100 80GB HBM3 (SXM, 700 W): dense bf16, HBM3, NVLink a direction
    assert (M.PEAK_FLOPS_BF16, M.HBM_BW, M.ICI_BW) == (989.4e12, 3.35e12, 450e9)
    summary = {"flops_per_device": 989.4e12, "bytes_per_device": 2 * 3.35e12,
               "collective_wire_bytes_per_device": 0.5 * 450e9, "n_devices": 2}
    t = analysis.roofline_terms(summary, model_flops_total=989.4e12)
    assert (t["t_compute_s"], t["t_memory_s"], t["t_collective_s"]) == (1.0, 2.0, 0.5)
    assert t["dominant"] == "memory" and t["bound_step_time_s"] == 2.0
    assert t["useful_flops_ratio"] == 0.5 and t["roofline_fraction"] == 0.25


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
@pytest.mark.parametrize("tp", [1, 2, 4, 16])
def test_model_spec_functions_match_the_reference(full, tp):
    for arch in all_arch_ids():
        rb, tb = ref_get_arch(arch), get_arch(arch)
        rc, tc = (rb.full, tb.full) if full else (rb.smoke, tb.smoke)
        if tb.family == "lm":
            assert _norm(TT.param_specs(tc, tp=tp)) == _norm(RT.param_specs(rc, tp=tp))
            assert _shapes(TT.init_params_shape_tree(tc)) == _shapes(jax.eval_shape(
                lambda k: RT.init_params(k, rc), jax.random.PRNGKey(0)))
            for kind in ("train", "prefill", "decode"):
                assert _shapes(TT.input_specs(tc, kind, 64, 2)) == _shapes(
                    RT.input_specs(rc, kind, 64, 2)), (arch, kind)
        elif tb.family == "gnn":
            for readout in (False, True):
                r2 = dataclasses.replace(rc, graph_readout=readout)
                t2 = dataclasses.replace(tc, graph_readout=readout)
                assert _norm(TG.param_specs(t2)) == _norm(RG.param_specs(r2))
                assert _shapes(TG.input_specs(t2, 96, 512, 8)) == _shapes(
                    RG.input_specs(r2, 96, 512, 8))
                for axes in (("data",), ("pod", "data")):
                    assert _norm(TG.batch_specs(t2, axes)) == _norm(RG.batch_specs(r2, axes))
                assert _norm(TG.batch_specs_sharded(t2)) == _norm(RG.batch_specs_sharded(r2))
        else:
            assert _norm(TR.param_specs(tc)) == _norm(RR.param_specs(rc))
            for kind in ("train", "serve", "retrieval"):
                assert _shapes(TR.input_specs(tc, kind, 8, 32)) == _shapes(
                    RR.input_specs(rc, kind, 8, 32)), (arch, kind)
                for axes in (("data",), ("pod", "data")):
                    assert _norm(TR.batch_specs(tc, kind, axes)) == _norm(
                        RR.batch_specs(rc, kind, axes))


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_cell_matches_the_reference_on_both_production_meshes(arch, shape):
    rb, tb = ref_get_arch(arch), get_arch(arch)
    rs = next(s for s in rb.shapes if s.name == shape)
    ts = next(s for s in tb.shapes if s.name == shape)
    for name, (sizes, names) in MESHES.items():
        rm = AbstractMesh(sizes, names, axis_types=(AxisType.Auto,) * len(names))
        r = ref_build_cell(rb, rs, rm, name)
        t = build_cell(tb, ts, M.Mesh(sizes, names), name)
        assert (t.arch_id, t.shape_name, t.mesh_name) == (arch, shape, name)
        assert t.model_flops == r.model_flops
        assert t.meta == r.meta
        assert _norm(t.in_shardings) == _norm(r.in_shardings)
        assert _norm(t.out_shardings) == _norm(r.out_shardings)
        assert _args(t.args) == _args(r.args), name


def _args(t):
    """A cell's arguments as shapes and dtypes; a 0-d int32 (an optimizer
    count, a decode position) as "host int": the port keeps those on the
    host."""
    if isinstance(t, dict):
        return {k: _args(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_args(v) for v in t]
    if isinstance(t, int) or (tuple(t.shape) == () and "int32" in str(t.dtype)):
        return "host int"
    return (tuple(t.shape), str(t.dtype).replace("torch.", ""))


def test_every_arch_has_its_cells():
    assert len(CELLS) == 36
    assert all_arch_ids() == ref_all_arch_ids()


# --------------------------------------------------------------------------
# the walker (test_hlo_walker.py's cases)
# --------------------------------------------------------------------------

def test_walker_counts_a_matmul():
    x, w = torch.randn(256, 128), torch.randn(128, 64)
    st = hlo_walker.walk(lambda: x @ w)
    assert st.dot_flops == 2 * 256 * 128 * 64
    assert st.while_trip_counts == []


def test_walker_counts_every_loop_step():
    c, w = torch.randn(128, 128), torch.randn(128, 128)

    def f(c):
        for _ in range(10):
            c = torch.tanh(c @ w)
        return c

    assert hlo_walker.walk(f, c).dot_flops == 10 * 2 * 128**3


def test_walker_counts_nested_loops():
    c, w = torch.randn(128, 128), torch.randn(128, 128)

    def f(c):
        for _ in range(4):
            for _ in range(5):
                c = torch.tanh(c @ w)
        return c

    assert hlo_walker.walk(f, c).dot_flops == 20 * 2 * 128**3


def test_walker_counts_gathered_rows_not_the_table():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as fake:
        table = torch.empty(100_000, 128)
        ids = torch.zeros(64, dtype=torch.long)
        st = hlo_walker.walk(lambda: table.index_select(0, ids), fake_mode=fake)
    # 2 x gathered rows (64 x 128 x 4 B), NOT the 51 MB table
    assert 0 < st.hbm_bytes_ideal <= 4 * 64 * 128 * 4
    assert st.hbm_bytes > 100_000 * 128 * 4  # op-by-op traffic reads the table


@pytest.mark.parametrize("case", ["rows", "contraction", "replicated"])
def test_walker_counts_one_devices_share_of_a_dtensor_matmul(case):
    """On a fake 8-rank group, a DTensor matmul counts the local matmul
    once: an eighth of the global FLOPs when an operand is sharded (DTensor's
    shape propagation on global fake tensors is not counted), the whole
    when both operands are replicated (every rank does all the work)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard

    x_pl, w_pl, share = {"rows": (Shard(0), Replicate(), 8),
                         "contraction": (Shard(1), Shard(0), 8),
                         "replicated": (Replicate(), Replicate(), 1)}[case]
    def local(shape, pl):
        shape = list(shape)
        if isinstance(pl, Shard):
            shape[pl.dim] //= 8
        return torch.empty(shape)

    with fake_group(8):
        dm = init_device_mesh("cpu", (8,), mesh_dim_names=("data",))
        with FakeTensorMode() as fake:
            x = M.from_local(local((256, 128), x_pl), dm, [x_pl], (256, 128))
            w = M.from_local(local((128, 64), w_pl), dm, [w_pl], (128, 64))
            with hlo_walker.Walker(fake) as walker:
                y = x @ w
            assert tuple(y.shape) == (256, 64)
    assert walker.stats.dot_flops == 2 * 256 * 128 * 64 / share


def test_collective_wire_bytes_follow_the_ring_formulas():
    with fake_group(8):
        mesh = M.make_host_mesh(4, 2)
        with hlo_walker.Walker() as w:
            M.all_gather(torch.zeros(16, 8), "model", mesh)  # 1,024 B result
            M.all_to_all(torch.zeros(8, 4), ("model", "data"), mesh)  # 128 B
            M.psum(torch.zeros(10), "data", mesh)  # 40 B
    st = w.stats
    assert st.coll_counts == {"all-gather": 1, "all-to-all": 1, "all-reduce": 1}
    assert st.coll_result_bytes == {"all-gather": 1024, "all-to-all": 128,
                                    "all-reduce": 40}
    assert st.coll_wire_bytes == 1024 * 1 / 2 + 128 * 7 / 8 + 2 * 40 * 3 / 4
    summ = analysis.summarize(st, 8)
    coll = analysis.parse_collectives([("reduce-scatter", 64, 4)])
    assert coll.wire_bytes_per_device == 64 * 3
    assert summ["collective_wire_bytes_per_device"] == st.coll_wire_bytes
    assert summ["while_trip_counts"] == [] and summ["n_devices"] == 8


# --------------------------------------------------------------------------
# the dry-run CLI
# --------------------------------------------------------------------------

def test_dryrun_cli_writes_ok_and_skipped_records(tmp_path):
    try:
        dryrun.main(["--arch", "gin-tu", "--shape", "molecule", "--mesh", "single",
                     "--out", str(tmp_path)])
        dryrun.main(["--arch", "qwen3-0.6b", "--shape", "long_500k", "--mesh",
                     "both", "--out", str(tmp_path)])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    ok = json.loads((tmp_path / "gin-tu__molecule__single.json").read_text())
    assert ok["status"] == "ok", ok.get("error")
    assert ok["summary"]["n_devices"] == 256
    assert ok["summary"]["flops_per_device"] > 0
    assert ok["roofline"]["dominant"] in ("compute", "memory", "collective")
    ref = ref_build_cell(ref_get_arch("gin-tu"), next(
        s for s in ref_get_arch("gin-tu").shapes if s.name == "molecule"),
        AbstractMesh((16, 16), ("data", "model"), axis_types=(AxisType.Auto,) * 2),
        "single")
    assert ok["model_flops"] == ref.model_flops and ok["meta"] == ref.meta
    for mesh in ("single", "multi"):
        sk = json.loads((tmp_path / f"qwen3-0.6b__long_500k__{mesh}.json").read_text())
        assert sk["status"] == "skipped" and sk["reason"].startswith("pure full-attention")


# one cell of each family, whose useful-FLOPs ratio the reference's dry run
# gives (XLA's cost analysis of the cell compiled for 512 placeholder CPU
# devices): qwen3's decode and gin-tu's molecule replicate most of their
# work on every device in both packages, dcn-v2's sparse step none of it
RATIO_CELLS = [("qwen3-0.6b", "decode_32k"), ("gin-tu", "molecule"),
               ("dcn-v2", "train_batch")]
# cells whose device once did work the reference's plan shards, or failed
# where the reference's record is ok: each now gives a record with at most
# 1% over the reference's FLOPs a device and at most 4x its wire bytes.
# dcn-v2 scored every candidate on every device (16x); din and bst failed
# to view their sharded candidates; mixtral's one-token MoE failed to view
# a size-1 group sharded over data; mixtral's decode gathered its cache's
# slots to every device (86x the wire), moonshot's moved its experts'
# weights by all-gathers (8x).
BOUND_CELLS = [("din", "retrieval_cand"), ("bst", "retrieval_cand"),
               ("dcn-v2", "retrieval_cand"), ("mixtral-8x22b", "long_500k"),
               ("mixtral-8x22b", "decode_32k"), ("moonshot-v1-16b-a3b", "decode_32k")]
_REF_DRYRUN = """
import sys
from repro.launch import dryrun  # sets XLA_FLAGS before jax starts
import pathlib
for cell in sys.argv[2:]:
    arch, shape = cell.split(":")
    dryrun.run_cell(arch, shape, "single", pathlib.Path(sys.argv[1]))
"""


@pytest.fixture(scope="module")
def reference_ratios(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref_dryrun")
    root = pathlib.Path(__file__).parent.parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _REF_DRYRUN, str(out),
         *(f"{a}:{s}" for a, s in RATIO_CELLS + BOUND_CELLS)],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return {(a, s): json.loads((out / f"{a}__{s}__single.json").read_text())
            for a, s in RATIO_CELLS + BOUND_CELLS}


@pytest.mark.parametrize("arch,shape", RATIO_CELLS, ids=[a for a, _ in RATIO_CELLS])
def test_dryrun_useful_flops_ratio_is_the_references(arch, shape, reference_ratios,
                                                     tmp_path):
    """The dry run's per-device FLOPs, and so its useful-FLOPs ratio, within
    1% of the reference's on the same cell: a device that counted an op
    twice (DTensor's shape propagation) or did work the reference shards
    would be off by 2x to 256x."""
    ref = reference_ratios[(arch, shape)]
    try:
        rec = dryrun.run_cell(arch, shape, "single", tmp_path)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert rec["status"] == "ok" and ref["status"] == "ok", rec.get("error")
    got, want = rec["roofline"]["useful_flops_ratio"], ref["roofline"]["useful_flops_ratio"]
    assert abs(got / want - 1) < 0.01, (got, want)
    assert rec["model_flops"] == ref["model_flops"]


@pytest.mark.parametrize("arch,shape", BOUND_CELLS, ids=[f"{a}-{s}" for a, s in BOUND_CELLS])
def test_dryrun_flops_a_device_are_at_most_the_references(arch, shape, reference_ratios,
                                                          tmp_path):
    """Each cell gives a record where the reference's does, and no device
    does more work than the reference's plan gives it: the port's FLOPs a
    device at most 1% over the reference's (below is the port's own plan:
    DTensor may split a product XLA keeps whole), its wire bytes a device
    at most 4x (they are counted another way: each collective the walker
    sees, against XLA's after fusion)."""
    ref = reference_ratios[(arch, shape)]
    try:
        rec = dryrun.run_cell(arch, shape, "single", tmp_path)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert ref["status"] == "ok", ref.get("error")
    assert rec["status"] == "ok", rec.get("error")
    got, want = rec["summary"]["flops_per_device"], ref["summary"]["flops_per_device"]
    assert got <= 1.01 * want, (got, want)
    wire = "collective_wire_bytes_per_device"
    assert rec["summary"][wire] <= 4 * ref["summary"][wire], (rec["summary"][wire],
                                                              ref["summary"][wire])
    assert rec["model_flops"] == ref["model_flops"]


# --------------------------------------------------------------------------
# one rank: the mesh paths equal the paths without a mesh
# --------------------------------------------------------------------------

def test_shard_map_on_one_rank_is_the_function(tmp_path):
    with one_rank_mesh(tmp_path) as mesh:
        x = torch.arange(12.0).reshape(4, 3).requires_grad_()
        f = M.shard_map(lambda a: M.psum((a * a).sum(), ("data", "model")), mesh,
                        (M.P(("model", "data"), None),), M.P())
        out = f(x)
        (g,) = torch.autograd.grad(out, [x])
        assert float(out.detach()) == float((x * x).sum())
        assert torch.equal(g, 2 * x.detach())
        assert M.get_abstract_mesh() is None
        with M.set_mesh(mesh):
            assert M.get_abstract_mesh() is mesh
            assert M.axis_index(("data", "model")) == 0


def test_compressed_psum_on_one_rank(tmp_path):
    from repro_torch.optim.compress import compressed_psum, ef_init

    g = {"a": torch.from_numpy(np.random.default_rng(0).normal(size=(16, 8)).astype(
        np.float32)), "b": [torch.ones(3)]}
    with one_rank_mesh(tmp_path) as mesh:
        out, ef = compressed_psum(g, ef_init(g), mesh, ("data",))
    for k in ("a",):
        x = g[k]
        scale = torch.clamp_min(x.abs().max(), 1e-12) / 127.0
        q = torch.clamp(torch.round(x / scale), -127, 127)
        assert torch.equal(out[k], q * scale)
        assert torch.equal(ef[k], x - q * scale)
    assert torch.equal(out["b"][0], torch.ones(3)) and not ef["b"][0].any()
