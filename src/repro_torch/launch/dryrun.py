"""Multi-pod dry run: trace every (arch x shape x mesh) cell on fake devices.

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles each
cell for 256 or 512 placeholder devices.  Here each cell's step runs once
on fake tensors (``FakeTensorMode``: shapes and dtypes, no storage) over a
fake process group of 256 or 512 ranks (``launch.mesh.
make_production_mesh``), its inputs DTensors placed by the cell's spec
trees, under the dispatch walker (``launch.hlo_walker``), whose counts a
device give the roofline terms (``launch.analysis``).  Nothing is
allocated and no device is touched.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out experiments/dryrun_torch
Each cell writes one JSON file (``status`` ok, skipped or error, as the
reference's); a failing cell is recorded and the run goes on.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import traceback

import torch

from .. import obs
from ..configs import all_arch_ids, get_arch
from .analysis import roofline_terms, summarize
from .cells import build_cell
from .mesh import (
    _tree_map,
    from_local,
    local_shape,
    make_production_mesh,
    set_mesh,
    spec_to_placements,
)


def _place(tree, specs, mesh):
    """A tree of meta tensors -> fake DTensors placed by ``specs`` (local
    shards only); other leaves as they are."""
    def one(t, spec):
        if not isinstance(t, torch.Tensor):
            return t
        spec = spec if spec is not None else ()
        local = torch.empty(local_shape(t.shape, spec, mesh), dtype=t.dtype)
        return from_local(local, mesh.device_mesh,
                          spec_to_placements(spec, mesh, t.ndim), t.shape)

    return _tree_map(one, tree, specs)


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    total = 0

    def add(t, _):
        nonlocal total
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
        return t

    _tree_map(add, tree, None)
    return total


def trace_cell(cell, mesh) -> tuple[dict, float, float]:
    """Run ``cell.fn`` once on fake DTensors over ``mesh`` under the
    walker: -> (summary, seconds to place the inputs, seconds to run)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    from .hlo_walker import Walker

    t0 = obs.now()
    # real host constants (positions) may meet fake tensors
    with FakeTensorMode(allow_non_fake_inputs=True) as fake:
        args = tuple(_place(a, s, mesh) for a, s in zip(cell.args, cell.in_shardings))
        t_place = obs.now() - t0
        # a plain tensor made inside the step (offsets, masks) is the same
        # on every rank: a replicated DTensor
        with set_mesh(mesh), implicit_replication(), Walker(fake) as w:
            out = cell.fn(*args)
            if cell.out_shardings is not None:
                out = _tree_map(
                    lambda t, s: t.redistribute(t.device_mesh, spec_to_placements(
                        s, mesh, t.ndim)) if s is not None and hasattr(
                            t, "redistribute") else t,
                    out, cell.out_shardings)
        t_run = obs.now() - t0 - t_place
        summary = summarize(w.stats, mesh.size, _local_bytes(args), _local_bytes(out))
    return summary, t_place, t_run


def run_cell(arch_id: str, shape_name: str, mesh_name: str, out_dir: pathlib.Path) -> dict:
    bundle = get_arch(arch_id)
    shape = next(s for s in bundle.shapes if s.name == shape_name)
    tag = f"{arch_id}__{shape_name}__{mesh_name}"
    out_path = out_dir / f"{tag}.json"

    if shape.skip:
        rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
               "status": "skipped", "reason": shape.skip}
        out_path.write_text(json.dumps(rec, indent=2))
        print(f"[dryrun] SKIP {tag}: {shape.skip}")
        return rec

    try:
        mesh = make_production_mesh(multi_pod=(mesh_name == "multi"))
        cell = build_cell(bundle, shape, mesh, mesh_name)
        summary, t_lower, t_compile = trace_cell(cell, mesh)
        terms = roofline_terms(summary, cell.model_flops)
        rec = {
            "arch": arch_id, "shape": shape_name, "mesh": mesh_name,
            "status": "ok", "t_lower_s": t_lower, "t_compile_s": t_compile,
            "model_flops": cell.model_flops, "meta": cell.meta,
            "summary": summary, "roofline": terms,
        }
    except Exception as e:  # noqa: BLE001 -- record the failure, keep going
        rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
        print(f"[dryrun] ERROR {tag}: {e}")
    out_path.write_text(json.dumps(rec, indent=2, default=str))
    dom = rec.get("roofline", {}).get("dominant", "-")
    print(f"[dryrun] {rec['status']:7s} {tag} dominant={dom} "
          f"({rec.get('t_compile_s', 0):.1f}s traced)", flush=True)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    targets = []
    if args.all:
        for arch_id in all_arch_ids():
            for s in get_arch(arch_id).shapes:
                for m in meshes:
                    targets.append((arch_id, s.name, m))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all required")
        for m in meshes:
            targets.append((args.arch, args.shape, m))

    n_ok = n_err = n_skip = 0
    for arch_id, shape_name, mesh_name in targets:
        tag = f"{arch_id}__{shape_name}__{mesh_name}"
        if args.skip_existing and (out_dir / f"{tag}.json").exists():
            prev = json.loads((out_dir / f"{tag}.json").read_text())
            if prev.get("status") in ("ok", "skipped"):
                print(f"[dryrun] cached  {tag}")
                continue
        rec = run_cell(arch_id, shape_name, mesh_name, out_dir)
        n_ok += rec["status"] == "ok"
        n_err += rec["status"] == "error"
        n_skip += rec["status"] == "skipped"
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_err} errors")


if __name__ == "__main__":
    main()
