"""Fault-tolerant checkpointing.

Counterpart of ``repro/checkpoint/manager.py``, with the same on-disk
format, so a checkpoint either package writes restores in the other:

  * atomic writes (tmp directory + rename) -- a killed host never corrupts
    the latest checkpoint;
  * retention of the last ``keep`` checkpoints;
  * async save (background thread) so the caller is not blocked;
  * leaves are stored logically (full host arrays, copied when ``save``
    is called); ``restore(..., devices=)`` places them on the
    target devices, so a job may restart on another device layout;
  * integer arrays that are strictly increasing are stored OptVB-packed
    with the paper's optimal partitioning -- the framework's own codec.

The tree is flattened as jax flattens a pytree (``tree_flatten``): dict
keys in sorted order, lists and tuples in order, None a node without
leaves, anything else a leaf.  The manifest's ``treedef`` is the string
jax prints for the same structure, so it names every key.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import sys
import threading
import time
import zipfile

import numpy as np
import torch

from .. import obs
from ..core import build_partitioned_index
from ..core.index import PartitionedIndex


# --------------------------------------------------------------------------
# the pytree flatten of dicts, lists and tuples
# --------------------------------------------------------------------------
class TreeDef:
    """The structure of a flattened tree: ``kind`` is "dict", "list",
    "tuple", "none" or "leaf"; dicts keep their sorted keys."""

    def __init__(self, kind: str, keys=(), children=()):
        self.kind = kind
        self.keys = tuple(keys)
        self.children = tuple(children)

    def __str__(self) -> str:
        return f"PyTreeDef({self._body()})"

    def _body(self) -> str:
        if self.kind == "leaf":
            return "*"
        if self.kind == "none":
            return "None"
        inner = [c._body() for c in self.children]
        if self.kind == "dict":
            return "{" + ", ".join(
                f"{k!r}: {b}" for k, b in zip(self.keys, inner)
            ) + "}"
        if self.kind == "list":
            return "[" + ", ".join(inner) + "]"
        return "(" + ", ".join(inner) + ("," if len(inner) == 1 else "") + ")"

    def unflatten(self, leaves):
        it = iter(leaves)
        out = self._build(it)
        if next(it, _END) is not _END:
            raise ValueError("more leaves than the tree structure holds")
        return out

    def _build(self, it):
        if self.kind == "leaf":
            leaf = next(it, _END)
            if leaf is _END:
                raise ValueError("fewer leaves than the tree structure holds")
            return leaf
        if self.kind == "none":
            return None
        kids = [c._build(it) for c in self.children]
        if self.kind == "dict":
            return dict(zip(self.keys, kids))
        return kids if self.kind == "list" else tuple(kids)


_END = object()


def tree_flatten(tree) -> tuple[list, TreeDef]:
    """(leaves, treedef), leaves in jax's order (dict keys sorted)."""
    leaves: list = []
    return leaves, _walk(tree, leaves)


def _walk(node, leaves: list) -> TreeDef:
    # a module-level function, not a recursive closure: a closure that
    # calls itself is a reference cycle, which would keep ``leaves`` (and
    # every tensor of the tree, on the card too) alive until a gc pass
    if node is None:
        return TreeDef("none")
    if isinstance(node, dict):
        keys = sorted(node)
        return TreeDef("dict", keys, [_walk(node[k], leaves) for k in keys])
    if isinstance(node, (list, tuple)):
        kind = "list" if isinstance(node, list) else "tuple"
        return TreeDef(kind, (), [_walk(c, leaves) for c in node])
    leaves.append(node)
    return TreeDef("leaf")


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping its structure."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return treedef.unflatten(
        [fn(x, *(o[i] for o in others)) for i, x in enumerate(leaves)]
    )


def _to_host(leaf):
    """A host copy of one leaf, taken when ``save`` is called: a CPU
    tensor's ``.numpy()`` would share its memory, so a step that updates
    it in place during an async save would change what is written."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


# --------------------------------------------------------------------------
# OptVB packing of sorted integer arrays
# --------------------------------------------------------------------------
def pack_sorted_int_array(arr: np.ndarray) -> dict:
    """Pack a strictly-increasing int array with the paper's codec."""
    idx = build_partitioned_index([np.asarray(arr, dtype=np.int64)], "optimal")
    return {
        "kind": "optvb",
        "n": int(arr.size),
        "endpoints": idx.endpoints,
        "sizes": idx.sizes,
        "tags": idx.tags,
        "offsets": idx.offsets,
        "payload": idx.payload,
        "list_part_offsets": idx.list_part_offsets,
        "list_sizes": idx.list_sizes,
    }


def unpack_sorted_int_array(packed: dict) -> np.ndarray:
    idx = PartitionedIndex(
        n_lists=1,
        list_part_offsets=packed["list_part_offsets"],
        list_sizes=packed["list_sizes"],
        endpoints=packed["endpoints"],
        sizes=packed["sizes"],
        tags=packed["tags"],
        offsets=packed["offsets"],
        payload=packed["payload"],
    )
    return idx.host_engine.decode_list(0)


def _is_strictly_increasing(a: np.ndarray) -> bool:
    return a.ndim == 1 and a.size > 1 and bool(np.all(a[1:] > a[:-1]))


# everything a corrupt/truncated checkpoint can throw at restore time: bad
# zip central directory (truncated npz), short member payload or shape
# mismatch (ValueError), missing npz keys (KeyError), unreadable files
# (OSError), bad JSON (json.JSONDecodeError is a ValueError)
RESTORE_ERRORS = (OSError, ValueError, KeyError, zipfile.BadZipFile)


# --------------------------------------------------------------------------
# Manager
# --------------------------------------------------------------------------
class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None

    # ---------------- save ----------------
    def save(self, step: int, tree) -> None:
        host_tree = tree_map(_to_host, tree)
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._save_sync, args=(step, host_tree), daemon=True
            )
            self._thread.start()
        else:
            self._save_sync(step, host_tree)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _save_sync(self, step: int, host_tree) -> None:
        with obs.timer("checkpoint_save_ms"):
            leaves, treedef = tree_flatten(host_tree)
            arrays = {}
            manifest = {"step": step, "treedef": str(treedef), "leaves": []}
            for i, leaf in enumerate(leaves):
                leaf = np.asarray(leaf)
                entry = {"i": i, "dtype": str(leaf.dtype), "shape": list(leaf.shape)}
                if leaf.dtype.kind in "iu" and _is_strictly_increasing(leaf):
                    packed = pack_sorted_int_array(leaf)
                    entry["codec"] = "optvb"
                    for k, v in packed.items():
                        if isinstance(v, np.ndarray):
                            arrays[f"l{i}_{k}"] = v
                        else:
                            entry[k] = v
                else:
                    entry["codec"] = "raw"
                    arrays[f"l{i}"] = leaf
                manifest["leaves"].append(entry)

            tmp = self.dir / f".tmp-{step}-{time.time_ns()}"
            tmp.mkdir()
            np.savez(tmp / "arrays.npz", **arrays)
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            final = self.dir / f"step_{step:010d}"
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)  # atomic publish
            self._gc()
        if obs.enabled():
            obs.count(
                "checkpoint_saved_bytes",
                sum(a.nbytes for a in arrays.values()),
            )
            obs.count("checkpoint_saves")

    def _gc(self) -> None:
        ckpts = sorted(self.dir.glob("step_*"))
        for old in ckpts[: -self.keep]:
            shutil.rmtree(old, ignore_errors=True)

    # ---------------- restore ----------------
    def steps(self) -> list[int]:
        """All retained checkpoint steps, ascending."""
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob("step_*"))

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def manifest(self, step: int) -> dict:
        """Parsed manifest of one retained step (raises if unreadable)."""
        path = self.dir / f"step_{step:010d}" / "manifest.json"
        return json.loads(path.read_text())

    def restore(self, target_tree, step: int | None = None, devices=None):
        """Load into the structure of ``target_tree``.

        A leaf comes back as a tensor where the target's leaf is a tensor
        (on the target's device), else as a numpy array.  ``devices``: one
        torch device, or a tree of them matching ``target_tree``, to place
        every leaf on instead (restore onto another device layout).

        With ``step=None`` a corrupt or truncated newest checkpoint (bad
        JSON, short zip payload, missing members) is SKIPPED with a warning
        and the newest *intact* retained step restores instead.  An
        explicit ``step`` never falls back: the caller asked for that exact
        state.
        """
        if step is not None:
            return self._restore_step(target_tree, step, devices)
        steps = self.steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        last_err: Exception | None = None
        for s in reversed(steps):
            try:
                return self._restore_step(target_tree, s, devices)
            except RESTORE_ERRORS as e:
                print(
                    f"[ckpt] step {s} unreadable ({type(e).__name__}: {e}); "
                    "falling back to the previous retained step",
                    file=sys.stderr,
                )
                last_err = e
        raise FileNotFoundError(
            f"no intact checkpoint in {self.dir}"
        ) from last_err

    def _restore_step(self, target_tree, step: int, devices=None):
        path = self.dir / f"step_{step:010d}"
        nbytes = 0
        with obs.timer("checkpoint_restore_ms"):
            manifest = json.loads((path / "manifest.json").read_text())
            data = np.load(path / "arrays.npz")
            leaves_t, treedef = tree_flatten(target_tree)
            if len(manifest["leaves"]) != len(leaves_t):
                raise ValueError(
                    f"checkpoint holds {len(manifest['leaves'])} leaves, the "
                    f"target tree {len(leaves_t)}"
                )
            if devices is None:
                devs = [t.device if isinstance(t, torch.Tensor) else None
                        for t in leaves_t]
            elif isinstance(devices, (str, torch.device)):
                devs = [torch.device(devices)] * len(leaves_t)
            else:
                devs = tree_flatten(devices)[0]
            out = []
            for entry, dev in zip(manifest["leaves"], devs):
                i = entry["i"]
                if entry["codec"] == "optvb":
                    packed = {k: data[f"l{i}_{k}"] for k in
                              ("endpoints", "sizes", "tags", "offsets", "payload",
                               "list_part_offsets", "list_sizes")}
                    arr = unpack_sorted_int_array(packed).astype(entry["dtype"])
                else:
                    arr = data[f"l{i}"]
                nbytes += arr.nbytes
                arr = arr.reshape(entry["shape"])
                if dev is not None:
                    arr = torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
                out.append(arr)
            tree = treedef.unflatten(out)
        if obs.enabled():
            obs.count("checkpoint_restored_bytes", nbytes)
            obs.count("checkpoint_restores")
        return tree, step
