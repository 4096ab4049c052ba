"""Arena checkpointing through ``CheckpointManager``.

Counterpart of ``repro/core/arena_ckpt.py``, writing and reading the same
checkpoint layout (a checkpoint of either package restores in the other).
The checkpoint manager gives atomic publish, retention, async save and
OptVB packing of strictly-increasing int leaves; this module maps the
block arena onto it so a lost shard's sub-arena can be re-served from
disk:

* ``arena_to_tree`` / ``tree_to_arena`` -- the ``DeviceArena`` (+ ranked
  sidecar) as a flat dict of numpy leaves.  The manager then OptVB-packs
  the monotone sidecars (``block_keys``, ``first_blk``, per-list block
  offsets...) with the paper's own codec, so the checkpoint stays close to
  the arena's compressed size -- recovery I/O is bounded by the index
  size, not a decoded blowup.
* ``save_arena`` / ``restore_arena`` -- whole-arena checkpoint/restore,
  skipping corrupt retained steps like ``CheckpointManager.restore``.
* ``restore_shard`` -- ONE shard's sub-arena from a GLOBAL checkpoint,
  re-routed through the splitmix64 replica placement: the target shard
  count / replica factor may differ from the serving layout at save time
  (the serving analog of restoring onto a new device layout).

Only the global arena is checkpointed: every shard is a pure row gather
of it (``core.shard._slice_arena``), so per-shard checkpoints would be
redundant bytes and would pin the save-time shard count.  Everything here
is host numpy: a restored sub-arena is uploaded by its caller.
"""

from __future__ import annotations

import sys

import numpy as np

from .arena import DeviceArena, RankedSidecar

# leaf names of the two tree shapes; a dict's treedef is its sorted key
# set, so templates built from these restore any checkpoint of that shape
UNRANKED_KEYS = (
    "bases_p1",
    "block_base",
    "block_keys",
    "data",
    "device_ok",
    "first_blk",
    "lane_valid",
    "lens",
    "list_blk_offsets",
    "n_blk",
    "n_blocks",
    "part_list",
    "part_of_block",
    "sizes",
    "stride",
)
# multi-codec arenas append their codec split + EF tiles
MULTICODEC_KEYS = (
    "block_codec",
    "codec_row",
    "ef_hi",
    "ef_lbits",
    "ef_lo",
)
RANKED_KEYS = UNRANKED_KEYS + (
    "bm25_b",
    "bm25_k1",
    "block_max_q",
    "bound_scale",
    "freq_data",
    "freq_lens",
    "idf",
    "kmin",
    "kstep",
    "list_ub",
    "norm_q",
    "norm_table",
)


def arena_to_tree(a: DeviceArena) -> dict:
    """The arena as a flat dict of numpy leaves (checkpoint layout).

    ``bases`` starts at -1 (docID before the first partition), so it is
    stored shifted (+1) as ``bases_p1``: the manager's OptVB packer codes
    the first gap from -1, and a leading -1 would make that gap 0 -- the
    shift keeps single-list arenas (where ``bases`` is strictly
    increasing) packable by the paper's codec.
    """
    tree = {
        "lens": a.lens,
        "data": a.data,
        "block_base": a.block_base,
        "block_keys": a.block_keys,
        "lane_valid": a.lane_valid,
        "part_of_block": a.part_of_block,
        "first_blk": a.first_blk,
        "n_blk": a.n_blk,
        "sizes": a.sizes,
        "bases_p1": a.bases + 1,
        "part_list": a.part_list,
        "list_blk_offsets": a.list_blk_offsets,
        "stride": np.int64(a.stride),
        "n_blocks": np.int64(a.n_blocks),
        "device_ok": np.bool_(a.device_ok),
    }
    if a.ranked is not None:
        r = a.ranked
        tree.update(
            freq_lens=r.freq_lens,
            freq_data=r.freq_data,
            norm_q=r.norm_q,
            block_max_q=r.block_max_q,
            bound_scale=np.float32(r.bound_scale),
            idf=r.idf,
            list_ub=r.list_ub,
            kmin=np.float32(r.kmin),
            kstep=np.float32(r.kstep),
            norm_table=r.norm_table,
            bm25_k1=np.float64(r.params.k1),
            bm25_b=np.float64(r.params.b),
        )
    if a.block_codec is not None:
        tree.update(
            block_codec=a.block_codec,
            codec_row=a.codec_row,
            ef_lo=a.ef_lo,
            ef_hi=a.ef_hi,
            ef_lbits=a.ef_lbits,
        )
    return tree


def arena_template(ranked: bool, multi: bool = False) -> dict:
    """Same-treedef dummy tree for ``CheckpointManager.restore`` (which
    needs the target STRUCTURE only; leaf values are ignored)."""
    z = np.zeros(0, np.int64)
    keys = RANKED_KEYS if ranked else UNRANKED_KEYS
    if multi:
        keys = keys + MULTICODEC_KEYS
    return {k: z for k in keys}


def tree_to_arena(tree: dict) -> DeviceArena:
    """Rebuild a host ``DeviceArena`` (+ ranked sidecar) from its tree."""
    ranked = None
    if "freq_lens" in tree:
        from ..ranked.bm25 import BM25Params

        ranked = RankedSidecar(
            freq_lens=np.asarray(tree["freq_lens"]),
            freq_data=np.asarray(tree["freq_data"]),
            norm_q=np.asarray(tree["norm_q"]),
            block_max_q=np.asarray(tree["block_max_q"]),
            bound_scale=np.float32(tree["bound_scale"]),
            idf=np.asarray(tree["idf"]),
            list_ub=np.asarray(tree["list_ub"]),
            kmin=np.float32(tree["kmin"]),
            kstep=np.float32(tree["kstep"]),
            norm_table=np.asarray(tree["norm_table"]),
            params=BM25Params(k1=float(tree["bm25_k1"]), b=float(tree["bm25_b"])),
        )
    return DeviceArena(
        lens=np.asarray(tree["lens"]),
        data=np.asarray(tree["data"]),
        block_base=np.asarray(tree["block_base"]),
        block_keys=np.asarray(tree["block_keys"]),
        lane_valid=np.asarray(tree["lane_valid"]),
        part_of_block=np.asarray(tree["part_of_block"]),
        first_blk=np.asarray(tree["first_blk"]),
        n_blk=np.asarray(tree["n_blk"]),
        sizes=np.asarray(tree["sizes"]),
        bases=np.asarray(tree["bases_p1"]) - 1,
        part_list=np.asarray(tree["part_list"]),
        list_blk_offsets=np.asarray(tree["list_blk_offsets"]),
        stride=int(tree["stride"]),
        n_blocks=int(tree["n_blocks"]),
        device_ok=bool(tree["device_ok"]),
        ranked=ranked,
        block_codec=(
            np.asarray(tree["block_codec"]) if "block_codec" in tree else None
        ),
        codec_row=np.asarray(tree["codec_row"]) if "codec_row" in tree else None,
        ef_lo=np.asarray(tree["ef_lo"]) if "ef_lo" in tree else None,
        ef_hi=np.asarray(tree["ef_hi"]) if "ef_hi" in tree else None,
        ef_lbits=np.asarray(tree["ef_lbits"]) if "ef_lbits" in tree else None,
    )


def save_arena(manager, arena: DeviceArena, step: int = 0) -> None:
    """Checkpoint the GLOBAL arena (synchronous: recovery depends on it)."""
    manager.save(step, arena_to_tree(arena))
    manager.wait()


def restore_arena(manager, step: int | None = None):
    """(arena, step) from the newest intact arena checkpoint (or ``step``).

    The ranked-ness of the template must match the checkpoint being read,
    so it is peeked from each step's manifest treedef; like
    ``CheckpointManager.restore``, a corrupt retained step is skipped with
    a warning when no explicit ``step`` was asked for.
    """
    from ..checkpoint.manager import RESTORE_ERRORS

    candidates = [step] if step is not None else list(reversed(manager.steps()))
    if not candidates:
        raise FileNotFoundError(f"no checkpoints in {manager.dir}")
    last_err: Exception | None = None
    for s in candidates:
        try:
            treedef = manager.manifest(s)["treedef"]
            tree, got = manager.restore(
                arena_template(
                    "freq_lens" in treedef, multi="block_codec" in treedef
                ),
                step=s,
            )
            return tree_to_arena(tree), got
        except RESTORE_ERRORS as e:
            if step is not None:
                raise
            print(
                f"[ckpt] arena step {s} unreadable ({type(e).__name__}: {e}); "
                "falling back to the previous retained step",
                file=sys.stderr,
            )
            last_err = e
    raise FileNotFoundError(
        f"no intact arena checkpoint in {manager.dir}"
    ) from last_err


def restore_shard(
    manager,
    shard: int,
    n_shards: int,
    replicas: int = 1,
    step: int | None = None,
):
    """(sub-arena, step): ONE shard restored from a GLOBAL checkpoint.

    Re-routes through the splitmix64 replica placement, so the target
    shard count and replica factor may differ from whatever sharding the
    arena was serving when checkpointed -- the serving analog of the
    manager's restore onto a new device layout.  The slice is the exact
    ``_slice_arena`` gather ``ShardedArena`` itself performs, so the
    recovered shard is bit-identical to a freshly built one.
    """
    from .shard import _slice_arena, local_map_of, replica_owners

    arena, got = restore_arena(manager, step=step)
    n_lists = len(arena.list_blk_offsets) - 1
    owner_r = replica_owners(n_lists, n_shards, min(int(replicas), n_shards))
    lists_s = np.flatnonzero((owner_r == shard).any(axis=0))
    return _slice_arena(arena, lists_s, local_map_of(lists_s, n_lists)), got
