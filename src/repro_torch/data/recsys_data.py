"""Synthetic Criteo-like recsys batches + OptVB-compressed multi-hot lists.

Counterpart of ``repro/data/recsys_data.py``: the same numpy draws in the
same order, so a seed gives the reference's batches exactly.  Multi-hot
fields (e.g. "recently viewed items") are sorted id lists -- posting lists
-- stored with the paper's optimal partitioning and decoded per batch; the
EmbeddingBag (``kernels/embedding_bag``) then reduces them.
"""

from __future__ import annotations

import numpy as np

from ..core.index import build_partitioned_index
from ..core.query_engine import QueryEngine
from ..models.recsys import RecsysConfig


def make_ctr_batch(rng: np.random.Generator, cfg: RecsysConfig, batch: int) -> dict:
    if cfg.kind in ("dcn", "dlrm"):
        dense = rng.lognormal(0.0, 1.0, size=(batch, cfg.n_dense)).astype(np.float32)
        dense = np.log1p(dense)
        sparse = (rng.zipf(1.2, size=(batch, cfg.n_sparse)) % cfg.rows_per_field).astype(
            np.int32
        )
        label = (rng.random(batch) < 0.25).astype(np.float32)
        return {"dense": dense, "sparse": sparse, "label": label}
    L = cfg.seq_len
    hist = (rng.zipf(1.2, size=(batch, L)) % cfg.item_vocab).astype(np.int32)
    lens = rng.integers(1, L + 1, size=batch)
    mask = np.arange(L)[None, :] < lens[:, None]
    target = (rng.zipf(1.2, size=batch) % cfg.item_vocab).astype(np.int32)
    label = (rng.random(batch) < 0.3).astype(np.float32)
    return {"history": hist, "hist_mask": mask, "target": target, "label": label}


def make_multihot_store(
    rng: np.random.Generator, n_users: int, vocab: int, mean_items: int = 60
):
    """Per-user sorted multi-hot item lists as an optimally partitioned
    index (list u = user u's items)."""
    lists = []
    for _ in range(n_users):
        n = max(2, int(rng.poisson(mean_items)))
        ids = np.unique(rng.integers(0, vocab, size=n))
        lists.append(ids.astype(np.int64))
    return build_partitioned_index(lists, "optimal")


def decode_multihot_batch(index, user_ids, pad_to: int, device="cuda"):
    """-> (ids [B, pad_to] int32, mask [B, pad_to] bool) numpy arrays for the
    EmbeddingBag: each user's first ``pad_to`` items, zero-padded.

    The lists are decoded through one ``QueryEngine(index, device=device)``
    -- on the card unless the caller asks for the CPU -- once per distinct
    user."""
    user_ids = np.asarray(user_ids, dtype=np.int64)
    engine = QueryEngine(index, device=device)
    users, inv = np.unique(user_ids, return_inverse=True)
    rows = np.zeros((len(users), pad_to), np.int32)
    rmask = np.zeros((len(users), pad_to), bool)
    for i, u in enumerate(users):
        lst = engine.decode_list(int(u))[:pad_to]
        rows[i, : lst.size] = lst
        rmask[i, : lst.size] = True
    return rows[inv.reshape(-1)], rmask[inv.reshape(-1)]
