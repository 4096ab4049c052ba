"""Synthetic graphs, OptVB-compressed CSR adjacency, neighbor sampler.

Counterpart of ``repro/data/graph_data.py``: the same numpy draws in the
same order, so a seed gives the reference's lists, index, subgraphs and
padded arrays exactly.  Adjacency lists (sorted neighbor ids per node) are
posting lists; the graph store keeps them with the paper's optimal
partitioning and decodes per-node lists on demand through the index's
query engine on the store's device (the ``decode_blocks`` kernel on the
card, its plain version on the CPU) -- the neighbor sampler for
``minibatch_lg`` works directly off the compressed store.  Lists,
subgraphs and padded arrays are numpy on the host; the trainer uploads
them.
"""

from __future__ import annotations

import numpy as np

from ..api import resolve_device
from ..core.index import PartitionedIndex, build_partitioned_index
from ..core.query_engine import QueryEngine


def make_powerlaw_graph(rng: np.random.Generator, n_nodes: int, avg_degree: int):
    """Undirected power-law-ish graph as sorted per-node adjacency lists.

    A node draws ``zipf(1.6) + avg_degree - 1`` neighbors (at most
    ``n_nodes - 1``) before self-loops and repeats go, so the mean degree
    is above ``avg_degree``: the Zipf term's mean grows with ``n_nodes``."""
    deg = np.minimum(rng.zipf(1.6, size=n_nodes) + avg_degree - 1, n_nodes - 1)
    lists = []
    for i in range(n_nodes):
        nbr = rng.integers(0, n_nodes, size=int(deg[i]))
        nbr = np.unique(nbr[nbr != i])
        if nbr.size == 0:
            nbr = np.array([(i + 1) % n_nodes])
        lists.append(nbr.astype(np.int64))
    return lists


class CompressedGraphStore:
    """Adjacency lists as one optimally partitioned index; ``device`` is
    where list decodes run (``"cuda"`` by default, which raises without a
    card; ``"cpu"`` when asked for)."""

    def __init__(self, adj_lists, device="cuda"):
        self.index: PartitionedIndex = build_partitioned_index(adj_lists, "optimal")
        self.n_nodes = len(adj_lists)
        self.raw_bytes = int(sum(8 * len(l) for l in adj_lists))
        self.device = resolve_device(device)
        self._engine = None

    @property
    def engine(self) -> QueryEngine:
        """The index's query engine on the store's device, built at the
        first decode (so a store built on the host pickles whole)."""
        if self._engine is None:
            self._engine = QueryEngine(self.index, device=self.device)
        return self._engine

    @property
    def compressed_bytes(self) -> int:
        return self.index.space_bits() // 8

    def neighbors(self, u: int) -> np.ndarray:
        return self.engine.decode_list(int(u))

    def sample_subgraph(
        self, rng: np.random.Generator, seeds: np.ndarray, fanouts=(15, 10)
    ):
        """GraphSAGE-style sampling -> (nodes, edges): the subgraph's global
        node ids, seeds first, and its ``[2, E]`` int32 (src, dst) edges in
        local ids.  All GIN layers then run on the induced subgraph."""
        nodes = list(seeds)
        node_set = {int(s): i for i, s in enumerate(seeds)}
        src, dst = [], []
        frontier = list(seeds)
        for fanout in fanouts:
            nxt = []
            for u in frontier:
                nbr = self.neighbors(int(u))
                if nbr.size > fanout:
                    nbr = rng.choice(nbr, size=fanout, replace=False)
                for v in nbr:
                    v = int(v)
                    if v not in node_set:
                        node_set[v] = len(nodes)
                        nodes.append(v)
                        nxt.append(v)
                    src.append(node_set[v])
                    dst.append(node_set[int(u)])
            frontier = nxt
        nodes = np.asarray(nodes, dtype=np.int64)
        edges = np.stack([np.asarray(src), np.asarray(dst)]).astype(np.int32)
        return nodes, edges


def pad_subgraph(nodes, edges, n_nodes_pad: int, n_edges_pad: int, d_feat: int, rng):
    """Static-shape padding: nodes get random features here (synthetic);
    edges past ``n_edges_pad`` are dropped, as the reference drops them.
    -> (feats [n_nodes_pad, d_feat] f32, edges [2, n_edges_pad] int32,
    edge mask [n_edges_pad] bool, the real node count)."""
    feats = rng.normal(size=(n_nodes_pad, d_feat)).astype(np.float32)
    e = np.zeros((2, n_edges_pad), np.int32)
    m = np.zeros((n_edges_pad,), bool)
    k = min(edges.shape[1], n_edges_pad)
    e[:, :k] = edges[:, :k]
    m[:k] = True
    return feats, e, m, nodes.size
