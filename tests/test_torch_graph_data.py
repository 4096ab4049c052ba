"""The port's graph pipeline (``repro_torch.data.graph_data``) against the
JAX package's: the same seed gives the same adjacency lists, the same
optimally partitioned index (array for array), the same decoded
neighbors, sizes, sampled subgraphs and padded arrays, all exactly; plus
``test_data_pipelines.py::test_graph_store_and_sampler``'s asserts.
"""

import numpy as np
import pytest

from repro.data import graph_data as RD

from repro_torch import convert
from repro_torch.data import graph_data as TD


def _both(n_nodes, avg_degree, seed=0):
    lists = {}
    for name, mod in (("ref", RD), ("port", TD)):
        rng = np.random.default_rng(seed)
        lists[name] = (mod.make_powerlaw_graph(rng, n_nodes, avg_degree), rng)
    return lists


@pytest.mark.parametrize("n_nodes,avg_degree", [(200, 5), (256, 6), (3, 1), (1_000, 40)])
def test_powerlaw_graph_and_store_match(n_nodes, avg_degree):
    got = _both(n_nodes, avg_degree)
    (ref, rrng), (port, trng) = got["ref"], got["port"]
    assert len(ref) == len(port) == n_nodes
    for a, b in zip(ref, port):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # the generators end in the same state
    assert rrng.integers(0, 2**62) == trng.integers(0, 2**62)
    rs, ts = RD.CompressedGraphStore(ref), TD.CompressedGraphStore(port, "cpu")
    ra, ta = convert.index_arrays(rs.index), convert.index_arrays(ts.index)
    assert ra.keys() == ta.keys()
    for k in ra:
        assert np.array_equal(np.asarray(ra[k]), np.asarray(ta[k])), k
    assert (ts.n_nodes, ts.raw_bytes, ts.compressed_bytes) == (
        rs.n_nodes, rs.raw_bytes, rs.compressed_bytes)
    assert ts.compressed_bytes < ts.raw_bytes or n_nodes < 10
    for u in range(n_nodes):
        got_u = ts.neighbors(u)
        assert got_u.dtype == np.int64 and np.array_equal(got_u, port[u]), u
        assert np.array_equal(got_u, rs.neighbors(u)), u


def test_graph_store_and_sampler():
    """The reference's test on the port, then its sample against the
    reference's."""
    rng = np.random.default_rng(0)
    adj = TD.make_powerlaw_graph(rng, n_nodes=200, avg_degree=5)
    store = TD.CompressedGraphStore(adj, "cpu")
    assert store.compressed_bytes < store.raw_bytes
    for u in (0, 13, 199):
        assert np.array_equal(store.neighbors(u), adj[u])
    seeds = rng.choice(200, size=8, replace=False)
    nodes, edges = store.sample_subgraph(rng, seeds, fanouts=(4, 3))
    assert edges.max() < nodes.size
    # every sampled edge endpoint is a real graph edge
    for s, d in edges.T[:20]:
        u, v = int(nodes[d]), int(nodes[s])
        assert v in set(adj[u]) or u in set(adj[v])

    rrng = np.random.default_rng(0)
    radj = RD.make_powerlaw_graph(rrng, n_nodes=200, avg_degree=5)
    rseeds = rrng.choice(200, size=8, replace=False)
    rnodes, redges = RD.CompressedGraphStore(radj).sample_subgraph(rrng, rseeds, (4, 3))
    assert np.array_equal(seeds, rseeds)
    assert nodes.dtype == rnodes.dtype and np.array_equal(nodes, rnodes)
    assert edges.dtype == redges.dtype and np.array_equal(edges, redges)


@pytest.mark.parametrize("n_seeds,fanouts,e_pad", [
    (32, (5, 5), 2_048),      # the launcher's batch: nothing dropped
    (64, (15, 10), 1_000),    # more edges than the pad: the tail is dropped
    (16, (3,), 64),
])
def test_sample_and_pad_match(n_seeds, fanouts, e_pad):
    n, d = 512, 7
    rng = np.random.default_rng(3)
    adj = TD.make_powerlaw_graph(rng, n, avg_degree=12)
    stores = {"ref": RD.CompressedGraphStore(adj), "port": TD.CompressedGraphStore(adj, "cpu")}
    out = {}
    for name, mod in (("ref", RD), ("port", TD)):
        r = np.random.default_rng(7)
        seeds = r.choice(n, size=n_seeds, replace=False)
        nodes, edges = stores[name].sample_subgraph(r, seeds, fanouts=fanouts)
        out[name] = (nodes, edges, *mod.pad_subgraph(nodes, edges, 1_024, e_pad, d, r))
    for g, w in zip(out["port"], out["ref"]):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)
        else:
            assert g == w
    nodes, edges, feats, e, m, n_real = out["port"]
    assert n_real == nodes.size and feats.shape == (1_024, d)
    k = min(edges.shape[1], e_pad)
    assert m.sum() == k and not m[k:].any() and not e[:, k:].any()
    assert np.array_equal(e[:, :k], edges[:, :k])
    if e_pad == 1_000:
        assert edges.shape[1] > e_pad


def test_store_decodes_through_its_engine(monkeypatch):
    """``neighbors`` is the index's list decode on the store's device (the
    ``decode_blocks`` kernel on the card, its plain version here); the
    default device is the card, which raises without one; a store pickles
    whole before its first decode, as a host worker hands it over."""
    import pickle

    import torch

    adj = TD.make_powerlaw_graph(np.random.default_rng(5), 300, avg_degree=8)
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TD.CompressedGraphStore(adj)
    store = pickle.loads(pickle.dumps(TD.CompressedGraphStore(adj, "cpu")))
    assert store.device.type == "cpu" and store._engine is None
    for u in (0, 150, 299, 150):
        assert np.array_equal(store.neighbors(u), adj[u])
    eng = store.engine
    assert eng.backend == "torch" and eng.device.type == "cpu"
    assert eng.stats["kernel_calls"] >= 1
