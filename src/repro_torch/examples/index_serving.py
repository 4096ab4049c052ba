"""End-to-end index serving (the paper's application, both engines).

    PYTHONPATH=src python -m repro_torch.examples.index_serving [--device cpu]

Counterpart of ``examples/index_serving.py``, with its asserts and its
printed numbers: an optimally partitioned index over a synthetic clustered
corpus serves boolean-AND queries through the host loop and through the
batched engine on ``device`` (the card unless the caller asks for the
CPU); then two lists resident on the device as ``DeviceList``s, decoded by
the ``decode_blocks`` kernel, answer an AND and 1,024 NextGEQ probes,
held to numpy.
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import obs
from ..api import resolve_device
from ..core import QueryEngine, build_partitioned_index, build_unpartitioned_index
from ..core.jax_engine import DeviceList
from ..data.postings import make_corpus, make_queries


def run(device="cuda") -> dict:
    """The reference script's steps; returns the numbers it prints."""
    dev = resolve_device(device)
    rng = np.random.default_rng(1)
    corpus = make_corpus(rng, n_lists=24, min_len=1_000, max_len=30_000,
                         mean_dense_gap=2.13, frac_dense=0.8)
    n_postings = sum(len(l) for l in corpus)

    t0 = obs.now()
    idx = build_partitioned_index(corpus, "optimal")
    build_s = obs.now() - t0
    bpi = idx.bits_per_int()
    base_bpi = build_unpartitioned_index(corpus).bits_per_int()
    print(f"built optimal index over {n_postings:,} postings in "
          f"{build_s:.2f}s -> {bpi:.2f} bpi "
          f"(vs {base_bpi:.2f} un-partitioned)")

    queries = [[int(t) for t in q] for q in make_queries(rng, len(corpus), 50, 2)]
    t0 = obs.now()
    total = sum(idx.intersect_scalar(q).size for q in queries)
    print(f"scalar loop: {50} AND queries, {total:,} results, "
          f"{(obs.now()-t0)/50*1e3:.2f} ms/query")

    # batched query engine (vectorized location + fused block decode)
    engine = QueryEngine(idx, device=dev)
    engine.intersect_batch(queries[:4])  # warm the block arena
    t0 = obs.now()
    batched = engine.intersect_batch(queries)
    dt = obs.now() - t0
    assert sum(r.size for r in batched) == total
    print(f"batched engine: same 50 queries in one call, "
          f"{dt/50*1e3:.3f} ms/query, results identical")

    # two lists resident on the device, decoded by the decode_blocks kernel
    a, b = DeviceList(corpus[0], device=dev), DeviceList(corpus[1], device=dev)
    t0 = obs.now()
    hits = a.intersect(b).cpu().numpy()
    hits = hits[hits >= 0]
    want = np.intersect1d(corpus[0], corpus[1])
    assert np.array_equal(hits, want)
    print(f"device engine: batched AND of lists 0,1 -> {hits.size:,} results "
          f"(matches numpy oracle), {obs.now()-t0:.2f}s on {dev}")

    probes = rng.integers(0, corpus[0][-1], 1024)
    got = a.next_geq_batch(probes).cpu().numpy()
    ks = np.searchsorted(corpus[0], probes)
    want = np.where(ks < len(corpus[0]),
                    corpus[0][np.minimum(ks, len(corpus[0]) - 1)], -1)
    assert np.array_equal(got, want)
    print("device engine: 1024 batched NextGEQ probes match the oracle")
    return {"postings": n_postings, "bpi": bpi, "base_bpi": base_bpi,
            "results": total, "and_hits": int(hits.size), "probes": len(probes)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions)")
    return run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
