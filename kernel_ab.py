#!/usr/bin/env python3
"""Time two checkouts' ``embedding_bag`` and ``pivot_select`` kernels, or
their boolean serving path, side by side on one card.

    python3 kernel_ab.py --against OTHER             # OTHER: a checkout's root
    python3 kernel_ab.py --against OTHER --boolean   # chip_smoke's phase 4

Run from the root of a checkout, on a machine with a CUDA card.  It loads
this checkout's ``src/repro_torch`` and OTHER's under two package names in
one process, builds each one's two libraries, and at the main paths'
launch shapes holds each kernel to this checkout's plain version (bits of
the f32 bag, integers of the pivot) and times it in turns (other, this,
this, other), two ways: CUDA events around the wrapper's calls
(``chip_smoke.event_ms``) and the card alone (``chip_smoke.device_ms``:
calls queued behind a spin kernel); then the wrapper's host time
(``chip_smoke.host_us``: the host's clock around a run of calls) in ten
alternating turns a tree, the least and the median kept.

Inputs, made from seeds:
- ``embedding_bag``: the recsys path's last step (``chip_smoke``'s
  ``RECSYS_STEPS + RECSYS_WARMUP`` steps): a [1,048,576 x 16] f32 table
  (the first field's rows of DCN-v2), ``train_recsys``'s multi-hot store of
  256 users, 65,536 bags of K = 64 (ids and the mask as weights);
- ``pivot_select``: one ``MAX_BUCKET`` launch (16,384 cursors) over 32,768
  random chunk rows, qmin drawn as ``chip_smoke`` draws it.

Prints one JSON line a kernel and checkout, then a summary line
``{"ab": ...}``; exits non-zero on a mismatch or without a card.

``--boolean`` instead times ``chip_smoke``'s phase 4 serving: this
checkout's ``launch.serve.run`` builds the full-size boolean index
(``chip_smoke.N_LISTS`` lists, ``chip_smoke.SERVE_ARGS``) and serves its
512 queries once; OTHER gets the same index through its ``convert`` (its
own arena transcode).  Each tree's ``QueryEngine`` on the card serves a
warm-up batch, then all the queries in batches of 64, in BOOLEAN_PAIRS
pairs of turns, the order alternating (other, this, this, other, ...);
every answer must equal the serve run's.  One JSON line a turn (q/s,
batch p50/p99), then ``{"boolean_ab": ...}`` with each tree's median.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time

import numpy as np

import chip_smoke as cs

HERE = os.path.dirname(os.path.abspath(__file__))
HOST_TURNS = 10  # turns of chip_smoke.HOST_REPS calls a tree, alternated
PIVOT_CHUNKS = 32_768
PIVOT_CURSORS = 16_384  # ranked/topk_engine.py MAX_BUCKET
BOOLEAN_PAIRS = 10  # --boolean: pairs of turns, ~12 s a turn at full size


def load_port(root: str, name: str):
    """``root/src/repro_torch`` imported as the package ``name``."""
    pkg = os.path.join(root, "src", "repro_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def bag_inputs(torch, port):
    """(table, ids, weights) of the recsys path's last step, on the card."""
    ex = importlib.import_module(f"{port.__name__}.examples.train_recsys")
    rd = importlib.import_module(f"{port.__name__}.data.recsys_data")
    cfg = importlib.import_module(f"{port.__name__}.configs").get_arch(
        cs.RECSYS_ARCH).full
    batch = 65_536
    store = rd.make_multihot_store(np.random.default_rng(0),
                                   n_users=ex.N_USERS,
                                   vocab=cfg.rows_per_field,
                                   mean_items=ex.MEAN_ITEMS)
    step = cs.RECSYS_WARMUP + cs.RECSYS_STEPS - 1
    users = np.random.default_rng(step).integers(0, ex.N_USERS, batch)
    ids, mask = rd.decode_multihot_batch(store, users, pad_to=ex.PAD_TO,
                                         device="cpu")
    gen = torch.Generator(device="cuda").manual_seed(0)
    table = torch.randn((cfg.rows_per_field, cfg.embed_dim), device="cuda",
                        generator=gen)
    return (table, torch.from_numpy(ids).cuda(),
            torch.from_numpy(mask).float().cuda())


def pivot_inputs(torch):
    """(qb, nblk, qmin, rows) of one MAX_BUCKET launch, on the card."""
    rng = np.random.default_rng(3)
    qb = rng.integers(0, 256, (PIVOT_CHUNKS, 128))
    nblk = np.where(rng.random(PIVOT_CHUNKS) < 0.9, 128,
                    rng.integers(1, 129, PIVOT_CHUNKS))
    crow = rng.integers(0, PIVOT_CHUNKS, PIVOT_CURSORS)
    hi = np.maximum(qb[crow].max(1), 1)
    qmin = np.minimum(rng.integers(0, hi + 1)[:, None]
                      + rng.integers(-8, 9, (PIVOT_CURSORS, 128)), 256)
    qmin[rng.random(PIVOT_CURSORS) < 0.1] = 256
    return tuple(torch.from_numpy(x.astype(np.int32)).cuda()
                 for x in (qb, nblk, np.maximum(qmin, 0), crow))


def boolean_ab(ports, card) -> dict:
    """``--boolean``: both trees' boolean engines over one full-size index,
    timed in turns; returns each tree's turns."""
    mods = {label: {m: importlib.import_module(f"{port.__name__}.{m}")
                    for m in ("kernels._build", "launch.serve", "convert",
                              "core.query_engine")}
            for label, port in ports.items()}
    for label, m in mods.items():
        t0 = time.perf_counter()
        m["kernels._build"].build_all(["vbyte_decode", "ef_search"])
        print(f"[kernel_ab] {label} built in {time.perf_counter()-t0:.1f}s",
              flush=True)
    serve = mods["this"]["launch.serve"]
    res = serve.run(serve.parse_args(["--n-lists", str(cs.N_LISTS),
                                      *cs.SERVE_ARGS, "--device", "cuda"]))
    queries, want = res["queries"], res["results"]
    other_idx = mods["other"]["convert"].index_from_arrays(
        mods["this"]["convert"].index_arrays(res["index"]))
    engines = {"this": res["engine"],
               "other": mods["other"]["core.query_engine"].QueryEngine(
                   other_idx, device="cuda")}
    del res
    engines["other"].intersect_batch(queries[: cs.BATCH])  # upload, warm-up
    turns = {"other": [], "this": []}
    order = []
    for i in range(BOOLEAN_PAIRS):  # which tree goes first alternates
        order += ["other", "this"] if i % 2 == 0 else ["this", "other"]
    for label in order:
        t0 = time.perf_counter()
        got, lat = serve.serve_batches(engines[label], queries, cs.BATCH)
        wall = time.perf_counter() - t0
        if any(not np.array_equal(g, w) for g, w in zip(got, want)):
            cs.fail(f"{label}: boolean answers differ from the serve run's")
        row = {"qps": len(queries) / wall,
               "batch_p50_ms": float(np.percentile(lat, 50)) * 1e3,
               "batch_p99_ms": float(np.percentile(lat, 99)) * 1e3}
        turns[label].append(row)
        print(f"[kernel_ab] {json.dumps({'boolean': label, **row, 'card': card})}",
              flush=True)
    return turns


def measure(torch, fn) -> dict:
    return {"ms": cs.event_ms(fn, 20), "device_ms": cs.device_ms(torch, fn)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", required=True,
                    help="root of the other checkout (its src/repro_torch)")
    ap.add_argument("--boolean", action="store_true",
                    help="time phase 4's boolean serving, not the kernels")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this needs a CUDA card")
    card = cs.card_line()
    print(card, flush=True)
    ports = {"other": load_port(os.path.abspath(args.against), "port_other"),
             "this": load_port(HERE, "port_this")}
    if args.boolean:
        turns = boolean_ab(ports, card)
        medians = {label: {k: float(np.median([r[k] for r in rows]))
                           for k in rows[0]} for label, rows in turns.items()}
        print(json.dumps({"boolean_ab": turns, "median": medians,
                          "card": card}), flush=True)
        return 0
    kernels = {}
    for label, port in ports.items():
        b = importlib.import_module(f"{port.__name__}.kernels._build")
        t0 = time.perf_counter()
        for name, log in b.build_all(["embedding_bag", "blockmax_pivot"]).items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[kernel_ab] {label} ptxas {name}: {line.strip()}")
        print(f"[kernel_ab] {label} built in {time.perf_counter()-t0:.1f}s",
              flush=True)
        kernels[label] = {
            "embedding_bag": importlib.import_module(
                f"{port.__name__}.kernels.embedding_bag.kernel").embedding_bag,
            "pivot_select": importlib.import_module(
                f"{port.__name__}.kernels.blockmax_pivot.kernel").pivot_select,
        }
    eref = importlib.import_module("port_this.kernels.embedding_bag.ref")
    pref = importlib.import_module("port_this.kernels.blockmax_pivot.ref")
    bag_args = bag_inputs(torch, ports["this"])
    piv_args = pivot_inputs(torch)
    plain = {"embedding_bag": eref.embedding_bag_ref(*bag_args),
             "pivot_select": pref.pivot_select_ref(*piv_args)}
    args_of = {"embedding_bag": bag_args, "pivot_select": piv_args}
    results = {}
    for name in ("embedding_bag", "pivot_select"):
        for label in ("other", "this"):
            got = kernels[label][name](*args_of[name])
            mism = (cs.compare_f32(got, plain[name])[0] if name == "embedding_bag"
                    else cs.compare(got, plain[name])[0])
            if mism:
                cs.fail(f"{label} {name}: {mism} mismatches against the plain "
                        "version")
        runs = {"other": [], "this": []}
        for label in ("other", "this", "this", "other"):
            fn = kernels[label][name]
            a = args_of[name]
            runs[label].append(measure(torch, lambda: fn(*a)))
        # the host's time drifts within a run: take it in short turns
        host = {"other": [], "this": []}
        for _ in range(HOST_TURNS):
            for label in ("other", "this"):
                fn = kernels[label][name]
                a = args_of[name]
                host[label].append(cs.host_us(torch, lambda: fn(*a), rounds=1))
        for label, rs in runs.items():
            row = {k: [r[k] for r in rs] for k in rs[0]}
            row["host_us"] = min(host[label])
            row["host_us_median"] = float(np.median(host[label]))
            results.setdefault(name, {})[label] = row
            print(f"[kernel_ab] {json.dumps({'kernel': name, 'tree': label, **row, 'card': card})}",
                  flush=True)
    table, ids, _ = bag_args
    gathered = ids.numel() * table.shape[1] * 4
    print(json.dumps({"ab": results, "bag_gathered_bytes": gathered,
                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
