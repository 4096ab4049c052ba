"""The control of a cell: the plain reference put in the program's place
in the next precision down (BM25 contributions in bfloat16 for the ranked
cells, whose configuration states f32) or with its guarantee broken
(membership decided per bucket of 8 docIDs for the AND cells, whose
configuration states exact answers), judged by the harness's own
comparison with the reference, at the cell's own sizes.

    python3 bench/tools/control.py --workload gov2.topk10-c64 --seeds 1,2,3 --queries 1000

Prints one JSON line a seed: the answers checked and the wrong answers.
The control has to read wrong where a sound run reads 0.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def control_readings(workload: str, seeds, n_queries: int, root=ROOT,
                     device="cuda") -> list[dict]:
    from bench.harness import cell, gen, spec

    bm = spec.load(root)
    w = spec.workload(bm, workload)
    cfg = spec.config(bm, w["config"], root)
    mix = spec.traffic(w["traffic"], root)
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        lists, freqs = gen.make_inputs(seed, cfg, device)
        pool = gen.query_pool(seed, cfg, mix["pool"], mix["arity"])
        qidx = [i % len(pool) for i in range(n_queries)]
        ref = cell.reference(mix["op"], mix.get("k"), lists, freqs, device)
        ctl = cell.reference(mix["op"], mix.get("k"), lists, freqs, device,
                             control=True)
        answers = [ctl(pool[i]) for i in qidx]
        wrong = cell.count_wrong(mix["op"], qidx, answers, pool, ref)
        out.append({"workload": workload, "seed": seed, "checked": len(qidx),
                    "wrong_answers": wrong,
                    "wrong_share_pct": 100.0 * wrong / max(len(qidx), 1),
                    "seconds": time.perf_counter() - t0})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench/tools/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--queries", type=int, default=1000)
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    seeds = [int(s) for s in args.seeds.split(",")]
    for rec in control_readings(args.workload, seeds, args.queries):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
