"""Run one cell of the benchmark once.

    python3 bench/run.py --workload gov2.and-b64 --seed 7 --seconds 30 --trace 0

Prints progress and the numbers compared with their limits on standard
error, and the result as the last line of standard output: one JSON object
with ``correct``, ``attempted``, ``failed``, ``metrics`` and ``device``
(with ``--trace 1`` also ``breakdown``), then ``checks``.  Exits non-zero
and prints no result without enough CUDA cards, without the program's
sources beside this folder, or when the process holds JAX or the JAX
package once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env() -> None:
    """Caches at fixed paths inside the checkout; no JAX through a
    library."""
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = ap.parse_args(argv)
    _env()
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("[bench] the program (src/repro_torch) is not in this checkout",
              file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, src]
    from bench.harness import cell, spec

    bm = spec.load(ROOT)
    chips = spec.workload(bm, args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"[bench] {args.workload} needs {chips} CUDA card(s); this "
              f"process sees {n}", file=sys.stderr)
        return 2
    out = cell.run_cell(args.workload, args.seed, args.seconds,
                        bool(args.trace), T_START, root=ROOT)
    bad = cell.forbidden_modules()
    if bad:
        print(f"[bench] JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 3
    print(f"[bench] correct: {out['correct']}", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"[bench] check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
