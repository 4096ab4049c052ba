"""The port's analyser: gate and ratchet.

    PYTHONPATH=src python -m repro_torch.analyze --check [--device cpu]
        run all four checkers (contract registry, kernel sources and, on
        the card, their PTX; host-sync audit against the committed
        baseline; idiom lint); exit 1 on any finding.

    PYTHONPATH=src python -m repro_torch.analyze --update-baseline [--force]
        re-measure the hot paths' sync counts and rewrite
        ``sync_baseline.json``.  Refuses to RAISE a count without
        ``--force``: the baseline is a ratchet, not a snapshot.  A count the
        device cannot measure (hidden syncs on the CPU) keeps the file's.

``--device`` is ``cuda`` by default, as for every entry point of the
port: without a card the run exits non-zero and never falls back to the
CPU.  ``--device cpu`` runs the audit over the kernels' plain versions
and skips the PTX check, which needs the card's toolchain.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

from . import contracts, idiom_lint, kernel_check


def _hidden(m: dict) -> str:
    return "not measured" if m["hidden_syncs"] is None else str(m["hidden_syncs"])


def _sync_counts(measured: dict) -> str:
    return " ".join(
        f"{name}={m['syncs']} (hidden {_hidden(m)})"
        for name, m in sorted(measured["hot_paths"].items())
    )


def update_baseline(measured: dict, path: pathlib.Path, force: bool) -> int:
    from . import sync_audit

    baseline = sync_audit.load_baseline(path)
    regressions = [
        f
        for f in sync_audit.compare_baseline(measured, baseline)
        if f.rule != "missing-baseline"
    ]
    if regressions and not force:
        print("[analyze] refusing to RAISE the baseline (it is a ratchet):")
        for f in regressions:
            print(f"[analyze]   {f}")
        print("[analyze] pass --force to accept the regression anyway")
        return 1
    written = sync_audit.with_baseline_hidden(measured, baseline)
    path.write_text(json.dumps(written, indent=2, sort_keys=True) + "\n")
    print(f"[analyze] baseline written: {path} ({_sync_counts(written)})")
    return 0


def main(argv=None) -> int:
    from . import sync_audit
    from ..api import resolve_device

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analyze", description=__doc__.splitlines()[0]
    )
    ap.add_argument("--check", action="store_true", help="run all checkers")
    ap.add_argument(
        "--update-baseline",
        action="store_true",
        help="rewrite the sync-count baseline from a fresh measurement",
    )
    ap.add_argument(
        "--force", action="store_true", help="allow --update-baseline to raise counts"
    )
    ap.add_argument("--baseline", default=str(sync_audit.BASELINE))
    ap.add_argument(
        "--device",
        default="cuda",
        choices=("cuda", "cpu"),
        help="device the sync audit serves on (default cuda; cpu runs the "
        "kernels' plain versions and skips the PTX check)",
    )
    args = ap.parse_args(argv)
    if not (args.check or args.update_baseline):
        args.check = True
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"[analyze] {e}", file=sys.stderr)
        return 2
    baseline_path = pathlib.Path(args.baseline)

    findings = contracts.check_contracts()
    print(f"[analyze] contracts: {len(findings)} finding(s)")

    lint = idiom_lint.lint_repo()
    print(f"[analyze] idiom lint: {len(lint)} finding(s)")
    findings += lint

    kern = kernel_check.check_kernels()
    print(f"[analyze] kernel sources: {len(kern)} finding(s)")
    findings += kern
    if args.device == "cuda":
        ptx, divs = kernel_check.check_ptx()
        print(f"[analyze] kernel PTX: {len(ptx)} finding(s) "
              f"(div.rn.f32 {json.dumps(divs, sort_keys=True)})")
        findings += ptx
    else:
        print("[analyze] kernel PTX: skipped on --device cpu (needs nvcc)")

    measured = sync_audit.audit_hot_paths(args.device)
    print(f"[analyze] sync audit ({args.device}): {_sync_counts(measured)}")
    for name, m in sorted(measured["hot_paths"].items()):
        hidden = m["hidden_sites"]
        print(f"[analyze]   {name}: sites {', '.join(m['sync_sites'])}"
              + ("" if hidden is None else f"; hidden {', '.join(hidden) or 'none'}"))

    if args.update_baseline:
        return update_baseline(measured, baseline_path, args.force)

    baseline = sync_audit.load_baseline(baseline_path)
    findings += sync_audit.compare_baseline(measured, baseline)
    for hint in sync_audit.improvements(measured, baseline):
        print(f"[analyze] NOTE {hint}")

    for f in findings:
        print(f"[analyze] FAIL {f}", file=sys.stderr)
    if findings:
        return 1
    print("[analyze] OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
