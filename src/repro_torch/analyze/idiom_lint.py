"""Repo-idiom lint (checker 4 of ``repro_torch.analyze``): AST rules for
conventions a type checker cannot see.  Suppress a single line by ending
it with ``# analyze: allow`` (and say why on that line).

Counterpart of ``repro/analyze/idiom_lint.py``, over ``src/repro_torch/``.
Rules:

* ``obs-timers`` -- raw wall-clock reads (``time.perf_counter()``,
  ``time.time()``, ``time.monotonic()`` CALLS) in ``src/repro_torch/``
  route through the observability layer instead (``obs.timer`` /
  ``obs.span`` / ``obs.now``): ad-hoc timing scraps can neither be
  exported nor asserted on.  ``repro_torch/obs/`` itself (the clock's
  home) is exempt, as are references to a clock (``clock=time.monotonic``,
  an injectable default) and non-timing uses like ``time.sleep`` /
  ``time.time_ns``.

* ``ranked-f32-math`` -- no bare ``np.float32(...)`` or
  ``torch.tensor(..., dtype=torch.float32)`` operand of a binary
  expression in ``src/repro_torch/ranked/``: the BM25 pipeline's f32
  constants flow through the dequant table and the kernel contract
  (``kernels.bm25_score``), where operation order is pinned; an ad-hoc
  ``x * np.float32(c)`` in engine code is exactly the kind of scalar that
  silently reassociates.  ``ranked/bm25.py``, which DEFINES that contract
  (``norm_table``, ``score_tf``), is the rule's authority and exempt.
  A float32 constant as a dtype, an argument or a plain value is fine.

* ``backend-route`` -- backend and device selection goes through
  ``api.resolve_backend`` / ``api.resolve_device``, the one place that
  decides whether the card serves (and raises without one).  Any other
  module calling ``torch.cuda.is_available()`` or reading
  ``REPRO_BACKEND`` re-introduces a per-module choice of device.

The reference's ``bench-history-timestamp`` rule has nothing to lint
here: the port writes no bench history.
"""

from __future__ import annotations

import ast

from .discovery import REPO_ROOT, repro_torch_source_files
from .report import Finding

SUPPRESS = "# analyze: allow"
BACKEND_AUTHORITY = "src/repro_torch/api.py"
F32_AUTHORITY = "src/repro_torch/ranked/bm25.py"
_RAW_CLOCKS = ("perf_counter", "time", "monotonic")


def _is_attr_call(node: ast.AST, owner: str, attr: str) -> bool:
    """``owner.attr(...)``, ``owner`` a dotted name such as ``torch.cuda``."""
    if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
        return False
    if node.func.attr != attr:
        return False
    return ast.unparse(node.func.value) == owner


def _is_raw_clock_call(node: ast.AST) -> bool:
    """time.perf_counter() / time.time() / time.monotonic() calls."""
    return any(_is_attr_call(node, "time", c) for c in _RAW_CLOCKS)


def _is_bare_f32(node: ast.AST) -> bool:
    """``np.float32(...)`` or ``torch.tensor(..., dtype=torch.float32)``."""
    if _is_attr_call(node, "np", "float32"):
        return True
    if _is_attr_call(node, "torch", "tensor"):
        return any(
            kw.arg == "dtype" and ast.unparse(kw.value) == "torch.float32"
            for kw in node.keywords
        )
    return False


def _const_eq(node: ast.AST, value: str) -> bool:
    return isinstance(node, ast.Constant) and node.value == value


def _is_repro_backend_read(node: ast.AST) -> bool:
    """os.environ["REPRO_BACKEND"] / .get(...) / os.getenv(...) reads."""
    if isinstance(node, ast.Subscript):
        return (
            isinstance(node.value, ast.Attribute)
            and node.value.attr == "environ"
            and _const_eq(node.slice, "REPRO_BACKEND")
        )
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        if node.func.attr in ("get", "getenv") and node.args:
            return _const_eq(node.args[0], "REPRO_BACKEND")
    return False


def lint_source(src: str, rel_path: str) -> list[Finding]:
    """Findings for one module, addressed by its repo-relative path."""
    rel = rel_path.replace("\\", "/")
    lines = src.splitlines()

    def suppressed(lineno: int) -> bool:
        return 0 < lineno <= len(lines) and SUPPRESS in lines[lineno - 1]

    findings: list[Finding] = []

    def add(rule: str, node: ast.AST, message: str) -> None:
        if not suppressed(node.lineno):
            findings.append(Finding("idiom", rule, f"{rel}:{node.lineno}", message))

    tree = ast.parse(src, filename=rel)
    in_port = rel.startswith("src/repro_torch/")
    timed = in_port and not rel.startswith("src/repro_torch/obs/")
    in_ranked = rel.startswith("src/repro_torch/ranked/") and rel != F32_AUTHORITY
    for node in ast.walk(tree):
        if timed and _is_raw_clock_call(node):
            add(
                "obs-timers",
                node,
                "raw wall-clock timing in src/repro_torch/; route through "
                "repro_torch.obs (obs.timer / obs.span / obs.now) instead",
            )
        if in_ranked and isinstance(node, ast.BinOp):
            if _is_bare_f32(node.left) or _is_bare_f32(node.right):
                add(
                    "ranked-f32-math",
                    node,
                    "bare float32 arithmetic in ranked/; route f32 constants "
                    "through the kernel contract (dequant table)",
                )
        if in_port and rel != BACKEND_AUTHORITY and (
            _is_repro_backend_read(node)
            or _is_attr_call(node, "torch.cuda", "is_available")
        ):
            add(
                "backend-route",
                node,
                "backend or device selection outside repro_torch.api; use "
                "api.resolve_backend / api.resolve_device instead",
            )
    return findings


def lint_repo() -> list[Finding]:
    """Lint every repro_torch source module."""
    findings: list[Finding] = []
    for path in repro_torch_source_files():
        rel = path.relative_to(REPO_ROOT).as_posix()
        findings += lint_source(path.read_text(), rel)
    return findings
