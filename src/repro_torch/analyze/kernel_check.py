"""Kernel-source sanitizer (checker 2 of ``repro_torch.analyze``).

Stands in for ``repro/analyze/hlo_check.py``, which reads XLA's optimized
HLO and has no counterpart here: its rules move to the CUDA sources the
port compiles and to the PTX ``nvcc`` makes of them.  The families'
identity classes are the ``CONTRACT``s' (``contracts``): an ``integer``
kernel gives the same integers as the reference and needs no float at
all; an ``f32-bit-exact`` kernel keeps the reference's f32 operation
order, so nothing may contract a multiply and an add into one FMA or
round a division approximately.

On any machine (``check_kernels``), from the sources:

* ``unclassified-source`` -- every ``csrc/`` source is in one of the two
  lists below, so none escapes both rules;
* ``float-in-integer-kernel`` -- no ``float`` or ``double`` token outside
  comments in the integer families' sources and their shared headers;
* ``fast-math`` -- the nvcc flags of ``kernels/_build.py`` hold no
  ``--use_fast_math``, ``-ftz=true``, ``-prec-div=false`` or
  ``-prec-sqrt=false`` (each would loosen every f32 operation);
* ``approx-intrinsic`` -- no ``fmaf``, ``__fmaf_*``, ``__fdividef`` or
  directed-rounding ``__f*_ru`` / ``_rd`` / ``_rz`` intrinsic in the f32
  sources (the contract rounds to nearest, one operation at a time).

On the card's toolchain (``check_ptx``, which runs ``nvcc -ptx``):

* ``ptx-f32-contract`` -- the PTX of the libraries that evaluate an f32
  contract holds no ``fma.rn.f32`` (a contracted multiply-add),
  ``div.approx`` or ``div.full.f32`` (approximate divisions).
"""

from __future__ import annotations

import ast
import pathlib
import re

from .discovery import SRC_ROOT
from .report import Finding

CSRC = SRC_ROOT / "csrc"
BUILD_PY = SRC_ROOT / "kernels" / "_build.py"
INTEGER_SOURCES = (
    "vbyte_decode.cu", "ef_search.cu", "blockmax_pivot.cu", "gain_scan.cu",
    "partition_scan.cu", "svb_tile.cuh", "pivot_tile.cuh",
)
F32_SOURCES = ("bm25_score.cu", "pivot_score.cu", "bm25_tile.cuh", "embedding_bag.cu")
# the libraries that evaluate an f32 contract (BM25's, the bag's k-ordered
# sum), and what their PTX must not hold
F32_LIBS = ("bm25_score", "pivot_score", "embedding_bag")
PTX_FORBIDDEN = ("fma.rn.f32", "div.approx", "div.full.f32")
FAST_MATH_FLAGS = ("use_fast_math", "ftz=true", "prec-div=false", "prec-sqrt=false")

_FLOAT_TOKEN = re.compile(r"\b(float|double)\b")
_APPROX = re.compile(r"\b(fmaf|__fmaf_\w+|__fdividef|__f(?:add|sub|mul|div|rcp|sqrt)_r[udz])\b")
_COMMENT = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)


def strip_comments(text: str) -> str:
    """``text`` with C/C++ comments blanked, line numbers kept."""
    return _COMMENT.sub(lambda m: "\n" * m.group(0).count("\n"), text)


def _scan(path: pathlib.Path, pattern, rule: str, message: str) -> list[Finding]:
    findings = []
    code = strip_comments(path.read_text())
    for lineno, line in enumerate(code.splitlines(), 1):
        for m in pattern.finditer(line):
            findings.append(
                Finding("kernel", rule, f"csrc/{path.name}:{lineno}",
                        f"{m.group(0)!r}: {message}")
            )
    return findings


def check_sources(csrc=None) -> list[Finding]:
    """The two source rules over ``csrc`` (default: the port's); every
    source there must be in one of the two lists."""
    csrc = pathlib.Path(csrc) if csrc else CSRC
    findings = []
    for name in INTEGER_SOURCES:
        findings += _scan(csrc / name, _FLOAT_TOKEN, "float-in-integer-kernel",
                          "an integer-class kernel computes no floats")
    for name in F32_SOURCES:
        findings += _scan(csrc / name, _APPROX, "approx-intrinsic",
                          "the f32 contract rounds each operation to nearest")
    known = set(INTEGER_SOURCES + F32_SOURCES)
    for path in sorted(csrc.iterdir()):
        if path.suffix in (".cu", ".cuh") and path.name not in known:
            findings.append(
                Finding("kernel", "unclassified-source", f"csrc/{path.name}",
                        "a CUDA source in neither INTEGER_SOURCES nor "
                        "F32_SOURCES is checked by no rule")
            )
    return findings


def check_build_flags(build_py=None) -> list[Finding]:
    """No string in ``build_py`` (default ``kernels/_build.py``) is a flag
    that loosens f32 arithmetic."""
    build_py = pathlib.Path(build_py) if build_py else BUILD_PY
    findings = []
    for node in ast.walk(ast.parse(build_py.read_text())):
        if not (isinstance(node, ast.Constant) and isinstance(node.value, str)):
            continue
        if node.value.lstrip("-") in FAST_MATH_FLAGS:
            findings.append(
                Finding("kernel", "fast-math", f"{build_py.name}:{node.lineno}",
                        f"nvcc flag {node.value!r} loosens every f32 operation")
            )
    return findings


def check_kernels(csrc=None, build_py=None) -> list[Finding]:
    """Every rule that reads files: the sources and the build flags."""
    return check_sources(csrc) + check_build_flags(build_py)


def check_ptx(ptx=None) -> tuple[list[Finding], dict[str, int]]:
    """The PTX rule; needs ``nvcc``.  ``ptx(name)`` returns the PTX of
    ``csrc/<name>.cu`` (default: ``kernels._build.ptx``, the build's
    target and optimisation level).  Returns the findings and each f32
    library's count of correctly rounded divisions (``div.rn.f32``)."""
    if ptx is None:
        from ..kernels._build import ptx
    findings, divs = [], {}
    for name in F32_LIBS:
        text = ptx(name)
        found = [w for w in PTX_FORBIDDEN if w in text]
        if found:
            findings.append(
                Finding("kernel", "ptx-f32-contract", f"csrc/{name}.cu",
                        f"PTX holds {found}: the f32 contract would drift off "
                        "the reference")
            )
        divs[name] = text.count("div.rn.f32")
    return findings, divs
