"""Single source of truth for "what counts as repro_torch source".

Counterpart of ``repro/analyze/discovery.py``.  The analysers enumerate
and filter the port's source files through here, so they cannot disagree
on what the tree holds.

Keep this module importable WITHOUT the package: it imports the stdlib
only and can be loaded by file path (``importlib.util.
spec_from_file_location``), so a tool can use it before anything imports
``repro_torch`` (and with it torch).
"""

from __future__ import annotations

import os
import pathlib

SRC_ROOT = pathlib.Path(__file__).resolve().parent.parent  # .../src/repro_torch
REPO_ROOT = SRC_ROOT.parent.parent


def repro_torch_source_files(subdir: str | None = None) -> list[pathlib.Path]:
    """Every repro_torch source file, sorted; ``subdir`` narrows to one
    package."""
    base = SRC_ROOT / subdir if subdir else SRC_ROOT
    return sorted(base.rglob("*.py"))


def repro_torch_frame_prefix() -> str:
    """Filename prefix identifying a stack frame as repro_torch source."""
    return str(SRC_ROOT) + os.sep


def canon_frame_filename(filename: str) -> str:
    """Canonical form of a code object's filename.

    ``tests/conftest.py`` prepends ``<repo>/tests/../src`` to ``sys.path``,
    and CPython does NOT collapse the ``..`` when it absolutizes module
    ``__file__``s -- so under pytest every frame's ``co_filename`` carries
    the unnormalized prefix and a naive ``startswith`` filter sees
    NOTHING.  Every frame filter must compare through this normalization.
    """
    return os.path.normpath(filename)


def is_repro_torch_frame(filename: str) -> bool:
    return canon_frame_filename(filename).startswith(repro_torch_frame_prefix())
