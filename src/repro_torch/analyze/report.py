"""One ``Finding`` type shared by every checker in ``repro_torch.analyze``.

Counterpart of ``repro/analyze/report.py``, copied so the port imports
nothing of the reference.  Stdlib only.

A finding is a VERDICT, not a log line: ``python -m repro_torch.analyze
--check`` exits non-zero iff the list of findings is non-empty, so a
checker emits a finding only for a real contract violation (no "info"
severity -- the baseline ratchet of ``sync_audit`` handles the one case
where a measurement is reported without failing the gate).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Finding:
    checker: str  # "contracts" | "kernel" | "sync" | "idiom"
    rule: str  # machine-readable rule id, e.g. "approx-intrinsic"
    where: str  # "path:line", a family/op, or a hot-path name
    message: str  # human-readable explanation

    def __str__(self) -> str:
        return f"[{self.checker}/{self.rule}] {self.where}: {self.message}"


def render(findings: list[Finding]) -> str:
    return "\n".join(str(f) for f in findings)
