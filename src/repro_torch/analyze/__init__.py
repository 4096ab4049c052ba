"""repro_torch.analyze: the port's static and dynamic checks.

Counterpart of ``repro/analyze``.  Four checkers, driven by ``python -m
repro_torch.analyze``:

* ``contracts``    -- the kernel-family CONTRACT registry (AST-level
  agreement of each numpy / plain / CUDA triple's signatures),
* ``kernel_check`` -- the f32 and integer rules over the CUDA sources,
  the nvcc flags and, on the card's toolchain, the PTX (in place of the
  reference's HLO sanitizer),
* ``sync_audit``   -- the host-sync count of the engines' hot paths,
  ratcheted by ``sync_baseline.json``, on the card also the syncs hidden
  inside device operations,
* ``idiom_lint``   -- AST rules for the port's conventions.

Importing this package is cheap: ``report`` and ``discovery`` are
stdlib-only, and only ``sync_audit`` imports torch.
"""

from .report import Finding, render

__all__ = ["Finding", "render"]
