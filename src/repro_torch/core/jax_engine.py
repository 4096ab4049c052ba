"""One posting list resident on the card, decoded by the block kernel.

Counterpart of ``repro/core/jax_engine.py`` (the path is kept so that a
reader finds it; nothing here uses jax).  ``DeviceList`` packs a posting
list into the fixed-block Stream-VByte layout of
``repro_torch.kernels.vbyte_decode``, decodes it on the device with the
``decode_blocks`` kernel and answers a batch of NextGEQ probes, or an AND
with another list, by ``torch.searchsorted`` over the decoded ids.  The
engines of ``core/query_engine.py`` serve whole indexes; this is the
paper's smallest demonstration of the layout, read by
``examples/index_serving.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..api import resolve_device
from ..kernels.vbyte_decode.ops import decode_sorted, pack_blocks
from .costs import gaps_from_sorted


class DeviceList:
    """One posting list resident on ``device`` (the card unless the caller
    asks for the CPU) in the kernel's block layout."""

    def __init__(self, seq: np.ndarray, use_kernel: bool = True,
                 device="cuda"):
        gaps = gaps_from_sorted(np.asarray(seq, dtype=np.int64))
        lens, data, n = pack_blocks((gaps - 1).astype(np.uint32))
        self.device = resolve_device(device)
        self.lens = torch.as_tensor(lens, device=self.device)
        self.data = torch.as_tensor(data, device=self.device)
        self.n = n
        self.use_kernel = use_kernel

    def decode(self) -> torch.Tensor:
        """The list's ids, int64 [n], on the device."""
        return decode_sorted(self.lens, self.data, self.n,
                             use_kernel=self.use_kernel)

    def next_geq_batch(self, probes) -> torch.Tensor:
        """Vectorized NextGEQ for a batch of probes (-1 past the end)."""
        ids = self.decode()
        probes = torch.as_tensor(probes, device=self.device).long()
        k = torch.searchsorted(ids, probes, side="left")
        vals = ids[k.clamp(max=self.n - 1)]
        return torch.where(k >= self.n, -1, vals)

    def intersect(self, other: "DeviceList") -> torch.Tensor:
        """Batched AND by a membership test: over ``self.decode()``, each
        id that ``other`` holds, else -1."""
        a = self.decode()
        b = other.decode()
        k = torch.searchsorted(b, a, side="left")
        hit = (k < other.n) & (b[k.clamp(max=other.n - 1)] == a)
        return torch.where(hit, a, -1)
