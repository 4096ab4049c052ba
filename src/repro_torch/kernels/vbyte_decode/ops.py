"""Host packer, numpy mirrors and numpy-in/numpy-out dispatch of the block
Stream-VByte decoder.

Counterpart of ``repro/kernels/vbyte_decode/ops.py``.  Two backends:
``"numpy"`` (the vectorized host mirror) and ``"torch"`` (the kernel
wrappers of ``kernel.py`` on ``device``: the CUDA kernels on a card, their
plain versions on the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from .kernel import BLOCK_BYTES, BLOCK_VALS, BM, decode_blocks
from .kernel import decode_search as decode_search_dev

BACKENDS = ("numpy", "torch")


# The family's identity and the signatures of its numpy / plain / CUDA
# triple, checked without importing anything by
# ``repro_torch.analyze.contracts``.  Outputs are the CUDA wrappers'
# (the numpy mirrors widen them to int64).
CONTRACT = {
    "family": "vbyte_decode",
    "identity": "integer",
    "ops": {
        "decode": {
            "roles": ["lens", "data"],
            "out": ["vals:int32[nr,128]"],
            "backends": {
                "numpy": {
                    "module": "ops",
                    "fn": "decode_blocks_np",
                    "params": ["lens:lens", "data:data"],
                },
                "ref": {
                    "module": "ref",
                    "fn": "decode_blocks_ref",
                    "params": ["lens:lens", "data:data", "rows:gather"],
                },
                "cuda": {
                    "module": "kernel",
                    "fn": "decode_blocks",
                    "source": "csrc/vbyte_decode.cu",
                    "params": ["lens:lens", "data:data", "rows:gather"],
                },
            },
        },
        "decode_search": {
            "roles": ["lens", "data", "base", "probe"],
            "out": ["value:int32[nr]", "rank:int32[nr]"],
            "backends": {
                "numpy": {
                    "module": "ops",
                    "fn": "decode_search_np",
                    "params": [
                        "lens:lens",
                        "data:data",
                        "block_base:base",
                        "rows:gather",
                        "probes:probe",
                    ],
                },
                "ref": {
                    "module": "ref",
                    "fn": "decode_search_ref",
                    "params": [
                        "lens:lens",
                        "data:data",
                        "block_base:base",
                        "rows:gather",
                        "pe:probe",
                        "codec_row:gather",
                    ],
                },
                "cuda": {
                    "module": "kernel",
                    "fn": "decode_search",
                    "source": "csrc/vbyte_decode.cu",
                    "params": [
                        "lens:lens",
                        "data:data",
                        "block_base:base",
                        "rows:gather",
                        "pe:probe",
                        "codec_row:gather",
                    ],
                },
            },
        },
    },
}


def pack_blocks(values: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    """Encode uint32 values into the kernels' block layout.

    Returns (lens [nb,128] int32, data [nb,512] uint8, n_values).  Blocks are
    padded to a multiple of BM * BLOCK_VALS values (pad value 0 -> len 1),
    as the reference pads them, so the host arrays stay byte-identical.
    """
    # lazy: repro_torch.core imports the engines, which import this module
    from ...core.costs import bit_length_np

    values = np.asarray(values, dtype=np.uint32)
    n = values.size
    per_super = BM * BLOCK_VALS
    n_pad = ((n + per_super - 1) // per_super) * per_super
    v = np.zeros(n_pad, np.uint32)
    v[:n] = values
    lens = np.clip((bit_length_np(v) + 7) // 8, 1, 4).astype(np.int32)
    lens = lens.reshape(-1, BLOCK_VALS)
    nb = lens.shape[0]
    data = np.zeros((nb, BLOCK_BYTES), np.uint8)
    v = v.reshape(nb, BLOCK_VALS).astype(np.uint64)
    ends = np.cumsum(lens, axis=1)
    starts = ends - lens
    for j in range(4):
        sel = lens > j
        rows, cols = np.nonzero(sel)
        data[rows, starts[sel] + j] = ((v[sel] >> np.uint64(8 * j)) & np.uint64(0xFF)).astype(np.uint8)
    return lens, data, n


def decode_blocks_np(lens: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Pure-numpy mirror of the block decoder (the host path).

    lens: [nb, 128] in 1..4; data: [nb, 512] uint8 -> [nb, 128] int64.
    """
    lens = np.asarray(lens, dtype=np.int64)
    data = np.asarray(data, dtype=np.uint8)
    starts = np.cumsum(lens, axis=1) - lens
    out = np.zeros(lens.shape, dtype=np.int64)
    rows = np.arange(lens.shape[0])[:, None]
    for j in range(4):
        sel = lens > j
        byte = data[rows, np.where(sel, starts + j, 0)].astype(np.int64)
        out |= np.where(sel, byte << (8 * j), 0)
    return out


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: expected one of {BACKENDS}")


def decode_block_rows(
    lens_rows: np.ndarray, data_rows: np.ndarray, backend: str = "numpy",
    device="cuda",
) -> np.ndarray:
    """Decode a gathered set of block rows; returns [n_rows, 128] int64.

    ``"torch"`` ships the rows to ``device`` and runs ``decode_blocks``
    there.  The engines keep the arena resident and call the kernel on it
    directly instead.
    """
    _check_backend(backend)
    if backend == "numpy":
        return decode_blocks_np(lens_rows, data_rows)
    out = decode_blocks(
        torch.as_tensor(np.asarray(lens_rows, np.int32), device=device),
        torch.as_tensor(np.asarray(data_rows, np.uint8), device=device),
    )
    return out.cpu().numpy().astype(np.int64)


def decode_search_np(
    lens: np.ndarray, data: np.ndarray, block_base: np.ndarray,
    rows: np.ndarray, probes: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized-numpy fused search: decode each cursor's arena row and
    resolve NextGEQ in one pass.  Duplicate rows are decoded once.

    Returns (value [C] int64, rank [C] int64): smallest in-row value >=
    probe (value of the LAST lane when none qualifies -- the host mirror's
    convention, unlike the kernels' 2^31-1) and the count of in-row values
    < probe (0..128).
    """
    rows = np.asarray(rows, dtype=np.int64)
    probes = np.asarray(probes, dtype=np.int64)
    urows, inv = np.unique(rows, return_inverse=True)
    gaps = decode_blocks_np(lens[urows], data[urows])
    uvals = np.asarray(block_base, np.int64)[urows][:, None] + np.cumsum(
        gaps + 1, axis=1
    )
    vals = uvals[inv]  # [C, 128]
    rank = (vals < probes[:, None]).sum(axis=1)
    value = vals[np.arange(len(rows)), np.minimum(rank, BLOCK_VALS - 1)]
    return value, rank


def decode_search(
    lens, data, block_base, rows, probes, backend: str = "numpy",
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Fused decode+NextGEQ over arena rows; numpy in/out, both backends.

    lens [nb,128] int32 / data [nb,512] uint8 / block_base [nb]: the block
    arena.  rows [C]: the arena row located for each cursor.  probes [C]:
    absolute probe docIDs, staged as int32 like the reference stages them.
    ``"numpy"`` follows ``decode_search_np``; ``"torch"`` ships the arena
    to ``device`` and follows the kernels' contract (2^31-1 when nothing
    in the row qualifies).  Returns (value [C] int64, rank [C] int64).
    """
    _check_backend(backend)
    if backend == "numpy":
        return decode_search_np(lens, data, block_base, rows, probes)

    def dev(x, dtype):
        return torch.as_tensor(np.asarray(x).astype(dtype), device=device)

    value, rank = decode_search_dev(
        dev(lens, np.int32), dev(data, np.uint8), dev(block_base, np.int32),
        dev(rows, np.int32), dev(probes, np.int32),
    )
    out = torch.stack([value, rank]).cpu().numpy().astype(np.int64)
    return out[0], out[1]
