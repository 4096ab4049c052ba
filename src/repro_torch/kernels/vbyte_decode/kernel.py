"""Wrappers of the CUDA block Stream-VByte kernels (``csrc/vbyte_decode.cu``).

Counterpart of ``repro/kernels/vbyte_decode/kernel.py``, whose Pallas
kernels rebuild the byte gather as one-hot MXU matmuls; the CUDA kernels
read the bytes from shared memory instead (see the note atop the source).

A wrapper takes its plain version (``ref.py``) only for tensors on the
CPU.  For CUDA tensors it checks device, dtype, shape and contiguity,
allocates the outputs, launches the kernel on the current stream and
raises if the launch failed; there is no fallback.  ``<wrapper>.launches``
counts the launches.
"""

from __future__ import annotations

import torch

from .. import _build
from . import ref

BLOCK_VALS = 128
BLOCK_BYTES = 512
BM = 8  # pack_blocks pads the arena to a multiple of 8 rows

_LIB = "vbyte_decode"


def on_cpu(*tensors) -> bool:
    """True when the inputs lie on the CPU: the plain versions serve them.

    Raises on inputs spread over several devices, or on a device that is
    neither the CPU nor CUDA.
    """
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"kernel inputs must share one device, got {devs}")
    (dev,) = devs
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return False


def require(t, name: str, dtype, width: int | None = None, ndim: int = 2,
            align: int = 4) -> None:
    """Reject what a kernel cannot take: wrong dtype, shape or layout."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim or (width is not None and t.shape[-1] != width):
        raise ValueError(f"{name}: bad shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: must be {align}-byte aligned")
    if t.numel() >= 2**31:
        raise ValueError(f"{name}: too large for int32 indexing")


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def decode_blocks(lens, data, rows=None):
    """[n,128] int32 decoded values (gap - 1) of arena rows.

    lens [R,128] int32, data [R,512] uint8: the arena (or any packed rows);
    rows [n] int32 picks the rows to decode (None: every row).
    """
    if on_cpu(lens, data, rows):
        return ref.decode_blocks_ref(lens, data, rows)
    require(lens, "lens", torch.int32, BLOCK_VALS, align=16)
    require(data, "data", torch.uint8, BLOCK_BYTES, align=16)
    if lens.shape[0] != data.shape[0]:
        raise ValueError("lens and data must hold the same rows")
    if rows is not None:
        require(rows, "rows", torch.int32, ndim=1)
    n = lens.shape[0] if rows is None else rows.shape[0]
    out = torch.empty((n, BLOCK_VALS), dtype=torch.int32, device=lens.device)
    if n:
        fn = _build.bind(_build.load(_LIB), "vbyte_decode_blocks", 4, 1)
        _build.check(
            fn(lens.data_ptr(), data.data_ptr(), _build.ptr(rows),
               out.data_ptr(), n, _stream(lens)),
            "vbyte_decode_blocks",
        )
        decode_blocks.launches += 1
    return out


decode_blocks.launches = 0


def decode_search(lens, data, block_base, rows, pe, codec_row=None):
    """Fused decode + NextGEQ: (value [C] int32, rank [C] int32).

    lens [R,128] int32, data [R,512] uint8, block_base [nb] int32: the
    resident arena.  rows [C] int32: the block row located for each cursor
    (mapped through ``codec_row`` [nb] int32 to a row of lens/data in a
    multi-codec arena).  pe [C] int32: the probes.  value is the smallest
    docID >= probe in the row (2^31-1 if none), rank the count of row
    docIDs < probe -- the Pallas kernel's contract.
    """
    if on_cpu(lens, data, block_base, rows, pe, codec_row):
        return ref.decode_search_ref(lens, data, block_base, rows, pe, codec_row)
    require(lens, "lens", torch.int32, BLOCK_VALS, align=16)
    require(data, "data", torch.uint8, BLOCK_BYTES, align=16)
    require(block_base, "block_base", torch.int32, ndim=1)
    require(rows, "rows", torch.int32, ndim=1)
    require(pe, "pe", torch.int32, ndim=1)
    if codec_row is not None:
        require(codec_row, "codec_row", torch.int32, ndim=1)
    if pe.shape != rows.shape:
        raise ValueError("rows and pe must have one entry per cursor")
    n = rows.shape[0]
    value = torch.empty(n, dtype=torch.int32, device=rows.device)
    rank = torch.empty(n, dtype=torch.int32, device=rows.device)
    if n:
        fn = _build.bind(_build.load(_LIB), "vbyte_decode_search", 8, 1)
        _build.check(
            fn(lens.data_ptr(), data.data_ptr(), block_base.data_ptr(),
               _build.ptr(codec_row), rows.data_ptr(), pe.data_ptr(),
               value.data_ptr(), rank.data_ptr(), n, _stream(rows)),
            "vbyte_decode_search",
        )
        decode_search.launches += 1
    return value, rank


decode_search.launches = 0
