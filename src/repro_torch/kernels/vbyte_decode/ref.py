"""Plain PyTorch versions of the two block Stream-VByte kernels.

Counterparts of ``repro/kernels/vbyte_decode/ref.py``, with the signatures
of the CUDA wrappers in ``kernel.py``: they take the resident arena and
gather the located rows themselves.  The CPU path of the port runs them;
on the card they only serve as the yardstick the kernels are held to.
Bytes are widened to int32 and values assembled in int64, then narrowed
to int32, which wraps exactly as the reference's int32 arithmetic does.
"""

from __future__ import annotations

import torch

I32_MAX = 2**31 - 1


def _storage_rows(rows, codec_row):
    rows = rows.long()
    return rows, (rows if codec_row is None else codec_row[rows].long())


def decode_blocks_ref(lens, data, rows=None):
    """lens [R,128] int32 (1..4); data [R,512] uint8; rows [n] int32 or
    None for every row -> [n,128] int32 decoded values (gap - 1).

    Value i of a row occupies ``data[s_i : s_i + lens_i]`` little-endian,
    with ``s_i`` the exclusive prefix sum of the row's lens.
    """
    if rows is not None:
        rows = rows.long()
        lens, data = lens[rows], data[rows]
    lens = lens.long()
    starts = torch.cumsum(lens, 1) - lens
    d = data.to(torch.int32)
    last = d.shape[1] - 1
    out = torch.zeros(lens.shape, dtype=torch.int64, device=lens.device)
    for j in range(4):
        byte = torch.gather(d, 1, (starts + j).clamp(0, last)).long()
        out |= torch.where(lens > j, byte << (8 * j), 0)
    return out.to(torch.int32)


def decode_sorted_ref(lens, data, base: int = -1):
    """Full d-gap decode of every block: blocks -> gaps (the +1
    convention) -> absolute ids, int64 [nb * 128] (padding lanes
    included)."""
    gaps = decode_blocks_ref(lens, data).reshape(-1).long() + 1
    return base + torch.cumsum(gaps, 0)


def row_docids(lens, data, block_base, rows, codec_row=None):
    """[n,128] int32 docIDs ``block_base + cumsum(gap)`` of located rows."""
    rows, srows = _storage_rows(rows, codec_row)
    gaps = decode_blocks_ref(lens, data, srows).long() + 1
    vals = block_base[rows].long()[:, None] + torch.cumsum(gaps, 1)
    return vals.to(torch.int32)


def decode_search_ref(lens, data, block_base, rows, pe, codec_row=None):
    """Fused decode + NextGEQ over located arena rows.

    rows [C] int32 block rows (``codec_row`` maps them to rows of
    lens/data in a multi-codec arena), pe [C] int32 probes.  Returns
    (value [C] int32, rank [C] int32): the smallest row docID >= probe
    (2^31-1 if none) and the count of row docIDs < probe.
    """
    vals = row_docids(lens, data, block_base, rows, codec_row)
    below = vals < pe[:, None]
    full = torch.full_like(vals, I32_MAX)
    value = torch.where(below, full, vals).amin(1)
    rank = below.sum(1, dtype=torch.int32)
    return value, rank
