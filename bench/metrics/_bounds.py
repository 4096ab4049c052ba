"""Bytes a kernel launch's answers need, from its inputs (the counts of
the port's kernel table, frozen here): each input byte the answers need
counted once, each output byte once.  ``launch_bytes(name, args,
kwargs)`` takes one probed call of the kernel's wrapper."""

from __future__ import annotations

import torch


def _arg(args, kwargs, i: int, name: str):
    return args[i] if len(args) > i else kwargs.get(name)


def decode_search_bytes(args, kwargs) -> int:
    """``decode_search(lens, data, block_base, rows, pe, codec_row)``:
    each distinct row's 512 B of lens, the bytes of its data that hold
    values, its base (4 B) and codec row (4 B in a multi-codec arena);
    each distinct cursor, its row, probe, value and rank (16 B)."""
    lens, rows, pe = args[0], args[3], args[4]
    codec_row = _arg(args, kwargs, 5, "codec_row")
    rows = rows.long()
    cursors = torch.unique((rows << 32) | (pe.long() & 0xFFFFFFFF)).numel()
    u = torch.unique(rows)
    tile = u if codec_row is None else codec_row[u].long()
    used = int(lens[tile].sum())
    per_row = 512 + 4 + (0 if codec_row is None else 4)
    return u.numel() * per_row + used + cursors * 16


def score_rows_bytes(args, kwargs) -> int:
    """``bm25_score_rows(flens, fdata, norm_q, idf, lob, table, k1p1,
    rows)``: each distinct row's freq tile (512 B of lens, 512 B of data),
    norm codes (128 B), owning list (4 B) and scores (512 B); idf and the
    norm table once."""
    norm_q, idf, table = args[2], args[3], args[5]
    rows = _arg(args, kwargs, 7, "rows")
    n = norm_q.shape[0] if rows is None else torch.unique(rows).numel()
    return n * (512 + 512 + 128 + 4 + 512) + idf.numel() * 4 + table.numel() * 4


def roofline_pct(nbytes: int, kernel_s: float, bytes_per_s: float):
    """The least time the bytes take at the memory rate, as a share of the
    kernel's device time; None where nothing ran."""
    if kernel_s <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / bytes_per_s / kernel_s
