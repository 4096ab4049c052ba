"""Plain PyTorch version of the Elias-Fano NextGEQ kernel.

Counterpart of ``repro/kernels/ef_search/ref.py`` (which re-derives the
Pallas tile arithmetic of ``_ef_search_tile``), with the signature of the
CUDA wrapper in ``kernel.py``.  The arithmetic is the reference's, step
for step, in int32/int64 (torch's uint16 support is thin): the inclusive
one-counts over the 384-bit high stream, ``Z(b)`` for the ranks and
``S(r)`` for the selected lane's high part.
"""

from __future__ import annotations

import torch

BLOCK_VALS = 128
EF_HI_WORDS = 24  # 16 high-stream bits per int32 word
EF_HI_BITS = EF_HI_WORDS * 16
I32_MAX = 2**31 - 1


def ef_search_tiles(lo, hi, lbits, base, probe):
    """Gathered tiles -> (value [n] int32, rank [n] int32).

    lo [n,128], hi [n,24] (16-bit words), lbits / base / probe [n]; all
    integer tensors, widened here.
    """
    dev = lo.device
    lo = lo.long()
    hi = hi.long()
    l = lbits.long()[:, None]
    base = base.long()[:, None]
    probe = probe.long()[:, None]
    shift = torch.arange(16, device=dev)
    bits = (hi[:, :, None] >> shift) & 1  # [n, 24, 16]
    inner = torch.cumsum(bits, 2)
    wo = inner[:, :, 15:16]
    oc = torch.cumsum(wo, 1) - wo + inner  # inclusive one counts
    pos1 = torch.arange(EF_HI_WORDS, device=dev)[:, None] * 16 + shift + 1
    # rebased probe in the reference's int32 arithmetic (wraps like it)
    rp = (probe - base - 1).to(torch.int32).long().clamp(min=0)
    hp = rp >> l
    lp = rp & ((1 << l) - 1)
    hp3 = hp.clamp(max=EF_HI_BITS)[:, :, None]
    z_lt = (oc >= pos1 - (hp3 - 1)).sum((1, 2))[:, None]
    z_le = (oc >= pos1 - hp3).sum((1, 2))[:, None]
    big = hp > 255
    count_lt = torch.where(hp <= 0, 0, z_lt - (hp - 1))
    count_lt = torch.where(big, BLOCK_VALS, count_lt)
    count_le = torch.where(big, BLOCK_VALS, z_le - hp)
    lane = torch.arange(BLOCK_VALS, device=dev)
    mid = (
        (lane >= count_lt) & (lane < count_le) & (lo < lp)
    ).sum(1, keepdim=True)
    rank = torch.where(big, BLOCK_VALS, count_lt + mid)
    rc = rank.clamp(max=BLOCK_VALS - 1)
    sel = (oc <= rc[:, :, None]).sum((1, 2))[:, None]
    high_r = sel - rc
    low_r = torch.gather(lo, 1, rc)
    value = (base + 1 + ((high_r << l) | low_r)).to(torch.int32)
    value = torch.where(rank >= BLOCK_VALS, I32_MAX, value)
    return value[:, 0], rank[:, 0].to(torch.int32)


def ef_search_ref(lo, hi, lbits, block_base, rows, pe, codec_row=None):
    """Fused EF NextGEQ over located tiles: (value [C], rank [C]) int32.

    lo [E,128] / hi [E,24] / lbits [E]: the resident EF tiles (int32);
    block_base [nb] int32; rows [C] int32 block rows, mapped through
    ``codec_row`` [nb] to tile rows (None: rows are tile rows); pe [C].
    """
    rows = rows.long()
    er = rows if codec_row is None else codec_row[rows].long()
    return ef_search_tiles(lo[er], hi[er], lbits[er], block_base[rows], pe)
