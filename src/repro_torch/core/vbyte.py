"""The Variable-Byte family: codecs and cost models (paper Table 2).

Full encode/decode for:
  * plain VByte (the paper's chosen format, decoded with Masked-VByte on x86;
    the block decoder of the query path lives in ``repro_torch.kernels``),
  * Stream-VByte layout (separate control/data streams -- the layout the
    block decode kernels consume; same size as Varint-GB),
Cost models for Varint-GB and Varint-G8IU (Table 2 space columns).

All functions operate on *values* (callers pass d-gaps).
"""

from __future__ import annotations

import numpy as np

from .costs import bit_length_np


# --------------------------------------------------------------------------
# Plain VByte
# --------------------------------------------------------------------------

def vbyte_encode(values: np.ndarray) -> np.ndarray:
    """Encode uint32 values into a plain VByte byte stream (LSB-first groups).

    7 data bits per byte; continuation bit (MSB) set on all but the last byte
    of each value, matching the paper's description (termination bit = 0).
    """
    values = np.asarray(values, dtype=np.uint64)
    nbytes = (bit_length_np(values) + 6) // 7
    total = int(nbytes.sum())
    out = np.empty(total, dtype=np.uint8)
    ends = np.cumsum(nbytes)
    starts = ends - nbytes
    # Vectorized over byte slots: for each value, bytes j = 0..nbytes-1 hold
    # bits [7j, 7j+7), continuation set for j < nbytes-1.
    max_b = int(nbytes.max()) if values.size else 0
    for j in range(max_b):
        sel = nbytes > j
        chunk = ((values[sel] >> np.uint64(7 * j)) & np.uint64(0x7F)).astype(np.uint8)
        cont = (nbytes[sel] - 1 > j).astype(np.uint8) << 7
        out[(starts[sel] + j)] = chunk | cont
    return out


def vbyte_decode(stream: np.ndarray, n: int) -> np.ndarray:
    """Decode n values from a plain VByte stream (vectorized numpy)."""
    if n == 0:
        return np.zeros(0, dtype=np.uint64)
    stream = np.asarray(stream, dtype=np.uint8)
    is_last = (stream & 0x80) == 0
    ends = np.flatnonzero(is_last)[:n]
    starts = np.empty(n, dtype=np.int64)
    starts[0] = 0
    starts[1:] = ends[:-1] + 1
    lens = ends - starts + 1
    out = np.zeros(n, dtype=np.uint64)
    max_b = int(lens.max()) if n else 0
    for j in range(max_b):
        sel = lens > j
        out[sel] |= (stream[starts[sel] + j] & np.uint64(0x7F)).astype(
            np.uint64
        ) << np.uint64(7 * j)
    return out


def vbyte_cost_bytes(values: np.ndarray) -> int:
    return int(((bit_length_np(values) + 6) // 7).sum())


# --------------------------------------------------------------------------
# Stream-VByte layout (control stream + data stream).  Size == Varint-GB.
# --------------------------------------------------------------------------

def streamvbyte_encode(values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Return (control, data): 2-bit lengths packed 4/byte and data bytes.

    Each value uses 1..4 data bytes (ceil(bits/8)); control code = len - 1.
    This is the layout the block decode kernels consume.
    """
    values = np.asarray(values, dtype=np.uint32)
    lens = np.clip((bit_length_np(values) + 7) // 8, 1, 4).astype(np.uint8)
    n = values.size
    # data stream
    total = int(lens.sum())
    data = np.empty(total, dtype=np.uint8)
    ends = np.cumsum(lens)
    starts = ends - lens
    v64 = values.astype(np.uint64)
    for j in range(4):
        sel = lens > j
        data[starts[sel] + j] = ((v64[sel] >> np.uint64(8 * j)) & np.uint64(0xFF)).astype(np.uint8)
    # control stream: 4 codes per byte, little-endian 2-bit fields
    codes = (lens - 1).astype(np.uint8)
    pad = (-n) % 4
    if pad:
        codes = np.concatenate([codes, np.zeros(pad, dtype=np.uint8)])
    codes = codes.reshape(-1, 4)
    control = (
        codes[:, 0] | (codes[:, 1] << 2) | (codes[:, 2] << 4) | (codes[:, 3] << 6)
    ).astype(np.uint8)
    return control, data


def streamvbyte_decode(control: np.ndarray, data: np.ndarray, n: int) -> np.ndarray:
    control = np.asarray(control, dtype=np.uint8)
    codes = np.empty(control.size * 4, dtype=np.uint8)
    codes[0::4] = control & 3
    codes[1::4] = (control >> 2) & 3
    codes[2::4] = (control >> 4) & 3
    codes[3::4] = (control >> 6) & 3
    lens = codes[:n].astype(np.int64) + 1
    ends = np.cumsum(lens)
    starts = ends - lens
    out = np.zeros(n, dtype=np.uint64)
    data = np.asarray(data, dtype=np.uint8)
    for j in range(4):
        sel = lens > j
        out[sel] |= data[starts[sel] + j].astype(np.uint64) << np.uint64(8 * j)
    return out


def streamvbyte_cost_bytes(values: np.ndarray) -> int:
    """== Varint-GB size: 2 control bits + 1..4 data bytes per value."""
    values = np.asarray(values)
    lens = np.clip((bit_length_np(values) + 7) // 8, 1, 4)
    return int(lens.sum()) + (values.size + 3) // 4


varint_gb_cost_bytes = streamvbyte_cost_bytes


def varint_g8iu_cost_bytes(values: np.ndarray) -> int:
    """Varint-G8IU: groups of 1 control byte + exactly 8 data bytes.

    Greedy packing; bytes that do not fit the remaining space of the 8-byte
    segment are wasted (paper section 4.1).
    """
    values = np.asarray(values)
    lens = np.clip((bit_length_np(values) + 7) // 8, 1, 4).astype(np.int64)
    groups = 1
    room = 8
    for ln in lens:
        if ln <= room:
            room -= ln
        else:
            groups += 1
            room = 8 - ln
    return groups * 9
