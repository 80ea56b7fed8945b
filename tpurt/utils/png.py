"""PNG encode/decode with the standard library (zlib + struct).

Covers what the renderer reads and writes: 8-bit, non-interlaced PNGs of
color type gray (0), RGB (2), palette (3), gray+alpha (4) and RGBA (6) on
decode; 8-bit gray, RGB or RGBA on encode.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray) -> bytes:
    """(H, W), (H, W, 1), (H, W, 3) or (H, W, 4) u8 -> PNG bytes."""
    a = np.asarray(image, np.uint8)
    if a.ndim == 2:
        a = a[..., None]
    h, w, c = a.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, w * c)],
                          axis=1)  # filter type 0 on every row
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _paeth(left, up, up_left):
    p = left + up - up_left
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
    return np.where((pa <= pb) & (pa <= pc), left,
                    np.where(pb <= pc, up, up_left))


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = raw[y, 0]
        line = raw[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:    # Sub: running sum along the row per channel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:    # Up
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):   # Average, Paeth: sequential per pixel
            lp = line.reshape(-1, bpp)
            up = prev.reshape(-1, bpp)
            cp = np.zeros_like(lp)
            left = np.zeros(bpp, np.int32)
            up_left = np.zeros(bpp, np.int32)
            for x in range(lp.shape[0]):
                pred = ((left + up[x]) >> 1 if ftype == 3
                        else _paeth(left, up[x], up_left))
                cp[x] = (lp[x] + pred) & 0xFF
                left, up_left = cp[x], up[x]
            cur = cp.reshape(-1)
        else:
            raise ValueError(f"PNG: unknown filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) u8 with C = 1 (gray), 3 (RGB, palette
    without transparency) or 4 (RGBA, gray+alpha, palette with tRNS)."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG stream")
    pos = 8
    idat = []
    palette = trns = None
    w = h = depth = color_type = interlace = None
    while pos < len(data):
        n, kind = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            w, h, depth, color_type, _, _, interlace = struct.unpack(
                ">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if depth != 8 or interlace != 0 or color_type not in _CHANNELS:
        raise ValueError(f"PNG: unsupported format (bit depth {depth}, "
                         f"color type {color_type}, interlace {interlace})")
    c = _CHANNELS[color_type]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    px = _unfilter(raw.reshape(h, 1 + w * c), h, w * c, c).reshape(h, w, c)
    if color_type == 3:
        idx = px[..., 0]
        rgb = palette[idx]
        if trns is None:
            return rgb
        alpha = np.full(len(palette), 255, np.uint8)
        alpha[:len(trns)] = trns
        return np.concatenate([rgb, alpha[idx][..., None]], axis=-1)
    if color_type == 4:
        return np.concatenate([np.repeat(px[..., :1], 3, axis=-1),
                               px[..., 1:]], axis=-1)
    return px
