"""Minimal 8-bit PNG writer and reader (zlib + numpy).

Lets the synthetic COLMAP scene be written and read back where neither
imageio nor PIL is installed. Handles non-interlaced 8-bit grey, RGB and
RGBA with every PNG row filter.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> channels


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(
        ">I", zlib.crc32(tag + data) & 0xFFFFFFFF
    )


def write_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 [H, W] or [H, W, 3|4] image (filter 0, zlib level 6)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 3: 2, 4: 6}[c]
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1
    ).tobytes()
    with open(path, "wb") as f:
        f.write(_SIG)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit non-interlaced grey/RGB/RGBA PNG as uint8 [H, W(, C)]."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat = 8, []
    w = h = c = None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
            if depth != 8 or ctype not in _CHANNELS or interlace:
                raise ValueError(f"{path}: unsupported PNG (depth {depth}, type {ctype})")
            c = _CHANNELS[ctype]
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * c)
    out = np.zeros((h, w * c), np.int32)
    prev = np.zeros(w * c, np.int32)
    for y in range(h):
        ftype, cur = rows[y, 0], rows[y, 1:].astype(np.int32)
        if ftype == 1:  # Sub
            line = cur.reshape(w, c)
            cur = (np.cumsum(line, axis=0) % 256).reshape(-1)
        elif ftype == 2:  # Up
            cur = (cur + prev) % 256
        elif ftype in (3, 4):  # Average, Paeth: sequential along the row
            cur = cur.copy()
            for x in range(w * c):
                a = cur[x - c] if x >= c else 0
                b = prev[x]
                if ftype == 3:
                    pred = (a + b) // 2
                else:
                    cc = prev[x - c] if x >= c else 0
                    p = a + b - cc
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else cc)
                cur[x] = (cur[x] + pred) % 256
        out[y] = cur
        prev = cur
    img = out.astype(np.uint8).reshape(h, w, c)
    return img[..., 0] if c == 1 else img
