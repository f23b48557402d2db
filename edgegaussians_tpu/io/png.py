"""Minimal PNG reader and writer (standard library + NumPy only).

Covers what the datasets and ``cli/make_synthetic`` use: 8-bit grayscale,
RGB and RGBA, non-interlaced, every scanline filter (PNG spec §9). Any
other format (palette, 16-bit, grayscale+alpha, Adam7 interlace) raises
``ValueError`` instead of being misread.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}          # color type -> samples per pixel


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0]
        if zlib.crc32(ctype + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {ctype!r}: CRC mismatch")
        yield ctype, body
        pos += 12 + length


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters -> [height, stride] uint8."""
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(height):
        ftype = int(rows[y, 0])
        line = rows[y, 1:].astype(np.int64)
        if ftype == 0:                                     # None
            cur = line
        elif ftype == 1:                                   # Sub
            cur = np.zeros(stride, np.int64)
            for c in range(bpp):      # running sum along each channel
                cur[c::bpp] = np.cumsum(line[c::bpp]) & 0xFF
        elif ftype == 2:                                   # Up
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):                              # Average, Paeth
            cur = _unfilter_sequential(line.tolist(), prev.tolist(), bpp,
                                       ftype == 4)
        else:
            raise ValueError(f"PNG: unknown scanline filter {ftype}")
        out[y] = cur
        prev = np.asarray(cur, np.int64)
    return out


def _unfilter_sequential(line, prev, bpp: int, paeth: bool):
    """Average / Paeth predictors (each byte depends on its left
    neighbour, so these run element by element on Python ints)."""
    cur = [0] * len(line)
    for x, v in enumerate(line):
        a = cur[x - bpp] if x >= bpp else 0
        b = prev[x]
        if paeth:
            c = prev[x - bpp] if x >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        else:
            pred = (a + b) >> 1
        cur[x] = (v + pred) & 0xFF
    return cur


def read_png(path) -> np.ndarray:
    """Decode a PNG -> uint8 array [H, W] (gray) or [H, W, C] (RGB/RGBA)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, ctype, comp, filt, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace or comp or filt:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, color type "
            f"{ctype}, interlace {interlace}); only 8-bit gray/RGB/RGBA "
            "non-interlaced images are supported")
    ch = _CHANNELS[ctype]
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != height * (width * ch + 1):
        raise ValueError(f"{path}: PNG image data has the wrong length")
    img = _unfilter(raw, height, width * ch, ch)
    return img.reshape(height, width) if ch == 1 else \
        img.reshape(height, width, ch)


def to_gray(img: np.ndarray) -> np.ndarray:
    """uint8 [H,W] or [H,W,C] -> uint8 luminance [H,W] (ITU-R 601-2 with
    the same fixed-point rounding as PIL's ``convert("L")``; alpha is
    ignored)."""
    if img.ndim == 2:
        return img
    rgb = img[..., :3].astype(np.uint32)
    lum = (rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
           + 0x8000) >> 16
    return lum.astype(np.uint8)


def write_png(path, img: np.ndarray) -> None:
    """Encode a uint8 [H, W] / [H, W, 3] / [H, W, 4] array as a PNG
    (filter 0 on every scanline)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png needs uint8 data, got {img.dtype}")
    ch = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 3: 2, 4: 6}.get(ch)
    if ctype is None or img.ndim not in (2, 3):
        raise ValueError(f"write_png: unsupported shape {img.shape}")
    height, width = img.shape[:2]
    rows = img.reshape(height, width * ch)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)

    def chunk(ctype_b: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + ctype_b + body
                + struct.pack(">I", zlib.crc32(ctype_b + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", width, height, 8, ctype, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + chunk(b"IEND", b""))
