"""A small PNG reader for the world bitmaps, from ``zlib``, ``struct`` and
numpy alone.

It reads what Stage world bitmaps are saved as: 8-bit samples, no
interlacing, colour types 0 (grey), 2 (RGB), 4 (grey + alpha) and 6 (RGBA),
any of the five scanline filters (PNG spec, section 9).  Anything else
(palette images, 1/2/4/16-bit samples, Adam7 interlacing, a bad CRC or a
truncated stream) raises ``ValueError`` with the reason.  :func:`read_grey`
converts to grey as PIL's ``Image.convert("L")`` does, so the world compiler
sees the bitmap the JAX package's loader sees.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: Samples a pixel for each colour type this reader takes.
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters: ``rows`` (H, 1 + stride) uint8, each
    row its filter type and then its filtered bytes."""
    h, stride = rows.shape[0], rows.shape[1] - 1
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, f = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:                                     # None
            cur = f.copy()
        elif kind == 1:                                   # Sub: cumulative
            cur = np.cumsum(f.reshape(-1, bpp), axis=0,   # per sample lane
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:                                   # Up
            cur = f + prior
        elif kind in (3, 4):                              # Average, Paeth
            cur = _sequential(kind, f.tobytes(), prior.tobytes(), bpp)
        else:
            raise ValueError(f"unknown PNG scanline filter {kind} in row {y}")
        out[y] = cur
        prior = cur
    return out


def _sequential(kind: int, f: bytes, prior: bytes, bpp: int) -> np.ndarray:
    """Average (3) or Paeth (4) over one row: each byte depends on the
    reconstructed byte ``bpp`` to its left, so this runs byte by byte."""
    cur = bytearray(f)
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prior[i]
        if kind == 3:
            pred = (a + b) >> 1
        else:
            c = prior[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def read_png(path) -> np.ndarray:
    """The image at ``path`` as (H, W, C) uint8 samples, C = 1, 3, 2 or 4
    for colour types 0, 2, 4 and 6."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    header, idat, pos = None, [], 8
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"{path}: truncated before the IEND chunk")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"{path}: chunk {kind!r} is truncated")
        body = data[pos + 8:end]
        if zlib.crc32(kind + body) != struct.unpack(">I", data[end:end + 4])[0]:
            raise ValueError(f"{path}: chunk {kind!r} fails its CRC")
        pos = end + 4
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        elif kind != b"PLTE" and kind[0] & 0x20 == 0:
            raise ValueError(f"{path}: unknown critical chunk {kind!r}")
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or no IDAT chunk")
    w, h, depth, colour, compression, filtering, interlace = header
    if colour not in _CHANNELS:
        raise ValueError(f"{path}: colour type {colour} (palette or "
                         f"invalid); only types 0, 2, 4 and 6 are read")
    if depth != 8:
        raise ValueError(f"{path}: bit depth {depth}; only 8-bit samples "
                         f"are read")
    if interlace != 0:
        raise ValueError(f"{path}: interlaced (Adam7); only non-interlaced "
                         f"images are read")
    if compression != 0 or filtering != 0:
        raise ValueError(f"{path}: unknown compression {compression} or "
                         f"filter method {filtering}")
    c = _CHANNELS[colour]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt image data ({e})") from None
    if len(raw) != h * (1 + w * c):
        raise ValueError(f"{path}: {len(raw)} bytes of image data, not "
                         f"{h * (1 + w * c)} for {w} x {h} x {c}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + w * c)
    return _unfilter(rows, c).reshape(h, w, c)


def to_grey(pixels: np.ndarray) -> np.ndarray:
    """(H, W, C) uint8 samples -> (H, W) uint8 grey, as PIL's
    ``convert("L")``: grey samples as they are, colour by ITU-R 601-2 luma
    in PIL's fixed-point arithmetic, L = (19595 R + 38470 G + 7471 B +
    0x8000) >> 16; alpha is ignored."""
    c = pixels.shape[-1]
    if c in (1, 2):
        return pixels[..., 0].copy()
    rgb = pixels[..., :3].astype(np.uint32)
    luma = (rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
            + 0x8000) >> 16
    return luma.astype(np.uint8)


def read_grey(path) -> np.ndarray:
    """The PNG at ``path`` as (H, W) uint8 grey (see :func:`to_grey`)."""
    return to_grey(read_png(path))
