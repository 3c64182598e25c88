"""Minimal PNG codec on the standard library (``zlib`` + ``struct``) and numpy.

Decodes 8-bit, non-interlaced grayscale, gray+alpha, RGB and RGBA PNGs to
a gray or RGB uint8 array, and encodes gray and RGB uint8 arrays. The port's
page path and the pipeline's render workers use this instead of PIL.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> channels, for bit depth 8
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _paeth_row(line: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    out = bytearray(len(line))
    for i in range(len(line)):
        a = out[i - bpp] if i >= bpp else 0
        b = int(prev[i])
        c = int(prev[i - bpp]) if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[i] = (int(line[i]) + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _average_row(line: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    out = bytearray(len(line))
    for i in range(len(line)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (int(line[i]) + ((a + int(prev[i])) >> 1)) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    rows = raw.reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros((stride,), np.uint8)
    for y in range(height):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: running sum along each channel, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = line + prev
        elif ftype == 3:
            cur = _average_row(line, prev, bpp)
        elif ftype == 4:
            cur = _paeth_row(line, prev, bpp)
        else:
            raise ValueError(f"PNG: bad filter type {ftype} in row {y}")
        out[y] = cur
        prev = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) uint8 gray or (H, W, 3) uint8 RGB (alpha
    dropped)."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    width = height = None
    idat = []
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("PNG: truncated chunk")
        pos += 12 + length
        if ctype == b"IHDR":
            (width, height, depth, color, _comp, _filt,
             interlace) = struct.unpack(">IIBBBBB", body)
            if depth != 8 or color not in _CHANNELS or interlace:
                raise ValueError(
                    f"PNG: unsupported depth {depth} / color type {color} / "
                    f"interlace {interlace} (8-bit, non-interlaced gray, "
                    f"gray+alpha, RGB or RGBA only)")
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if width is None or not idat:
        raise ValueError("PNG: missing IHDR or IDAT")
    bpp = _CHANNELS[color]
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError("PNG: image data size does not match the header")
    px = _unfilter(raw, height, stride, bpp).reshape(height, width, bpp)
    if bpp in (1, 2):
        return np.ascontiguousarray(px[..., 0])
    return np.ascontiguousarray(px[..., :3])


def decode_png_rgb(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 RGB (alpha dropped, gray replicated)."""
    px = decode_png(data)
    return np.repeat(px[..., None], 3, axis=-1) if px.ndim == 2 else px


def _chunk(ctype: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(ctype + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", crc)


def _encode(px: np.ndarray, color: int, level: int) -> bytes:
    h, w = px.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           px.reshape(h, -1)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def encode_png_rgb(rgb: np.ndarray, level: int = 6) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes (filter type 0 on every row)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {rgb.shape}")
    return _encode(rgb, 2, level)


def encode_png_gray(gray: np.ndarray, level: int = 6) -> bytes:
    """(H, W) uint8 -> 8-bit grayscale PNG bytes (filter type 0)."""
    gray = np.ascontiguousarray(gray, np.uint8)
    if gray.ndim != 2:
        raise ValueError(f"expected (H, W) uint8, got {gray.shape}")
    return _encode(gray, 0, level)
