"""JBIG2 halftone content: pattern dictionaries + halftone regions
(ITU-T T.88 6.6/6.7, segment syntax 7.4.4/7.4.5, gray-code decoding
Annex C).

Halftone coding is JBIG2's mode for dithered/screened images: a pattern
dictionary holds GRAYMAX+1 small cell bitmaps, and the region is a grid
of gray-scale indices (decoded as gray-coded bitplanes through the
generic-region coder, one shared MQ decoder + context bank for all
planes, C.5) whose cells are stamped along a skewed grid. Arithmetic
variants only (HMMR/HDMMR raise; same boundary as the symbol layer —
encoders that emit MMR halftones are rare and a half-validated decoder
would be worse than a clean refusal).

Like the rest of the JBIG2 stack, each procedure has an encoder twin used
for fixtures: round-trip is the validation (no trusted codec in this
image; see tests/test_jbig2_halftone.py).
"""

from __future__ import annotations

import struct

import numpy as np

from karanta_tpu_torch.pdf.jbig2 import (JBIG2Error, MQContexts, MQDecoder,
                                   MQEncoder, _parse_region_info,
                                   _RegionInfo, _template_offsets, _px,
                                   decode_generic_region)


def _graybits(graymax: int) -> int:
    bits = 1
    while graymax >= (1 << bits):
        bits += 1
    return bits


# ----------------------------------------------------------------------
# 6.7: pattern dictionary — one collective bitmap split into cells
# ----------------------------------------------------------------------

def _pattern_at(hdpw: int, template: int):
    """AT pixels for the collective bitmap (6.7.5): A1 = (-HDPW, 0)."""
    a1 = (-hdpw, 0)
    if template == 0:
        return (a1, (-3, -1), (2, -2), (-2, -2))
    return (a1,)


def decode_pattern_dict(data: bytes) -> list[np.ndarray]:
    """Segment payload -> [GRAYMAX+1 patterns of (HDPH, HDPW)]."""
    flags = data[0]
    if flags & 1:
        raise JBIG2Error("MMR pattern dictionaries unsupported")
    template = (flags >> 1) & 3
    hdpw, hdph = data[1], data[2]
    graymax = struct.unpack_from(">I", data, 3)[0]
    if not hdpw or not hdph or graymax > (1 << 16):
        raise JBIG2Error("bad pattern dictionary parameters")
    collective = decode_generic_region(
        data[7:], (graymax + 1) * hdpw, hdph, template,
        at=_pattern_at(hdpw, template), tpgdon=False)
    return [collective[:, i * hdpw:(i + 1) * hdpw].copy()
            for i in range(graymax + 1)]


def encode_pattern_dict(patterns: list[np.ndarray],
                        template: int = 0) -> bytes:
    from karanta_tpu_torch.pdf.jbig2 import encode_generic_region

    hdph, hdpw = patterns[0].shape
    assert all(p.shape == (hdph, hdpw) for p in patterns)
    collective = np.concatenate(patterns, axis=1)
    out = bytes([(template & 3) << 1, hdpw, hdph])
    out += struct.pack(">I", len(patterns) - 1)
    out += encode_generic_region(collective, template,
                                 at=_pattern_at(hdpw, template))
    return out


# ----------------------------------------------------------------------
# Annex C: gray-code bitplane decoding of the index grid
# ----------------------------------------------------------------------

def _grayscale_at(template: int):
    return (((3 if template <= 1 else 2), -1), (-3, -1), (2, -2), (-2, -2))


def decode_grayscale(data: bytes, hgw: int, hgh: int, bits: int,
                     template: int,
                     skip: np.ndarray | None) -> np.ndarray:
    """(HGH, HGW) int32 grid of gray values; one shared MQ decoder +
    context bank across all bitplanes (C.5)."""
    at = _grayscale_at(template)[: 4 if template == 0 else 1]
    mq = MQDecoder(data)
    cx = MQContexts(1 << 16)
    planes = []
    for _ in range(bits):  # MSB first
        planes.append(decode_generic_region(
            b"", hgw, hgh, template, at=at, tpgdon=False, cx=cx, mq=mq,
            skip=skip))
    # gray -> binary: plane[j] ^= plane[j+1] walking down from the MSB
    for j in range(1, bits):
        planes[j] ^= planes[j - 1]
    value = np.zeros((hgh, hgw), np.int32)
    for j, plane in enumerate(planes):  # planes[0] is the MSB
        value |= plane.astype(np.int32) << (bits - 1 - j)
    return value


def encode_grayscale(grid: np.ndarray, bits: int, template: int = 0,
                     skip: np.ndarray | None = None) -> bytes:
    from karanta_tpu_torch.pdf.jbig2 import _template_offsets as offsets_of

    at = _grayscale_at(template)[: 4 if template == 0 else 1]
    offs = offsets_of(template, at)
    enc = MQEncoder()
    cx = MQContexts(1 << 16)
    # binary -> gray, MSB first
    binary = [((grid >> (bits - 1 - j)) & 1).astype(np.uint8)
              for j in range(bits)]
    gray = [binary[0]]
    for j in range(1, bits):
        gray.append(binary[j] ^ binary[j - 1])
    h, w = grid.shape
    for plane in gray:
        for y in range(h):
            for x in range(w):
                if skip is not None and skip[y, x]:
                    continue
                context = 0
                for bit, (dx, dy) in enumerate(offs):
                    if _px(plane, x + dx, y + dy):
                        context |= 1 << bit
                enc.encode(int(plane[y, x]), cx, context)
    return enc.flush()


# ----------------------------------------------------------------------
# 6.6: halftone region
# ----------------------------------------------------------------------

def _grid_positions(hgw, hgh, hgx, hgy, hrx, hry):
    """Cell origins along the (possibly skewed) 8.8 fixed-point grid."""
    mg = np.arange(hgh).reshape(-1, 1)
    ng = np.arange(hgw).reshape(1, -1)
    x = (hgx + mg * hry + ng * hrx) >> 8
    y = (hgy + mg * hrx - ng * hry) >> 8
    return x, y


def _skip_bitmap(x, y, hpw, hph, hbw, hbh) -> np.ndarray:
    return ((x + hpw <= 0) | (x >= hbw)
            | (y + hph <= 0) | (y >= hbh)).astype(np.uint8)


def decode_halftone_region(data: bytes, patterns: list[np.ndarray]
                           ) -> tuple[_RegionInfo, np.ndarray]:
    if not patterns:
        raise JBIG2Error("halftone region with no pattern dictionary")
    info, pos = _parse_region_info(data)
    flags = data[pos]
    pos += 1
    if flags & 1:
        raise JBIG2Error("MMR halftone regions unsupported")
    template = (flags >> 1) & 3
    enable_skip = (flags >> 3) & 1
    comb_op = (flags >> 4) & 7
    def_pixel = (flags >> 7) & 1
    hgw, hgh, hgx, hgy = struct.unpack_from(">IIii", data, pos)
    pos += 16
    hrx, hry = struct.unpack_from(">HH", data, pos)
    pos += 4
    if hgw > (1 << 16) or hgh > (1 << 16):
        raise JBIG2Error("unreasonable halftone grid")

    hph, hpw = patterns[0].shape
    bits = _graybits(len(patterns) - 1)
    x, y = _grid_positions(hgw, hgh, hgx, hgy, hrx, hry)
    skip = (_skip_bitmap(x, y, hpw, hph, info.width, info.height)
            if enable_skip else None)
    grid = decode_grayscale(data[pos:], hgw, hgh, bits, template, skip)
    grid = np.minimum(grid, len(patterns) - 1)

    region = np.full((info.height, info.width), def_pixel, np.uint8)
    for mg in range(hgh):
        for ng in range(hgw):
            if skip is not None and skip[mg, ng]:
                continue
            _stamp(region, patterns[int(grid[mg, ng])],
                   int(x[mg, ng]), int(y[mg, ng]), comb_op)
    return info, region


def _stamp(region: np.ndarray, pat: np.ndarray, x: int, y: int, op: int):
    h, w = region.shape
    ph, pw = pat.shape
    x0, y0 = max(x, 0), max(y, 0)
    x1, y1 = min(x + pw, w), min(y + ph, h)
    if x1 <= x0 or y1 <= y0:
        return
    sub = pat[y0 - y:y1 - y, x0 - x:x1 - x]
    dst = region[y0:y1, x0:x1]
    if op == 0:
        dst |= sub
    elif op == 1:
        dst &= sub
    elif op == 2:
        dst ^= sub
    elif op == 3:
        dst[...] = 1 - (dst ^ sub)
    else:
        dst[...] = sub


def encode_halftone_region(width: int, height: int, grid: np.ndarray,
                           patterns: list[np.ndarray], hgx: int = 0,
                           hgy: int = 0, hrx: int = 256, hry: int = 0,
                           enable_skip: bool = False, template: int = 0,
                           x0: int = 0, y0: int = 0) -> bytes:
    """Fixture encoder. `grid` holds pattern indices; grid vectors are 8.8
    fixed point (hrx=256, hry=0 = an axis-aligned cell-per-step grid)."""
    hgh, hgw = grid.shape
    hph, hpw = patterns[0].shape
    bits = _graybits(len(patterns) - 1)
    out = struct.pack(">IIIIB", width, height, x0, y0, 0)
    out += bytes([(template & 3) << 1 | (8 if enable_skip else 0)])
    out += struct.pack(">IIii", hgw, hgh, hgx, hgy)
    out += struct.pack(">HH", hrx, hry)
    skip = None
    if enable_skip:
        x, y = _grid_positions(hgw, hgh, hgx, hgy, hrx, hry)
        skip = _skip_bitmap(x, y, hpw, hph, width, height)
    out += encode_grayscale(grid.astype(np.int32), bits, template, skip)
    return out
