"""JBIG2 (ITU-T T.88) decoder for PDF-embedded streams.

The reference gets JBIG2 for free from poppler (reference
karanta/data/process_pdf_utils.py:56-74); archive.org scans — the
reference's data source (scripts/internet_archive_downloader.py) — use it
heavily post-2005. This module implements, from the T.88 specification:

- the MQ arithmetic coder (Annex E): decoder AND encoder. The encoder
  exists for test fixtures and validation: with no trusted JBIG2 codec in
  this image (libjbig is JBIG1), correctness is established by round-trip
  (both sides written independently from the spec's flowcharts — decoder
  from the DECODE/BYTEIN charts, encoder from CODEMPS/CODELPS/BYTEOUT —
  so a transcription slip in either side breaks the round trip) plus a
  C++-vs-Python cross-implementation check (native/jbig2core.cpp).
- generic region decoding (6.2): templates 0-3, AT pixels, TPGDON typical
  prediction; MMR regions route to the existing T.6 decoder (ccitt.py).
- the embedded-stream segment layer (Annex D.2 organization used by PDF's
  /JBIG2Decode + /JBIG2Globals): segment headers, page info, immediate
  generic regions, end-of-page/stripe/file.
- symbol-coded content (Annex 6.4/6.5): symbol dictionaries and text
  regions — see decode_symbol_dict/_decode_text_region below.

Bitmaps are numpy uint8 arrays (h, w), 1 = black, matching ccitt.py.

The per-pixel MQ loop is sequential and adaptive (unvectorizable); the
native extension (native/jbig2core.cpp, built by `make native`) provides
the production-speed path and this file is the behavioral reference.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Optional

import numpy as np


class JBIG2Error(Exception):
    pass


# ----------------------------------------------------------------------
# MQ arithmetic coder (T.88 Annex E). Qe table: E.1.
# ----------------------------------------------------------------------

# (Qe, NMPS, NLPS, SWITCH)
QE_TABLE = (
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0),
    (0x0AC1, 4, 12, 0), (0x0521, 5, 29, 0), (0x0221, 38, 33, 0),
    (0x5601, 7, 6, 1), (0x5401, 8, 14, 0), (0x4801, 9, 14, 0),
    (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1),
    (0x5401, 16, 14, 0), (0x5101, 17, 15, 0), (0x4801, 18, 16, 0),
    (0x3801, 19, 17, 0), (0x3401, 20, 18, 0), (0x3001, 21, 19, 0),
    (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0),
    (0x1401, 28, 25, 0), (0x1201, 29, 26, 0), (0x1101, 30, 27, 0),
    (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0), (0x08A1, 33, 30, 0),
    (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0),
    (0x0085, 40, 37, 0), (0x0049, 41, 38, 0), (0x0025, 42, 39, 0),
    (0x0015, 43, 40, 0), (0x0009, 44, 41, 0), (0x0005, 45, 42, 0),
    (0x0001, 45, 43, 0), (0x5601, 46, 46, 0),
)


class MQContexts:
    """Per-CX adaptive state (index into Qe table + MPS sense)."""

    __slots__ = ("icx", "mps")

    def __init__(self, n: int):
        self.icx = bytearray(n)
        self.mps = bytearray(n)


class MQDecoder:
    """T.88 E.3: INITDEC / DECODE / BYTEIN, software conventions
    (C is a 32-bit register, Chigh its top 16 bits)."""

    __slots__ = ("data", "bp", "c", "a", "ct")

    def __init__(self, data: bytes):
        self.data = data
        self.bp = 0
        self.c = self._b(0) << 16
        self._bytein()
        self.c = (self.c << 7) & 0xFFFFFFFF
        self.ct -= 7
        self.a = 0x8000

    def _b(self, i: int) -> int:
        # past the end of the data the decoder sees 1-bits (T.88 E.3.4:
        # a marker terminates the stream and BYTEIN feeds 0xFF00)
        return self.data[i] if i < len(self.data) else 0xFF

    def _bytein(self):
        if self._b(self.bp) == 0xFF:
            if self._b(self.bp + 1) > 0x8F:  # marker: feed 1s forever
                self.c += 0xFF00
                self.ct = 8
            else:
                self.bp += 1
                self.c += self._b(self.bp) << 9
                self.ct = 7
        else:
            self.bp += 1
            self.c += self._b(self.bp) << 8
            self.ct = 8

    def decode(self, cx: MQContexts, i: int) -> int:
        qe, nmps, nlps, switch = QE_TABLE[cx.icx[i]]
        self.a -= qe
        if ((self.c >> 16) & 0xFFFF) < qe:
            # LPS subinterval selected (or MPS via conditional exchange)
            if self.a < qe:
                d = cx.mps[i]
                cx.icx[i] = nmps
            else:
                d = 1 - cx.mps[i]
                if switch:
                    cx.mps[i] ^= 1
                cx.icx[i] = nlps
            self.a = qe
        else:
            self.c -= qe << 16
            if self.a & 0x8000:
                return cx.mps[i]
            if self.a < qe:
                d = 1 - cx.mps[i]
                if switch:
                    cx.mps[i] ^= 1
                cx.icx[i] = nlps
            else:
                d = cx.mps[i]
                cx.icx[i] = nmps
        # RENORMD
        while True:
            if self.ct == 0:
                self._bytein()
            self.a = (self.a << 1) & 0xFFFF
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if self.a & 0x8000:
                break
        return d


class MQEncoder:
    """T.88 E.3: INITENC / CODEMPS / CODELPS / BYTEOUT / FLUSH.

    Output begins with a sentinel byte standing in for the spec's
    "byte before BPST": a carry out of the code register increments it,
    in which case it is part of the code string and is kept; otherwise
    it is dropped at flush."""

    __slots__ = ("out", "c", "a", "ct")

    def __init__(self):
        self.out = bytearray([0x00])
        self.c = 0
        self.a = 0x8000
        self.ct = 12

    def encode(self, d: int, cx: MQContexts, i: int):
        qe, nmps, nlps, switch = QE_TABLE[cx.icx[i]]
        if d == cx.mps[i]:
            self.a -= qe
            if self.a & 0x8000:
                self.c += qe
                return
            if self.a < qe:  # conditional exchange
                self.a = qe
            else:
                self.c += qe
            cx.icx[i] = nmps
        else:
            self.a -= qe
            if self.a < qe:  # conditional exchange
                self.c += qe
            else:
                self.a = qe
            if switch:
                cx.mps[i] ^= 1
            cx.icx[i] = nlps
        # RENORME
        while True:
            self.a = (self.a << 1) & 0xFFFF
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self._byteout()
            if self.a & 0x8000:
                break

    def _byteout(self):
        if self.out[-1] == 0xFF:
            self.out.append((self.c >> 20) & 0xFF)
            self.c &= 0xFFFFF
            self.ct = 7
        elif self.c < 0x8000000:
            self.out.append((self.c >> 19) & 0xFF)
            self.c &= 0x7FFFF
            self.ct = 8
        else:
            self.out[-1] += 1  # carry propagates into the previous byte
            if self.out[-1] == 0xFF:
                self.c &= 0x7FFFFFF
                self.out.append((self.c >> 20) & 0xFF)
                self.c &= 0xFFFFF
                self.ct = 7
            else:
                self.c &= 0x7FFFFFF
                self.out.append((self.c >> 19) & 0xFF)
                self.c &= 0x7FFFF
                self.ct = 8

    def flush(self) -> bytes:
        # SETBITS (openjpeg formulation, equivalent to E.3.8)
        tempc = self.c + self.a
        self.c |= 0xFFFF
        if self.c >= tempc:
            self.c -= 0x8000
        self.c <<= self.ct
        self._byteout()
        self.c <<= self.ct
        self._byteout()
        # drop the sentinel unless a carry made it part of the code string
        data = self.out[1:] if self.out[0] == 0 else self.out
        # trailing 0xFF would combine with whatever follows in a container;
        # T.88 permits the optional 0xFF 0xAC terminator — append the 0xAC
        # so the tail is unambiguous
        if data and data[-1] == 0xFF:
            data.append(0xAC)
        return bytes(data)


# ----------------------------------------------------------------------
# Generic region coding (T.88 6.2). Context layouts follow the spec's
# figures (bit assignments as in 6.2.5.7's per-template equations).
# ----------------------------------------------------------------------

# nominal AT pixel positions per template (6.2.5.4)
NOMINAL_AT = {
    0: ((3, -1), (-3, -1), (2, -2), (-2, -2)),
    1: ((3, -1),),
    2: ((2, -1),),
    3: ((2, -1),),
}

# SLTP decision contexts for TPGDON (6.2.5.7)
_TPGDON_CTX = {0: 0x9B25, 1: 0x0795, 2: 0x00E5, 3: 0x0195}


def _template_offsets(template: int, at) -> list[tuple[int, int]]:
    """(dx, dy) per context bit, LSB first."""
    a = list(at)
    if template == 0:
        return [(-1, 0), (-2, 0), (-3, 0), (-4, 0), a[0],
                (2, -1), (1, -1), (0, -1), (-1, -1), (-2, -1), a[1], a[2],
                (1, -2), (0, -2), (-1, -2), a[3]]
    if template == 1:
        return [(-1, 0), (-2, 0), (-3, 0), a[0],
                (2, -1), (1, -1), (0, -1), (-1, -1), (-2, -1),
                (2, -2), (1, -2), (0, -2), (-1, -2)]
    if template == 2:
        return [(-1, 0), (-2, 0), a[0],
                (1, -1), (0, -1), (-1, -1), (-2, -1),
                (1, -2), (0, -2), (-1, -2)]
    if template == 3:
        return [(-1, 0), (-2, 0), (-3, 0), (-4, 0), a[0],
                (1, -1), (0, -1), (-1, -1), (-2, -1), (-3, -1)]
    raise JBIG2Error(f"bad GBTEMPLATE {template}")


def _px(bitmap: np.ndarray, x: int, y: int) -> int:
    if x < 0 or y < 0 or y >= bitmap.shape[0] or x >= bitmap.shape[1]:
        return 0
    return int(bitmap[y, x])


def decode_generic_region(data: bytes, width: int, height: int,
                          template: int = 0, at=None,
                          tpgdon: bool = False,
                          cx: Optional[MQContexts] = None,
                          mq: Optional[MQDecoder] = None,
                          skip: Optional[np.ndarray] = None) -> np.ndarray:
    """Decode an MQ-coded generic region to an (h, w) uint8 bitmap.

    `cx`/`mq` may be passed to continue an outer decoding procedure's
    arithmetic state (refinement/symbol dictionaries share one decoder)."""
    at = tuple(at) if at else NOMINAL_AT[template]
    if _use_native(width, height, cx, mq, skip):
        return _native_decode(data, width, height, template, at, tpgdon)
    offsets = _template_offsets(template, at)
    bitmap = np.zeros((height, width), np.uint8)
    mq = mq or MQDecoder(data)
    cx = cx or MQContexts(1 << 16)
    ltp = 0
    for y in range(height):
        if tpgdon:
            if mq.decode(cx, _TPGDON_CTX[template]):
                ltp ^= 1
            if ltp:
                if y > 0:
                    bitmap[y] = bitmap[y - 1]
                continue
        for x in range(width):
            if skip is not None and skip[y, x]:
                continue
            context = 0
            for bit, (dx, dy) in enumerate(offsets):
                if _px(bitmap, x + dx, y + dy):
                    context |= 1 << bit
            if mq.decode(cx, context):
                bitmap[y, x] = 1
    return bitmap


def encode_generic_region(bitmap: np.ndarray, template: int = 0, at=None,
                          tpgdon: bool = False) -> bytes:
    """Inverse of decode_generic_region (test fixtures / validation)."""
    at = tuple(at) if at else NOMINAL_AT[template]
    offsets = _template_offsets(template, at)
    h, w = bitmap.shape
    enc = MQEncoder()
    cx = MQContexts(1 << 16)
    ltp = 0
    for y in range(h):
        if tpgdon:
            same = y > 0 and bool((bitmap[y] == bitmap[y - 1]).all())
            sltp = 1 if same != bool(ltp) else 0
            enc.encode(sltp, cx, _TPGDON_CTX[template])
            ltp ^= sltp
            if ltp:
                continue
        for x in range(w):
            context = 0
            for bit, (dx, dy) in enumerate(offsets):
                if _px(bitmap, x + dx, y + dy):
                    context |= 1 << bit
            enc.encode(int(bitmap[y, x]), cx, context)
    return enc.flush()


# ----------------------------------------------------------------------
# native fast path (built by `make native`; behavioral twin of the above)
# ----------------------------------------------------------------------

import os as _os
import sys as _sys

_NATIVE_DIR = _os.path.join(_os.path.dirname(_os.path.dirname(
    _os.path.dirname(_os.path.abspath(__file__)))), "native")
if _NATIVE_DIR not in _sys.path:
    _sys.path.append(_NATIVE_DIR)
try:
    import jbig2core as _native
except ImportError:
    _native = None


def _use_native(width, height, cx, mq, skip) -> bool:
    if _native is None or cx is not None or mq is not None \
            or skip is not None:
        return False
    import os

    if os.environ.get("KARANTA_JBIG2_NATIVE", "1") == "0":
        return False
    return True


def _native_decode(data, width, height, template, at, tpgdon):
    flat = []
    for dx, dy in at:
        flat += [dx, dy]
    raw = _native.decode_generic(bytes(data), width, height, template,
                                 bytes(struct.pack(f"{len(flat)}b", *flat)),
                                 1 if tpgdon else 0)
    return np.frombuffer(raw, np.uint8).reshape(height, width).copy()


# ----------------------------------------------------------------------
# Embedded-stream segment layer (Annex D.2 — the PDF organization)
# ----------------------------------------------------------------------

@dataclass
class Segment:
    number: int
    type: int
    referred: tuple
    page: int
    data: bytes


# segment type numbers (7.3)
SYMBOL_DICT = 0
INTERMEDIATE_TEXT = 4
IMMEDIATE_TEXT = 6
IMMEDIATE_LOSSLESS_TEXT = 7
PATTERN_DICT = 16
INTERMEDIATE_HALFTONE = 20
IMMEDIATE_HALFTONE = 22
IMMEDIATE_LOSSLESS_HALFTONE = 23
INTERMEDIATE_GENERIC = 36
IMMEDIATE_GENERIC = 38
IMMEDIATE_LOSSLESS_GENERIC = 39
PAGE_INFO = 48
END_OF_PAGE = 49
END_OF_STRIPE = 50
END_OF_FILE = 51
PROFILES = 52
CODE_TABLES = 53
EXTENSION = 62


def parse_segments(data: bytes) -> list[Segment]:
    """Parse a sequence of segment headers + payloads (7.2)."""
    segments = []
    pos = 0
    n = len(data)
    while pos + 11 <= n:
        number, flags = struct.unpack_from(">IB", data, pos)
        pos += 5
        seg_type = flags & 0x3F
        page_assoc_4 = bool(flags & 0x40)
        # referred-to segments (7.2.4)
        count_byte = data[pos]
        if (count_byte >> 5) == 7:
            count = struct.unpack_from(">I", data, pos)[0] & 0x1FFFFFFF
            pos += 4 + (count + 8) // 8  # retain bits
        else:
            count = count_byte >> 5
            pos += 1
        if number <= 256:
            ref_size = 1
        elif number <= 65536:
            ref_size = 2
        else:
            ref_size = 4
        referred = []
        for _ in range(count):
            if ref_size == 1:
                referred.append(data[pos])
            elif ref_size == 2:
                referred.append(struct.unpack_from(">H", data, pos)[0])
            else:
                referred.append(struct.unpack_from(">I", data, pos)[0])
            pos += ref_size
        if page_assoc_4:
            page = struct.unpack_from(">I", data, pos)[0]
            pos += 4
        else:
            page = data[pos]
            pos += 1
        length = struct.unpack_from(">I", data, pos)[0]
        pos += 4
        if length == 0xFFFFFFFF:
            raise JBIG2Error("unknown-length segment (7.2.7) unsupported")
        if pos + length > n:
            raise JBIG2Error("segment payload truncated")
        segments.append(Segment(number, seg_type, tuple(referred), page,
                                data[pos:pos + length]))
        pos += length
    return segments


@dataclass
class _RegionInfo:
    width: int
    height: int
    x: int
    y: int
    comb_op: int


def _parse_region_info(data: bytes) -> tuple[_RegionInfo, int]:
    w, h, x, y, flags = struct.unpack_from(">IIIIB", data, 0)
    return _RegionInfo(w, h, x, y, flags & 0x07), 17


def _decode_generic_segment(seg: Segment) -> tuple[_RegionInfo, np.ndarray]:
    info, pos = _parse_region_info(seg.data)
    flags = seg.data[pos]
    pos += 1
    mmr = flags & 1
    template = (flags >> 1) & 3
    tpgdon = bool(flags & 8)
    if mmr:
        from karanta_tpu_torch.pdf.ccitt import decode_g4

        bitmap = decode_g4(seg.data[pos:], columns=info.width,
                           rows=info.height)
    else:
        n_at = 4 if template == 0 else 1
        at = []
        for _ in range(n_at):
            dx, dy = struct.unpack_from("bb", seg.data, pos)
            at.append((dx, dy))
            pos += 2
        bitmap = decode_generic_region(seg.data[pos:], info.width,
                                       info.height, template, at, tpgdon)
    return info, bitmap


def _compose(page: np.ndarray, info: _RegionInfo, bitmap: np.ndarray):
    h, w = page.shape
    y0, x0 = info.y, info.x
    y1 = min(h, y0 + bitmap.shape[0])
    x1 = min(w, x0 + bitmap.shape[1])
    if y1 <= y0 or x1 <= x0:
        return
    sub = bitmap[: y1 - y0, : x1 - x0]
    dst = page[y0:y1, x0:x1]
    if info.comb_op == 0:      # OR
        dst |= sub
    elif info.comb_op == 1:    # AND
        dst &= sub
    elif info.comb_op == 2:    # XOR
        dst ^= sub
    elif info.comb_op == 3:    # XNOR
        dst[...] = 1 - (dst ^ sub)
    else:                      # REPLACE
        dst[...] = sub


def decode_embedded(data: bytes, globals_data: bytes = b"",
                    width: Optional[int] = None,
                    height: Optional[int] = None) -> np.ndarray:
    """Decode a PDF-embedded JBIG2 stream (+ optional /JBIG2Globals) to the
    page bitmap (1 = black). `width`/`height` come from the image dict and
    take over when the page info segment declares striped/unknown height."""
    segments = (parse_segments(globals_data) if globals_data else []) \
        + parse_segments(data)
    page_w, page_h, page_default = width, height, 0
    symbol_dicts: dict[int, list] = {}
    pattern_dicts: dict[int, list] = {}
    tables: dict[int, object] = {}
    page: Optional[np.ndarray] = None

    height_fixed = height is not None  # the PDF /Height is authoritative

    def ensure_page() -> np.ndarray:
        nonlocal page
        if page is None:
            if not page_w or not page_h:
                raise JBIG2Error("no page dimensions available")
            page = np.full((page_h, page_w), page_default, np.uint8)
        return page

    def place(info: _RegionInfo, bitmap: np.ndarray) -> None:
        nonlocal page, page_h, page_w
        if page_w is None:
            page_w = info.x + info.width
        if page_h is None:
            page_h = info.y + info.height
        p = ensure_page()
        bottom = info.y + bitmap.shape[0]
        if bottom > p.shape[0] and not height_fixed:
            # striped page with unknown declared height (7.4.8.2): the
            # page grows downward as stripes arrive
            if bottom > (1 << 16):
                raise JBIG2Error("unreasonable striped page height")
            grown = np.full((bottom, p.shape[1]), page_default, np.uint8)
            grown[: p.shape[0]] = p
            page = grown
            page_h = bottom
        _compose(page, info, bitmap)

    for seg in segments:
        if seg.type == PAGE_INFO:
            w, h = struct.unpack_from(">II", seg.data, 0)
            flags = seg.data[16]
            page_default = (flags >> 2) & 1
            if not page_w:
                page_w = w if w != 0xFFFFFFFF else None
            if not page_h:
                page_h = h if h != 0xFFFFFFFF else None
        elif seg.type in (IMMEDIATE_GENERIC, IMMEDIATE_LOSSLESS_GENERIC,
                          INTERMEDIATE_GENERIC):
            info, bitmap = _decode_generic_segment(seg)
            place(info, bitmap)
        elif seg.type == SYMBOL_DICT:
            inherited: list = []
            for r in seg.referred:
                inherited.extend(symbol_dicts.get(r, []))
            symbol_dicts[seg.number] = decode_symbol_dict(
                seg.data, inherited,
                [tables[r] for r in seg.referred if r in tables])
        elif seg.type in (IMMEDIATE_TEXT, IMMEDIATE_LOSSLESS_TEXT,
                          INTERMEDIATE_TEXT):
            symbols: list = []
            for r in seg.referred:
                symbols.extend(symbol_dicts.get(r, []))
            info, bitmap = _decode_text_region(
                seg.data, symbols,
                [tables[r] for r in seg.referred if r in tables])
            place(info, bitmap)
        elif seg.type == PATTERN_DICT:
            from karanta_tpu_torch.pdf.jbig2_halftone import decode_pattern_dict

            pattern_dicts[seg.number] = decode_pattern_dict(seg.data)
        elif seg.type in (IMMEDIATE_HALFTONE, IMMEDIATE_LOSSLESS_HALFTONE,
                          INTERMEDIATE_HALFTONE):
            from karanta_tpu_torch.pdf.jbig2_halftone import (
                decode_halftone_region,
            )

            patterns: list = []
            for r in seg.referred:
                patterns.extend(pattern_dicts.get(r, []))
            info, bitmap = decode_halftone_region(seg.data, patterns)
            place(info, bitmap)
        elif seg.type == CODE_TABLES:
            tables[seg.number] = parse_custom_table(seg.data)
        elif seg.type in (END_OF_PAGE, END_OF_STRIPE, END_OF_FILE,
                          PROFILES, EXTENSION):
            continue
        else:
            raise JBIG2Error(f"unsupported segment type {seg.type}")
    return ensure_page()


# ----------------------------------------------------------------------
# Embedded-stream encoder (fixtures): page info + one immediate generic
# region (+ end of page), the minimal organization a PDF consumer needs.
# ----------------------------------------------------------------------

def _segment_header(number: int, seg_type: int, referred: tuple,
                    page: int, length: int) -> bytes:
    out = struct.pack(">IB", number, seg_type & 0x3F)
    assert len(referred) <= 4, "fixture writer: short form only"
    out += bytes([len(referred) << 5])
    for r in referred:
        assert number <= 256
        out += bytes([r])
    out += bytes([page])
    out += struct.pack(">I", length)
    return out


def encode_embedded(bitmap: np.ndarray, template: int = 0,
                    tpgdon: bool = False) -> bytes:
    h, w = bitmap.shape
    page_info = struct.pack(">IIIIBH", w, h, 0, 0, 0, 0)
    out = _segment_header(0, PAGE_INFO, (), 1, len(page_info)) + page_info

    at = NOMINAL_AT[template]
    region = struct.pack(">IIIIB", w, h, 0, 0, 0)  # comb op OR
    region += bytes([(template << 1) | (8 if tpgdon else 0)])
    for dx, dy in at:
        region += struct.pack("bb", dx, dy)
    region += encode_generic_region(bitmap, template, at, tpgdon)
    out += _segment_header(1, IMMEDIATE_LOSSLESS_GENERIC, (), 1,
                           len(region)) + region
    out += _segment_header(2, END_OF_PAGE, (), 1, 0)
    return out


# ----------------------------------------------------------------------
# Symbol dictionaries & text regions (6.4/6.5) — implemented in
# jbig2_text.py to keep this file to the coder + generic layer.
# ----------------------------------------------------------------------

def decode_symbol_dict(data, inherited, custom_tables):
    from karanta_tpu_torch.pdf.jbig2_text import decode_symbol_dict as impl

    return impl(data, inherited, custom_tables)


def _decode_text_region(data, symbols, custom_tables):
    from karanta_tpu_torch.pdf.jbig2_text import decode_text_region as impl

    return impl(data, symbols, custom_tables)


def parse_custom_table(data):
    from karanta_tpu_torch.pdf.jbig2_text import parse_custom_table as impl

    return impl(data)
