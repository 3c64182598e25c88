"""JBIG2 symbol-coded content: symbol dictionaries, text regions,
refinement (ITU-T T.88 6.3/6.4/6.5, segment syntax 7.4.3/7.4.4).

Symbol coding is how real archive scans are compressed: encoders
(jbig2enc, LuraDocument) segment each page into connected components,
dedupe them into a symbol dictionary, and code the page as (symbol id,
position) instances — the generic layer in jbig2.py only covers the
fallback mode. This module implements the arithmetic-coded flavor:

- the integer arithmetic decoding procedure (Annex A): IADH/IADW/IAEX/...
  classes with the 512-state PREV context chain, and IAID's fixed-length
  context tree,
- symbol dictionary decoding (6.5): height classes, delta-width loops,
  refinement/aggregate symbols (REFAGGNINST == 1), export run-lengths,
- text region decoding (6.4): strips, REFCORNER/TRANSPOSED placement,
  per-instance refinement, combination operators,
- generic refinement region decoding (6.3): templates 0/1 with TPGRON
  typical prediction (context layouts per the spec's figures, bit order
  as in 6.3.5.3's equations),
- encoders for all of the above (fixtures/validation — there is no
  trusted JBIG2 codec in this image, so round-trip + cross-checks are the
  correctness argument; see tests/test_jbig2_text.py).

Huffman-coded symbol/text segments (SDHUFF/SBHUFF = 1) raise JBIG2Error;
the renderer degrades to an image-less anchor for such pages. Arithmetic
coding is what the dominant encoders emit.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Optional

import numpy as np

from karanta_tpu_torch.pdf.jbig2 import (JBIG2Error, MQContexts, MQDecoder,
                                   MQEncoder, NOMINAL_AT,
                                   decode_generic_region,
                                   encode_generic_region,
                                   _parse_region_info, _RegionInfo)

OOB = object()  # Annex A out-of-band value


# ----------------------------------------------------------------------
# Annex A: integer arithmetic decoding (+ the encoding inverse)
# ----------------------------------------------------------------------

class IntContext:
    """One integer-class context bank (IADH, IADW, ...): 512 CX states
    chained through PREV."""

    def __init__(self):
        self.cx = MQContexts(512)


# (range offset, number of tail bits) per prefix, A.2 step 3
_INT_RANGES = ((0, 2), (4, 4), (20, 6), (84, 8), (340, 12), (4436, 32))


def decode_int(mq: MQDecoder, ic: IntContext):
    """A.2: returns an int or OOB."""
    prev = 1

    def bit() -> int:
        nonlocal prev
        d = mq.decode(ic.cx, prev)
        prev = ((prev << 1) | d) if prev < 256 else \
            (((((prev << 1) | d)) & 511) | 256)
        return d

    s = bit()
    for i, (offset, nbits) in enumerate(_INT_RANGES):
        if i < len(_INT_RANGES) - 1 and bit():
            continue
        v = 0
        for _ in range(nbits):
            v = (v << 1) | bit()
        v += offset
        break
    if s:
        if v == 0:
            return OOB
        return -v
    return v


def encode_int(enc: MQEncoder, ic: IntContext, value) -> None:
    """Inverse of decode_int (fixtures)."""
    prev = 1

    def bit(d: int):
        nonlocal prev
        enc.encode(d, ic.cx, prev)
        prev = ((prev << 1) | d) if prev < 256 else \
            (((((prev << 1) | d)) & 511) | 256)

    if value is OOB:
        s, mag = 1, 0
    elif value < 0:
        s, mag = 1, -value
    else:
        s, mag = 0, value
    bit(s)
    for i, (offset, nbits) in enumerate(_INT_RANGES):
        last = i == len(_INT_RANGES) - 1
        top = offset + (1 << nbits) - 1
        if mag <= top or last:
            if not last:
                bit(0)
            v = mag - offset
            if v < 0:
                raise JBIG2Error(f"unencodable integer {value}")
            for k in range(nbits - 1, -1, -1):
                bit((v >> k) & 1)
            return
        bit(1)


class IDContext:
    """IAID context tree: 1 << (symcodelen + 1) states (A.3)."""

    def __init__(self, symcodelen: int):
        self.symcodelen = symcodelen
        self.cx = MQContexts(1 << (symcodelen + 1))


def decode_iaid(mq: MQDecoder, ic: IDContext) -> int:
    prev = 1
    for _ in range(ic.symcodelen):
        prev = (prev << 1) | mq.decode(ic.cx, prev)
    return prev - (1 << ic.symcodelen)


def encode_iaid(enc: MQEncoder, ic: IDContext, value: int) -> None:
    prev = 1
    for k in range(ic.symcodelen - 1, -1, -1):
        d = (value >> k) & 1
        enc.encode(d, ic.cx, prev)
        prev = (prev << 1) | d


def _symcodelen(n_syms: int) -> int:
    n = 1
    while n_syms > (1 << n):
        n += 1
    return n  # == max(1, ceil(log2(n_syms)))


# ----------------------------------------------------------------------
# 6.3: generic refinement region decoding (+ encoder)
# ----------------------------------------------------------------------

NOMINAL_RAT = ((-1, -1), (-1, -1))

# SLTP decision contexts for TPGRON per template (6.3.5.6)
_TPGRON_CTX = (0x0100, 0x0080)


def _ref_context(dest: np.ndarray, ref: np.ndarray, x: int, y: int,
                 dx: int, dy: int, template: int, at) -> int:
    def d(ax, ay):
        if ax < 0 or ay < 0 or ay >= dest.shape[0] or ax >= dest.shape[1]:
            return 0
        return int(dest[ay, ax])

    def r(ax, ay):
        ax, ay = ax - dx, ay - dy
        if ax < 0 or ay < 0 or ay >= ref.shape[0] or ax >= ref.shape[1]:
            return 0
        return int(ref[ay, ax])

    if template == 0:
        a = at
        return (d(x - 1, y)
                | d(x + 1, y - 1) << 1
                | d(x, y - 1) << 2
                | d(x + a[0][0], y + a[0][1]) << 3
                | r(x + 1, y + 1) << 4
                | r(x, y + 1) << 5
                | r(x - 1, y + 1) << 6
                | r(x + a[1][0], y + a[1][1]) << 7
                | r(x + 1, y) << 8
                | r(x, y) << 9
                | r(x - 1, y) << 10
                | r(x + 1, y - 1) << 11
                | r(x, y - 1) << 12)
    return (d(x - 1, y)
            | d(x + 1, y - 1) << 1
            | d(x, y - 1) << 2
            | d(x - 1, y - 1) << 3
            | r(x + 1, y + 1) << 4
            | r(x, y + 1) << 5
            | r(x + 1, y) << 6
            | r(x, y) << 7
            | r(x - 1, y) << 8
            | r(x, y - 1) << 9)


def _ref_typical(ref: np.ndarray, x: int, y: int, dx: int, dy: int):
    """3x3 reference window uniformity: returns 0, 1, or None."""
    vals = []
    for yy in range(y - dy - 1, y - dy + 2):
        for xx in range(x - dx - 1, x - dx + 2):
            if xx < 0 or yy < 0 or yy >= ref.shape[0] or xx >= ref.shape[1]:
                vals.append(0)
            else:
                vals.append(int(ref[yy, xx]))
    if all(v == 0 for v in vals):
        return 0
    if all(v == 1 for v in vals):
        return 1
    return None


def decode_refinement(mq: MQDecoder, cx: MQContexts, width: int,
                      height: int, ref: np.ndarray, dx: int, dy: int,
                      template: int = 0, at=NOMINAL_RAT,
                      tpgron: bool = False) -> np.ndarray:
    dest = np.zeros((height, width), np.uint8)
    ltp = 0
    for y in range(height):
        if tpgron:
            ltp ^= mq.decode(cx, _TPGRON_CTX[template])
        for x in range(width):
            if ltp:
                typ = _ref_typical(ref, x, y, dx, dy)
                if typ is not None:
                    dest[y, x] = typ
                    continue
            context = _ref_context(dest, ref, x, y, dx, dy, template, at)
            dest[y, x] = mq.decode(cx, context)
    return dest


def encode_refinement(enc: MQEncoder, cx: MQContexts, bitmap: np.ndarray,
                      ref: np.ndarray, dx: int, dy: int, template: int = 0,
                      at=NOMINAL_RAT, tpgron: bool = False) -> None:
    h, w = bitmap.shape
    dest = np.zeros((h, w), np.uint8)
    ltp = 0
    for y in range(h):
        if tpgron:
            # a row is "typical-codable" if every pixel with a uniform
            # reference window equals that uniform value
            codable = True
            for x in range(w):
                typ = _ref_typical(ref, x, y, dx, dy)
                if typ is not None and typ != bitmap[y, x]:
                    codable = False
                    break
            sltp = 1 if codable != bool(ltp) else 0
            enc.encode(sltp, cx, _TPGRON_CTX[template])
            ltp ^= sltp
        for x in range(w):
            if ltp:
                typ = _ref_typical(ref, x, y, dx, dy)
                if typ is not None:
                    dest[y, x] = typ
                    continue
            context = _ref_context(dest, ref, x, y, dx, dy, template, at)
            enc.encode(int(bitmap[y, x]), cx, context)
            dest[y, x] = bitmap[y, x]


# ----------------------------------------------------------------------
# 6.5 / 7.4.3: symbol dictionary
# ----------------------------------------------------------------------

def _native_mod():
    import os

    from karanta_tpu_torch.pdf.jbig2 import _native

    if _native is None or os.environ.get("KARANTA_JBIG2_NATIVE",
                                         "1") == "0":
        return None
    return _native if hasattr(_native, "decode_symbol_dict") else None


def decode_symbol_dict(data: bytes, inherited: list,
                       custom_tables: list) -> list:
    """Segment payload -> list of exported symbol bitmaps."""
    native = _native_mod()
    if native is not None and not custom_tables:
        packed = [(b.shape[1], b.shape[0],
                   np.ascontiguousarray(b, np.uint8).tobytes())
                  for b in inherited]
        try:
            out = native.decode_symbol_dict(bytes(data), packed)
        except ValueError as e:
            raise JBIG2Error(str(e)) from None
        return [np.frombuffer(raw, np.uint8).reshape(h, w).copy()
                for w, h, raw in out]
    return _decode_symbol_dict_py(data, inherited, custom_tables)


def _decode_symbol_dict_py(data: bytes, inherited: list,
                           custom_tables: list) -> list:
    flags = struct.unpack_from(">H", data, 0)[0]
    pos = 2
    sdhuff = flags & 1
    sdrefagg = (flags >> 1) & 1
    template = (flags >> 10) & 3
    rtemplate = (flags >> 12) & 1
    if sdhuff:
        raise JBIG2Error("Huffman symbol dictionaries unsupported")
    n_at = 4 if template == 0 else 1
    at = []
    for _ in range(n_at):
        dx, dy = struct.unpack_from("bb", data, pos)
        at.append((dx, dy))
        pos += 2
    rat = list(NOMINAL_RAT)
    if sdrefagg and rtemplate == 0:
        rat = []
        for _ in range(2):
            dx, dy = struct.unpack_from("bb", data, pos)
            rat.append((dx, dy))
            pos += 2
    n_ex, n_new = struct.unpack_from(">II", data, pos)
    pos += 8

    mq = MQDecoder(data[pos:])
    iadh, iadw, iaex, iaai = (IntContext() for _ in range(4))
    iardx, iardy = IntContext(), IntContext()
    gb_cx = MQContexts(1 << 16)
    gr_cx = MQContexts(1 << 13)
    id_ctx = IDContext(_symcodelen(len(inherited) + n_new))

    new_syms: list = []
    height = 0
    while len(new_syms) < n_new:
        dh = decode_int(mq, iadh)
        if dh is OOB:
            raise JBIG2Error("OOB height delta")
        height += dh
        width = 0
        while True:
            dw = decode_int(mq, iadw)
            if dw is OOB:
                break
            width += dw
            if width <= 0 or height <= 0:
                raise JBIG2Error("bad symbol dimensions")
            if len(new_syms) >= n_new:
                raise JBIG2Error("more symbols than declared")
            if not sdrefagg:
                bmp = decode_generic_region(
                    b"", width, height, template, at, tpgdon=False,
                    cx=gb_cx, mq=mq)
            else:
                n_inst = decode_int(mq, iaai)
                if n_inst != 1:
                    raise JBIG2Error(
                        "aggregate refinement (REFAGGNINST > 1) unsupported")
                sym_id = decode_iaid(mq, id_ctx)
                rdx = decode_int(mq, iardx)
                rdy = decode_int(mq, iardy)
                pool = inherited + new_syms
                if sym_id >= len(pool):
                    raise JBIG2Error("refinement references unknown symbol")
                bmp = decode_refinement(mq, gr_cx, width, height,
                                        pool[sym_id], rdx, rdy, rtemplate,
                                        rat)
            new_syms.append(bmp)

    # 6.5.10: export flags as alternating run lengths over all symbols
    all_syms = list(inherited) + new_syms
    exported: list = []
    i = 0
    flag = 0
    while i < len(all_syms) and len(exported) < n_ex:
        run = decode_int(mq, iaex)
        if run is OOB or run < 0:
            raise JBIG2Error("bad export run")
        if flag:
            exported.extend(all_syms[i:i + run])
        i += run
        flag ^= 1
    if len(exported) != n_ex:
        raise JBIG2Error("export count mismatch")
    return exported


def encode_symbol_dict(symbols: list, template: int = 0) -> bytes:
    """Fixture encoder: all symbols new, all exported, arithmetic coding.
    Symbols must be sorted by (height, width) as 6.5.5 requires."""
    order = sorted(range(len(symbols)),
                   key=lambda i: (symbols[i].shape[0], symbols[i].shape[1]))
    assert order == sorted(order), "symbols must be presorted by height"
    flags = (template & 3) << 10
    out = struct.pack(">H", flags)
    at = NOMINAL_AT[template]
    for dx, dy in at:
        out += struct.pack("bb", dx, dy)
    out += struct.pack(">II", len(symbols), len(symbols))

    enc = MQEncoder()
    iadh, iadw, iaex = IntContext(), IntContext(), IntContext()
    gb_cx = MQContexts(1 << 16)
    height = 0
    i = 0
    while i < len(symbols):
        h = symbols[i].shape[0]
        encode_int(enc, iadh, h - height)
        height = h
        width = 0
        while i < len(symbols) and symbols[i].shape[0] == height:
            w = symbols[i].shape[1]
            encode_int(enc, iadw, w - width)
            width = w
            _encode_generic_into(enc, gb_cx, symbols[i], template, at)
            i += 1
        encode_int(enc, iadw, OOB)
    encode_int(enc, iaex, 0)            # zero not-exported
    encode_int(enc, iaex, len(symbols))  # then export all
    return out + enc.flush()


def _encode_generic_into(enc: MQEncoder, cx: MQContexts,
                         bitmap: np.ndarray, template: int, at) -> None:
    """encode_generic_region but continuing an outer MQ encoder/contexts
    (symbol dictionaries code every symbol in ONE arithmetic stream)."""
    from karanta_tpu_torch.pdf.jbig2 import _template_offsets, _px

    offsets = _template_offsets(template, at)
    h, w = bitmap.shape
    for y in range(h):
        for x in range(w):
            context = 0
            for bit, (dx, dy) in enumerate(offsets):
                if _px(bitmap, x + dx, y + dy):
                    context |= 1 << bit
            enc.encode(int(bitmap[y, x]), cx, context)


# ----------------------------------------------------------------------
# 6.4 / 7.4.4: text region
# ----------------------------------------------------------------------

@dataclass
class _TextParams:
    info: _RegionInfo
    log_strips: int
    ref_corner: int
    transposed: int
    comb_op: int
    def_pixel: int
    ds_offset: int
    rtemplate: int
    refine: int
    rat: list
    n_instances: int
    data_start: int


def _parse_text_params(data: bytes) -> _TextParams:
    info, pos = _parse_region_info(data)
    flags = struct.unpack_from(">H", data, pos)[0]
    pos += 2
    if flags & 1:
        raise JBIG2Error("Huffman text regions unsupported")
    refine = (flags >> 1) & 1
    log_strips = (flags >> 2) & 3
    ref_corner = (flags >> 4) & 3
    transposed = (flags >> 6) & 1
    comb_op = (flags >> 7) & 3
    def_pixel = (flags >> 9) & 1
    ds_offset = (flags >> 10) & 0x1F
    if ds_offset > 15:
        ds_offset -= 32
    rtemplate = (flags >> 15) & 1
    rat = list(NOMINAL_RAT)
    if refine and rtemplate == 0:
        rat = []
        for _ in range(2):
            dx, dy = struct.unpack_from("bb", data, pos)
            rat.append((dx, dy))
            pos += 2
    n_instances = struct.unpack_from(">I", data, pos)[0]
    pos += 4
    return _TextParams(info, log_strips, ref_corner, transposed, comb_op,
                       def_pixel, ds_offset, rtemplate, refine, rat,
                       n_instances, pos)


def _draw(region: np.ndarray, bmp: np.ndarray, x: int, y: int, op: int):
    h, w = region.shape
    bh, bw = bmp.shape
    x0, y0 = max(x, 0), max(y, 0)
    x1, y1 = min(x + bw, w), min(y + bh, h)
    if x1 <= x0 or y1 <= y0:
        return
    sub = bmp[y0 - y:y1 - y, x0 - x:x1 - x]
    dst = region[y0:y1, x0:x1]
    if op == 0:
        dst |= sub
    elif op == 1:
        dst &= sub
    elif op == 2:
        dst ^= sub
    else:
        dst[...] = 1 - (dst ^ sub)


def decode_text_region(data: bytes, symbols: list,
                       custom_tables: list) -> tuple[_RegionInfo, np.ndarray]:
    native = _native_mod()
    if native is not None and not custom_tables and symbols:
        packed = [(b.shape[1], b.shape[0],
                   np.ascontiguousarray(b, np.uint8).tobytes())
                  for b in symbols]
        try:
            w, h, x, y, comb, raw = native.decode_text_region(bytes(data),
                                                              packed)
        except ValueError as e:
            raise JBIG2Error(str(e)) from None
        region = np.frombuffer(raw, np.uint8).reshape(h, w).copy()
        return _RegionInfo(w, h, x, y, comb), region
    return _decode_text_region_py(data, symbols, custom_tables)


def _decode_text_region_py(data: bytes, symbols: list,
                           custom_tables: list
                           ) -> tuple[_RegionInfo, np.ndarray]:
    p = _parse_text_params(data)
    if not symbols:
        raise JBIG2Error("text region with no symbol dictionary")
    strips = 1 << p.log_strips
    mq = MQDecoder(data[p.data_start:])
    iadt, iafs, iads, iait = (IntContext() for _ in range(4))
    iari, iardw, iardh, iardx, iardy = (IntContext() for _ in range(5))
    id_ctx = IDContext(_symcodelen(len(symbols)))
    gr_cx = MQContexts(1 << 13)

    region = np.full((p.info.height, p.info.width), p.def_pixel, np.uint8)
    dt = decode_int(mq, iadt)
    if dt is OOB:
        raise JBIG2Error("bad STRIPT")
    stript = -dt * strips
    firsts = 0
    n_decoded = 0
    while n_decoded < p.n_instances:
        dt = decode_int(mq, iadt)
        if dt is OOB:
            raise JBIG2Error("bad strip delta")
        stript += dt * strips
        first = True
        curs = 0
        while True:
            if first:
                dfs = decode_int(mq, iafs)
                if dfs is OOB:
                    raise JBIG2Error("bad first S")
                firsts += dfs
                curs = firsts
                first = False
            else:
                ids = decode_int(mq, iads)
                if ids is OOB:
                    break  # end of strip
                curs += ids + p.ds_offset
            curt = 0 if strips == 1 else decode_int(mq, iait)
            t = stript + curt
            sym_id = decode_iaid(mq, id_ctx)
            if sym_id >= len(symbols):
                raise JBIG2Error("symbol id out of range")
            bmp = symbols[sym_id]
            if p.refine:
                r = decode_int(mq, iari)
                if r:
                    rdw = decode_int(mq, iardw)
                    rdh = decode_int(mq, iardh)
                    rdx = decode_int(mq, iardx)
                    rdy = decode_int(mq, iardy)
                    nw, nh = bmp.shape[1] + rdw, bmp.shape[0] + rdh
                    if nw <= 0 or nh <= 0:
                        raise JBIG2Error("bad refined dimensions")
                    bmp = decode_refinement(
                        mq, gr_cx, nw, nh, bmp,
                        (rdw >> 1) + rdx, (rdh >> 1) + rdy,
                        p.rtemplate, p.rat)
            bh, bw = bmp.shape
            if not p.transposed:
                x = curs
                y = t if p.ref_corner in (1, 3) else t - bh + 1
                _draw(region, bmp, x, y, p.comb_op)
                curs += bw - 1
            else:
                x = t if p.ref_corner in (0, 1) else t - bw + 1
                y = curs
                _draw(region, bmp, x, y, p.comb_op)
                curs += bh - 1
            n_decoded += 1
            if n_decoded > p.n_instances:
                raise JBIG2Error("instance overrun")
    return p.info, region


def encode_text_region(width: int, height: int, symbols: list,
                       placements: list, ref_corner: int = 1,
                       transposed: int = 0, x0: int = 0,
                       y0: int = 0) -> bytes:
    """Fixture encoder. `placements`: (sym_id, x, y) with (x, y) the
    TOP-LEFT pixel of the instance; strips of 1, DS offset 0, no
    refinement, OR composition."""
    flags = (0 << 2) | (ref_corner << 4) | (transposed << 6)
    out = struct.pack(">IIIIB", width, height, x0, y0, 0)
    out += struct.pack(">H", flags)
    out += struct.pack(">I", len(placements))

    enc = MQEncoder()
    iadt, iafs, iads = IntContext(), IntContext(), IntContext()
    id_ctx = IDContext(_symcodelen(len(symbols)))

    # convert top-left placements to the (S, T) the corner convention
    # expects, group into strips of identical T
    insts = []
    for sym_id, x, y in placements:
        bh, bw = symbols[sym_id].shape
        if not transposed:
            t = y if ref_corner in (1, 3) else y + bh - 1
            s = x
        else:
            t = x if ref_corner in (0, 1) else x + bw - 1
            s = y
        insts.append((t, s, sym_id))
    insts.sort()
    encode_int(enc, iadt, 0)  # STRIPT starts at 0
    stript = 0
    firsts = 0
    i = 0
    while i < len(insts):
        t = insts[i][0]
        if t < stript:
            raise JBIG2Error("placements must be strip-sorted")
        encode_int(enc, iadt, t - stript)
        stript = t
        first = True
        curs = 0
        while i < len(insts) and insts[i][0] == t:
            _, s, sym_id = insts[i]
            if first:
                encode_int(enc, iafs, s - firsts)
                firsts = s
                curs = s
                first = False
            else:
                if s < curs:
                    raise JBIG2Error("instances must be S-sorted per strip")
                encode_int(enc, iads, s - curs)
                curs = s
            encode_iaid(enc, id_ctx, sym_id)
            bh, bw = symbols[sym_id].shape
            curs += (bw if not transposed else bh) - 1
            i += 1
        encode_int(enc, iads, OOB)
    return out + enc.flush()


def parse_custom_table(data: bytes):
    raise JBIG2Error("custom Huffman tables unsupported")
