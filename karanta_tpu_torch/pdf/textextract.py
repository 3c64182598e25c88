"""Content-stream interpretation: positioned text + image placements.

Provides the page-report data the reference builds with a pypdf visitor
(karanta/prompts/anchor.py:69-128: text xy via ctm x tm, image bboxes from Do
XObject ops), implemented directly over our minipdf reader.
"""

from __future__ import annotations

import dataclasses
import os
import re
import sys
from typing import Iterator, Optional

from karanta_tpu_torch.pdf.minipdf import (
    Name, Op, PdfDocument, Stream, _Lexer, _parse_object,
)

# native C++ lexer (native/pdflex.cpp, `make native`): one-pass tokenization
# of content streams — the host hot loop at corpus scale
_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
if _NATIVE_DIR not in sys.path:
    sys.path.append(_NATIVE_DIR)
try:
    import pdflex as _pdflex
except ImportError:
    _pdflex = None

_INLINE_IMAGE_RE = re.compile(rb"(?:^|(?<=[\s\x00]))BI[\s\x00][\s\S]*?"
                              rb"[\s\x00]EI(?=[\s\x00]|$)")


def _strip_inline_images(content: bytes) -> bytes:
    """Remove BI..EI inline-image segments (binary payloads break lexing)."""
    if b"BI" not in content:
        return content
    return _INLINE_IMAGE_RE.sub(b" ", content)


def _convert_native(token):
    kind, value = token
    if kind == "num":
        return value
    if kind == "str":
        return value
    if kind == "name":
        return Name(value)
    if kind == "op":
        return Op(value)
    if kind == "arr":
        return [_convert_native(v) for v in value]
    return None


def _iter_tokens(content: bytes, doc) -> Iterator:
    """Token stream for one content stream: native lexer when built,
    pure-Python otherwise."""
    if _pdflex is not None:
        for token in _pdflex.lex_content(content):
            yield _convert_native(token)
        return
    lex = _Lexer(content, 0)
    while True:
        obj = _parse_object(lex, doc)
        if obj is None and lex.peek() == b"":
            return
        yield obj


@dataclasses.dataclass
class TextElement:
    x: float
    y: float
    text: str
    # PDF text rendering mode (Tr operator); 3 = invisible — the OCR text
    # layer under a scanned image. Visible-vs-invisible drives the poppler-
    # free renderer's image-only exemption (pdf/primitives.py).
    render_mode: int = 0


@dataclasses.dataclass
class ImageElement:
    name: str
    x0: float
    y0: float
    x1: float
    y1: float


@dataclasses.dataclass
class PageReport:
    mediabox: tuple[float, float, float, float]
    text_elements: list[TextElement]
    image_elements: list[ImageElement]


def _mat_mul(a, b):
    """3x3 affine as 6-tuple (a b c d e f): rows [[a b 0],[c d 0],[e f 1]]."""
    return (
        a[0] * b[0] + a[1] * b[2],
        a[0] * b[1] + a[1] * b[3],
        a[2] * b[0] + a[3] * b[2],
        a[2] * b[1] + a[3] * b[3],
        a[4] * b[0] + a[5] * b[2] + b[4],
        a[4] * b[1] + a[5] * b[3] + b[5],
    )


_IDENTITY = (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)


def _apply(m, x, y):
    return (m[0] * x + m[2] * y + m[4], m[1] * x + m[3] * y + m[5])


# Adobe Glyph List subset: the names real subset fonts use in /Differences
# arrays (reference analogue: pypdf's full AGL). Letters/digits resolve
# programmatically; this table covers punctuation + accented Latin — the
# glyph repertoire of the reference's newspaper corpora.
_GLYPH_NAMES = {
    "space": " ", "exclam": "!", "quotedbl": '"', "numbersign": "#",
    "dollar": "$", "percent": "%", "ampersand": "&", "quotesingle": "'",
    "parenleft": "(", "parenright": ")", "asterisk": "*", "plus": "+",
    "comma": ",", "hyphen": "-", "period": ".", "slash": "/", "colon": ":",
    "semicolon": ";", "less": "<", "equal": "=", "greater": ">",
    "question": "?", "at": "@", "bracketleft": "[", "backslash": "\\",
    "bracketright": "]", "asciicircum": "^", "underscore": "_",
    "grave": "`", "braceleft": "{", "bar": "|", "braceright": "}",
    "asciitilde": "~", "quoteleft": "‘", "quoteright": "’",
    "quotedblleft": "“", "quotedblright": "”",
    "endash": "–", "emdash": "—", "bullet": "•",
    "fi": "ﬁ", "fl": "ﬂ", "ellipsis": "…",
    "dagger": "†", "daggerdbl": "‡", "section": "§",
    "paragraph": "¶", "sterling": "£", "degree": "°",
    "copyright": "©", "registered": "®", "trademark": "™",
    "zero": "0", "one": "1", "two": "2", "three": "3", "four": "4",
    "five": "5", "six": "6", "seven": "7", "eight": "8", "nine": "9",
    "germandbls": "ß", "ae": "æ", "AE": "Æ",
    "oe": "œ", "OE": "Œ", "oslash": "ø", "Oslash": "Ø",
    "thorn": "þ", "Thorn": "Þ", "eth": "ð", "Eth": "Ð",
    "dotlessi": "ı", "cedilla": "¸", "dieresis": "¨",
    "macron": "¯", "acute": "´", "caron": "ˇ",
    "breve": "˘", "tilde": "˜", "ring": "˚",
    "ogonek": "˛", "hungarumlaut": "˝", "circumflex": "ˆ",
}

# accent-name -> combining suffix for names like "eacute"/"Ccedilla"
_ACCENTS = {
    "acute": "́", "grave": "̀", "circumflex": "̂",
    "tilde": "̃", "dieresis": "̈", "ring": "̊",
    "cedilla": "̧", "macron": "̄", "breve": "̆",
    "caron": "̌", "ogonek": "̨", "dotaccent": "̇",
    "hungarumlaut": "̋",
}


def _glyph_to_unicode(name: str) -> Optional[str]:
    """Glyph name -> text, best effort (AGL subset + uniXXXX + accents)."""
    if not name:
        return None
    if name in _GLYPH_NAMES:
        return _GLYPH_NAMES[name]
    if len(name) == 1:
        return name
    if name.startswith("uni") and len(name) >= 7:
        try:
            return "".join(chr(int(name[i:i + 4], 16))
                           for i in range(3, len(name) - 3, 4))
        except ValueError:
            return None
    if name.startswith("u") and len(name) in (5, 7):
        try:
            return chr(int(name[1:], 16))
        except ValueError:
            return None
    # composed names like "eacute", "Ccedilla", "ntilde"
    base, rest = name[0], name[1:]
    if base.isalpha() and rest in _ACCENTS:
        import unicodedata

        return unicodedata.normalize("NFC", base + _ACCENTS[rest])
    return None


class _Font:
    """Byte-string -> unicode decoding for one font resource."""

    def __init__(self, doc: PdfDocument, font_dict: dict):
        self.two_byte = False
        self.undecodable = False
        self.cmap: dict[int, str] = {}
        self.codec = "latin-1"
        self.diff_map: dict[int, str] = {}
        subtype = doc.resolve(font_dict.get(Name("Subtype")))
        if subtype == Name("Type0"):
            self.two_byte = True
        enc = doc.resolve(font_dict.get(Name("Encoding")))
        codecs = {"WinAnsiEncoding": "cp1252", "MacRomanEncoding": "mac_roman"}
        if isinstance(enc, Name):
            self.codec = codecs.get(str(enc), "latin-1")
        elif isinstance(enc, dict):
            base = doc.resolve(enc.get(Name("BaseEncoding")))
            if isinstance(base, Name):
                self.codec = codecs.get(str(base), "latin-1")
            diffs = doc.resolve(enc.get(Name("Differences")))
            if isinstance(diffs, list):
                code = 0
                for item in diffs:
                    item = doc.resolve(item)
                    if isinstance(item, (int, float)):
                        code = int(item)
                    elif isinstance(item, Name):
                        uni = _glyph_to_unicode(str(item))
                        if uni is not None and 0 <= code <= 255:
                            self.diff_map[code] = uni
                        code += 1
        to_unicode = doc.resolve(font_dict.get(Name("ToUnicode")))
        if isinstance(to_unicode, Stream):
            try:
                self._parse_cmap(to_unicode.data(doc))
            except Exception:
                pass  # corrupt CMap: fall through to the no-cmap paths
        if self.two_byte and not self.cmap:
            # CID/Type0 without a usable ToUnicode: the codes are glyph ids,
            # not characters — emitting chr(code) would inject mojibake into
            # the anchor. Degrade to no text (the page report still carries
            # image boxes, so the anchor becomes image-only — matching
            # poppler's behavior of garbled-or-empty on such fonts).
            self.undecodable = True

    def _parse_cmap(self, data: bytes):
        lex = _Lexer(data, 0)
        mode: Optional[str] = None
        pending: list = []
        while True:
            obj = _parse_object(lex, None)
            if obj is None and lex.peek() == b"":
                break
            if obj == b"beginbfchar":
                mode, pending = "char", []
            elif obj == b"beginbfrange":
                mode, pending = "range", []
            elif obj in (b"endbfchar", b"endbfrange"):
                mode = None
            elif mode == "char":
                pending.append(obj)
                if len(pending) == 2:
                    src, dst = pending
                    pending = []
                    if isinstance(src, bytes) and isinstance(dst, bytes):
                        self.cmap[int.from_bytes(src, "big")] = _utf16(dst)
            elif mode == "range":
                pending.append(obj)
                if len(pending) == 3:
                    lo, hi, dst = pending
                    pending = []
                    if not isinstance(lo, bytes) or not isinstance(hi, bytes):
                        continue
                    lo_i, hi_i = int.from_bytes(lo, "big"), int.from_bytes(hi, "big")
                    if isinstance(dst, bytes):
                        base = int.from_bytes(dst, "big")
                        width = len(dst)
                        for code in range(lo_i, min(hi_i, lo_i + 65535) + 1):
                            self.cmap[code] = _utf16(
                                (base + code - lo_i).to_bytes(width, "big"))
                    elif isinstance(dst, list):
                        for off, d in enumerate(dst):
                            if isinstance(d, bytes):
                                self.cmap[lo_i + off] = _utf16(d)

    def decode(self, raw: bytes) -> str:
        if self.undecodable:
            return ""
        if self.two_byte:
            codes = [int.from_bytes(raw[i:i + 2], "big")
                     for i in range(0, len(raw) - len(raw) % 2, 2)]
        else:
            codes = list(raw)
        if self.cmap:
            return "".join(self.cmap.get(c, "") for c in codes)
        # (two_byte without a cmap never reaches here: __init__ marks those
        # fonts undecodable and decode returned "" above)
        if self.diff_map:
            return "".join(
                self.diff_map.get(c, bytes([c]).decode(self.codec, "ignore"))
                for c in codes)
        return raw.decode(self.codec, errors="ignore")


def _utf16(b: bytes) -> str:
    try:
        return b.decode("utf-16-be", errors="ignore")
    except Exception:
        return ""


def extract_page_report(doc: PdfDocument, page_index: int,
                        max_ops: int = 500_000) -> PageReport:
    page = doc.pages[page_index]
    mediabox = doc.media_box(page_index)
    if getattr(doc, "encrypt_unsupported", False):
        # content streams are ciphertext we cannot remove (real password /
        # exotic handler): a mediabox-only report gives the pipeline a clean
        # "Page dimensions" anchor instead of binary noise
        return PageReport(mediabox=mediabox, text_elements=[],
                          image_elements=[])
    resources = doc.resolve(page.get(Name("Resources"))) or {}
    fonts_res = doc.resolve(resources.get(Name("Font"))) or {}
    xobjects = doc.resolve(resources.get(Name("XObject"))) or {}

    font_cache: dict[str, _Font] = {}

    def get_font(name: str) -> _Font:
        if name not in font_cache:
            fd = doc.resolve(fonts_res.get(Name(name)))
            font_cache[name] = _Font(doc, fd if isinstance(fd, dict) else {})
        return font_cache[name]

    content = _strip_inline_images(doc.page_content(page_index))

    texts: list[TextElement] = []
    images: list[ImageElement] = []

    ctm = _IDENTITY
    stack: list = []
    tm = _IDENTITY
    tlm = _IDENTITY
    font: Optional[_Font] = None
    font_size = 1.0
    leading = 0.0
    render_mode = 0  # Tr text state; part of graphics state (q/Q-saved)
    operands: list = []

    def show(raw: bytes):
        if not isinstance(raw, bytes):
            return
        decoded = (font.decode(raw) if font else
                   raw.decode("latin-1", errors="ignore"))
        if not decoded.strip():
            return
        trm = _mat_mul(tm, ctm)
        texts.append(TextElement(trm[4], trm[5], decoded, render_mode))

    ops = 0
    for obj in _iter_tokens(content, doc):
        ops += 1
        if ops > max_ops:
            break
        if not isinstance(obj, Op):
            operands.append(obj)
            continue
        op = obj
        try:
            if op == b"q":
                stack.append((ctm, render_mode))
            elif op == b"Q":
                ctm, render_mode = stack.pop() if stack else (_IDENTITY, 0)
            elif op == b"Tr" and operands:
                render_mode = int(float(operands[-1]))
            elif op == b"cm" and len(operands) >= 6:
                m = tuple(float(v) for v in operands[-6:])
                ctm = _mat_mul(m, ctm)
            elif op == b"BT":
                tm = tlm = _IDENTITY
            elif op == b"Tf" and len(operands) >= 2:
                name = operands[-2]
                font = get_font(str(name)) if isinstance(name, Name) else None
                font_size = float(operands[-1])
            elif op == b"TL" and operands:
                leading = float(operands[-1])
            elif op == b"Td" and len(operands) >= 2:
                tlm = _mat_mul((1, 0, 0, 1, float(operands[-2]),
                                float(operands[-1])), tlm)
                tm = tlm
            elif op == b"TD" and len(operands) >= 2:
                leading = -float(operands[-1])
                tlm = _mat_mul((1, 0, 0, 1, float(operands[-2]),
                                float(operands[-1])), tlm)
                tm = tlm
            elif op == b"Tm" and len(operands) >= 6:
                tm = tlm = tuple(float(v) for v in operands[-6:])
            elif op == b"T*":
                tlm = _mat_mul((1, 0, 0, 1, 0.0, -leading), tlm)
                tm = tlm
            elif op == b"Tj" and operands:
                show(operands[-1])
            elif op == b"'" and operands:
                tlm = _mat_mul((1, 0, 0, 1, 0.0, -leading), tlm)
                tm = tlm
                show(operands[-1])
            elif op == b'"' and len(operands) >= 3:
                tlm = _mat_mul((1, 0, 0, 1, 0.0, -leading), tlm)
                tm = tlm
                show(operands[-1])
            elif op == b"TJ" and operands and isinstance(operands[-1], list):
                parts = [p for p in operands[-1] if isinstance(p, bytes)]
                show(b"".join(parts))
            elif op == b"Do" and operands and isinstance(operands[-1], Name):
                name = str(operands[-1])
                xo = doc.resolve(xobjects.get(Name(name)))
                if (isinstance(xo, Stream) and
                        doc.resolve(xo.dict.get(Name("Subtype"))) == Name("Image")):
                    x0, y0 = _apply(ctm, 0.0, 0.0)
                    x1, y1 = _apply(ctm, 1.0, 1.0)
                    images.append(ImageElement(
                        name, min(x0, x1), min(y0, y1), max(x0, x1), max(y0, y1)))
            # (inline BI..EI images are stripped before lexing)
        except (TypeError, ValueError, IndexError):
            pass
        operands = []

    del font_size
    return PageReport(mediabox=mediabox, text_elements=texts,
                      image_elements=images)


def extract_plain_text(doc: PdfDocument, page_index: int) -> str:
    """pdftotext-style linearized text: elements sorted top-to-bottom, joined."""
    report = extract_page_report(doc, page_index)
    elems = sorted(report.text_elements, key=lambda e: (-e.y, e.x))
    lines: list[str] = []
    current_y: Optional[float] = None
    buf: list[str] = []
    for el in elems:
        if current_y is None or abs(el.y - current_y) > 2.0:
            if buf:
                lines.append(" ".join(buf))
            buf = [el.text]
            current_y = el.y
        else:
            buf.append(el.text)
    if buf:
        lines.append(" ".join(buf))
    return "\n".join(lines)
