"""Minimal pure-Python PDF reader: page tree, media boxes, positioned text,
image placements.

Many hosts (the card host among them) ship neither poppler nor any Python PDF
package, so the framework carries its own reader for the hot metadata paths
the reference gets from pypdf/poppler: page count + MediaBox
(reference karanta/data/process_pdf_utils.py:6-47), positioned text + image
bounding boxes for anchor-text generation (karanta/prompts/anchor.py:69-198),
and plain-text fallback extraction (pipeline.py:440-442, pdf_engine="pdftotext").
Rasterization still shells out to pdftoppm when present (pdf/primitives.py) —
that path is genuinely I/O-bound and poppler-quality font rendering is out of
scope.

Supported: classic xref tables, xref streams, object streams (ObjStm),
FlateDecode (+ predictors for xref streams), the text operators
(BT/ET, Tf, Td, TD, Tm, T*, TL, Tj, TJ, ', "), CTM tracking (q/Q/cm), simple
font encodings + ToUnicode bfchar/bfrange CMaps, and image XObject Do
placements. Unsupported constructs degrade softly (skipped, never raise mid-
page) — matching the "best effort anchor" contract of the reference.
"""

from __future__ import annotations

import dataclasses
import re
import zlib
from typing import Any, BinaryIO, Optional

# ---------------------------------------------------------------------------
# object model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Ref:
    num: int
    gen: int


class Name(str):
    """A PDF name (/Foo) — distinct from strings."""


class Op(bytes):
    """A content-stream operator / keyword — distinct from string operands."""


@dataclasses.dataclass
class Stream:
    dict: dict
    raw: bytes

    def data(self, doc: "PdfDocument") -> bytes:
        filt = doc.resolve(self.dict.get(Name("Filter")))
        data = self.raw
        filters = filt if isinstance(filt, list) else ([filt] if filt else [])
        parms_entry = doc.resolve(self.dict.get(Name("DecodeParms")))
        parms_list = (parms_entry if isinstance(parms_entry, list)
                      else [parms_entry])
        for i, f in enumerate(filters):
            f = doc.resolve(f)
            if f == Name("FlateDecode"):
                try:
                    data = zlib.decompress(data)
                except zlib.error:
                    try:
                        # salvage a truncated-but-valid prefix (common in
                        # real-world PDFs with sloppy /Length values)
                        data = zlib.decompressobj().decompress(data)
                    except zlib.error as exc:
                        raise PdfError(f"corrupt Flate stream: {exc}")
                parms = doc.resolve(parms_list[i]) if i < len(parms_list) else None
                if isinstance(parms, dict):
                    data = _apply_predictor(data, doc, parms)
            elif f is None:
                continue
            else:
                # unsupported filter (DCT, CCITT, ...) — leave raw
                return data
        return data


def _apply_predictor(data: bytes, doc: "PdfDocument", parms: dict) -> bytes:
    predictor = doc.resolve(parms.get(Name("Predictor"), 1)) or 1
    if predictor < 10:
        return data
    columns = int(doc.resolve(parms.get(Name("Columns"), 1)) or 1)
    colors = int(doc.resolve(parms.get(Name("Colors"), 1)) or 1)
    bpc = int(doc.resolve(parms.get(Name("BitsPerComponent"), 8)) or 8)
    bpp = max(1, colors * bpc // 8)
    row_len = columns * bpp
    out = bytearray()
    prev = bytearray(row_len)
    pos = 0
    while pos + 1 + row_len <= len(data) + row_len:
        if pos >= len(data):
            break
        ft = data[pos]
        row = bytearray(data[pos + 1:pos + 1 + row_len])
        pos += 1 + row_len
        if ft == 0:
            pass
        elif ft == 1:
            for i in range(bpp, row_len):
                row[i] = (row[i] + row[i - bpp]) & 0xFF
        elif ft == 2:
            for i in range(row_len):
                row[i] = (row[i] + prev[i]) & 0xFF
        elif ft == 3:
            for i in range(row_len):
                left = row[i - bpp] if i >= bpp else 0
                row[i] = (row[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif ft == 4:
            for i in range(row_len):
                a = row[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                row[i] = (row[i] + pred) & 0xFF
        out.extend(row)
        prev = row
    return bytes(out)


# ---------------------------------------------------------------------------
# lexer / parser
# ---------------------------------------------------------------------------

_WHITESPACE = b"\x00\t\n\x0c\r "
_DELIMS = b"()<>[]{}/%"


class _Lexer:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def skip_ws(self):
        data, n = self.data, len(self.data)
        while self.pos < n:
            c = data[self.pos]
            if c in _WHITESPACE:
                self.pos += 1
            elif c == 0x25:  # %
                while self.pos < n and data[self.pos] not in b"\r\n":
                    self.pos += 1
            else:
                return

    def peek(self, k: int = 1) -> bytes:
        return self.data[self.pos:self.pos + k]

    def read_token(self) -> Optional[bytes]:
        self.skip_ws()
        data, n = self.data, len(self.data)
        if self.pos >= n:
            return None
        c = data[self.pos]
        if c in _DELIMS:
            if data[self.pos:self.pos + 2] in (b"<<", b">>"):
                self.pos += 2
                return data[self.pos - 2:self.pos]
            self.pos += 1
            return bytes([c])
        start = self.pos
        while self.pos < n and data[self.pos] not in _WHITESPACE + _DELIMS:
            self.pos += 1
        return data[start:self.pos]


_NUM_RE = re.compile(rb"^[+-]?(\d+\.?\d*|\.\d+)$")


def _parse_object(lex: _Lexer, doc: Optional["PdfDocument"] = None,
                  depth: int = 0) -> Any:
    if depth > 128:
        # corrupt/hostile nesting: fail instead of blowing the Python
        # stack (RecursionError escaping a worker thread)
        raise PdfError("object nesting too deep")
    lex.skip_ws()
    head = lex.peek(2)
    if head[:1] == b"(":
        return _parse_literal_string(lex)
    if head == b"<<":
        lex.read_token()
        return _parse_dict_body(lex, doc, depth)
    if head[:1] == b"<":
        return _parse_hex_string(lex)
    if head[:1] == b"[":
        lex.read_token()
        arr = []
        while True:
            lex.skip_ws()
            if lex.peek() == b"]":
                lex.read_token()
                return arr
            if lex.peek() == b"":
                return arr
            arr.append(_parse_object(lex, doc, depth + 1))
    if head[:1] == b"/":
        # the name's characters must immediately follow the slash (no ws skip)
        lex.pos += 1
        data = lex.data
        start = lex.pos
        while lex.pos < len(data) and data[lex.pos] not in _WHITESPACE + _DELIMS:
            lex.pos += 1
        return Name(_decode_name(data[start:lex.pos]))
    tok = lex.read_token()
    if tok is None:
        return None
    if tok in (b"true", b"false"):
        return tok == b"true"
    if tok == b"null":
        return None
    if _NUM_RE.match(tok):
        # might be "num gen R"
        save = lex.pos
        t2 = lex.read_token()
        t3 = lex.read_token() if t2 is not None else None
        if (t2 is not None and t3 == b"R" and _NUM_RE.match(t2)
                and b"." not in tok and b"." not in t2):
            return Ref(int(tok), int(t2))
        lex.pos = save
        return float(tok) if b"." in tok else int(tok)
    return Op(tok)  # operator / keyword


def _decode_name(tok: bytes) -> str:
    out = bytearray()
    i = 0
    while i < len(tok):
        if tok[i:i + 1] == b"#" and i + 2 < len(tok) + 1:
            try:
                out.append(int(tok[i + 1:i + 3], 16))
                i += 3
                continue
            except ValueError:
                pass
        out.append(tok[i])
        i += 1
    return out.decode("latin-1")


def _parse_dict_body(lex: _Lexer, doc, depth: int = 0) -> dict:
    d: dict = {}
    while True:
        lex.skip_ws()
        if lex.peek(2) == b">>":
            lex.read_token()
            return d
        if lex.peek() == b"":
            return d
        key = _parse_object(lex, doc, depth + 1)
        if not isinstance(key, Name):
            continue
        d[key] = _parse_object(lex, doc, depth + 1)


def _parse_literal_string(lex: _Lexer) -> bytes:
    data = lex.data
    assert data[lex.pos:lex.pos + 1] == b"("
    lex.pos += 1
    depth = 1
    out = bytearray()
    while lex.pos < len(data):
        c = data[lex.pos]
        if c == 0x5C:  # backslash
            lex.pos += 1
            if lex.pos >= len(data):
                break
            e = data[lex.pos]
            esc = {0x6E: 10, 0x72: 13, 0x74: 9, 0x62: 8, 0x66: 12,
                   0x28: 40, 0x29: 41, 0x5C: 92}
            if e in esc:
                out.append(esc[e])
                lex.pos += 1
            elif 0x30 <= e <= 0x37:  # octal
                oct_digits = bytearray()
                while (lex.pos < len(data) and len(oct_digits) < 3
                       and 0x30 <= data[lex.pos] <= 0x37):
                    oct_digits.append(data[lex.pos])
                    lex.pos += 1
                out.append(int(oct_digits, 8) & 0xFF)
            elif e in b"\r\n":
                lex.pos += 1
                if e == 0x0D and data[lex.pos:lex.pos + 1] == b"\n":
                    lex.pos += 1
            else:
                out.append(e)
                lex.pos += 1
        elif c == 0x28:
            depth += 1
            out.append(c)
            lex.pos += 1
        elif c == 0x29:
            depth -= 1
            lex.pos += 1
            if depth == 0:
                return bytes(out)
            out.append(c)
        else:
            out.append(c)
            lex.pos += 1
    return bytes(out)


def _parse_hex_string(lex: _Lexer) -> bytes:
    data = lex.data
    assert data[lex.pos:lex.pos + 1] == b"<"
    end = data.find(b">", lex.pos)
    if end < 0:
        end = len(data)
    hexstr = re.sub(rb"[^0-9A-Fa-f]", b"", data[lex.pos + 1:end])
    lex.pos = end + 1
    if len(hexstr) % 2:
        hexstr += b"0"
    return bytes.fromhex(hexstr.decode("ascii"))


# ---------------------------------------------------------------------------
# document
# ---------------------------------------------------------------------------


class PdfError(Exception):
    pass


class PdfDocument:
    def __init__(self, data: bytes):
        self.data = data
        self._objects: dict[int, Any] = {}
        self._offsets: dict[int, int] = {}
        self._objstm: dict[int, tuple[int, int]] = {}  # obj -> (stm num, idx)
        self.trailer: dict = {}
        self._rescanned = False
        self._scan_offsets: dict[int, int] = {}
        self._last_gen = 0
        self.handler = None  # standard security handler (pdf/crypt.py)
        self.encrypt_unsupported = False
        self._encrypt_num = -1
        self._load_xref()
        self._init_encryption()
        self._pages: Optional[list[dict]] = None

    def _init_encryption(self):
        """Install the standard security handler for /Encrypt docs (empty
        user password — the archive.org DRM-flavored case pypdf/poppler
        open transparently). Anything we can't decrypt marks the doc
        `encrypt_unsupported`; extraction then degrades to mediabox-only
        reports instead of emitting ciphertext as text."""
        enc = self.trailer.get(Name("Encrypt"))
        if enc is None:
            return
        if isinstance(enc, Ref):
            self._encrypt_num = enc.num
        try:
            enc_dict = self.resolve(enc)
        except Exception:
            self.encrypt_unsupported = True
            return
        if not isinstance(enc_dict, dict):
            self.encrypt_unsupported = True
            return
        id0 = b""
        ids = self.resolve(self.trailer.get(Name("ID")))
        if isinstance(ids, list) and ids:
            first = self.resolve(ids[0])
            if isinstance(first, bytes):
                id0 = first
        try:
            from karanta_tpu_torch.pdf.crypt import make_security_handler

            self.handler = make_security_handler(enc_dict, id0, self.resolve)
        except Exception:
            self.handler = None
            self.encrypt_unsupported = True

    @classmethod
    def open(cls, path_or_file: "str | bytes | BinaryIO") -> "PdfDocument":
        if isinstance(path_or_file, bytes):
            return cls(path_or_file)
        if isinstance(path_or_file, str):
            with open(path_or_file, "rb") as f:
                return cls(f.read())
        return cls(path_or_file.read())

    # -- xref loading ------------------------------------------------------

    def _load_xref(self):
        idx = self.data.rfind(b"startxref")
        if idx < 0:
            self._scan_all_objects()
            return
        lex = _Lexer(self.data, idx + len(b"startxref"))
        tok = lex.read_token()
        try:
            offset = int(tok)
        except (TypeError, ValueError):
            self._scan_all_objects()
            return
        seen = set()
        while offset and offset not in seen and 0 <= offset < len(self.data):
            seen.add(offset)
            offset = self._load_xref_section(offset)
        if not self._offsets and not self._objstm:
            self._scan_all_objects()

    def _load_xref_section(self, offset: int) -> Optional[int]:
        lex = _Lexer(self.data, offset)
        lex.skip_ws()
        if lex.peek(4) == b"xref":
            lex.read_token()
            while True:
                lex.skip_ws()
                if lex.peek(7) == b"trailer":
                    lex.read_token()
                    trailer = _parse_object(lex, self)
                    if isinstance(trailer, dict):
                        for k, v in trailer.items():
                            self.trailer.setdefault(k, v)
                        xs = trailer.get(Name("XRefStm"))
                        if isinstance(xs, int):
                            self._load_xref_section(xs)
                        prev = trailer.get(Name("Prev"))
                        return int(prev) if isinstance(prev, (int, float)) else None
                    return None
                start_tok = lex.read_token()
                count_tok = lex.read_token()
                if start_tok is None or count_tok is None:
                    return None
                try:
                    start, count = int(start_tok), int(count_tok)
                except ValueError:
                    return None
                for i in range(count):
                    lex.skip_ws()
                    entry = self.data[lex.pos:lex.pos + 20]
                    lex.pos += 20 if len(entry) >= 20 else len(entry)
                    if len(entry) < 18:
                        return None
                    if entry[17:18] == b"n" and (start + i) not in self._offsets:
                        self._offsets[start + i] = int(entry[0:10])
        else:
            # xref stream: "N G obj << ... >> stream"
            obj = self._parse_indirect_at(offset)
            if not isinstance(obj, Stream):
                return None
            d = obj.dict
            data = obj.data(self)
            w = [int(self.resolve(x)) for x in self.resolve(d.get(Name("W"), []))]
            size = int(self.resolve(d.get(Name("Size"), 0)))
            index = self.resolve(d.get(Name("Index"), [0, size]))
            index = [int(self.resolve(x)) for x in index]
            for k, v in d.items():
                self.trailer.setdefault(k, v)
            row = sum(w)
            pos = 0

            def field(buf, start, width, default):
                if width == 0:
                    return default
                return int.from_bytes(buf[start:start + width], "big")

            for j in range(0, len(index), 2):
                first, count = index[j], index[j + 1]
                for i in range(count):
                    if pos + row > len(data):
                        break
                    buf = data[pos:pos + row]
                    pos += row
                    ftype = field(buf, 0, w[0], 1)
                    f2 = field(buf, w[0], w[1] if len(w) > 1 else 0, 0)
                    f3 = field(buf, w[0] + (w[1] if len(w) > 1 else 0),
                               w[2] if len(w) > 2 else 0, 0)
                    num = first + i
                    if ftype == 1 and num not in self._offsets:
                        self._offsets[num] = f2
                    elif ftype == 2 and num not in self._objstm:
                        self._objstm[num] = (f2, f3)
            prev = d.get(Name("Prev"))
            return int(prev) if isinstance(prev, (int, float)) else None
        return None

    def _scan_all_objects(self):
        """Fallback: regex-scan for 'N G obj' (damaged/unusual files)."""
        for m in re.finditer(rb"(\d+)\s+(\d+)\s+obj\b", self.data):
            self._offsets[int(m.group(1))] = m.start()
        m = re.search(rb"trailer", self.data)
        if m:
            lex = _Lexer(self.data, m.end())
            trailer = _parse_object(lex, self)
            if isinstance(trailer, dict):
                self.trailer.update(trailer)
        else:
            # xref-stream-only file: find /Root in any dict
            for num in list(self._offsets):
                obj = self.get_object(num)
                d = obj.dict if isinstance(obj, Stream) else obj
                if isinstance(d, dict) and Name("Root") in d:
                    self.trailer.setdefault(Name("Root"), d[Name("Root")])

    # -- object access -----------------------------------------------------

    def _parse_indirect_at(self, offset: int,
                           expect_num: Optional[int] = None) -> Any:
        lex = _Lexer(self.data, offset)
        num_tok = lex.read_token()
        gen_tok = lex.read_token()
        kw = lex.read_token()
        if kw != b"obj":
            return None
        try:
            header_num = int(num_tok)
            header_gen = int(gen_tok)
        except (TypeError, ValueError):
            return None
        if expect_num is not None and header_num != expect_num:
            # broken xref: the table points at a different object (shifted
            # offsets from sloppy incremental updates are common in the wild)
            return None
        value = _parse_object(lex, self)
        lex.skip_ws()
        if lex.peek(6) == b"stream":
            lex.pos += 6
            if self.data[lex.pos:lex.pos + 2] == b"\r\n":
                lex.pos += 2
            elif self.data[lex.pos:lex.pos + 1] == b"\n":
                lex.pos += 1
            length = self.resolve(value.get(Name("Length")))
            if not isinstance(length, int):
                end = self.data.find(b"endstream", lex.pos)
                length = max(end - lex.pos, 0)
            raw = self.data[lex.pos:lex.pos + int(length)]
            # set AFTER nested resolution (an indirect /Length re-enters this
            # method and would otherwise clobber the outer object's gen —
            # the decryption key depends on it)
            self._last_gen = header_gen
            return Stream(value, raw)
        self._last_gen = header_gen
        return value

    def get_object(self, num: int) -> Any:
        if num in self._objects:
            return self._objects[num]
        value = None
        from_offsets = False
        if num in self._offsets:
            value = self._parse_indirect_at(self._offsets[num],
                                            expect_num=num)
            from_offsets = True
        elif num in self._objstm:
            stm_num, idx = self._objstm[num]
            value = self._load_from_objstm(stm_num, idx, num)
        if value is None:
            # xref recovery: the recorded offset was broken or the object is
            # missing from every table — locate it by scanning the file once
            # (pypdf/poppler-style tolerance for damaged archives)
            recovered = self._recovered_offset(num)
            if recovered is not None:
                value = self._parse_indirect_at(recovered, expect_num=num)
                from_offsets = True
        if (value is not None and from_offsets and self.handler is not None
                and num != self._encrypt_num):
            value = self._decrypt_value(value, num, self._last_gen)
        self._objects[num] = value
        return value

    def _recovered_offset(self, num: int) -> Optional[int]:
        if not self._rescanned:
            self._rescanned = True
            # last occurrence wins: incremental updates append newer bodies
            for m in re.finditer(rb"(?:^|[\r\n])\s*(\d+)\s+(\d+)\s+obj\b",
                                 self.data):
                self._scan_offsets[int(m.group(1))] = m.start(1)
        return self._scan_offsets.get(num)

    def _decrypt_value(self, value: Any, num: int, gen: int) -> Any:
        """Decrypt every string/stream in an indirect object's value
        (objects inside object streams are already plaintext — the ObjStm
        stream itself was decrypted — so this is only applied to objects
        parsed from file offsets)."""
        h = self.handler

        def walk(v):
            if isinstance(v, Op) or isinstance(v, bool):
                return v
            if isinstance(v, bytes):
                return h.decrypt_string(v, num, gen)
            if isinstance(v, list):
                return [walk(x) for x in v]
            if isinstance(v, Stream):
                return Stream({k: walk(x) for k, x in v.dict.items()},
                              h.decrypt_stream(v.raw, num, gen))
            if isinstance(v, dict):
                return {k: walk(x) for k, x in v.items()}
            return v

        try:
            return walk(value)
        except Exception:
            self.encrypt_unsupported = True
            return value

    def _load_from_objstm(self, stm_num: int, idx: int, want: int) -> Any:
        stm = self.get_object(stm_num)
        if not isinstance(stm, Stream):
            return None
        data = stm.data(self)
        n = int(self.resolve(stm.dict.get(Name("N"), 0)))
        first = int(self.resolve(stm.dict.get(Name("First"), 0)))
        lex = _Lexer(data, 0)
        pairs = []
        for _ in range(n):
            a, b = lex.read_token(), lex.read_token()
            if a is None or b is None:
                break
            pairs.append((int(a), int(b)))
        for onum, ooff in pairs:
            if onum == want:
                sub = _Lexer(data, first + ooff)
                return _parse_object(sub, self)
        return None

    def resolve(self, obj: Any, depth: int = 0) -> Any:
        while isinstance(obj, Ref) and depth < 32:
            obj = self.get_object(obj.num)
            depth += 1
        return obj

    # -- pages -------------------------------------------------------------

    @property
    def pages(self) -> list[dict]:
        if self._pages is None:
            self._pages = []
            root = self.resolve(self.trailer.get(Name("Root")))
            if not isinstance(root, dict):  # corrupt graph: fall through
                root = {}
            tree = self.resolve(root.get(Name("Pages")))
            if isinstance(tree, dict):
                self._walk_pages(tree, {}, 0)
            if not self._pages:
                # fallback: any object with /Type /Page
                for num in sorted(self._offsets) + sorted(self._objstm):
                    obj = self.resolve(self.get_object(num))
                    if (isinstance(obj, dict)
                            and obj.get(Name("Type")) == Name("Page")):
                        self._pages.append(obj)
        return self._pages

    def _walk_pages(self, node: dict, inherited: dict, depth: int):
        if depth > 64 or not isinstance(node, dict):
            return
        inh = dict(inherited)
        for key in (Name("MediaBox"), Name("Resources"), Name("Rotate")):
            if key in node:
                inh[key] = node[key]
        if node.get(Name("Type")) == Name("Page"):
            page = dict(inh)
            page.update(node)
            self._pages.append(page)
            return
        for kid in self.resolve(node.get(Name("Kids"), [])) or []:
            self._walk_pages(self.resolve(kid), inh, depth + 1)

    def num_pages(self) -> int:
        return len(self.pages)

    def media_box(self, page_index: int) -> tuple[float, float, float, float]:
        page = self.pages[page_index]
        box = self.resolve(page.get(Name("MediaBox"), [0, 0, 612, 792]))
        vals = [float(self.resolve(v)) for v in box]
        return tuple(vals)  # type: ignore[return-value]

    def page_content(self, page_index: int) -> bytes:
        page = self.pages[page_index]
        contents = self.resolve(page.get(Name("Contents")))
        parts = []
        items = contents if isinstance(contents, list) else [contents]
        for item in items:
            item = self.resolve(item)
            if isinstance(item, Stream):
                parts.append(item.data(self))
        return b"\n".join(parts)
