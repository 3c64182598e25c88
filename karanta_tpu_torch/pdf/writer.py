"""Single-page PDF extraction: copy one page's reachable object graph into a
new PDF (native replacement for pypdf PdfWriter in the page splitter —
reference karanta/data/split_pdf.py:17-44)."""

from __future__ import annotations

import io
from typing import Any

from karanta_tpu_torch.pdf.minipdf import Name, PdfDocument, Ref, Stream


def _serialize(obj: Any, renumber: dict[int, int]) -> bytes:
    if isinstance(obj, Ref):
        return f"{renumber[obj.num]} 0 R".encode()
    if isinstance(obj, Name):
        escaped = "".join(
            c if c.isalnum() or c in "-_.+" else f"#{ord(c):02X}"
            for c in str(obj))
        return b"/" + escaped.encode("latin-1")
    if isinstance(obj, bool):
        return b"true" if obj else b"false"
    if obj is None:
        return b"null"
    if isinstance(obj, (int, float)):
        if isinstance(obj, float) and obj.is_integer():
            obj = int(obj)
        return repr(obj).encode()
    if isinstance(obj, bytes):
        return b"<" + obj.hex().encode() + b">"
    if isinstance(obj, list):
        return b"[" + b" ".join(_serialize(v, renumber) for v in obj) + b"]"
    if isinstance(obj, dict):
        parts = [b"<<"]
        for key, value in obj.items():
            parts.append(_serialize(Name(key), renumber))
            parts.append(_serialize(value, renumber))
        parts.append(b">>")
        return b" ".join(parts)
    if isinstance(obj, Stream):
        d = dict(obj.dict)
        d[Name("Length")] = len(obj.raw)
        return (_serialize(d, renumber) + b"\nstream\n" + obj.raw
                + b"\nendstream")
    raise TypeError(f"cannot serialize {type(obj)}")


def _collect_refs(doc: PdfDocument, obj: Any, seen: set[int],
                  depth: int = 0) -> None:
    if depth > 64:
        return
    if isinstance(obj, Ref):
        if obj.num in seen:
            return
        seen.add(obj.num)
        _collect_refs(doc, doc.get_object(obj.num), seen, depth + 1)
    elif isinstance(obj, dict):
        for key, value in obj.items():
            if key == Name("Parent"):
                continue  # don't drag the whole page tree along
            _collect_refs(doc, value, seen, depth + 1)
    elif isinstance(obj, list):
        for value in obj:
            _collect_refs(doc, value, seen, depth + 1)
    elif isinstance(obj, Stream):
        _collect_refs(doc, obj.dict, seen, depth + 1)


def extract_page(doc: PdfDocument, page_index: int) -> bytes:
    """Build a standalone one-page PDF from page_index of doc."""
    page = dict(doc.pages[page_index])
    page.pop(Name("Parent"), None)
    page[Name("Type")] = Name("Page")

    seen: set[int] = set()
    _collect_refs(doc, page, seen)

    # object numbering: 1=Catalog, 2=Pages, 3=Page, then copied objects
    renumber = {num: i + 4 for i, num in enumerate(sorted(seen))}

    page[Name("Parent")] = Ref(-2, 0)  # sentinel, renumbered below
    renumber[-2] = 2

    out = io.BytesIO()
    out.write(b"%PDF-1.7\n")
    offsets: list[int] = []

    def write_obj(num: int, body: bytes):
        offsets.append(out.tell())
        out.write(f"{num} 0 obj\n".encode() + body + b"\nendobj\n")

    write_obj(1, b"<< /Type /Catalog /Pages 2 0 R >>")
    write_obj(2, b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>")
    write_obj(3, _serialize(page, renumber))
    for num in sorted(seen):
        write_obj(renumber[num], _serialize(doc.get_object(num), renumber))

    total = len(offsets)
    xref_pos = out.tell()
    out.write(f"xref\n0 {total + 1}\n".encode())
    out.write(b"0000000000 65535 f \n")
    for off in offsets:
        out.write(f"{off:010d} 00000 n \n".encode())
    out.write(f"trailer\n<< /Size {total + 1} /Root 1 0 R >>\n"
              f"startxref\n{xref_pos}\n%%EOF\n".encode())
    return out.getvalue()
