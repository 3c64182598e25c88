"""Anchor-text generation: budgeted linearization of a page's raw text layer.

Produces the RAW_TEXT block the OCR prompt embeds ({{base_text}} slot), in the
same wire format the olmOCR-family checkpoints were trained on:

    Page dimensions: 612.0x792.0
    [70x740]A line of text
    [Image 50x50 to 300x200]

Reference behavior being matched (karanta/prompts/anchor.py):
  - pdfreport engine: positioned text + merged image boxes (:69-198)
  - budgeted selection: always keep edge elements, randomly fill the middle
    up to the length budget, then sort top-to-bottom (:231-342)
  - per-element 250-char cap, whitespace escaping (:201-228)
  - pdftotext engine for fallback pages (pipeline.py:440-442)
"""

from __future__ import annotations

import random
import unicodedata

from karanta_tpu_torch.pdf.minipdf import PdfDocument
from karanta_tpu_torch.pdf.textextract import (
    ImageElement, PageReport, extract_page_report, extract_plain_text,
)

MAX_ELEMENT_CHARS = 250
MAX_IMAGES = 100


def _clean_text(text: str) -> str:
    text = unicodedata.normalize("NFKC", text)
    text = text.replace("\n", "\\n").replace("\r", "\\r").replace("\t", " ")
    text = "".join(c for c in text if c.isprintable() or c == " ")
    return text[:MAX_ELEMENT_CHARS]


def _merge_images(images: list[ImageElement]) -> list[ImageElement]:
    """Union overlapping image boxes; bail out (keep as-is) past MAX_IMAGES."""
    if len(images) > MAX_IMAGES:
        return images[:MAX_IMAGES]
    boxes = [[im.x0, im.y0, im.x1, im.y1] for im in images]
    parent = list(range(len(boxes)))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    def overlap(a, b):
        return not (a[2] < b[0] or b[2] < a[0] or a[3] < b[1] or b[3] < a[1])

    for i in range(len(boxes)):
        for j in range(i + 1, len(boxes)):
            if overlap(boxes[i], boxes[j]):
                parent[find(i)] = find(j)

    merged: dict[int, list[float]] = {}
    for i, box in enumerate(boxes):
        root = find(i)
        if root not in merged:
            merged[root] = list(box)
        else:
            m = merged[root]
            m[0], m[1] = min(m[0], box[0]), min(m[1], box[1])
            m[2], m[3] = max(m[2], box[2]), max(m[3], box[3])
    return [ImageElement("img", *m) for m in merged.values()]


def _linearize(report: PageReport, max_length: int, seed: int = 1337) -> str:
    w = report.mediabox[2] - report.mediabox[0]
    h = report.mediabox[3] - report.mediabox[1]
    header = f"Page dimensions: {w:.1f}x{h:.1f}\n"

    entries: list[tuple[float, float, str]] = []
    for im in _merge_images(report.image_elements):
        entries.append((im.y1, im.x0,
                        f"[Image {im.x0:.0f}x{im.y0:.0f} to {im.x1:.0f}x{im.y1:.0f}]"))
    for el in report.text_elements:
        cleaned = _clean_text(el.text)
        if cleaned.strip():
            entries.append((el.y, el.x, f"[{el.x:.0f}x{el.y:.0f}]{cleaned}"))

    if not entries:
        return header

    budget = max_length - len(header)
    total = sum(len(e[2]) + 1 for e in entries)
    if total <= budget:
        chosen = entries
    else:
        # keep page-edge elements (top-most/bottom-most content anchors the
        # model on headers/footers and continuations), randomly fill the rest
        by_y = sorted(entries, key=lambda e: e[0])
        edge = by_y[:2] + by_y[-2:] if len(by_y) > 4 else by_y
        chosen_set = {id(e) for e in edge}
        used = sum(len(e[2]) + 1 for e in edge)
        middle = [e for e in entries if id(e) not in chosen_set]
        rng = random.Random(seed)
        rng.shuffle(middle)
        chosen = list(edge)
        for e in middle:
            cost = len(e[2]) + 1
            if used + cost > budget:
                continue
            chosen.append(e)
            used += cost

    chosen.sort(key=lambda e: (-e[0], e[1]))  # top-to-bottom, left-to-right
    return header + "\n".join(e[2] for e in chosen)


def get_anchor_text(local_pdf_path: str, page: int,
                    pdf_engine: str = "pdfreport",
                    target_length: int = 4000) -> str:
    """Anchor text for 1-based page. Engines: pdfreport | pdftotext."""
    try:
        doc = PdfDocument.open(local_pdf_path)
        if pdf_engine == "pdfreport":
            report = extract_page_report(doc, page - 1)
            return _linearize(report, target_length)
        if pdf_engine == "pdftotext":
            return extract_plain_text(doc, page - 1)[: target_length * 4]
        raise ValueError(f"Unknown pdf_engine {pdf_engine!r}")
    except ValueError:
        raise
    except Exception:
        # anchor text is best-effort: a malformed page yields an empty anchor
        return ""
