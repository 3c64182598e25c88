"""Page/document result types + Dolma JSONL document builder.

Byte-compatible with the reference's output schema (karanta/pipeline.py:
PageResponse fields from olmocr.prompts — SURVEY.md §2.11; build_dolma_document
:538-591): the Dolma doc id is the sha1 of the text, page spans are
[start, end, page_num] character ranges, and attributes carry the per-page
analysis fields.
"""

from __future__ import annotations

import dataclasses
import datetime
import hashlib
from typing import List, Optional

from karanta_tpu_torch.version import VERSION


@dataclasses.dataclass(frozen=True)
class PageResponse:
    natural_text: Optional[str]
    primary_language: Optional[str] = None
    is_rotation_valid: bool = True
    rotation_correction: int = 0
    is_table: bool = False
    is_diagram: bool = False

    def __post_init__(self):
        if self.rotation_correction not in (0, 90, 180, 270):
            raise ValueError(
                f"rotation_correction must be 0/90/180/270, "
                f"got {self.rotation_correction}")


@dataclasses.dataclass(frozen=True)
class ListPageResponse:
    pages: List[PageResponse]

    @property
    def natural_text(self) -> Optional[str]:
        texts = [p.natural_text for p in self.pages if p.natural_text]
        return "\n".join(texts) if texts else None


@dataclasses.dataclass(frozen=True)
class PageResult:
    s3_path: str
    page_num: int
    response: ListPageResponse
    input_tokens: int
    output_tokens: int
    is_fallback: bool


def build_dolma_document(pdf_orig_path: str,
                         page_results: List[PageResult]) -> Optional[dict]:
    """Assemble one Dolma JSONL record from per-page results.

    Returns None when the document has no text (reference :560-561).
    """
    document_text = ""
    pdf_page_spans = []
    for index, page_result in enumerate(page_results):
        text = page_result.response.natural_text
        if text is not None:
            content = text + ("\n" if index < len(page_results) - 1 else "")
        else:
            content = ""
        start = len(document_text)
        document_text += content
        pdf_page_spans.append([start, len(document_text), page_result.page_num])

    if not document_text:
        return None

    today = datetime.datetime.now().strftime("%Y-%m-%d")
    first_pages = [p.response.pages[0] if p.response.pages else
                   PageResponse(natural_text=None) for p in page_results]
    return {
        "id": hashlib.sha1(document_text.encode()).hexdigest(),
        "text": document_text,
        "source": "karanta-tpu",
        "added": today,
        "created": today,
        "metadata": {
            "Source-File": pdf_orig_path,
            "karanta-tpu-version": VERSION,
            "pdf-total-pages": len(page_results),
            "total-input-tokens": sum(p.input_tokens for p in page_results),
            "total-output-tokens": sum(p.output_tokens for p in page_results),
            "total-fallback-pages": sum(p.is_fallback for p in page_results),
        },
        "attributes": {
            "pdf_page_numbers": pdf_page_spans,
            "primary_language": [p.primary_language for p in first_pages],
            "is_rotation_valid": [p.is_rotation_valid for p in first_pages],
            "rotation_correction": [p.rotation_correction for p in first_pages],
            "is_table": [p.is_table for p in first_pages],
            "is_diagram": [p.is_diagram for p in first_pages],
        },
    }
