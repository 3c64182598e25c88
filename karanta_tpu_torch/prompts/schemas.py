"""Structured-output schemas for teacher LLMs and bench test generation.

Parity surface with reference karanta/data/utils.py:322-639: OpenAI
response_format JSON schemas for single/multi-page analysis, bench test-case
schemas (text_present / text_absent / text_order), and the pydantic models
used to validate teacher responses.
"""

from __future__ import annotations

from typing import List, Optional

from pydantic import BaseModel


class PageAnalysis(BaseModel):
    primary_language: Optional[str]
    is_rotation_valid: bool
    rotation_correction: int
    is_table: bool
    is_diagram: bool
    natural_text: Optional[str]


class PagesAnalysisResponse(BaseModel):
    pages: List[PageAnalysis]


_PAGE_PROPERTIES = {
    "primary_language": {
        "type": ["string", "null"],
        "description": "Two-letter code of the page's primary language, or "
                       "null when there is no readable text.",
    },
    "is_rotation_valid": {
        "type": "boolean",
        "description": "True when the page is upright as presented.",
    },
    "rotation_correction": {
        "type": "integer",
        "enum": [0, 90, 180, 270],
        "description": "Clockwise rotation that would make the page upright.",
    },
    "is_table": {
        "type": "boolean",
        "description": "True when the page is dominated by tabular content.",
    },
    "is_diagram": {
        "type": "boolean",
        "description": "True when the page is dominated by a diagram/figure.",
    },
    "natural_text": {
        "type": ["string", "null"],
        "description": "The page's natural plain-text reading, or null.",
    },
}

_PAGE_SCHEMA = {
    "type": "object",
    "properties": _PAGE_PROPERTIES,
    "required": list(_PAGE_PROPERTIES),
    "additionalProperties": False,
}


def openai_response_format_schema() -> dict:
    """response_format for single-page analysis."""
    return {
        "type": "json_schema",
        "json_schema": {
            "name": "page_response",
            "schema": _PAGE_SCHEMA,
            "strict": True,
        },
    }


def openai_response_format_schema_multipages() -> dict:
    """response_format for multi-page (scan-of-spread) analysis."""
    return {
        "type": "json_schema",
        "json_schema": {
            "name": "pages_response",
            "schema": {
                "type": "object",
                "properties": {
                    "pages": {"type": "array", "items": _PAGE_SCHEMA},
                },
                "required": ["pages"],
                "additionalProperties": False,
            },
            "strict": True,
        },
    }


def _test_schema(name: str, extra_properties: dict, required: list[str]) -> dict:
    properties = {
        "pdf": {"type": "string", "description": "Source PDF file name."},
        "page": {"type": "integer", "description": "1-based page number."},
        "id": {"type": "string", "description": "Unique test id."},
        "type": {"type": "string", "enum": [name]},
        "max_diffs": {
            "type": "integer",
            "description": "Edit-distance tolerance when matching text.",
        },
        **extra_properties,
    }
    return {
        "type": "json_schema",
        "json_schema": {
            "name": name,
            "schema": {
                "type": "object",
                "properties": properties,
                "required": ["pdf", "page", "id", "type"] + required,
                "additionalProperties": False,
            },
            "strict": True,
        },
    }


def text_present_test_schema() -> dict:
    """Bench test: a snippet that must appear in the OCR output."""
    return _test_schema("present", {
        "text": {"type": "string",
                 "description": "Text that must appear in the output."},
        "case_sensitive": {"type": "boolean"},
        "first_n": {"type": ["integer", "null"]},
        "last_n": {"type": ["integer", "null"]},
    }, ["text"])


def text_absent_test_schema() -> dict:
    """Bench test: a snippet (header/footer/artifact) that must NOT appear."""
    return _test_schema("absent", {
        "text": {"type": "string",
                 "description": "Text that must not appear in the output."},
        "case_sensitive": {"type": "boolean"},
        "first_n": {"type": ["integer", "null"]},
        "last_n": {"type": ["integer", "null"]},
    }, ["text"])


def text_order_test_schema() -> dict:
    """Bench test: snippet A must precede snippet B in the output."""
    return _test_schema("order", {
        "before": {"type": "string",
                   "description": "Text that must appear first."},
        "after": {"type": "string",
                  "description": "Text that must appear after 'before'."},
    }, ["before", "after"])
