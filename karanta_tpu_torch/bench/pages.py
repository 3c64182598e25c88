"""Synthetic page images for throughput runs (the port's copy of
``bench.py make_page_png``, encoded without PIL)."""

from __future__ import annotations

import base64

import numpy as np

from karanta_tpu_torch.ops.png import encode_png_rgb

# the engine bench's prompt (bench.py page_messages)
PAGE_PROMPT = ("Return the plain text representation of this document as if "
               "you were reading it naturally.\n")


def make_page_png(height: int = 1288, width: int = 994, seed: int = 0) -> str:
    """Base64 PNG of a text-like page at pipeline render size (1288 px
    longest side). Distinct seeds give distinct pages."""
    rng = np.random.default_rng(seed)
    page = np.full((height, width), 235, np.uint8)
    # rows of dark "text" lines
    for y in range(60, height - 60, 22):
        line = rng.integers(0, 2, size=(12, width - 120)) * rng.integers(
            100, 200, size=(12, width - 120))
        page[y:y + 12, 60:width - 60] = np.minimum(
            page[y:y + 12, 60:width - 60], 255 - line).astype(np.uint8)
    png = encode_png_rgb(np.stack([page] * 3, axis=-1))
    return base64.b64encode(png).decode()


def page_messages(png_b64: str, prompt: str = PAGE_PROMPT) -> list[dict]:
    """One OpenAI-style user message: the prompt text, then the page."""
    return [{"role": "user", "content": [
        {"type": "text", "text": prompt},
        {"type": "image_url",
         "image_url": {"url": f"data:image/png;base64,{png_b64}"}}]}]
