"""Prompt loading + vision-message construction.

Parity surface with reference karanta/data/utils.py:254-297
(load_prompt_template / create_vision_message) and :228-251
(prepare_image_and_text): prompt templates live in YAML keyed by name,
rendered with jinja2 ({{base_text}} anchor slot), and wrapped in
OpenAI-format vision messages.
"""

from __future__ import annotations

import base64
import io
import os
from typing import Optional

import numpy as np
import yaml
from jinja2 import Template

from karanta_tpu_torch.constants import PROMPT_PATH, TARGET_IMAGE_DIM
from karanta_tpu_torch.pdf.anchor import get_anchor_text
from karanta_tpu_torch.pdf.primitives import render_pdf_to_base64png


def load_prompt_template(prompt_key: str,
                         prompt_path: Optional[str] = None) -> Template:
    if not prompt_path:
        prompt_path = PROMPT_PATH
    elif not os.path.exists(prompt_path):
        # never silently substitute the default prompts for an explicit
        # path: the prompt IS the model contract (checkpoints are tuned to
        # exact wording), so a typo'd/CWD-relative path must fail loudly
        raise FileNotFoundError(f"prompt file not found: {prompt_path!r}")
    with open(prompt_path, "r") as stream:
        templates = yaml.safe_load(stream)
    if prompt_key not in templates:
        raise KeyError(
            f"Prompt {prompt_key!r} not in {prompt_path} "
            f"(available: {sorted(templates)})")
    return Template(templates[prompt_key])


def create_vision_message(prompt_template: Template,
                          anchor_text: Optional[str],
                          image_base64: str) -> list[dict]:
    """OpenAI chat message: text part + data-URL image part."""
    if anchor_text:
        rendered = prompt_template.render({"base_text": anchor_text})
    else:
        rendered = prompt_template.render()
    # the renderer's scanned-page fast path ships the embedded JPEG bytes
    # untouched; label the data URL to match the bytes ("/9j/" is base64 of
    # the JPEG SOI marker) for servers that trust the MIME type
    mime = "image/jpeg" if image_base64.startswith("/9j/") else "image/png"
    return [{
        "role": "user",
        "content": [
            {"type": "text", "text": rendered},
            {"type": "image_url",
             "image_url": {"url": f"data:{mime};base64,{image_base64}"}},
        ],
    }]


def base64_to_grayscale(image_base64: str) -> str:
    """Re-encode a base64 PNG as 8-bit grayscale (reference
    karanta/data/utils.py:186-225 — shrinks the payload and normalizes
    scanned-page color noise).

    PIL's "L" conversion, without PIL: (19595 R + 38470 G + 7471 B
    + 0x8000) >> 16, encoded by ``ops/png.py``. A JPEG (the renderer's
    passthrough) is decoded by PIL, which must then be installed."""
    from karanta_tpu_torch.ops.png import decode_png, encode_png_gray

    raw = base64.b64decode(image_base64)
    if raw[:8] == b"\x89PNG\r\n\x1a\n":
        px = decode_png(raw)
    else:
        from karanta_tpu_torch.pdf.primitives import _pil_image

        Image = _pil_image("converting a non-PNG page image to grayscale")
        with Image.open(io.BytesIO(raw)) as img:
            px = np.asarray(img.convert("L"))
    if px.ndim == 3:
        rgb = px.astype(np.uint32)
        px = ((19595 * rgb[..., 0] + 38470 * rgb[..., 1] + 7471 * rgb[..., 2]
               + 0x8000) >> 16).astype(np.uint8)
    return base64.b64encode(encode_png_gray(px)).decode("utf-8")


def prepare_image_and_text(local_pdf_path: str, page: int,
                           target_longest_image_dim: int = TARGET_IMAGE_DIM,
                           target_anchor_text_len: int = 4000,
                           convert_to_grayscale: bool = False,
                           ) -> tuple[str, str]:
    """(image_base64, anchor_text) for one page."""
    image_base64 = render_pdf_to_base64png(
        local_pdf_path, page, target_longest_image_dim=target_longest_image_dim)
    if convert_to_grayscale:
        image_base64 = base64_to_grayscale(image_base64)
    anchor_text = get_anchor_text(local_pdf_path, page, "pdfreport",
                                  target_anchor_text_len)
    return image_base64, anchor_text
