"""Synthetic scanned-page OCR corpus generator.

Renders short text strings onto white page images, wraps each page as a
scanned (image-only) PDF, and writes ground-truth JSON in the training
layout consumed by ``training/data.LocalDataset`` (``pdfs/<doc>.pdf`` +
``json/<doc>.json`` — reference layout: karanta/training/data.py:55-73,
ground-truth wrapper: karanta/training/pipeline_steps.py:78-87).

Purpose: hermetic end-to-end accuracy validation. The reference validates
model quality only against cloud teacher outputs (SURVEY.md §4); this
module lets the whole native stack close the loop offline —
train -> checkpoint -> serve -> pipeline -> CER — with a corpus whose
ground truth is exact by construction. See scripts/closed_loop_demo.py.

Glyphs are rendered with PIL's built-in bitmap font (no font files), drawn
small and nearest-upscaled so edges stay crisp; ``render_text_image`` is the
one function here that needs PIL. Pages are embedded as Flate RGB.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np

DIGITS = "0123456789"


def render_text_image(text: str,
                      char_px: int = 32,
                      pad_px: int = 16,
                      noise: float = 0.0,
                      seed: int = 0) -> "np.ndarray":
    """Render ``text`` (possibly multi-line) as dark glyphs on a white page.

    Returns an (H, W, 3) uint8 array. ``char_px`` is the upscaled glyph
    cell height (of one line); the default PIL bitmap font is ~6x11 px,
    upscaled with NEAREST so the strokes stay hard-edged.
    """
    from PIL import Image, ImageDraw, ImageFont

    font = ImageFont.load_default()
    n_lines = max(1, text.count("\n") + 1)
    longest = max((len(ln) for ln in text.splitlines()), default=1)
    # measure at native font scale (textbbox handles multiline strings)
    probe = Image.new("L", (8 * max(1, longest) + 8, 24 * n_lines + 8), 255)
    draw = ImageDraw.Draw(probe)
    left, top, right, bottom = draw.textbbox((2, 2), text, font=font)
    w, h = right - left + 4, bottom - top + 4
    canvas = Image.new("L", (w, h), 255)
    ImageDraw.Draw(canvas).text((2 - left + 2, 2 - top + 2), text, fill=20,
                                font=font)
    scale = max(1, char_px // max(1, h // n_lines))
    big = canvas.resize((w * scale, h * scale), Image.Resampling.NEAREST)

    page_w, page_h = big.width + 2 * pad_px, big.height + 2 * pad_px
    page = Image.new("L", (page_w, page_h), 255)
    page.paste(big, (pad_px, pad_px))
    arr = np.asarray(page, dtype=np.uint8)
    if noise > 0:
        rng = np.random.default_rng(seed)
        jitter = rng.normal(0.0, 255.0 * noise, arr.shape)
        arr = np.clip(arr.astype(np.float32) + jitter, 0, 255).astype(np.uint8)
    return np.stack([arr] * 3, axis=-1)


def page_to_pdf_bytes(image: "np.ndarray",
                      text_layer: Optional[str] = None) -> bytes:
    """Wrap a rendered (H, W, 3) uint8 page as a single-page scanned PDF;
    text_layer adds an invisible OCR-style text layer (anchor-extractable)
    under the image.

    The page is embedded losslessly as Flate RGB, where the JAX package
    embeds a JPEG: the port has no JPEG encoder without PIL."""
    from karanta_tpu_torch.ops.png import encode_png_rgb
    from karanta_tpu_torch.pdf.primitives import convert_image_to_pdf_bytes

    return convert_image_to_pdf_bytes(encode_png_rgb(image),
                                      text_layer=text_layer)


def pages_to_pdf_bytes(images: Sequence["np.ndarray"]) -> bytes:
    """A scanned PDF of several pages, one (H, W, 3) uint8 image each,
    embedded as Flate RGB and drawn over its page's media box (no text
    layer)."""
    import zlib

    objects = [b"<< /Type /Catalog /Pages 2 0 R >>", b""]
    kids = []
    for px in images:
        h, w = px.shape[:2]
        payload = zlib.compress(np.ascontiguousarray(px, np.uint8).tobytes())
        num = len(objects) + 1
        kids.append(f"{num} 0 R")
        content = f"q {w} 0 0 {h} 0 0 cm /Im0 Do Q".encode()
        objects += [
            (f"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 {w} {h}] "
             f"/Resources << /XObject << /Im0 {num + 1} 0 R >> >> "
             f"/Contents {num + 2} 0 R >>").encode(),
            (f"<< /Type /XObject /Subtype /Image /Width {w} /Height {h} "
             f"/ColorSpace /DeviceRGB /BitsPerComponent 8 /Filter "
             f"/FlateDecode /Length {len(payload)} >>").encode()
            + b"\nstream\n" + payload + b"\nendstream",
            f"<< /Length {len(content)} >>".encode() + b"\nstream\n"
            + content + b"\nendstream"]
    objects[1] = (f"<< /Type /Pages /Kids [{' '.join(kids)}] "
                  f"/Count {len(kids)} >>").encode()
    out = bytearray(b"%PDF-1.4\n")
    offsets = []
    for i, body in enumerate(objects, start=1):
        offsets.append(len(out))
        out += f"{i} 0 obj\n".encode() + body + b"\nendobj\n"
    xref = len(out)
    out += f"xref\n0 {len(objects) + 1}\n0000000000 65535 f \n".encode()
    out += b"".join(f"{off:010d} 00000 n \n".encode() for off in offsets)
    out += (f"trailer\n<< /Size {len(objects) + 1} /Root 1 0 R >>\n"
            f"startxref\n{xref}\n%%EOF\n").encode()
    return bytes(out)


def ground_truth_json(text: str, language: str = "en") -> str:
    """Ground-truth sidecar in the trainer's FetchPageData wrapper format."""
    page = {
        "primary_language": language,
        "is_rotation_valid": True,
        "rotation_correction": 0,
        "is_table": False,
        "is_diagram": False,
        "natural_text": text,
    }
    return json.dumps({"result": {"text": json.dumps([page])}})


def random_texts(n: int, n_chars: int = 4, charset: str = DIGITS,
                 seed: int = 0, words: Optional[int] = None,
                 lines: int = 1, vocab: Optional[int] = None) -> list[str]:
    """n random strings; with ``words`` set, that many space-separated
    groups of n_chars each; ``lines`` newline-joined lines of those.
    ``vocab`` draws words from a fixed vocab of that size instead of fresh
    random strings (prose-like repetition — the n-gram drafter's food)."""
    rng = np.random.default_rng(seed)

    def word():
        return "".join(charset[i] for i in rng.integers(0, len(charset),
                                                        n_chars))

    lexicon = [word() for _ in range(vocab)] if vocab else None
    out = []
    for _ in range(n):
        page_lines = []
        for _ in range(max(1, lines)):
            groups = words or 1
            parts = [lexicon[rng.integers(0, len(lexicon))] if lexicon
                     else word() for _ in range(groups)]
            page_lines.append(" ".join(parts))
        out.append("\n".join(page_lines))
    return out


def make_corpus(root: str,
                n_pages: int,
                n_chars: int = 4,
                charset: str = DIGITS,
                seed: int = 0,
                char_px: int = 32,
                noise: float = 0.0,
                texts: Optional[Sequence[str]] = None,
                text_layer: bool = False) -> list[tuple[str, str]]:
    """Write a pdfs/ + json/ corpus under ``root``.

    text_layer embeds each page's ground truth as an invisible PDF text
    layer (an OCRed scan), so the pipeline's anchor extraction feeds the
    page text into the prompt — the prompt-lookup setting where n-gram
    speculative decoding shines (the transcript largely reproduces the
    anchor).

    Returns [(doc_name, ground_truth_text), ...] sorted by doc name.
    """
    pdf_dir = os.path.join(root, "pdfs")
    json_dir = os.path.join(root, "json")
    os.makedirs(pdf_dir, exist_ok=True)
    os.makedirs(json_dir, exist_ok=True)
    if texts is None:
        texts = random_texts(n_pages, n_chars, charset, seed)
    manifest = []
    for i, text in enumerate(texts):
        name = f"doc{i:04d}"
        img = render_text_image(text, char_px=char_px, noise=noise,
                                seed=seed + i)
        with open(os.path.join(pdf_dir, f"{name}.pdf"), "wb") as f:
            f.write(page_to_pdf_bytes(
                img, text_layer=text if text_layer else None))
        with open(os.path.join(json_dir, f"{name}.json"), "w",
                  encoding="utf-8") as f:
            f.write(ground_truth_json(text))
        manifest.append((name, text))
    return manifest
