"""Startup environment checks for the pipeline.

The port's equivalent of the reference's preflight gates — poppler presence
(/root/reference/karanta/pipeline.py:1263 check_poppler_version) and GPU
availability when serving locally (:1342 check_torch_gpu_available). Failing
fast at startup beats a stack trace mid-run on page 40,000.
"""

from __future__ import annotations

import logging
import os

logger = logging.getLogger(__name__)

# a one-page blank PDF, enough to exercise parse + render end to end
_PROBE_PDF = (
    b"%PDF-1.4\n"
    b"1 0 obj << /Type /Catalog /Pages 2 0 R >> endobj\n"
    b"2 0 obj << /Type /Pages /Kids [3 0 R] /Count 1 >> endobj\n"
    b"3 0 obj << /Type /Page /Parent 2 0 R /MediaBox [0 0 72 72] >> endobj\n"
    b"trailer << /Root 1 0 R >>\n"
)


def check_rasterizer() -> None:
    """Verify the PDF parse+render path works on a probe document.

    Raises RuntimeError with a diagnosis if rendering is broken; the
    reference's analogue validates the poppler install before starting.
    """
    import tempfile

    from karanta_tpu_torch.pdf.primitives import render_pdf_to_base64png

    with tempfile.NamedTemporaryFile("wb", suffix=".pdf", delete=False) as tf:
        tf.write(_PROBE_PDF)
        path = tf.name
    try:
        b64 = render_pdf_to_base64png(path, 1, target_longest_image_dim=64)
        if not b64:
            raise RuntimeError("rasterizer returned an empty image")
    except Exception as exc:
        raise RuntimeError(
            "PDF rasterizer preflight failed — cannot render documents "
            f"({exc}). Install poppler or fix the native render path."
        ) from exc
    finally:
        os.unlink(path)
    logger.info("preflight: rasterizer ok")


def check_device(require_accelerator: bool = True) -> None:
    """Verify a CUDA card is visible for local serving.

    Equivalent of the reference's check_torch_gpu_available (pipeline.py:1342),
    applied only when the pipeline spawns its own inference server. It counts
    the cards and allocates nothing on them. Set KARANTA_ALLOW_CPU=1 to
    accept a host without one (tests, dry runs).
    """
    import torch

    n = torch.cuda.device_count()
    if n:
        logger.info("preflight: %d CUDA device(s) ok", n)
        return
    if require_accelerator and os.environ.get("KARANTA_ALLOW_CPU") != "1":
        raise RuntimeError(
            "local inference serving requires a CUDA card but none is "
            "visible (set KARANTA_ALLOW_CPU=1 to override)")
    logger.info("preflight: no CUDA device; running without a card")
