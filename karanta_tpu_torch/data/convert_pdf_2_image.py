"""Batch PDF -> image converter CLI (the port's copy of
``karanta_tpu/data/convert_pdf_2_image.py``; reference karanta/data/
convert_pdf_2_image.py:23-193): renders every page of every PDF in a
directory to {base}_pg_{i}.{fmt} using a process pool, and the inverse
image -> PDF direction."""

from __future__ import annotations

import argparse
import base64
import glob as globmod
import logging
import os
import multiprocessing
from typing import Optional

logger = logging.getLogger(__name__)


def convert_one_pdf(task: tuple[str, str, str, int]) -> int:
    pdf_path, out_dir, fmt, target_dim = task
    import io

    from PIL import Image

    from karanta_tpu_torch.pdf.minipdf import PdfDocument
    from karanta_tpu_torch.pdf.primitives import render_pdf_to_base64png

    base = os.path.splitext(os.path.basename(pdf_path))[0]
    try:
        num_pages = PdfDocument.open(pdf_path).num_pages()
    except Exception:
        logger.exception("cannot read %s", pdf_path)
        return 0
    written = 0
    for page in range(1, num_pages + 1):
        out_path = os.path.join(out_dir, f"{base}_pg_{page}.{fmt}")
        if os.path.exists(out_path):
            written += 1
            continue
        try:
            b64 = render_pdf_to_base64png(pdf_path, page, target_dim)
            img = Image.open(io.BytesIO(base64.b64decode(b64)))
            img.convert("RGB").save(out_path)
            written += 1
        except Exception:
            logger.exception("failed %s p%d", pdf_path, page)
    return written


def convert_pdfs_to_images(input_dir: str, output_dir: str,
                           fmt: str = "png", target_dim: int = 2048,
                           workers: Optional[int] = None) -> int:
    os.makedirs(output_dir, exist_ok=True)
    pdfs = sorted(globmod.glob(os.path.join(input_dir, "**", "*.pdf"),
                               recursive=True))
    tasks = [(p, output_dir, fmt, target_dim) for p in pdfs]
    if not tasks:
        return 0
    # spawned workers: the caller may hold threads or a CUDA context
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(workers or max(1, (os.cpu_count() or 4) - 1)) as pool:
        counts = pool.map(convert_one_pdf, tasks)
    return sum(counts)


def image_to_pdf(image_path: str, output_path: str) -> None:
    """(reference :86-131)"""
    from karanta_tpu_torch.pdf.primitives import convert_image_to_pdf_bytes

    with open(image_path, "rb") as f:
        pdf = convert_image_to_pdf_bytes(f.read())
    with open(output_path, "wb") as f:
        f.write(pdf)


def convert_images_to_pdfs(input_dir: str, output_dir: str) -> int:
    os.makedirs(output_dir, exist_ok=True)
    count = 0
    for ext in ("png", "jpg", "jpeg"):
        for path in globmod.glob(os.path.join(input_dir, f"*.{ext}")):
            base = os.path.splitext(os.path.basename(path))[0]
            image_to_pdf(path, os.path.join(output_dir, f"{base}.pdf"))
            count += 1
    return count


def main(argv: Optional[list[str]] = None):
    parser = argparse.ArgumentParser(
        prog="python -m karanta_tpu_torch.data.convert_pdf_2_image")
    parser.add_argument("--input_dir", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--format", default="png", choices=["png", "jpg"])
    parser.add_argument("--target_dim", type=int, default=2048)
    parser.add_argument("--workers", type=int, default=None)
    parser.add_argument("--reverse", action="store_true",
                        help="images -> PDFs instead")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.reverse:
        n = convert_images_to_pdfs(args.input_dir, args.output_dir)
    else:
        n = convert_pdfs_to_images(args.input_dir, args.output_dir,
                                   args.format, args.target_dim, args.workers)
    print(f"converted {n}")


if __name__ == "__main__":
    main()
