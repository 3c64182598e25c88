"""Split PDFs into per-page files (the port's copy of
``karanta_tpu/data/split_pdf.py``; reference karanta/data/split_pdf.py:17-44):
{name}_page_{n}.pdf via a process pool, using the native page extractor."""

from __future__ import annotations

import argparse
import glob as globmod
import logging
import os
import multiprocessing
from typing import Optional

logger = logging.getLogger(__name__)


def split_one(task: tuple[str, str]) -> int:
    pdf_path, out_dir = task
    from karanta_tpu_torch.pdf.minipdf import PdfDocument
    from karanta_tpu_torch.pdf.writer import extract_page

    base = os.path.splitext(os.path.basename(pdf_path))[0]
    try:
        doc = PdfDocument.open(pdf_path)
        n = doc.num_pages()
    except Exception:
        logger.exception("cannot open %s", pdf_path)
        return 0
    written = 0
    for i in range(n):
        out_path = os.path.join(out_dir, f"{base}_page_{i + 1}.pdf")
        if os.path.exists(out_path):
            written += 1
            continue
        try:
            with open(out_path, "wb") as f:
                f.write(extract_page(doc, i))
            written += 1
        except Exception:
            logger.exception("failed to extract %s p%d", pdf_path, i + 1)
    return written


def split_pdfs(input_dir: str, output_dir: str,
               workers: Optional[int] = None) -> int:
    os.makedirs(output_dir, exist_ok=True)
    pdfs = sorted(globmod.glob(os.path.join(input_dir, "**", "*.pdf"),
                               recursive=True))
    tasks = [(p, output_dir) for p in pdfs]
    if not tasks:
        return 0
    # spawned workers: the caller may hold threads or a CUDA context
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(workers or max(1, (os.cpu_count() or 4) - 1)) as pool:
        return sum(pool.map(split_one, tasks))


def main(argv: Optional[list[str]] = None):
    parser = argparse.ArgumentParser(
        prog="python -m karanta_tpu_torch.data.split_pdf")
    parser.add_argument("--input_dir", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--workers", type=int, default=None)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    print(f"split {split_pdfs(args.input_dir, args.output_dir, args.workers)}")


if __name__ == "__main__":
    main()
