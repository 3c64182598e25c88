"""OCR bench harness: run registered OCR methods over a folder of PDFs (the
port's copy of ``karanta_tpu/bench/convert.py``; its native methods run the
port's engine and pipeline).

Parity surface with reference karanta/bench/convert.py:151-390: for each
method and each page of each <dir>/pdfs/**.pdf, write
<dir>/<method>/<base>_pg<N>_repeat<R>.md. Methods are "name:key=value" specs
resolved from a registry; async with a concurrency cap; --remove_text
re-rasterizes pages to strip the text layer before OCR (so anchor-free paths
are measured honestly).

Usage:
  python -m karanta_tpu_torch.bench.convert karanta_pipeline:server=http://...:30024/v1 \
      --dir bench_data --repeats 1 --parallel 8
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import glob as globmod
import importlib
import logging
import os
import tempfile
from typing import Any, Callable, Optional

logger = logging.getLogger("karanta_tpu_torch.bench")

# method name -> "module:function" (async fn(pdf_path, page_num, **kwargs) -> str|None)
#
# Native methods ship in-repo. The reference's other 13 registry entries
# (karanta/bench/convert.py:367-390) are adapters importing the external
# `olmocr` pip package's runners (marker, mineru, gotocr, chatgpt, ...) —
# third-party OCR engines, deliberately NOT re-implemented here. The same
# names resolve below when `olmocr` is installed and fail with a clear
# message when it is not.
METHOD_REGISTRY: dict[str, str] = {
    "karanta_pipeline": "karanta_tpu_torch.bench.runners.run_karanta:run_karanta_pipeline",
    "karantaocr_pipeline": "karanta_tpu_torch.bench.runners.run_karanta:run_karanta_pipeline",
    "anchor_text": "karanta_tpu_torch.bench.runners.run_karanta:run_anchor_baseline",
    # raw single-call against any OpenAI-compatible endpoint (native
    # equivalent of the reference's `server` adapter, convert.py:389)
    "server": "karanta_tpu_torch.bench.runners.run_karanta:run_server",
    "karanta_server": "karanta_tpu_torch.bench.runners.run_karanta:run_server",
    # in-process engine, no HTTP hop (native equivalent of `transformers`,
    # convert.py:388, but through the production continuous-batching engine)
    "karanta_engine": "karanta_tpu_torch.bench.runners.run_karanta:run_engine",
}

# external-engine adapters, resolved only if the olmocr package is present
# (reference registry names, convert.py:367-390)
OLMOCR_METHODS: dict[str, str] = {
    "olmocr_pipeline": "olmocr.bench.runners.run_olmocr_pipeline:run_olmocr_pipeline",
    "gotocr": "olmocr.bench.runners.run_gotocr:run_gotocr",
    "nanonetsocr": "olmocr.bench.runners.run_nanonetsocr:run_nanonetsocr",
    "nanonetsocr_2": "olmocr.bench.runners.run_nanonetsocr_2:run_server",
    "marker": "olmocr.bench.runners.run_marker:run_marker",
    "mineru": "olmocr.bench.runners.run_mineru:run_mineru",
    "chatgpt": "olmocr.bench.runners.run_chatgpt:run_chatgpt",
    "gemini": "olmocr.bench.runners.run_gemini:run_gemini",
    "mistral": "olmocr.bench.runners.run_mistral:run_mistral",
    "docling": "olmocr.bench.runners.run_docling:run_docling",
    "rolmocr": "olmocr.bench.runners.run_rolmocr:run_rolmocr",
    "paddlepaddle": "olmocr.bench.runners.run_paddlepaddle:run_paddlepaddle",
    "paddlevl": "olmocr.bench.runners.run_paddlevl:run_paddlevl",
    "transformers": "olmocr.bench.runners.run_transformers:run_transformers",
}


def parse_method_arg(spec: str) -> tuple[str, dict[str, Any]]:
    """"name:k1=v1:k2=v2" -> (name, kwargs) with int/float/bool casting
    (reference convert.py:65-95). A segment without '=' is re-joined onto
    the previous value with ':' ONLY when that value plausibly continues
    across a colon (a URL scheme or a host:port), so
    "server:server=http://host:30024/v1" survives while a typo'd extra
    like "karanta_engine:preset=tiny:quantize" raises as the reference
    does for non key=value segments."""
    parts = spec.split(":")
    name = parts[0]
    raw_kwargs: list[list[str]] = []
    for part in parts[1:]:
        if not part:
            continue  # trailing/double colon: ignore, as before the re-join
        if "=" in part:
            key, _, raw = part.partition("=")
            raw_kwargs.append([key, raw])
        elif raw_kwargs and (raw_kwargs[-1][1].lower().endswith(("http", "https"))
                             or part.startswith("//")
                             or part[:1].isdigit()):
            raw_kwargs[-1][1] += ":" + part
        else:
            raise ValueError(
                f"Invalid kwarg segment {part!r} in method spec {spec!r}: "
                "expected key=value")
    kwargs: dict[str, Any] = {}
    for key, raw in raw_kwargs:
        value: Any = raw
        for cast in (int, float):
            try:
                value = cast(raw)
                break
            except ValueError:
                continue
        if raw.lower() in ("true", "false"):
            value = raw.lower() == "true"
        kwargs[key] = value
    return name, kwargs


def resolve_method(name: str) -> Callable:
    spec = METHOD_REGISTRY.get(name) or OLMOCR_METHODS.get(name)
    if spec is None:
        known = sorted(METHOD_REGISTRY) + sorted(OLMOCR_METHODS)
        raise KeyError(f"Unknown method {name!r}; known: {known}")
    module_name, _, fn_name = spec.partition(":")
    try:
        module = importlib.import_module(module_name)
    except ImportError as exc:
        if name in OLMOCR_METHODS:
            raise ImportError(
                f"method {name!r} adapts the external `olmocr` package's "
                f"runner ({module_name}); install olmocr to use it"
            ) from exc
        raise
    return getattr(module, fn_name)


def _strip_text_layer(pdf_path: str, page_num: int) -> str:
    """Rasterize a page and re-wrap as an image-only PDF (--remove_text;
    reference convert.py:200-243). Returns a temp pdf path."""
    from karanta_tpu_torch.pdf.primitives import (
        convert_image_to_pdf_bytes, render_pdf_to_base64png,
    )

    png_b64 = render_pdf_to_base64png(pdf_path, page_num, 1600)
    pdf_bytes = convert_image_to_pdf_bytes(base64.b64decode(png_b64))
    tf = tempfile.NamedTemporaryFile("wb", suffix=".pdf", delete=False)
    tf.write(pdf_bytes)
    tf.close()
    return tf.name


async def process_pdfs(methods: list[tuple[str, dict]], data_dir: str,
                       repeats: int = 1, max_parallel: int = 8,
                       remove_text: bool = False,
                       force: bool = False) -> dict[str, int]:
    from karanta_tpu_torch.pdf.minipdf import PdfDocument

    pdf_paths = sorted(
        globmod.glob(os.path.join(data_dir, "pdfs", "**", "*.pdf"),
                     recursive=True))
    if not pdf_paths:
        raise SystemExit(f"no PDFs under {data_dir}/pdfs")

    semaphore = asyncio.Semaphore(max_parallel)
    counts: dict[str, int] = {}

    async def one(method_name, fn, kwargs, pdf_path, page, repeat):
        base = os.path.splitext(os.path.basename(pdf_path))[0]
        out_dir = os.path.join(data_dir, method_name)
        os.makedirs(out_dir, exist_ok=True)
        out_path = os.path.join(out_dir, f"{base}_pg{page}_repeat{repeat}.md")
        if os.path.exists(out_path) and not force:
            return
        async with semaphore:
            local = pdf_path
            stripped = None
            try:
                if remove_text:
                    stripped = await asyncio.to_thread(
                        _strip_text_layer, pdf_path, page)
                    local = stripped
                text = await fn(local, page, **kwargs)
            except Exception:
                logger.exception("%s failed on %s p%d", method_name,
                                 pdf_path, page)
                text = None
            finally:
                if stripped and os.path.exists(stripped):
                    os.unlink(stripped)
        if text is not None:
            with open(out_path, "w") as f:
                f.write(text)
            counts[method_name] = counts.get(method_name, 0) + 1

    tasks = []
    for method_name, kwargs in methods:
        fn = resolve_method(method_name)
        for pdf_path in pdf_paths:
            try:
                num_pages = PdfDocument.open(pdf_path).num_pages()
            except Exception:
                logger.warning("cannot read %s, skipping", pdf_path)
                continue
            for page in range(1, num_pages + 1):
                for repeat in range(1, repeats + 1):
                    tasks.append(one(method_name, fn, kwargs, pdf_path,
                                     page, repeat))
    await asyncio.gather(*tasks)
    return counts


def main(argv: Optional[list[str]] = None):
    parser = argparse.ArgumentParser(prog="python -m karanta_tpu_torch.bench.convert")
    parser.add_argument("methods", nargs="+",
                        help="method specs: name[:k=v...]")
    parser.add_argument("--dir", required=True)
    parser.add_argument("--repeats", type=int, default=1)
    parser.add_argument("--parallel", type=int, default=8)
    parser.add_argument("--remove_text", action="store_true")
    parser.add_argument("--force", action="store_true")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    methods = [parse_method_arg(m) for m in args.methods]
    counts = asyncio.run(process_pdfs(
        methods, args.dir, args.repeats, args.parallel, args.remove_text,
        args.force))
    print(counts)


if __name__ == "__main__":
    main()
