"""Batch-request builder for teacher-model ground-truth generation.

Reference karanta/data/create_batch_data_prompts.py:45-212: turns sampled PDF
pages into OpenAI-batch-format request files (custom_id + /v1/chat/completions
body, logprobs top-5, multipage response schema) or vLLM-flavored request
lines, rotating output files every `requests_per_file`.
"""

from __future__ import annotations

import argparse
import glob as globmod
import json
import logging
import os
from typing import Optional

from karanta_tpu_torch.constants import TARGET_IMAGE_DIM
from karanta_tpu_torch.pdf.minipdf import PdfDocument
from karanta_tpu_torch.prompts.schemas import openai_response_format_schema_multipages
from karanta_tpu_torch.prompts.templates import (
    create_vision_message, load_prompt_template, prepare_image_and_text,
)
from karanta_tpu_torch.utils.timing import timeit

logger = logging.getLogger(__name__)


@timeit
def build_openai_batch_request(pdf_path: str, page: int, model: str,
                               prompt_key: str = "page_analysis_prompt",
                               prompt_path: Optional[str] = None,
                               target_dim: int = TARGET_IMAGE_DIM,
                               max_tokens: int = 8192) -> dict:
    """One OpenAI batch-API line (reference :45-80)."""
    image_b64, anchor = prepare_image_and_text(pdf_path, page, target_dim,
                                               convert_to_grayscale=True)
    template = load_prompt_template(prompt_key, prompt_path)
    messages = create_vision_message(template, anchor, image_b64)
    base = os.path.splitext(os.path.basename(pdf_path))[0]
    return {
        "custom_id": f"{base}_pg{page}",
        "method": "POST",
        "url": "/v1/chat/completions",
        "body": {
            "model": model,
            "messages": messages,
            "max_tokens": max_tokens,
            "temperature": 0.1,
            "logprobs": True,
            "top_logprobs": 5,
            "response_format": openai_response_format_schema_multipages(),
        },
    }


@timeit
def build_vllm_request(pdf_path: str, page: int, model: str,
                       prompt_key: str = "olmo_ocr_system_prompt",
                       prompt_path: Optional[str] = None,
                       target_dim: int = TARGET_IMAGE_DIM,
                       max_tokens: int = 4000) -> dict:
    """One request line for our server / vLLM bulk path (reference :84-120)."""
    image_b64, anchor = prepare_image_and_text(pdf_path, page, target_dim,
                                               convert_to_grayscale=True)
    template = load_prompt_template(prompt_key, prompt_path)
    base = os.path.splitext(os.path.basename(pdf_path))[0]
    return {
        "custom_id": f"{base}_pg{page}",
        "body": {
            "model": model,
            "messages": create_vision_message(template, anchor, image_b64),
            "max_tokens": max_tokens,
            "temperature": 0.0,
        },
    }


def build_requests(pdf_dir: str, output_dir: str, model: str,
                   flavor: str = "openai", pages_per_pdf: int = 2,
                   requests_per_file: int = 1000,
                   prompt_key: Optional[str] = None,
                   target_dim: int = TARGET_IMAGE_DIM) -> int:
    """Sample pages per PDF, write rotating JSONL request files
    (reference :123-212)."""
    import numpy as np

    os.makedirs(output_dir, exist_ok=True)
    builder = (build_openai_batch_request if flavor == "openai"
               else build_vllm_request)
    kwargs = {}
    if prompt_key:
        kwargs["prompt_key"] = prompt_key

    rng = np.random.default_rng(0)
    count = 0
    file_index = 0
    handle = None
    try:
        for pdf_path in sorted(globmod.glob(
                os.path.join(pdf_dir, "**", "*.pdf"), recursive=True)):
            try:
                n_pages = PdfDocument.open(pdf_path).num_pages()
            except Exception:
                logger.exception("cannot read %s", pdf_path)
                continue
            chosen = rng.permutation(n_pages)[:pages_per_pdf] + 1
            for page in sorted(int(p) for p in chosen):
                try:
                    request = builder(pdf_path, page, model,
                                      target_dim=target_dim, **kwargs)
                except Exception:
                    logger.exception("failed building %s p%d", pdf_path, page)
                    continue
                if handle is None or count % requests_per_file == 0:
                    if handle:
                        handle.close()
                    handle = open(os.path.join(
                        output_dir, f"batch_requests_{file_index:04d}.jsonl"),
                        "w")
                    file_index += 1
                handle.write(json.dumps(request, ensure_ascii=False) + "\n")
                count += 1
    finally:
        if handle:
            handle.close()
    return count


def main(argv: Optional[list[str]] = None):
    parser = argparse.ArgumentParser(
        prog="python -m karanta_tpu_torch.data.create_batch_data_prompts")
    parser.add_argument("--pdf_dir", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--model", default="gpt-4o")
    parser.add_argument("--flavor", choices=["openai", "vllm"],
                        default="openai")
    parser.add_argument("--pages_per_pdf", type=int, default=2)
    parser.add_argument("--requests_per_file", type=int, default=1000)
    parser.add_argument("--prompt_key", default=None)
    parser.add_argument("--target_dim", type=int, default=TARGET_IMAGE_DIM)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    n = build_requests(args.pdf_dir, args.output_dir, args.model, args.flavor,
                       args.pages_per_pdf, args.requests_per_file,
                       args.prompt_key, args.target_dim)
    print(json.dumps({"requests": n}))


if __name__ == "__main__":
    main()
