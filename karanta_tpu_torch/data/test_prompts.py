"""Prompt smoke-tester: run one page through a teacher model or our server.

Reference karanta/data/test_prompts.py:25-225: single-page tests against
OpenAI / Azure / a vLLM-style server, printing the rendered prompt and parsed
response. Providers resolve through llm_clients (mock works offline).

Usage:
  python -m karanta_tpu_torch.data.test_prompts --pdf doc.pdf --page 1 \
      --provider mock
  python -m karanta_tpu_torch.data.test_prompts --pdf doc.pdf --page 1 \
      --provider openai --base-url http://localhost:30024/v1 --model karanta
"""

from __future__ import annotations

import argparse
import json
import logging
from typing import Optional

from karanta_tpu_torch.constants import TARGET_IMAGE_DIM
from karanta_tpu_torch.llm_clients.openai_client import get_client
from karanta_tpu_torch.prompts.schemas import PageAnalysis
from karanta_tpu_torch.prompts.templates import (
    create_vision_message, load_prompt_template, prepare_image_and_text,
)

logger = logging.getLogger(__name__)


def run_prompt_test(pdf_path: str, page: int, provider: str, model: str,
                    prompt_key: str = "olmo_ocr_system_prompt",
                    prompt_path: Optional[str] = None,
                    base_url: Optional[str] = None,
                    structured: bool = False,
                    target_dim: int = TARGET_IMAGE_DIM,
                    max_tokens: int = 2000) -> dict:
    image_b64, anchor = prepare_image_and_text(pdf_path, page, target_dim,
                                               convert_to_grayscale=True)
    template = load_prompt_template(prompt_key, prompt_path)
    messages = create_vision_message(template, anchor, image_b64)

    kwargs = {}
    if base_url:
        kwargs["base_url"] = base_url
        kwargs["api_key"] = kwargs.get("api_key", "-")
        kwargs["check_credentials"] = False
    client = get_client(provider, model, **kwargs)
    (completion,) = client.completion(
        [messages], structured_object=PageAnalysis if structured else None,
        max_tokens=max_tokens, temperature=0.0)

    rendered = messages[0]["content"][0]["text"]
    response = completion.response
    out = {
        "prompt_chars": len(rendered),
        "anchor_chars": len(anchor or ""),
        "model": completion.model,
        "prompt_tokens": completion.prompt_tokens,
        "completion_tokens": completion.completion_tokens,
        "response": (response.model_dump() if hasattr(response, "model_dump")
                     else response),
    }
    print("=" * 50)
    print(rendered[:2000])
    print("=" * 50)
    print(json.dumps(out["response"], ensure_ascii=False, default=str)[:2000])
    return out


def main(argv: Optional[list[str]] = None):
    parser = argparse.ArgumentParser(
        prog="python -m karanta_tpu_torch.data.test_prompts")
    parser.add_argument("--pdf", required=True)
    parser.add_argument("--page", type=int, default=1)
    parser.add_argument("--provider", default="mock",
                        choices=["mock", "openai", "azure", "tgi"])
    parser.add_argument("--model", default="mock")
    parser.add_argument("--base-url", default=None)
    parser.add_argument("--prompt_key", default="olmo_ocr_system_prompt")
    parser.add_argument("--prompt_path", default=None)
    parser.add_argument("--structured", action="store_true")
    parser.add_argument("--target_dim", type=int, default=TARGET_IMAGE_DIM)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    run_prompt_test(args.pdf, args.page, args.provider, args.model,
                    args.prompt_key, args.prompt_path, args.base_url,
                    args.structured, args.target_dim)


if __name__ == "__main__":
    main()
