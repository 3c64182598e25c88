"""Single-page OCR harness: run one page through the engine directly
(no server), for checkpoint smoke-testing (the port's copy of
``karanta_tpu/inference/single_page.py``, with ``--device``).

Reference karanta/training/test_trained_model.py:15-158: load model +
processor, build the message (render + anchor + prompt), greedy generate,
decode. Here the engine does all of that in-process.

Usage:
  python -m karanta_tpu_torch.inference.single_page --pdf doc.pdf --page 1 \
      --model-path /ckpts/qwen2.5-vl-3b [--preset qwen2.5-vl-3b] \
      [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
from typing import Optional

logger = logging.getLogger(__name__)


def build_message(pdf_path: str, page: int, target_dim: int,
                  prompt_key: str, prompt_path: Optional[str]) -> list[dict]:
    """Render + anchor + prompt -> OpenAI message list
    (reference test_trained_model.py:45-73)."""
    from karanta_tpu_torch.prompts.templates import (
        create_vision_message, load_prompt_template, prepare_image_and_text,
    )

    image_b64, anchor = prepare_image_and_text(pdf_path, page, target_dim,
                                               convert_to_grayscale=True)
    template = load_prompt_template(prompt_key, prompt_path)
    return create_vision_message(template, anchor, image_b64)


def run_inference(engine, messages: list[dict], max_tokens: int = 4000,
                  temperature: float = 0.0) -> dict:
    """(reference test_trained_model.py:76-99)"""
    from karanta_tpu_torch.inference.engine import GenRequest

    (result,) = engine.generate([GenRequest(
        messages=messages, max_tokens=max_tokens, temperature=temperature,
        request_id="single-page")])
    return {
        "text": result.text,
        "finish_reason": result.finish_reason,
        "prompt_tokens": result.prompt_tokens,
        "completion_tokens": result.completion_tokens,
        "latency_s": result.latency_s,
    }


def main(argv: Optional[list[str]] = None):
    from karanta_tpu_torch.inference.server import build_engine_from_args

    parser = argparse.ArgumentParser(
        prog="python -m karanta_tpu_torch.inference.single_page")
    parser.add_argument("--pdf", required=True)
    parser.add_argument("--page", type=int, default=1)
    parser.add_argument("--model-path", default=None)
    parser.add_argument("--native-checkpoint", dest="native_checkpoint",
                        default=None,
                        help="run a native-trainer checkpoint dir (the "
                             "reference's test_trained_model use case on "
                             "a fresh fine-tune)")
    parser.add_argument("--tokenizer-path", dest="tokenizer_path",
                        default=None)
    parser.add_argument("--preset", default=None)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) or "
                             "cpu, which runs the kernels' plain versions")
    parser.add_argument("--max-batch-size", type=int, default=1)
    parser.add_argument("--max-model-len", type=int, default=8192)
    parser.add_argument("--decode-chunk", type=int, default=32)
    parser.add_argument("--max-tokens", type=int, default=4000)
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--target_dim", type=int, default=1288)
    parser.add_argument("--prompt_key", default="olmo_ocr_system_prompt")
    parser.add_argument("--prompt_path", default=None)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    engine, name = build_engine_from_args(args)
    messages = build_message(args.pdf, args.page, args.target_dim,
                             args.prompt_key, args.prompt_path)
    result = run_inference(engine, messages, args.max_tokens, args.temperature)
    result["model"] = name
    print(json.dumps(result, ensure_ascii=False, indent=2))


if __name__ == "__main__":
    main()
