"""Bench runners: the karanta pipeline method + anchor-text baseline (the
port's copy of ``karanta_tpu/bench/runners/run_karanta.py``).

Parity with reference karanta/bench/runners/run_karanta_pipeline.py:28-115:
adapts pipeline.process_page into the bench method signature
async fn(pdf_path, page_num, **kwargs) -> markdown text | None.
The in-process ``karanta_engine`` method builds the port's engine on the
card, or on the CPU with ``device=cpu``.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Optional

from karanta_tpu_torch.constants import PIPELINE_IMAGE_DIM


@dataclass
class RunnerArgs:
    """Mirror of the pipeline args the runner needs
    (reference run_karanta_pipeline.py:28-43)."""

    model: str = "karanta-ocr"
    server: str = "http://localhost:30024/v1"
    target_longest_image_dim: int = PIPELINE_IMAGE_DIM
    max_page_retries: int = 8
    max_page_error_rate: float = 0.004
    prompt_key: str = "olmo_ocr_system_prompt"
    prompt_path: Optional[str] = None
    guided_decoding: bool = False
    api_key: Optional[str] = None
    workspace: str = field(default="/tmp/karanta_bench_ws")


_server_check_lock = asyncio.Lock()
_server_checked: set[str] = set()


async def run_karanta_pipeline(pdf_path: str, page_num: int,
                               **kwargs) -> Optional[str]:
    """OCR one page through the pipeline's process_page against a server."""
    from karanta_tpu_torch.pipeline.runner import process_page, server_ready

    args = RunnerArgs(**{k: v for k, v in kwargs.items()
                         if k in RunnerArgs.__dataclass_fields__})

    async with _server_check_lock:
        if args.server not in _server_checked:
            if not await server_ready(args.server, attempts=30):
                raise RuntimeError(f"server {args.server} not ready")
            _server_checked.add(args.server)

    result = await process_page(args, 0, pdf_path, pdf_path, page_num)
    if result.is_fallback:
        return None
    return result.response.natural_text


async def run_anchor_baseline(pdf_path: str, page_num: int,
                              **kwargs) -> Optional[str]:
    """No-model baseline: the PDF's own text layer, linearized."""
    from karanta_tpu_torch.pdf.anchor import get_anchor_text

    text = await asyncio.to_thread(
        get_anchor_text, pdf_path, page_num, "pdftotext")
    return text or None


async def run_server(pdf_path: str, page_num: int,
                     server: str = "http://localhost:30024/v1",
                     model: str = "karanta-ocr",
                     temperature: float = 0.0,
                     target_longest_image_dim: int = PIPELINE_IMAGE_DIM,
                     prompt_key: str = "olmo_ocr_system_prompt",
                     prompt_path: Optional[str] = None,
                     api_key: Optional[str] = None,
                     **kwargs) -> Optional[str]:
    """Raw single-call method against ANY OpenAI-compatible endpoint (vLLM,
    karanta-tpu server, cloud) — the native equivalent of the reference's
    `server` registry entry (olmocr run_server adapter, reference
    convert.py:389). No retry ladder or fallback machinery: one request,
    parsed leniently, so the bench measures the serving stack alone."""
    from karanta_tpu_torch.pipeline.http import apost
    from karanta_tpu_torch.pipeline.runner import build_page_query, parse_model_content

    query = await build_page_query(
        pdf_path, page_num, target_longest_image_dim,
        model_name=model, prompt_key=prompt_key, prompt_path=prompt_path)
    query["temperature"] = temperature
    status, body = await apost(f"{server.rstrip('/')}/chat/completions",
                               json_data=query, api_key=api_key)
    if status != 200:
        raise RuntimeError(f"server returned {status}: {body[:200]!r}")
    import json as _json

    data = _json.loads(body)
    content = data["choices"][0]["message"]["content"]
    try:
        parsed = parse_model_content(content)
        return parsed.pages[0].natural_text if parsed.pages else None
    except Exception:
        return content or None


_ENGINE_CACHE: dict = {}
_engine_lock = asyncio.Lock()
# Engine.generate mutates shared slot/cache state and is NOT thread-safe:
# all bench calls into one engine serialize here. (Pages still amortize
# across Engine.generate's own continuous batching when passed together;
# the bench harness calls per page, so this is correctness, not perf.)
_generate_lock = asyncio.Lock()


async def run_engine(pdf_path: str, page_num: int,
                     preset: str = "tiny",
                     model_path: Optional[str] = None,
                     native_checkpoint: Optional[str] = None,
                     max_model_len: int = 4096,
                     max_batch_size: int = 4,
                     quantize: Optional[str] = None,
                     device: Optional[str] = None,
                     target_longest_image_dim: int = PIPELINE_IMAGE_DIM,
                     prompt_key: str = "olmo_ocr_system_prompt",
                     prompt_path: Optional[str] = None,
                     **kwargs) -> Optional[str]:
    """Serverless method: drive the continuous-batching engine in-process
    (no HTTP hop). The engine is built once per bench run and cached; pages
    fan into Engine.generate. Mirrors the reference's `transformers` direct
    -model registry entry (convert.py:388) but through the production
    engine, so paged KV / quantization paths are what gets measured.
    ``device`` picks the card (the default) or ``cpu``."""
    from karanta_tpu_torch.inference.engine import GenRequest
    from karanta_tpu_torch.pipeline.runner import build_page_query, parse_model_content

    key = (preset, model_path, native_checkpoint, max_model_len,
           max_batch_size, quantize, device)
    async with _engine_lock:
        if key not in _ENGINE_CACHE:
            import argparse

            from karanta_tpu_torch.inference.server import build_engine_from_args

            ns = argparse.Namespace(
                model_path=model_path, native_checkpoint=native_checkpoint,
                tokenizer_path=model_path, preset=preset,
                max_batch_size=max_batch_size, max_model_len=max_model_len,
                decode_chunk=16, quantize=quantize, kv_quantize=None,
                act_quant=None, vision_quant=None, prefix_cache=False,
                speculative_ngram=0, tensor_parallel_size=1,
                data_parallel_size=1, device=device)
            # a model load takes seconds to minutes: keep the event loop
            # (and any concurrent HTTP methods) alive
            _ENGINE_CACHE[key] = (await asyncio.to_thread(
                build_engine_from_args, ns))[0]
    engine = _ENGINE_CACHE[key]

    query = await build_page_query(
        pdf_path, page_num, target_longest_image_dim,
        prompt_key=prompt_key, prompt_path=prompt_path)
    request = GenRequest(messages=query["messages"],
                         max_tokens=query["max_tokens"], temperature=0.0)
    async with _generate_lock:
        result = (await asyncio.to_thread(engine.generate, [request]))[0]
    try:
        parsed = parse_model_content(result.text)
        return parsed.pages[0].natural_text if parsed.pages else None
    except Exception:
        return result.text or None
