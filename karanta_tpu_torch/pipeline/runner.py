"""Scale-out OCR pipeline orchestrator.

Re-implementation of the reference's control plane (karanta/pipeline.py) with
the same public stage API — build_page_query, process_page, process_pdf,
worker, main — the same retry/temperature ladder, rotation self-correction,
fallback pages, failure budget, Dolma JSONL + markdown outputs, and --stats.
The engine behind the HTTP boundary is the port's CUDA server
(karanta_tpu_torch.inference.server) instead of vLLM.

CLI:  python -m karanta_tpu_torch.pipeline <workspace> --pdfs <glob|files> \
          [--server http://host:port/v1 | --serve-inproc --model <path>]
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import glob as globmod
import json
import logging
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from karanta_tpu_torch.constants import (
    MAX_OUTPUT_TOKENS_PER_PAGE, MODEL_MAX_CONTEXT, PIPELINE_IMAGE_DIM,
    TEMPERATURE_BY_ATTEMPT,
)
from karanta_tpu_torch.pdf.anchor import get_anchor_text
from karanta_tpu_torch.pdf.minipdf import PdfDocument
from karanta_tpu_torch.pdf.primitives import (
    convert_image_to_pdf_bytes, is_jpeg, is_pdf, is_png,
)
from karanta_tpu_torch.pipeline.dolma import (
    ListPageResponse, PageResponse, PageResult, build_dolma_document,
)
from karanta_tpu_torch.pipeline.http import aget, apost
from karanta_tpu_torch.pipeline.work_queue import LocalBackend, WorkQueue, make_backend
from karanta_tpu_torch.prompts.templates import (
    create_vision_message, load_prompt_template, prepare_image_and_text,
)
from karanta_tpu_torch.utils.metrics import MetricsKeeper, WorkerTracker

logger = logging.getLogger("karanta_tpu_torch.pipeline")

# rotation-correction regex for guided decoding (the YAML-ish front matter the
# olmOCR-2 family emits; reference pipeline.py:304-307)
GUIDED_REGEX = (
    r"---\nprimary_language: (?:[a-z]{2}|null)\n"
    r"is_rotation_valid: (?:True|False|true|false)\n"
    r"rotation_correction: (?:0|90|180|270)\n"
    r"is_table: (?:True|False|true|false)\n"
    r"is_diagram: (?:True|False|true|false)\n(?:---|---\n[\s\S]+)"
)

metrics = MetricsKeeper(window=300)
tracker = WorkerTracker()

# anchor length above which a page votes for speculative decoding (its
# completion will largely repeat the text layer, so n-gram drafts accept)
SPEC_ANCHOR_MIN_CHARS = 200

# bounded host-side render concurrency (reference pipeline.py:94-96);
# one semaphore per event loop — asyncio primitives must not cross loops
_render_semaphores: dict[int, asyncio.Semaphore] = {}


def _render_sem() -> asyncio.Semaphore:
    from karanta_tpu_torch.pipeline.render_pool import _worker_count

    loop_id = id(asyncio.get_running_loop())
    sem = _render_semaphores.get(loop_id)
    if sem is None:
        _render_semaphores.clear()  # old loops are gone; drop their semaphores
        # sized to the render worker pool (cpu-2, reference
        # pipeline.py:136-142) so render_wait_ms measures pool queueing
        sem = asyncio.Semaphore(max(1, _worker_count()))
        _render_semaphores[loop_id] = sem
    return sem


@dataclass
class PipelineArgs:
    workspace: str
    pdfs: list[str] = field(default_factory=list)
    model: str = "karanta-ocr"
    server: str = "http://localhost:30024/v1"
    api_key: Optional[str] = None
    workers: int = 20
    pages_per_group: int = 500
    max_page_retries: int = 8
    max_page_error_rate: float = 0.004
    target_longest_image_dim: int = PIPELINE_IMAGE_DIM
    prompt_key: str = "olmo_ocr_system_prompt"
    prompt_path: Optional[str] = None
    guided_decoding: bool = False
    accept_raw_text: bool = False
    markdown: bool = False
    stats: bool = False
    serve_inproc: bool = False
    model_path: Optional[str] = None
    server_extra_args: list[str] = field(default_factory=list)
    # queue-depth worker admission (reference pipeline.py:815-843,1366)
    admission_control: bool = True
    admission_poll_interval: float = 1.0
    admission_release_interval: float = 30.0
    # per-page completion budget; the reference hardcodes 4000
    # (pipeline.py:124) — overridable so capacity planning (and the
    # pipeline bench) can match the serving engine's decode budget
    max_output_tokens: int = MAX_OUTPUT_TOKENS_PER_PAGE
    # bench-only (not CLI-exposed): (pdf_orig_path, page_num) -> str
    # attaches a forced_output stream per request so throughput can be
    # measured under realistic output-text statistics against a
    # teacher-forcing server (EngineConfig.teacher_force)
    forced_output_fn: Optional[Any] = None


async def build_page_query(local_pdf_path: str, page: int,
                           target_longest_image_dim: int,
                           image_rotation: int = 0,
                           model_name: str = "karanta-ocr",
                           prompt_key: str = "olmo_ocr_system_prompt",
                           prompt_path: Optional[str] = None,
                           max_tokens: int = MAX_OUTPUT_TOKENS_PER_PAGE
                           ) -> dict:
    """Render a page + anchor text into one chat-completions request body."""
    assert image_rotation in (0, 90, 180, 270), "invalid rotation"
    template = load_prompt_template(prompt_key, prompt_path)

    t0 = time.perf_counter()
    async with _render_sem():
        t1 = time.perf_counter()
        # rasterize + anchor in a spawned worker PROCESS (render_pool):
        # minipdf's content-stream work is GIL-bound, so in-thread
        # rendering caps at ~1 core and steals time from the serving loop
        from karanta_tpu_torch.pipeline.render_pool import render_page

        image_base64, anchor_text = await render_page(
            local_pdf_path, page, target_longest_image_dim, 4000, True)
    # client-side accounting (totals; consumers divide by pages):
    # render_wait = queueing for the bounded render pool, render = the
    # rasterize+anchor thread itself
    metrics.add_metrics(render_wait_ms=1000 * (t1 - t0),
                        render_ms=1000 * (time.perf_counter() - t1))

    if image_rotation:
        image_base64 = rotate_png_base64(image_base64, image_rotation)

    return {
        "model": model_name,
        "messages": create_vision_message(template, anchor_text, image_base64),
        "max_tokens": max_tokens,
        "temperature": 0.0,
        # speculation hint: pages WITH a text layer repeat their anchor in
        # the output, where n-gram drafting wins; scanned pages give the
        # drafter nothing to match, so they vote it off. The engine ignores
        # this unless it was started with --speculative-ngram; foreign
        # servers ignore the extra field.
        "speculative": len(anchor_text.strip()) >= SPEC_ANCHOR_MIN_CHARS,
    }


def rotate_png_base64(image_base64: str, rotation: int) -> str:
    """A base64 PNG turned counter-clockwise by ``rotation`` degrees, as
    PIL's ``Transpose.ROTATE_<rotation>`` turns it (``np.rot90`` turns the
    same way), kept gray or RGB."""
    from karanta_tpu_torch.ops.png import (decode_png, encode_png_gray,
                                           encode_png_rgb)

    px = np.rot90(decode_png(base64.b64decode(image_base64)),
                  k=rotation // 90)
    encode = encode_png_gray if px.ndim == 2 else encode_png_rgb
    return base64.b64encode(encode(px)).decode("utf-8")


def parse_model_content(content: str,
                        accept_raw_text: bool = False) -> ListPageResponse:
    """Model output -> ListPageResponse: a JSON page object or a JSON list
    of page objects (the reference's trained envelope — non-JSON counts as
    a retryable attempt, reference pipeline.py:352-362,414-428). With
    accept_raw_text, a non-JSON completion is wrapped as natural_text
    instead — for fine-tunes that emit plain text/markdown (most
    third-party OCR models do; training/data.py PlainTextFormat)."""
    stripped = content.strip()
    if stripped.startswith("{") or stripped.startswith("["):
        parsed = json.loads(stripped)
        items = parsed if isinstance(parsed, list) else [parsed]
        return ListPageResponse(pages=[PageResponse(**item) for item in items])
    if accept_raw_text and stripped:
        return ListPageResponse(pages=[PageResponse(natural_text=stripped)])
    raise json.JSONDecodeError("not JSON", content, 0)


async def process_page(args, worker_id: int, pdf_orig_path: str,
                       pdf_local_path: str, page_num: int) -> PageResult:
    """OCR one page with the retry/temperature ladder + rotation correction."""
    completion_url = f"{args.server.rstrip('/')}/chat/completions"
    max_retries = args.max_page_retries
    exponential_backoffs = 0
    cumulative_rotation = 0
    attempt = 0
    await tracker.track_work(worker_id, f"{pdf_orig_path}-{page_num}", "started")

    while attempt < max_retries:
        lookup = min(attempt, len(TEMPERATURE_BY_ATTEMPT) - 1)
        query = await build_page_query(
            pdf_local_path, page_num, args.target_longest_image_dim,
            image_rotation=cumulative_rotation, model_name=args.model,
            prompt_key=args.prompt_key, prompt_path=args.prompt_path,
            max_tokens=getattr(args, "max_output_tokens",
                               MAX_OUTPUT_TOKENS_PER_PAGE))
        query["temperature"] = TEMPERATURE_BY_ATTEMPT[lookup]
        if args.guided_decoding:
            query["guided_regex"] = GUIDED_REGEX
        ffn = getattr(args, "forced_output_fn", None)
        if ffn is not None:  # bench-only teacher forcing (PipelineArgs);
            # keyed on the ORIGINAL path (the local one is a temp copy)
            forced = ffn(pdf_orig_path, page_num)
            if forced:
                query["forced_output"] = forced

        try:
            t_post = time.perf_counter()
            status, body = await apost(completion_url, query,
                                       api_key=getattr(args, "api_key", None))
            metrics.add_metrics(
                http_ms=1000 * (time.perf_counter() - t_post))
            if status in (400, 500):
                raise ValueError(f"server returned {status}: {body[:500]!r}")
            if status == 429:
                raise ConnectionError("429: rate limited")
            if status != 200:
                raise ValueError(f"http status {status}")

            data = json.loads(body)
            usage = data.get("usage", {})
            if usage.get("total_tokens", 0) > MODEL_MAX_CONTEXT:
                raise ValueError(
                    f"response exceeded model_max_context {MODEL_MAX_CONTEXT}")
            choice = data["choices"][0]
            if choice.get("finish_reason") != "stop":
                raise ValueError("finish_reason was not 'stop'")

            metrics.add_metrics(
                server_input_tokens=usage.get("prompt_tokens", 0),
                server_output_tokens=usage.get("completion_tokens", 0))

            page_response = parse_model_content(
                choice["message"]["content"],
                accept_raw_text=getattr(args, "accept_raw_text", False))

            first = page_response.pages[0]
            if not first.is_rotation_valid and attempt < max_retries - 1:
                cumulative_rotation = (
                    cumulative_rotation + first.rotation_correction) % 360
                logger.info(
                    "rotation invalid for %s-%d; cumulative rotation now %d",
                    pdf_orig_path, page_num, cumulative_rotation)
                raise ValueError("invalid_page rotation")

            metrics.add_metrics(**{"completed_pages": 1,
                                   f"finished_on_attempt_{attempt}": 1})
            await tracker.track_work(
                worker_id, f"{pdf_orig_path}-{page_num}", "finished")
            return PageResult(
                pdf_orig_path, page_num, page_response,
                input_tokens=usage.get("prompt_tokens", 0),
                output_tokens=usage.get("completion_tokens", 0),
                is_fallback=False)
        except (ConnectionError, OSError, asyncio.TimeoutError) as exc:
            # transport problems back off without consuming page attempts;
            # base 10 s matches reference pipeline.py:394-407, env-tunable so
            # crash-recovery tests don't spend real minutes sleeping
            base = float(os.environ.get("KARANTA_BACKOFF_BASE", "10"))
            delay = base * (2 ** exponential_backoffs)
            exponential_backoffs += 1
            logger.warning("transport error on %s-%d (%s); sleeping %ds",
                           pdf_orig_path, page_num, exc, delay)
            await asyncio.sleep(delay)
        except asyncio.CancelledError:
            await tracker.track_work(
                worker_id, f"{pdf_orig_path}-{page_num}", "cancelled")
            raise
        except json.JSONDecodeError as exc:
            logger.warning("json decode error attempt %d for %s-%d: %s",
                           attempt, pdf_orig_path, page_num, exc)
            attempt += 1
        except (ValueError, KeyError, IndexError, TypeError) as exc:
            logger.warning("attempt %d failed for %s-%d: %s",
                           attempt, pdf_orig_path, page_num, exc)
            attempt += 1
        except Exception:
            logger.exception("unexpected error for %s-%d",
                             pdf_orig_path, page_num)
            attempt += 1

    logger.error("page %s-%d failed after %d attempts; using anchor fallback",
                 pdf_orig_path, page_num, max_retries)
    metrics.add_metrics(failed_pages=1)
    await tracker.track_work(worker_id, f"{pdf_orig_path}-{page_num}", "errored")
    fallback_text = await asyncio.to_thread(
        get_anchor_text, pdf_local_path, page_num, "pdftotext")
    return PageResult(
        pdf_orig_path, page_num,
        ListPageResponse(pages=[PageResponse(natural_text=fallback_text or None)]),
        input_tokens=0, output_tokens=0, is_fallback=True)


async def process_pdf(args, worker_id: int, pdf_orig_path: str) -> Optional[dict]:
    """OCR all pages of one document; returns a Dolma doc or None."""
    try:
        data = await asyncio.to_thread(_read_source_bytes, pdf_orig_path)
    except FileNotFoundError:
        logger.info("source not found, skipping %s", pdf_orig_path)
        return None
    except Exception:
        logger.exception("could not fetch %s, skipping", pdf_orig_path)
        return None

    if is_png(data) or is_jpeg(data):
        data = convert_image_to_pdf_bytes(data)
    if not is_pdf(data):
        logger.warning("%s is not a PDF/PNG/JPEG, skipping", pdf_orig_path)
        return None

    with tempfile.NamedTemporaryFile("wb", suffix=".pdf", delete=False) as tf:
        tf.write(data)
        local_path = tf.name

    try:
        try:
            num_pages = PdfDocument.open(local_path).num_pages()
        except Exception:
            logger.exception("could not count pages for %s", pdf_orig_path)
            return None
        if num_pages == 0:
            return None

        page_results = None
        try:
            async with asyncio.TaskGroup() as tg:
                tasks = [
                    tg.create_task(process_page(
                        args, worker_id, pdf_orig_path, local_path, page))
                    for page in range(1, num_pages + 1)
                ]
            page_results = [t.result() for t in tasks]
        except* Exception as eg:
            logger.error("page task group failed for %s: %s",
                         pdf_orig_path, eg.exceptions[:3])
        if page_results is None:
            return None

        fallback = sum(p.is_fallback for p in page_results)
        if fallback / num_pages > args.max_page_error_rate:
            logger.error(
                "%s: %d/%d fallback pages exceeds budget %.4f — discarding",
                pdf_orig_path, fallback, num_pages, args.max_page_error_rate)
            return None
        if fallback:
            logger.warning("%s: proceeding with %d fallback pages",
                           pdf_orig_path, fallback)
        return build_dolma_document(pdf_orig_path, page_results)
    finally:
        if os.path.exists(local_path):
            os.unlink(local_path)


def _read_source_bytes(path: str) -> bytes:
    """Read a work document: local path or s3://|gs:// URI with backoff
    (reference pipeline.py:456-470 get_s3_bytes_with_backoff)."""
    if "://" in path:
        from karanta_tpu_torch.pipeline.work_queue import fetch_remote_bytes

        return fetch_remote_bytes(path)
    with open(path, "rb") as f:
        return f.read()


async def worker(args, work_queue: WorkQueue, semaphore: asyncio.Semaphore,
                 worker_id: int, release_per_item: bool = False) -> None:
    """Drain work groups. Under admission control (release_per_item=False)
    a permit is consumed per work item and only the admission controller
    mints new ones — the reference's one-at-a-time worker ramp
    (pipeline.py:594-615,1366)."""
    backend = work_queue.backend
    while True:
        if work_queue.size == 0:
            # queue drained: exit without waiting for an admission permit,
            # and post one so blocked siblings wake and exit too
            semaphore.release()
            return
        await semaphore.acquire()
        item = await work_queue.get_work()
        if item is None:
            semaphore.release()
            return
        try:
            async with asyncio.TaskGroup() as tg:
                tasks = [tg.create_task(process_pdf(args, worker_id, path))
                         for path in item.work_paths]
            docs = [t.result() for t in tasks if t.result() is not None]

            out_path = backend.output_path(item.hash)
            os.makedirs(os.path.dirname(out_path), exist_ok=True)
            tmp = out_path + ".tmp"
            with open(tmp, "w") as f:
                for doc in docs:
                    f.write(json.dumps(doc, ensure_ascii=False) + "\n")
            backend.finalize_output(item.hash, tmp)

            if args.markdown:
                _write_markdown(backend.local_root, docs)

            metrics.add_metrics(completed_documents=len(docs),
                                completed_groups=1)
            await work_queue.mark_done(item)
        except Exception:
            logger.exception("worker %d failed on group %s",
                             worker_id, item.hash)
        finally:
            await tracker.clear_work(worker_id)
            if release_per_item:
                semaphore.release()


def _write_markdown(workspace: str, docs: list[dict]) -> None:
    md_dir = os.path.join(workspace, "markdown")
    os.makedirs(md_dir, exist_ok=True)
    for doc in docs:
        base = os.path.splitext(
            os.path.basename(doc["metadata"]["Source-File"]))[0]
        with open(os.path.join(md_dir, f"{base}.md"), "w") as f:
            f.write(doc["text"])


async def server_ready(server: str, attempts: int = 300) -> bool:
    url = f"{server.rstrip('/')}/models"
    for _ in range(attempts):
        try:
            status, _ = await aget(url, timeout=5)
            if status == 200:
                return True
        except ConnectionError:
            pass
        await asyncio.sleep(1)
    return False


async def admission_controller(args, semaphore: asyncio.Semaphore,
                               stop: asyncio.Event) -> None:
    """Ramp worker admission off the engine's queue depth.

    Mirrors the reference's timeout_task (pipeline.py:815-843): poll the
    server's /metrics running/waiting counters every poll interval and mint
    one more worker permit when (a) the waiting queue has drained below 20%
    of the peak running count, (b) at least admission_release_interval has
    passed since the last release, (c) all existing permits are in use, and
    (d) the engine is idle or its running count decreased since the last
    poll. Keeps the engine saturated without letting its queue grow
    unboundedly.
    """
    base = args.server.rstrip("/")
    if base.endswith("/v1"):
        base = base[: -len("/v1")]
    metrics_url = f"{base}/metrics"

    peak_running = 0
    last_running = 0
    running_decreased = False
    consecutive_failures = 0
    last_release = time.monotonic()
    while not stop.is_set():
        try:
            await asyncio.wait_for(stop.wait(), args.admission_poll_interval)
            return
        except asyncio.TimeoutError:
            pass

        try:
            status, body = await aget(metrics_url, timeout=5)
            data = json.loads(body) if status == 200 else None
        except (ConnectionError, OSError, asyncio.TimeoutError,
                json.JSONDecodeError):
            data = None

        now = time.monotonic()
        if data is None:
            # dead/unscrapable metrics must not wedge the pipeline: after
            # ~30 failed polls fall back to timed releases
            consecutive_failures += 1
            if (consecutive_failures >= 30 and semaphore.locked()
                    and now - last_release > args.admission_release_interval):
                logger.warning(
                    "admission: metrics unreachable %d polls; releasing on "
                    "timer", consecutive_failures)
                semaphore.release()
                last_release = now
            continue
        consecutive_failures = 0

        running = int(data.get("running", 0))
        waiting = int(data.get("waiting", 0))
        slots = int(data.get("slots", 0))
        if running < last_running:
            running_decreased = True
        last_running = running
        peak_running = max(peak_running, running)

        # a starved engine (idle slots, empty queue) cannot be overloaded:
        # ramp at the poll cadence until it saturates. Servers that don't
        # advertise slot capacity (vLLM) keep the timed ramp only.
        starved = slots > 0 and waiting == 0 and running < slots
        min_gap = (args.admission_poll_interval if starved
                   else args.admission_release_interval)
        if (waiting <= int(peak_running * 0.2)
                and now - last_release > min_gap
                and semaphore.locked()
                and (starved or running == 0 or running_decreased)):
            semaphore.release()
            running_decreased = False
            last_release = now
            logger.info(
                "admission: released a permit (running=%d waiting=%d peak=%d)",
                running, waiting, peak_running)


async def metrics_reporter(interval: float = 10.0) -> None:
    while True:
        await asyncio.sleep(interval)
        logger.info("\n%s", metrics)
        logger.info("\n%s", tracker)


def print_stats(workspace: str) -> dict:
    """Aggregate results/*.jsonl (reference --stats, pipeline.py:964-1110)."""
    from karanta_tpu_torch.constants import LONG_CONTEXT_THRESHOLD

    results_dir = os.path.join(workspace, "results")
    docs = pages = fallback_pages = input_tokens = output_tokens = 0
    long_context_docs = 0
    for path in globmod.glob(os.path.join(results_dir, "output_*.jsonl")):
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                doc = json.loads(line)
                docs += 1
                meta = doc.get("metadata", {})
                pages += meta.get("pdf-total-pages", 0)
                fallback_pages += meta.get("total-fallback-pages", 0)
                input_tokens += meta.get("total-input-tokens", 0)
                out_toks = meta.get("total-output-tokens", 0)
                output_tokens += out_toks
                if out_toks > LONG_CONTEXT_THRESHOLD:
                    long_context_docs += 1
    stats = {
        "documents": docs,
        "pages": pages,
        "fallback_pages": fallback_pages,
        "total_input_tokens": input_tokens,
        "total_output_tokens": output_tokens,
        "long_context_docs": long_context_docs,
    }
    print(json.dumps(stats, indent=2))
    return stats


async def amain(args: PipelineArgs) -> None:
    backend = make_backend(args.workspace)
    work_queue = WorkQueue(backend)

    if args.stats:
        print_stats(backend.local_root)
        return

    # fail fast on a broken environment (reference pipeline.py:1263,1342)
    from karanta_tpu_torch.pipeline.preflight import check_device, check_rasterizer

    check_rasterizer()
    if args.serve_inproc:
        check_device(require_accelerator=True)

    # spawn + warm the render worker pool now, not inside the first pages
    from karanta_tpu_torch.pipeline.render_pool import warm_pool

    n_render = await warm_pool()
    if n_render:
        logger.info("render pool warm: %d worker process(es)", n_render)

    if args.pdfs:
        paths: list[str] = []
        for pattern in args.pdfs:
            if "://" in pattern:
                paths.append(pattern)  # remote URI, fetched per-document
            elif os.path.exists(pattern):
                paths.append(pattern)
            else:
                paths.extend(globmod.glob(pattern, recursive=True))
        paths = sorted(set(paths))
        # size groups so each holds ~pages_per_group pages, estimated from a
        # sample of documents (reference pipeline.py:1267-1333)
        import random

        sample = random.Random(0).sample(paths, min(100, len(paths)))
        page_counts = []
        for path in sample:
            try:
                page_counts.append(PdfDocument.open(path).num_pages())
            except Exception:
                page_counts.append(1)
        avg_pages = max(1.0, sum(page_counts) / max(len(page_counts), 1))
        items_per_group = max(1, int(args.pages_per_group / avg_pages))
        work_queue.populate_queue(paths, items_per_group)

    pending = work_queue.initialize_queue()
    logger.info("%d work groups pending", pending)
    if pending == 0:
        logger.info("nothing to do")
        return

    supervisor = None
    stop_supervisor = asyncio.Event()
    if args.serve_inproc:
        supervisor = asyncio.create_task(
            _supervise_server(args, stop_supervisor))

    try:
        if not await server_ready(args.server):
            raise RuntimeError(f"server at {args.server} never became ready")

        reporter = asyncio.create_task(metrics_reporter())
        stop_admission = asyncio.Event()
        admission = None
        if args.admission_control:
            # one permit to start; the controller ramps admission as the
            # engine's queue drains (reference pipeline.py:1366)
            semaphore = asyncio.Semaphore(1)
            admission = asyncio.create_task(
                admission_controller(args, semaphore, stop_admission))
            release_per_item = False
        else:
            semaphore = asyncio.Semaphore(args.workers)
            release_per_item = True
        workers = [asyncio.create_task(
                       worker(args, work_queue, semaphore, i,
                              release_per_item=release_per_item))
                   for i in range(args.workers)]
        await asyncio.gather(*workers)
        stop_admission.set()
        if admission is not None:
            await admission
        reporter.cancel()
        logger.info("final metrics:\n%s", metrics)
        print(json.dumps(metrics.get_metrics_summary(), default=str, indent=2))
    finally:
        stop_supervisor.set()
        if supervisor is not None:
            await supervisor


async def _supervise_server(args, stop: asyncio.Event,
                            max_restarts: int = 5) -> None:
    """Keep the in-process inference server alive, restarting on crash
    (reference pipeline.py:865-882: vLLM subprocess restarted up to 5x)."""
    restarts = 0
    proc = await _spawn_server(args)
    try:
        while not stop.is_set():
            wait_stop = asyncio.create_task(stop.wait())
            wait_proc = asyncio.create_task(proc.wait())
            done, pending = await asyncio.wait(
                {wait_stop, wait_proc}, return_when=asyncio.FIRST_COMPLETED)
            for task in pending:
                task.cancel()
            if stop.is_set():
                break
            restarts += 1
            if restarts > max_restarts:
                logger.critical("inference server crashed %d times; giving up",
                                restarts)
                raise RuntimeError("inference server keeps crashing")
            logger.error("inference server exited (code %s); restart %d/%d",
                         proc.returncode, restarts, max_restarts)
            proc = await _spawn_server(args)
    finally:
        if proc.returncode is None:
            proc.terminate()
            await proc.wait()


def _server_cmd(args: PipelineArgs) -> list[str]:
    """Command line for the spawned inference server. No performance flags
    are injected here: the server's own CLI defaults ARE the product
    configuration (prefix caching on, n-gram speculation on), and unknown
    pipeline flags pass through in
    server_extra_args so `--no-prefix-cache` / `--speculative-ngram 0`
    reach the server (reference forwards unknowns to vLLM the same way,
    pipeline.py:733-734,1249)."""
    from urllib.parse import urlparse

    port = urlparse(args.server).port or 30024
    cmd = [sys.executable, "-m", "karanta_tpu_torch.inference.server",
           "--port", str(port)]
    if args.model_path:
        cmd += ["--model-path", args.model_path]
    cmd += list(getattr(args, "server_extra_args", []) or [])
    return cmd


async def _spawn_server(args: PipelineArgs):
    cmd = _server_cmd(args)
    logger.info("spawning inference server: %s", " ".join(cmd))
    return await asyncio.create_subprocess_exec(*cmd)


def parse_args(argv: Optional[list[str]] = None) -> PipelineArgs:
    parser = argparse.ArgumentParser(
        prog="python -m karanta_tpu_torch.pipeline",
        description="Scale-out OCR pipeline over a CUDA inference server")
    parser.add_argument("workspace")
    parser.add_argument("--pdfs", nargs="*", default=[])
    parser.add_argument("--model", default="karanta-ocr")
    parser.add_argument("--server", default="http://localhost:30024/v1")
    parser.add_argument("--api-key", dest="api_key", default=None)
    parser.add_argument("--workers", type=int, default=20)
    parser.add_argument("--pages_per_group", type=int, default=500)
    parser.add_argument("--max_page_retries", type=int, default=8)
    parser.add_argument("--max_page_error_rate", type=float, default=0.004)
    parser.add_argument("--target_longest_image_dim", type=int,
                        default=PIPELINE_IMAGE_DIM)
    parser.add_argument("--prompt_key", default="olmo_ocr_system_prompt")
    parser.add_argument("--prompt_path", default=None)
    parser.add_argument("--guided_decoding", action="store_true")
    parser.add_argument("--accept_raw_text", action="store_true",
                        help="accept non-JSON completions as natural_text "
                             "(plain-text/markdown fine-tunes; default: "
                             "strict reference JSON envelope)")
    parser.add_argument("--markdown", action="store_true")
    parser.add_argument("--stats", action="store_true")
    parser.add_argument("--serve-inproc", dest="serve_inproc",
                        action="store_true")
    parser.add_argument("--model-path", dest="model_path", default=None)
    parser.add_argument("--no-admission-control", dest="admission_control",
                        action="store_false",
                        help="flat worker semaphore instead of queue-depth "
                             "admission ramp")
    parser.add_argument("--admission_poll_interval", type=float, default=1.0)
    parser.add_argument("--admission_release_interval", type=float,
                        default=30.0)
    parser.add_argument("--max_output_tokens", type=int,
                        default=MAX_OUTPUT_TOKENS_PER_PAGE,
                        help="per-page completion budget (reference "
                             "pipeline.py:124 hardcodes 4000)")
    # unknown flags pass through to the spawned inference server, as the
    # reference forwards unknowns to vLLM (pipeline.py:1249,733-734)
    ns, extra = parser.parse_known_args(argv)
    args = PipelineArgs(**vars(ns))
    args.server_extra_args = extra
    return args


def main(argv: Optional[list[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    asyncio.run(amain(parse_args(argv)))


if __name__ == "__main__":
    main()
