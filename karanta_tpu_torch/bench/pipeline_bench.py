"""Full-pipeline throughput bench: the number a karanta-ocr user experiences.

Drives the REAL pipeline (karanta_tpu_torch.pipeline.runner.amain) over a
synthetic PDF corpus against the port's OpenAI-protocol server in the same
process, on the card unless ``--device cpu``:

  PDF bytes -> rasterize (host) -> anchor extract -> prompt build ->
  HTTP /v1/chat/completions -> continuous-batching engine (prefill +
  decode) -> response validation ladder -> Dolma JSONL write

It prints the same one JSON line as the JAX package's
``karanta_tpu.bench.pipeline_bench``; ``backend`` is the torch device type
and ``chips`` the card count. There is no tunnel canary (both canary fields
are null) and no compile cache.

Honesty notes, so the number is interpretable:
- Weights are random; kernel cost is weight-value independent, so device
  time is representative. Model output is garbage that runs to the token
  budget, so every page takes exactly ONE full-cost attempt
  (`--max_page_retries 1`) and then the anchor-text fallback — the bench
  therefore ALSO pays fallback extraction per page, which a production run
  with a real checkpoint would skip (conservative).
- The per-page completion budget defaults to 512 tokens to match bench.py's
  engine operating point, via the pipeline's --max_output_tokens knob.
- Pages are distinct (unique content per page), so no image-decode or
  prefix caching of the page can fire.
- ``--teacher-force`` forces each page's completion to its own text layer,
  word-perturbed at ``--force-error-rate`` (``forced_page_text``), through
  the engine's teacher-forcing hook: the full decode and verify compute
  runs, the completion stops and parses on its first attempt, and n-gram
  acceptance reflects the transcript's real statistics. ``--guided`` sends
  the pipeline's guided regex with every request; the two do not compose
  (forced tokens bypass the automaton).

Usage:
  python -m karanta_tpu_torch.bench.pipeline_bench [--pages 120]
      [--preset qwen2.5-vl-7b] [--device cuda|cpu] ...
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import time
from typing import Optional

import numpy as np

_WORDS = ("the of and to in is was he for it with as his on be at by had "
          "not are but from or have an they which one you were her all she "
          "there would their we him been has when who will more no if out "
          "so said what up its about into than them can only other new some "
          "could time these two may then do first any my now such like our "
          "over man me even most made after also did many before must well "
          "back through years where much your way down should because each "
          "just those people how too little state good very make world still "
          "own see men work long get here between both life being under").split()


def page_text(seed: int, n_lines: int = 40, words_per_line: int = 9) -> str:
    """Deterministic pseudo-English page text (distinct per seed)."""
    rng = np.random.default_rng(1000 + seed)
    lines = []
    for _ in range(n_lines):
        ws = rng.choice(len(_WORDS), size=words_per_line)
        lines.append(" ".join(_WORDS[i] for i in ws))
    return "\n".join(lines)


def forced_page_text(seed: int, error_rate: float,
                     n_lines: int = 40) -> str:
    """The completion a real checkpoint would emit for page `seed`: its own
    text layer, word-perturbed at `error_rate` to model OCR-vs-anchor
    divergence (the anchor in the prompt is the exact layer; a real model's
    transcript differs by its error rate, which bounds n-gram acceptance).
    Deterministic per page."""
    text = page_text(seed, n_lines=n_lines)
    if not error_rate:
        return text
    rng = np.random.default_rng(7000 + seed)
    out_lines = []
    for line in text.split("\n"):
        words = line.split(" ")
        for i in range(len(words)):
            if rng.random() < error_rate:
                words[i] = _WORDS[int(rng.integers(0, len(_WORDS)))]
        out_lines.append(" ".join(words))
    # perturbed per line: only words change, and the transcript keeps the
    # anchor's line structure
    return "\n".join(out_lines)


def make_page_array(seed: int, height: int = 1288,
                    width: int = 994) -> "np.ndarray":
    """Text-like page content at pipeline render dims (1288 px longest side,
    reference pipeline.py:1170-1175); same construction as bench.py's
    make_page_png so the two benches share a workload."""
    rng = np.random.default_rng(seed)
    page = np.full((height, width), 235, np.uint8)
    for y in range(60, height - 60, 22):
        line = rng.integers(0, 2, size=(12, width - 120)) * rng.integers(
            100, 200, size=(12, width - 120))
        page[y:y + 12, 60:width - 60] = np.minimum(
            page[y:y + 12, 60:width - 60], 255 - line).astype(np.uint8)
    return np.stack([page] * 3, axis=-1)


def build_corpus(root: str, n_pages: int, text_layer: bool,
                 height: int = 1288, width: Optional[int] = None,
                 n_lines: int = 40) -> list[str]:
    """Write n_pages single-page scanned PDFs; with text_layer each carries
    an invisible OCR-style text layer (anchor-extractable — the workload
    where the pipeline auto-enables speculation)."""
    from karanta_tpu_torch.data.synthetic import page_to_pdf_bytes

    if width is None:
        width = max(64, int(height * 994 / 1288))
    os.makedirs(root, exist_ok=True)
    paths = []
    for i in range(n_pages):
        pdf = page_to_pdf_bytes(
            make_page_array(i, height, width),
            text_layer=(page_text(i, n_lines=n_lines)
                        if text_layer else None))
        path = os.path.join(root, f"page_{i:04d}.pdf")
        with open(path, "wb") as f:
            f.write(pdf)
        paths.append(path)
    return paths


def build_engine(args, cfg, dtype, device):
    from karanta_tpu_torch.bench.randweights import init_params_bench
    from karanta_tpu_torch.inference.engine import Engine, EngineConfig
    from karanta_tpu_torch.inference.tokenizer import ByteTokenizer

    quantize = args.quantize if args.quantize != "none" else None
    params, engine_quantize = init_params_bench(cfg, dtype, quantize,
                                                device=device)
    prefill_buckets = tuple(
        b for b in (512, 1024, 1536, 2048, 2432, 4096)
        if b <= args.max_seq_len) or (args.max_seq_len,)
    ecfg = EngineConfig(
        max_batch_size=args.batch,
        max_seq_len=args.max_seq_len,
        decode_chunk=int(os.environ.get("KARANTA_BENCH_CHUNK",
                                        args.decode_chunk)),
        prefill_buckets=prefill_buckets,
        image_token_buckets=tuple(args.image_token_buckets),
        dtype=dtype,
        quantize=engine_quantize,
        kv_quantize=(args.kv_quantize if args.kv_quantize != "none"
                     else None),
        act_quant=("int8" if quantize == "int8"
                   and args.act_quant != "none" else None),
        speculative_ngram=args.speculative_ngram,
        # every OCR page shares the olmOCR instruction prefix (text before
        # the per-page anchor): cache its KV and prefill only the suffix
        prefix_cache=args.prefix_cache,
        prefix_min_tokens=args.prefix_min_tokens,
        teacher_force=args.teacher_force,
    )
    if args.tokenizer_path:
        # BPE operating point: word-level token statistics instead of the
        # hermetic byte tokenizer's ~4x spend; build one with
        # scripts/make_bpe_tokenizer.py
        from karanta_tpu_torch.inference.tokenizer import HFTokenizer

        tok = HFTokenizer(args.tokenizer_path)
        if cfg.text.vocab_size < tok.vocab_size:
            raise SystemExit(
                f"preset {cfg.name} vocab {cfg.text.vocab_size} can't "
                f"cover the tokenizer's {tok.vocab_size} ids; use a "
                f"full-size preset")
    else:
        tok = ByteTokenizer()
    return Engine(params, cfg, tok, ecfg, device=device)


async def _warmup(server_url: str, args) -> None:
    """One page through the full HTTP path before timing starts (the
    allocator, the library handles and the kernels' first launches)."""
    from karanta_tpu_torch.pipeline.http import apost
    from karanta_tpu_torch.pipeline.runner import (GUIDED_REGEX,
                                                   build_page_query)

    import tempfile

    from karanta_tpu_torch.data.synthetic import page_to_pdf_bytes

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "warm.pdf")
        with open(path, "wb") as f:
            f.write(page_to_pdf_bytes(
                make_page_array(10_000_000, args.page_dim,
                                max(64, int(args.page_dim * 994 / 1288))),
                text_layer=(page_text(10_000_000, n_lines=args.page_lines)
                            if args.text_layer else None)))
        query = await build_page_query(
            path, 1, args.page_dim, max_tokens=args.decode_tokens,
            prompt_key=args.prompt_key, prompt_path=args.prompt_path)
        if args.guided:
            query["guided_regex"] = GUIDED_REGEX
        if args.teacher_force:
            # the warm-up page's own forced transcript, as the timed pages
            # get theirs: random weights would run it to the whole budget
            query["forced_output"] = forced_page_text(
                10_000_000, args.force_error_rate, n_lines=args.page_lines)
        status, body = await apost(
            f"{server_url.rstrip('/')}/chat/completions", query,
            timeout=3600.0)
        if status != 200:
            raise RuntimeError(f"warmup request failed: {status} "
                               f"{body[:300]!r}")


async def run_bench(args) -> dict:
    import torch

    from karanta_tpu_torch.device import resolve_device
    from karanta_tpu_torch.inference.server import InferenceServer
    from karanta_tpu_torch.models.qwen25_vl.config import get_config, tiny_config
    from karanta_tpu_torch.pipeline import runner

    device = resolve_device(args.device)
    if args.preset == "tiny":  # CI-scale smoke point (CPU-runnable)
        from karanta_tpu_torch.inference.tokenizer import ByteTokenizer

        cfg = tiny_config(vocab_size=ByteTokenizer().vocab_size)
    else:
        cfg = get_config(args.preset)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    engine = build_engine(args, cfg, dtype, device)
    server = InferenceServer(engine, model_name=f"bench-{cfg.name}")
    port = await server.start("127.0.0.1", 0)
    server_url = f"http://127.0.0.1:{port}/v1"

    workspace = args.workspace
    corpus_dir = os.path.join(workspace, "corpus")
    pdfs = build_corpus(corpus_dir, args.pages, args.text_layer,
                        height=args.page_dim,
                        n_lines=args.page_lines)

    from karanta_tpu_torch.pipeline.render_pool import warm_pool

    await warm_pool()
    await _warmup(server_url, args)

    pargs = runner.PipelineArgs(
        workspace=workspace,
        pdfs=pdfs,
        server=server_url,
        workers=args.workers,
        pages_per_group=max(1, args.pages // max(1, args.workers)),
        # random weights never produce a parseable page: one full-cost
        # attempt per page, then the anchor fallback (see module docstring)
        max_page_retries=1,
        max_page_error_rate=1.01,
        target_longest_image_dim=args.page_dim,
        prompt_key=args.prompt_key,
        prompt_path=args.prompt_path,
        guided_decoding=args.guided,
        accept_raw_text=True,
        admission_control=args.admission_control,
        admission_poll_interval=0.5,
        admission_release_interval=args.admission_release_interval,
        max_output_tokens=args.decode_tokens,
    )
    if args.teacher_force:
        import re

        def _forced(path: str, page: int) -> Optional[str]:
            m = re.search(r"page_(\d+)", os.path.basename(path))
            return (forced_page_text(int(m.group(1)), args.force_error_rate,
                                     n_lines=args.page_lines)
                    if m else None)

        pargs.forced_output_fn = _forced
        # forced completions parse on the first attempt (as a real
        # checkpoint's do); the single-attempt budget stays for
        # comparability

    start = time.time()
    await runner.amain(pargs)
    elapsed = time.time() - start
    await server.stop()

    summary = runner.metrics.get_metrics_summary()
    totals = summary.get("total_metrics", {})
    n_chips = torch.cuda.device_count() if device.type == "cuda" else 1
    rate = args.pages / elapsed
    detail = {
        "preset": cfg.name,
        "pages": args.pages,
        "elapsed_s": round(elapsed, 3),
        "decode_tokens_per_page": args.decode_tokens,
        "workers": args.workers,
        "batch": args.batch,
        "max_seq_len": args.max_seq_len,
        "text_layer": args.text_layer,
        "guided": args.guided,
        "speculative_ngram": args.speculative_ngram,
        "tokenizer": ("bpe:" + os.path.basename(
            args.tokenizer_path.rstrip("/"))
            if args.tokenizer_path else "byte"),
        "teacher_force": args.teacher_force,
        "force_error_rate": (args.force_error_rate if args.teacher_force
                             else None),
        "backend": device.type,
        "chips": n_chips,
        "server_output_tokens": totals.get("server_output_tokens", 0),
        "server_input_tokens": totals.get("server_input_tokens", 0),
        "requests_served": server.requests_served,
        "completion_tokens_served": server.completion_tokens_served,
        "tunnel_canary_pre": None,
        "tunnel_canary_post": None,
    }
    detail["finished_on_attempt_0"] = int(
        totals.get("finished_on_attempt_0", 0))
    detail["fallback_pages"] = int(totals.get("failed_pages", 0))
    if detail["finished_on_attempt_0"] < args.pages:
        # a degraded run (server errors -> anchor fallbacks) must not
        # masquerade as a throughput number
        import sys

        print(f"WARNING: only {detail['finished_on_attempt_0']}/"
              f"{args.pages} pages decoded on attempt 0 — the metric line "
              "reflects fallback-path speed, not serving throughput",
              file=sys.stderr)
    if getattr(engine, "spec_passes", 0):
        detail["spec_tokens_per_pass"] = round(
            engine.spec_tokens / max(1, engine.spec_passes), 3)
    for key in ("render_ms", "render_wait_ms", "http_ms"):
        if key in totals:
            detail[f"client_{key}_per_page"] = round(
                totals[key] / max(1, args.pages), 2)
    prof = dict(getattr(server, "_prof", {}) or {})
    reqs = max(1, prof.pop("requests", 1))
    if prof:
        # server-side per-op wall ms/request (body_read and
        # decode_collect are waits, the rest is host work)
        detail["server_prof_ms_per_req"] = {
            k[:-2]: round(1000 * v / reqs, 2)
            for k, v in sorted(prof.items()) if k.endswith("_s")}
    return {
        "metric": "pipeline_pages_per_sec_per_chip",
        "value": round(rate / n_chips, 4),
        "unit": "pages/s/chip",
        "vs_baseline": round(rate / n_chips / args.baseline, 4),
        "detail": detail,
    }


def add_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--preset", default=os.environ.get(
        "KARANTA_BENCH_PRESET", "qwen2.5-vl-7b"))
    parser.add_argument("--pages", type=int, default=120)
    parser.add_argument("--workers", type=int, default=16)
    parser.add_argument("--decode-tokens", dest="decode_tokens", type=int,
                        default=512,
                        help="per-page completion budget (matches bench.py)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) or "
                             "cpu, which runs the kernels' plain versions")
    parser.add_argument("--batch", type=int, default=None,
                        help="engine slots (default 64 for 7B presets, "
                             "128 otherwise, as the JAX bench)")
    parser.add_argument("--max-seq-len", dest="max_seq_len", type=int,
                        default=2816,
                        help="KV bucket: the pipeline's real prompt is "
                             "~2290 byte-tokens (olmOCR prompt text + "
                             "~1630 image tokens at 1288 px) + 512 decode "
                             "= 2801")
    parser.add_argument("--decode-chunk", dest="decode_chunk", type=int,
                        default=64)
    parser.add_argument("--page-dim", dest="page_dim", type=int,
                        default=1288,
                        help="corpus page height + pipeline render dim "
                             "(reference pipeline.py:1170-1175)")
    parser.add_argument("--image-token-buckets", dest="image_token_buckets",
                        type=lambda s: [int(x) for x in s.split(",")],
                        default=[2048])
    parser.add_argument("--prompt-key", dest="prompt_key",
                        default="olmo_ocr_system_prompt")
    parser.add_argument("--prompt-path", dest="prompt_path", default=None)
    parser.add_argument("--quantize", default=os.environ.get(
        "KARANTA_BENCH_QUANTIZE", "int8"), choices=["none", "int8"])
    parser.add_argument("--kv-quantize", dest="kv_quantize",
                        default="int8", choices=["none", "int8", "int4"])
    parser.add_argument("--act-quant", dest="act_quant", default=None,
                        choices=["none", "int8"])
    parser.add_argument("--text-layer", dest="text_layer",
                        action="store_true",
                        help="corpus pages carry an invisible text layer "
                             "(anchored workload; enables the pipeline's "
                             "speculation heuristic)")
    parser.add_argument("--guided", action="store_true",
                        help="send the pipeline's guided regex per request")
    parser.add_argument("--speculative-ngram", dest="speculative_ngram",
                        type=int, default=3,
                        help="n-gram drafter depth; default matches the "
                             "production server CLI (3). Per-request "
                             "anchor gating still applies, so un-anchored "
                             "corpora decode per-step as in production; "
                             "0 disables")
    parser.add_argument("--teacher-force", dest="teacher_force",
                        action="store_true",
                        help="force each page's completion to its (word-"
                             "perturbed) text layer via the engine's "
                             "teacher-forcing hook: full compute runs, "
                             "output-text statistics become realistic, the "
                             "operating point for measuring speculative "
                             "decoding without checkpoints")
    parser.add_argument("--page-lines", dest="page_lines", type=int,
                        default=40,
                        help="lines of text per corpus page (the text "
                             "layer/anchor). The hermetic ByteTokenizer "
                             "spends ~4x the tokens of real BPE on the same "
                             "text, so anchored operating points shrink "
                             "this to keep the anchor's TOKEN count "
                             "realistic")
    parser.add_argument("--force-error-rate", dest="force_error_rate",
                        type=float, default=0.05,
                        help="word perturbation rate for the forced "
                             "transcript vs the anchor (models the OCR "
                             "error rate; bounds n-gram acceptance)")
    parser.add_argument("--tokenizer-path", dest="tokenizer_path",
                        default=None,
                        help="HF tokenizer dir (scripts/"
                             "make_bpe_tokenizer.py output or real Qwen "
                             "files): measure under word-level BPE token "
                             "statistics instead of the hermetic byte "
                             "tokenizer's ~4x spend")
    parser.add_argument("--prefix-min-tokens", dest="prefix_min_tokens",
                        type=int, default=256,
                        help="LCP gate below which prefix caching doesn't "
                             "fire (the server CLI's default)")
    parser.add_argument("--no-prefix-cache", dest="prefix_cache",
                        action="store_false", default=True,
                        help="disable shared-instruction-prefix KV caching "
                             "(default on: the pipeline's pages share the "
                             "olmOCR prompt head)")
    parser.add_argument("--no-admission-control", dest="admission_control",
                        action="store_false")
    parser.add_argument("--admission-release-interval",
                        dest="admission_release_interval", type=float,
                        default=5.0,
                        help="admission ramp cadence; the production 30 s "
                             "default would dominate a 2-minute bench run")
    parser.add_argument("--workspace", default=None,
                        help="workspace dir (default: a temp dir)")
    parser.add_argument("--baseline", type=float, default=1.0)


def main(argv: Optional[list[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m karanta_tpu_torch.bench.pipeline_bench")
    add_args(parser)
    args = parser.parse_args(argv)
    run(args)


def run(args) -> dict:
    """Resolve defaults, run, print the one JSON metric line."""
    import tempfile

    if args.teacher_force and args.guided:
        # forced tokens bypass the DFA: every request would fail in
        # Engine.prepare and the bench would degrade to fallback pages
        raise SystemExit(
            "--teacher-force does not compose with --guided "
            "(forced tokens bypass the automaton); drop one of the flags")
    if args.batch is None:
        args.batch = 64 if "7b" in args.preset.lower() else 128

    cleanup = None
    if args.workspace is None:
        tmp = tempfile.TemporaryDirectory(prefix="karanta_pipe_bench_")
        args.workspace = tmp.name
        cleanup = tmp
    try:
        result = asyncio.run(run_bench(args))
    finally:
        if cleanup is not None:
            cleanup.cleanup()
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
