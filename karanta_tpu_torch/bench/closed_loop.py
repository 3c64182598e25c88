"""Closed loop of the port: train -> checkpoint -> serve -> pipeline -> CER
(the port's twin of ``scripts/closed_loop_demo.py``, with its flags and its
outputs).

It chains the port's own modules on a corpus whose ground truth is exact by
construction:

  1. ``data/synthetic.py`` renders digit strings as image-only PDFs with
     their ground-truth JSON (a training corpus and an evaluation corpus);
  2. ``training/train.py`` fine-tunes the tiny VLM on
     ``configs/training/ocr/closed_loop.yaml``, on the card unless
     ``--device cpu``;
  3. ``python -m karanta_tpu_torch.inference.server --native-checkpoint``
     serves the result as a subprocess (OpenAI HTTP surface);
  4. ``pipeline/runner.py`` OCRs the evaluation corpus through that server
     with ``--accept_raw_text`` (the corpus trains on plain-text targets);
  5. ``bench/scoring.py`` scores CER and WER against the ground truth, into
     ``<root>/scores.json`` and ``<root>/report.md``.

Usage:
  python -m karanta_tpu_torch.bench.closed_loop --train-pages 8 --chars 1 \\
      --eval-pages 8 --eval-from-train --steps 500 --lr 0.001
  (add --device cpu to run on the CPU; --skip-train reuses the checkpoint
  under <root>/train)
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import time
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CONFIG = os.path.join(REPO, "configs/training/ocr/closed_loop.yaml")
PROMPTS = os.path.join(REPO, "configs/prompts/closed_loop.yaml")


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m karanta_tpu_torch.bench.closed_loop",
        description=__doc__.splitlines()[0])
    p.add_argument("--root",
                   default=os.path.join(REPO, "runs/closed_loop_torch"))
    p.add_argument("--model", default="tiny", choices=["tiny", "small"])
    p.add_argument("--device", default=None,
                   help="cpu trains and serves on the CPU (the kernels' "
                        "plain versions); the card otherwise")
    p.add_argument("--train-pages", type=int, default=512)
    p.add_argument("--eval-pages", type=int, default=16)
    p.add_argument("--chars", type=int, default=4)
    p.add_argument("--words", type=int, default=None,
                   help="words per line (default: one word per page)")
    p.add_argument("--lines", type=int, default=1, help="lines per page")
    p.add_argument("--vocab", type=int, default=None,
                   help="draw words from a fixed vocab of this size")
    p.add_argument("--text-layer", action="store_true",
                   help="embed each page's text as an invisible PDF text "
                        "layer (the pipeline's anchor text then carries it)")
    p.add_argument("--speculative-ngram", type=int, default=0,
                   help="serve with n-gram speculative decoding (gamma); "
                        "0 leaves the server's default")
    p.add_argument("--max-model-len", type=int, default=512)
    p.add_argument("--max-length", type=int, default=None,
                   help="training sequence cap override (longer pages)")
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--lr", type=float, default=None,
                   help="override the config learning rate")
    p.add_argument("--skip-train", action="store_true",
                   help="reuse an existing checkpoint under <root>/train")
    p.add_argument("--eval-from-train", action="store_true",
                   help="evaluate on training strings (memorization check)")
    p.add_argument("--port", type=int, default=0, help="0 = pick a free port")
    p.add_argument("--time-pipeline", action="store_true",
                   help="run the pipeline twice, the second pass timed, and "
                        "record pages/s in the report")
    p.add_argument("--serve-batch", type=int, default=4,
                   help="server decode slots")
    p.add_argument("--decode-chunk", type=int, default=8)
    p.add_argument("--pipeline-workers", type=int, default=4)
    return p.parse_args(argv)


def gen_corpora(args) -> list[tuple[str, str]]:
    from karanta_tpu_torch.data.synthetic import make_corpus, random_texts

    train_dir = os.path.join(args.root, "corpus_train")
    eval_dir = os.path.join(args.root, "corpus_eval")
    kw = dict(n_chars=args.chars, words=args.words, lines=args.lines,
              vocab=args.vocab)
    train_texts = random_texts(args.train_pages, seed=0, **kw)
    if args.eval_from_train:
        eval_texts = train_texts[: args.eval_pages]
    else:
        seen = set(train_texts)
        eval_texts = [t for t in random_texts(args.eval_pages * 4, seed=99,
                                              **kw)
                      if t not in seen][: args.eval_pages]
    # regenerate the training corpus whenever its contents would differ
    manifest_path = os.path.join(train_dir, "manifest.json")
    want = {"texts": train_texts, "text_layer": args.text_layer}
    have = None
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            have = json.load(f)
    if have != want:
        shutil.rmtree(train_dir, ignore_errors=True)
        make_corpus(train_dir, len(train_texts), texts=train_texts,
                    char_px=48, seed=0, text_layer=args.text_layer)
        with open(manifest_path, "w") as f:
            json.dump(want, f)
    manifest = make_corpus(eval_dir, len(eval_texts), texts=eval_texts,
                           char_px=48, seed=1, text_layer=args.text_layer)
    print(f"corpora: {len(train_texts)} train / {len(manifest)} evaluation "
          f"pages under {args.root}", flush=True)
    return manifest


def train(args) -> str:
    from karanta_tpu_torch.training.checkpoint import get_last_checkpoint
    from karanta_tpu_torch.training.train import main as train_main

    out_dir = os.path.join(args.root, "train")
    if args.skip_train and get_last_checkpoint(out_dir):
        print(f"reusing checkpoint {get_last_checkpoint(out_dir)}",
              flush=True)
        return out_dir
    t0 = time.time()
    argv = [CONFIG,
            "--dataset_root", os.path.join(args.root, "corpus_train"),
            "--output_dir", out_dir,
            "--max_steps", str(args.steps),
            "--model_name_or_path", args.model]
    if args.lr is not None:
        argv += ["--learning_rate", str(args.lr)]
    if args.max_length is not None:
        argv += ["--max_length", str(args.max_length)]
    if args.device is not None:
        argv += ["--device", args.device]
    metrics = train_main(argv)
    seconds = time.time() - t0
    print(f"trained {args.steps} steps in {seconds:.1f}s "
          f"({args.steps / seconds:.2f} steps/s): loss={metrics['loss']:.4f}",
          flush=True)
    return out_dir


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def serve(args, ckpt_dir: str) -> tuple[subprocess.Popen, int]:
    port = args.port or _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    cmd = [sys.executable, "-m", "karanta_tpu_torch.inference.server",
           "--native-checkpoint", ckpt_dir, "--preset", args.model,
           "--host", "127.0.0.1", "--port", str(port),
           "--max-batch-size", str(args.serve_batch), "--max-model-len",
           str(args.max_model_len), "--decode-chunk", str(args.decode_chunk)]
    if args.speculative_ngram:
        cmd += ["--speculative-ngram", str(args.speculative_ngram)]
    if args.device is not None:
        cmd += ["--device", args.device]
    log = open(os.path.join(args.root, "server.log"), "w")
    proc = subprocess.Popen(cmd, env=env, cwd=REPO, stdout=log,
                            stderr=subprocess.STDOUT)
    deadline = time.time() + 600
    while time.time() < deadline:
        if proc.poll() is not None:
            raise RuntimeError("server exited early; see server.log")
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/health", timeout=2) as r:
                if r.status == 200:
                    print(f"server ready on :{port}", flush=True)
                    return proc, port
        except OSError:
            time.sleep(0.5)
    proc.terminate()
    raise RuntimeError("server did not become ready in 600s")


def run_pipeline(args, port: int) -> dict[str, str]:
    """OCR the evaluation corpus through the pipeline; pdf stem -> text."""
    from karanta_tpu_torch.pipeline.runner import main as pipeline_main

    workspace = os.path.join(args.root, "workspace")
    shutil.rmtree(workspace, ignore_errors=True)  # a fresh queue every run
    eval_pdfs = os.path.join(args.root, "corpus_eval", "pdfs")
    pdfs = sorted(os.path.join(eval_pdfs, f) for f in os.listdir(eval_pdfs))
    pipeline_main([
        workspace,
        "--pdfs", *pdfs,
        "--server", f"http://127.0.0.1:{port}/v1",
        "--workers", str(args.pipeline_workers),
        "--pages_per_group", "8",
        "--max_page_retries", "3",
        "--target_longest_image_dim", "128",
        # the prompt branch FinetuningPrompt took at training time
        "--prompt_key", ("olmo_ocr_system_prompt" if args.text_layer
                         else "olmo_ocr_system_prompt_no_anchor"),
        "--prompt_path", PROMPTS,
        "--markdown",
        "--accept_raw_text",
    ])
    outputs: dict[str, str] = {}
    results_dir = os.path.join(workspace, "results")
    if not os.path.isdir(results_dir):
        # no document survived the failure budget: CER 1.0, not a trace
        print("pipeline produced no result files", flush=True)
        return outputs
    for name in os.listdir(results_dir):
        with open(os.path.join(results_dir, name)) as f:
            for line in f:
                doc = json.loads(line)
                src = os.path.basename(doc["metadata"]["Source-File"])
                outputs[src.removesuffix(".pdf")] = doc["text"]
    return outputs


def score(args, manifest: list[tuple[str, str]], outputs: dict[str, str],
          extra: dict) -> dict:
    from karanta_tpu_torch.bench.scoring import cer, wer

    rows, cers, wers, exact = [], [], [], 0
    for name, truth in manifest:
        got = outputs.get(name, "").strip()
        c, w = cer(truth, got), wer(truth, got)
        cers.append(c)
        wers.append(w)
        exact += got == truth
        rows.append((name, truth, got, c))
    summary = {
        "pages": len(manifest),
        "exact_match": exact,
        "mean_cer": sum(cers) / max(1, len(cers)),
        "mean_wer": sum(wers) / max(1, len(wers)),
    }
    summary.update(extra)
    report = os.path.join(args.root, "report.md")
    with open(report, "w") as f:
        f.write("# Closed-loop demo: train -> serve -> pipeline -> CER\n\n")
        f.write(f"Evaluation pages: {summary['pages']}"
                + (" (training strings)" if args.eval_from_train
                   else " (page texts unseen in training)") + "\n\n")
        f.write(f"- exact match: {exact}/{summary['pages']}\n")
        f.write(f"- mean CER: {summary['mean_cer']:.4f}\n")
        f.write(f"- mean WER: {summary['mean_wer']:.4f}\n")
        if "spec_tokens_per_pass" in summary:
            f.write(f"- speculative tokens/verify-pass: "
                    f"{summary['spec_tokens_per_pass']} "
                    f"({summary['spec_tokens']} tokens / "
                    f"{summary['spec_passes']} passes; plain decode = 1.0)\n")
        if "pipeline_pages_per_sec" in summary:
            f.write(f"- pipeline throughput (timed 2nd pass): "
                    f"{summary['pipeline_pages_per_sec']} pages/s "
                    f"({summary['pages']} pages in "
                    f"{summary['pipeline_elapsed_s']}s)\n")
        f.write("\n| page | truth | pipeline output | CER |\n"
                "|---|---|---|---|\n")
        for name, truth, got, c in rows:
            f.write(f"| {name} | `{truth}` | `{got}` | {c:.3f} |\n")
    with open(os.path.join(args.root, "scores.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(f"report: {report}\n{json.dumps(summary)}", flush=True)
    return summary


def main(argv=None) -> dict:
    args = parse_args(argv)
    args.root = os.path.abspath(args.root)
    # the training config names configs/prompts/*.yaml relative to the repo
    os.chdir(REPO)
    os.makedirs(args.root, exist_ok=True)
    manifest = gen_corpora(args)
    ckpt_dir = train(args)
    proc, port = serve(args, ckpt_dir)
    extra: dict = {}
    try:
        outputs = run_pipeline(args, port)
        if args.time_pipeline:
            t0 = time.time()
            outputs = run_pipeline(args, port)
            elapsed = time.time() - t0
            extra["pipeline_elapsed_s"] = round(elapsed, 3)
            extra["pipeline_pages_per_sec"] = round(len(manifest) / elapsed,
                                                    4)
        if args.speculative_ngram:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/metrics", timeout=5) as r:
                m = json.loads(r.read())
            extra.update({k: m[k] for k in ("spec_passes", "spec_tokens",
                                            "spec_tokens_per_pass")
                          if k in m})
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
    return score(args, manifest, outputs, extra)


if __name__ == "__main__":
    main()
