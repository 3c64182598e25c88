"""Bulk OCR CLI: batch JSONL request files -> OCR servers -> results.

Preserves the reference's CLI shape (bulk_processing/main.py:63-145:
--input dir of *.jsonl request files, --output dir, server endpoints, resume
via <output>/<stem>/job_id.txt) while replacing Celery/Redis with the native
asyncio dispatcher (bulk/dispatcher.py).

Request-file format: one JSON object per line with OpenAI-style fields
{"custom_id": ..., "messages"/"body": {...}} — the formats emitted by
data/create_batch_data_prompts.py.

Usage:
  python -m karanta_tpu_torch.bulk.main --input reqs/ --output out/ \
      --servers http://localhost:30024 http://localhost:30025
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
from pathlib import Path
from typing import Optional

from karanta_tpu_torch.bulk.database import JobDatabase
from karanta_tpu_torch.bulk.dispatcher import BulkDispatcher, ServerRouter

logger = logging.getLogger("karanta_tpu_torch.bulk.main")


def normalize_request(obj: dict) -> dict:
    """Accept both the OpenAI batch format ({"custom_id", "body": {...}}) and
    bare chat bodies ({"messages": [...]})."""
    if "body" in obj:
        body = dict(obj["body"])
        body["custom_id"] = obj.get("custom_id")
        return body
    return obj


def load_requests(path: str) -> list[dict]:
    requests = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                requests.append(normalize_request(json.loads(line)))
    return requests


async def process_file(input_file: Path, output_root: Path, db: JobDatabase,
                       dispatcher: BulkDispatcher) -> dict:
    job_dir = output_root / input_file.stem
    job_dir.mkdir(parents=True, exist_ok=True)
    job_id_file = job_dir / "job_id.txt"

    if job_id_file.exists():
        job_id = job_id_file.read_text().strip()
        if db.get_job(job_id) is None:
            job_id = None
    else:
        job_id = None

    if job_id is None:
        requests = load_requests(str(input_file))
        if not requests:
            logger.warning("no requests in %s", input_file)
            return {}
        job_id = db.create_job(requests,
                               metadata={"source": str(input_file)})
        job_id_file.write_text(job_id)
        logger.info("created job %s for %s (%d tasks)", job_id, input_file,
                    len(requests))
    else:
        logger.info("resuming job %s for %s", job_id, input_file)

    dispatcher.results_dir = str(job_dir / "results")
    os.makedirs(dispatcher.results_dir, exist_ok=True)
    return await dispatcher.run_job(job_id)


async def amain(args) -> list[dict]:
    output_root = Path(args.output)
    output_root.mkdir(parents=True, exist_ok=True)
    db = JobDatabase(str(output_root / "batch_jobs.db"))
    router = ServerRouter(args.servers)
    dispatcher = BulkDispatcher(
        db, router, str(output_root / "results"), model=args.model_name,
        concurrency=args.concurrency, max_retries=args.max_retries)

    input_files = sorted(Path(args.input).glob("*.jsonl"))
    if not input_files:
        raise SystemExit(f"no *.jsonl files under {args.input}")
    jobs = []
    for input_file in input_files:
        jobs.append(await process_file(input_file, output_root, db, dispatcher))
    return jobs


def parse_args(argv: Optional[list[str]] = None):
    parser = argparse.ArgumentParser(prog="python -m karanta_tpu_torch.bulk.main")
    parser.add_argument("--input", required=True,
                        help="directory of *.jsonl request files")
    parser.add_argument("--output", required=True)
    parser.add_argument("--servers", nargs="+",
                        default=["http://localhost:30024"])
    parser.add_argument("--ports", nargs="*", type=int, default=None,
                        help="alternative to --servers: localhost ports")
    parser.add_argument("--model-name", default="karanta-ocr")
    parser.add_argument("--concurrency", type=int, default=32)
    parser.add_argument("--max-retries", type=int, default=10)
    args = parser.parse_args(argv)
    if args.ports:
        args.servers = [f"http://localhost:{p}" for p in args.ports]
    return args


def main(argv: Optional[list[str]] = None):
    logging.basicConfig(level=logging.INFO)
    return asyncio.run(amain(parse_args(argv)))


if __name__ == "__main__":
    main()
