"""Bulk OCR dispatcher: async fan-out of job tasks across OCR server endpoints.

Replaces the reference's Celery/Redis machinery (bulk_processing/workers/*,
utils/gpu_router.py) with a dependency-free asyncio dispatcher: the "queue
broker" is the SQLite job store; the "GPU router" queries each server's
/metrics endpoint and routes to the least-loaded one (the reference asks Redis
for per-port queue lengths — gpu_router.py:10-20); results are idempotent
per-task JSON files (inference_worker.py:316-321); DB writes are batched
(inference_worker.py:24-254).
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time
from dataclasses import dataclass
from karanta_tpu_torch.bulk.database import JobDatabase
from karanta_tpu_torch.pipeline.http import aget, apost

logger = logging.getLogger("karanta_tpu_torch.bulk")


@dataclass
class ServerEndpoint:
    url: str                      # e.g. http://localhost:30024
    healthy: bool = True
    inflight: int = 0

    @property
    def completions_url(self) -> str:
        return f"{self.url}/v1/chat/completions"


class ServerRouter:
    """Least-loaded routing over N endpoints (replaces the Redis llen router)."""

    def __init__(self, urls: list[str]):
        self.endpoints = [ServerEndpoint(u.rstrip("/")) for u in urls]

    async def refresh_health(self):
        for ep in self.endpoints:
            try:
                status, _ = await aget(f"{ep.url}/health", timeout=5)
                ep.healthy = status == 200
            except ConnectionError:
                ep.healthy = False

    async def get_queue_stats(self) -> dict[str, dict]:
        stats = {}
        for ep in self.endpoints:
            try:
                status, body = await aget(f"{ep.url}/metrics", timeout=5)
                stats[ep.url] = json.loads(body) if status == 200 else {}
            except (ConnectionError, json.JSONDecodeError):
                stats[ep.url] = {}
        return stats

    def best(self) -> ServerEndpoint:
        healthy = [ep for ep in self.endpoints if ep.healthy]
        pool = healthy or self.endpoints
        return min(pool, key=lambda ep: ep.inflight)


class BulkDispatcher:
    def __init__(self, db: JobDatabase, router: ServerRouter,
                 results_dir: str, model: str = "karanta-ocr",
                 concurrency: int = 32, max_retries: int = 10,
                 flush_every: int = 50):
        self.db = db
        self.router = router
        self.results_dir = results_dir
        self.model = model
        self.concurrency = concurrency
        self.max_retries = max_retries
        self.flush_every = flush_every
        self._updates: list[tuple[str, str]] = []
        os.makedirs(results_dir, exist_ok=True)

    def _result_path(self, task_id: str) -> str:
        return os.path.join(self.results_dir,
                            f"{task_id.replace(':', '_')}.json")

    def _flush(self, force: bool = False):
        if self._updates and (force or len(self._updates) >= self.flush_every):
            self.db.batch_update_tasks(self._updates)
            self._updates = []

    async def run_job(self, job_id: str) -> dict:
        """Process all pending tasks of a job to completion."""
        sem = asyncio.Semaphore(self.concurrency)
        await self.router.refresh_health()

        async def one(task: dict):
            async with sem:
                await self._process_task(task)

        round_num = 0
        while True:
            pending = self.db.get_pending_tasks(job_id, self.max_retries)
            if not pending:
                break
            round_num += 1
            logger.info("job %s round %d: %d tasks", job_id, round_num,
                        len(pending))
            await asyncio.gather(*(one(t) for t in pending))
            self._flush(force=True)
            if round_num > self.max_retries + 1:
                break
        self._flush(force=True)
        job = self.db.get_job(job_id)
        logger.info("job %s done: %s", job_id, job["status_counts"])
        return job

    async def _process_task(self, task: dict):
        task_id = task["task_id"]
        result_path = self._result_path(task_id)
        if os.path.exists(result_path):
            # idempotent skip: a previous worker already produced the result
            self._updates.append((task_id, "completed"))
            self._flush()
            return

        self.db.update_task_status(task_id, "processing")
        payload = json.loads(task["payload"])
        request = {
            "model": payload.get("model", self.model),
            "messages": payload["messages"],
            "max_tokens": payload.get("max_tokens", 4000),
            "temperature": payload.get("temperature", 0.0),
        }
        endpoint = self.router.best()
        endpoint.inflight += 1
        start = time.time()
        try:
            status, body = await apost(endpoint.completions_url, request)
            if status != 200:
                raise ValueError(f"status {status}: {body[:300]!r}")
            data = json.loads(body)
            result = {
                "task_id": task_id,
                "custom_id": payload.get("custom_id"),
                "response": data,
                "server": endpoint.url,
                "latency_s": time.time() - start,
            }
            tmp = result_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(result, f, ensure_ascii=False)
            os.replace(tmp, result_path)
            self.db.update_task_status(task_id, "completed",
                                       result_path=result_path)
        except (ConnectionError, ValueError, json.JSONDecodeError,
                KeyError) as exc:
            endpoint.healthy = isinstance(exc, ValueError)  # transport -> down
            self.db.update_task_status(task_id, "failed", error=str(exc))
        finally:
            endpoint.inflight -= 1
