"""SQLite job/task store for bulk OCR processing.

Keeps the reference's schema shape (bulk_processing/utils/database.py:13-49:
jobs + tasks tables, status indices, attempts counters, julianday-based
processing-time accounting) — it is a good schema. Thread-safe via one
connection per call; SQLite serializes writers.
"""

from __future__ import annotations

import json
import sqlite3
import time
import uuid
from typing import Any, Optional

SCHEMA = """
CREATE TABLE IF NOT EXISTS jobs (
    job_id TEXT PRIMARY KEY,
    created_at REAL NOT NULL,
    total_tasks INTEGER NOT NULL,
    status TEXT NOT NULL DEFAULT 'pending',
    metadata TEXT
);
CREATE TABLE IF NOT EXISTS tasks (
    task_id TEXT PRIMARY KEY,
    job_id TEXT NOT NULL REFERENCES jobs(job_id),
    payload TEXT NOT NULL,
    status TEXT NOT NULL DEFAULT 'pending',
    attempts INTEGER NOT NULL DEFAULT 0,
    created_at REAL NOT NULL,
    started_at REAL,
    completed_at REAL,
    processing_time_ms REAL,
    error TEXT,
    result_path TEXT
);
CREATE INDEX IF NOT EXISTS idx_tasks_job ON tasks(job_id);
CREATE INDEX IF NOT EXISTS idx_tasks_status ON tasks(status);
CREATE INDEX IF NOT EXISTS idx_tasks_job_status ON tasks(job_id, status);
"""

TERMINAL = ("completed", "skipped")


class JobDatabase:
    def __init__(self, db_path: str):
        self.db_path = db_path
        with self._conn() as conn:
            conn.executescript(SCHEMA)

    def _conn(self) -> sqlite3.Connection:
        conn = sqlite3.connect(self.db_path, timeout=30)
        conn.row_factory = sqlite3.Row
        conn.execute("PRAGMA journal_mode=WAL")
        return conn

    # -- jobs ---------------------------------------------------------------

    def create_job(self, requests: list[dict],
                   job_id: Optional[str] = None,
                   metadata: Optional[dict] = None) -> str:
        job_id = job_id or str(uuid.uuid4())
        now = time.time()
        with self._conn() as conn:
            conn.execute(
                "INSERT INTO jobs (job_id, created_at, total_tasks, status,"
                " metadata) VALUES (?, ?, ?, 'pending', ?)",
                (job_id, now, len(requests), json.dumps(metadata or {})))
            conn.executemany(
                "INSERT INTO tasks (task_id, job_id, payload, created_at)"
                " VALUES (?, ?, ?, ?)",
                [(f"{job_id}:{i}", job_id, json.dumps(req), now)
                 for i, req in enumerate(requests)])
        return job_id

    def get_job(self, job_id: str) -> Optional[dict]:
        with self._conn() as conn:
            row = conn.execute("SELECT * FROM jobs WHERE job_id = ?",
                               (job_id,)).fetchone()
            if row is None:
                return None
            counts = dict(conn.execute(
                "SELECT status, COUNT(*) FROM tasks WHERE job_id = ?"
                " GROUP BY status", (job_id,)).fetchall())
        job = dict(row)
        job["status_counts"] = counts
        done = sum(counts.get(s, 0) for s in TERMINAL)
        job["progress"] = done / max(job["total_tasks"], 1)
        return job

    def list_jobs(self) -> list[dict]:
        with self._conn() as conn:
            return [dict(r) for r in conn.execute(
                "SELECT * FROM jobs ORDER BY created_at").fetchall()]

    # -- tasks --------------------------------------------------------------

    def get_pending_tasks(self, job_id: str, max_retries: int = 10,
                          limit: Optional[int] = None) -> list[dict]:
        """pending ∪ (failed & attempts < max_retries)
        (reference database.py:201-222)."""
        query = ("SELECT * FROM tasks WHERE job_id = ? AND (status = 'pending'"
                 " OR (status = 'failed' AND attempts < ?)) ORDER BY task_id")
        if limit:
            query += f" LIMIT {int(limit)}"
        with self._conn() as conn:
            rows = conn.execute(query, (job_id, max_retries)).fetchall()
        return [dict(r) for r in rows]

    def update_task_status(self, task_id: str, status: str,
                           error: Optional[str] = None,
                           result_path: Optional[str] = None) -> None:
        now = time.time()
        sets = ["status = ?"]
        vals: list[Any] = [status]
        if status == "processing":
            sets += ["started_at = ?", "attempts = attempts + 1"]
            vals.append(now)
        if status in ("completed", "failed", "skipped"):
            sets.append("completed_at = ?")
            vals.append(now)
            sets.append("processing_time_ms = (? - COALESCE(started_at, ?))"
                        " * 1000.0")
            vals += [now, now]
        if error is not None:
            sets.append("error = ?")
            vals.append(error[:2000])
        if result_path is not None:
            sets.append("result_path = ?")
            vals.append(result_path)
        vals.append(task_id)
        with self._conn() as conn:
            conn.execute(f"UPDATE tasks SET {', '.join(sets)}"
                         " WHERE task_id = ?", vals)

    def batch_update_tasks(self, updates: list[tuple[str, str]]) -> None:
        """[(task_id, status)] in one transaction
        (reference job_manager.py:72-104)."""
        now = time.time()
        with self._conn() as conn:
            conn.executemany(
                "UPDATE tasks SET status = ?, completed_at = ? WHERE task_id = ?",
                [(status, now, task_id) for task_id, status in updates])

    def get_task(self, task_id: str) -> Optional[dict]:
        with self._conn() as conn:
            row = conn.execute("SELECT * FROM tasks WHERE task_id = ?",
                               (task_id,)).fetchone()
        return dict(row) if row else None

    def get_job_analytics(self, job_id: str) -> dict:
        """avg/min/max processing times + retry counts
        (reference database.py:224-241)."""
        with self._conn() as conn:
            row = conn.execute(
                "SELECT COUNT(*) AS n,"
                " AVG(processing_time_ms) AS avg_ms,"
                " MIN(processing_time_ms) AS min_ms,"
                " MAX(processing_time_ms) AS max_ms,"
                " SUM(CASE WHEN attempts > 1 THEN 1 ELSE 0 END) AS retried"
                " FROM tasks WHERE job_id = ? AND status = 'completed'",
                (job_id,)).fetchone()
        return dict(row) if row else {}
