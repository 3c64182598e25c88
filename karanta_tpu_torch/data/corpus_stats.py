"""Corpus PDF statistics with resumable state (the port's copy of
``karanta_tpu/data/corpus_stats.py``).

Reference karanta/data/azure_data_stats.py:46-260: scan a blob store of PDFs,
count pages per document, keep md5-keyed resumable JSON state, report
per-folder statistics. Backends: local filesystem (native) and Azure blob
(gated on the azure-storage-blob package). Page counting uses our own reader;
a thread pool parallelizes the I/O-bound scan.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import logging
import os
import threading
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterable, Optional

logger = logging.getLogger(__name__)


class LocalPdfBackend:
    def __init__(self, root: str):
        self.root = Path(root)

    def list_blobs(self) -> Iterable[tuple[str, float]]:
        """yields (relative_path, mtime)."""
        for path in sorted(self.root.rglob("*.pdf")):
            yield str(path.relative_to(self.root)), path.stat().st_mtime

    def read(self, rel_path: str) -> bytes:
        return (self.root / rel_path).read_bytes()


class AzurePdfBackend:
    """Gated on azure-storage-blob; constructor raises a clear error without it."""

    def __init__(self, container: str, connection_string: Optional[str] = None):
        try:
            from azure.storage.blob import BlobServiceClient
        except ImportError as exc:
            raise ImportError(
                "azure-storage-blob is required for AzurePdfBackend; "
                "install it or use LocalPdfBackend") from exc
        conn = connection_string or os.environ["AZURE_STORAGE_CONNECTION_STRING"]
        self._client = BlobServiceClient.from_connection_string(
            conn).get_container_client(container)

    def list_blobs(self):
        for blob in self._client.list_blobs():
            if blob.name.lower().endswith(".pdf"):
                yield blob.name, blob.last_modified.timestamp()

    def read(self, rel_path: str) -> bytes:
        return self._client.download_blob(rel_path).readall()


def blob_key(name: str, mtime: float) -> str:
    """md5(name + mtime) dedup key (reference :93-96)."""
    return hashlib.md5(f"{name}|{mtime}".encode()).hexdigest()


class CorpusAnalyzer:
    def __init__(self, backend, state_path: str, max_workers: int = 8):
        self.backend = backend
        self.state_path = state_path
        self.max_workers = max_workers
        self._lock = threading.Lock()
        self.state: dict = {"processed": {}}
        if os.path.exists(state_path):
            with open(state_path) as f:
                self.state = json.load(f)

    def _save_state(self):
        with self._lock:
            tmp = self.state_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self.state, f)
            os.replace(tmp, self.state_path)

    def _process(self, item: tuple[str, float]) -> None:
        name, mtime = item
        key = blob_key(name, mtime)
        if key in self.state["processed"]:
            return
        from karanta_tpu_torch.pdf.minipdf import PdfDocument

        try:
            pages = PdfDocument.open(self.backend.read(name)).num_pages()
            error = None
        except Exception as exc:
            pages, error = 0, str(exc)[:200]
        with self._lock:
            self.state["processed"][key] = {
                "name": name, "pages": pages, "error": error}

    def run(self, checkpoint_every: int = 100) -> dict:
        todo = [item for item in self.backend.list_blobs()
                if blob_key(*item) not in self.state["processed"]]
        logger.info("%d new PDFs to scan", len(todo))
        with ThreadPoolExecutor(self.max_workers) as pool:
            for i, _ in enumerate(pool.map(self._process, todo)):
                if (i + 1) % checkpoint_every == 0:
                    self._save_state()
        self._save_state()
        return self.folder_stats()

    def folder_stats(self) -> dict:
        """Per-top-level-folder document/page counts (reference :236-260)."""
        stats: dict[str, dict] = defaultdict(
            lambda: {"documents": 0, "pages": 0, "errors": 0})
        for record in self.state["processed"].values():
            folder = record["name"].split("/")[0] if "/" in record["name"] \
                else "."
            stats[folder]["documents"] += 1
            stats[folder]["pages"] += record["pages"]
            if record.get("error"):
                stats[folder]["errors"] += 1
        total = {
            "documents": sum(s["documents"] for s in stats.values()),
            "pages": sum(s["pages"] for s in stats.values()),
            "errors": sum(s["errors"] for s in stats.values()),
        }
        return {"folders": dict(stats), "total": total}


def main(argv: Optional[list[str]] = None):
    parser = argparse.ArgumentParser(
        prog="python -m karanta_tpu_torch.data.corpus_stats")
    parser.add_argument("--root", help="local PDF directory")
    parser.add_argument("--azure-container", default=None)
    parser.add_argument("--state", default="corpus_stats_state.json")
    parser.add_argument("--workers", type=int, default=8)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.azure_container:
        backend = AzurePdfBackend(args.azure_container)
    else:
        backend = LocalPdfBackend(args.root)
    stats = CorpusAnalyzer(backend, args.state, args.workers).run()
    print(json.dumps(stats, indent=2))


if __name__ == "__main__":
    main()
