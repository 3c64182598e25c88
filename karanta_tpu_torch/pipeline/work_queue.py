"""Crash-safe work distribution over the filesystem.

Native re-implementation of the olmocr WorkQueue/LocalBackend surface the
reference imports (SURVEY.md §2.11; usage karanta/pipeline.py:1265-1357,
594-704): the queue is a zstd-framed CSV of work groups
(workspace/work_index_list.csv.zstd), each group identified by a stable hash;
completion is the existence of results/output_<hash>.jsonl, which makes the
whole pipeline idempotent and resumable across worker crashes.

The index is written as zstd frames of raw (stored) blocks, which every
zstd reader accepts, so writing needs no ``zstandard`` package. Raw and RLE
blocks are read here; a frame with compressed blocks (an index written by
``zstandard``, as the JAX package writes it) is read through ``zstandard``,
and without it raises an ImportError that names the package.
"""

from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import logging
import os
import struct
from typing import Optional, Sequence

logger = logging.getLogger(__name__)

INDEX_NAME = "work_index_list.csv.zstd"
RESULTS_DIR = "results"


_ZSTD_MAGIC = 0xFD2FB528
_ZSTD_BLOCK_MAX = 1 << 17  # 128 KiB, the format's largest block


def zstd_frame(data: bytes) -> bytes:
    """One zstd frame of raw blocks holding ``data`` (RFC 8878): a
    single-segment header with the 8-byte content size, which one-shot
    readers require, and no checksum."""
    out = [struct.pack("<IBQ", _ZSTD_MAGIC, 0xE0, len(data))]
    pos = 0
    while True:
        chunk = data[pos:pos + _ZSTD_BLOCK_MAX]
        pos += len(chunk)
        last = pos >= len(data)
        out.append((last | (len(chunk) << 3)).to_bytes(3, "little") + chunk)
        if last:
            return b"".join(out)


def zstd_decompress(payload: bytes) -> bytes:
    """Content of concatenated zstd frames. Raw and RLE blocks and skippable
    frames are read here; compressed blocks need ``zstandard``."""
    out = bytearray()
    pos = 0
    while pos < len(payload):
        (magic,) = struct.unpack_from("<I", payload, pos)
        if magic & 0xFFFFFFF0 == 0x184D2A50:  # skippable frame
            (size,) = struct.unpack_from("<I", payload, pos + 4)
            pos += 8 + size
            continue
        if magic != _ZSTD_MAGIC:
            raise ValueError("not a zstd frame")
        desc = payload[pos + 4]
        single = bool(desc & 0x20)
        fcs_len = (1 if single else 0, 2, 4, 8)[desc >> 6]
        pos += 5 + (0 if single else 1) + (0, 1, 2, 4)[desc & 3] + fcs_len
        while True:
            header = int.from_bytes(payload[pos:pos + 3], "little")
            btype, size = (header >> 1) & 3, header >> 3
            pos += 3
            if btype == 0:
                out += payload[pos:pos + size]
                pos += size
            elif btype == 1:
                out += payload[pos:pos + 1] * size
                pos += 1
            else:
                return _zstandard_decompress(payload)
            if header & 1:
                break
        pos += 4 if desc & 4 else 0  # content checksum
    return bytes(out)


def _zstandard_decompress(payload: bytes) -> bytes:
    try:
        import zstandard
    except ImportError as exc:
        raise ImportError(
            "this work index holds compressed zstd blocks, which need the "
            "zstandard package (not installed)") from exc
    return zstandard.ZstdDecompressor().decompress(payload)


@dataclasses.dataclass(frozen=True)
class WorkItem:
    hash: str
    work_paths: tuple[str, ...]


def _group_hash(paths: Sequence[str]) -> str:
    return hashlib.sha1(("|".join(paths)).encode()).hexdigest()


class LocalBackend:
    def __init__(self, workspace: str):
        self.workspace = workspace
        self.local_root = workspace      # where --stats/--markdown read/write
        os.makedirs(workspace, exist_ok=True)

    @property
    def index_path(self) -> str:
        return os.path.join(self.workspace, INDEX_NAME)

    @property
    def results_dir(self) -> str:
        return os.path.join(self.workspace, RESULTS_DIR)

    def read_index(self) -> list[tuple[str, ...]]:
        if not os.path.exists(self.index_path):
            return []
        with open(self.index_path, "rb") as f:
            data = zstd_decompress(f.read())
        groups = []
        for line in data.decode("utf-8").splitlines():
            line = line.strip()
            if line:
                groups.append(tuple(p for p in line.split(",") if p))
        return groups

    def write_index(self, groups: list[tuple[str, ...]]) -> None:
        lines = "\n".join(",".join(g) for g in groups).encode("utf-8")
        payload = zstd_frame(lines)
        tmp = self.index_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, self.index_path)

    def output_path(self, group_hash: str) -> str:
        return os.path.join(self.results_dir, f"output_{group_hash}.jsonl")

    def is_done(self, group_hash: str) -> bool:
        return os.path.exists(self.output_path(group_hash))

    def finalize_output(self, group_hash: str, tmp_path: str) -> None:
        os.replace(tmp_path, self.output_path(group_hash))


class WorkQueue:
    """Async multi-worker queue over a LocalBackend."""

    def __init__(self, backend: LocalBackend):
        self.backend = backend
        self._queue: asyncio.Queue[WorkItem] = asyncio.Queue()
        self._outstanding = 0

    def populate_queue(self, paths: Sequence[str], items_per_group: int) -> int:
        """Merge new paths into the index, grouped; returns total groups.

        Already-indexed paths keep their existing groups (stable hashes →
        stable completion markers across invocations; reference
        pipeline.py:1267-1333).
        """
        existing = self.backend.read_index()
        known = {p for g in existing for p in g}
        fresh = sorted(set(paths) - known)
        items_per_group = max(1, items_per_group)
        new_groups = [tuple(fresh[i:i + items_per_group])
                      for i in range(0, len(fresh), items_per_group)]
        groups = existing + new_groups
        if new_groups:
            self.backend.write_index(groups)
        logger.info("work index: %d groups (%d new)", len(groups), len(new_groups))
        return len(groups)

    def initialize_queue(self) -> int:
        """Load pending (not-yet-done) groups into the async queue."""
        os.makedirs(self.backend.results_dir, exist_ok=True)
        pending = 0
        for group in self.backend.read_index():
            h = _group_hash(group)
            if not self.backend.is_done(h):
                self._queue.put_nowait(WorkItem(hash=h, work_paths=group))
                pending += 1
        self._outstanding = pending
        return pending

    @property
    def size(self) -> int:
        return self._queue.qsize()

    @property
    def outstanding(self) -> int:
        return self._outstanding

    async def get_work(self) -> Optional[WorkItem]:
        try:
            return self._queue.get_nowait()
        except asyncio.QueueEmpty:
            return None

    async def mark_done(self, item: WorkItem) -> None:
        # completion is the result file's existence; here we only account
        self._outstanding = max(0, self._outstanding - 1)
        self._queue.task_done()


# ---------------------------------------------------------------------------
# Remote (s3:// / gs://) workspaces.
#
# The reference runs its fleet off S3 workspaces (olmocr S3WorkQueue;
# usage karanta/pipeline.py:1265-1357): same index/results layout as local,
# with object existence as the completion marker. The object store is an
# injectable 3-method client so tests run against an in-memory store and
# the SDKs (boto3 / google-cloud-storage) stay optional.
# ---------------------------------------------------------------------------


class _S3Store:
    def __init__(self, bucket: str):
        try:
            import boto3
        except ImportError as exc:  # pragma: no cover - env without boto3
            raise ImportError("boto3 is required for s3:// workspaces") from exc
        self._client = boto3.client("s3")
        self._bucket = bucket

    def get(self, key: str) -> Optional[bytes]:
        try:
            return self._client.get_object(
                Bucket=self._bucket, Key=key)["Body"].read()
        except self._client.exceptions.NoSuchKey:
            return None

    def put(self, key: str, data: bytes) -> None:
        self._client.put_object(Bucket=self._bucket, Key=key, Body=data)

    def exists(self, key: str) -> bool:
        try:
            self._client.head_object(Bucket=self._bucket, Key=key)
            return True
        except Exception:
            return False


class _GCSStore:
    def __init__(self, bucket: str):
        try:
            from google.cloud import storage
        except ImportError as exc:  # pragma: no cover - env without SDK
            raise ImportError(
                "google-cloud-storage is required for gs:// workspaces"
            ) from exc
        self._bucket = storage.Client().bucket(bucket)

    def get(self, key: str) -> Optional[bytes]:
        blob = self._bucket.blob(key)
        return blob.download_as_bytes() if blob.exists() else None

    def put(self, key: str, data: bytes) -> None:
        self._bucket.blob(key).upload_from_string(data)

    def exists(self, key: str) -> bool:
        return self._bucket.blob(key).exists()


# scheme -> store class; tests swap in an in-memory store here so remote
# workspaces and document fetches run hermetically without cloud SDKs
STORE_FACTORIES: dict[str, type] = {"s3": _S3Store, "gs": _GCSStore}

_STORE_CACHE: dict[tuple[str, str], object] = {}


def get_store(scheme: str, bucket: str):
    """Cached store client for one bucket (one boto3/GCS client per bucket)."""
    key = (scheme, bucket)
    store = _STORE_CACHE.get(key)
    if store is None:
        factory = STORE_FACTORIES.get(scheme)
        if factory is None:
            raise ValueError(f"unsupported object-store scheme: {scheme}")
        store = _STORE_CACHE[key] = factory(bucket)
    return store


def clear_store_cache() -> None:
    _STORE_CACHE.clear()


def fetch_remote_bytes(uri: str, attempts: int = 6,
                       base_delay: float = 1.0) -> bytes:
    """Read one s3://|gs:// object with jittered exponential backoff.

    The pipeline hot path fetches every work document through this
    (reference pipeline.py:456-470 get_s3_bytes_with_backoff). Raises
    FileNotFoundError for a missing object — callers skip those documents —
    and the last transport error once attempts are exhausted.
    """
    import random
    import time

    scheme, rest = uri.split("://", 1)
    bucket, _, key = rest.partition("/")
    store = get_store(scheme, bucket)
    last_exc: Optional[Exception] = None
    for attempt in range(attempts):
        try:
            data = store.get(key)
            if data is None:
                raise FileNotFoundError(uri)
            return data
        except FileNotFoundError:
            raise
        except Exception as exc:
            last_exc = exc
            delay = base_delay * (2 ** attempt) * (0.5 + random.random())
            logger.warning("fetch %s attempt %d failed (%s); sleeping %.1fs",
                           uri, attempt, exc, delay)
            time.sleep(delay)
    raise RuntimeError(f"could not fetch {uri} "
                       f"after {attempts} attempts") from last_exc


class RemoteBackend:
    """Work queue over an object store, LocalBackend-compatible surface.

    output_path() hands workers a local staging path; finalize_output()
    uploads the finished group file and keeps the local copy so --stats
    and --markdown work off the staging mirror.
    """

    def __init__(self, workspace: str, store=None,
                 local_mirror: Optional[str] = None):
        scheme, rest = workspace.split("://", 1)
        bucket, _, prefix = rest.partition("/")
        self.workspace = workspace
        self.prefix = prefix.rstrip("/")
        if store is not None:
            self.store = store
        else:
            self.store = get_store(scheme, bucket)
        self._mirror = local_mirror or os.path.join(
            os.path.expanduser("~/.cache/karanta_tpu_torch/workspaces"),
            hashlib.sha1(workspace.encode()).hexdigest()[:16])
        self.local_root = self._mirror   # --stats/--markdown staging mirror
        os.makedirs(self._mirror, exist_ok=True)

    def _key(self, *parts: str) -> str:
        return "/".join(p for p in (self.prefix,) + parts if p)

    @property
    def index_path(self) -> str:
        return f"{self.workspace}/{INDEX_NAME}"

    @property
    def results_dir(self) -> str:
        return os.path.join(self._mirror, RESULTS_DIR)

    def read_index(self) -> list[tuple[str, ...]]:
        payload = self.store.get(self._key(INDEX_NAME))
        if payload is None:
            return []
        data = zstd_decompress(payload)
        return [tuple(p for p in line.strip().split(",") if p)
                for line in data.decode("utf-8").splitlines() if line.strip()]

    def write_index(self, groups: list[tuple[str, ...]]) -> None:
        lines = "\n".join(",".join(g) for g in groups).encode("utf-8")
        self.store.put(self._key(INDEX_NAME), zstd_frame(lines))

    def output_path(self, group_hash: str) -> str:
        return os.path.join(self.results_dir, f"output_{group_hash}.jsonl")

    def is_done(self, group_hash: str) -> bool:
        return self.store.exists(
            self._key(RESULTS_DIR, f"output_{group_hash}.jsonl"))

    def finalize_output(self, group_hash: str, tmp_path: str) -> None:
        with open(tmp_path, "rb") as f:
            self.store.put(self._key(RESULTS_DIR,
                                     f"output_{group_hash}.jsonl"), f.read())
        os.replace(tmp_path, self.output_path(group_hash))


def make_backend(workspace: str):
    """LocalBackend for plain paths, RemoteBackend for s3:// / gs:// URIs."""
    if "://" in workspace:
        return RemoteBackend(workspace)
    return LocalBackend(workspace)
