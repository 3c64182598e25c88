"""Model-weight acquisition: local path, s3://, gs://, weka://, or HF hub id.

Reference karanta/pipeline.py:916-952 download_model: resolves the --model
argument to a local directory, downloading from S3/GCS/weka or snapshotting
from the HF hub, with jittered retry backoff. Cloud/hub backends are gated on
their SDKs (boto3 / google-cloud-storage / huggingface_hub); local paths need
nothing.
"""

from __future__ import annotations

import logging
import os
import random
import time
from typing import Optional

logger = logging.getLogger(__name__)

CACHE_ROOT = os.environ.get("KARANTA_MODEL_CACHE",
                            os.path.expanduser("~/.cache/karanta_tpu_torch/models"))


def download_model(model_name_or_path: str, retries: int = 5) -> str:
    """Resolve to a local directory containing the checkpoint."""
    if os.path.isdir(model_name_or_path):
        return model_name_or_path

    for attempt in range(retries):
        try:
            if model_name_or_path.startswith("s3://"):
                return _download_s3(model_name_or_path)
            if model_name_or_path.startswith(("gs://", "weka://")):
                return _download_gcs(model_name_or_path)
            return _download_hf(model_name_or_path)
        except Exception as exc:
            if attempt == retries - 1:
                raise
            delay = (2 ** attempt) + random.uniform(0, 2)
            logger.warning("model download failed (%s); retrying in %.1fs",
                           exc, delay)
            time.sleep(delay)
    raise RuntimeError("unreachable")


def _cache_dir(uri: str) -> str:
    import hashlib

    safe = uri.replace("://", "_").replace("/", "_")[:80]
    digest = hashlib.sha1(uri.encode()).hexdigest()[:8]
    path = os.path.join(CACHE_ROOT, f"{safe}_{digest}")
    os.makedirs(path, exist_ok=True)
    return path


def _download_s3(uri: str) -> str:
    try:
        import boto3
    except ImportError as exc:
        raise ImportError("boto3 is required for s3:// model paths") from exc
    dest = _cache_dir(uri)
    bucket, _, prefix = uri[len("s3://"):].partition("/")
    s3 = boto3.client("s3")
    paginator = s3.get_paginator("list_objects_v2")
    for page in paginator.paginate(Bucket=bucket, Prefix=prefix):
        for obj in page.get("Contents", []):
            rel = os.path.relpath(obj["Key"], prefix)
            local = os.path.join(dest, rel)
            if os.path.exists(local) and \
                    os.path.getsize(local) == obj["Size"]:
                continue
            os.makedirs(os.path.dirname(local), exist_ok=True)
            s3.download_file(bucket, obj["Key"], local)
    return dest


def _download_gcs(uri: str) -> str:
    scheme = uri.split("://")[0]
    try:
        from google.cloud import storage
    except ImportError as exc:
        raise ImportError(
            f"google-cloud-storage is required for {scheme}:// paths") from exc
    dest = _cache_dir(uri)
    bucket_name, _, prefix = uri.split("://", 1)[1].partition("/")
    client = storage.Client()
    for blob in client.list_blobs(bucket_name, prefix=prefix):
        rel = os.path.relpath(blob.name, prefix)
        local = os.path.join(dest, rel)
        if os.path.exists(local) and os.path.getsize(local) == blob.size:
            continue
        os.makedirs(os.path.dirname(local), exist_ok=True)
        blob.download_to_filename(local)
    return dest


def _download_hf(repo_id: str, revision: Optional[str] = None) -> str:
    try:
        from huggingface_hub import snapshot_download
    except ImportError as exc:
        raise ImportError(
            "huggingface_hub is required for hub model ids") from exc
    return snapshot_download(repo_id, revision=revision,
                             cache_dir=os.path.join(CACHE_ROOT, "hf"))
