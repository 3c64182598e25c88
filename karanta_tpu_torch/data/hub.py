"""Language registry + dataset/model hub upload helpers.

Reference surfaces: the Languages enum (karanta/training/utils.py:25-42) and
the HF hub upload helpers with retry (karanta/data/utils.py:114-162). Hub
access is gated on huggingface_hub availability and credentials.
"""

from __future__ import annotations

import enum
import logging
import time
from typing import Optional

logger = logging.getLogger(__name__)


class Languages(str, enum.Enum):
    """Target languages of the karanta corpus (reference utils.py:25-42)."""

    YORUBA = "yoruba"
    HAUSA = "hausa"
    IGBO = "igbo"
    SWAHILI = "swahili"
    AMHARIC = "amharic"
    ZULU = "zulu"
    XHOSA = "xhosa"
    AFRIKAANS = "afrikaans"
    SOMALI = "somali"
    OROMO = "oromo"
    TIGRINYA = "tigrinya"
    ENGLISH = "english"
    FRENCH = "french"


def _require_hub():
    try:
        import huggingface_hub

        return huggingface_hub
    except ImportError as exc:
        raise ImportError(
            "huggingface_hub is required for hub uploads") from exc


def upload_folder_to_hub(local_dir: str, repo_id: str,
                         repo_type: str = "dataset",
                         private: bool = True,
                         retries: int = 5,
                         commit_message: Optional[str] = None) -> str:
    """Upload a local folder to the hub with exponential-backoff retries
    (reference data/utils.py:114-139)."""
    hub = _require_hub()
    api = hub.HfApi()
    api.create_repo(repo_id, repo_type=repo_type, private=private,
                    exist_ok=True)
    for attempt in range(retries):
        try:
            api.upload_folder(
                folder_path=local_dir, repo_id=repo_id, repo_type=repo_type,
                commit_message=commit_message or "upload via karanta-tpu")
            return f"https://huggingface.co/{repo_type}s/{repo_id}"
        except Exception as exc:
            if attempt == retries - 1:
                raise
            delay = 2.0 ** attempt
            logger.warning("hub upload failed (%s); retrying in %.0fs",
                           exc, delay)
            time.sleep(delay)
    raise RuntimeError("unreachable")


def push_model_to_hub(checkpoint_dir: str, repo_id: str,
                      private: bool = True) -> str:
    """Upload a converted model checkpoint directory
    (reference data/utils.py:142-162)."""
    return upload_folder_to_hub(checkpoint_dir, repo_id, repo_type="model",
                                private=private)
