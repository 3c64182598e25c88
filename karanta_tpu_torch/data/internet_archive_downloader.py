"""Internet Archive language-filtered PDF downloader.

Reference scripts/internet_archive_downloader.py:11-194: searches archive.org
for documents in target (African) languages, downloads PDFs with a process
pool, falls back to derived PDFs, and keeps a download log. Network + the
`internetarchive` package are gated: module imports cleanly everywhere, the
download path raises a clear error when the dependency is missing.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from multiprocessing import Pool
from typing import Optional

logger = logging.getLogger(__name__)

# language name -> archive.org language query values (reference :11-32)
LANGUAGE_MAP = {
    "yoruba": ["yoruba", "yor"],
    "hausa": ["hausa", "hau"],
    "igbo": ["igbo", "ibo"],
    "swahili": ["swahili", "swa"],
    "amharic": ["amharic", "amh"],
    "zulu": ["zulu", "zul"],
    "xhosa": ["xhosa", "xho"],
    "afrikaans": ["afrikaans", "afr"],
    "somali": ["somali", "som"],
    "oromo": ["oromo", "orm"],
    "tigrinya": ["tigrinya", "tir"],
}


def _require_ia():
    try:
        import internetarchive  # noqa: F401

        return internetarchive
    except ImportError as exc:
        raise ImportError(
            "the `internetarchive` package (and network access) is required "
            "for archive.org downloads") from exc


def search_identifiers(language: str, max_items: int = 1000) -> list[str]:
    ia = _require_ia()
    values = LANGUAGE_MAP.get(language.lower(), [language.lower()])
    lang_query = " OR ".join(f'language:"{v}"' for v in values)
    query = f"({lang_query}) AND mediatype:texts AND format:PDF"
    results = ia.search_items(query)
    out = []
    for item in results:
        out.append(item["identifier"])
        if len(out) >= max_items:
            break
    return out


def download_one(task: tuple[str, str]) -> Optional[str]:
    identifier, out_dir = task
    ia = _require_ia()
    try:
        item = ia.get_item(identifier)
        pdfs = [f for f in item.files if f["name"].lower().endswith(".pdf")]
        if not pdfs:
            return None
        # prefer original PDFs, fall back to derived ones (reference behavior)
        original = [f for f in pdfs if f.get("source") == "original"]
        chosen = (original or pdfs)[0]["name"]
        item.download(files=[chosen], destdir=out_dir, no_directory=False,
                      retries=3)
        return os.path.join(out_dir, identifier, chosen)
    except Exception:
        logger.exception("download failed for %s", identifier)
        return None


def download_language(language: str, out_dir: str, max_items: int = 100,
                      workers: int = 4) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    log_path = os.path.join(out_dir, "download_log.json")
    log = {"language": language, "downloaded": [], "failed": []}
    if os.path.exists(log_path):
        with open(log_path) as f:
            log = json.load(f)
    done = set(log["downloaded"]) | set(log["failed"])

    identifiers = [i for i in search_identifiers(language, max_items)
                   if i not in done]
    with Pool(workers) as pool:
        results = pool.map(download_one,
                           [(ident, out_dir) for ident in identifiers])
    for identifier, path in zip(identifiers, results):
        (log["downloaded"] if path else log["failed"]).append(identifier)
    with open(log_path, "w") as f:
        json.dump(log, f, indent=2)
    return log


def main(argv: Optional[list[str]] = None):
    parser = argparse.ArgumentParser(
        prog="python -m karanta_tpu_torch.data.internet_archive_downloader")
    parser.add_argument("--language", required=True,
                        choices=sorted(LANGUAGE_MAP))
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--max_items", type=int, default=100)
    parser.add_argument("--workers", type=int, default=4)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    log = download_language(args.language, args.output_dir, args.max_items,
                            args.workers)
    print(json.dumps({"downloaded": len(log["downloaded"]),
                      "failed": len(log["failed"])}))


if __name__ == "__main__":
    main()
