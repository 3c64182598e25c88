"""Generate bench test cases from ground-truth transcriptions via teacher LLMs.

Reference surface: configs/prompts/create_tests.yaml + notebooks/
create_tests.ipynb generate text_present/absent/order cases with strict JSON
schemas (karanta/data/utils.py:443-604); scoring runs in bench/scoring.py.

Usage:
  python -m karanta_tpu_torch.bench.create_tests --transcriptions gt/ \
      --output tests.jsonl --provider mock --per-page 3
"""

from __future__ import annotations

import argparse
import glob as globmod
import json
import logging
import os
import re
from typing import Optional

from karanta_tpu_torch.constants import CREATE_TEST_PROMPT_PATH
from karanta_tpu_torch.llm_clients.openai_client import get_client
from karanta_tpu_torch.llm_clients.utils import json_parse_model_output
from karanta_tpu_torch.prompts.templates import load_prompt_template

logger = logging.getLogger(__name__)

PROMPT_KEYS = {
    "present": "text_present_prompt",
    "absent": "text_absent_prompt",
    "order": "text_order_prompt",
}

_PAGE_RE = re.compile(r"_pg(\d+)")


def generate_tests_for_page(client, pdf_name: str, page: int,
                            transcription: str, kinds: list[str],
                            per_page: int = 3,
                            base_text: str = "",
                            prompt_path: Optional[str] = None) -> list[dict]:
    tests: list[dict] = []
    for kind in kinds:
        template = load_prompt_template(
            PROMPT_KEYS[kind], prompt_path or CREATE_TEST_PROMPT_PATH)
        prompt = template.render({
            "num_tests": per_page, "pdf_name": pdf_name, "page": page,
            "transcription": transcription[:12000], "base_text": base_text,
        })
        (completion,) = client.completion([prompt], max_tokens=2000,
                                          temperature=0.2)
        parsed = json_parse_model_output(str(completion.response))
        if not isinstance(parsed, list):
            logger.warning("no test list for %s p%d (%s)", pdf_name, page, kind)
            continue
        for i, item in enumerate(parsed):
            if not isinstance(item, dict):
                continue
            item.setdefault("pdf", pdf_name)
            item.setdefault("page", page)
            item.setdefault("type", kind)
            item.setdefault("id", f"{pdf_name}_pg{page}_{kind}_{i}")
            tests.append(item)
    return tests


def heuristic_tests_for_page(pdf_name: str, page: int, transcription: str,
                             kinds: list[str], per_page: int = 3,
                             seed: int = 0) -> list[dict]:
    """Deterministic offline teacher: derive test cases from the ground
    truth itself (no LLM, no network). present = contiguous word spans from
    the page; absent = spans with words mangled into strings that do not
    occur; order = two spans in reading order. Lets the full
    create_tests -> convert -> scoring loop run hermetically (the LLM
    providers remain the production path)."""
    import random

    rng = random.Random(f"{pdf_name}|{page}|{seed}")
    words = re.sub(r"\s+", " ", transcription).strip().split()
    tests: list[dict] = []

    def span(width: int) -> Optional[tuple[str, int]]:
        if len(words) < width or width <= 0:
            return None
        i = rng.randrange(0, len(words) - width + 1)
        return " ".join(words[i:i + width]), i

    for kind in kinds:
        for t in range(per_page):
            test: Optional[dict] = None
            if kind == "present":
                got = span(min(4, len(words)))
                if got:
                    test = {"type": "present", "text": got[0]}
            elif kind == "absent":
                got = span(min(3, len(words)))
                if got:
                    mangled = " ".join(w[::-1] + "qz" for w in got[0].split())
                    if mangled not in transcription:
                        test = {"type": "absent", "text": mangled}
            elif kind == "order":
                if len(words) >= 4:
                    half = len(words) // 2
                    i = rng.randrange(0, half)
                    j = rng.randrange(half, len(words))
                    width = min(3, half)
                    test = {"type": "order",
                            "before": " ".join(words[i:i + width]),
                            "after": " ".join(words[j:j + width])}
            if test:
                test.update(pdf=pdf_name, page=page, max_diffs=0,
                            id=f"{pdf_name}_pg{page}_{kind}_{t}")
                tests.append(test)
    return tests


def main(argv: Optional[list[str]] = None):
    parser = argparse.ArgumentParser(
        prog="python -m karanta_tpu_torch.bench.create_tests")
    parser.add_argument("--transcriptions", required=True,
                        help="dir of <base>_pg<N>*.md ground-truth files")
    parser.add_argument("--output", required=True)
    parser.add_argument("--provider", default="mock")
    parser.add_argument("--model", default="mock")
    parser.add_argument("--base-url", default=None)
    parser.add_argument("--kinds", nargs="+",
                        default=["present", "absent", "order"])
    parser.add_argument("--per-page", type=int, default=3)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    client = None
    if args.provider != "heuristic":
        kwargs = {}
        if args.base_url:
            kwargs.update(base_url=args.base_url, api_key="-",
                          check_credentials=False)
        client = get_client(args.provider, args.model, **kwargs)

    count = 0
    with open(args.output, "w") as out:
        for path in sorted(globmod.glob(
                os.path.join(args.transcriptions, "*.md"))):
            name = os.path.basename(path)
            match = _PAGE_RE.search(name)
            page = int(match.group(1)) if match else 1
            pdf_name = name.split("_pg")[0] + ".pdf"
            with open(path) as f:
                transcription = f.read()
            if args.provider == "heuristic":
                tests = heuristic_tests_for_page(
                    pdf_name, page, transcription, args.kinds, args.per_page)
            else:
                tests = generate_tests_for_page(
                    client, pdf_name, page, transcription, args.kinds,
                    args.per_page)
            for test in tests:
                out.write(json.dumps(test, ensure_ascii=False) + "\n")
                count += 1
    print(json.dumps({"tests": count}))


if __name__ == "__main__":
    main()
