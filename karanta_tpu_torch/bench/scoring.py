"""Bench scoring: olmOCR-bench-style unit tests over OCR outputs + CER/WER
(the port's copy of ``karanta_tpu/bench/scoring.py``).

The reference generates test cases (text_present / text_absent / text_order /
headers_footers) with teacher LLMs and scores through the external
olmocr-bench layout (SURVEY.md L9). This module provides the scorer natively:
it consumes JSONL test files ({"pdf", "page", "id", "type", ...} matching
prompts/schemas.py) and the <dir>/<method>/<base>_pg<N>_repeat<R>.md outputs
of bench/convert.py, plus plain CER/WER against reference transcriptions.
"""

from __future__ import annotations

import dataclasses
import glob as globmod
import json
import os
import re
import sys
import unicodedata
from typing import Optional

# native C++ kernels (native/fastlev.cpp); build with `make native`
_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
if _NATIVE_DIR not in sys.path:
    sys.path.append(_NATIVE_DIR)
try:
    import fastlev as _fastlev
except ImportError:
    _fastlev = None


def edit_distance(a: str, b: str, limit: Optional[int] = None) -> int:
    """Levenshtein distance (O(len(a)*len(b)), early-exit on limit)."""
    if a == b:
        return 0
    if _fastlev is not None:
        return _fastlev.edit_distance(a, b, -1 if limit is None else limit)
    if len(a) > len(b):
        a, b = b, a
    previous = list(range(len(a) + 1))
    for i, cb in enumerate(b, start=1):
        current = [i]
        row_min = i
        for j, ca in enumerate(a, start=1):
            cost = min(previous[j] + 1, current[j - 1] + 1,
                       previous[j - 1] + (ca != cb))
            current.append(cost)
            row_min = min(row_min, cost)
        if limit is not None and row_min > limit:
            return limit + 1
        previous = current
    return previous[-1]


def _normalize(text: str, case_sensitive: bool = True) -> str:
    text = unicodedata.normalize("NFKC", text)
    text = re.sub(r"\s+", " ", text).strip()
    return text if case_sensitive else text.lower()


def _fuzzy_find(haystack: str, needle: str, max_diffs: int = 0) -> bool:
    """Is `needle` present in `haystack` within `max_diffs` edits?"""
    if max_diffs <= 0:
        return needle in haystack
    if _fastlev is not None:
        return bool(_fastlev.fuzzy_contains(haystack, needle, max_diffs))
    n = len(needle)
    if n == 0:
        return True
    step = max(1, max_diffs)
    for start in range(0, max(1, len(haystack) - n + max_diffs + 1), step):
        window = haystack[start:start + n + max_diffs]
        if edit_distance(window[:n + max_diffs], needle,
                         limit=max_diffs) <= max_diffs:
            return True
    return False


def run_test(test: dict, output_text: str) -> bool:
    """Evaluate one test case against one OCR output."""
    case_sensitive = test.get("case_sensitive", True)
    text = _normalize(output_text, case_sensitive)
    kind = test["type"]
    max_diffs = int(test.get("max_diffs", 0))

    def norm(s):
        return _normalize(s, case_sensitive)

    if kind in ("present", "text_present"):
        return _fuzzy_find(text, norm(test["text"]), max_diffs)
    if kind in ("absent", "text_absent", "headers_footers"):
        return not _fuzzy_find(text, norm(test["text"]), max_diffs)
    if kind in ("order", "text_order"):
        first = text.find(norm(test["before"]))
        second = text.find(norm(test["after"]))
        return first >= 0 and second >= 0 and first < second
    raise ValueError(f"Unknown test type {kind!r}")


@dataclasses.dataclass
class MethodScore:
    method: str
    total: int = 0
    passed: int = 0
    missing_outputs: int = 0

    @property
    def score(self) -> float:
        return self.passed / self.total if self.total else 0.0


def load_tests(tests_path: str) -> list[dict]:
    tests = []
    for path in sorted(globmod.glob(tests_path)):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    tests.append(json.loads(line))
    return tests


def score_method(data_dir: str, method: str, tests: list[dict],
                 repeat: int = 1) -> MethodScore:
    score = MethodScore(method=method)
    for test in tests:
        base = os.path.splitext(os.path.basename(test["pdf"]))[0]
        out_path = os.path.join(
            data_dir, method, f"{base}_pg{test['page']}_repeat{repeat}.md")
        score.total += 1
        if not os.path.exists(out_path):
            score.missing_outputs += 1
            continue
        with open(out_path) as f:
            if run_test(test, f.read()):
                score.passed += 1
    return score


def cer(reference: str, hypothesis: str) -> float:
    """Character error rate (edit distance / reference length)."""
    ref = _normalize(reference)
    hyp = _normalize(hypothesis)
    if not ref:
        return 0.0 if not hyp else 1.0
    return edit_distance(ref, hyp) / len(ref)


def wer(reference: str, hypothesis: str) -> float:
    """Word error rate."""
    ref = _normalize(reference).split()
    hyp = _normalize(hypothesis).split()
    if not ref:
        return 0.0 if not hyp else 1.0
    # Levenshtein over word sequences
    previous = list(range(len(ref) + 1))
    for i, hw in enumerate(hyp, start=1):
        current = [i]
        for j, rw in enumerate(ref, start=1):
            current.append(min(previous[j] + 1, current[j - 1] + 1,
                               previous[j - 1] + (rw != hw)))
        previous = current
    return previous[-1] / len(ref)
