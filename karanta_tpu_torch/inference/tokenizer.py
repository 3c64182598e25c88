"""Tokenizer interface for the serving engine.

Production path wraps the HF fast tokenizer loaded from the local model
directory (the reference gets this implicitly through vLLM). Tests use a
byte-level fake with the same special-token contract, so the whole engine
runs hermetically (SURVEY.md §4: fake backends over network dependencies).
"""

from __future__ import annotations

import re
from typing import Protocol, Sequence

from karanta_tpu_torch.inference.chat import IM_END, IM_START, IMAGE_PAD, VISION_END, VISION_START


class Tokenizer(Protocol):
    eos_token_id: int
    pad_token_id: int
    image_pad_id: int

    def encode(self, text: str) -> list[int]: ...
    def decode(self, ids: Sequence[int]) -> str: ...


class HFTokenizer:
    """Qwen tokenizer from a local checkpoint directory (no network)."""

    def __init__(self, model_path: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(model_path, use_fast=True)
        self.eos_token_id = self._tok.convert_tokens_to_ids(IM_END)
        self.pad_token_id = self._tok.pad_token_id or 0
        self.image_pad_id = self._tok.convert_tokens_to_ids(IMAGE_PAD)
        # total id space incl. added specials (model vocab must cover it)
        self.vocab_size = len(self._tok)

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text, add_special_tokens=False)

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=True)


class ByteTokenizer:
    """Hermetic byte-level tokenizer matching tiny_config's special ids.

    Layout: ids 0..15 reserved for specials; byte b -> id b + 16.
    """

    SPECIALS = {
        IM_START: 3,
        IM_END: 2,
        VISION_START: 8,
        IMAGE_PAD: 9,
        VISION_END: 11,
    }
    OFFSET = 16

    def __init__(self):
        self.eos_token_id = self.SPECIALS[IM_END]
        self.pad_token_id = 0
        self.image_pad_id = self.SPECIALS[IMAGE_PAD]
        self._pattern = re.compile(
            "(" + "|".join(re.escape(s) for s in self.SPECIALS) + ")")
        self._by_id = {v: k for k, v in self.SPECIALS.items()}

    @property
    def vocab_size(self) -> int:
        return self.OFFSET + 256

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for chunk in self._pattern.split(text):
            if not chunk:
                continue
            if chunk in self.SPECIALS:
                ids.append(self.SPECIALS[chunk])
            else:
                ids.extend(b + self.OFFSET for b in chunk.encode("utf-8"))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i - self.OFFSET for i in ids
                     if i >= self.OFFSET and i - self.OFFSET < 256)
        return data.decode("utf-8", errors="replace")
