"""Qwen chat template + OpenAI-message parsing for the serving engine.

Renders the exact Qwen2-VL ChatML wire format (<|im_start|> blocks,
<|vision_start|><|image_pad|>*N<|vision_end|>) so checkpoints behave as they
do under the reference's vLLM server. Parses the OpenAI-style message lists
built by create_vision_message (reference karanta/data/utils.py:269-297:
role=user, content=[{type:text},{type:image_url,url:data:image/png;base64,..}]).
"""

from __future__ import annotations

import base64
import dataclasses
import re
from typing import Any, Optional

IM_START = "<|im_start|>"
IM_END = "<|im_end|>"
VISION_START = "<|vision_start|>"
VISION_END = "<|vision_end|>"
IMAGE_PAD = "<|image_pad|>"

DEFAULT_SYSTEM = "You are a helpful assistant."

_DATA_URL_RE = re.compile(r"^data:image/(png|jpeg|jpg|webp);base64,(.*)$", re.DOTALL)


@dataclasses.dataclass
class ParsedPrompt:
    """A rendered chat prompt: text with one IMAGE_PAD placeholder per image,
    plus the decoded image bytes in order of appearance."""

    text: str
    images: list[bytes]


# sentinel payload the server substitutes for base64 image data it already
# decoded straight off the request bytes (inference/server.py fast path);
# alphabet-safe for _DATA_URL_RE
RAW_IMAGE_SENTINEL = "KARANTARAW"


def parse_openai_messages(messages: list[dict[str, Any]],
                          system: Optional[str] = DEFAULT_SYSTEM,
                          raw_images: Optional[list[bytes]] = None
                          ) -> ParsedPrompt:
    """Render OpenAI chat messages into the Qwen ChatML prompt string.

    raw_images: pre-decoded image bytes referenced by sentinel data URLs
    (``data:image/png;base64,KARANTARAW<i>``) — lets the HTTP server skip
    JSON-scanning and re-encoding multi-MB base64 payloads."""
    parts: list[str] = []
    images: list[bytes] = []

    has_system = any(m.get("role") == "system" for m in messages)
    if system is not None and not has_system:
        parts.append(f"{IM_START}system\n{system}{IM_END}\n")

    for message in messages:
        role = message.get("role", "user")
        content = message.get("content", "")
        parts.append(f"{IM_START}{role}\n")
        if isinstance(content, str):
            parts.append(content)
        else:
            for item in content:
                itype = item.get("type")
                if itype == "text":
                    parts.append(item.get("text", ""))
                elif itype == "image_url":
                    url = item["image_url"]
                    if isinstance(url, dict):
                        url = url.get("url", "")
                    match = _DATA_URL_RE.match(url)
                    if not match:
                        raise ValueError(
                            "Only data:image/...;base64 image URLs are supported")
                    payload = match.group(2)
                    if (raw_images is not None
                            and payload.startswith(RAW_IMAGE_SENTINEL)):
                        images.append(
                            raw_images[int(payload[len(RAW_IMAGE_SENTINEL):])])
                    else:
                        images.append(base64.b64decode(payload))
                    parts.append(f"{VISION_START}{IMAGE_PAD}{VISION_END}")
                else:
                    raise ValueError(f"Unsupported content type {itype!r}")
        parts.append(f"{IM_END}\n")

    parts.append(f"{IM_START}assistant\n")
    return ParsedPrompt(text="".join(parts), images=images)


def expand_image_pads(token_ids: list[int], image_pad_id: int,
                      tokens_per_image: list[int]) -> list[int]:
    """Replace each single IMAGE_PAD token with N copies (N = merged vision
    tokens for that image), mirroring the HF processor's expansion."""
    out: list[int] = []
    img = 0
    for tid in token_ids:
        if tid == image_pad_id:
            out.extend([tid] * tokens_per_image[img])
            img += 1
        else:
            out.append(tid)
    if img != len(tokens_per_image):
        raise ValueError(
            f"Prompt has {img} image pads but {len(tokens_per_image)} images")
    return out
