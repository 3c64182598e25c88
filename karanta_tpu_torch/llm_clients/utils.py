"""Client helpers (reference karanta/llm_clients/utils.py:10-45)."""

from __future__ import annotations

import importlib
import json
from typing import Any, Optional, Type


def resolve_class(dotted_path: str) -> Type:
    """'pkg.module.ClassName' -> class (reference :10-21)."""
    module_path, _, name = dotted_path.rpartition(".")
    module = importlib.import_module(module_path)
    return getattr(module, name)


def json_parse_model_output(text: str) -> Optional[Any]:
    """Extract the first balanced JSON object/array from free-form model
    output (reference :24-45 bracket scanning)."""
    for open_ch, close_ch in (("{", "}"), ("[", "]")):
        start = text.find(open_ch)
        while start >= 0:
            depth = 0
            in_string = False
            escape = False
            for i in range(start, len(text)):
                c = text[i]
                if in_string:
                    if escape:
                        escape = False
                    elif c == "\\":
                        escape = True
                    elif c == '"':
                        in_string = False
                    continue
                if c == '"':
                    in_string = True
                elif c == open_ch:
                    depth += 1
                elif c == close_ch:
                    depth -= 1
                    if depth == 0:
                        try:
                            return json.loads(text[start:i + 1])
                        except json.JSONDecodeError:
                            break
            start = text.find(open_ch, start + 1)
    return None
