"""Teacher-LLM client abstraction: completion interface + mock backend.

Parity surface with reference karanta/llm_clients/base.py:11-148:
ModelCompletion records, provider enums with per-provider credential checks,
the abstract BaseLLM.completion(prompt, structured_object, **kwargs) ->
List[ModelCompletion] contract, a ```json fence sanitizer, and MockLLM — the
hermetic fake used by tests and dry runs.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
import re
from abc import ABC, abstractmethod
from typing import Any, List, Optional, Type


@dataclasses.dataclass
class ModelCompletion:
    response: Any
    model: str
    prompt_tokens: int = 0
    completion_tokens: int = 0
    raw: Optional[dict] = None


class GenerationModels(str, enum.Enum):
    GPT_4O = "gpt-4o"
    GPT_41 = "gpt-4.1"
    GPT_5 = "gpt-5"
    GEMINI_PRO = "gemini-1.5-pro"
    CLAUDE_SONNET = "claude-sonnet-4-5"
    MOCK = "mock"


class ModelProvider(str, enum.Enum):
    OPENAI = "openai"
    AZURE = "azure"
    GEMINI = "gemini"
    ANTHROPIC = "anthropic"
    TOGETHER = "together"
    TGI = "tgi"
    MOCK = "mock"


# provider -> required environment variables (reference base.py:73-104)
PROVIDER_ENV_VARS = {
    ModelProvider.OPENAI: ("OPENAI_API_KEY",),
    ModelProvider.AZURE: ("AZURE_OPENAI_API_KEY", "AZURE_OPENAI_ENDPOINT"),
    ModelProvider.GEMINI: ("GEMINI_API_KEY",),
    ModelProvider.ANTHROPIC: ("ANTHROPIC_API_KEY",),
    ModelProvider.TOGETHER: ("TOGETHER_API_KEY",),
    ModelProvider.TGI: ("TGI_ENDPOINT",),
    ModelProvider.MOCK: (),
}

_FENCE_RE = re.compile(r"^```(?:json)?\s*\n?(.*?)\n?```\s*$", re.DOTALL)


def strip_json_fences(text: str) -> str:
    """Remove markdown code fences around JSON payloads
    (reference base.py:106-113)."""
    match = _FENCE_RE.match(text.strip())
    return match.group(1) if match else text


class BaseLLM(ABC):
    """Provider-agnostic completion interface."""

    provider: ModelProvider = ModelProvider.MOCK

    def __init__(self, model: str, check_credentials: bool = True):
        self.model = model
        if check_credentials:
            self.assert_credentials()

    def assert_credentials(self) -> None:
        missing = [v for v in PROVIDER_ENV_VARS.get(self.provider, ())
                   if not os.environ.get(v)]
        if missing:
            raise EnvironmentError(
                f"{self.provider.value} client requires env vars: {missing}")

    @abstractmethod
    def completion(self, prompts: list, structured_object: Optional[Type] = None,
                   **gen_kwargs) -> List[ModelCompletion]:
        """Generate one completion per prompt; parse into structured_object
        (a pydantic model class) when given."""

    def _parse_structured(self, text: str, structured_object: Optional[Type]):
        if structured_object is None:
            return text
        payload = json.loads(strip_json_fences(text))
        return structured_object(**payload)


class MockLLM(BaseLLM):
    """Canned-response fake backend (reference base.py:116-138)."""

    provider = ModelProvider.MOCK

    def __init__(self, model: str = "mock", canned_response: Any = None):
        super().__init__(model, check_credentials=False)
        self.canned_response = canned_response or {
            "primary_language": "en",
            "is_rotation_valid": True,
            "rotation_correction": 0,
            "is_table": False,
            "is_diagram": False,
            "natural_text": "mock transcription",
        }
        self.calls: list = []

    def completion(self, prompts: list, structured_object: Optional[Type] = None,
                   **gen_kwargs) -> List[ModelCompletion]:
        self.calls.append({"prompts": prompts, "kwargs": gen_kwargs})
        out = []
        for _ in prompts:
            if structured_object is not None:
                response = structured_object(**self.canned_response) \
                    if isinstance(self.canned_response, dict) \
                    else self.canned_response
            else:
                response = json.dumps(self.canned_response) \
                    if isinstance(self.canned_response, dict) \
                    else str(self.canned_response)
            out.append(ModelCompletion(response=response, model=self.model,
                                       prompt_tokens=10, completion_tokens=5))
        return out
