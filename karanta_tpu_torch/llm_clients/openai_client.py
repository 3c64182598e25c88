"""OpenAI-protocol clients: generic HTTP client + Azure variants + TGI +
provider shims (gemini/anthropic/together).

Covers the reference's LiteLLM/Azure/TGI client trio
(karanta/llm_clients/litellm_client.py, azure_client.py:28-154,
tgi_inference_client.py) with one dependency-free implementation: any
OpenAI-compatible endpoint (including the port's own server) via the pipeline's
pool-free HTTP client, with tenacity-style bounded retries and structured
response_format support. The PROVIDER_SHIMS table maps providers without a
bespoke client onto their OpenAI-compat surfaces (base URL + auth-header
template), matching the reference's LiteLLM breadth
(karanta/constants.py:8-25) without the dependency.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
from typing import List, Optional, Type

from karanta_tpu_torch.llm_clients.base import (
    BaseLLM, ModelCompletion, ModelProvider, strip_json_fences,
)
from karanta_tpu_torch.llm_clients.utils import json_parse_model_output
from karanta_tpu_torch.pipeline.http import apost

logger = logging.getLogger(__name__)


def _schema_for(structured_object: Type) -> dict:
    """JSON schema for a structured-output target: pydantic model, a dict
    already shaped as a schema, or a plain class with __annotations__."""
    if isinstance(structured_object, dict):
        return structured_object
    if hasattr(structured_object, "model_json_schema"):
        return structured_object.model_json_schema()
    if hasattr(structured_object, "schema"):
        return structured_object.schema()
    raise TypeError(f"cannot derive a JSON schema from {structured_object!r}")


def pydantic_function_tool(structured_object: Type) -> dict:
    """OpenAI function-tool wrapper around a pydantic schema — the
    reference's old-deployments structured-output workaround
    (karanta/llm_clients/azure_client.py:122: openai.pydantic_function_tool)."""
    schema = _schema_for(structured_object)
    name = getattr(structured_object, "__name__", schema.get("title", "output"))
    return {
        "type": "function",
        "function": {"name": name, "parameters": schema, "strict": True},
    }


class OpenAICompatLLM(BaseLLM):
    """Chat-completions client for any OpenAI-protocol endpoint."""

    provider = ModelProvider.OPENAI

    def __init__(self, model: str, base_url: Optional[str] = None,
                 api_key: Optional[str] = None, max_retries: int = 10,
                 retry_wait_s: float = 20.0, check_credentials: bool = True,
                 extra_headers: Optional[dict] = None):
        self.base_url = (base_url or os.environ.get(
            "OPENAI_BASE_URL", "https://api.openai.com/v1")).rstrip("/")
        self.api_key = api_key or os.environ.get("OPENAI_API_KEY")
        self.max_retries = max_retries
        self.retry_wait_s = retry_wait_s
        self.extra_headers = dict(extra_headers or {})
        super().__init__(model, check_credentials=check_credentials
                         and api_key is None)

    # bearer_auth=False providers (Azure) send the key via extra_headers only
    bearer_auth = True

    def completions_url(self) -> str:
        return f"{self.base_url}/chat/completions"

    def completion(self, prompts: list, structured_object: Optional[Type] = None,
                   **gen_kwargs) -> List[ModelCompletion]:
        return asyncio.run(self.acompletion(prompts, structured_object,
                                            **gen_kwargs))

    async def acompletion(self, prompts: list,
                          structured_object: Optional[Type] = None,
                          **gen_kwargs) -> List[ModelCompletion]:
        tasks = [self._one(p, structured_object, gen_kwargs) for p in prompts]
        return list(await asyncio.gather(*tasks))

    def _apply_structured(self, body: dict, structured_object: Type) -> None:
        """Request-shaping for structured output; subclasses may use the
        function-tool channel instead of response_format."""
        if "response_format" not in body:
            body["response_format"] = {"type": "json_object"}

    def _extract_content(self, message: dict) -> str:
        """Pull the payload text out of the assistant message; the
        function-tool path reads tool_calls[0].function.arguments instead
        (reference azure_client.py:136-141)."""
        tool_calls = message.get("tool_calls")
        if tool_calls:
            return tool_calls[0]["function"]["arguments"]
        return message["content"]

    async def _one(self, prompt, structured_object, gen_kwargs
                   ) -> ModelCompletion:
        messages = (prompt if isinstance(prompt, list)
                    else [{"role": "user", "content": prompt}])
        body = {"model": self.model, "messages": messages, **gen_kwargs}
        if structured_object is not None:
            self._apply_structured(body, structured_object)

        last_error: Exception = RuntimeError("no attempts made")
        for attempt in range(self.max_retries):
            try:
                status, payload = await apost(
                    self.completions_url(), body,
                    api_key=self.api_key if self.bearer_auth else None,
                    extra_headers=self.extra_headers or None)
                if status != 200:
                    raise ValueError(f"status {status}: {payload[:300]!r}")
                data = json.loads(payload)
                message = data["choices"][0]["message"]
                content = self._extract_content(message)
                response = content
                if structured_object is not None:
                    parsed = json_parse_model_output(strip_json_fences(content))
                    if parsed is None:
                        raise ValueError("no JSON found in model output")
                    response = structured_object(**parsed) \
                        if isinstance(parsed, dict) \
                        and not isinstance(structured_object, dict) else parsed
                usage = data.get("usage", {})
                return ModelCompletion(
                    response=response, model=data.get("model", self.model),
                    prompt_tokens=usage.get("prompt_tokens", 0),
                    completion_tokens=usage.get("completion_tokens", 0),
                    raw=data)
            except (ConnectionError, ValueError, json.JSONDecodeError,
                    KeyError, TypeError, IndexError) as exc:
                last_error = exc
                logger.warning("completion attempt %d failed: %s", attempt, exc)
                await asyncio.sleep(min(self.retry_wait_s, 2.0 ** attempt))
        raise last_error


# api versions older than this reject response_format json_schema; the
# reference keeps a whole second client for them (azure_client.py:93-154)
_AZURE_JSON_SCHEMA_MIN_VERSION = "2024-08-01"


class AzureOpenAILLM(OpenAICompatLLM):
    """Azure deployment flavor (reference azure_client.py:28-90): endpoint/
    deployment URL shape, `api-version` as a URL QUERY PARAMETER (Azure
    rejects it in the body), and `api-key:` header auth. For api versions
    older than 2024-08-01-preview, structured output automatically falls
    back to the function-tool channel (reference azure_client.py:99-154)."""

    provider = ModelProvider.AZURE
    bearer_auth = False

    def __init__(self, model: str, deployment: Optional[str] = None,
                 api_version: Optional[str] = None, **kwargs):
        endpoint = os.environ.get("AZURE_OPENAI_ENDPOINT", "").rstrip("/")
        deployment = deployment or model
        base_url = (f"{endpoint}/openai/deployments/{deployment}"
                    if endpoint else None)
        self.api_version = api_version or os.environ.get(
            "AZURE_OPENAI_API_VERSION", "2024-08-01-preview")
        api_key = kwargs.pop("api_key", None) or os.environ.get(
            "AZURE_OPENAI_API_KEY")
        headers = kwargs.pop("extra_headers", None) or {}
        if api_key:
            headers.setdefault("api-key", api_key)
        super().__init__(model, base_url=base_url, api_key=api_key,
                         extra_headers=headers, **kwargs)

    def completions_url(self) -> str:
        return (f"{self.base_url}/chat/completions"
                f"?api-version={self.api_version}")

    def _supports_json_schema(self) -> bool:
        return self.api_version[:10] >= _AZURE_JSON_SCHEMA_MIN_VERSION

    def _apply_structured(self, body: dict, structured_object: Type) -> None:
        if "response_format" in body or "tools" in body:
            return
        if self._supports_json_schema():
            schema = _schema_for(structured_object)
            name = getattr(structured_object, "__name__",
                           schema.get("title", "output"))
            body["response_format"] = {
                "type": "json_schema",
                "json_schema": {"name": name, "schema": schema,
                                "strict": True},
            }
        else:
            body["tools"] = [pydantic_function_tool(structured_object)]
            body["tool_choice"] = "required"


class AzureOldDeploymentsLLM(AzureOpenAILLM):
    """Force the function-tool structured-output channel regardless of
    api_version (reference AzureOldDeployments, azure_client.py:99-154)."""

    def _supports_json_schema(self) -> bool:
        return False


class TGIClient(BaseLLM):
    """HF text-generation-inference client (reference
    tgi_inference_client.py:26-72): chat_completion over the TGI endpoint,
    JSON-substring parsing of responses."""

    provider = ModelProvider.TGI

    def __init__(self, model: str, endpoint: Optional[str] = None,
                 max_retries: int = 5, check_credentials: bool = True):
        self.endpoint = (endpoint or os.environ.get("TGI_ENDPOINT", "")
                         ).rstrip("/")
        self.max_retries = max_retries
        super().__init__(model,
                         check_credentials=check_credentials and not endpoint)

    def completion(self, prompts: list, structured_object: Optional[Type] = None,
                   **gen_kwargs) -> List[ModelCompletion]:
        inner = OpenAICompatLLM(self.model, base_url=f"{self.endpoint}/v1",
                                api_key="-", check_credentials=False,
                                max_retries=self.max_retries)
        results = inner.completion(prompts, None, **gen_kwargs)
        if structured_object is not None:
            for r in results:
                parsed = json_parse_model_output(str(r.response))
                if parsed is not None and isinstance(parsed, dict):
                    r.response = structured_object(**parsed)
        return results


# Providers reached through their OpenAI-compat surfaces: base-URL + auth
# env-var templates. This is the repo's LiteLLM equivalent — the reference
# dispatches gpt-4o/4.1/gemini model names through litellm
# (karanta/llm_clients/litellm_client.py:32-155, constants.py:8-25); we map
# each provider onto the one protocol every modern API exposes.
PROVIDER_SHIMS: dict = {
    "gemini": {
        "provider": ModelProvider.GEMINI,
        "base_url": "https://generativelanguage.googleapis.com/v1beta/openai",
        "env_key": "GEMINI_API_KEY",
    },
    "anthropic": {
        "provider": ModelProvider.ANTHROPIC,
        "base_url": "https://api.anthropic.com/v1",
        "env_key": "ANTHROPIC_API_KEY",
        # Anthropic's OpenAI-compat layer also honors its native headers
        "headers": {"anthropic-version": "2023-06-01"},
    },
    "together": {
        "provider": ModelProvider.TOGETHER,
        "base_url": "https://api.together.xyz/v1",
        "env_key": "TOGETHER_API_KEY",
    },
}


def _make_shim_client(shim: dict, model: str, **kwargs) -> OpenAICompatLLM:
    base_url = kwargs.pop("base_url", None) or shim["base_url"]
    api_key = kwargs.pop("api_key", None) or os.environ.get(shim["env_key"])
    check = kwargs.pop("check_credentials", True)
    if check and not api_key:
        raise EnvironmentError(
            f"{shim['provider'].value} client requires env var"
            f" {shim['env_key']}")
    client = OpenAICompatLLM(model, base_url=base_url, api_key=api_key,
                             check_credentials=False,
                             extra_headers=shim.get("headers"), **kwargs)
    client.provider = shim["provider"]
    return client


def get_client(provider: str, model: str, **kwargs) -> BaseLLM:
    """Factory over provider names (litellm-style dispatch without litellm)."""
    from karanta_tpu_torch.llm_clients.base import MockLLM

    table = {
        "openai": OpenAICompatLLM,
        "azure": AzureOpenAILLM,
        "azure_old": AzureOldDeploymentsLLM,
        "tgi": TGIClient,
        "mock": MockLLM,
    }
    if provider in table:
        return table[provider](model, **kwargs)
    if provider in PROVIDER_SHIMS:
        return _make_shim_client(PROVIDER_SHIMS[provider], model, **kwargs)
    raise ValueError(f"unknown provider {provider!r}; known "
                     f"{list(table) + list(PROVIDER_SHIMS)}")
