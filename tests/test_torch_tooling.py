"""The port's teacher-LLM clients and request builders (``llm_clients/``,
``prompts/schemas.py``, ``data/create_batch_data_prompts.py``) against the
JAX package's copies: the twins of tests/test_tooling.py's batch-prompt,
client, Azure and shim cases. Where both packages talk to a server, each
talks to its own ``tests/fake_server.py`` and the requests they send (path,
query, headers, body) must be equal; the request files they write from the
same PDFs must be equal, page images compared as pixels.
"""

import asyncio
import base64
import io
import json

import numpy as np
import pytest

from karanta_tpu.llm_clients import base as jbase
from karanta_tpu.llm_clients import openai_client as jclient
from karanta_tpu.llm_clients import utils as jutils
from karanta_tpu.prompts import schemas as jschemas
from karanta_tpu_torch.llm_clients import base as tbase
from karanta_tpu_torch.llm_clients import openai_client as tclient
from karanta_tpu_torch.llm_clients import utils as tutils
from karanta_tpu_torch.prompts import schemas as tschemas
from tests.fake_server import FakeOpenAIServer
from tests.pdf_helpers import make_pdf

PACKAGES = {"jax": (jbase, jclient, jutils, jschemas),
            "torch": (tbase, tclient, tutils, tschemas)}


def _pixels(url: str) -> np.ndarray:
    from PIL import Image

    b64 = url.split(",", 1)[1]
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


def _split_images(obj, images: list):
    """`obj` with every data-URL image replaced by a marker, its pixels
    appended to `images`."""
    if isinstance(obj, dict):
        if obj.get("type") == "image_url":
            images.append(_pixels(obj["image_url"]["url"]))
            return {**obj, "image_url": "<image>"}
        return {k: _split_images(v, images) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_split_images(v, images) for v in obj]
    return obj


@pytest.fixture(scope="module")
def pdf_dir(tmp_path_factory):
    """A scanned (image-only) PDF and a two-page text PDF."""
    from PIL import Image

    from karanta_tpu.pdf.primitives import convert_image_to_pdf_bytes

    root = tmp_path_factory.mktemp("pdfs")
    rng = np.random.default_rng(3)
    img = Image.fromarray(rng.integers(150, 255, (60, 80, 3), np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="JPEG")
    (root / "a.pdf").write_bytes(convert_image_to_pdf_bytes(buf.getvalue()))
    (root / "b.pdf").write_bytes(make_pdf(
        [[(72, 700, "first page text")], [(72, 700, "second page text")]]))
    return root


@pytest.mark.parametrize("flavor", ["openai", "vllm"])
def test_build_requests_equal_jax(pdf_dir, tmp_path, flavor):
    from karanta_tpu.data.create_batch_data_prompts import \
        build_requests as jbuild
    from karanta_tpu_torch.data.create_batch_data_prompts import \
        build_requests as tbuild

    outs = {}
    for name, build in (("jax", jbuild), ("torch", tbuild)):
        out = tmp_path / name
        n = build(str(pdf_dir), str(out), "gpt-4o", flavor=flavor,
                  pages_per_pdf=2, requests_per_file=2, target_dim=128)
        assert n == 3
        outs[name] = {p.name: p.read_text().splitlines()
                      for p in sorted(out.glob("*.jsonl"))}
    assert list(outs["jax"]) == list(outs["torch"]) == [
        "batch_requests_0000.jsonl", "batch_requests_0001.jsonl"]
    for fname, lines in outs["jax"].items():
        for jline, tline in zip(lines, outs["torch"][fname], strict=True):
            jimgs, timgs = [], []
            assert _split_images(json.loads(tline), timgs) == \
                _split_images(json.loads(jline), jimgs)
            assert len(jimgs) == len(timgs) == 1
            np.testing.assert_array_equal(timgs[0], jimgs[0])
    first = json.loads(outs["torch"]["batch_requests_0000.jsonl"][0])
    assert first["custom_id"] == "a_pg1"
    if flavor == "openai":
        assert first["body"]["response_format"]["type"] == "json_schema"


def test_schemas_equal_jax():
    for fn in ("openai_response_format_schema",
               "openai_response_format_schema_multipages",
               "text_present_test_schema", "text_absent_test_schema",
               "text_order_test_schema"):
        assert getattr(tschemas, fn)() == getattr(jschemas, fn)(), fn
    for model in ("PageAnalysis", "PagesAnalysisResponse"):
        assert getattr(tschemas, model).model_json_schema() == \
            getattr(jschemas, model).model_json_schema(), model


def test_fences_and_json_parse_equal_jax():
    cases = ['```json\n{"a": 1}\n```', '{"a": 1}',
             'Sure! Here is the JSON: {"x": [1, 2], "y": "a}b"} trailing',
             "no json here", "[1, {\"k\": \"]\"}] tail"]
    for text in cases:
        assert tbase.strip_json_fences(text) == jbase.strip_json_fences(text)
        assert tutils.json_parse_model_output(text) == \
            jutils.json_parse_model_output(text)
    assert tutils.json_parse_model_output(
        'Sure! Here is the JSON: {"x": [1, 2], "y": "a}b"} trailing') == \
        {"x": [1, 2], "y": "a}b"}


def test_mock_llm_structured():
    llm = tbase.MockLLM()
    (completion,) = llm.completion(["read this"],
                                   structured_object=tschemas.PageAnalysis)
    assert isinstance(completion.response, tschemas.PageAnalysis)
    assert completion.response.natural_text == "mock transcription"
    assert llm.calls


def _both(responder, call):
    """call(pkg modules, port) against a fake server of its own, for each
    package: {name: (result, raw requests)}."""
    out = {}
    for name, mods in PACKAGES.items():
        server = FakeOpenAIServer(responder)

        async def run():
            port = await server.start()
            try:
                return await call(mods, port)
            finally:
                await server.stop()

        result = asyncio.run(run())
        out[name] = (result, server.raw_calls)
    return out


def _same_requests(out):
    """Both packages sent the same requests (path, query, headers, body;
    the Host header names each server's own port)."""
    def strip(raw):
        return [{**r, "headers": {k: v for k, v in r["headers"].items()
                                  if k != "host"}} for r in raw]

    assert strip(out["torch"][1]) == strip(out["jax"][1])
    assert out["torch"][1]


def test_openai_compat_request_equals_jax():
    async def call(mods, port):
        llm = mods[1].OpenAICompatLLM(
            "fake", base_url=f"http://127.0.0.1:{port}/v1", api_key="k",
            max_retries=2)
        return await llm.acompletion(["hello"], structured_object=None,
                                     max_tokens=8)

    out = _both(None, call)
    _same_requests(out)
    (completion,) = out["torch"][0]
    assert "natural_text" in completion.response
    assert completion.completion_tokens == 20


def test_structured_request_equals_jax():
    async def call(mods, port):
        llm = mods[1].OpenAICompatLLM(
            "fake", base_url=f"http://127.0.0.1:{port}/v1", api_key="k",
            max_retries=1)
        return await llm.acompletion(["read"],
                                     structured_object=mods[3].PageAnalysis)

    out = _both(lambda req, i: (200, FakeOpenAIServer.completion(
        FakeOpenAIServer.page_json("structured"))), call)
    _same_requests(out)
    (completion,) = out["torch"][0]
    assert isinstance(completion.response, tschemas.PageAnalysis)
    assert completion.response.natural_text == "structured"


def test_factory_and_credential_gate(monkeypatch):
    assert isinstance(tclient.get_client("mock", "m"), tbase.MockLLM)
    with pytest.raises(ValueError):
        tclient.get_client("nope", "m")
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    with pytest.raises(EnvironmentError):
        tclient.OpenAICompatLLM("gpt-4o")
    # a local server needs no key when the caller says so
    llm = tclient.get_client("openai", "m", base_url="http://127.0.0.1:1/v1",
                             api_key="dummy")
    assert llm.base_url == "http://127.0.0.1:1/v1"


@pytest.mark.parametrize("api_version,structured", [
    ("2024-10-21", False), ("2024-08-01-preview", True),
    ("2024-02-01", True)])
def test_azure_request_equals_jax(monkeypatch, api_version, structured):
    """The Azure URL and auth shape and the structured-output channel
    (json_schema on new API versions, a function tool on old ones)."""
    monkeypatch.setenv("AZURE_OPENAI_API_KEY", "sekret")

    def responder(req, i):
        if "tools" in req:
            args = json.dumps(FakeOpenAIServer.page_json("tooled"))
            return 200, {
                "id": "fake-1", "object": "chat.completion", "model": "fake",
                "choices": [{"index": 0, "message": {
                    "role": "assistant", "content": None,
                    "tool_calls": [{"id": "c1", "type": "function",
                                    "function": {"name": "PageAnalysis",
                                                 "arguments": args}}]},
                    "finish_reason": "tool_calls"}],
                "usage": {"prompt_tokens": 5, "completion_tokens": 9,
                          "total_tokens": 14}}
        return 200, FakeOpenAIServer.completion(
            FakeOpenAIServer.page_json())

    async def call(mods, port):
        monkeypatch.setenv("AZURE_OPENAI_ENDPOINT", f"http://127.0.0.1:{port}")
        llm = mods[1].AzureOpenAILLM("gpt-4o", deployment="dep1",
                                     api_version=api_version, max_retries=1)
        return await llm.acompletion(
            ["hi"], max_tokens=4,
            structured_object=mods[3].PageAnalysis if structured else None)

    out = _both(responder, call)
    _same_requests(out)
    raw = out["torch"][1][0]
    assert raw["path"] == "/openai/deployments/dep1/chat/completions"
    assert raw["query"] == f"api-version={api_version}"
    assert raw["headers"].get("api-key") == "sekret"
    assert "api-version" not in json.loads(raw["body"])
    if structured:
        (completion,) = out["torch"][0]
        assert isinstance(completion.response, tschemas.PageAnalysis)


def test_azure_old_forces_tools_even_on_new_api(monkeypatch):
    monkeypatch.setenv("AZURE_OPENAI_API_KEY", "k")
    monkeypatch.setenv("AZURE_OPENAI_ENDPOINT", "http://x")
    bodies = []
    for mods in PACKAGES.values():
        llm = mods[1].AzureOldDeploymentsLLM(
            "gpt-4o", api_version="2025-01-01-preview")
        body = {"model": "m", "messages": []}
        llm._apply_structured(body, mods[3].PageAnalysis)
        assert "tools" in body and "response_format" not in body
        bodies.append(body)
    assert bodies[0] == bodies[1]


def test_provider_shims_equal_jax(monkeypatch):
    monkeypatch.setenv("GEMINI_API_KEY", "g")
    monkeypatch.setenv("ANTHROPIC_API_KEY", "a")
    monkeypatch.setenv("TOGETHER_API_KEY", "t")
    for provider, model in (("gemini", "gemini-1.5-pro"),
                            ("anthropic", "claude-sonnet-4-5"),
                            ("together", "llama-3.1-70b")):
        got = tclient.get_client(provider, model)
        want = jclient.get_client(provider, model)
        assert got.base_url == want.base_url
        assert got.extra_headers == want.extra_headers
    assert "generativelanguage.googleapis.com" in \
        tclient.get_client("gemini", "gemini-1.5-pro").base_url
    monkeypatch.delenv("GEMINI_API_KEY", raising=False)
    with pytest.raises(EnvironmentError):
        tclient.get_client("gemini", "gemini-1.5-pro")


def test_shim_request_equals_jax():
    async def call(mods, port):
        llm = mods[1].get_client("anthropic", "claude-sonnet-4-5",
                                 api_key="sk-ant", max_retries=1,
                                 base_url=f"http://127.0.0.1:{port}/v1")
        return await llm.acompletion(["hello"], max_tokens=4)

    out = _both(None, call)
    _same_requests(out)
    raw = out["torch"][1][0]
    assert raw["headers"].get("authorization") == "Bearer sk-ant"
    assert raw["headers"].get("anthropic-version")


def _same_bodies_up_to_pixels(out):
    """Both packages sent the same requests; page images compared as
    pixels (the two renderers encode PNGs in their own way)."""
    tcalls, jcalls = out["torch"][1], out["jax"][1]
    assert len(tcalls) == len(jcalls) >= 1
    for t, j in zip(tcalls, jcalls):
        assert (t["method"], t["path"], t["query"]) == \
            (j["method"], j["path"], j["query"])
        timgs, jimgs = [], []
        assert _split_images(json.loads(t["body"]), timgs) == \
            _split_images(json.loads(j["body"]), jimgs)
        for a, b in zip(timgs, jimgs, strict=True):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("structured", [False, True])
def test_prompt_tester_against_a_server_equals_jax(pdf_dir, structured):
    """data/test_prompts.py through get_client("openai", base_url=...): the
    same request as the JAX tool's and the same result (the answer as text,
    or parsed into PageAnalysis)."""
    from karanta_tpu.data.test_prompts import run_prompt_test as jrun
    from karanta_tpu_torch.data.test_prompts import run_prompt_test as trun

    runs = {"jax": jrun, "torch": trun}
    answer = (FakeOpenAIServer.page_json("parsed") if structured
              else "plain text, not JSON")

    async def call(mods, port):
        name = "jax" if mods[1] is jclient else "torch"
        return await asyncio.to_thread(
            runs[name], str(pdf_dir / "b.pdf"), 2, "openai", "karanta-ocr",
            base_url=f"http://127.0.0.1:{port}/v1", structured=structured,
            target_dim=128)

    out = _both(lambda req, i: (200, FakeOpenAIServer.completion(answer)),
                call)
    _same_bodies_up_to_pixels(out)
    assert out["torch"][0] == out["jax"][0]
    assert out["torch"][0]["response"] == answer


@pytest.mark.parametrize("provider", ["openai", "heuristic"])
def test_create_tests_equals_jax(tmp_path, provider):
    """bench/create_tests.py over two transcriptions, through a server (the
    teacher's answer: a JSON list of tests) or the offline heuristic: the
    same requests and the same tests file as the JAX tool's."""
    from karanta_tpu.bench.create_tests import main as jmain
    from karanta_tpu_torch.bench.create_tests import main as tmain

    gt = tmp_path / "gt"
    gt.mkdir()
    (gt / "doc_pg1.md").write_text("Ọ̀rọ̀ àkọ́kọ́ ni èyí . the second line")
    (gt / "doc_pg2.md").write_text("alpha beta gamma delta epsilon zeta")
    answer = json.dumps([{"type": "present", "text": "alpha beta"},
                         {"type": "absent", "text": "omega"}])
    mains = {"jax": jmain, "torch": tmain}

    async def call(mods, port):
        name = "jax" if mods[1] is jclient else "torch"
        argv = ["--transcriptions", str(gt), "--output",
                str(tmp_path / f"{name}.jsonl"), "--provider", provider,
                "--kinds", "present", "absent", "--per-page", "2"]
        if provider == "openai":
            argv += ["--model", "karanta-ocr", "--base-url",
                     f"http://127.0.0.1:{port}/v1"]
        await asyncio.to_thread(mains[name], argv)

    out = _both(lambda req, i: (200, FakeOpenAIServer.completion(answer)),
                call)
    got = (tmp_path / "torch.jsonl").read_text().splitlines()
    assert got == (tmp_path / "jax.jsonl").read_text().splitlines()
    if provider == "openai":
        _same_requests(out)
        assert len(out["torch"][1]) == 4  # two pages x two kinds
        # json_parse_model_output takes the first balanced {...} before any
        # [...], so a list of test objects parses as its first object and
        # no test is kept, in both packages
        assert got == []
    else:
        assert len(got) >= 4
