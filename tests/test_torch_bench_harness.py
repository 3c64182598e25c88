"""The port's OCR bench harness (``karanta_tpu_torch.bench.convert``, its
runners and ``bench/scoring.py``) and ``inference/single_page.py``, on the
cases of tests/test_bench.py, on the CPU.

The scoring cases hold the same exact values as the JAX package's; the
method-spec parser and the scorer's outputs are compared with the JAX
package's own on the same inputs. The in-process engine method and the
single-page harness run the tiny config (random weights) with
``device=cpu``.
"""

import argparse
import asyncio
import io
import json

import numpy as np
import pytest

from karanta_tpu.bench import scoring as jscoring
from karanta_tpu.bench.convert import parse_method_arg as j_parse_method_arg
from karanta_tpu_torch.bench.convert import (METHOD_REGISTRY,
                                             parse_method_arg, process_pdfs,
                                             resolve_method)
from karanta_tpu_torch.bench.scoring import (cer, edit_distance, load_tests,
                                             run_test, score_method, wer)
from karanta_tpu_torch.pdf.primitives import convert_image_to_pdf_bytes
from tests.fake_server import FakeOpenAIServer


def _pdf(tmp_path, seed, hw=(100, 80)):
    """<tmp>/pdfs/doc.pdf: one JPEG page of seeded noise."""
    from PIL import Image

    pdfs = tmp_path / "pdfs"
    pdfs.mkdir(exist_ok=True)
    rng = np.random.default_rng(seed)
    img = Image.fromarray(rng.integers(150, 255, (*hw, 3), dtype=np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="JPEG")
    path = pdfs / "doc.pdf"
    path.write_bytes(convert_image_to_pdf_bytes(buf.getvalue()))
    return path


@pytest.mark.parametrize("spec", [
    "karanta_pipeline:server=http://x=1:max_page_retries=2:flag=true",
    "server:server=http://127.0.0.1:30024/v1:model=m",
    "karanta_engine:preset=tiny:device=cpu:max_model_len=512",
])
def test_parse_method_arg_matches_jax(spec):
    assert parse_method_arg(spec) == j_parse_method_arg(spec)


def test_parse_method_arg_values():
    name, kwargs = parse_method_arg(
        "karanta_pipeline:server=http://x=1:max_page_retries=2:flag=true")
    assert name == "karanta_pipeline"
    assert kwargs["max_page_retries"] == 2 and kwargs["flag"] is True
    name, kwargs = parse_method_arg(
        "server:server=http://127.0.0.1:30024/v1:model=m")
    assert kwargs == {"server": "http://127.0.0.1:30024/v1", "model": "m"}


def test_parse_rejects_bare_segment():
    with pytest.raises(ValueError, match="key=value"):
        parse_method_arg("karanta_engine:preset=tiny:quantize")


def test_registry_resolves_the_ports_runners():
    for name, spec in METHOD_REGISTRY.items():
        assert spec.startswith("karanta_tpu_torch.bench.runners."), name
        assert callable(resolve_method(name))
    with pytest.raises(KeyError):
        resolve_method("no_such_method")


def test_edit_distance():
    assert edit_distance("kitten", "sitting") == 3
    assert edit_distance("abc", "abc") == 0


def test_present_absent_order():
    out = "The quick brown fox\njumps over the lazy dog."
    cases = [({"type": "present", "text": "brown fox"}, True),
             ({"type": "present", "text": "brwn fox", "max_diffs": 2}, True),
             ({"type": "present", "text": "purple cat"}, False),
             ({"type": "absent", "text": "purple cat"}, True),
             ({"type": "order", "before": "quick", "after": "lazy"}, True),
             ({"type": "order", "before": "lazy", "after": "quick"}, False),
             ({"type": "present", "text": "BROWN", "case_sensitive": False},
              True)]
    for test, want in cases:
        assert run_test(test, out) is want
        assert jscoring.run_test(test, out) is want


def test_cer_wer():
    assert cer("abcd", "abcd") == 0.0
    assert cer("abcd", "abce") == 0.25
    assert wer("a b c d", "a b x d") == 0.25
    for ref, hyp in (("Ọjọ́ ìbí", "Ojo ibi"), ("a b c", "a c"), ("", "x")):
        assert cer(ref, hyp) == jscoring.cer(ref, hyp)
        assert wer(ref, hyp) == jscoring.wer(ref, hyp)


def test_score_method_and_load_tests(tmp_path):
    method_dir = tmp_path / "m"
    method_dir.mkdir()
    (method_dir / "doc_pg1_repeat1.md").write_text("hello world")
    tests = [
        {"pdf": "doc.pdf", "page": 1, "id": "t1", "type": "present",
         "text": "hello"},
        {"pdf": "doc.pdf", "page": 1, "id": "t2", "type": "absent",
         "text": "goodbye"},
        {"pdf": "missing.pdf", "page": 1, "id": "t3", "type": "present",
         "text": "x"},
    ]
    with open(tmp_path / "tests.jsonl", "w") as f:
        for t in tests:
            f.write(json.dumps(t) + "\n")
    loaded = load_tests(str(tmp_path / "tests.jsonl"))
    assert loaded == tests
    score = score_method(str(tmp_path), "m", loaded)
    assert (score.passed, score.total, score.missing_outputs) == (2, 3, 1)
    want = jscoring.score_method(str(tmp_path), "m", loaded)
    assert (score.passed, score.total, score.missing_outputs,
            score.score) == (want.passed, want.total, want.missing_outputs,
                             want.score)


@pytest.mark.parametrize("method", ["karanta_pipeline", "server"])
def test_convert_against_fake_server(tmp_path, method):
    """The pipeline method (process_page's retry ladder) and the raw
    single-call method against an OpenAI-compatible fake server."""
    _pdf(tmp_path, seed=0 if method == "server" else 1)
    server = FakeOpenAIServer()
    kwargs = {"server": None, "target_longest_image_dim": 128}
    if method == "karanta_pipeline":
        kwargs["max_page_retries"] = 2

    async def run():
        await server.start()
        try:
            return await process_pdfs([(method, {**kwargs,
                                                 "server": server.url})],
                                      str(tmp_path), repeats=1,
                                      max_parallel=2)
        finally:
            await server.stop()

    counts = asyncio.run(run())
    assert counts.get(method) == 1
    out = tmp_path / method / "doc_pg1_repeat1.md"
    assert out.read_text() == "Hello from fake model"


def test_engine_method_in_process_on_cpu(tmp_path):
    """karanta_engine:preset=tiny:device=cpu builds the port's engine on the
    CPU and writes the page's text; the outputs score through the port's
    scorer."""
    _pdf(tmp_path, seed=2, hw=(64, 56))
    counts = asyncio.run(process_pdfs(
        [parse_method_arg("karanta_engine:preset=tiny:device=cpu:"
                          "max_model_len=2048:target_longest_image_dim=64")],
        str(tmp_path), repeats=1, max_parallel=1))
    out = tmp_path / "karanta_engine" / "doc_pg1_repeat1.md"
    # random tiny weights may end the page at once (no file) or write text
    assert counts.get("karanta_engine", 0) in (0, 1)
    if counts.get("karanta_engine"):
        text = out.read_text()
        assert text
        score = score_method(str(tmp_path), "karanta_engine", [
            {"pdf": "doc.pdf", "page": 1, "id": "t", "type": "present",
             "text": text[:8]}])
        assert (score.passed, score.total) == (1, 1)


def test_single_page_main_on_cpu(tmp_path, capsys):
    from karanta_tpu_torch.inference import single_page

    pdf = _pdf(tmp_path, seed=3, hw=(64, 56))
    single_page.main(["--pdf", str(pdf), "--preset", "tiny", "--device",
                      "cpu", "--max-tokens", "6", "--max-model-len", "2048",
                      "--target_dim", "64"])
    result = json.loads(capsys.readouterr().out)
    assert result["model"] == "random-qwen2.5-vl-tiny"
    assert 1 <= result["completion_tokens"] <= 6
    assert result["finish_reason"] in ("stop", "length")
    assert result["prompt_tokens"] > 0


def test_engine_from_single_page_namespace():
    """build_engine_from_args takes single_page's namespace, which has no
    --quantize, --tensor-parallel-size or speculation flags: the JAX
    server's defaults fill them in."""
    from karanta_tpu_torch.inference.server import build_engine_from_args

    ns = argparse.Namespace(
        pdf="x.pdf", page=1, model_path=None, native_checkpoint=None,
        tokenizer_path=None, preset="tiny", device="cpu", max_batch_size=1,
        max_model_len=512, decode_chunk=8, max_tokens=4, temperature=0.0)
    engine, name = build_engine_from_args(ns)
    assert name == "random-qwen2.5-vl-tiny"
    assert engine.device.type == "cpu"
    assert (engine.ecfg.quantize, engine.ecfg.kv_quantize,
            engine.ecfg.vision_quant) == (None, None, None)
    assert engine.ecfg.prefix_cache and engine.ecfg.speculative_ngram == 3
    assert (engine.ecfg.max_batch_size, engine.ecfg.max_seq_len,
            engine.ecfg.decode_chunk) == (1, 512, 8)
