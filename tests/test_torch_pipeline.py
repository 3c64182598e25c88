"""The port's OCR pipeline (``karanta_tpu_torch.pipeline``, ``prompts``,
``bench/pipeline_bench.py``) against the JAX package's, on the CPU.

- Prompts: every key of the prompt files renders to the same text.
- Work queue: an index written by either package is read by the other, with
  the same groups, hashes and resume.
- Requests: the same PDF and page give the same request body (the page
  image compared by its pixels: the two PNG encoders pick other filters).
- End to end: the JAX pipeline against the JAX server and the port's
  pipeline against the port's server, both in process on the tiny config
  with the same weights (``from_jax_params``) and greedy decoding, give the
  same Dolma documents.
- Preflight, the render workers' imports and the pipeline bench's JSON line.
"""

import asyncio
import base64
import contextlib
import dataclasses
import glob
import io
import json
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from karanta_tpu.bench import pipeline_bench as j_bench
from karanta_tpu.inference.engine import Engine as JEngine
from karanta_tpu.inference.engine import EngineConfig as JEngineConfig
from karanta_tpu.inference.server import InferenceServer as JServer
from karanta_tpu.inference.tokenizer import ByteTokenizer as JByteTokenizer
from karanta_tpu.models.qwen25_vl.config import tiny_config as j_tiny_config
from karanta_tpu.models.qwen25_vl.model import init_params as j_init_params
from karanta_tpu.pipeline import runner as j_runner
from karanta_tpu.pipeline import work_queue as j_wq
from karanta_tpu.prompts import templates as j_templates
from karanta_tpu_torch import constants
from karanta_tpu_torch.bench import pipeline_bench
from karanta_tpu_torch.inference.engine import Engine, EngineConfig
from karanta_tpu_torch.inference.server import InferenceServer
from karanta_tpu_torch.inference.tokenizer import ByteTokenizer
from karanta_tpu_torch.models.qwen25_vl.config import tiny_config
from karanta_tpu_torch.models.qwen25_vl.convert import from_jax_params
from karanta_tpu_torch.pipeline import preflight, runner
from karanta_tpu_torch.pipeline import work_queue as wq
from karanta_tpu_torch.prompts import templates
from tests.fake_server import FakeOpenAIServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT_FILES = [constants.PROMPT_PATH,
                os.path.join(REPO, "configs", "prompts", "closed_loop.yaml")]
CLOSED_LOOP = PROMPT_FILES[1]


def _pdf(tmp_path, name, seed, h=224, text=None, pages=1):
    """A scanned PDF: one page from the port's synthetic writer (Flate RGB,
    optionally under an invisible text layer), or several pages from the
    repo's test writer."""
    from karanta_tpu_torch.bench.pipeline_bench import make_page_array
    from karanta_tpu_torch.data.synthetic import page_to_pdf_bytes
    from tests.pdf_helpers import make_pdf

    w = int(h * 994 / 1288)
    path = tmp_path / name
    if pages == 1:
        path.write_bytes(page_to_pdf_bytes(make_page_array(seed, h, w),
                                           text_layer=text))
        return str(path)
    # several pages, each one full-page image under an invisible text layer
    path.write_bytes(make_pdf([[(20, 200 - 20 * i, f"page {p} line {i}")
                                for i in range(3)] for p in range(pages)],
                              with_image=True, image_cm="612 0 0 792 0 0",
                              text_render_mode=3))
    return str(path)


# ---------------------------------------------------------------------------
# prompts
# ---------------------------------------------------------------------------

def test_prompt_path_is_the_repo_file():
    assert constants.PROMPT_PATH == j_templates.PROMPT_PATH
    assert os.path.exists(constants.PROMPT_PATH)


@pytest.mark.parametrize("path", PROMPT_FILES, ids=os.path.basename)
def test_prompts_render_like_jax(path):
    with open(path) as f:
        keys = sorted(yaml.safe_load(f))
    assert keys
    for key in keys:
        mine = templates.load_prompt_template(key, path)
        theirs = j_templates.load_prompt_template(key, path)
        for anchor in (None, "", "Page dimensions: 612.0x792.0\n[72x720]A"
                       " line with {braces}, \\n and a trailing newline\n"):
            got = templates.create_vision_message(mine, anchor, "iVBORw0K")
            want = j_templates.create_vision_message(theirs, anchor,
                                                     "iVBORw0K")
            assert got == want, (key, anchor)


# ---------------------------------------------------------------------------
# work queue
# ---------------------------------------------------------------------------

PATHS = [f"/data/doc{i:02d}.pdf" for i in range(7)]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_work_index_crosses_packages(tmp_path, writer):
    """An index written by one package is read by the other: the same
    groups and hashes; a finished group is skipped on resume by both."""
    ws = str(tmp_path / "ws")
    make = {"port": wq, "jax": j_wq}
    write_q = make[writer].WorkQueue(make[writer].LocalBackend(ws))
    assert write_q.populate_queue(PATHS[:5], 2) == 3
    read = {name: m.WorkQueue(m.LocalBackend(ws)) for name, m in make.items()}
    groups = {name: q.backend.read_index() for name, q in read.items()}
    assert groups["port"] == groups["jax"] == [
        tuple(PATHS[0:2]), tuple(PATHS[2:4]), tuple(PATHS[4:5])]
    assert wq._group_hash(PATHS[:2]) == j_wq._group_hash(PATHS[:2])
    # the other package adds paths: old groups keep their hashes
    other = "jax" if writer == "port" else "port"
    assert read[other].populate_queue(PATHS, 2) == 4
    os.makedirs(read["port"].backend.results_dir, exist_ok=True)
    done = wq._group_hash(tuple(PATHS[0:2]))
    with open(read["port"].backend.output_path(done), "w"):
        pass
    pending = {}
    for name, m in make.items():
        q = m.WorkQueue(m.LocalBackend(ws))
        assert q.initialize_queue() == 3
        items = []
        while q.size:
            items.append(asyncio.run(q.get_work()))
        pending[name] = [(it.hash, it.work_paths) for it in items]
    assert pending["port"] == pending["jax"]
    assert done not in {h for h, _ in pending["port"]}


def test_zstd_frames(tmp_path, monkeypatch):
    """The port writes raw-block zstd frames that zstandard reads; it reads
    zstandard's compressed frames through zstandard, and without the
    package raises an ImportError that names it."""
    import zstandard

    for n in (0, 5, (1 << 17) + 3):
        data = bytes(range(256)) * (n // 256) + b"x" * (n % 256)
        assert zstandard.ZstdDecompressor().decompress(
            wq.zstd_frame(data)) == data
        assert wq.zstd_decompress(wq.zstd_frame(data)) == data
    packed = zstandard.ZstdCompressor().compress(b"a.pdf,b.pdf\n" * 500)
    assert wq.zstd_decompress(packed) == b"a.pdf,b.pdf\n" * 500
    monkeypatch.setitem(sys.modules, "zstandard", None)
    with pytest.raises(ImportError, match="zstandard"):
        wq.zstd_decompress(packed)
    # a port-written index needs no zstandard at all
    backend = wq.LocalBackend(str(tmp_path / "ws"))
    backend.write_index([("a.pdf",), ("b.pdf", "c.pdf")])
    assert backend.read_index() == [("a.pdf",), ("b.pdf", "c.pdf")]


# ---------------------------------------------------------------------------
# requests, against the fake server
# ---------------------------------------------------------------------------

def _pixels(url: str) -> np.ndarray:
    b64 = url.split(",", 1)[1]
    with Image.open(io.BytesIO(base64.b64decode(b64))) as img:
        return np.asarray(img)


def _split_image(body: dict):
    body = json.loads(json.dumps(body))
    part = body["messages"][0]["content"][1]["image_url"]
    url = part.pop("url")
    return body, url.split(";", 1)[0], _pixels(url)


def test_page_queries_match_jax(tmp_path, monkeypatch):
    """build_page_query: the same body for the same PDF and page, at every
    rotation, through the render workers' in-thread path."""
    monkeypatch.setenv("KARANTA_RENDER_PROCS", "0")
    pdf = _pdf(tmp_path, "q.pdf", 3, h=300,
               text="layer words " * 30 + "\nsecond line")
    for rotation in (0, 90, 180, 270):
        got = asyncio.run(runner.build_page_query(
            pdf, 1, 256, image_rotation=rotation))
        want = asyncio.run(j_runner.build_page_query(
            pdf, 1, 256, image_rotation=rotation))
        (gb, gmime, gpx), (wb, wmime, wpx) = _split_image(got), \
            _split_image(want)
        assert gb == wb and gmime == wmime == "data:image/png"
        assert gpx.ndim == 2 and np.array_equal(gpx, wpx), rotation
        assert got["speculative"] is True


def _body_key(request: dict) -> str:
    return json.dumps(_split_image(request)[0], sort_keys=True)


def test_fake_server_runs_match_jax(tmp_path, monkeypatch):
    """Both runners against the same scripted server (a 500, then a page
    that asks to be turned by 90 degrees, then JSON pages): the same
    requests, retries, rotations and Dolma documents."""
    monkeypatch.setenv("KARANTA_RENDER_PROCS", "0")
    pdfs = [_pdf(tmp_path, f"d{i}.pdf", 20 + i, h=200) for i in range(2)]
    pdfs.append(_pdf(tmp_path, "two_pages.pdf", 0, pages=2))
    results = {}
    for name, mod in (("jax", j_runner), ("port", runner)):
        server = FakeOpenAIServer()
        calls = []

        def responder(request, idx, server=server, calls=calls):
            calls.append(request)
            if len(calls) == 1:
                return 500, b"boom"
            if len(calls) == 2:
                return 200, server.completion([server.page_json(
                    "sideways", is_rotation_valid=False,
                    rotation_correction=90)])
            return 200, server.completion([server.page_json("recognized")])

        server.responder = responder

        async def run(mod=mod, server=server, name=name):
            await server.start()
            try:
                # one document per group, one worker: the first document
                # meets the 500 and the rotation in both runs
                args = mod.PipelineArgs(
                    workspace=str(tmp_path / f"ws_{name}"), pdfs=pdfs,
                    server=server.url, workers=1, pages_per_group=1,
                    max_page_retries=3, target_longest_image_dim=128,
                    admission_control=False)
                await mod.amain(args)
                return args
            finally:
                await server.stop()

        args = asyncio.run(run())
        docs = [json.loads(line)
                for p in sorted(glob.glob(os.path.join(
                    args.workspace, "results", "*.jsonl")))
                for line in open(p)]
        results[name] = (docs, calls)
    (jdocs, jcalls), (docs, calls) = results["jax"], results["port"]
    assert len(calls) == len(jcalls) == 6
    # the first document's three calls in order (500, rotation, answer);
    # the two-page document's pages may reach the server in either order
    calls = calls[:3] + sorted(calls[3:], key=_body_key)
    jcalls = jcalls[:3] + sorted(jcalls[3:], key=_body_key)
    for got, want in zip(calls, jcalls):
        (gb, _, gpx), (wb, _, wpx) = _split_image(got), _split_image(want)
        assert gb == wb and np.array_equal(gpx, wpx)
    turned = _split_image(calls[2])[2]
    assert turned.shape == _split_image(calls[1])[2].shape[::-1]
    assert docs == jdocs and len(docs) == 3


# ---------------------------------------------------------------------------
# end to end: pipeline + server, in process, tiny config
# ---------------------------------------------------------------------------

ENGINE_KW = dict(max_batch_size=2, max_seq_len=384, decode_chunk=8,
                 prefill_buckets=(128, 256, 384), image_token_buckets=(64,),
                 speculative_ngram=3, prefix_cache=True, prefix_min_tokens=16)


MAX_TOKENS = 24
# These random weights never pick the byte tokenizer's end token, so every
# page would run to MAX_TOKENS and fall back to its anchor text. Greedy
# decoding on them gives "Skkk..." with an odd "X" (token 104) on some
# pages; with that as the end token, those pages finish with "stop" and the
# model's text is what reaches their Dolma documents, while the others fall
# back.
STOP_TOKEN = 104


class _StopTokenizer(ByteTokenizer):
    def __init__(self):
        super().__init__()
        self.eos_token_id = STOP_TOKEN


class _JStopTokenizer(JByteTokenizer):
    def __init__(self):
        super().__init__()
        self.eos_token_id = STOP_TOKEN


@contextlib.contextmanager
def _running(server):
    """Serve on 127.0.0.1 at a free port from an event loop in a thread."""
    loop = asyncio.new_event_loop()
    started = threading.Event()
    holder = {}

    def run():
        asyncio.set_event_loop(loop)
        holder["port"] = loop.run_until_complete(server.start("127.0.0.1", 0))
        started.set()
        loop.run_forever()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    assert started.wait(60)
    try:
        yield holder["port"]
    finally:
        asyncio.run_coroutine_threadsafe(server.stop(), loop).result(60)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(60)
        assert not thread.is_alive()


def _pipeline_docs(mod, server, workspace, pdfs):
    with _running(server) as port:
        args = mod.PipelineArgs(
            workspace=workspace, pdfs=pdfs,
            server=f"http://127.0.0.1:{port}/v1", workers=2,
            max_page_retries=1, max_page_error_rate=1.01,
            target_longest_image_dim=224, prompt_key="olmo_ocr_system_prompt",
            prompt_path=CLOSED_LOOP, accept_raw_text=True,
            admission_control=False, max_output_tokens=MAX_TOKENS)
        asyncio.run(mod.amain(args))
    return sorted((json.loads(line)
                   for p in glob.glob(os.path.join(workspace, "results",
                                                   "*.jsonl"))
                   for line in open(p)),
                  key=lambda d: d["metadata"]["Source-File"])


def test_pipeline_end_to_end_matches_jax(tmp_path, monkeypatch):
    """Three PDFs (one of two pages, two with a text layer) through each
    package's pipeline and server: the same Dolma text, page spans and
    fallback flags, with greedy decoding (the retry ladder's temperatures
    set to 0 in both runners)."""
    monkeypatch.setenv("KARANTA_RENDER_PROCS", "0")
    for mod in (runner, j_runner):
        monkeypatch.setattr(mod, "TEMPERATURE_BY_ATTEMPT", [0.0] * 8)
    pdfs = [_pdf(tmp_path, "a.pdf", 1, text="alpha beta gamma"),
            _pdf(tmp_path, "b.pdf", 2),
            _pdf(tmp_path, "c.pdf", 0, pages=2)]
    jtok = _JStopTokenizer()
    jcfg = j_tiny_config(vocab_size=jtok.vocab_size)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tok = _StopTokenizer()
    cfg = tiny_config(vocab_size=tok.vocab_size)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu", dtype=torch.float32)
    jdocs = _pipeline_docs(
        j_runner, JServer(JEngine(jparams, jcfg, jtok, JEngineConfig(
            dtype=jnp.float32, **ENGINE_KW)), model_name="tiny"),
        str(tmp_path / "ws_jax"), pdfs)
    docs = _pipeline_docs(
        runner, InferenceServer(Engine(params, cfg, tok, EngineConfig(
            dtype=torch.float32, **ENGINE_KW), device="cpu"),
            model_name="tiny"),
        str(tmp_path / "ws_port"), pdfs)
    assert len(docs) == len(jdocs) >= 2
    for got, want in zip(docs, jdocs):
        assert got["text"] == want["text"]
        assert got["attributes"] == want["attributes"]
        assert got["metadata"] == want["metadata"]
    pages = sum(d["metadata"]["pdf-total-pages"] for d in docs)
    fallbacks = sum(d["metadata"]["total-fallback-pages"] for d in docs)
    assert pages >= 3 and fallbacks < pages  # some pages came from the model


# ---------------------------------------------------------------------------
# preflight, render workers, __main__
# ---------------------------------------------------------------------------

def test_check_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.delenv("KARANTA_ALLOW_CPU", raising=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        preflight.check_device(require_accelerator=True)
    preflight.check_device(require_accelerator=False)
    monkeypatch.setenv("KARANTA_ALLOW_CPU", "1")
    preflight.check_device(require_accelerator=True)
    preflight.check_rasterizer()


def test_render_worker_imports_neither_torch_nor_pil():
    """A render worker's imports (render_pool._warm_entry, as the pool runs
    it in each spawned process) load neither torch nor PIL, and running the
    pipeline's __main__ module under another name does nothing."""
    code = (
        "import runpy, sys\n"
        "from karanta_tpu_torch.pipeline import render_pool\n"
        "render_pool._warm_entry()\n"
        "runpy.run_module('karanta_tpu_torch.pipeline.__main__',"
        " run_name='__mp_main__')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'PIL', 'jax', 'karanta_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_server_command_is_the_port():
    args = runner.parse_args(["ws", "--serve-inproc", "--server",
                              "http://127.0.0.1:4321/v1", "--preset",
                              "qwen2.5-vl-7b"])
    cmd = runner._server_cmd(args)
    assert cmd[1:] == ["-m", "karanta_tpu_torch.inference.server", "--port",
                       "4321", "--preset", "qwen2.5-vl-7b"]
    assert dataclasses.asdict(args).keys() == dataclasses.asdict(
        j_runner.parse_args(["ws"])).keys()


# ---------------------------------------------------------------------------
# pipeline bench
# ---------------------------------------------------------------------------

def _bench_args(mod, workspace, **over):
    import argparse

    parser = argparse.ArgumentParser()
    mod.add_args(parser)
    args = parser.parse_args([])
    for k, v in dict(preset="tiny", pages=3, workers=2, batch=2,
                     max_seq_len=256, decode_tokens=8, decode_chunk=8,
                     page_dim=224, image_token_buckets=[16, 64],
                     quantize="none", kv_quantize="none", text_layer=True,
                     prompt_key="olmo_ocr_system_prompt_no_anchor",
                     prompt_path=CLOSED_LOOP, admission_control=False,
                     workspace=str(workspace), **over).items():
        setattr(args, k, v)
    return args


def _json_line(out: str) -> dict:
    return json.loads([ln for ln in out.splitlines()
                       if ln.startswith("{")][-1])


def test_pipeline_bench_line_has_the_jax_keys(tmp_path, capsys,
                                               monkeypatch):
    monkeypatch.setenv("KARANTA_RENDER_PROCS", "0")
    got = pipeline_bench.run(_bench_args(pipeline_bench, tmp_path / "p",
                                         device="cpu"))
    line = _json_line(capsys.readouterr().out)
    assert line == json.loads(json.dumps(got))
    want = j_bench.run(_bench_args(j_bench, tmp_path / "j"))
    capsys.readouterr()
    assert line.keys() == want.keys()
    assert line["detail"].keys() == want["detail"].keys()
    detail = line["detail"]
    assert (detail["backend"], detail["chips"]) == ("cpu", 1)
    assert detail["tunnel_canary_pre"] is None
    assert detail["requests_served"] == 4  # 3 pages and the warm-up
    assert line["unit"] == "pages/s/chip" and line["value"] > 0
    with pytest.raises(SystemExit, match="guided"):
        pipeline_bench.run(_bench_args(pipeline_bench, tmp_path / "t",
                                       device="cpu", teacher_force=True,
                                       guided=True))
