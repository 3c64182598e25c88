"""The port's OpenAI server, in process on the CPU at the tiny config, against
the JAX package's server.

Both servers run the product defaults (n-gram speculation, prefix caching)
over the same weights (the JAX init through ``from_jax_params``), float32,
and answer the same requests over HTTP (the standard library's client), so
their completion texts must be equal.
"""

import asyncio
import base64
import contextlib
import http.client
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karanta_tpu.inference.engine import Engine as JEngine
from karanta_tpu.inference.engine import EngineConfig as JEngineConfig
from karanta_tpu.inference.server import InferenceServer as JServer
from karanta_tpu.inference.server import extract_data_images as j_extract
from karanta_tpu.inference.server import make_arg_parser as j_parser
from karanta_tpu.inference.tokenizer import ByteTokenizer as JByteTokenizer
from karanta_tpu.models.qwen25_vl.config import tiny_config as j_tiny_config
from karanta_tpu.models.qwen25_vl.model import init_params as j_init_params
from karanta_tpu_torch.inference import server as S
from karanta_tpu_torch.inference.engine import Engine, EngineConfig
from karanta_tpu_torch.inference.tokenizer import ByteTokenizer
from karanta_tpu_torch.models.qwen25_vl.config import tiny_config
from karanta_tpu_torch.models.qwen25_vl.convert import from_jax_params
from karanta_tpu_torch.ops.png import encode_png_rgb

ENGINE_KW = dict(max_batch_size=2, max_seq_len=256, decode_chunk=8,
                 prefill_buckets=(64, 128, 256), image_token_buckets=(16, 64),
                 speculative_ngram=3, prefix_cache=True, prefix_min_tokens=16)
INSTRUCTION = "Read the page as plain text, keep every diacritic. "


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


def _call(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    data = body if body is None or isinstance(body, bytes) else \
        json.dumps(body).encode()
    conn.request(method, path, body=data,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    return resp.status, raw


def _png_b64(seed):
    page = np.random.default_rng(seed).integers(0, 255, (56, 56, 3),
                                                dtype=np.uint8)
    return base64.b64encode(encode_png_rgb(page)).decode()


def _body(text, image_seed=None, max_tokens=12, **extra):
    content = [{"type": "text", "text": INSTRUCTION + text}]
    if image_seed is not None:
        content.append({"type": "image_url", "image_url": {
            "url": f"data:image/png;base64,{_png_b64(image_seed)}"}})
    return {"model": "karanta-ocr", "max_tokens": max_tokens,
            "temperature": 0.0,
            "messages": [{"role": "user", "content": content}], **extra}


def _completions(port, bodies):
    """POST the bodies concurrently; returns the parsed responses in order."""
    out = [None] * len(bodies)

    def post(i):
        status, raw = _call(port, "POST", "/v1/chat/completions", bodies[i])
        assert status == 200, raw
        out[i] = json.loads(raw)

    threads = [threading.Thread(target=post, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    return out


@contextlib.contextmanager
def _server_pair(**engine_kw):
    """The JAX server and the port's, over the same weights, running."""
    jtok = JByteTokenizer()
    jcfg = j_tiny_config(vocab_size=jtok.vocab_size)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    jserver = JServer(JEngine(jparams, jcfg, jtok,
                              JEngineConfig(dtype=jnp.float32, **engine_kw)),
                      model_name="tiny-test")
    tok = ByteTokenizer()
    cfg = tiny_config(vocab_size=tok.vocab_size)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu", dtype=torch.float32)
    server = S.InferenceServer(
        Engine(params, cfg, tok, EngineConfig(dtype=torch.float32,
                                              **engine_kw), device="cpu"),
        model_name="tiny-test")
    with _running(jserver) as jport, _running(server) as port:
        yield {"jax": jport, "port": port, "server": server}


@pytest.fixture(scope="module")
def servers():
    with _server_pair(**ENGINE_KW) as pair:
        yield pair


def test_health_models_and_metrics(servers):
    port = servers["port"]
    assert _call(port, "GET", "/health")[0] == 200
    status, raw = _call(port, "GET", "/v1/models")
    assert status == 200
    assert json.loads(raw)["data"][0]["id"] == "tiny-test"
    _completions(port, [_body("metrics page")])
    status, raw = _call(port, "GET", "/metrics")
    assert status == 200
    data = json.loads(raw)
    assert {"running", "waiting", "slots", "requests_served"} <= set(data)
    assert data["slots"] == 2 and data["requests_served"] >= 1
    assert data["spec_passes"] > 0 and data["spec_tokens"] > 0
    assert data["prof"]["requests"] >= 1


def test_completions_equal_the_jax_server(servers):
    """Four concurrent requests (two slots: two admission waves), text and
    pages, one opting out of speculation: the same texts and token counts
    as the JAX server's; the shared instruction hits the prefix cache."""
    bodies = [_body("alpha"), _body("beta", image_seed=1),
              _body("gamma", image_seed=2, speculative=False),
              _body("delta delta delta", max_tokens=20)]
    want = _completions(servers["jax"], bodies)
    got = _completions(servers["port"], bodies)
    for w, g in zip(want, got):
        assert g["choices"][0]["message"] == w["choices"][0]["message"]
        assert g["choices"][0]["finish_reason"] == \
            w["choices"][0]["finish_reason"]
        assert g["usage"] == w["usage"]
    assert len(servers["server"].engine._prefix_kv) >= 1


def test_int4_completions_equal_the_jax_server():
    """Both servers at --kv-quantize int4 with the product defaults: a text
    and a page request (one opting out of speculation) give the same texts
    and token counts."""
    bodies = [_body("alpha alpha alpha", max_tokens=16),
              _body("beta", image_seed=5, speculative=False)]
    with _server_pair(**ENGINE_KW, kv_quantize="int4") as pair:
        want = _completions(pair["jax"], bodies)
        got = _completions(pair["port"], bodies)
        assert pair["server"].engine.cache.k.shape[-2] == 128  # packed rows
    for w, g in zip(want, got):
        assert g["choices"][0]["message"] == w["choices"][0]["message"]
        assert g["usage"] == w["usage"]


def test_stream_concatenates_to_the_completion(servers):
    port = servers["port"]
    body = _body("stream me", image_seed=3, max_tokens=16)
    want = _completions(port, [body])[0]["choices"][0]["message"]["content"]
    status, raw = _call(port, "POST", "/v1/chat/completions",
                        {**body, "stream": True})
    assert status == 200
    events = [line[len("data: "):] for line in raw.decode().split("\n")
              if line.startswith("data: ")]
    assert events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    assert chunks[0]["choices"][0]["delta"] == {"role": "assistant"}
    assert chunks[-1]["choices"][0]["finish_reason"] in ("stop", "length")
    text = "".join(c["choices"][0]["delta"].get("content", "")
                   for c in chunks)
    assert text == want


def test_error_status_codes(servers):
    port = servers["port"]
    assert _call(port, "POST", "/v1/chat/completions", b"{not json")[0] == 400
    assert _call(port, "POST", "/v1/chat/completions",
                 {"not_messages": 1})[0] == 400
    too_long = _body("x" * 400)
    assert _call(port, "POST", "/v1/chat/completions", too_long)[0] == 400
    assert _call(port, "GET", "/nope")[0] == 404
    guided = _body("digits", guided_regex="[0-9]+")
    assert _call(port, "POST", "/v1/chat/completions", guided)[0] == 500


def test_arg_parser_matches_the_jax_server():
    """Every flag the JAX server has, with the same default; plus --device."""
    want = vars(j_parser().parse_args([]))
    got = vars(S.make_arg_parser().parse_args([]))
    assert set(got) == set(want) | {"device"}
    for key, value in want.items():
        assert got[key] == value, key
    assert got["device"] == "cuda"
    assert got["speculative_ngram"] == 3 and got["prefix_cache"] is True


def test_build_engine_from_args_on_cpu():
    args = S.make_arg_parser().parse_args(
        ["--preset", "tiny", "--device", "cpu", "--max-batch-size", "2",
         "--max-model-len", "256", "--kv-quantize", "int8"])
    engine, name = S.build_engine_from_args(args)
    assert name.startswith("random-")
    assert engine.device.type == "cpu" and engine.ecfg.dtype == torch.float32
    assert engine.ecfg.speculative_ngram == 3 and engine.ecfg.prefix_cache
    assert engine.cache.k.dtype == torch.int8
    args.kv_quantize = "int4"
    engine, _ = S.build_engine_from_args(args)
    assert engine.cache.ks.shape[2] == 2 * engine.cfg.text.num_kv_heads
    for bad in (["--model-path", "/nowhere"], ["--native-checkpoint", "x"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            S.build_engine_from_args(S.make_arg_parser().parse_args(
                ["--preset", "tiny", "--device", "cpu", *bad]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            S.build_engine_from_args(S.make_arg_parser().parse_args(
                ["--preset", "tiny"]))


def test_extract_data_images_matches_jax():
    body = json.dumps(_body("page", image_seed=4)).encode()
    assert S.extract_data_images(body) == j_extract(body)
    assert S.extract_data_images(b'{"a": 1}') == j_extract(b'{"a": 1}')
