"""Multi-rank serving end to end on the CPU: the port's OpenAI server built
by its CLI path with ``tensor_parallel_size=2`` (this process is rank 0 and
spawns rank 1, gloo) serves the surface and gives the greedy text of the
port's one-device server and of the JAX server on a (data=2, fsdp=1,
model=2) mesh: the four cases of ``tests/test_server_sharded.py``.

All three serve the same weights: the JAX tiny init, written as a native
checkpoint of the port (``training/checkpoint.py``) for the port's servers
(``--native-checkpoint``, the path that reads each tensor into its shard).
"""

import argparse
import asyncio
import base64
import io
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
from karanta_tpu.inference.tokenizer import ByteTokenizer as JByteTokenizer
from karanta_tpu.models.qwen25_vl.config import tiny_config as j_tiny_config
from karanta_tpu.models.qwen25_vl.model import init_params as j_init_params
from karanta_tpu.parallel.mesh import MeshConfig as JMeshConfig
from karanta_tpu.parallel.mesh import create_mesh as j_create_mesh
from karanta_tpu.pipeline.http import aget, apost
from karanta_tpu_torch.inference import server as S
from karanta_tpu_torch.models.qwen25_vl.config import tiny_config
from karanta_tpu_torch.models.qwen25_vl.convert import from_jax_params
from karanta_tpu_torch.training.checkpoint import save_checkpoint
from tests.torch_ranks import RANK_TIMEOUT_S

SLOTS, MAX_LEN, CHUNK = 2, 256, 8


def _boot(server):
    loop = asyncio.new_event_loop()
    started = threading.Event()
    holder = {}

    def run():
        asyncio.set_event_loop(loop)

        async def go():
            holder["port"] = await server.start("127.0.0.1", 0)
            started.set()

        loop.run_until_complete(go())
        loop.run_forever()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    assert started.wait(timeout=60)
    return f"http://127.0.0.1:{holder['port']}", loop, thread


def _stop(server, loop, thread):
    asyncio.run_coroutine_threadsafe(server.stop(), loop).result(timeout=120)
    loop.call_soon_threadsafe(loop.stop)
    thread.join(timeout=30)


def _port_args(ckpt: str, tp: int) -> argparse.Namespace:
    args = S.make_arg_parser().parse_args([
        "--native-checkpoint", ckpt, "--preset", "tiny", "--device", "cpu",
        "--max-batch-size", str(SLOTS), "--max-model-len", str(MAX_LEN),
        "--decode-chunk", str(CHUNK), "--tensor-parallel-size", str(tp)])
    args.rank_timeout = RANK_TIMEOUT_S  # a hung rank fails within a minute
    return args


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    jtok = JByteTokenizer()
    jcfg = j_tiny_config(vocab_size=jtok.vocab_size)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    # the port CLI's engine settings: speculation and prefix caching on
    jengine = JEngine(
        jparams, jcfg, jtok,
        JEngineConfig(max_batch_size=SLOTS, max_seq_len=MAX_LEN,
                      decode_chunk=CHUNK, dtype=jnp.float32,
                      speculative_ngram=3, prefix_cache=True),
        mesh=j_create_mesh(JMeshConfig(data=2, fsdp=1, model=2),
                           devices=jax.devices()[:4]))
    root = tmp_path_factory.mktemp("ckpt")
    params = from_jax_params(jax.tree.map(np.asarray, jparams),
                             tiny_config(vocab_size=jtok.vocab_size),
                             device="cpu", dtype=torch.float32)
    save_checkpoint(str(root), 1, {"params": params})
    booted = []
    try:
        for engine in (jengine, S.build_engine_from_args(
                _port_args(str(root), 1))[0],
                S.build_engine_from_args(_port_args(str(root), 2))[0]):
            cls = JServer if engine is jengine else S.InferenceServer
            server = cls(engine, model_name="tiny")
            booted.append((server,) + _boot(server))
        yield {name: b[1] for name, b in zip(("jax", "single", "tp2"),
                                               booted)}
    finally:
        for server, _, loop, thread in booted:
            _stop(server, loop, thread)
    # the stopped leader joined its worker rank
    assert not any(p.is_alive() for p in booted[-1][0].engine._workers)


def _chat_body(text="read this page", max_tokens=12, with_image=False):
    content = [{"type": "text", "text": text}]
    if with_image:
        from PIL import Image

        img = Image.fromarray(np.random.default_rng(3).integers(
            0, 255, (56, 56, 3), dtype=np.uint8))
        buf = io.BytesIO()
        img.save(buf, format="PNG")
        b64 = base64.b64encode(buf.getvalue()).decode()
        content.append({"type": "image_url",
                        "image_url": {"url": f"data:image/png;base64,{b64}"}})
    return {"model": "karanta-ocr", "max_tokens": max_tokens,
            "temperature": 0.0,
            "messages": [{"role": "user", "content": content}]}


def _post(url, body):
    async def go():
        return await apost(f"{url}/v1/chat/completions", body)

    return asyncio.run(go())


def _three(servers, body):
    out = {}
    for name, url in servers.items():
        status, raw = _post(url, body)
        assert status == 200, (name, raw)
        out[name] = json.loads(raw)
    return out


def test_surface_up(servers):
    async def go():
        return (await aget(f"{servers['tp2']}/health"),
                await aget(f"{servers['tp2']}/metrics"))

    (hs, _), (ms, mbody) = asyncio.run(go())
    assert hs == 200 and ms == 200
    assert {"running", "waiting"} <= set(json.loads(mbody))


def test_greedy_text_matches_single_device_and_jax(servers):
    got = _three(servers, _chat_body())
    texts = {k: v["choices"][0]["message"]["content"] for k, v in got.items()}
    assert texts["tp2"] == texts["single"] == texts["jax"]
    assert got["tp2"]["usage"] == got["single"]["usage"] == got["jax"]["usage"]


def test_greedy_multimodal_matches_single_device_and_jax(servers):
    got = _three(servers, _chat_body(with_image=True, max_tokens=8))
    assert got["tp2"]["usage"]["prompt_tokens"] > 20
    texts = {k: v["choices"][0]["message"]["content"] for k, v in got.items()}
    assert texts["tp2"] == texts["single"] == texts["jax"]


def test_concurrent_batch_on_mesh(servers):
    async def go():
        return await asyncio.gather(*[
            apost(f"{servers['tp2']}/v1/chat/completions",
                  _chat_body(text=f"page {i}", max_tokens=6))
            for i in range(4)])

    results = asyncio.run(go())
    assert all(status == 200 for status, _ in results)
    assert all(json.loads(body)["usage"]["completion_tokens"] > 0
               for _, body in results)
