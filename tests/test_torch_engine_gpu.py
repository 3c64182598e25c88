"""The port's engine on the card against the same engine on the CPU, on the
tiny config, under teacher forcing, guided decoding and logprobs.

These tests need a CUDA device and skip without one; they import neither
JAX nor the JAX package, so the GPU machine runs them with

    python -m pytest --noconftest -m gpu tests/test_torch_engine_gpu.py

Tolerance: greedy tokens equal; the logits of every captured step within
2e-3 x max|logit| (W8A8 and int8-cache rounding may move a value across a
quantization step, as in chip_smoke.py's tiny phase); logprobs within the
same bound, with equal chosen tokens.
"""

import pytest
import torch

from karanta_tpu_torch.inference.engine import Engine, EngineConfig, GenRequest
from karanta_tpu_torch.inference.guided import compile_regex, match_full
from karanta_tpu_torch.inference.tokenizer import ByteTokenizer
from karanta_tpu_torch.models.qwen25_vl.config import tiny_config
from karanta_tpu_torch.models.qwen25_vl.model import init_params
from karanta_tpu_torch.utils.tree import tree_map

pytestmark = pytest.mark.gpu

LOGIT_TOL = 2e-3
FORCED = ("the quick brown fox jumps over the lazy dog while the quick "
          "brown fox jumps over the lazy dog again")
KW = dict(max_batch_size=2, max_seq_len=256, decode_chunk=4,
          prefill_buckets=(128, 256), dtype=torch.float32, quantize="int8",
          kv_quantize="int8")


@pytest.fixture(scope="module")
def setup():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are compiled and run "
                    "only on the card")
    tok = ByteTokenizer()
    cfg = tiny_config(vocab_size=tok.vocab_size)
    params_cpu = init_params(cfg, 0, torch.float32, device="cpu")
    params_gpu = tree_map(lambda x, _: x.to("cuda"), params_cpu)
    return tok, cfg, {"cpu": params_cpu, "cuda": params_gpu}


def run_both(setup, ecfg, fn):
    """fn(engine, logits_out) on a fresh engine on each device; returns
    {device: (fn's result, captured logits)}."""
    tok, cfg, params = setup
    out = {}
    for dev in ("cpu", "cuda"):
        captured = []
        eng = Engine(params[dev], cfg, tok, ecfg, device=dev)
        out[dev] = (fn(eng, captured), captured)
    return out


def check_logits(out):
    cpu, cuda = out["cpu"][1], out["cuda"][1]
    assert len(cpu) == len(cuda) > 0
    for want, got in zip(cpu, cuda):
        want, got = want.float().cpu(), got.float().cpu()
        scale = max(float(want.abs().max()), 1.0)
        assert float((want - got).abs().max()) <= LOGIT_TOL * scale


def _request(content, **kw):
    return GenRequest(messages=[{"role": "user", "content": content}], **kw)


@pytest.mark.parametrize("gamma", [0, 3])
def test_forced_decode_card_vs_cpu(setup, gamma):
    """Teacher forcing per step (decode kernel #3's path) and in verify
    passes (#4's): the same forced text and acceptance, the logits of the
    steps and passes within the bound."""
    ecfg = EngineConfig(teacher_force=True, speculative_ngram=gamma,
                        **dict(KW, max_seq_len=512,
                               prefill_buckets=(128, 256)))
    prompt = "RAW TEXT START\n" + FORCED + "\nRAW TEXT END"

    def fn(eng, captured):
        req = _request(prompt, max_tokens=200, forced_output=FORCED)
        eng.prefill_insert(0, eng.prepare(req))
        if gamma:
            _, counts = eng.decode_chunk_spec(4, logits_out=captured)
            accepted = counts[:, 0].tolist()
        else:
            eng.decode_chunk(4, logits_out=captured)
            accepted = None
        eng.free_slot(0)
        [res] = eng.generate([req])
        return res.text, res.finish_reason, accepted

    out = run_both(setup, ecfg, fn)
    assert out["cpu"][0] == out["cuda"][0]
    assert out["cuda"][0][:2] == (FORCED, "stop")
    check_logits(out)


def test_guided_decode_card_vs_cpu(setup):
    """A guided request beside an unguided one: the same greedy tokens on
    the card as on the CPU, the completion matches its regex, and the
    logits of the guided steps agree within the bound."""
    regex = r"(?:yes|no): [0-9]{1,3}"
    ecfg = EngineConfig(**KW)

    def fn(eng, captured):
        eng.prefill_insert(0, eng.prepare(_request(
            "classify", guided_regex=regex)))
        eng.decode_chunk(4, logits_out=captured)
        eng.free_slot(0)
        res = eng.generate([_request("classify", max_tokens=16,
                                     guided_regex=regex),
                            _request("hello", max_tokens=8)])
        return [r.token_ids for r in res], res[0].text

    out = run_both(setup, ecfg, fn)
    assert out["cpu"][0] == out["cuda"][0]
    assert match_full(compile_regex(regex), out["cuda"][0][1].encode())
    check_logits(out)


def test_logprobs_card_vs_cpu(setup):
    """Logprobs (top 5) of a greedy request: the same tokens and chosen
    logprobs within the bound on the card as on the CPU; the chosen token
    is the top-1."""
    ecfg = EngineConfig(speculative_ngram=3, **KW)

    def fn(eng, captured):
        [res] = eng.generate([_request("page text", max_tokens=10,
                                       logprobs=True, top_logprobs=5)])
        return res

    out = run_both(setup, ecfg, fn)
    cpu, cuda = out["cpu"][0], out["cuda"][0]
    assert cpu.token_ids == cuda.token_ids
    for (c, top), (wc, wtop) in zip(cuda.logprobs, cpu.logprobs):
        assert abs(c - wc) <= LOGIT_TOL * max(abs(wc), 1.0)
        assert top[0][0] == wtop[0][0] and abs(c - top[0][1]) <= 1e-6


def _page_request(seed: int) -> GenRequest:
    import base64

    import numpy as np

    from karanta_tpu_torch.ops.png import encode_png_rgb

    page = np.random.default_rng(seed).integers(0, 255, (112, 112, 3),
                                                dtype=np.uint8)
    png = base64.b64encode(encode_png_rgb(page)).decode()
    return GenRequest(messages=[{"role": "user", "content": [
        {"type": "text", "text": "read this"},
        {"type": "image_url",
         "image_url": {"url": f"data:image/png;base64,{png}"}}]}])


@pytest.mark.parametrize("kv", [None, "int8"])
def test_prefill_insert_batch_vs_single_inserts(setup, kv):
    """prefill_insert_batch of K = 4 same-shaped pages on the card against 4
    single prefill_inserts on the card: prefill logits within the bound,
    the same first tokens, lengths and positions; the float cache's rows
    within the bound of the slots' largest row, the int8 cache's values
    within one quantization step. The batched call launches each vision
    window layer, full layer and decoder layer's kernel once."""
    from karanta_tpu_torch import kernels

    tok, cfg, params = setup
    ecfg = EngineConfig(prefill_batch=4, **dict(
        KW, max_batch_size=4, max_seq_len=512, prefill_buckets=(256,),
        image_token_buckets=(64,), kv_quantize=kv))
    batched = Engine(params["cuda"], cfg, tok, ecfg, device="cuda")
    single = Engine(params["cuda"], cfg, tok, ecfg, device="cuda")
    group = [batched.prepare(_page_request(i)) for i in range(4)]
    assert len({batched._batch_key(g) for g in group}) == 1
    logits_b, _ = batched.prefill_batch(group)
    group = [batched.prepare(_page_request(i)) for i in range(4)]
    kernels.reset_launches()
    firsts_b = batched.prefill_insert_batch(group, [0, 1, 2, 3])
    torch.cuda.synchronize()
    n_full = len(cfg.vision.fullatt_block_indexes)
    assert kernels.LAUNCHES["window_attention"] == cfg.vision.depth - n_full
    assert kernels.LAUNCHES["flash_attention"] == (n_full
                                                   + cfg.text.num_layers)
    firsts_s = []
    for slot in range(4):
        prepared = single.prepare(_page_request(slot))
        logits_s, _ = single.prefill(single.prepare(_page_request(slot)))
        want, got = logits_s.float().cpu(), logits_b[slot].float().cpu()
        scale = max(float(want.abs().max()), 1.0)
        assert float((want - got).abs().max()) <= LOGIT_TOL * scale
        firsts_s.append(int(single.prefill_insert(slot, prepared)))
    assert [int(f) for f in firsts_b] == firsts_s
    for name in ("cache_len", "next_pos", "last_token"):
        assert torch.equal(getattr(batched, name), getattr(single, name))
    rows = int(batched.cache_len.max())
    for name in ("k", "v"):
        got = getattr(batched.cache, name)[..., :rows, :].float().cpu()
        want = getattr(single.cache, name)[..., :rows, :].float().cpu()
        if kv == "int8":
            assert float((got - want).abs().max()) <= 1.0
        else:
            scale = max(float(want.abs().max()), 1.0)
            assert float((got - want).abs().max()) <= LOGIT_TOL * scale


@pytest.mark.parametrize("kv", ["int8", "int4", None])
def test_tensor_parallel_engine_on_card(setup, kv, tmp_path):
    """The engine at model=2 on the card (two spawned ranks sharing it over
    gloo) against one rank on the card: greedy tokens equal, the decode
    steps' logits within LOGIT_TOL (the int8 points with the W8A8 tower, so
    every prefill product is int8 and exact under the split)."""
    from karanta_tpu_torch.parallel.launch import run_ranks
    from tests.torch_ranks import (RANK_TIMEOUT_S, card_engine_rank,
                                   card_engine_trace)

    tok, cfg, params = setup
    kw = dict(KW, kv_quantize=kv, speculative_ngram=3)
    if kv is None:
        kw.update(quantize=None)
    else:
        kw.update(act_quant="int8", vision_quant="int8")
    requests = ["abcabcabcabcabc", "The quick brown fox."]
    want = card_engine_trace(Engine(params["cuda"], cfg, tok,
                                    EngineConfig(**kw), device="cuda"),
                             requests)
    ranks = run_ranks(card_engine_rank, 2,
                      ({"engine": kw, "requests": requests},),
                      init_url=f"file://{tmp_path}/store",
                      timeout_s=4 * RANK_TIMEOUT_S)
    for got in ranks:
        assert got["tokens"] == want["tokens"]
        scale = max(float(want["logits"].abs().max()), 1.0)
        assert float((got["logits"] - want["logits"]).abs().max()) <= \
            LOGIT_TOL * scale
