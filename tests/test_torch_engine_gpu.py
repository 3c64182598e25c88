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
