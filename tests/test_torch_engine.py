"""The PyTorch port's engine against the JAX engine, and the port's rules.

The slice as a whole: greedy tokens of ``karanta_tpu_torch`` Engine.generate
equal the JAX engine's on the tiny config (float32, int8 weights, W8A8
prefill and head, int8 KV cache), for a text request and a page image; with
n-gram speculation over the int8 and the float cache they equal the JAX
speculative engine's and the port's own per-step decoding; prefix caching
changes no token. Over the int4 cache the tokens equal the JAX int4
engine's with and without speculation and with the prefix cache, and both
engines refuse the same int4 configurations.
"""

import base64
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karanta_tpu.inference.engine import Engine as JEngine
from karanta_tpu.inference.engine import EngineConfig as JEngineConfig
from karanta_tpu.inference.engine import GenRequest as JGenRequest
from karanta_tpu.inference.tokenizer import ByteTokenizer as JByteTokenizer
from karanta_tpu.models.qwen25_vl.config import tiny_config as j_tiny_config
from karanta_tpu.models.qwen25_vl.model import init_params as j_init_params
from karanta_tpu_torch.inference.engine import Engine, EngineConfig, GenRequest
from karanta_tpu_torch.inference.tokenizer import ByteTokenizer
from karanta_tpu_torch.models.qwen25_vl.config import tiny_config
from karanta_tpu_torch.models.qwen25_vl.convert import from_jax_params
from karanta_tpu_torch.ops.png import encode_png_rgb

REPO = Path(__file__).resolve().parents[1]


class _NoStopJ(JByteTokenizer):
    def __init__(self):
        super().__init__()
        self.eos_token_id = -1


class _NoStop(ByteTokenizer):
    def __init__(self):
        super().__init__()
        self.eos_token_id = -1


def _messages(png_b64=None, text="Return the plain text of this page.\n"):
    if png_b64 is None:
        return [{"role": "user", "content": "page zero"}]
    return [{"role": "user", "content": [
        {"type": "text", "text": text},
        {"type": "image_url",
         "image_url": {"url": f"data:image/png;base64,{png_b64}"}}]}]


ENGINE_KW = dict(max_batch_size=2, max_seq_len=256, decode_chunk=4,
                 prefill_buckets=(128, 256), quantize="int8",
                 kv_quantize="int8", act_quant="int8")


@pytest.mark.parametrize("kind", ["text", "page", "page_host_resize"])
def test_greedy_tokens_match_jax_engine(kind):
    """Port Engine.generate == JAX Engine.generate, token for token."""
    jtok = _NoStopJ()
    jcfg = j_tiny_config(vocab_size=jtok.vocab_size)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    rng = np.random.default_rng(12)
    png = None
    if kind == "page":
        # sides that are multiples of 28: the page is not resized, so both
        # engines see bit-identical pixels (a real resize may differ by one
        # uint8 step between XLA and PyTorch; tests/test_torch_ops.py holds
        # resize_patchify to that bound)
        page = rng.integers(0, 255, size=(84, 112, 3), dtype=np.uint8)
        png = base64.b64encode(encode_png_rgb(page)).decode()
    elif kind == "page_host_resize":
        # a page that needs resizing, resized on the host by PIL in both
        # engines (device_resize=False)
        page = rng.integers(0, 255, size=(70, 130, 3), dtype=np.uint8)
        png = base64.b64encode(encode_png_rgb(page)).decode()
    kw = dict(ENGINE_KW, device_resize=kind != "page_host_resize")
    max_tokens = 10

    jeng = JEngine(jparams, jcfg, jtok,
                   JEngineConfig(dtype=jnp.float32, **kw))
    want = jeng.generate([JGenRequest(messages=_messages(png),
                                      max_tokens=max_tokens,
                                      temperature=0.0, request_id="r")])

    tok = _NoStop()
    cfg = tiny_config(vocab_size=tok.vocab_size)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu", dtype=torch.float32)
    eng = Engine(params, cfg, tok, EngineConfig(dtype=torch.float32, **kw),
                 device="cpu")
    got = eng.generate([GenRequest(messages=_messages(png),
                                   max_tokens=max_tokens, temperature=0.0,
                                   request_id="r")])
    assert got[0].prompt_tokens == want[0].prompt_tokens
    assert len(got[0].token_ids) == max_tokens
    assert got[0].token_ids == want[0].token_ids


def test_unported_features_raise():
    tok = _NoStop()
    cfg = tiny_config(vocab_size=tok.vocab_size)
    params = {"text": {"layers": {"attn": {"wq": None}}}}
    for bad in (dict(prefill_batch=4), dict(vision_quant="int8")):
        kw = {**dict(kv_quantize="int8"), **bad}
        with pytest.raises(NotImplementedError):
            Engine(params, cfg, tok, EngineConfig(**kw), device="cpu")


def test_unported_request_options_raise():
    """Every request option is ported; the ones an engine cannot honour
    raise ValueError, as in the JAX engine: a regex outside the guided
    syntax (when its automaton is bound at prefill) and guided decoding
    together with a forced stream."""
    from karanta_tpu_torch.models.qwen25_vl.model import init_params

    tok = _NoStop()
    cfg = tiny_config(vocab_size=tok.vocab_size)
    params = init_params(cfg, 0, torch.float32, device="cpu")
    kw = dict(max_batch_size=1, max_seq_len=128, prefill_buckets=(128,),
              dtype=torch.float32, kv_quantize="int8")
    eng = Engine(params, cfg, tok, EngineConfig(**kw), device="cpu")
    prepared = eng.prepare(GenRequest(messages=_messages(),
                                      guided_regex="(?=x)"))
    with pytest.raises(ValueError, match="groups"):
        eng.prefill_insert(0, prepared)
    forced = Engine(params, cfg, tok, EngineConfig(teacher_force=True, **kw),
                    device="cpu")
    with pytest.raises(ValueError, match="guided"):
        forced.prepare(GenRequest(messages=_messages(), guided_regex="[0-9]+",
                                  forced_output="123"))


@pytest.mark.parametrize("variant", ["palette", "gray16", "bilevel"])
def test_png_variants_decode_as_pil(variant):
    """PNGs the port's decoder does not take (palette, 16-bit gray, 1-bit),
    written by Pillow, decode through PIL as in the JAX engine, to PIL's
    convert("RGB") exactly."""
    import io

    from PIL import Image

    from karanta_tpu_torch.models.qwen25_vl.model import init_params

    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 255, size=(40, 52, 3), dtype=np.uint8)
    img = Image.fromarray(rgb)
    img = {"palette": lambda: img.convert("P"),
           "gray16": lambda: Image.fromarray(
               rng.integers(0, 65535, size=(40, 52)).astype(np.uint16)),
           "bilevel": lambda: img.convert("1")}[variant]()
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    raw = buf.getvalue()
    want = np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"), np.uint8)
    tok = _NoStop()
    cfg = tiny_config(vocab_size=tok.vocab_size)
    eng = Engine(init_params(cfg, 0, torch.float32, device="cpu"), cfg, tok,
                 EngineConfig(max_batch_size=1, max_seq_len=256,
                              prefill_buckets=(128, 256),
                              dtype=torch.float32), device="cpu")
    np.testing.assert_array_equal(eng._decode_image(raw), want)
    png = base64.b64encode(raw).decode()
    prepared = eng.prepare(GenRequest(messages=_messages(png)))
    assert prepared.img_token_counts[0] > 0


def test_entry_points_need_cuda_or_explicit_cpu():
    """Without device= the entry points run on CUDA; with no card they raise
    instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from karanta_tpu_torch.bench.randweights import init_params_bench
    from karanta_tpu_torch.models.qwen25_vl.model import init_params

    tok = _NoStop()
    cfg = tiny_config(vocab_size=tok.vocab_size)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg, 0, torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params_bench(cfg, torch.float32, "int8")
    params = init_params(cfg, 0, torch.float32, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(params, cfg, tok, EngineConfig(kv_quantize="int8"))


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of karanta_tpu_torch, and chip_smoke.py's imports, load
    without JAX and without karanta_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import karanta_tpu_torch\n"
        "for m in pkgutil.walk_packages(karanta_tpu_torch.__path__, "
        "'karanta_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "for m in ('inference.guided', 'models.qwen25_vl.loading', "
        "'models.qwen25_vl.exporting'):\n"
        "    assert 'karanta_tpu_torch.' + m in sys.modules, m\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' "
        "or n.startswith('jax.') or n == 'karanta_tpu' "
        "or n.startswith('karanta_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


# ---------------------------------------------------------------------------
# n-gram speculation and prefix caching
# ---------------------------------------------------------------------------

SPEC_KW = dict(max_batch_size=2, max_seq_len=128, decode_chunk=6,
               prefill_buckets=(128,))


@pytest.fixture(scope="module")
def tiny_weights():
    jtok = _NoStopJ()
    jcfg = j_tiny_config(vocab_size=jtok.vocab_size)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tok = _NoStop()
    cfg = tiny_config(vocab_size=tok.vocab_size)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu", dtype=torch.float32)
    return dict(jtok=jtok, jcfg=jcfg, jparams=jparams, tok=tok, cfg=cfg,
                params=params)


def _spec_msgs():
    # the JAX package's speculation cases: a repeating prompt (drafts hit)
    # and a prompt without repeats
    return [[{"role": "user", "content": "abcabcabcabcabcabc"}],
            [{"role": "user", "content": "The quick brown fox."}]]


def _port_engine(w, **kw):
    return Engine(w["params"], w["cfg"], w["tok"],
                  EngineConfig(dtype=torch.float32, **kw), device="cpu")


def _count_spec(engine, reqs):
    calls = {"n": 0}
    orig = engine.decode_chunk_spec

    def counted(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    engine.decode_chunk_spec = counted
    try:
        outs = engine.generate(reqs)
    finally:
        engine.decode_chunk_spec = orig
    return calls["n"], outs


@pytest.mark.parametrize("kv", ["int8", None])
def test_speculative_tokens_match_jax_and_plain(tiny_weights, kv):
    """Greedy speculation (gamma 3) over the int8 cache (the multi-token
    kernel's plain version) and the float cache (scatter + dense verify
    attention): tokens equal the JAX speculative engine's, the port's
    per-step decoding, and the acceptance counts equal JAX's."""
    w = tiny_weights
    kw = dict(SPEC_KW, kv_quantize=kv)
    jeng = JEngine(w["jparams"], w["jcfg"], w["jtok"],
                   JEngineConfig(dtype=jnp.float32, speculative_ngram=3, **kw))
    want = jeng.generate([JGenRequest(messages=m, max_tokens=24,
                                      request_id=str(i))
                          for i, m in enumerate(_spec_msgs())])
    reqs = [GenRequest(messages=m, max_tokens=24, request_id=str(i))
            for i, m in enumerate(_spec_msgs())]
    spec = _port_engine(w, speculative_ngram=3, **kw)
    n_spec, got = _count_spec(spec, reqs)
    plain = _port_engine(w, **kw).generate(reqs)
    assert n_spec > 0
    for a, b, c in zip(want, got, plain):
        assert len(b.token_ids) == 24
        assert b.token_ids == a.token_ids == c.token_ids
    assert (spec.spec_passes, spec.spec_tokens) == (jeng.spec_passes,
                                                    jeng.spec_tokens)
    assert spec.spec_tokens > spec.spec_passes  # the repeating prompt hits


@pytest.mark.parametrize("votes,spec_calls", [
    ((False, False), 0),      # opted-out majority: per-step decode
    ((True, False), 0),       # a split vote is no majority
    ((None, None), 1),        # the default speculates
])
def test_per_request_speculation_votes(tiny_weights, votes, spec_calls):
    eng = _port_engine(tiny_weights, speculative_ngram=3,
                       kv_quantize="int8", **SPEC_KW)
    reqs = [GenRequest(messages=m, max_tokens=24, speculative=v)
            for m, v in zip(_spec_msgs(), votes)]
    n, outs = _count_spec(eng, reqs)
    assert (n > 0) == bool(spec_calls)
    assert all(len(o.token_ids) == 24 for o in outs)


def test_sampled_rows_verify_by_rejection_sampling(tiny_weights):
    """temperature > 0 still speculates (rejection sampling); at 1e-6 the
    verifier collapses to argmax and gives the greedy tokens."""
    eng = _port_engine(tiny_weights, speculative_ngram=3, **SPEC_KW)
    msgs = [{"role": "user", "content": "abcabcabcabc"}]
    n, outs = _count_spec(eng, [GenRequest(messages=msgs, max_tokens=8,
                                           temperature=0.7)])
    assert n > 0 and len(outs[0].token_ids) == 8
    greedy = _port_engine(tiny_weights, **SPEC_KW).generate(
        [GenRequest(messages=msgs, max_tokens=24)])[0]
    tiny_t = eng.generate([GenRequest(messages=msgs, max_tokens=24,
                                      temperature=1e-6)])[0]
    assert tiny_t.token_ids == greedy.token_ids


def _prefix_request(page_text, seed=0):
    page = np.random.default_rng(seed).integers(0, 255, (56, 56, 3),
                                                dtype=np.uint8)
    png = base64.b64encode(encode_png_rgb(page)).decode()
    return GenRequest(messages=[{"role": "user", "content": [
        {"type": "text",
         "text": "Read the page as plain text, keep every diacritic. "},
        {"type": "image_url",
         "image_url": {"url": f"data:image/png;base64,{png}"}},
        {"type": "text", "text": page_text}]}], max_tokens=10)


@pytest.mark.parametrize("kv", ["int8", None])
def test_prefix_cache_keeps_tokens_and_hits(tiny_weights, kv):
    """Pages sharing an instruction head: the same tokens with the prefix
    cache as without it, and the second and third page reuse one cached
    prefix (a suffix-only prefill, the flash path at q_offset > 0)."""
    kw = dict(max_batch_size=1, max_seq_len=256, decode_chunk=4,
              prefill_buckets=(32, 64, 128, 256), image_token_buckets=(16,),
              kv_quantize=kv)
    reqs = [_prefix_request(t) for t in ("alpha", "beta", "gamma")]
    want = [r.token_ids for r in _port_engine(tiny_weights, **kw)
            .generate(reqs)]
    cached = _port_engine(tiny_weights, prefix_cache=True,
                          prefix_min_tokens=16, **kw)
    built = []
    orig = cached._get_prefix_cache

    def spy(ids):
        built.append(len(ids))
        return orig(ids)

    cached._get_prefix_cache = spy
    got = [r.token_ids for r in cached.generate(reqs)]
    assert got == want
    assert len(built) == 2 and len(cached._prefix_kv) == 1
    short = _port_engine(tiny_weights, prefix_cache=True,
                         prefix_min_tokens=500, **kw)
    short.generate(reqs[:2])
    assert len(short._prefix_kv) == 0


# ---------------------------------------------------------------------------
# the int4 KV cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gamma,prefix", [(0, False), (3, False), (3, True)])
def test_int4_engine_matches_jax(tiny_weights, gamma, prefix):
    """Greedy tokens over the int4 cache (kernels #6 and #7's plain
    versions) equal the JAX int4 engine's (its dense nibble paths), with and
    without speculation and with the prefix cache; with speculation the
    acceptance counts agree too."""
    w = tiny_weights
    if prefix:
        # pages sharing an instruction head: the second reuses its rows
        kw = dict(max_batch_size=1, max_seq_len=256, decode_chunk=4,
                  prefill_buckets=(32, 64, 128, 256),
                  image_token_buckets=(16,), prefix_cache=True,
                  prefix_min_tokens=16)
        msgs = [_prefix_request(t).messages for t in ("alpha", "beta")]
        n = 10
    else:
        kw = dict(SPEC_KW)
        msgs = _spec_msgs()
        n = 24
    kw.update(kv_quantize="int4", speculative_ngram=gamma)
    jeng = JEngine(w["jparams"], w["jcfg"], w["jtok"],
                   JEngineConfig(dtype=jnp.float32, **kw))
    want = jeng.generate([JGenRequest(messages=m, max_tokens=n,
                                      request_id=str(i))
                          for i, m in enumerate(msgs)])
    eng = _port_engine(w, **kw)
    got = eng.generate([GenRequest(messages=m, max_tokens=n,
                                   request_id=str(i))
                        for i, m in enumerate(msgs)])
    assert tuple(eng.cache.k.shape[-2:]) == (kw["max_seq_len"] // 2,
                                             w["cfg"].text.head_dim)
    for a, b in zip(want, got):
        assert len(b.token_ids) == n
        assert b.token_ids == a.token_ids
    if gamma:
        assert (eng.spec_passes, eng.spec_tokens) == (jeng.spec_passes,
                                                      jeng.spec_tokens)
    if prefix:
        assert len(eng._prefix_kv) == 1


@pytest.mark.parametrize("kw,match", [
    (dict(max_seq_len=64, speculative_ngram=2), "128"),
    (dict(max_seq_len=320), "256"),
])
def test_int4_limits_match_jax(kw, match):
    """The JAX engine's int4 limits, with the same messages."""
    jtok = _NoStopJ()
    jcfg = j_tiny_config(vocab_size=jtok.vocab_size)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    with pytest.raises(ValueError, match=match) as want:
        JEngine(jparams, jcfg, jtok, JEngineConfig(
            max_batch_size=2, dtype=jnp.float32, kv_quantize="int4", **kw))
    tok = _NoStop()
    cfg = tiny_config(vocab_size=tok.vocab_size)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match=match) as got:
        Engine(params, cfg, tok, EngineConfig(
            max_batch_size=2, dtype=torch.float32, kv_quantize="int4", **kw),
            device="cpu")
    assert str(got.value) == str(want.value)
