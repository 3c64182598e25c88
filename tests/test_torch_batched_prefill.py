"""Batched prefill, the W8A8 vision tower and the decoded-image cache of the
port's engine, against the JAX package on the tiny config.

Weights come from the JAX package's init_params through from_jax_params;
pages and pixels are made from seeds with numpy. float32 on the CPU.
Tolerances: the batched vision encode within 1e-4 of JAX's (the vision
parity test's bound) and each image's slice within 1e-5 of its own
single-image encode (the same float32 sums over more rows); the W8A8 encode
within 2e-2 normwise of JAX's W8A8 encode (see its test for why not
elementwise); int8 weights and scales, and every cache and slot row a batched insert
writes, bit-equal; greedy tokens equal.
"""

import base64
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karanta_tpu.inference.engine import Engine as JEngine
from karanta_tpu.inference.engine import EngineConfig as JEngineConfig
from karanta_tpu.inference.engine import GenRequest as JGenRequest
from karanta_tpu.inference.tokenizer import ByteTokenizer as JByteTokenizer
from karanta_tpu.models.qwen25_vl import vision as jvis
from karanta_tpu.models.qwen25_vl.config import tiny_config as j_tiny_config
from karanta_tpu.models.qwen25_vl.layout import build_vision_layout as j_layout
from karanta_tpu.models.qwen25_vl.model import init_params as j_init_params
from karanta_tpu.ops.quantization import (
    quantize_vision_params as j_quantize_vision_params,
)
from karanta_tpu_torch.inference.engine import Engine, EngineConfig, GenRequest
from karanta_tpu_torch.inference.tokenizer import ByteTokenizer
from karanta_tpu_torch.models.qwen25_vl import decoder as dec
from karanta_tpu_torch.models.qwen25_vl import vision as vis
from karanta_tpu_torch.models.qwen25_vl.config import tiny_config
from karanta_tpu_torch.models.qwen25_vl.convert import from_jax_params
from karanta_tpu_torch.models.qwen25_vl.layout import build_vision_layout
from karanta_tpu_torch.ops.image_prep import plan_image
from karanta_tpu_torch.ops.png import encode_png_rgb
from karanta_tpu_torch.ops.quantization import (QUANT_KEY, is_quantized,
                                                quantize_vision_params)


class _NoStopJ(JByteTokenizer):
    def __init__(self):
        super().__init__()
        self.eos_token_id = -1


class _NoStop(ByteTokenizer):
    def __init__(self):
        super().__init__()
        self.eos_token_id = -1


@pytest.fixture(scope="module")
def w():
    jtok = _NoStopJ()
    jcfg = j_tiny_config(vocab_size=jtok.vocab_size)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tok = _NoStop()
    cfg = tiny_config(vocab_size=tok.vocab_size)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu", dtype=torch.float32)
    return dict(jtok=jtok, jcfg=jcfg, jparams=jparams, tok=tok, cfg=cfg,
                params=params)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


# ---------------------------------------------------------------------------
# the vision encoder over K images, and its W8A8 weights
# ---------------------------------------------------------------------------

def _images(cfg, n, hw=(150, 230), seed=5):
    """n same-shaped images' pixels and the concatenated layout inputs."""
    plan = plan_image(*hw)
    layout = build_vision_layout(plan, cfg.vision)
    rng = np.random.default_rng(seed)
    pix = [rng.normal(size=(plan.pad_tokens, cfg.vision.patch_input_dim))
           .astype(np.float32) for _ in range(n)]
    p = plan.pad_tokens
    perm = np.concatenate([layout.perm + i * p for i in range(n)])
    valid = np.concatenate([layout.valid] * n)
    pos_hw = np.concatenate([layout.pos_hw] * n)
    return pix, perm, valid, pos_hw, layout


def _extract(encoded, layout, n):
    pad_merged = encoded.shape[0] // n
    return [encoded[np.asarray(layout.extract) + i * pad_merged]
            for i in range(n)]


def test_encode_three_images_matches_jax_and_single(w):
    """encode_image(n_images=3) == JAX's within 1e-4; each image's tokens
    equal its own single-image encode within 1e-5."""
    cfg, jcfg = w["cfg"], w["jcfg"]
    pix, perm, valid, pos_hw, layout = _images(cfg, 3)
    jl = j_layout(plan_image(150, 230), jcfg.vision)
    want = np.asarray(jvis.encode_image(
        w["jparams"]["visual"], jcfg.vision, jnp.asarray(np.concatenate(pix)),
        jnp.asarray(perm), jnp.asarray(valid), jnp.asarray(pos_hw),
        jl.n_windows * 3, n_images=3))
    got = vis.encode_image(w["params"]["visual"], cfg.vision,
                           _t(np.concatenate(pix)), _t(perm), _t(valid),
                           _t(pos_hw), n_images=3)
    for g, j in zip(_extract(got.numpy(), layout, 3),
                    _extract(want, layout, 3)):
        np.testing.assert_allclose(g, j, atol=1e-4)
    for i, g in enumerate(_extract(got.numpy(), layout, 3)):
        single = vis.encode_image(w["params"]["visual"], cfg.vision,
                                  _t(pix[i]), _t(layout.perm),
                                  _t(layout.valid), _t(layout.pos_hw))
        np.testing.assert_allclose(
            g, vis.extract_image_tokens(single, layout).numpy(), atol=1e-5)


def test_quantize_vision_params_bit_equal(w):
    """int8 values and scales bit-equal to JAX's quantize_vision_params;
    biases and norms untouched."""
    jq = jax.tree.map(np.asarray,
                      j_quantize_vision_params(w["jparams"]["visual"]))
    tq = quantize_vision_params(w["params"]["visual"])
    quantized = [("blocks", "attn", n) for n in ("wq", "wk", "wv", "wo")]
    quantized += [("blocks", "mlp", n) for n in tq["blocks"]["mlp"]
                  if is_quantized(tq["blocks"]["mlp"][n])]
    quantized += [("patch_embed", "kernel"), ("merger", "w1"),
                  ("merger", "w2")]
    assert len(quantized) == 10  # the tiny tower's MLP is gated

    def at(tree, path):
        for key in path:
            tree = tree[key]
        return tree

    for path in quantized:
        jleaf, tleaf = at(jq, path), at(tq, path)
        np.testing.assert_array_equal(tleaf[QUANT_KEY].numpy(),
                                      jleaf[QUANT_KEY])
        np.testing.assert_array_equal(tleaf["scale"].numpy(), jleaf["scale"])
    for path in (("blocks", "attn", "bq"), ("blocks", "norm1"),
                 ("merger", "ln_q"), ("merger", "b2")):
        assert at(tq, path) is at(w["params"]["visual"], path)


@pytest.mark.parametrize("hw", [(112, 112), (150, 230)])
def test_w8a8_encode_matches_jax(w, hw):
    """The W8A8 tower over two concatenated images against JAX's W8A8
    encode: within 2e-2 normwise (the decode streams' bound for quantized
    products), and at most half as far from it as from JAX's float tower.
    The decoder's elementwise W8A8 rule (atol 2e-3) does not hold here: a
    float32 summation-order difference moves an activation across an int8
    rounding step (at 112x112 and 150x230, one merged token 2e-2 off after
    the second block), and the full-attention layer spreads it over the
    image: 1.0e-2 normwise, against 3.2e-2 between the W8A8 and the float
    tower."""
    cfg, jcfg = w["cfg"], w["jcfg"]
    pix, perm, valid, pos_hw, layout = _images(cfg, 2, hw=hw, seed=8)
    jl = j_layout(plan_image(*hw), jcfg.vision)

    def jax_encode(visual):
        out = np.asarray(jvis.encode_image(
            visual, jcfg.vision, jnp.asarray(np.concatenate(pix)),
            jnp.asarray(perm), jnp.asarray(valid), jnp.asarray(pos_hw),
            jl.n_windows * 2, n_images=2))
        return np.stack(_extract(out, layout, 2))

    want = jax_encode(j_quantize_vision_params(w["jparams"]["visual"]))
    plain = jax_encode(w["jparams"]["visual"])
    got = vis.encode_image(quantize_vision_params(w["params"]["visual"]),
                           cfg.vision, _t(np.concatenate(pix)), _t(perm),
                           _t(valid), _t(pos_hw), n_images=2)
    got = np.stack(_extract(got.numpy(), layout, 2))
    err = np.linalg.norm(got - want)
    assert err <= 2e-2 * np.linalg.norm(want)
    assert err <= 0.5 * np.linalg.norm(got - plain)


# ---------------------------------------------------------------------------
# the engine: batched prefill against per-page prefill and the JAX engine
# ---------------------------------------------------------------------------

def _png(seed, hw=(112, 112)):
    rng = np.random.default_rng(seed)
    page = rng.integers(0, 255, size=(*hw, 3), dtype=np.uint8)
    return base64.b64encode(encode_png_rgb(page)).decode()


def _image(png):
    return {"type": "image_url",
            "image_url": {"url": f"data:image/png;base64,{png}"}}


def _page(seed, n_images=1):
    return [{"role": "user", "content": [
        {"type": "text", "text": "read this"},
        *[_image(_png(seed + 100 * j)) for j in range(n_images)]]}]


# the JAX package's batched-prefill test (tests/test_engine.py), with five
# pages so that one group of four fills
BATCH_KW = dict(max_batch_size=4, max_seq_len=512, decode_chunk=4,
                prefill_buckets=(256,), image_token_buckets=(64,))
FORCED = "the quick brown fox jumps over the lazy dog"


def _requests(variant):
    """(kwargs of GenRequest per page, EngineConfig overrides)."""
    pages = [dict(messages=_page(i), max_tokens=8) for i in range(5)]
    over = {}
    if variant == "speculative":
        over = dict(speculative_ngram=3)
        for p in pages:
            p["max_tokens"] = 16
    elif variant == "teacher":
        over = dict(teacher_force=True)
        for p in pages[::2]:
            p["forced_output"] = FORCED
    elif variant == "mixed":
        over = dict(max_batch_size=8)
        pages += [dict(messages=_page(7), max_tokens=8,
                       guided_regex="[0-9]+"),
                  dict(messages=_page(8), max_tokens=8, logprobs=True,
                       top_logprobs=2),
                  dict(messages=_page(9, n_images=2), max_tokens=8)]
    return pages, over


def _port_engine(w, **kw):
    return Engine(w["params"], w["cfg"], w["tok"],
                  EngineConfig(dtype=torch.float32, **kw), device="cpu")


def _count_batches(engine):
    calls = []
    orig = engine.prefill_insert_batch

    def counted(group, slots):
        calls.append(len(group))
        return orig(group, slots)

    engine.prefill_insert_batch = counted
    return calls


@pytest.mark.parametrize("variant",
                         ["plain", "speculative", "teacher", "mixed"])
def test_batched_prefill_matches_single_and_jax(w, variant):
    """prefill_batch=4 gives the greedy tokens of prefill_batch=1 and of the
    JAX engine with prefill_batch=4, through one batched group of four;
    with speculation (equal acceptance counts), with teacher forcing, and in
    a wave that mixes a guided, a logprobs and a two-image page with
    batchable ones."""
    pages, over = _requests(variant)
    kw = dict(BATCH_KW, **over)
    reqs = [GenRequest(request_id=str(i), **p) for i, p in enumerate(pages)]
    single = _port_engine(w, **kw)
    want = [r.token_ids for r in single.generate(reqs)]
    batched = _port_engine(w, prefill_batch=4, **kw)
    calls = _count_batches(batched)
    got = [r.token_ids for r in batched.generate(reqs)]
    assert calls == [4]
    assert got == want
    jeng = JEngine(w["jparams"], w["jcfg"], w["jtok"],
                   JEngineConfig(dtype=jnp.float32, prefill_batch=4, **kw))
    jwant = jeng.generate([JGenRequest(request_id=str(i), **p)
                           for i, p in enumerate(pages)])
    assert got == [r.token_ids for r in jwant]
    assert all(len(t) == p["max_tokens"] for t, p in zip(got, pages)
               if not p.get("forced_output"))
    if variant == "speculative":
        assert (batched.spec_passes, batched.spec_tokens) == \
            (jeng.spec_passes, jeng.spec_tokens)
    if variant == "teacher":
        # the forced stream, cut to the page's 8-token budget
        assert got[0][:7] == w["tok"].encode(FORCED)[:7]


def test_batch_key(w):
    """Same-shaped single-image pages share a key; a guided page, a logprobs
    page, a two-image page, a text-only page and a prefix-cache hit get
    None."""
    eng = _port_engine(w, prefill_batch=4, **BATCH_KW)

    def key(**kw):
        return eng._batch_key(eng.prepare(GenRequest(**kw)))

    k0 = key(messages=_page(0))
    assert k0 is not None and key(messages=_page(1)) == k0
    assert key(messages=_page(0, n_images=2)) is None
    assert key(messages=[{"role": "user", "content": "text only"}]) is None
    assert key(messages=_page(0), guided_regex="[0-9]+") is None
    assert key(messages=_page(0), logprobs=True) is None
    prepared = eng.prepare(GenRequest(messages=_page(0)))
    prepared.prefix_len = 16
    assert eng._batch_key(prepared) is None


@pytest.mark.parametrize("kv,dtype", [(None, torch.bfloat16),
                                      ("int8", torch.float32),
                                      ("int4", torch.float32)])
def test_batched_insert_bit_equal_to_single_inserts(w, kv, dtype):
    """One insert of K = 3 prefills leaves the cache (bf16, int8 or int4),
    cache_len, next_pos, last_token, temps and the speculation history
    bit-equal to 3 single inserts, and each slot's rows equal the single
    insert's quantization (and nibble packing) of its own rows."""
    kw = dict(max_batch_size=4, max_seq_len=256, prefill_buckets=(128,),
              kv_quantize=kv, speculative_ngram=3)
    one = Engine(w["params"], w["cfg"], w["tok"],
                 EngineConfig(dtype=dtype, **kw), device="cpu")
    many = Engine(w["params"], w["cfg"], w["tok"],
                  EngineConfig(dtype=dtype, **kw), device="cpu")
    group = [one.prepare(GenRequest(messages=[
        {"role": "user", "content": "page " * (i + 1)}], temperature=0.1 * i))
        for i in range(3)]
    t = w["cfg"].text
    rng = np.random.default_rng(11)
    rows = 72  # a whole 64-token int4 window and a ragged one
    shape = (t.num_layers, 3, t.num_kv_heads, rows, t.head_dim)
    pk, pv = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
              .to(dtype) for _ in range(2))
    firsts = [torch.tensor(v) for v in (5, 17, 40)]
    slots = [2, 0, 3]
    many._insert(slots, group, dec.KVCache(pk, pv), firsts, [0, 0, 0])
    for i, slot in enumerate(slots):
        one._insert([slot], [group[i]],
                    dec.KVCache(pk[:, i:i + 1], pv[:, i:i + 1]),
                    [firsts[i]], [0])
    names = ("k", "v", "ks", "vs") if kv else ("k", "v")
    for name in names:
        assert torch.equal(getattr(many.cache, name),
                           getattr(one.cache, name)), name
    for name in ("cache_len", "next_pos", "last_token", "temps", "top_ps",
                 "dfa_state", "token_hist"):
        assert torch.equal(getattr(many, name), getattr(one, name)), name
    assert many._slot_len == one._slot_len
    assert many.slot_free == one.slot_free == [False, True, False, False]
    for i, slot in enumerate(slots):
        if kv == "int4":
            want = dec.q4_pack_prefill(pk[:, i], pv[:, i])
        elif kv == "int8":
            (kq, ks), (vq, vs) = (dec.quantize_kv_rows(x[:, i])
                                  for x in (pk, pv))
            want = (kq, vq, ks, vs)
        else:
            want = (pk[:, i], pv[:, i])
        for name, x in zip(names, want):
            got = getattr(many.cache, name)[:, slot, :, :x.shape[2]]
            assert torch.equal(got, x.to(got.dtype)), (name, slot)


def test_vision_quant_engine_matches_jax(w):
    """vision_quant="int8" (with int8 decoder weights, the JAX package's
    W8A8 tower test) gives the JAX engine's greedy tokens, and an unknown
    vision_quant raises the JAX engine's ValueError."""
    msgs = [{"role": "user", "content": [
        {"type": "text", "text": "Read this"},
        _image(_png(3, (64, 64)))]}]
    kw = dict(max_batch_size=1, max_seq_len=256, decode_chunk=4,
              prefill_buckets=(128, 256), image_token_buckets=(64,),
              quantize="int8", vision_quant="int8")
    [want] = JEngine(w["jparams"], w["jcfg"], w["jtok"],
                     JEngineConfig(dtype=jnp.float32, **kw)).generate(
        [JGenRequest(messages=msgs, max_tokens=8)])
    [got] = _port_engine(w, **kw).generate(
        [GenRequest(messages=msgs, max_tokens=8)])
    assert len(got.token_ids) == 8
    assert got.token_ids == want.token_ids
    bad = dict(kw, vision_quant="fp8")
    with pytest.raises(ValueError) as jerr:
        JEngine(w["jparams"], w["jcfg"], w["jtok"],
                JEngineConfig(dtype=jnp.float32, **bad))
    with pytest.raises(ValueError) as terr:
        _port_engine(w, **bad)
    assert str(terr.value) == str(jerr.value)


def test_server_cli_builds_the_w8a8_tower():
    """The server CLI's --vision-quant int8 builds an engine whose vision
    tower is int8 (the port's server refused the flag before)."""
    from karanta_tpu_torch.inference.server import (build_engine_from_args,
                                                    make_arg_parser)

    engine, _ = build_engine_from_args(make_arg_parser().parse_args(
        ["--preset", "tiny", "--device", "cpu", "--max-model-len", "256",
         "--quantize", "int8", "--vision-quant", "int8"]))
    assert engine.ecfg.vision_quant == "int8"
    assert is_quantized(engine.params["visual"]["blocks"]["mlp"]["down"])
    assert is_quantized(engine.params["text"]["layers"]["mlp"]["down"])


# ---------------------------------------------------------------------------
# the decoded-image cache (tests/test_engine.py TestImageCache)
# ---------------------------------------------------------------------------

def _png_bytes(seed=0, hw=(56, 56)):
    from PIL import Image

    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (*hw, 3), dtype=np.uint8)).save(
        buf, format="PNG")
    return buf.getvalue()


@pytest.fixture()
def cache_engine(w):
    return _port_engine(w, max_batch_size=1, max_seq_len=128,
                        prefill_buckets=(128,))


def test_image_cache_repeat_bytes_hit(cache_engine):
    raw = _png_bytes()
    a = cache_engine._decode_image(raw)
    b = cache_engine._decode_image(raw)
    assert a is b  # the second decode is served from the LRU
    assert not a.flags.writeable


def test_image_cache_disabled(monkeypatch, cache_engine):
    monkeypatch.setattr(cache_engine, "_img_cache_cap", 0)
    raw = _png_bytes()
    a = cache_engine._decode_image(raw)
    b = cache_engine._decode_image(raw)
    assert a is not b
    np.testing.assert_array_equal(a, b)
    assert not cache_engine._img_cache


def test_image_cache_lru_eviction_bounds_bytes(cache_engine):
    size = cache_engine._decode_image(_png_bytes()).nbytes
    cache_engine._img_cache.clear()
    cache_engine._img_cache_bytes = 0
    cache_engine._img_cache_cap = size * 2  # room for two decoded images
    for seed in range(4):
        cache_engine._decode_image(_png_bytes(seed))
    assert cache_engine._img_cache_bytes <= size * 2
    assert len(cache_engine._img_cache) == 2  # the oldest were evicted


def test_prepare_pool_stays_within_its_window(w):
    """generate prepares pages on its pool at most max(16, 1.5 B) ahead of
    admission (each prepared page holds its pixels on the device), returns
    every result in order, and shuts the pool down."""
    import threading

    eng = _port_engine(w, max_batch_size=2, max_seq_len=128,
                       prefill_buckets=(128,))
    counts = {"prepared": 0, "admitted": 0, "ahead": 0}
    lock = threading.Lock()
    prepare, prefill_insert = eng.prepare, eng.prefill_insert

    def counted_prepare(request):
        with lock:
            counts["prepared"] += 1
            counts["ahead"] = max(counts["ahead"],
                                  counts["prepared"] - counts["admitted"])
        return prepare(request)

    def counted_insert(slot, prepared):
        with lock:
            counts["admitted"] += 1
        return prefill_insert(slot, prepared)

    eng.prepare, eng.prefill_insert = counted_prepare, counted_insert
    before = threading.active_count()
    reqs = [GenRequest(messages=[{"role": "user", "content": f"page {i}"}],
                       max_tokens=2, request_id=str(i)) for i in range(40)]
    results = eng.generate(reqs)
    assert [r.request_id for r in results] == [str(i) for i in range(40)]
    assert counts["prepared"] == counts["admitted"] == 40
    assert counts["ahead"] <= 16
    assert threading.active_count() == before
