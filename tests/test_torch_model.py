"""The port's model functions against the JAX package on the tiny config.

Weights come from the JAX package's init_params through from_jax_params;
inputs are made from seeds with numpy. float32 throughout, atol 1e-4: the
two frameworks sum in different orders, so agreement is to float32 rounding
accumulated over the layers, not bit-exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karanta_tpu.models.qwen25_vl import decoder as jdec
from karanta_tpu.models.qwen25_vl import vision as jvis
from karanta_tpu.models.qwen25_vl.config import tiny_config as j_tiny_config
from karanta_tpu.models.qwen25_vl.layout import build_vision_layout as j_layout
from karanta_tpu.models.qwen25_vl.model import init_params as j_init_params
from karanta_tpu.ops.image_prep import plan_image as j_plan_image
from karanta_tpu.ops.quantization import (
    quantize_decoder_params as j_quantize_decoder_params,
)
from karanta_tpu_torch.models.qwen25_vl import decoder as dec
from karanta_tpu_torch.models.qwen25_vl import vision as vis
from karanta_tpu_torch.models.qwen25_vl.config import tiny_config
from karanta_tpu_torch.models.qwen25_vl.convert import from_jax_params
from karanta_tpu_torch.models.qwen25_vl.layout import build_vision_layout
from karanta_tpu_torch.models.qwen25_vl.model import merge_image_embeddings
from karanta_tpu_torch.ops.image_prep import plan_image

ATOL = 1e-4
JCFG = j_tiny_config()
CFG = tiny_config()


@pytest.fixture(scope="module")
def jparams():
    return j_init_params(JCFG, jax.random.PRNGKey(3), jnp.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x, dtype=None):
    t = torch.from_numpy(np.asarray(x).copy())
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("hw", [(56, 84), (150, 230)])
def test_encode_image_matches_jax(jparams, hw):
    rng = np.random.default_rng(hw[0])
    plan = plan_image(*hw)
    assert dataclasses.astuple(plan) == dataclasses.astuple(j_plan_image(*hw))
    layout = build_vision_layout(plan, CFG.vision)
    jl = j_layout(plan, JCFG.vision)
    np.testing.assert_array_equal(layout.perm, jl.perm)
    pix = rng.normal(size=(plan.pad_tokens, CFG.vision.patch_input_dim))
    pix = pix.astype(np.float32)
    want = jvis.encode_image(jparams["visual"], JCFG.vision, jnp.asarray(pix),
                             jnp.asarray(jl.perm), jnp.asarray(jl.valid),
                             jnp.asarray(jl.pos_hw), jl.n_windows)
    want = np.asarray(jvis.extract_image_tokens(want, jl))
    params = from_jax_params(_np(jparams), CFG, "cpu", torch.float32)
    got = vis.encode_image(params["visual"], CFG.vision, _t(pix),
                           _t(layout.perm), _t(layout.valid),
                           _t(layout.pos_hw))
    got = vis.extract_image_tokens(got, layout).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def _prompt(batch=2, s=24, pad=4):
    rng = np.random.default_rng(4)
    emb = rng.normal(size=(batch, s, JCFG.text.hidden_size)).astype(np.float32)
    pos = np.stack([np.tile(np.arange(s), (3, 1)) + 5 * b
                    for b in range(batch)], axis=1).astype(np.int32)
    mask = np.ones((batch, s), np.float32)
    mask[1, s - pad:] = 0.0
    return emb, pos, mask


@pytest.mark.parametrize("act_quant", [False, True])
def test_prefill_forward_matches_jax(jparams, act_quant):
    emb, pos, mask = _prompt()
    jtext = jparams["text"]
    if act_quant:
        jtext = j_quantize_decoder_params(jtext)
    h_j, kv_j = jdec.prefill_forward(jtext, JCFG.text, jnp.asarray(emb),
                                     jnp.asarray(pos), jnp.asarray(mask),
                                     act_quant=act_quant)
    text = from_jax_params(_np({"text": jtext, "visual": jparams["visual"]}),
                           CFG, "cpu", torch.float32)["text"]
    h_t, kv_t = dec.prefill_forward(text, CFG.text, _t(emb), _t(pos),
                                    _t(mask), act_quant=act_quant)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=ATOL)
    np.testing.assert_allclose(kv_t.k.numpy(), np.asarray(kv_j.k), atol=ATOL)
    np.testing.assert_allclose(kv_t.v.numpy(), np.asarray(kv_j.v), atol=ATOL)
    logit_j = jdec.logits_from_hidden(jtext, JCFG.text, h_j[:, -1],
                                      act_quant=act_quant)
    logit_t = dec.logits_from_hidden(text, CFG.text, h_t[:, -1],
                                     act_quant=act_quant)
    np.testing.assert_allclose(logit_t.numpy(), np.asarray(logit_j),
                               atol=ATOL)


def test_decode_steps_over_int8_cache_match_jax(jparams):
    """Three decode steps over the int8 cache: hidden states and all four
    cache tensors agree with the JAX decode_step (its XLA path on the CPU)."""
    batch, m = 2, 32
    emb, pos, mask = _prompt(batch=batch, s=12, pad=0)
    jtext = j_quantize_decoder_params(jparams["text"])
    text = from_jax_params(_np({"text": jtext, "visual": jparams["visual"]}),
                           CFG, "cpu", torch.float32)["text"]
    _, pre = jdec.prefill_forward(jtext, JCFG.text, jnp.asarray(emb),
                                  jnp.asarray(pos))
    kq, ks = jdec.quantize_kv_rows(pre.k)
    vq, vs = jdec.quantize_kv_rows(pre.v)
    jc = jdec.QuantKVCache.zeros(JCFG.text, batch, m, jnp.float32)
    jc = jdec.QuantKVCache(jc.k.at[:, :, :, :12].set(kq),
                           jc.v.at[:, :, :, :12].set(vq),
                           jc.ks.at[:, :, :, :12].set(ks),
                           jc.vs.at[:, :, :, :12].set(vs))
    tc = dec.QuantKVCache(_t(jc.k), _t(jc.v), _t(jc.ks), _t(jc.vs))
    lens = np.asarray([12, 9], np.int32)
    rng = np.random.default_rng(9)
    for step in range(3):
        x = rng.normal(size=(batch, 1, JCFG.text.hidden_size))
        x = x.astype(np.float32)
        p = (pos[:, :, -1] + 1 + step).astype(np.int32)
        h_j, jc = jdec.decode_step(jtext, JCFG.text, jnp.asarray(x),
                                   jnp.asarray(p), jc, jnp.asarray(lens))
        h_t, tc = dec.decode_step(text, CFG.text, _t(x), _t(p), tc,
                                  _t(lens))
        np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=ATOL)
        lens = lens + 1
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jc.v))
    np.testing.assert_array_equal(tc.ks.numpy(), np.asarray(jc.ks))
    np.testing.assert_array_equal(tc.vs.numpy(), np.asarray(jc.vs))


def test_quantize_kv_rows_exact():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 2, 5, 64)) * 5).astype(np.float32)
    qj, sj = jdec.quantize_kv_rows(jnp.asarray(x))
    qt, st = dec.quantize_kv_rows(_t(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert st.dtype == torch.bfloat16
    np.testing.assert_array_equal(st.float().numpy(),
                                  np.asarray(sj, np.float32))


def test_merge_image_embeddings_drops_padding():
    rng = np.random.default_rng(1)
    emb = rng.normal(size=(10, 4)).astype(np.float32)
    img = rng.normal(size=(5, 4)).astype(np.float32)
    pos = np.asarray([2, 3, 7, 10, 10], np.int32)
    from karanta_tpu.models.qwen25_vl.model import (
        merge_image_embeddings as j_merge,
    )

    want = np.asarray(j_merge(jnp.asarray(emb), jnp.asarray(img),
                              jnp.asarray(pos)))
    got = merge_image_embeddings(_t(emb), _t(img), _t(pos)).numpy()
    np.testing.assert_array_equal(got, want)


def _random_caches(rng, quant, batch, m):
    """A populated cache of each kind (the JAX package's own test inputs):
    int8 rows with scales in [0.01, 0.1), or float rows."""
    shape = (JCFG.text.num_layers, batch, JCFG.text.num_kv_heads, m,
             JCFG.text.head_dim)
    if quant:
        jc = jdec.QuantKVCache(
            jnp.asarray(rng.integers(-127, 127, size=shape), jnp.int8),
            jnp.asarray(rng.integers(-127, 127, size=shape), jnp.int8),
            jnp.asarray(rng.uniform(0.01, 0.1, size=shape[:-1]), jnp.float32),
            jnp.asarray(rng.uniform(0.01, 0.1, size=shape[:-1]), jnp.float32))
        return jc, dec.QuantKVCache(_t(jc.k), _t(jc.v), _t(jc.ks), _t(jc.vs))
    jc = jdec.KVCache(jnp.asarray(rng.normal(size=shape), jnp.float32),
                      jnp.asarray(rng.normal(size=shape), jnp.float32))
    return jc, dec.KVCache(_t(jc.k), _t(jc.v))


def _assert_caches(tc, jc, quant):
    """int8 rows bit-equal and scales within 1e-6; float rows within 2e-5."""
    if quant:
        np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
        np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jc.v))
        np.testing.assert_allclose(tc.ks.numpy(), np.asarray(jc.ks),
                                   atol=1e-6)
        np.testing.assert_allclose(tc.vs.numpy(), np.asarray(jc.vs),
                                   atol=1e-6)
    else:
        np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=2e-5)
        np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), atol=2e-5)


@pytest.mark.parametrize("quant,act_quant", [(True, False), (True, True),
                                             (False, False)])
def test_decode_multi_matches_jax(jparams, quant, act_quant):
    """The verify pass (T = 4) over each cache: the int8 cache through the
    multi-token kernel's plain version, the float cache through scatter +
    decode_attention_multi; the JAX decode_multi takes its XLA path. Hidden
    states within atol/rtol 2e-4, as the JAX package's own kernel test
    (W8A8: see below); int8 caches bit-equal."""
    batch, m, tq = 2, 64, 4
    rng = np.random.default_rng(3)
    jc, tc = _random_caches(rng, quant, batch, m)
    jtext = (j_quantize_decoder_params(jparams["text"]) if act_quant
             else jparams["text"])
    text = from_jax_params(_np({"text": jtext, "visual": jparams["visual"]}),
                           CFG, "cpu", torch.float32)["text"]
    emb = rng.normal(size=(batch, tq, JCFG.text.hidden_size))
    emb = emb.astype(np.float32)
    pos = rng.integers(0, 40, size=(3, batch, tq)).astype(np.int32)
    lens = np.asarray([7, 33], np.int32)
    h_j, jc = jdec.decode_multi(jtext, JCFG.text, jnp.asarray(emb),
                                jnp.asarray(pos), jc, jnp.asarray(lens),
                                act_quant=act_quant)
    h_t, tc = dec.decode_multi(text, CFG.text, _t(emb), _t(pos), tc,
                               _t(lens), act_quant=act_quant)
    # W8A8: a float32 summation-order difference can move an activation
    # across an int8 rounding boundary, one quantization step (~7e-4 here)
    tol = 2e-3 if act_quant else 2e-4
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=tol,
                               rtol=2e-4)
    _assert_caches(tc, jc, quant)


def test_decode_steps_over_float_cache_match_jax(jparams):
    """Three decode steps over the cache in the activations' dtype (the bf16
    cache's path, float32 here): kernel #5's plain version against the JAX
    decode_step's dense path."""
    batch, m = 2, 64
    rng = np.random.default_rng(5)
    jc, tc = _random_caches(rng, False, batch, m)
    text = from_jax_params(_np(jparams), CFG, "cpu", torch.float32)["text"]
    lens = np.asarray([12, 40], np.int32)
    for step in range(3):
        x = rng.normal(size=(batch, 1, JCFG.text.hidden_size))
        x = x.astype(np.float32)
        p = (lens + 3).astype(np.int32)[None].repeat(3, 0)
        h_j, jc = jdec.decode_step(jparams["text"], JCFG.text, jnp.asarray(x),
                                   jnp.asarray(p), jc, jnp.asarray(lens))
        h_t, tc = dec.decode_step(text, CFG.text, _t(x), _t(p), tc,
                                  _t(lens))
        np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=ATOL)
        lens = lens + 1
    _assert_caches(tc, jc, False)


@pytest.mark.parametrize("act_quant", [False, True])
def test_prefill_with_prefix_matches_jax_and_full_prefill(jparams,
                                                          act_quant):
    """A suffix over a cached 10-token prefix: equal to the JAX
    prefill_with_prefix, and to the full prefill's suffix rows within the
    JAX package's own bounds (atol 2e-5, rtol 1e-4)."""
    emb, pos, _ = _prompt(batch=2, s=24, pad=0)
    emb, pos = emb[:1], pos[:, :1]
    jtext = jparams["text"]
    if act_quant:
        jtext = j_quantize_decoder_params(jtext)
    text = from_jax_params(_np({"text": jtext, "visual": jparams["visual"]}),
                           CFG, "cpu", torch.float32)["text"]
    p = 10
    _, jpre = jdec.prefill_forward(jtext, JCFG.text, jnp.asarray(emb[:, :p]),
                                   jnp.asarray(pos[:, :, :p]),
                                   act_quant=act_quant)
    h_j, kv_j = jdec.prefill_with_prefix(
        jtext, JCFG.text, jnp.asarray(emb[:, p:]), jnp.asarray(pos[:, :, p:]),
        jpre, jnp.ones((1, p), jnp.float32), act_quant=act_quant)
    h_full, kv_full = dec.prefill_forward(text, CFG.text, _t(emb), _t(pos),
                                          act_quant=act_quant)
    _, pre = dec.prefill_forward(text, CFG.text, _t(emb[:, :p]),
                                 _t(pos[:, :, :p]), act_quant=act_quant)
    h_t, kv_t = dec.prefill_with_prefix(text, CFG.text, _t(emb[:, p:]),
                                        _t(pos[:, :, p:]), pre,
                                        torch.ones((1, p)),
                                        act_quant=act_quant)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=ATOL)
    np.testing.assert_allclose(kv_t.k.numpy(), np.asarray(kv_j.k), atol=ATOL)
    if not act_quant:  # per-token activation scales differ with the split
        np.testing.assert_allclose(h_t.numpy(), h_full[:, p:].numpy(),
                                   atol=2e-5, rtol=1e-4)
        np.testing.assert_allclose(kv_t.k.numpy(), kv_full.k.numpy(),
                                   atol=2e-5)


def _q4_caches(rng, batch, m):
    """A populated int4 cache (random packed bytes and scales in
    [0.01, 0.1), the JAX package's own test inputs) for both packages."""
    shape = (JCFG.text.num_layers, batch, JCFG.text.num_kv_heads, m // 2,
             JCFG.text.head_dim)
    sshape = shape[:2] + (2 * JCFG.text.num_kv_heads, m // 2)
    jc = jdec.Q4KVCache(
        jnp.asarray(rng.integers(-128, 128, size=shape), jnp.int8),
        jnp.asarray(rng.integers(-128, 128, size=shape), jnp.int8),
        jnp.asarray(rng.uniform(0.01, 0.1, size=sshape), jnp.float32),
        jnp.asarray(rng.uniform(0.01, 0.1, size=sshape), jnp.float32))
    return jc, dec.Q4KVCache(_t(jc.k), _t(jc.v), _t(jc.ks), _t(jc.vs))


def test_decode_steps_over_int4_cache_match_jax(jparams):
    """A prompt's rows packed by q4_pack_prefill, then three decode steps
    over the int4 cache (kernel #6's plain version; the JAX decode_step's
    dense nibble path): hidden states within atol/rtol 2e-4, packed caches
    bit-equal, scales within 1e-6."""
    batch, m = 2, 128
    emb, pos, _ = _prompt(batch=batch, s=12, pad=0)
    jtext = j_quantize_decoder_params(jparams["text"])
    text = from_jax_params(_np({"text": jtext, "visual": jparams["visual"]}),
                           CFG, "cpu", torch.float32)["text"]
    _, pre = jdec.prefill_forward(jtext, JCFG.text, jnp.asarray(emb),
                                  jnp.asarray(pos))
    k4, v4, ks4, vs4 = jdec.q4_pack_prefill(pre.k, pre.v)
    ps = k4.shape[-2]
    jc = jdec.Q4KVCache.zeros(JCFG.text, batch, m, jnp.float32)
    jc = jdec.Q4KVCache(jc.k.at[:, :, :, :ps].set(k4),
                        jc.v.at[:, :, :, :ps].set(v4),
                        jc.ks.at[:, :, :, :ps].set(ks4),
                        jc.vs.at[:, :, :, :ps].set(vs4))
    tc = dec.Q4KVCache.zeros(CFG.text, batch, m, torch.float32)
    tk4, tv4, tks4, tvs4 = dec.q4_pack_prefill(_t(pre.k), _t(pre.v))
    for dst, src in ((tc.k, tk4), (tc.v, tv4), (tc.ks, tks4), (tc.vs, tvs4)):
        dst[:, :, :, :ps] = src.to(dst.dtype)
    _assert_caches(tc, jc, True)
    lens = np.asarray([12, 9], np.int32)
    rng = np.random.default_rng(9)
    for step in range(3):
        x = rng.normal(size=(batch, 1, JCFG.text.hidden_size))
        x = x.astype(np.float32)
        p = (pos[:, :, -1] + 1 + step).astype(np.int32)
        h_j, jc = jdec.decode_step(jtext, JCFG.text, jnp.asarray(x),
                                   jnp.asarray(p), jc, jnp.asarray(lens))
        h_t, tc = dec.decode_step(text, CFG.text, _t(x), _t(p), tc,
                                  _t(lens))
        np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=2e-4,
                                   rtol=2e-4)
        lens = lens + 1
    _assert_caches(tc, jc, True)


@pytest.mark.parametrize("act_quant", [False, True])
def test_decode_multi_over_int4_cache_matches_jax(jparams, act_quant):
    """The verify pass (T = 4) over the int4 cache, one slot's span crossing
    a 64-token window (lens 7 and 62): kernel #7's plain version against
    the JAX decode_multi's dense nibble path; tolerances as for the int8
    cache."""
    batch, m, tq = 2, 128, 4
    rng = np.random.default_rng(5)
    jc, tc = _q4_caches(rng, batch, m)
    jtext = (j_quantize_decoder_params(jparams["text"]) if act_quant
             else jparams["text"])
    text = from_jax_params(_np({"text": jtext, "visual": jparams["visual"]}),
                           CFG, "cpu", torch.float32)["text"]
    emb = rng.normal(size=(batch, tq, JCFG.text.hidden_size))
    emb = emb.astype(np.float32)
    pos = rng.integers(0, 40, size=(3, batch, tq)).astype(np.int32)
    lens = np.asarray([7, 62], np.int32)
    h_j, jc = jdec.decode_multi(jtext, JCFG.text, jnp.asarray(emb),
                                jnp.asarray(pos), jc, jnp.asarray(lens),
                                act_quant=act_quant)
    h_t, tc = dec.decode_multi(text, CFG.text, _t(emb), _t(pos), tc,
                               _t(lens), act_quant=act_quant)
    tol = 2e-3 if act_quant else 2e-4
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=tol,
                               rtol=2e-4)
    _assert_caches(tc, jc, True)


def test_stacked_decode_mode_equals_default(jparams, monkeypatch):
    """KARANTA_PAGED_DECODE=stacked (scatter + kernel #9's plain version)
    and the JAX package's dense mode "0" (scatter + dense attention over the
    bucket) give the default mode's hidden states and caches within 1e-6
    (kernel #5's plain version sums in another order, and a layer's rows
    follow the layers below it); other values raise ValueError; the
    quantized caches ignore the variable."""
    batch, m = 2, 64
    text = from_jax_params(_np(jparams), CFG, "cpu", torch.float32)["text"]
    rng = np.random.default_rng(8)
    x = _t(rng.normal(size=(batch, 1, JCFG.text.hidden_size))
           .astype(np.float32))
    p = _t(np.asarray([[20, 41]] * 3, np.int32))
    lens = _t(np.asarray([20, 41], np.int32))
    out = {}
    for mode in (None, "1", "stacked", "0"):
        if mode is None:
            monkeypatch.delenv("KARANTA_PAGED_DECODE", raising=False)
        else:
            monkeypatch.setenv("KARANTA_PAGED_DECODE", mode)
        _, tc = _random_caches(np.random.default_rng(4), False, batch, m)
        h, tc = dec.decode_step(text, CFG.text, x, p, tc, lens)
        out[mode] = (h, tc)
    for mode in ("1", "stacked", "0"):
        np.testing.assert_allclose(out[mode][0].numpy(), out[None][0].numpy(),
                                   atol=1e-6)
        for part in ("k", "v"):
            np.testing.assert_allclose(getattr(out[mode][1], part).numpy(),
                                       getattr(out[None][1], part).numpy(),
                                       atol=1e-6)
    for mode in ("0", "dense"):
        monkeypatch.setenv("KARANTA_PAGED_DECODE", mode)
        if mode == "dense":
            _, tc = _random_caches(np.random.default_rng(4), False, batch, m)
            with pytest.raises(ValueError, match="dense"):
                dec.decode_step(text, CFG.text, x, p, tc, lens)
        _, qc = _random_caches(np.random.default_rng(4), True, batch, m)
        dec.decode_step(text, CFG.text, x, p, qc, lens)
