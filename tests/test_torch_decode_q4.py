"""The port's int4 KV cache against the JAX package: the packing helpers bit
for bit, and the plain versions of kernels #6 and #7 against the JAX Pallas
kernels run with ``interpret=True``, at the shapes of the JAX package's own
tests (``tests/test_paged_decode.py:372-531``, ``tests/test_kv_quant.py``).

Tolerances: attention within atol 5e-3 (the Pallas kernels round their
V-scaled probabilities to the compute dtype before the PV product; the port
keeps float32), packed caches bit-equal, scales within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karanta_tpu.models.qwen25_vl import decoder as jdec
from karanta_tpu_torch.models.qwen25_vl import decoder as dec
from karanta_tpu_torch.ops import decode_attention as DA


def _t(x):
    return torch.from_numpy(np.array(x))


def test_quantize_kv_rows_q4_matches_jitted_jax():
    """Bit-equal to the JAX function as its decode step and insert run it
    (inside jit, where XLA multiplies by the reciprocal of 7), over enough
    rows to meet the one in ~200,000 where a division would differ."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(200_000, 16))
         * rng.uniform(0.01, 50, size=(200_000, 1))).astype(np.float32)
    qj, sj = jax.jit(jdec.quantize_kv_rows_q4)(jnp.asarray(x))
    qt, st = dec.quantize_kv_rows_q4(_t(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert st.dtype == torch.bfloat16
    np.testing.assert_array_equal(st.float().numpy(),
                                  np.asarray(sj, np.float32))
    assert int(qt.abs().max()) <= 7


def test_pack_helpers_match_jax():
    rng = np.random.default_rng(11)
    q = rng.integers(-8, 8, size=(2, 3, 128, 32)).astype(np.int8)
    s = rng.uniform(0.01, 1.0, size=(2, 3, 128)).astype(np.float32)
    packed = jdec.pack_q4_rows(jnp.asarray(q))
    np.testing.assert_array_equal(dec.pack_q4_rows(_t(q)).numpy(),
                                  np.asarray(packed))
    np.testing.assert_array_equal(dec.unpack_q4_rows(_t(packed)).numpy(), q)
    planes = jdec.pack_q4_scales(jnp.asarray(s))
    np.testing.assert_array_equal(dec.pack_q4_scales(_t(s)).numpy(),
                                  np.asarray(planes))
    np.testing.assert_array_equal(dec.unpack_q4_scales(_t(planes)).numpy(), s)
    u = rng.integers(0, 256, size=(1000,)).astype(np.int32)
    np.testing.assert_array_equal(dec.bits_to_int8(_t(u)).numpy(),
                                  np.asarray(jdec._bits_to_int8(
                                      jnp.asarray(u))))
    pos = np.arange(300, dtype=np.int32)
    for got, want in zip(dec.q4_row_nib(_t(pos)),
                         jdec._q4_row_nib(jnp.asarray(pos))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("s", [70, 128])
def test_q4_pack_prefill_matches_jax(s):
    """The oracle of tests/test_kv_quant.py:166-178: S pads to a whole
    64-token window (70 -> 128 tokens, 64 packed rows) with dead nibbles."""
    rng = np.random.default_rng(3)
    k = rng.normal(size=(2, 2, s, 32)).astype(np.float32)
    v = rng.normal(size=(2, 2, s, 32)).astype(np.float32)
    want = jax.jit(jdec.q4_pack_prefill)(jnp.asarray(k), jnp.asarray(v))
    got = dec.q4_pack_prefill(_t(k), _t(v))
    assert tuple(got[0].shape) == (2, 2, 64, 32)
    assert tuple(got[2].shape) == (2, 4, 64)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))
    kq, _ = dec.quantize_kv_rows_q4(_t(k))
    np.testing.assert_array_equal(dec.unpack_q4_rows(got[0])[:, :, :s].numpy(),
                                  kq.numpy())


def test_q4_cache_needs_whole_windows():
    from karanta_tpu_torch.models.qwen25_vl.config import tiny_config

    cfg = tiny_config().text
    c = dec.Q4KVCache.zeros(cfg, 2, 128, torch.float32)
    assert tuple(c.k.shape) == (cfg.num_layers, 2, cfg.num_kv_heads, 64,
                                cfg.head_dim)
    assert tuple(c.ks.shape) == (cfg.num_layers, 2, 2 * cfg.num_kv_heads, 64)
    with pytest.raises(ValueError, match="64"):
        dec.Q4KVCache.zeros(cfg, 2, 100, torch.float32)


def _token_caches(rng, L, B, KVH, M, D):
    """Token-ordered int4 caches and scales (the JAX tests' inputs)."""
    return (rng.integers(-7, 8, size=(L, B, KVH, M, D)).astype(np.int8),
            rng.integers(-7, 8, size=(L, B, KVH, M, D)).astype(np.int8),
            rng.uniform(0.01, 0.1, size=(L, B, KVH, M)).astype(np.float32),
            rng.uniform(0.01, 0.1, size=(L, B, KVH, M)).astype(np.float32))


def _packed(k, v, ks, vs):
    return (jdec.pack_q4_rows(jnp.asarray(k)), jdec.pack_q4_rows(jnp.asarray(v)),
            jdec.pack_q4_scales(jnp.asarray(ks)),
            jdec.pack_q4_scales(jnp.asarray(vs)))


def _new_rows(rng, lead, KVH, D):
    nkq, nks = jdec.quantize_kv_rows_q4(
        jnp.asarray(rng.normal(size=lead + (KVH, D)), jnp.float32))
    nvq, nvs = jdec.quantize_kv_rows_q4(
        jnp.asarray(rng.normal(size=lead + (KVH, D)), jnp.float32))
    return nkq, nvq, nks.astype(jnp.float32), nvs.astype(jnp.float32)


def _assert_same(attn_t, attn_j, caches_t, caches_j):
    np.testing.assert_allclose(attn_t.numpy(), np.asarray(attn_j), atol=5e-3)
    for got, want, exact in zip(caches_t, caches_j, (True, True, False, False)):
        if exact:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-6)


def test_q4_plain_matches_pallas():
    """Kernel #6's plain version (through its wrapper on CPU tensors) against
    the JAX Pallas kernel at tests/test_paged_decode.py:372-421."""
    from karanta_tpu.ops.decode_attention import paged_decode_append_q4

    rng = np.random.default_rng(13)
    L, B, M, H, KVH, D = 2, 4, 256, 8, 2, 64
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    caches = _packed(*_token_caches(rng, L, B, KVH, M, D))
    new = _new_rows(rng, (B,), KVH, D)
    lens = [0, 5, 200, 255]
    attn_j, *caches_j = paged_decode_append_q4(
        jnp.asarray(q), *new, *caches, jnp.asarray(0),
        jnp.asarray(lens, jnp.int32), block=128, interpret=True)
    caches_t = [_t(c) for c in caches]
    attn_t = DA.paged_decode_append_q4(
        _t(q), *(_t(x) for x in new), *caches_t, 0,
        torch.tensor(lens, dtype=torch.int32))
    _assert_same(attn_t, attn_j, caches_t, caches_j)


@pytest.mark.parametrize("tq,lens", [
    (3, [0, 5, 200, 248]),
    (5, [31, 32, 63, 127]),   # spans crossing the 32-row tile
    (4, [60, 62, 95, 126]),   # spans crossing the 64-token window
])
def test_multi_q4_plain_matches_pallas(tq, lens):
    """Kernel #7's plain version against the JAX Pallas kernel at the cases
    of tests/test_paged_decode.py:473-531 (layer 1)."""
    from karanta_tpu.ops.decode_attention import paged_decode_append_multi_q4

    rng = np.random.default_rng(17)
    L, B, M, H, KVH, D = 2, 4, 256, 8, 2, 64
    q = rng.normal(size=(B, tq, H, D)).astype(np.float32)
    caches = _packed(*_token_caches(rng, L, B, KVH, M, D))
    new = _new_rows(rng, (B, tq), KVH, D)
    attn_j, *caches_j = paged_decode_append_multi_q4(
        jnp.asarray(q), *new, *caches, jnp.asarray(1),
        jnp.asarray(lens, jnp.int32), block=128, interpret=True)
    caches_t = [_t(c) for c in caches]
    attn_t = DA.paged_decode_append_multi_q4(
        _t(q), *(_t(x) for x in new), *caches_t, 1,
        torch.tensor(lens, dtype=torch.int32))
    _assert_same(attn_t, attn_j, caches_t, caches_j)


def test_q4_wrappers_reject_bad_shapes():
    q = torch.zeros(2, 1, 4, 16)
    nk = torch.zeros(2, 2, 16, dtype=torch.int8)
    sc = torch.ones(2, 2)
    lens = torch.zeros(2, dtype=torch.int32)
    bad_pm = torch.zeros(1, 2, 2, 20, 16, dtype=torch.int8)
    with pytest.raises(ValueError, match="32"):
        DA.paged_decode_append_q4(q, nk, nk, sc, sc, bad_pm, bad_pm,
                                  torch.ones(1, 2, 4, 20),
                                  torch.ones(1, 2, 4, 20), 0, lens)
    cache = torch.zeros(1, 2, 2, 64, 16, dtype=torch.int8)
    planes = torch.ones(1, 2, 4, 64)
    with pytest.raises(ValueError, match="32"):
        DA.paged_decode_append_multi_q4(
            torch.zeros(2, 33, 4, 16), torch.zeros(2, 33, 2, 16,
                                                   dtype=torch.int8),
            torch.zeros(2, 33, 2, 16, dtype=torch.int8), torch.ones(2, 33, 2),
            torch.ones(2, 33, 2), cache, cache, planes, planes, 0, lens)
    with pytest.raises(ValueError, match="new_ks"):
        DA.paged_decode_append_q4(q, nk, nk, torch.ones(2, 4), sc, cache,
                                  cache, planes, planes, 0, lens)


@pytest.mark.parametrize("layer,lens", [
    (1, [0, 61, 130, 251]),   # the last span crosses the 64-token window
    (0, [28, 30, 93, 190]),   # spans crossing the 32-row tile
])
def test_multi_q4_plain_matches_pallas_bf16(layer, lens):
    """Kernel #7's plain version against the JAX Pallas kernel
    (``interpret=True``) at the 7B's heads (H = 28, KVH = 4, D = 128, T = 4)
    with bf16 activations and scales, under the card's bf16 rule (the Pallas
    kernel rounds p * vsc to bf16 before P.V, the plain version does not);
    all four caches bit-equal."""
    from karanta_tpu.ops.decode_attention import paged_decode_append_multi_q4

    rng = np.random.default_rng(90 + layer)
    L, B, M, H, KVH, D, tq = 2, 4, 256, 28, 4, 128, 4
    x = rng.normal(size=(B, tq, H, D)).astype(np.float32)
    jq, q = jnp.asarray(x, jnp.bfloat16), _t(x).to(torch.bfloat16)
    caches = [c.astype(jnp.bfloat16) if i >= 2 else c for i, c in
              enumerate(_packed(*_token_caches(rng, L, B, KVH, M, D)))]
    new = [c.astype(jnp.bfloat16) if i >= 2 else c for i, c in
           enumerate(_new_rows(rng, (B, tq), KVH, D))]
    attn_j, *caches_j = paged_decode_append_multi_q4(
        jq, *new, *caches, jnp.asarray(layer), jnp.asarray(lens, jnp.int32),
        block=128, interpret=True)

    def tt(x):
        return (_t(np.asarray(x, np.float32)).to(torch.bfloat16)
                if x.dtype == jnp.bfloat16 else _t(x))

    caches_t = [tt(c) for c in caches]
    got = DA.paged_decode_append_multi_q4(
        q, *(tt(x) for x in new), *caches_t, layer,
        torch.tensor(lens, dtype=torch.int32))
    assert got.dtype == torch.bfloat16
    want = np.asarray(attn_j).astype(np.float32)
    limit = 2.0 ** -7 * np.abs(want) + 2.0 ** -9 * np.abs(want).max()
    err = np.abs(got.float().numpy() - want)
    assert np.isfinite(err).all() and (err <= limit).all(), (
        f"worst error/limit {float((err / limit).max()):.3g}")
    for g, w in zip(caches_t, caches_j):
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w).astype(np.float32))


@pytest.mark.parametrize("layer,lens", [
    (1, [0, 31, 32, 33]),     # on and beside the 32-row tile
    (0, [63, 64, 65, 255]),   # on and beside the 64-token window, M - 1
    (1, [95, 96, 127, 190]),  # the second window's tile edge and tail
])
def test_q4_plain_matches_pallas_bf16(layer, lens):
    """Kernel #6's plain version against the JAX Pallas kernel
    (``interpret=True``) at the 7B's heads (H = 28, KVH = 4, D = 128) with
    bf16 activations and scales, under the card's bf16 rule (the Pallas
    kernel rounds p * vsc to bf16 before P.V, the plain version does not);
    all four caches bit-equal."""
    from karanta_tpu.ops.decode_attention import paged_decode_append_q4

    rng = np.random.default_rng(70 + layer + lens[0])
    L, B, M, H, KVH, D = 2, 4, 256, 28, 4, 128
    x = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    jq, q = jnp.asarray(x, jnp.bfloat16), _t(x).to(torch.bfloat16)
    caches = [c.astype(jnp.bfloat16) if i >= 2 else c for i, c in
              enumerate(_packed(*_token_caches(rng, L, B, KVH, M, D)))]
    new = [c.astype(jnp.bfloat16) if i >= 2 else c for i, c in
           enumerate(_new_rows(rng, (B,), KVH, D))]
    attn_j, *caches_j = paged_decode_append_q4(
        jq, *new, *caches, jnp.asarray(layer), jnp.asarray(lens, jnp.int32),
        block=128, interpret=True)

    def tt(x):
        return (_t(np.asarray(x, np.float32)).to(torch.bfloat16)
                if x.dtype == jnp.bfloat16 else _t(x))

    caches_t = [tt(c) for c in caches]
    got = DA.paged_decode_append_q4(
        q, *(tt(x) for x in new), *caches_t, layer,
        torch.tensor(lens, dtype=torch.int32))
    assert got.dtype == torch.bfloat16
    want = np.asarray(attn_j).astype(np.float32)
    limit = 2.0 ** -7 * np.abs(want) + 2.0 ** -9 * np.abs(want).max()
    err = np.abs(got.float().numpy() - want)
    assert np.isfinite(err).all() and (err <= limit).all(), (
        f"worst error/limit {float((err / limit).max()):.3g}")
    for g, w in zip(caches_t, caches_j):
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w).astype(np.float32))
