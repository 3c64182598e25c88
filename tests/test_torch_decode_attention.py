"""The port's int8 append+decode kernel's plain version against the JAX
Pallas kernel (``interpret=True``), at the shapes of the JAX package's own
test: attention within atol 5e-3 (the Pallas kernel rounds its V
probabilities to the activation dtype), all four caches exactly equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karanta_tpu.models.qwen25_vl.decoder import quantize_kv_rows as j_qkv_rows
from karanta_tpu.ops.attention import decode_attention as j_decode_attention
from karanta_tpu.ops.decode_attention import (
    paged_decode_append_quant as j_append_quant,
)
from karanta_tpu_torch.ops.attention import decode_attention
from karanta_tpu_torch.ops.decode_attention import (
    paged_decode_append_quant, paged_decode_append_quant_plain)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _inputs(seed, L, B, M, H, KVH, D):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    kq, ks = j_qkv_rows(jnp.asarray(rng.normal(size=(L, B, KVH, M, D)),
                                    jnp.float32))
    vq, vs = j_qkv_rows(jnp.asarray(rng.normal(size=(L, B, KVH, M, D)),
                                    jnp.float32))
    nkq, nks = j_qkv_rows(jnp.asarray(rng.normal(size=(B, KVH, D)),
                                      jnp.float32))
    nvq, nvs = j_qkv_rows(jnp.asarray(rng.normal(size=(B, KVH, D)),
                                      jnp.float32))
    return q, kq, ks, vq, vs, nkq, nks, nvq, nvs


@pytest.mark.parametrize("layer,lens", [(0, [0, 5, 200, 255]),
                                        (1, [255, 128, 1, 64])])
def test_plain_matches_pallas(layer, lens):
    L, B, M, H, KVH, D = 2, 4, 256, 8, 2, 64
    q, kq, ks, vq, vs, nkq, nks, nvq, nvs = _inputs(7 + layer, L, B, M, H,
                                                    KVH, D)
    # the JAX cache stores scales as bf16 (quantize_kv_rows); so does ours
    attn_j, k2, v2, ks2, vs2 = j_append_quant(
        jnp.asarray(q), nkq, nvq, nks, nvs, kq, vq, ks, vs,
        jnp.asarray(layer), jnp.asarray(lens, jnp.int32), block=128,
        interpret=True)
    tk, tv = _t(kq), _t(vq)
    tks = _t(np.asarray(ks, np.float32)).to(torch.bfloat16)
    tvs = _t(np.asarray(vs, np.float32)).to(torch.bfloat16)
    attn_t = paged_decode_append_quant(
        _t(q), _t(nkq), _t(nvq),
        _t(np.asarray(nks, np.float32)).to(torch.bfloat16),
        _t(np.asarray(nvs, np.float32)).to(torch.bfloat16),
        tk, tv, tks, tvs, layer, torch.tensor(lens, dtype=torch.int32))
    np.testing.assert_allclose(attn_t.numpy(), np.asarray(attn_j), atol=5e-3)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(k2))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(v2))
    np.testing.assert_array_equal(tks.float().numpy(),
                                  np.asarray(ks2, np.float32))
    np.testing.assert_array_equal(tvs.float().numpy(),
                                  np.asarray(vs2, np.float32))


def test_plain_matches_dense_decode_attention():
    """The two-part sum equals dense attention over the appended cache (the
    JAX decode_attention with scales) to float32 rounding."""
    L, B, M, H, KVH, D = 1, 3, 64, 4, 2, 16
    q, kq, ks, vq, vs, nkq, nks, nvq, nvs = _inputs(3, L, B, M, H, KVH, D)
    lens = np.asarray([0, 17, 63], np.int32)
    ks32, vs32 = np.asarray(ks, np.float32), np.asarray(vs, np.float32)
    tk, tv, tks, tvs = _t(kq), _t(vq), _t(ks32), _t(vs32)
    got = paged_decode_append_quant_plain(
        _t(q), _t(nkq), _t(nvq), _t(np.asarray(nks, np.float32)),
        _t(np.asarray(nvs, np.float32)), tk, tv, tks, tvs, 0, _t(lens))
    mask = (np.arange(M)[None] <= lens[:, None]).astype(np.float32)
    want = j_decode_attention(jnp.asarray(q), jnp.asarray(tk[0].numpy()),
                              jnp.asarray(tv[0].numpy()), jnp.asarray(mask),
                              k_scale=jnp.asarray(tks[0].numpy()),
                              v_scale=jnp.asarray(tvs[0].numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    torch_dense = decode_attention(_t(q), tk[0], tv[0], _t(mask),
                                   k_scale=tks[0], v_scale=tvs[0])
    np.testing.assert_allclose(torch_dense.numpy(), np.asarray(want),
                               atol=1e-5)


def test_rejects_mismatched_shapes():
    q = torch.zeros(2, 1, 4, 16)
    cache = torch.zeros(1, 2, 2, 8, 16, dtype=torch.int8)
    sc = torch.ones(1, 2, 2, 8)
    with pytest.raises(ValueError):
        paged_decode_append_quant(q, torch.zeros(2, 2, 16, dtype=torch.int8),
                                  torch.zeros(2, 2, 16, dtype=torch.int8),
                                  torch.ones(2, 2), torch.ones(2, 2), cache,
                                  cache, sc, sc, 1,
                                  torch.zeros(2, dtype=torch.int32))


@pytest.mark.parametrize("tq,lens", [(3, [0, 5, 200, 248]),
                                     (5, [31, 32, 63, 127])])
def test_multi_plain_matches_pallas_and_dense(tq, lens):
    """Kernel #4's plain version against the JAX Pallas kernel
    (``interpret=True``) and against scatter + ``decode_attention_multi``, at
    the cases of the JAX package's own test (layer 1): attention within atol
    5e-3, int8 caches bit-equal, scales within 1e-6."""
    from karanta_tpu.ops.attention import (
        decode_attention_multi as j_decode_multi,
    )
    from karanta_tpu.ops.decode_attention import (
        paged_decode_append_multi_quant as j_multi,
    )
    from karanta_tpu_torch.ops.attention import decode_attention_multi
    from karanta_tpu_torch.ops.decode_attention import (
        paged_decode_append_multi_quant)

    rng = np.random.default_rng(11)
    L, B, M, H, KVH, D = 2, 4, 256, 8, 2, 64
    q = rng.normal(size=(B, tq, H, D)).astype(np.float32)
    kq, ks = j_qkv_rows(jnp.asarray(rng.normal(size=(L, B, KVH, M, D)),
                                    jnp.float32))
    vq, vs = j_qkv_rows(jnp.asarray(rng.normal(size=(L, B, KVH, M, D)),
                                    jnp.float32))
    nkq, nks = j_qkv_rows(jnp.asarray(rng.normal(size=(B, tq, KVH, D)),
                                      jnp.float32))
    nvq, nvs = j_qkv_rows(jnp.asarray(rng.normal(size=(B, tq, KVH, D)),
                                      jnp.float32))
    lens_j = jnp.asarray(lens, jnp.int32)
    attn_j, k2, v2, ks2, vs2 = j_multi(
        jnp.asarray(q), nkq, nvq, nks, nvs, kq, vq, ks, vs, jnp.asarray(1),
        lens_j, block=128, interpret=True)
    bidx = jnp.arange(B)[:, None]
    wpos = lens_j[:, None] + jnp.arange(tq)[None]
    want = j_decode_multi(
        jnp.asarray(q), kq.at[1, bidx, :, wpos].set(nkq)[1],
        vq.at[1, bidx, :, wpos].set(nvq)[1], lens_j,
        k_scale=ks.at[1, bidx, :, wpos].set(nks)[1],
        v_scale=vs.at[1, bidx, :, wpos].set(nvs)[1])

    def bf(x):
        return _t(np.asarray(x, np.float32)).to(torch.bfloat16)

    tk, tv, tks, tvs = _t(kq), _t(vq), bf(ks), bf(vs)
    lens_t = torch.tensor(lens, dtype=torch.int32)
    attn_t = paged_decode_append_multi_quant(
        _t(q), _t(nkq), _t(nvq), bf(nks), bf(nvs), tk, tv, tks, tvs, 1,
        lens_t)
    np.testing.assert_allclose(attn_t.numpy(), np.asarray(attn_j), atol=5e-3)
    np.testing.assert_allclose(attn_t.numpy(), np.asarray(want), atol=5e-3)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(k2))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(v2))
    np.testing.assert_allclose(tks.float().numpy(),
                               np.asarray(ks2, np.float32), atol=1e-6)
    np.testing.assert_allclose(tvs.float().numpy(),
                               np.asarray(vs2, np.float32), atol=1e-6)
    # the port's own dense verify attention over the appended caches
    dense = decode_attention_multi(_t(q), tk[1], tv[1], lens_t,
                                   k_scale=tks[1], v_scale=tvs[1])
    np.testing.assert_allclose(dense.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("layer,lens", [(0, [0, 5, 200, 255]),
                                        (1, [64, 64, 63, 1])])
def test_append_plain_matches_pallas(layer, lens):
    """Kernel #5's plain version against the JAX Pallas kernel
    (``interpret=True``) and scatter + dense attention, float32, with the
    tolerances of the JAX package's own test: atol 3e-6, caches exact."""
    from karanta_tpu.ops.decode_attention import (
        paged_decode_append as j_append,
    )
    from karanta_tpu_torch.ops.decode_attention import paged_decode_append

    rng = np.random.default_rng(5)
    L, B, M, H, KVH, D = 2, 4, 256, 8, 2, 64
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    nk = rng.normal(size=(B, KVH, D)).astype(np.float32)
    nv = rng.normal(size=(B, KVH, D)).astype(np.float32)
    k = rng.normal(size=(L, B, KVH, M, D)).astype(np.float32)
    v = rng.normal(size=(L, B, KVH, M, D)).astype(np.float32)
    lens_j = jnp.asarray(lens, jnp.int32)
    attn_j, k2, v2 = j_append(jnp.asarray(q), jnp.asarray(nk),
                              jnp.asarray(nv), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(layer), lens_j, block=128,
                              interpret=True)
    bidx = jnp.arange(B)
    k_ref = jnp.asarray(k).at[layer, bidx, :, lens_j].set(nk)
    v_ref = jnp.asarray(v).at[layer, bidx, :, lens_j].set(nv)
    mask = (jnp.arange(M)[None, :] <= lens_j[:, None]).astype(jnp.float32)
    want = j_decode_attention(jnp.asarray(q), k_ref[layer], v_ref[layer], mask)
    tk, tv = _t(k), _t(v)
    attn_t = paged_decode_append(_t(q), _t(nk), _t(nv), tk, tv, layer,
                                 torch.tensor(lens, dtype=torch.int32))
    np.testing.assert_allclose(attn_t.numpy(), np.asarray(attn_j), atol=3e-6)
    np.testing.assert_allclose(attn_t.numpy(), np.asarray(want), atol=3e-6)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(k2))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(v2))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(k_ref))


@pytest.mark.parametrize("lens", [[5, 200, 511, 0], [63, 64, 65, 255]])
def test_read_only_plain_matches_pallas(lens):
    """Kernel #8's plain version (through its wrapper on CPU tensors) against
    the JAX Pallas kernel (``interpret=True``) and the dense reference, at
    the shape of the JAX package's own test, float32: atol 3e-6."""
    from karanta_tpu.ops.decode_attention import (
        paged_decode_attention as j_paged,
    )
    from karanta_tpu_torch.ops.decode_attention import paged_decode_attention

    rng = np.random.default_rng(0)
    B, M, H, KVH, D = 4, 512, 8, 2, 64
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    k = rng.normal(size=(B, KVH, M, D)).astype(np.float32)
    v = rng.normal(size=(B, KVH, M, D)).astype(np.float32)
    lens_j = jnp.asarray(lens, jnp.int32)
    attn_j = j_paged(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), lens_j,
                     block=128, interpret=True)
    mask = (jnp.arange(M)[None, :] <= lens_j[:, None]).astype(jnp.float32)
    want = j_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              mask)
    got = paged_decode_attention(_t(q), _t(k), _t(v),
                                 torch.tensor(lens, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(attn_j), atol=3e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-6)


def test_stacked_plain_matches_pallas():
    """Kernel #9's plain version against the JAX stacked kernel at layer 2
    (``interpret=True``): atol 2e-6, caches untouched."""
    from karanta_tpu.ops.decode_attention import (
        paged_decode_attention_stacked as j_stacked,
    )
    from karanta_tpu_torch.ops.decode_attention import (
        paged_decode_attention_stacked)

    rng = np.random.default_rng(1)
    L, B, M, H, KVH, D = 3, 4, 256, 8, 2, 64
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    k = rng.normal(size=(L, B, KVH, M, D)).astype(np.float32)
    v = rng.normal(size=(L, B, KVH, M, D)).astype(np.float32)
    lens = [5, 100, 255, 64]
    attn_j, _, _ = j_stacked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(2), jnp.asarray(lens, jnp.int32),
                             block=128, interpret=True)
    tk, tv = _t(k), _t(v)
    got = paged_decode_attention_stacked(_t(q), tk, tv, 2,
                                         torch.tensor(lens, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(attn_j), atol=2e-6)
    np.testing.assert_array_equal(tk.numpy(), k)
    np.testing.assert_array_equal(tv.numpy(), v)
    with pytest.raises(ValueError, match="layer"):
        paged_decode_attention_stacked(_t(q), tk, tv, 3,
                                       torch.tensor(lens, dtype=torch.int32))


def _assert_bf16_rule(got, want):
    """The card's bf16 rule, per element: 2^-7 |want| + 2^-9 max|want|."""
    limit = 2.0 ** -7 * np.abs(want) + 2.0 ** -9 * np.abs(want).max()
    assert np.isfinite(got).all() and (np.abs(got - want) <= limit).all(), (
        f"worst error/limit {float((np.abs(got - want) / limit).max()):.3g}")


def _bf16(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), _t(x).to(torch.bfloat16)


@pytest.mark.parametrize("lens", [[5, 200, 511, 0], [63, 64, 65, 255]])
def test_read_only_plain_matches_pallas_bf16(lens):
    """Kernel #8's plain version against the JAX Pallas kernel
    (``interpret=True``) on a bf16 cache, under the card's bf16 rule (the
    Pallas kernel rounds P to bf16 before P.V, the plain version does
    not)."""
    from karanta_tpu.ops.decode_attention import (
        paged_decode_attention as j_paged,
    )
    from karanta_tpu_torch.ops.decode_attention import paged_decode_attention

    rng = np.random.default_rng(30 + lens[0])
    B, M, H, KVH, D = 4, 512, 8, 2, 64
    (jq, tq), (jk, tk), (jv, tv) = (_bf16(rng, s) for s in
                                    ((B, 1, H, D), (B, KVH, M, D),
                                     (B, KVH, M, D)))
    want = np.asarray(j_paged(jq, jk, jv, jnp.asarray(lens, jnp.int32),
                              block=128, interpret=True)).astype(np.float32)
    got = paged_decode_attention(tq, tk, tv,
                                 torch.tensor(lens, dtype=torch.int32))
    assert got.dtype == torch.bfloat16
    _assert_bf16_rule(got.float().numpy(), want)


def test_stacked_plain_matches_pallas_bf16():
    """Kernel #9's plain version against the JAX stacked kernel at layer 2
    (``interpret=True``) on a bf16 cache, under the card's bf16 rule; the
    caches are untouched."""
    from karanta_tpu.ops.decode_attention import (
        paged_decode_attention_stacked as j_stacked,
    )
    from karanta_tpu_torch.ops.decode_attention import (
        paged_decode_attention_stacked)

    rng = np.random.default_rng(41)
    L, B, M, H, KVH, D = 3, 4, 256, 8, 2, 64
    (jq, tq), (jk, tk), (jv, tv) = (_bf16(rng, s) for s in
                                    ((B, 1, H, D), (L, B, KVH, M, D),
                                     (L, B, KVH, M, D)))
    lens = [5, 100, 255, 64]
    k0, v0 = tk.clone(), tv.clone()
    attn_j, _, _ = j_stacked(jq, jk, jv, jnp.asarray(2),
                             jnp.asarray(lens, jnp.int32), block=128,
                             interpret=True)
    got = paged_decode_attention_stacked(tq, tk, tv, 2,
                                         torch.tensor(lens, dtype=torch.int32))
    assert got.dtype == torch.bfloat16
    _assert_bf16_rule(got.float().numpy(),
                      np.asarray(attn_j).astype(np.float32))
    assert torch.equal(tk, k0) and torch.equal(tv, v0)


@pytest.mark.parametrize("layer,lens", [(1, [0, 37, 128, 251]),
                                        (0, [5, 100, 200, 250])])
def test_multi_plain_matches_pallas_bf16(layer, lens):
    """Kernel #4's plain version against the JAX Pallas kernel
    (``interpret=True``) at the 7B's heads (H = 28, KVH = 4, D = 128, T = 4)
    with bf16 activations, under the card's bf16 rule (the Pallas kernel
    rounds p * vsc to bf16 before P.V, the plain version does not); all four
    caches bit-equal."""
    from karanta_tpu.ops.decode_attention import (
        paged_decode_append_multi_quant as j_multi,
    )
    from karanta_tpu_torch.ops.decode_attention import (
        paged_decode_append_multi_quant)

    rng = np.random.default_rng(50 + layer)
    L, B, M, H, KVH, D, tq = 2, 4, 256, 28, 4, 128, 4
    jq, tq_ = _bf16(rng, (B, tq, H, D))

    def rows(shape):
        return j_qkv_rows(jnp.asarray(rng.normal(size=shape), jnp.float32))

    (kq, ks), (vq, vs) = rows((L, B, KVH, M, D)), rows((L, B, KVH, M, D))
    (nkq, nks), (nvq, nvs) = rows((B, tq, KVH, D)), rows((B, tq, KVH, D))
    attn_j, k2, v2, ks2, vs2 = j_multi(
        jq, nkq, nvq, nks, nvs, kq, vq, ks, vs, jnp.asarray(layer),
        jnp.asarray(lens, jnp.int32), block=128, interpret=True)

    def bf(x):
        return _t(np.asarray(x, np.float32)).to(torch.bfloat16)

    tk, tv, tks, tvs = _t(kq), _t(vq), bf(ks), bf(vs)
    got = paged_decode_append_multi_quant(
        tq_, _t(nkq), _t(nvq), bf(nks), bf(nvs), tk, tv, tks, tvs, layer,
        torch.tensor(lens, dtype=torch.int32))
    assert got.dtype == torch.bfloat16
    _assert_bf16_rule(got.float().numpy(),
                      np.asarray(attn_j).astype(np.float32))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(k2))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(v2))
    np.testing.assert_array_equal(tks.float().numpy(),
                                  np.asarray(ks2, np.float32))
    np.testing.assert_array_equal(tvs.float().numpy(),
                                  np.asarray(vs2, np.float32))


@pytest.mark.parametrize("layer,lens", [(1, [0, 5, 200, 255]),
                                        (0, [64, 128, 63, 1])])
def test_append_plain_matches_pallas_bf16(layer, lens):
    """Kernel #5's plain version against the JAX Pallas kernel
    (``interpret=True``) at the 7B's heads (H = 28, KVH = 4, D = 128) on a
    bf16 cache, under the card's bf16 rule (the Pallas kernel rounds P to
    bf16 before P.V, the plain version does not); caches bit-equal."""
    from karanta_tpu.ops.decode_attention import (
        paged_decode_append as j_append,
    )
    from karanta_tpu_torch.ops.decode_attention import paged_decode_append

    rng = np.random.default_rng(60 + layer)
    L, B, M, H, KVH, D = 2, 4, 256, 28, 4, 128
    (jq, tq), (jnk, tnk), (jnv, tnv), (jk, tk), (jv, tv) = (
        _bf16(rng, s) for s in ((B, 1, H, D), (B, KVH, D), (B, KVH, D),
                                (L, B, KVH, M, D), (L, B, KVH, M, D)))
    attn_j, k2, v2 = j_append(jq, jnk, jnv, jk, jv, jnp.asarray(layer),
                              jnp.asarray(lens, jnp.int32), block=128,
                              interpret=True)
    got = paged_decode_append(tq, tnk, tnv, tk, tv, layer,
                              torch.tensor(lens, dtype=torch.int32))
    assert got.dtype == torch.bfloat16
    _assert_bf16_rule(got.float().numpy(),
                      np.asarray(attn_j).astype(np.float32))
    np.testing.assert_array_equal(tk.float().numpy(),
                                  np.asarray(k2).astype(np.float32))
    np.testing.assert_array_equal(tv.float().numpy(),
                                  np.asarray(v2).astype(np.float32))


@pytest.mark.parametrize("layer,lens", [(1, [0, 5, 200, 255]),
                                        (0, [64, 128, 63, 1])])
def test_quant_plain_matches_pallas_bf16(layer, lens):
    """Kernel #3's plain version against the JAX Pallas kernel
    (``interpret=True``) at the 7B's heads (H = 28, KVH = 4, D = 128) with
    bf16 activations, under the card's bf16 rule (the Pallas kernel rounds
    p * vsc to bf16 before P.V, the plain version does not); all four
    caches bit-equal."""
    rng = np.random.default_rng(70 + layer)
    L, B, M, H, KVH, D = 2, 4, 256, 28, 4, 128
    jq, tq = _bf16(rng, (B, 1, H, D))

    def rows(shape):
        return j_qkv_rows(jnp.asarray(rng.normal(size=shape), jnp.float32))

    (kq, ks), (vq, vs) = rows((L, B, KVH, M, D)), rows((L, B, KVH, M, D))
    (nkq, nks), (nvq, nvs) = rows((B, KVH, D)), rows((B, KVH, D))
    attn_j, k2, v2, ks2, vs2 = j_append_quant(
        jq, nkq, nvq, nks, nvs, kq, vq, ks, vs, jnp.asarray(layer),
        jnp.asarray(lens, jnp.int32), block=128, interpret=True)

    def bf(x):
        return _t(np.asarray(x, np.float32)).to(torch.bfloat16)

    tk, tv, tks, tvs = _t(kq), _t(vq), bf(ks), bf(vs)
    got = paged_decode_append_quant(
        tq, _t(nkq), _t(nvq), bf(nks), bf(nvs), tk, tv, tks, tvs, layer,
        torch.tensor(lens, dtype=torch.int32))
    assert got.dtype == torch.bfloat16
    _assert_bf16_rule(got.float().numpy(),
                      np.asarray(attn_j).astype(np.float32))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(k2))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(v2))
    np.testing.assert_array_equal(tks.float().numpy(),
                                  np.asarray(ks2, np.float32))
    np.testing.assert_array_equal(tvs.float().numpy(),
                                  np.asarray(vs2, np.float32))


@pytest.mark.parametrize("m", [4096, 1920, 64])
def test_split_run_rules(m):
    """The run-length rules of the persistent kernels' bf16 instances and of
    the split bodies that the A/B tool times as baselines (pure Python; the
    card only times them). The split rule: powers of two within its range,
    the shortest that leaves at most the given live blocks an SM at
    half-full slots, longer only to respect the last block's merge limit.
    The persistent kernels' resident-run rule (#3, #4, #7 and #6, which
    walk fixed items): the shortest power of two in range whose runs of
    full slots fit the resident blocks, else the longest; never shorter as
    the batch grows. The int4 rules (#7, #6) count tokens in whole 128-token
    chunks, so no 64-token window is split."""
    from karanta_tpu_torch.bench.flash_ab import split_run_rows
    from karanta_tpu_torch.ops import decode_attention as DA

    n_sm = 132
    batches = (1, 2, 4, 8, 16, 32, 64, 80, 128)
    assert DA.Q4_MIN_RUN % 128 == 0 and DA.MULTI_Q4_MIN_RUN % 128 == 0
    runs = [split_run_rows(b, 4, m, n_sm, 256, 1024, 64, blocks_per_sm=1)
            for b in batches]
    assert runs == sorted(runs)
    for b, run in zip(batches, runs):
        assert 256 <= run <= 1024 and run & (run - 1) == 0
        blocks = b * 4 * -(-m // (2 * run))   # live at half-full slots
        assert blocks <= n_sm or run == 1024
        if run > 256:  # the next shorter run would overfill
            assert b * 4 * -(-m // run) > n_sm
    grid = 2 * n_sm
    for rule, lo, hi in (
            (DA.quant_run_rows, DA.QUANT_MIN_RUN, DA.QUANT_MAX_RUN),
            (DA.multi_quant_run_rows, DA.MULTI_MIN_RUN, DA.MULTI_MAX_RUN),
            (DA.multi_q4_run_tokens, DA.MULTI_Q4_MIN_RUN,
             DA.MULTI_Q4_MAX_RUN),
            (DA.q4_run_tokens, DA.Q4_MIN_RUN, DA.Q4_MAX_RUN)):
        runs = [rule(b, 4, m, grid, 32) for b in batches]
        assert runs == sorted(runs)
        for b, run in zip(batches, runs):
            assert lo <= run <= hi and run & (run - 1) == 0
            assert b * 4 * -(-m // run) <= grid or run == hi
            if run > lo:  # the next shorter run's items would not fit
                assert b * 4 * -(-m // (run // 2)) > grid
    # the served and engine points (measured on the card: PERF.md); #3, #4
    # and #7 hold two blocks an SM
    assert DA.multi_quant_run_rows(4, 4, 4096, 2 * n_sm, 32) == 512
    assert DA.multi_quant_run_rows(8, 4, 4096, 2 * n_sm, 32) == 512
    assert DA.multi_quant_run_rows(32, 4, 4096, 2 * n_sm, 32) == 1024
    assert DA.multi_quant_run_rows(80, 4, 1920, 2 * n_sm, 32) == 1024
    assert DA.multi_quant_run_rows(4, 2, 1920, 2 * n_sm, 32) == 512
    assert DA.multi_q4_run_tokens(4, 4, 4096, 2 * n_sm, 32) == 256
    assert DA.multi_q4_run_tokens(8, 4, 4096, 2 * n_sm, 32) == 512
    assert DA.multi_q4_run_tokens(32, 4, 4096, 2 * n_sm, 32) == 2048
    assert DA.multi_q4_run_tokens(4, 1, 2048, 2 * n_sm, 32) == 256
    # the int8 decode kernel at two blocks an SM: one run a block while the
    # runs of full slots fit, else the grid walks the longest runs
    assert DA.quant_run_rows(4, 4, 1920, 2 * n_sm, 32) == 256
    assert DA.quant_run_rows(16, 4, 1920, 2 * n_sm, 32) == 512
    assert DA.quant_run_rows(32, 4, 1920, 2 * n_sm, 32) == 1024
    assert DA.quant_run_rows(80, 4, 1920, 2 * n_sm, 32) == 1024
    assert DA.quant_run_rows(1, 1, 65536, 2 * n_sm, 32) == 2048
    # the int4 decode kernel, on #7's body at T = 1 (two blocks an SM): the
    # smoke's B = 4 over 2,048 tokens, the served B = 8 over 4,096, one
    # rank's kv heads, and larger batches
    assert DA.q4_run_tokens(4, 4, 2048, 2 * n_sm, 32) == 256
    assert DA.q4_run_tokens(8, 4, 4096, 2 * n_sm, 32) == 512
    assert DA.q4_run_tokens(4, 2, 2048, 2 * n_sm, 32) == 256
    assert DA.q4_run_tokens(16, 4, 4096, 2 * n_sm, 32) == 1024
    assert DA.q4_run_tokens(32, 4, 4096, 2 * n_sm, 32) == 1024
    assert DA.q4_run_tokens(80, 4, 4096, 2 * n_sm, 32) == 1024
    # a slot never gets more runs than the last block can merge
    assert split_run_rows(1, 1, 4096, n_sm, 64, 64, max_runs=16) == 256
    assert split_run_rows(1, 1, 4096, n_sm, 64, 4096, 64) == 64
    assert DA.multi_q4_run_tokens(1, 1, 65536, 2 * n_sm, 32) == 2048
    assert DA.q4_run_tokens(1, 1, 65536, 2 * n_sm, 32) == 2048
    assert DA.multi_quant_run_rows(1, 1, 65536, 2 * n_sm, 32) == 2048


def _q4_live_rows(n):
    """Packed int4 rows that hold a token below n (32 a 64-token window)."""
    return (n // 64) * 32 + min(n % 64, 32)


def _quant_items(lens, kvh, m, run_rows, chunk=128, tok=1):
    """The items of the int8 decode kernel's bf16 instance
    (kernels/csrc/decode_append_quant.cu; tok = 1: one token a stored row,
    chunks of 128 rows) or of the verify body's over the int4 cache
    (verify_tma.cuh, #6 at T = 1; tok = 2: packed rows, chunks of 64, m and
    run_rows in tokens) in their fixed order: every (slot, kv head)'s first
    run, then every second run, ...; each as (slot, kv head, first chunk,
    chunks)."""
    run = run_rows // (chunk * tok)
    rows = [min(n, m - 1) if tok == 1 else _q4_live_rows(min(n, m - 1))
            for n in lens]
    nch = [max(1, -(-x // chunk)) for x in rows]
    return [(b, h, r * run, min(run, c - r * run))
            for r in range(-(-m // run_rows))
            for b, c in enumerate(nch) if c > r * run for h in range(kvh)]


def _quant_walk(n_items, n_grid, blk):
    """The items block blk takes: item blk of each even round of n_grid,
    item n_grid - 1 - blk of each odd one."""
    return [k * n_grid + (n_grid - 1 - blk if k % 2 else blk)
            for k in range(-(-n_items // n_grid))
            if k * n_grid + (n_grid - 1 - blk if k % 2 else blk) < n_items]


@pytest.mark.parametrize("kernel", ["3", "6"])
@pytest.mark.parametrize("seed", range(6))
def test_quant_items_bound_the_workspace(seed, kernel):
    """The rule's runs cover every (slot, kv head)'s chunks once, in at most
    ceil(M / run) runs (the partials the wrapper allocates a slot) and the
    kernel's 32; the grid's walk takes every item once; and a slot's runs
    depend on its own length only, not on the slots batched beside it. #3
    counts rows (chunks of 128); #6 counts tokens, its chunks 64 packed rows
    (128 tokens), M a whole number of 64-token windows."""
    from karanta_tpu_torch.ops import decode_attention as DA

    rng = np.random.default_rng(seed)
    tok = 1 if kernel == "3" else 2
    sizes = ([256, 300, 640, 1920, 1923, 4096] if kernel == "3"
             else [256, 640, 1920, 2048, 4096, 8192])
    rule = DA.quant_run_rows if kernel == "3" else DA.q4_run_tokens
    for _ in range(40):
        m = int(rng.choice(sizes))
        b, kvh = int(rng.integers(1, 90)), int(rng.choice([1, 2, 4]))
        n_grid = int(rng.choice([16, 132, 264]))
        lens = [int(x) for x in rng.integers(0, m, b)]
        if rng.random() < 0.3:
            lens = [m - 1] * b
        run = rule(b, kvh, m, n_grid, 32)
        assert run % 128 == 0 and -(-m // run) <= 32
        items = _quant_items(lens, kvh, m, run, chunk=128 // tok, tok=tok)
        for slot, n in enumerate(lens):
            rows = n if tok == 1 else _q4_live_rows(n)
            for h in range(kvh):
                mine = [(c, nc) for s_, h_, c, nc in items
                        if (s_, h_) == (slot, h)]
                chunks = [c + j for c, nc in mine for j in range(nc)]
                assert chunks == list(range(max(1, -(-rows // (128 // tok)))))
                assert len(mine) <= -(-m // run)
        taken = sorted(i for blk in range(n_grid)
                       for i in _quant_walk(len(items), n_grid, blk))
        assert taken == list(range(len(items)))
        others = [int(x) for x in rng.integers(0, m, b)]
        others[0] = lens[0]
        assert ([x for x in _quant_items(others, kvh, m, run,
                                         chunk=128 // tok, tok=tok)
                 if x[0] == 0] == [x for x in items if x[0] == 0])


@pytest.mark.parametrize("lens", [[127, 128, 129, 0], [255, 256, 257, 383]])
def test_quant_plain_matches_pallas_at_chunk_edges(lens):
    """Kernel #3's plain version against the JAX Pallas kernel
    (``interpret=True``) with cache_len at -1, 0 and +1 of the bf16
    instance's 128-row chunk and of its two-stage ring's 256 rows, 0 and M
    - 1: attention within atol 5e-3, all four caches exactly equal."""
    L, B, M, H, KVH, D = 2, 4, 384, 8, 2, 64
    q, kq, ks, vq, vs, nkq, nks, nvq, nvs = _inputs(31 + lens[0], L, B, M, H,
                                                    KVH, D)
    attn_j, k2, v2, ks2, vs2 = j_append_quant(
        jnp.asarray(q), nkq, nvq, nks, nvs, kq, vq, ks, vs, jnp.asarray(1),
        jnp.asarray(lens, jnp.int32), block=128, interpret=True)
    tk, tv = _t(kq), _t(vq)
    tks = _t(np.asarray(ks, np.float32)).to(torch.bfloat16)
    tvs = _t(np.asarray(vs, np.float32)).to(torch.bfloat16)
    attn_t = paged_decode_append_quant(
        _t(q), _t(nkq), _t(nvq),
        _t(np.asarray(nks, np.float32)).to(torch.bfloat16),
        _t(np.asarray(nvs, np.float32)).to(torch.bfloat16),
        tk, tv, tks, tvs, 1, torch.tensor(lens, dtype=torch.int32))
    np.testing.assert_allclose(attn_t.numpy(), np.asarray(attn_j), atol=5e-3)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(k2))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(v2))
    np.testing.assert_array_equal(tks.float().numpy(),
                                  np.asarray(ks2, np.float32))
    np.testing.assert_array_equal(tvs.float().numpy(),
                                  np.asarray(vs2, np.float32))


def test_quant_plain_reads_nothing_past_the_slot():
    """The plain version over caches whose rows and scales past each slot's
    cache_len hold finite garbage equals it over the same caches with
    those rows zeroed, and leaves every row past cache_len but the new one
    as it was."""
    L, B, M, H, KVH, D = 2, 5, 200, 8, 2, 32
    rng = np.random.default_rng(41)
    q, kq, ks, vq, vs, nkq, nks, nvq, nvs = _inputs(41, L, B, M, H, KVH, D)
    lens = torch.tensor([0, 1, 127, 128, 199], dtype=torch.int32)
    dead = (torch.arange(M)[None, :] >= lens.long()[:, None])[:, None, :]
    new = (_t(nkq), _t(nvq), _t(np.asarray(nks, np.float32)),
           _t(np.asarray(nvs, np.float32)))
    base = [_t(kq), _t(vq), _t(np.asarray(ks, np.float32)),
            _t(np.asarray(vs, np.float32))]
    garbage = [x.clone() for x in base]
    for x in garbage[:2]:
        noise = torch.from_numpy(rng.integers(-128, 128, x.shape[1:]).astype(
            np.int8))
        x[1] = torch.where(dead[..., None], noise, x[1])
    for x in garbage[2:]:
        noise = torch.from_numpy(rng.uniform(-1e4, 1e4, x.shape[1:]).astype(
            np.float32))
        x[1] = torch.where(dead, noise, x[1])
    zeroed = [x.clone() for x in base]
    for x in zeroed[:2]:
        x[1] = torch.where(dead[..., None], torch.zeros_like(x[1]), x[1])
    for x in zeroed[2:]:
        x[1] = torch.where(dead, torch.zeros_like(x[1]), x[1])
    before = [x.clone() for x in garbage]
    got = paged_decode_append_quant_plain(_t(q), *new, *garbage, 1, lens)
    want = paged_decode_append_quant_plain(_t(q), *new, *zeroed, 1, lens)
    assert torch.equal(got, want)
    past = (dead & (torch.arange(M)[None, :]
                    != lens.long()[:, None])[:, None, :]).expand(-1, KVH, -1)
    for x, y in zip(garbage, before):
        assert torch.equal(x[1][past], y[1][past])
        assert torch.equal(x[0], y[0])


def _q4_case(rng, L, B, M, H, KVH, D, lead):
    """Packed int4 caches (token-ordered nibbles and scales packed with the
    port's helpers), q and int4 fresh rows with leading shape `lead`, all
    float32 scales, as numpy arrays."""
    from karanta_tpu_torch.ops.decode_attention import (pack_q4_rows,
                                                        pack_q4_scales)

    def nibbles(shape):
        return torch.from_numpy(rng.integers(-7, 8, size=shape).astype(np.int8))

    def scales(shape):
        return torch.from_numpy(rng.uniform(0.01, 0.1, size=shape).astype(
            np.float32))

    caches = [pack_q4_rows(nibbles((L, B, KVH, M, D))),
              pack_q4_rows(nibbles((L, B, KVH, M, D))),
              pack_q4_scales(scales((L, B, KVH, M))),
              pack_q4_scales(scales((L, B, KVH, M)))]
    q = torch.from_numpy(rng.normal(size=(B, 1, H, D)).astype(np.float32))
    new = (nibbles(lead + (KVH, D)), nibbles(lead + (KVH, D)),
           scales(lead + (KVH,)), scales(lead + (KVH,)))
    return q, new, caches


@pytest.mark.parametrize("lens", [[0, 31, 32, 33], [63, 64, 65, 255],
                                  [5, 127, 128, 200]])
def test_q4_decode_step_is_the_verify_pass_at_one_token(lens):
    """The premise of running #6 on #7's body: the port's int4 decode step
    (paged_decode_append_q4_plain) equals its int4 verify pass at T = 1
    (paged_decode_append_multi_q4_plain) on the same inputs, float32:
    outputs within 1e-5, all four caches bit-equal. Lengths on and beside
    the 32-row tile, the 64-token window and the 128-token chunk, 0 and
    M - 1."""
    from karanta_tpu_torch.ops import decode_attention as DA

    L, B, M, H, KVH, D = 2, 4, 256, 8, 2, 32
    rng = np.random.default_rng(120 + lens[1])
    q, new, caches = _q4_case(rng, L, B, M, H, KVH, D, (B,))
    lens_t = torch.tensor(lens, dtype=torch.int32)
    one = [c.clone() for c in caches]
    multi = [c.clone() for c in caches]
    got = DA.paged_decode_append_q4_plain(q, *new, *one, 1, lens_t)
    want = DA.paged_decode_append_multi_q4_plain(
        q, *(x[:, None] for x in new), *multi, 1, lens_t)
    assert got.shape == want.shape == (B, 1, H, D)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    for x, y in zip(one, multi):
        assert torch.equal(x, y)


@pytest.mark.parametrize("lens", [[0, 5, 200, 255], [127, 128, 129, 64]])
def test_quant_decode_step_is_the_verify_pass_at_one_token(lens):
    """The same premise for #3 and #4 over the int8 cache: the port's int8
    decode step (paged_decode_append_quant_plain) equals its int8 verify
    pass at T = 1 (paged_decode_append_multi_quant_plain), float32: outputs
    within 1e-5, all four caches bit-equal."""
    L, B, M, H, KVH, D = 2, 4, 256, 8, 2, 64
    q, kq, ks, vq, vs, nkq, nks, nvq, nvs = _inputs(130 + lens[0], L, B, M,
                                                    H, KVH, D)
    new = (_t(nkq), _t(nvq), _t(np.asarray(nks, np.float32)),
           _t(np.asarray(nvs, np.float32)))
    base = [_t(kq), _t(vq), _t(np.asarray(ks, np.float32)),
            _t(np.asarray(vs, np.float32))]
    from karanta_tpu_torch.ops.decode_attention import (
        paged_decode_append_multi_quant_plain)

    lens_t = torch.tensor(lens, dtype=torch.int32)
    one = [c.clone() for c in base]
    multi = [c.clone() for c in base]
    got = paged_decode_append_quant_plain(_t(q), *new, *one, 1, lens_t)
    want = paged_decode_append_multi_quant_plain(
        _t(q), *(x[:, None] for x in new), *multi, 1, lens_t)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    for x, y in zip(one, multi):
        assert torch.equal(x, y)


@pytest.mark.parametrize("lens", [[0, 31, 64, 255], [63, 127, 128, 200]])
def test_jax_q4_verify_kernel_at_one_token_is_the_decode_kernel(lens):
    """In the JAX package itself, the int4 verify kernel at T = 1
    (paged_decode_append_multi_q4, interpret mode) against the int4 decode
    kernel (paged_decode_append_q4) on the same inputs, float32: attention
    within 1e-5, caches equal; and the port's #6 wrapper (its plain version
    on the CPU) against both."""
    from karanta_tpu.models.qwen25_vl import decoder as jdec
    from karanta_tpu.ops.decode_attention import (
        paged_decode_append_multi_q4 as j_multi_q4,
        paged_decode_append_q4 as j_q4,
    )
    from karanta_tpu_torch.ops.decode_attention import paged_decode_append_q4

    L, B, M, H, KVH, D = 2, 4, 256, 8, 2, 64
    rng = np.random.default_rng(140 + lens[1])
    k = rng.integers(-7, 8, size=(L, B, KVH, M, D)).astype(np.int8)
    v = rng.integers(-7, 8, size=(L, B, KVH, M, D)).astype(np.int8)
    ks = rng.uniform(0.01, 0.1, size=(L, B, KVH, M)).astype(np.float32)
    vs = rng.uniform(0.01, 0.1, size=(L, B, KVH, M)).astype(np.float32)
    caches = (jdec.pack_q4_rows(jnp.asarray(k)),
              jdec.pack_q4_rows(jnp.asarray(v)),
              jdec.pack_q4_scales(jnp.asarray(ks)),
              jdec.pack_q4_scales(jnp.asarray(vs)))
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    nkq, nks = jdec.quantize_kv_rows_q4(
        jnp.asarray(rng.normal(size=(B, KVH, D)), jnp.float32))
    nvq, nvs = jdec.quantize_kv_rows_q4(
        jnp.asarray(rng.normal(size=(B, KVH, D)), jnp.float32))
    new = (nkq, nvq, nks.astype(jnp.float32), nvs.astype(jnp.float32))
    lens_j = jnp.asarray(lens, jnp.int32)
    attn_1, *caches_1 = j_q4(jnp.asarray(q), *new, *caches, jnp.asarray(1),
                             lens_j, block=128, interpret=True)
    attn_m, *caches_m = j_multi_q4(
        jnp.asarray(q), *(x[:, None] for x in new), *caches, jnp.asarray(1),
        lens_j, block=128, interpret=True)
    np.testing.assert_allclose(np.asarray(attn_m), np.asarray(attn_1),
                               atol=1e-5)
    for x, y in zip(caches_m, caches_1):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    caches_t = [_t(c) for c in caches]
    got = paged_decode_append_q4(_t(q), *(_t(x) for x in new), *caches_t, 1,
                                 torch.tensor(lens, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(attn_1), atol=5e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(attn_m), atol=5e-3)
    for x, y in zip(caches_t, caches_1):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


@pytest.mark.parametrize("lens", [[0, 5, 200, 255], [127, 128, 129, 64]])
def test_jax_quant_verify_kernel_at_one_token_is_the_decode_kernel(lens):
    """The same for the int8 kernels of the JAX package: the verify kernel
    at T = 1 (paged_decode_append_multi_quant, interpret mode) against the
    decode kernel (paged_decode_append_quant), float32: attention within
    1e-5, caches equal; and the port's #3 wrapper against both."""
    from karanta_tpu.ops.decode_attention import (
        paged_decode_append_multi_quant as j_multi,
    )

    L, B, M, H, KVH, D = 2, 4, 256, 8, 2, 64
    q, kq, ks, vq, vs, nkq, nks, nvq, nvs = _inputs(150 + lens[0], L, B, M,
                                                    H, KVH, D)
    lens_j = jnp.asarray(lens, jnp.int32)
    attn_1, *caches_1 = j_append_quant(
        jnp.asarray(q), nkq, nvq, nks, nvs, kq, vq, ks, vs, jnp.asarray(1),
        lens_j, block=128, interpret=True)
    attn_m, *caches_m = j_multi(
        jnp.asarray(q), nkq[:, None], nvq[:, None], nks[:, None],
        nvs[:, None], kq, vq, ks, vs, jnp.asarray(1), lens_j, block=128,
        interpret=True)
    np.testing.assert_allclose(np.asarray(attn_m), np.asarray(attn_1),
                               atol=1e-5)
    for x, y in zip(caches_m, caches_1):
        np.testing.assert_array_equal(np.asarray(x, np.float32),
                                      np.asarray(y, np.float32))
    tk, tv = _t(kq), _t(vq)
    tks = _t(np.asarray(ks, np.float32)).to(torch.bfloat16)
    tvs = _t(np.asarray(vs, np.float32)).to(torch.bfloat16)
    got = paged_decode_append_quant(
        _t(q), _t(nkq), _t(nvq),
        _t(np.asarray(nks, np.float32)).to(torch.bfloat16),
        _t(np.asarray(nvs, np.float32)).to(torch.bfloat16),
        tk, tv, tks, tvs, 1, torch.tensor(lens, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(attn_1), atol=5e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(attn_m), atol=5e-3)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(caches_1[0]))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(caches_1[1]))
