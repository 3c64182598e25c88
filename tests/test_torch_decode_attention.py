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
    """The run-length rules of the split kernels' bf16 instances (pure
    Python; the card only times them): powers of two within each kernel's
    range, the shortest that leaves at most one live block per two SMs at
    half-full slots, longer only to respect the last block's merge limit,
    never shorter as the batch grows."""
    from karanta_tpu_torch.ops import decode_attention as DA

    n_sm = 132
    rules = ((lambda b: DA.multi_quant_run_rows(b, 4, m, n_sm, 64),
              DA.MULTI_MIN_RUN, DA.MULTI_MAX_RUN, 0.5),
             (lambda b: DA.multi_q4_run_tokens(b, 4, m, n_sm, 64),
              DA.MULTI_Q4_MIN_RUN, DA.MULTI_Q4_MAX_RUN, 0.5),
             (lambda b: DA.quant_run_rows(b, 4, m, n_sm, 64),
              DA.QUANT_MIN_RUN, DA.QUANT_MAX_RUN, DA.QUANT_BLOCKS_PER_SM),
             (lambda b: DA.q4_run_tokens(b, 4, m, n_sm, 64),
              DA.Q4_MIN_RUN, DA.Q4_MAX_RUN, DA.Q4_BLOCKS_PER_SM))
    # the int4 rules count tokens in whole 64-token windows
    assert DA.MULTI_Q4_MIN_RUN % 64 == 0 and DA.Q4_MIN_RUN % 64 == 0
    for rule, lo, hi, per_sm in rules:
        runs = [rule(b) for b in (1, 2, 4, 8, 16, 32, 64, 80, 128)]
        assert runs == sorted(runs)
        for b, run in zip((1, 2, 4, 8, 16, 32, 64, 80, 128), runs):
            assert lo <= run <= hi and run & (run - 1) == 0
            blocks = b * 4 * -(-m // (2 * run))   # live at half-full slots
            assert blocks <= per_sm * n_sm or run == hi
            if run > lo:  # the next shorter run would overfill the card
                assert b * 4 * -(-m // run) > per_sm * n_sm
    # the served and engine points (measured on the card: PERF.md)
    assert DA.multi_quant_run_rows(4, 4, 4096, n_sm, 64) == 512
    assert DA.multi_quant_run_rows(32, 4, 4096, n_sm, 64) == 1024
    assert DA.multi_q4_run_tokens(4, 4, 4096, n_sm, 64) == 512
    assert DA.multi_q4_run_tokens(8, 4, 4096, n_sm, 64) == 1024
    assert DA.quant_run_rows(4, 4, 1920, n_sm, 64) == 256
    assert DA.quant_run_rows(32, 4, 1920, n_sm, 64) == 512
    assert DA.quant_run_rows(80, 4, 1920, n_sm, 64) == 1024
    assert DA.q4_run_tokens(4, 4, 2048, n_sm, 64) == 256
    assert DA.q4_run_tokens(8, 4, 4096, n_sm, 64) == 512
    assert DA.q4_run_tokens(32, 4, 4096, n_sm, 64) == 1024
    assert DA.q4_run_tokens(64, 4, 4096, n_sm, 64) == 1024
    # a slot never gets more runs than the last block can merge
    assert DA.split_run_rows(1, 1, 4096, n_sm, 64, 64, max_runs=16) == 256
    assert DA.split_run_rows(1, 1, 4096, n_sm, 64, 4096, 64) == 64
