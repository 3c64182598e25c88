"""The port's attention kernels' plain versions against the JAX Pallas kernels.

The JAX kernels run as the JAX package's own tests run them on the CPU
(``interpret=True``); inputs are made from seeds with numpy, float32, atol
2e-5. The CUDA kernels themselves are held against these plain versions on
the card (tests/test_torch_kernels_gpu.py and chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karanta_tpu.ops.attention import _window_attention_kernel_call as j_window
from karanta_tpu.ops.attention import _window_reference as j_window_reference
from karanta_tpu.ops.attention import flash_attention as j_flash
from karanta_tpu.ops.attention import mha_reference as j_mha
from karanta_tpu.ops.rotary import vision_rope_cos_sin as j_vision_rope
from karanta_tpu_torch.ops import attention as A

ATOL = 2e-5


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _qkv(rng, b, sq, sk, h, kvh, d):
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, sk, kvh, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, kvh, d)).astype(np.float32)
    return q, k, v


def _assert_bf16_rule(got, want):
    """The card's bf16 rule, per element: 2^-7 |want| + 2^-9 max|want|."""
    limit = 2.0 ** -7 * np.abs(want) + 2.0 ** -9 * np.abs(want).max()
    assert np.isfinite(got).all() and (np.abs(got - want) <= limit).all(), (
        f"worst error/limit {float((np.abs(got - want) / limit).max()):.3g}")


FLASH_CASES = [
    # (b, sq, sk, h, kvh, d, causal, masked, q_offset)
    (1, 128, 128, 2, 2, 64, False, False, 0),
    (1, 128, 128, 2, 2, 64, True, False, 0),
    (2, 200, 200, 4, 2, 32, True, True, 0),     # GQA, mask, ragged S
    (1, 96, 160, 4, 1, 16, True, True, 64),     # prefix continuation
    (2, 130, 130, 6, 2, 80, False, True, 0),    # vision-style full layer
]


@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal,masked,q_offset",
                         FLASH_CASES)
def test_flash_plain_matches_pallas(b, sq, sk, h, kvh, d, causal, masked,
                                    q_offset):
    rng = np.random.default_rng(sq * 7 + d)
    q, k, v = _qkv(rng, b, sq, sk, h, kvh, d)
    mask = None
    if masked:
        mask = np.ones((b, sk), np.float32)
        mask[-1, sk - sk // 5:] = 0.0   # a padded tail
        mask[0, 3] = 0.0                # and a hole
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   None if mask is None else jnp.asarray(mask),
                   causal=causal, q_offset=q_offset, block_q=128,
                   block_k=128, interpret=True)
    got = A.flash_attention(_t(q), _t(k), _t(v),
                            None if mask is None else _t(mask),
                            causal=causal, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal,masked,q_offset",
                         FLASH_CASES)
def test_flash_plain_matches_pallas_bf16(b, sq, sk, h, kvh, d, causal, masked,
                                         q_offset):
    """bf16 inputs through the plain version and the Pallas kernel, held to
    the card's bf16 rule: per element 2^-7 |want| + 2^-9 max|want| (each
    rounds its float32 result to bf16 once; the Pallas kernel also rounds P
    to bf16 before P.V)."""
    rng = np.random.default_rng(sq * 11 + d)
    q, k, v = _qkv(rng, b, sq, sk, h, kvh, d)
    mask = None
    if masked:
        mask = np.ones((b, sk), np.float32)
        mask[-1, sk - sk // 5:] = 0.0
        mask[0, 3] = 0.0
    want = np.asarray(j_flash(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
        None if mask is None else jnp.asarray(mask), causal=causal,
        q_offset=q_offset, block_q=128, block_k=128,
        interpret=True)).astype(np.float32)
    got = A.flash_attention(*(_t(x).to(torch.bfloat16) for x in (q, k, v)),
                            None if mask is None else _t(mask),
                            causal=causal, q_offset=q_offset)
    assert got.dtype == torch.bfloat16
    _assert_bf16_rule(got.float().numpy(), want)


# the edges of the card's bf16 flash kernel (128-row query blocks, 128-key
# TMA boxes; tests/test_torch_kernels_gpu.py BF16_EDGE_CASES): lengths of
# 1, 63, 65 and 129, GQA 7/1 and 14/2, causal at a q_offset with Sk > Sq,
# and a mask with whole 128-key tiles dead and a batch row without a live
# key. The plain version that the kernel is held to on the card agrees with
# the Pallas kernel there, on every batch row with a live key: a row
# without one the Pallas kernel averages over its keys padded to its 128-key
# block, the port (plain and kernel) over the Sk keys.
FLASH_EDGE_CASES = [
    # (b, sq, sk, h, kvh, d, causal, mask, q_offset)
    (1, 1, 1, 2, 1, 64, False, None, 0),
    (2, 63, 65, 7, 1, 128, False, "tail", 0),
    (2, 65, 63, 14, 2, 128, True, None, 0),
    (1, 1, 129, 7, 1, 128, True, None, 128),
    (1, 129, 1, 4, 4, 16, False, None, 0),
    (2, 63, 129, 4, 2, 32, True, "tail", 66),
    (2, 129, 600, 4, 2, 80, False, "tiles", 0),
]


@pytest.mark.parametrize("case", FLASH_EDGE_CASES)
def test_flash_plain_matches_pallas_at_the_kernel_edges(case):
    b, sq, sk, h, kvh, d, causal, kind, q_offset = case
    rng = np.random.default_rng(sq + 3 * sk + d)
    q, k, v = _qkv(rng, b, sq, sk, h, kvh, d)
    mask = None
    if kind == "tail":
        mask = np.ones((b, sk), np.float32)
        mask[-1, sk - sk // 5:] = 0.0
    elif kind == "tiles":
        mask = (rng.uniform(size=(b, sk)) > 0.25).astype(np.float32)
        mask[:, 128:256] = 0.0
        mask[:, 384:512] = 0.0
        mask[-1] = 0.0
    want = np.asarray(j_flash(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
        None if mask is None else jnp.asarray(mask), causal=causal,
        q_offset=q_offset, block_q=128, block_k=128,
        interpret=True)).astype(np.float32)
    got = A.flash_attention(*(_t(x).to(torch.bfloat16) for x in (q, k, v)),
                            None if mask is None else _t(mask),
                            causal=causal, q_offset=q_offset)
    rows = slice(None) if mask is None else mask.any(-1)
    _assert_bf16_rule(got.float().numpy()[rows], want[rows])


def test_flash_plain_matches_jax_reference_dense():
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 1, 40, 40, 4, 2, 16)
    want = j_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    got = A.mha_reference(_t(q), _t(k), _t(v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("rope", [False, True])
def test_window_plain_matches_pallas(rope):
    """Window attention with and without fused rope, at the shapes of the
    JAX package's own fused-rope test; compared on rows whose window has a
    live key (the only rows the vision encoder keeps)."""
    rng = np.random.default_rng(0)
    b, s, h, d, w = 1, 512, 4, 80, 64
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, h, d)).astype(np.float32)
    v = rng.normal(size=(b, s, h, d)).astype(np.float32)
    mask = (rng.random(size=(b, s)) > 0.1).astype(np.float32)
    mask[0, 128:192] = 0.0   # one window with no live key
    cos = sin = None
    if rope:
        pos = rng.integers(0, 40, size=(s, 2)).astype(np.int32)
        jc, js = j_vision_rope(jnp.asarray(pos), d)
        cos, sin = np.asarray(jc)[None], np.asarray(js)[None]
    want = np.asarray(j_window(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), w,
        kv_mask=jnp.asarray(mask),
        cos=None if cos is None else jnp.asarray(cos),
        sin=None if sin is None else jnp.asarray(sin), interpret=True))
    got = A.window_attention_kernel_call(
        _t(q), _t(k), _t(v), w, kv_mask=_t(mask),
        cos=None if cos is None else _t(cos),
        sin=None if sin is None else _t(sin)).numpy()
    live_window = mask.reshape(b, s // w, w).max(-1) > 0
    rows = np.repeat(live_window, w, axis=1)             # (b, s)
    np.testing.assert_allclose(got[rows], want[rows], atol=ATOL)
    if not rope:  # the dense JAX reference agrees everywhere
        ref = np.asarray(j_window_reference(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v), w,
                                            jnp.asarray(mask), None))
        np.testing.assert_allclose(got, ref, atol=ATOL)


WINDOW_BF16_CASES = [
    # (b, s, h, d, w, rope): the vision width at W = 64 (the JAX package's
    # fused-rope shape), then the edges of the card kernel's walk: windows of
    # 16 and 32 (several a 64-row tile), 48 (a tile's last 16 rows left out)
    # and 128 (two query tiles a window); head counts 3 and 5; head dims 16
    # and 64; two batch rows
    (1, 512, 4, 80, 64, False),
    (1, 512, 4, 80, 64, True),
    (1, 256, 3, 80, 16, True),
    (2, 256, 5, 64, 32, False),
    (1, 288, 3, 80, 48, True),
    (2, 192, 2, 80, 48, False),
    (1, 512, 5, 16, 128, True),
    (2, 256, 3, 16, 64, False),
    (1, 256, 5, 64, 64, True),
    (2, 256, 4, 80, 128, False),
]


@pytest.mark.parametrize("case", WINDOW_BF16_CASES)
def test_window_plain_matches_pallas_bf16(case):
    """bf16 inputs through the window plain version and the Pallas kernel,
    with and without fused rope, held to the card's bf16 rule on rows whose
    window has a live key (the Pallas kernel also rounds the normalised P to
    bf16 before P.V, as the card's kernel does; the plain version does
    not). Each case has a window with no live key."""
    b, s, h, d, w, rope = case
    rng = np.random.default_rng([20 + rope, b, s, h, d, w])
    q, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32)
               for _ in range(3))
    mask = (rng.random(size=(b, s)) > 0.1).astype(np.float32)
    mask[b - 1, s - w:] = 0.0   # one window with no live key
    cos = sin = None
    if rope:
        pos = rng.integers(0, 40, size=(s, 2)).astype(np.int32)
        jc, js = j_vision_rope(jnp.asarray(pos), d)
        cos, sin = (np.broadcast_to(np.asarray(x)[None], (b, s, d)).copy()
                    for x in (jc, js))
    want = np.asarray(j_window(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), w,
        kv_mask=jnp.asarray(mask),
        cos=None if cos is None else jnp.asarray(cos),
        sin=None if sin is None else jnp.asarray(sin),
        interpret=True)).astype(np.float32)
    got = A.window_attention_kernel_call(
        *(_t(x).to(torch.bfloat16) for x in (q, k, v)), w, kv_mask=_t(mask),
        cos=None if cos is None else _t(cos),
        sin=None if sin is None else _t(sin))
    assert got.dtype == torch.bfloat16
    rows = np.repeat(mask.reshape(b, s // w, w).max(-1) > 0, w, axis=1)
    assert not rows.all()
    _assert_bf16_rule(got.float().numpy()[rows], want[rows])


def test_wrappers_reject_bad_shapes():
    q = torch.zeros(1, 100, 2, 16)
    with pytest.raises(ValueError):
        A.window_attention_kernel_call(q, q, q, 64)
    with pytest.raises(ValueError):
        A.flash_attention(q, torch.zeros(1, 100, 3, 16), torch.zeros(1, 100, 3,
                                                                     16))


# The rounding argument of the flash kernel's float32 instance, which runs
# Q.K^T and P.V on the tensor cores in 3xTF32 (kernels/csrc/flash_attention.cu):
# a plain-PyTorch model of its arithmetic, held to float64 attention. Each
# operand x is split into hi = tf32(x) and lo = tf32(x - hi) (round to
# nearest, ties away, by bit masking), and a product is hi.hi + hi.lo +
# lo.hi, each term accumulated in float32; P is split unrounded. At the
# document classifiers' shapes (batch cut) and the tiny config's D = 16
# the model stays within the GPU tests' 2e-5, and one TF32 pass does not:
# that is why the kernel takes three. Inputs as drawn, with every element
# scaled by 2^U(-8, 1) (nine binades), and with q and k so and v over
# sixteen binades, 2^U(-8, 8), where the bound is 2e-5 x max|want|. The
# card's check of the kernel itself is tests/test_torch_kernels_gpu.py.
TF32_MODEL_SHAPES = [
    # (b, sq, sk, h, d): SegFormer stages 1-4 (mit-b0, 512 px), the ViT,
    # the tiny VLM's heads
    (1, 16384, 256, 1, 32), (1, 4096, 256, 2, 32), (1, 1024, 256, 5, 32),
    (2, 256, 256, 8, 32), (2, 197, 197, 6, 64), (2, 128, 128, 2, 16)]


def _tf32(x):
    """float32 -> TF32 (10 mantissa bits), nearest, ties away from zero."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _mm_3xtf32(eq, a, b):
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (torch.einsum(eq, a_hi, b_lo) + torch.einsum(eq, a_lo, b_hi)
            + torch.einsum(eq, a_hi, b_hi))


def _mm_1xtf32(eq, a, b):
    return torch.einsum(eq, _tf32(a), _tf32(b))


def _attention_model(q, k, v, mm):
    """Online-softmax attention's arithmetic with products `mm`: scores,
    unnormalised P = exp(s - max), P.V, then / l."""
    s = mm("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = mm("bhqk,bkhd->bqhd", p, v)
    return o / p.sum(-1).permute(0, 2, 1)[..., None]


@pytest.mark.parametrize("inputs", ["normal", "binades", "wide_v"])
@pytest.mark.parametrize("b,sq,sk,h,d", TF32_MODEL_SHAPES)
def test_flash_f32_3xtf32_rounding_model(b, sq, sk, h, d, inputs):
    rng = np.random.default_rng(b + sq + sk + h + d)
    q, k, v = _qkv(rng, b, sq, sk, h, h, d)
    if inputs != "normal":
        top = {"q": 1, "k": 1, "v": 8 if inputs == "wide_v" else 1}
        q, k, v = (x * (2.0 ** rng.uniform(-8, top[n], x.shape))
                   .astype(np.float32) for n, x in zip("qkv", (q, k, v)))
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k) * d ** -0.5
    p = np.exp(s - s.max(-1, keepdims=True))
    want = np.einsum("bhqk,bkhd->bqhd", p / p.sum(-1, keepdims=True), v)
    q, k, v = _t(q), _t(k), _t(v)
    three = _attention_model(q, k, v, _mm_3xtf32).double().numpy()
    one = _attention_model(q, k, v, _mm_1xtf32).double().numpy()
    atol = ATOL * np.abs(want).max() if inputs == "wide_v" else ATOL
    assert np.abs(three - want).max() < atol
    assert np.abs(one - want).max() > atol
