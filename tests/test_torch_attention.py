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


@pytest.mark.parametrize("rope", [False, True])
def test_window_plain_matches_pallas_bf16(rope):
    """bf16 inputs through the window plain version and the Pallas kernel,
    with and without fused rope, held to the card's bf16 rule on rows whose
    window has a live key (the Pallas kernel also rounds the normalised P to
    bf16 before P.V, as the card's kernel does; the plain version does
    not)."""
    rng = np.random.default_rng(20 + rope)
    b, s, h, d, w = 1, 512, 4, 80, 64
    q, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32)
               for _ in range(3))
    mask = (rng.random(size=(b, s)) > 0.1).astype(np.float32)
    mask[0, 320:384] = 0.0   # one window with no live key
    cos = sin = None
    if rope:
        pos = rng.integers(0, 40, size=(s, 2)).astype(np.int32)
        jc, js = j_vision_rope(jnp.asarray(pos), d)
        cos, sin = np.asarray(jc)[None], np.asarray(js)[None]
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
    _assert_bf16_rule(got.float().numpy()[rows], want[rows])


def test_wrappers_reject_bad_shapes():
    q = torch.zeros(1, 100, 2, 16)
    with pytest.raises(ValueError):
        A.window_attention_kernel_call(q, q, q, 64)
    with pytest.raises(ValueError):
        A.flash_attention(q, torch.zeros(1, 100, 3, 16), torch.zeros(1, 100, 3,
                                                                     16))
