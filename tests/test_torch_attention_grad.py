"""The port's differentiable attention against the JAX package's custom VJPs.

``attention`` and ``window_attention`` (each a torch.autograd.Function over
its kernel, the plain version here on the CPU) get their gradients from the
JAX package's blockwise math in plain PyTorch. Same inputs from numpy seeds
through ``jax.grad`` of the JAX functions (their reference path on the CPU)
and ``torch.autograd.grad`` of the port's, float32, at the tolerance of
``tests/test_attention.py`` (atol 2e-5, rtol 1e-4; 3e-5 for the long case).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karanta_tpu.ops import attention as JA
from karanta_tpu_torch.ops import attention as A


def _grads_port(fn, arrays, w):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = fn(*ts)
    loss = (out * torch.from_numpy(w)).sum() if w is not None \
        else (out ** 2).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, ts)], out


def _grads_jax(fn, arrays, w):
    def loss(*xs):
        o = fn(*xs)
        return jnp.sum(o * w) if w is not None else jnp.sum(o ** 2)
    gs = jax.grad(loss, argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    return [np.asarray(g) for g in gs]


@pytest.mark.parametrize("causal,q_offset,with_mask,gqa", [
    (False, 0, False, False),
    (True, 0, False, False),
    (True, 0, True, True),
    (False, 0, True, True),
    (True, 5, True, False),
])
def test_attention_grads_match_jax(causal, q_offset, with_mask, gqa):
    rng = np.random.default_rng(17)
    b, sq, sk, h, d = 2, 24, 29 + q_offset, 4, 16
    kvh = 2 if gqa else h
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, sk, kvh, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, kvh, d)).astype(np.float32)
    mask = None
    if with_mask:
        mask = (rng.random((b, sk)) > 0.2).astype(np.float32)
        mask[:, :4] = 1.0
    w = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    tmask = None if mask is None else torch.from_numpy(mask)
    jmask = None if mask is None else jnp.asarray(mask)
    got, out = _grads_port(
        lambda q, k, v: A.attention(q, k, v, kv_mask=tmask, causal=causal,
                                    q_offset=q_offset), (q, k, v), w)
    assert out.grad_fn is not None, "the kernel's output lost its grad_fn"
    want = _grads_jax(
        lambda q, k, v: JA.attention(q, k, v, kv_mask=jmask, causal=causal,
                                     q_offset=q_offset), (q, k, v), w)
    for a, b_, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(a, b_, atol=2e-5, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("sq,kvh", [(700, 2), (1100, 1)])
def test_attention_grads_multi_block_and_q_chunks(sq, kvh):
    """Sk > the 512-row backward block and Sq > the 512-row query chunk:
    the port's kv-block loops and its query-chunked backward (dk/dv summed
    over chunks in float32) against JAX's scans."""
    rng = np.random.default_rng(3)
    h, d = 2, 8
    q = rng.normal(size=(1, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(1, sq, kvh, d)).astype(np.float32)
    v = rng.normal(size=(1, sq, kvh, d)).astype(np.float32)
    mask = np.ones((1, sq), np.float32)
    mask[0, -37:] = 0.0
    got, _ = _grads_port(
        lambda q, k, v: A.attention(q, k, v, kv_mask=torch.from_numpy(mask),
                                    causal=True), (q, k, v), None)
    want = _grads_jax(jax.jit(
        lambda q, k, v: JA.attention(q, k, v, kv_mask=jnp.asarray(mask),
                                     causal=True)), (q, k, v), None)
    for a, b_, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(a, b_, atol=3e-5, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("window,with_mask", [(32, True), (16, False)])
def test_window_attention_grads_match_jax(window, with_mask):
    rng = np.random.default_rng(5)
    b, s, h, d = 1, 128, 2, 16
    q, k, v = (rng.normal(size=(b, s, h, d)).astype(np.float32)
               for _ in range(3))
    mask = ((rng.random((b, s)) > 0.1).astype(np.float32) if with_mask
            else None)
    tmask = None if mask is None else torch.from_numpy(mask)
    jmask = None if mask is None else jnp.asarray(mask)
    got, out = _grads_port(
        lambda q, k, v: A.window_attention(q, k, v, window, kv_mask=tmask),
        (q, k, v), None)
    assert out.grad_fn is not None, "the kernel's output lost its grad_fn"
    want = _grads_jax(
        lambda q, k, v: JA.window_attention(q, k, v, window=window,
                                            kv_mask=jmask), (q, k, v), None)
    for a, b_, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(a, b_, atol=2e-5, rtol=1e-4, err_msg=name)


def test_backward_math_matches_autograd_of_the_plain_version():
    """The blockwise backward against autograd through mha_reference (the
    dense plain version), bf16 inputs: the gradients are computed in
    float32 and rounded once to bf16, so they agree to a bf16 step."""
    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.normal(size=(1, 40, 8, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 40, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(1, 40, 2, 16)).astype(np.float32))
    qb, kb, vb = (x.bfloat16().requires_grad_(True) for x in (q, k, v))
    got = torch.autograd.grad(A.attention(qb, kb, vb, causal=True).float()
                              .square().sum(), (qb, kb, vb))
    qf, kf, vf = (x.bfloat16().float().requires_grad_(True)
                  for x in (q, k, v))
    out = A.mha_reference(qf, kf, vf, causal=True).bfloat16().float()
    want = torch.autograd.grad(out.square().sum(), (qf, kf, vf))
    for g, w, name in zip(got, want, "qkv"):
        err = (g.float() - w).norm() / w.norm()
        assert g.dtype == torch.bfloat16 and err < 1e-2, (name, float(err))
