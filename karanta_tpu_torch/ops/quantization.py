"""Int8 weight quantization for serving (port of
``karanta_tpu/ops/quantization.py``).

Scheme: symmetric per-output-channel int8 weights ``{int8_q, scale}`` with
weights stored ``(..., in, out)`` as in the JAX package.

- ``matmul``: weight-only int8. The weight is dequantized eagerly to the
  activation dtype before the product, a transient copy of each weight per
  call that XLA avoided by fusing the convert into the dot.
- ``matmul_w8a8``: dynamic per-token int8 activations times int8 weights,
  an exact int32 product (``torch._int_mm``), scaled in float32.
"""

from __future__ import annotations

from typing import Any

import torch

QUANT_KEY = "int8_q"  # marker key distinguishing quantized leaves

# XLA compiles the JAX package's `amax / 127.0` into a multiply by the
# float32 reciprocal; the port multiplies too, so scales agree to the bit
INV_127 = 1.0 / 127.0


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and QUANT_KEY in w


def out_major(q: torch.Tensor) -> torch.Tensor:
    """The (..., in, out) int8 weight as a view of (..., out, in)-contiguous
    storage. Shapes and values are the JAX layout's; the storage order is the
    one cuBLASLt's fast int8 kernels take for the second operand (with
    (in, out)-contiguous storage it picks a slow sm80 fallback)."""
    return q.transpose(-1, -2).contiguous().transpose(-1, -2)


def quantize_weight(w: torch.Tensor) -> dict:
    """(..., in, out) float -> {int8_q (..., in, out), scale (..., 1, out) f32}."""
    wf = w.float()
    amax = torch.amax(torch.abs(wf), dim=-2, keepdim=True)
    scale = torch.clamp(amax * INV_127, min=1e-8)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {QUANT_KEY: out_major(q), "scale": scale}


def matmul(x: torch.Tensor, w: Any) -> torch.Tensor:
    """x @ w for plain tensors and quantized dicts (weight-only int8)."""
    if not is_quantized(w):
        return x @ w
    acc = (x @ w[QUANT_KEY].to(x.dtype)).float()
    scale = w["scale"]
    if acc.dim() < scale.dim():  # 1-D x: drop the broadcast row axis
        scale = scale.squeeze(-2)
    return (acc * scale).to(x.dtype)


# torch._int_mm on CUDA takes more than 16 rows, and cuBLASLt refuses 17-31
# rows at K <= 64 (measured on an H100); small batches are padded to 32 rows
_INT_MM_MIN_ROWS = 32


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact (M, K) int8 @ (K, N) int8 -> (M, N) int32.

    On CUDA the rows are zero-padded up to what ``torch._int_mm`` takes (K
    and N must be multiples of 8 there); on the CPU the product is exact
    integer accumulation at any shape."""
    m = a.shape[0]
    if a.is_cuda:
        if a.shape[1] % 8 or b.shape[1] % 8:
            raise ValueError(f"int8 product on CUDA needs K, N divisible by "
                             f"8, got {tuple(a.shape)} @ {tuple(b.shape)}")
        if m < _INT_MM_MIN_ROWS:
            a = torch.cat([a, a.new_zeros((_INT_MM_MIN_ROWS - m, a.shape[1]))])
        if not b.t().is_contiguous():
            b = b.contiguous()
        return torch._int_mm(a.contiguous(), b)[:m]
    return torch._int_mm(a.contiguous(), b.contiguous())


def matmul_w8a8(x: torch.Tensor, w: Any) -> torch.Tensor:
    """x @ w with dynamic per-token int8 activations (prefill / LM head)."""
    if not is_quantized(w):
        return x @ w
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    xs = torch.clamp(amax * INV_127, min=1e-8)
    xq = torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8)
    wq = w[QUANT_KEY]
    lead = xq.shape[:-1]
    acc = int8_mm(xq.reshape(-1, xq.shape[-1]), wq).reshape(*lead, wq.shape[-1])
    scale = w["scale"]
    if acc.dim() < scale.dim():  # 1-D x: drop the broadcast row axis
        scale = scale.squeeze(-2)
        xs = xs.squeeze(-1)
    return (acc.float() * xs * scale).to(x.dtype)


def matmul_auto(x: torch.Tensor, w: Any) -> torch.Tensor:
    """x @ w, taking the W8A8 path iff the weight leaf is quantized."""
    if is_quantized(w):
        return matmul_w8a8(x, w)
    return x @ w


def quantize_decoder_params(text_params: dict) -> dict:
    """Quantize the decoder's attention, MLP and logits-head matrices.

    The input embedding stays in the working dtype (it is gathered); tied
    embeddings get a separate int8 ``logits_head`` table (embed transposed)."""
    layers = text_params["layers"]
    new_attn = dict(layers["attn"])
    for name in ("wq", "wk", "wv", "wo"):
        new_attn[name] = quantize_weight(layers["attn"][name])
    new_mlp = {name: quantize_weight(layers["mlp"][name])
               for name in ("gate", "up", "down")}
    out = dict(text_params)
    out["layers"] = {**layers, "attn": new_attn, "mlp": new_mlp}
    if "lm_head" in text_params:
        out["lm_head"] = quantize_weight(text_params["lm_head"])
    else:
        out["logits_head"] = quantize_weight(
            text_params["embed"].transpose(0, 1))
    return out
