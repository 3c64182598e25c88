"""Int8 weight quantization for serving (port of
``karanta_tpu/ops/quantization.py``).

Scheme: symmetric per-output-channel int8 weights ``{int8_q, scale}`` with
weights stored ``(..., in, out)`` as in the JAX package.

- ``matmul``: weight-only int8. The weight is dequantized eagerly to the
  activation dtype before the product, a transient copy of each weight per
  call that XLA avoided by fusing the convert into the dot.
- ``matmul_w8a8``: dynamic per-token int8 activations times int8 weights,
  an exact int32 product (``torch._int_mm``), scaled in float32.
- Row-parallel products (``group`` = the tensor-parallel process group; x
  and the weight hold this rank's slice of the input dim): each keeps the
  unsharded product's global semantics. W8A8 takes the per-token amax over
  the whole row (an all-reduce max) and sums the int32 accumulators (an
  exact all-reduce), so it is bit-equal to one rank's product; the
  weight-only and plain products sum float32 partials (bf16 operands
  multiplied into a float32 output, never rounded to bf16 on the way), then
  scale and cast once: one rounding, as one rank's product has, over a sum
  taken in another order. Biases are the caller's, added once after the
  product.
- Inline LoRA (training): a leaf ``{lora_base, a, b, scale}`` multiplies as
  ``x @ base + scale * (x @ a) @ b`` without building the merged weight; the
  base may be an NF4 leaf (QLoRA), dequantized per call. Row-parallel, the
  delta's float32 partial joins the base's before the one sum.
- NF4 (QLoRA's frozen base): 16 NormalFloat code points, absmax blocks of 64
  along the reduction axis, two codes a byte, bit-equal to the JAX package.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from karanta_tpu_torch.parallel.sharding import (all_reduce_max,
                                                 all_reduce_sum, own_slice,
                                                 reduce_from_group)

QUANT_KEY = "int8_q"  # marker key distinguishing quantized leaves
LORA_KEY = "lora_base"  # marker key of inline-LoRA wrapped leaves

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


def is_lora_wrapped(w: Any) -> bool:
    return isinstance(w, dict) and LORA_KEY in w


def _lora_matmul(x: torch.Tensor, w: dict, base_mm,
                 group=None) -> torch.Tensor:
    """x @ (base + scale * a @ b) without materializing the merged matrix:
    the delta is two thin products, the second accumulated in float32.

    Row-parallel over `group` (x and the base hold this rank's slice of the
    input dim, a its rows): the float32 partial of (x @ a) @ b, scaled, is
    added to the base product's float32 partial before the one sum over the
    group, then cast once, so the delta is counted once. An NF4 base kept
    whole over the group (its rank slices would cut 64-row blocks) is
    sliced to this rank's rows after dequantizing."""
    base = w[LORA_KEY]
    if is_nf4(base):
        base = nf4_dequantize(base, x.dtype)
    a = w["a"].to(x.dtype)
    b = w["b"].to(x.dtype)
    delta = (x @ a).float() @ b.float()
    if group is None:
        y = base_mm(x, base)
        return (y.float() + delta * w["scale"].float()).to(x.dtype)
    if base.shape[-2] != x.shape[-1]:
        base = own_slice(base, base.dim() - 2, group)
    partial = _f32_product(x, base) + delta * w["scale"].float()
    return reduce_from_group(partial, group).to(x.dtype)


def _f32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with a float32 result: a bf16/fp16 product accumulated in
    float32 and left unrounded (cuBLAS's ``mm`` with ``out_dtype`` on the
    card; float32 operands on the CPU, which has no such kernel)."""
    if x.dtype == torch.float32:
        return x @ w
    if not x.is_cuda:
        return x.float() @ w.float()
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        # training: the product in x's dtype (cuBLAS accumulates in float32
        # and rounds once); ``mm`` with ``out_dtype`` has no backward
        return (x @ w).float()
    lead = x.shape[:-1]
    y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
    return y.reshape(*lead, w.shape[-1])


def _row_parallel(x: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """Plain x @ w over a row-parallel shard: float32 partials summed over
    the group, cast once (differentiable: the gradient passes through the
    sum, Megatron's row-parallel rule)."""
    return reduce_from_group(_f32_product(x, w), group).to(x.dtype)


def matmul(x: torch.Tensor, w: Any, group=None) -> torch.Tensor:
    """x @ w for plain tensors, quantized dicts (weight-only int8) and
    inline-LoRA leaves; row-parallel over `group` when given."""
    if is_lora_wrapped(w):
        return _lora_matmul(x, w, matmul, group)
    if not is_quantized(w):
        return x @ w if group is None else _row_parallel(x, w, group)
    wd = w[QUANT_KEY].to(x.dtype)
    if group is None:
        acc = (x @ wd).float()
    else:
        acc = all_reduce_sum(_f32_product(x, wd), group)
    scale = w["scale"]
    if acc.dim() < scale.dim():  # 1-D x: drop the broadcast row axis
        scale = scale.squeeze(-2)
    return (acc * scale).to(x.dtype)


# torch._int_mm on CUDA takes more than 16 rows, and cuBLASLt refuses 17-31
# rows at K <= 64 (measured on an H100); small batches are padded to 32 rows
_INT_MM_MIN_ROWS = 32


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact (M, K) int8 @ (K, N) int8 -> (M, N) int32.

    On CUDA the operands are zero-padded up to what ``torch._int_mm`` takes:
    more than 16 rows, K and N multiples of 8 (the 7B vision MLP's 3420
    columns are not); zeros add nothing to an integer sum. On the CPU the
    product is exact integer accumulation at any shape."""
    m, k = a.shape
    n = b.shape[1]
    if a.is_cuda:
        pad_k, pad_n = -k % 8, -n % 8
        if pad_k:
            a = F.pad(a, (0, pad_k))
        if m < _INT_MM_MIN_ROWS:
            a = F.pad(a, (0, 0, 0, _INT_MM_MIN_ROWS - m))
        if pad_k or pad_n:
            # (N, K)-contiguous storage, the order cuBLASLt takes (out_major)
            b = F.pad(b.t(), (0, pad_k, 0, pad_n)).t()
        elif not b.t().is_contiguous():
            b = b.contiguous()
        return torch._int_mm(a.contiguous(), b)[:m, :n]
    return torch._int_mm(a.contiguous(), b.contiguous())


def matmul_w8a8(x: torch.Tensor, w: Any, group=None) -> torch.Tensor:
    """x @ w with dynamic per-token int8 activations (prefill / LM head);
    row-parallel over `group` when given (bit-equal to one rank's)."""
    if is_lora_wrapped(w):
        return _lora_matmul(x, w, matmul_w8a8, group)
    if not is_quantized(w):
        return x @ w if group is None else _row_parallel(x, w, group)
    xf = x.float()
    amax = all_reduce_max(torch.amax(torch.abs(xf), dim=-1, keepdim=True),
                          group)
    xs = torch.clamp(amax * INV_127, min=1e-8)
    xq = torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8)
    wq = w[QUANT_KEY]
    lead = xq.shape[:-1]
    acc = int8_mm(xq.reshape(-1, xq.shape[-1]), wq)
    acc = all_reduce_sum(acc, group).reshape(*lead, wq.shape[-1])
    scale = w["scale"]
    if acc.dim() < scale.dim():  # 1-D x: drop the broadcast row axis
        scale = scale.squeeze(-2)
        xs = xs.squeeze(-1)
    return (acc.float() * xs * scale).to(x.dtype)


def matmul_auto(x: torch.Tensor, w: Any, group=None) -> torch.Tensor:
    """x @ w, taking the W8A8 path iff the weight leaf is quantized;
    row-parallel over `group` when given."""
    if is_quantized(w):
        return matmul_w8a8(x, w, group)
    return x @ w if group is None else _row_parallel(x, w, group)


# the leaves (paths in the decoder's and the tower's trees) that the int8
# modes quantize; biases, norms and the input embedding stay as they are
DECODER_INT8 = frozenset(
    {("layers", "attn", w) for w in ("wq", "wk", "wv", "wo")}
    | {("layers", "mlp", w) for w in ("gate", "up", "down")} | {("lm_head",)})
VISION_INT8 = frozenset(
    {("blocks", "attn", w) for w in ("wq", "wk", "wv", "wo")}
    | {("blocks", "mlp", w) for w in ("gate", "up", "down", "fc1", "fc2")}
    | {("merger", "w1"), ("merger", "w2"), ("patch_embed", "kernel")})


def _quantize_leaves(tree: dict, leaves: frozenset, path: tuple = ()):
    if isinstance(tree, dict):
        return {k: _quantize_leaves(v, leaves, path + (k,))
                for k, v in tree.items()}
    return quantize_weight(tree) if path in leaves else tree


def quantize_vision_params(visual: dict) -> dict:
    """Quantize the vision encoder's matrices (the blocks' attention and
    MLP, the patch embedding, the merger: ``VISION_INT8``) to per-channel
    int8. ``matmul_auto`` then runs them W8A8."""
    return _quantize_leaves(visual, VISION_INT8)


def quantize_decoder_params(text_params: dict) -> dict:
    """Quantize the decoder's attention, MLP and logits-head matrices
    (``DECODER_INT8``).

    The input embedding stays in the working dtype (it is gathered); tied
    embeddings get a separate int8 ``logits_head`` table (embed transposed)."""
    out = _quantize_leaves(text_params, DECODER_INT8)
    if "lm_head" not in text_params:
        out["logits_head"] = quantize_weight(
            text_params["embed"].transpose(0, 1))
    return out


# ---------------------------------------------------------------------------
# NF4: QLoRA's 4-bit frozen base (``karanta_tpu/ops/quantization.py:180-238``).
# Blockwise absmax over 64 consecutive reduction-axis elements per output
# channel, the nearest of 16 NormalFloat code points found by a search over
# the midpoints, two codes a byte along the reduction axis (the first of a
# pair in the high nibble).
# ---------------------------------------------------------------------------

NF4_BLOCK = 64
NF4_KEY = "nf4_q"
# the 16 NormalFloat4 code points (QLoRA paper, appendix E), ascending
NF4_CODE = (
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0)


def _nf4_code(device) -> torch.Tensor:
    return torch.tensor(NF4_CODE, dtype=torch.float32, device=device)


def nf4_quantize(w: torch.Tensor) -> dict:
    """(..., in, out) float -> {nf4_q uint8 (..., in/2, out), absmax float32
    (..., in/64, out)}."""
    *lead, d_in, d_out = w.shape
    if d_in % NF4_BLOCK:
        raise ValueError(f"nf4: reduction dim {d_in} is not a multiple of "
                         f"{NF4_BLOCK}")
    wf = w.float().reshape(*lead, d_in // NF4_BLOCK, NF4_BLOCK, d_out)
    absmax = torch.clamp(wf.abs().amax(dim=-2, keepdim=True), min=1e-8)
    code = _nf4_code(w.device)
    bounds = (code[1:] + code[:-1]) / 2.0
    idx = torch.searchsorted(bounds, (wf / absmax).contiguous())
    idx = idx.to(torch.uint8).reshape(*lead, d_in // 2, 2, d_out)
    packed = (idx[..., 0, :] << 4) | idx[..., 1, :]
    return {NF4_KEY: packed, "absmax": absmax.squeeze(-2)}


def is_nf4(w: Any) -> bool:
    return isinstance(w, dict) and NF4_KEY in w


def nf4_dequantize(q: dict, dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of nf4_quantize; shapes recovered from the packed arrays."""
    packed, absmax = q[NF4_KEY], q["absmax"]
    *lead, half, d_out = packed.shape
    idx = torch.stack([packed >> 4, packed & 0xF], dim=-2).long()
    idx = idx.reshape(*lead, half * 2 // NF4_BLOCK, NF4_BLOCK, d_out)
    vals = _nf4_code(packed.device)[idx] * absmax[..., None, :]
    return vals.reshape(*lead, half * 2, d_out).to(dtype)
