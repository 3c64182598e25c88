"""Quintic Newton-Schulz orthogonalization, the core of the Muon optimizer
(port of ``karanta_tpu/ops/newton_schulz.py``).

Five iterations of three products each. The products take bfloat16 operands,
accumulate in float32 and round their results to bfloat16, at the same
points as the JAX function; the elementwise steps round to bfloat16 after
each operation, with the coefficients rounded to bfloat16 first (JAX's weak
scalars take the array's dtype).
"""

from __future__ import annotations

import math

import torch

NS_COEFFS = (3.4445, -4.7750, 2.0315)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 x bf16 -> float32 accumulation -> bf16. On the card a bf16
    product on the tensor cores does this; on the CPU the operands go
    through float32 explicitly."""
    if a.is_cuda:
        return torch.matmul(a, b)
    return torch.matmul(a.float(), b.float()).to(torch.bfloat16)


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def orthogonalize(grad: torch.Tensor, steps: int = 5,
                  eps: float = 1e-7) -> torch.Tensor:
    """Approximately orthogonalize a 2-D (or batched 2-D) gradient matrix."""
    if grad.dim() < 2:
        raise ValueError(f"orthogonalize needs a matrix, got {tuple(grad.shape)}")
    a, b, c = NS_COEFFS
    transposed = grad.shape[-2] > grad.shape[-1]
    x = grad.transpose(-2, -1) if transposed else grad
    x = x.to(torch.bfloat16)
    norm = torch.linalg.vector_norm(x.float(), dim=(-2, -1), keepdim=True)
    x = (x.float() / (norm + eps)).to(torch.bfloat16)
    ca, cb, cc = (_scalar(v, x) for v in (a, b, c))
    for _ in range(steps):
        xxt = _mm(x, x.transpose(-2, -1))
        y = cb * xxt + cc * _mm(xxt, xxt)
        x = ca * x + _mm(y, x)
    x = x.transpose(-2, -1) if transposed else x
    return x.to(grad.dtype)


def muon_update(grad: torch.Tensor, momentum: torch.Tensor,
                beta: float = 0.95, nesterov: bool = True,
                ns_steps: int = 5) -> tuple[torch.Tensor, torch.Tensor]:
    """One Muon direction update. Returns (update_direction, new_momentum);
    the caller applies the learning rate."""
    cb, c1 = _scalar(beta, grad), _scalar(1.0 - beta, grad)
    new_momentum = cb * momentum + c1 * grad
    update = c1 * grad + cb * new_momentum if nesterov else new_momentum
    update = orthogonalize(update, steps=ns_steps)
    scale = math.sqrt(max(1.0, grad.shape[-2] / grad.shape[-1]))
    return update * _scalar(scale, update), new_momentum
