"""RMS and layer normalization (plain PyTorch; the JAX package leaves them
to XLA too)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """f32 statistics and f32 weight, result in x's dtype (as the reference)."""
    dtype = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * (1.0 / torch.sqrt(var + eps))
    return (out * weight.float()).to(dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
               eps: float) -> torch.Tensor:
    """f32 mean and variance, f32 weight and bias, result in x's dtype (as
    the reference's layer_norm, gpt2's norm)."""
    dtype = x.dtype
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean((x32 - mu) ** 2, dim=-1, keepdim=True)
    out = (x32 - mu) / torch.sqrt(var + eps)
    out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(dtype)
