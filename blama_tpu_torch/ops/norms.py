"""RMS normalization (plain PyTorch; the JAX package leaves it to XLA too)."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """f32 statistics and f32 weight, result in x's dtype (as the reference)."""
    dtype = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * (1.0 / torch.sqrt(var + eps))
    return (out * weight.float()).to(dtype)
