"""Rotary position embeddings.

Two layouts:
  * interleaved ("NORM", ggml's layout for the llama family): rotate adjacent
    dim pairs (2i, 2i+1)
  * half ("NEOX"): rotate (i, i + d/2) pairs

Applied lazily: K is cached UNROTATED and rotated at attention time from the
cache's per-slot position array, so the KV position edits (context shift,
Self-Extend) are metadata updates, not KV rewrites.
"""

from __future__ import annotations

import functools
import math

import torch


def yarn_corr_dim(rope_dim: int, orig_ctx: int, beta: float, freq_base: float) -> float:
    """Dimension index below which rotations exceed `beta` full turns over the
    original context (ggml_rope_yarn_corr_dim semantics)."""
    return rope_dim * math.log(orig_ctx / (beta * 2.0 * math.pi)) / (2.0 * math.log(freq_base))


@functools.lru_cache(maxsize=16)
def _inv_freq(rope_dim: int, freq_base: float, device: torch.device) -> torch.Tensor:
    """freq_base^(-2i/rope_dim) [rope_dim//2] f32 on `device`, made once: a
    step makes no host-to-device copy, so it can be captured in a graph."""
    exponents = torch.arange(rope_dim // 2, dtype=torch.float32, device=device) * (2.0 / rope_dim)
    return torch.pow(torch.tensor(freq_base, dtype=torch.float32, device=device), -exponents)


def rope_angles(
    positions: torch.Tensor,
    rope_dim: int,
    freq_base: float,
    scale: float = 1.0,
    yarn: tuple | None = None,          # (ext_factor, attn_factor, beta_fast, beta_slow, orig_ctx)
    freq_factors: torch.Tensor | None = None,  # [rope_dim//2] llama-3.1 per-dim divisors
):
    """positions [...,] -> cos/sin of shape [..., rope_dim//2], float32.

    `scale` is freq_scale = 1/scaling-factor. `yarn` switches to YaRN
    NTK-by-parts interpolation with its attention magnitude scale folded into
    cos/sin; `freq_factors` divides the inverse frequencies per dim."""
    dev = positions.device
    half = rope_dim // 2
    inv_freq = _inv_freq(rope_dim, freq_base, dev)
    if freq_factors is not None:
        inv_freq = inv_freq / freq_factors.float()
    theta_extrap = positions.float()[..., None] * inv_freq
    ext = yarn[0] if yarn is not None else 0.0
    if yarn is None or ext == 0.0:
        theta = theta_extrap * scale
        mscale = yarn[1] if yarn is not None else 1.0
    else:
        _, attn_factor, beta_fast, beta_slow, orig_ctx = yarn
        low = max(0.0, math.floor(yarn_corr_dim(rope_dim, orig_ctx, beta_fast, freq_base)))
        high = min(rope_dim - 1.0, math.ceil(yarn_corr_dim(rope_dim, orig_ctx, beta_slow, freq_base)))
        dim_i = torch.arange(half, dtype=torch.float32, device=dev)
        ramp = 1.0 - torch.clamp((dim_i - low) / max(0.001, high - low), 0.0, 1.0)
        mix = ramp * ext
        theta = (theta_extrap * scale) * (1.0 - mix) + theta_extrap * mix
        mscale = attn_factor * (1.0 + 0.1 * math.log(1.0 / scale))
    if mscale != 1.0:
        return torch.cos(theta) * mscale, torch.sin(theta) * mscale
    return torch.cos(theta), torch.sin(theta)


def apply_rope(
    x: torch.Tensor,
    positions: torch.Tensor,
    rope_dim: int,
    freq_base: float,
    interleaved: bool = True,
    scale: float = 1.0,
    cos_sin: tuple | None = None,
    yarn: tuple | None = None,
    freq_factors: torch.Tensor | None = None,
) -> torch.Tensor:
    """x: [..., T, H, D] (positions broadcastable to [..., T]). Rotates the
    first `rope_dim` dims of D in f32; the rest pass through. Pass `cos_sin`
    to reuse precomputed angles."""
    if rope_dim == 0:
        return x
    dtype = x.dtype
    if cos_sin is not None:
        cos, sin = cos_sin
    else:
        cos, sin = rope_angles(positions, rope_dim, freq_base, scale,
                               yarn=yarn, freq_factors=freq_factors)
    cos = cos[..., None, :]  # [..., T, 1, half]
    sin = sin[..., None, :]
    rot = x[..., :rope_dim].float()
    rest = x[..., rope_dim:]
    if interleaved:
        x_even = rot[..., 0::2]
        x_odd = rot[..., 1::2]
        r_even = x_even * cos - x_odd * sin
        r_odd = x_even * sin + x_odd * cos
        rotated = torch.stack([r_even, r_odd], dim=-1).reshape(rot.shape)
    else:
        half = rope_dim // 2
        x1 = rot[..., :half]
        x2 = rot[..., half:]
        rotated = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    out = rotated.to(dtype)
    if rest.shape[-1]:
        out = torch.cat([out, rest], dim=-1)
    return out
