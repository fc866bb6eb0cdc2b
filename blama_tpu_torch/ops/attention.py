"""Two-pass attention over the position-mapped KV cache (plain PyTorch).

The reference semantics: rotate the cached K by its slot positions, masked
f32 softmax, then P·V. Fused attention serves T == 1 and T % 8 == 0 chunks;
this chain serves the rest (T in {2, 4} prompt chunks), as the JAX
package's ops/attention.py does.
"""

from __future__ import annotations

import torch

from .rope import apply_rope

NEG_INF = -1e30


def attention(
    q: torch.Tensor,          # [B, T, H, D] already rotated
    k_cache: torch.Tensor,    # [B, S, Hkv, D] unrotated
    v_cache: torch.Tensor,    # [B, S, Hkv, D]
    q_pos: torch.Tensor,      # [B, T] int32
    kv_pos: torch.Tensor,     # [B, S] int32 (-1 = empty)
    rope_dim: int,
    freq_base: float,
    interleaved: bool = True,
    causal: bool = True,
    logit_scale: float | None = None,
    kv_rope: tuple | None = None,  # precomputed (cos, sin) for kv positions
) -> torch.Tensor:
    B, T, H, D = q.shape
    Hkv = k_cache.shape[2]
    group = H // Hkv

    k = apply_rope(k_cache, torch.clamp(kv_pos, min=0), rope_dim, freq_base,
                   interleaved, cos_sin=kv_rope)

    scale = logit_scale if logit_scale is not None else 1.0 / (D**0.5)

    qf = q.float().reshape(B, T, Hkv, group, D)
    kf = k.float()
    scores = torch.einsum("bthgd,bshd->bhgts", qf, kf) * scale

    valid = kv_pos[:, None, None, None, :] >= 0
    if causal:
        allowed = kv_pos[:, None, None, None, :] <= q_pos[:, None, None, :, None]
        valid = valid & allowed
    scores = torch.where(valid, scores, NEG_INF)

    m = torch.amax(scores, dim=-1, keepdim=True)
    e = torch.exp(scores - torch.clamp(m, min=NEG_INF / 2))
    e = torch.where(valid, e, 0.0)
    denom = torch.sum(e, dim=-1, keepdim=True)
    p = e / torch.clamp(denom, min=1e-30)

    vf = v_cache.float()
    out = torch.einsum("bhgts,bshd->bthgd", p, vf)
    return out.reshape(B, T, H, D).to(q.dtype)
