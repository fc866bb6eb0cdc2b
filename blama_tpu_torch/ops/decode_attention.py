"""Fused flash attention over the position-mapped INT8 KV cache.

Counterpart of blama_tpu/ops/pallas/decode_attention.py: one streaming pass
of the stored cache per layer and step replaces the two-pass chain
(ops/attention.py). K stays int8 codes until it is in fast memory, rope is
applied to K inside the kernel from the slot position map, and the INT8
scales fold into the score and probability rows:

    q . rope(ks*codes_k) == ks * (q . rope(codes_k))
    p @ (vs*codes_v)     == (p*vs) @ codes_v

Kernel C (`decode_attention`, T == 1) and kernel D (`prefill_attention`,
T % 8 == 0 prompt chunks) are CUDA C++ (ops/csrc/decode_attention.cu). On
a CPU tensor each wrapper runs the plain PyTorch version in this module; on
a CUDA tensor it launches the kernel or raises. The `supports` /
`prefill_supports` gates mirror the reference's, so the same chunk length T
takes the same route in both packages.

Numerics differ from the two-pass chain (online vs two-pass softmax), so
fused attention is an engine *mode*: prover and verifier pick the same mode.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import kernels
from .rope import yarn_corr_dim

NEG_INF = -1e30
TILE_S = 32        # slots per kernel tile (ops/csrc/decode_attention.cu TS)


def effective_inv_freq(
    rope_dim: int,
    head_dim: int,
    freq_base: float,
    scale: float = 1.0,
    yarn: tuple | None = None,
    freq_factors: torch.Tensor | None = None,
) -> tuple[torch.Tensor, float]:
    """Per-lane effective inverse frequency for in-kernel rope.

    YaRN NTK-by-parts and llama-3.1 freq factors reduce to a per-dim
    multiplier on theta = pos * inv_freq, so the kernels need one [head_dim]
    f32 vector. Lanes are interleave-expanded (theta[2i] == theta[2i+1]) and
    zero beyond rope_dim (cos=1, sin=0: identity on pass-through dims).
    Computed in numpy f32 exactly as the reference does. Returns
    (inv_freq_e [head_dim] f32 CPU tensor, mscale)."""
    half = rope_dim // 2
    if half == 0:
        return torch.zeros(head_dim, dtype=torch.float32), 1.0
    exponents = np.arange(half, dtype=np.float32) * (2.0 / rope_dim)
    inv_freq = np.asarray(freq_base ** (-exponents), dtype=np.float32)
    if freq_factors is not None:
        ff = freq_factors.detach().cpu().numpy() if torch.is_tensor(freq_factors) \
            else np.asarray(freq_factors)
        inv_freq = inv_freq / ff.astype(np.float32)
    ext = yarn[0] if yarn is not None else 0.0
    if yarn is None or ext == 0.0:
        eff = inv_freq * np.float32(scale)
        mscale = yarn[1] if yarn is not None else 1.0
    else:
        _, attn_factor, beta_fast, beta_slow, orig_ctx = yarn
        low = max(0.0, math.floor(yarn_corr_dim(rope_dim, orig_ctx, beta_fast, freq_base)))
        high = min(rope_dim - 1.0, math.ceil(yarn_corr_dim(rope_dim, orig_ctx, beta_slow, freq_base)))
        dim_i = np.arange(half, dtype=np.float32)
        ramp = 1.0 - np.clip((dim_i - low) / max(0.001, high - low), 0.0, 1.0)
        mix = (ramp * ext).astype(np.float32)
        eff = inv_freq * (np.float32(scale) * (1.0 - mix) + mix)
        mscale = attn_factor * (1.0 + 0.1 * math.log(1.0 / scale))
    out = np.zeros((head_dim,), np.float32)
    out[0:rope_dim:2] = eff
    out[1:rope_dim:2] = eff
    return torch.from_numpy(out), float(mscale)


# ---------------------------------------------------------------------------
# routing gates (mirror the reference's, so T picks the same route)
# ---------------------------------------------------------------------------

def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size() if isinstance(dtype, torch.dtype) \
        else np.dtype(dtype).itemsize


def _pick_block_s(S: int, itemsize: int, batch: int = 1,
                  cap: int = 1024) -> int | None:
    cands = (2048, 1024, 512, 256, 128, 64, 32, 16, 8) if itemsize == 1 else (
        512, 256, 128, 64, 32, 16, 8)
    for bs in cands:
        if bs <= cap and S % bs == 0 and (bs % 128 == 0 or bs == batch * S):
            return bs
    return None


def supports(S: int, head_dim: int, k_dtype, batch: int = 1) -> bool:
    """Whether the fused decode route serves this cache geometry."""
    return (_pick_block_s(S, _itemsize(k_dtype), batch) is not None
            and head_dim % 2 == 0 and head_dim <= 256)


def _pick_block_t(T: int) -> int | None:
    for bt in (128, 64, 32, 16, 8):
        if T % bt == 0:
            return bt
    return None


def prefill_supports(T: int, S: int, head_dim: int, k_dtype,
                     batch: int = 1) -> bool:
    """Whether the fused prefill route serves this chunk geometry."""
    return (T > 1 and _pick_block_t(T) is not None
            and _pick_block_s(S, _itemsize(k_dtype), batch, cap=512) is not None
            and head_dim % 2 == 0 and head_dim <= 256)


# ---------------------------------------------------------------------------
# plain versions (the function both kernels compute)
# ---------------------------------------------------------------------------

def flash_attention_plain(q, k_cache, v_cache, q_pos, kv_pos, inv_freq_e,
                          k_scale=None, v_scale=None, scale: float = 1.0):
    """q [B, T, H, D] rotated; cache [B, S, Hkv, D] unrotated; q_pos [B, T];
    kv_pos [B, S]. Rope K from kv_pos·inv_freq_e (interleaved pairs), fold
    the INT8 scales into scores / probabilities, mask pos == -1 and
    pos > q_pos, softmax with the max(l, 1e-30) finalize. → q.dtype."""
    B, T, H, D = q.shape
    Hkv = k_cache.shape[2]
    g = H // Hkv
    theta = kv_pos.float()[..., None] * inv_freq_e.to(q.device).float()  # [B, S, D]
    cos = torch.cos(theta)[:, :, None, :]
    sin = torch.sin(theta)[:, :, None, :]
    even = (torch.arange(D, device=q.device) % 2 == 0)
    sin_signed = torch.where(even, -sin, sin)
    kf = k_cache.float()
    swapped = kf.reshape(B, -1, Hkv, D // 2, 2).flip(-1).reshape(kf.shape)
    k_rot = kf * cos + swapped * sin_signed                              # [B, S, Hkv, D]
    qf = q.float().reshape(B, T, Hkv, g, D)
    scores = torch.einsum("bthgd,bshd->bhgts", qf, k_rot) * scale
    if k_scale is not None:
        scores = scores * k_scale.permute(0, 2, 1)[:, :, None, None, :]
    mask = (kv_pos[:, None, None, None, :] >= 0) & \
        (kv_pos[:, None, None, None, :] <= q_pos[:, None, None, :, None])
    scores = torch.where(mask, scores, NEG_INF)
    m = torch.amax(scores, dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(scores - m), 0.0)
    l = e.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        e = e * v_scale.permute(0, 2, 1)[:, :, None, None, :]
    acc = torch.einsum("bhgts,bshd->bthgd", e, v_cache.float())
    denom = torch.clamp(l, min=1e-30).permute(0, 3, 1, 2, 4)            # [B, T, Hkv, g, 1]
    return (acc / denom).reshape(B, T, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_cuda(q, k_cache, v_cache, k_scale, v_scale, kv_pos, q_pos, inv_freq_e):
    B, T, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    if (k_scale is None or v_scale is None or k_cache.dtype != torch.int8
            or v_cache.dtype != torch.int8):
        raise ValueError("the CUDA attention kernels take the INT8 cache only")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"queries must be bf16, got {q.dtype}")
    if D not in (64, 128, 256) or H % Hkv or H // Hkv > 32:
        raise ValueError(f"unsupported head geometry H={H} Hkv={Hkv} D={D}")
    expect = {"k_cache": (k_cache, (B, S, Hkv, D)), "v_cache": (v_cache, (B, S, Hkv, D)),
              "k_scale": (k_scale, (B, S, Hkv)), "v_scale": (v_scale, (B, S, Hkv)),
              "kv_pos": (kv_pos, (B, S)), "inv_freq_e": (inv_freq_e, (D,))}
    for name, (t, shp) in expect.items():
        if tuple(t.shape) != shp or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {shp} tensor on {q.device}")
    if kv_pos.dtype != torch.int32 or q_pos.dtype != torch.int32:
        raise TypeError("positions must be int32")
    if any(t.dtype != torch.float32 for t in (k_scale, v_scale, inv_freq_e)):
        raise TypeError("scales and inv_freq_e must be f32")
    return B, T, H, D, S, Hkv


def decode_split(B: int, Hkv: int, S: int) -> int:
    """Slots per block of kernel C: enough blocks to fill the card, fixed for
    a given (B, Hkv, S) so a replay splits the same way."""
    nsplit = max(1, min(-(-264 // (B * Hkv)), -(-S // TILE_S)))
    per_split = -(-S // nsplit)
    return -(-per_split // TILE_S) * TILE_S


def decode_attention(
    q: torch.Tensor,          # [B, 1, H, D] rotated query (one decode token)
    k_cache: torch.Tensor,    # [B, S, Hkv, D] unrotated int8 codes
    v_cache: torch.Tensor,    # [B, S, Hkv, D]
    q_pos: torch.Tensor,      # [B] int32
    kv_pos: torch.Tensor,     # [B, S] int32, -1 = empty slot
    inv_freq_e: torch.Tensor,  # [head_dim] f32 from effective_inv_freq
    k_scale: torch.Tensor | None = None,  # [B, S, Hkv] f32 (INT8-KV mode)
    v_scale: torch.Tensor | None = None,
    logit_scale: float | None = None,
    mscale: float = 1.0,
) -> torch.Tensor:
    """Kernel C: fused single-token attention; returns [B, 1, H, D] in q.dtype."""
    B, T, H, D = q.shape
    if T != 1:
        raise ValueError(f"decode_attention is the T == 1 path, got T={T}")
    scale = (logit_scale if logit_scale is not None else 1.0 / (D ** 0.5)) * mscale
    if q.device.type == "cpu":
        return flash_attention_plain(q, k_cache, v_cache, q_pos.reshape(B, 1),
                                     kv_pos, inv_freq_e, k_scale, v_scale, scale)
    q = q.contiguous()
    q_pos = q_pos.reshape(B).contiguous()
    B, T, H, D, S, Hkv = _check_cuda(q, k_cache, v_cache, k_scale, v_scale,
                                     kv_pos, q_pos, inv_freq_e)
    chunk = decode_split(B, Hkv, S)
    nsplit = -(-S // chunk)
    dev = q.device
    part_m = torch.empty((B, H, nsplit), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((B, H, nsplit, D), dtype=torch.float32, device=dev)
    out = torch.empty((B, 1, H, D), dtype=q.dtype, device=dev)
    rc = kernels.lib("decode_attention").decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), kv_pos.data_ptr(), q_pos.data_ptr(),
        inv_freq_e.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
        part_acc.data_ptr(), out.data_ptr(), B, H, Hkv, D, S, chunk,
        float(scale), kernels.stream_ptr(dev))
    kernels.check(rc, "decode_attention")
    kernels.count("decode_attention")
    return out


def prefill_attention(
    q: torch.Tensor,          # [B, T, H, D] rotated queries (prompt chunk)
    k_cache: torch.Tensor,    # [B, S, Hkv, D] unrotated int8 codes
    v_cache: torch.Tensor,    # [B, S, Hkv, D]
    q_pos: torch.Tensor,      # [B, T] int32
    kv_pos: torch.Tensor,     # [B, S] int32, -1 = empty slot
    inv_freq_e: torch.Tensor,  # [head_dim] f32 from effective_inv_freq
    k_scale: torch.Tensor | None = None,  # [B, S, Hkv] f32 (INT8-KV mode)
    v_scale: torch.Tensor | None = None,
    logit_scale: float | None = None,
    mscale: float = 1.0,
) -> torch.Tensor:
    """Kernel D: fused causal chunk attention; returns [B, T, H, D] in q.dtype."""
    B, T, H, D = q.shape
    scale = (logit_scale if logit_scale is not None else 1.0 / (D ** 0.5)) * mscale
    if q.device.type == "cpu":
        return flash_attention_plain(q, k_cache, v_cache, q_pos, kv_pos,
                                     inv_freq_e, k_scale, v_scale, scale)
    q = q.contiguous()
    q_pos = q_pos.contiguous()
    B, T, H, D, S, Hkv = _check_cuda(q, k_cache, v_cache, k_scale, v_scale,
                                     kv_pos, q_pos, inv_freq_e)
    if tuple(q_pos.shape) != (B, T):
        raise ValueError(f"q_pos must be [B, T] = {(B, T)}")
    qt = max(1, 8 // (H // Hkv))   # query tokens per block (8 warps at g <= 8)
    out = torch.empty_like(q)
    rc = kernels.lib("decode_attention").prefill_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), kv_pos.data_ptr(), q_pos.data_ptr(),
        inv_freq_e.data_ptr(), out.data_ptr(), B, T, H, Hkv, D, S, qt,
        float(scale), kernels.stream_ptr(q.device))
    kernels.check(rc, "prefill_attention")
    kernels.count("prefill_attention")
    return out
