"""Paged attention: stream KV pages straight from the shared pool.

Counterpart of blama_tpu/ops/pallas/paged_attention.py, the companion of
ops/decode_attention.py for the paged cache (ops/paged_kv.py). The dense
fused kernels walk a row's contiguous [S, Hkv, D] cache; here a sequence's
cache lives on scattered pages of a pool shared by every scheduler row, so
each tile's address goes through the row's page table.

Kernel E (`paged_decode_attention`, T == 1) and kernel F
(`paged_prefill_attention`, T % 8 == 0 chunks) are CUDA C++
(ops/csrc/paged_attention.cu over ops/csrc/attention_common.cuh). No
gathered copy of the row view is materialized: device-memory traffic is one
pass over the row's LIVE pages per step, and pages the row does not own are
never read.

Numerics/determinism: the device code is the dense kernels' with a paged
address. E splits the logical row MP*G by the same `decode_plan` as kernel
C, walks slots in the same order and folds the splits in the same order;
F relates to D the same way. Unmapped pages are not read, an exact no-op
under the online softmax. So the output is bit-identical to the dense fused kernel
over the same logical row: physical page placement cannot affect logits
(verification contract; held by chip_smoke.py on the card, and on the CPU
the plain version below equals the dense plain version exactly).

On a CPU tensor each wrapper runs `paged_attention_plain`; on a CUDA tensor
it launches its kernel or raises. bf16 queries take the bf16 instances
(ops/csrc/paged_attention.cu), f32 queries the f32 ones (the float32
engine; ops/csrc/attention_f32.cu), each counted under its own name.
"""

from __future__ import annotations

import torch

from . import decode_attention as dattn
from . import kernels
from .paged_kv import view_slot_map

__all__ = ["paged_decode_attention", "paged_prefill_attention", "supports",
           "prefill_supports", "paged_attention_plain"]


def supports(page_size: int, head_dim: int, k_dtype) -> bool:
    """Whether the paged route serves this pool geometry. The gate is the
    reference's, argument for argument (pages of a multiple of 128 slots;
    `k_dtype` decides nothing there either), so the same pool takes the same
    route in both packages; kernels E and F take every head dim it admits,
    over an INT8, bf16 or f32 pool (a store of another type is refused on a
    card where the pool is created: decode_attention.require_kernel_geometry)."""
    return (
        page_size % 128 == 0
        and head_dim % 2 == 0
        and head_dim <= 256
    )


def prefill_supports(T: int, page_size: int, head_dim: int, k_dtype) -> bool:
    return (
        T > 1
        and dattn._pick_block_t(T) is not None
        and supports(page_size, head_dim, k_dtype)
    )


def paged_attention_plain(q, k_pool, v_pool, pool_pos, page_table, q_pos,
                          inv_freq_e, k_scale=None, v_scale=None,
                          scale: float = 1.0):
    """The function kernels E and F compute: gather each row's logical view
    through its page table (positions -1 on unmapped pages) and run the
    dense plain version on it. q [B, T, H, D]; pools [P, G, Hkv, D];
    pool_pos [P, G]; page_table [B, MP]; q_pos [B, T]."""
    G = k_pool.shape[1]
    Hkv, D = k_pool.shape[-2], k_pool.shape[-1]
    slot_map = view_slot_map(page_table, G)                       # [B, MP*G]
    mapped = torch.repeat_interleave(page_table >= 0, G, dim=1)
    pos_view = torch.where(mapped, pool_pos.reshape(-1)[slot_map], -1).to(torch.int32)
    k = k_pool.reshape(-1, Hkv, D)[slot_map]
    v = v_pool.reshape(-1, Hkv, D)[slot_map]
    ks = vs = None
    if k_scale is not None:
        ks = k_scale.reshape(-1, Hkv)[slot_map]
        vs = v_scale.reshape(-1, Hkv)[slot_map]
    return dattn.flash_attention_plain(q, k, v, q_pos, pos_view, inv_freq_e,
                                       ks, vs, scale)


def _check_cuda(q, k_pool, v_pool, pool_pos, page_table, q_pos, inv_freq_e,
                k_scale, v_scale):
    B, T, H, D = q.shape
    P, G, Hkv = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    MP = page_table.shape[1]
    kv_type = dattn.kv_type_of(k_pool, v_pool, k_scale, v_scale)
    dattn.check_cuda_common(q, inv_freq_e, q_pos, pool_pos, Hkv)
    if G % dattn.TILE_S:
        raise ValueError(f"page size {G} must be a multiple of {dattn.TILE_S}")
    dattn.check_tensors(q.device, {
        "k_pool": (k_pool, (P, G, Hkv, D), None),
        "v_pool": (v_pool, (P, G, Hkv, D), None),
        "k_scale": (k_scale, (P, G, Hkv), torch.float32),
        "v_scale": (v_scale, (P, G, Hkv), torch.float32),
        "pool_pos": (pool_pos, (P, G), None),
        "page_table": (page_table, (B, MP), torch.int32),
        "inv_freq_e": (inv_freq_e, (D,), None)})
    return B, T, H, D, Hkv, MP, G, kv_type


def paged_decode_attention(
    q: torch.Tensor,           # [B, 1, H, D] rotated query (one decode token)
    k_pool: torch.Tensor,      # [P, G, Hkv, D] unrotated pool pages; int8, bf16 or f32
    v_pool: torch.Tensor,      # [P, G, Hkv, D]
    pool_pos: torch.Tensor,    # [P, G] int32, -1 = empty slot
    page_table: torch.Tensor,  # [B, MP] int32, -1 = unmapped
    q_pos: torch.Tensor,       # [B] int32
    inv_freq_e: torch.Tensor,  # [head_dim] f32 (decode_attention.effective_inv_freq)
    k_scale: torch.Tensor | None = None,  # [P, G, Hkv] f32 (INT8-KV mode)
    v_scale: torch.Tensor | None = None,
    logit_scale: float | None = None,
    mscale: float = 1.0,
    split: int | None = None,  # slots per split, for measuring only (decode_plan)
) -> torch.Tensor:
    """Kernel E: fused single-token paged attention; [B, 1, H, D] in q.dtype."""
    B, T, H, D = q.shape
    if T != 1:
        raise ValueError(f"paged_decode_attention is the T == 1 path, got T={T}")
    scale = (logit_scale if logit_scale is not None else 1.0 / (D ** 0.5)) * mscale
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, pool_pos, page_table,
                                     q_pos.reshape(B, 1), inv_freq_e, k_scale,
                                     v_scale, scale)
    q = q.contiguous()
    q_pos = q_pos.reshape(B).contiguous()
    B, T, H, D, Hkv, MP, G, kv_type = _check_cuda(
        q, k_pool, v_pool, pool_pos, page_table, q_pos, inv_freq_e, k_scale, v_scale)
    out = torch.empty((B, 1, H, D), dtype=q.dtype, device=q.device)
    # kernel C's plan of the same logical row
    return dattn.decode_launch(kernels.lib("paged_attention"), "paged_decode_attention", q,
                               k_pool, v_pool, k_scale, v_scale, pool_pos, q_pos, inv_freq_e,
                               out, MP * G, kv_type, scale, split,
                               paged=(page_table, MP, G))


def paged_prefill_attention(
    q: torch.Tensor,           # [B, T, H, D] rotated queries (prompt chunk)
    k_pool: torch.Tensor,      # [P, G, Hkv, D]
    v_pool: torch.Tensor,      # [P, G, Hkv, D]
    pool_pos: torch.Tensor,    # [P, G] int32
    page_table: torch.Tensor,  # [B, MP] int32
    q_pos: torch.Tensor,       # [B, T] int32
    inv_freq_e: torch.Tensor,  # [head_dim] f32
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    logit_scale: float | None = None,
    mscale: float = 1.0,
) -> torch.Tensor:
    """Kernel F: fused chunked-prefill paged attention; [B, T, H, D]."""
    B, T, H, D = q.shape
    scale = (logit_scale if logit_scale is not None else 1.0 / (D ** 0.5)) * mscale
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, pool_pos, page_table,
                                     q_pos, inv_freq_e, k_scale, v_scale, scale)
    q = q.contiguous()
    q_pos = q_pos.contiguous()
    B, T, H, D, Hkv, MP, G, kv_type = _check_cuda(
        q, k_pool, v_pool, pool_pos, page_table, q_pos, inv_freq_e, k_scale, v_scale)
    if tuple(q_pos.shape) != (B, T):
        raise ValueError(f"q_pos must be [B, T] = {(B, T)}")
    dattn.require_aligned(q=q, k_pool=k_pool, v_pool=v_pool)
    tq, split, grid = dattn.prefill_plan(B, T, H, Hkv, MP * G)
    # the scratch tensor owns the memory the pointers address until the launch
    scratch, bufs = dattn.prefill_buffers(B, T, H, Hkv, D, MP * G, grid[2], kv_type, q.device)
    out = torch.empty_like(q)
    if q.dtype == torch.float32:
        name = "paged_prefill_attention_f32q"
        fn = kernels.lib("attention_f32").paged_prefill_attention_f32_launch
    else:
        name = "paged_prefill_attention"
        fn = kernels.lib("paged_attention").paged_prefill_attention_launch
    rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), dattn.ptr(k_scale),
            dattn.ptr(v_scale), pool_pos.data_ptr(), page_table.data_ptr(),
            q_pos.data_ptr(), inv_freq_e.data_ptr(), *bufs,
            out.data_ptr(), B, T, H, Hkv, D, MP, G, tq, split, kv_type, float(scale),
            kernels.stream_ptr(q.device))
    kernels.check(rc, name)
    kernels.count(name)
    return out
