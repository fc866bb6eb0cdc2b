"""Fused flash attention over the position-mapped KV cache (INT8, bf16 or
f32 store).

Counterpart of blama_tpu/ops/pallas/decode_attention.py: one streaming pass
of the stored cache per layer and step replaces the two-pass chain
(ops/attention.py). K stays as stored (int8 codes, bf16 or f32) until it is
in fast memory, rope is applied to K inside the kernel from the slot
position map, and in INT8 mode the scales fold into the score and
probability rows:

    q . rope(ks*codes_k) == ks * (q . rope(codes_k))
    p @ (vs*codes_v)     == (p*vs) @ codes_v

Kernel C (`decode_attention`, T == 1) and kernel D (`prefill_attention`,
T % 8 == 0 prompt chunks) are CUDA C++ (ops/csrc/decode_attention.cu), and
so are the reference's opt-in decode modes, each its own kernel:

  * N, fresh operand (`decode_attention(..., k_new=, v_new=, slot=)`,
    BLAMA_ATTN_FRESH in ops/generate_loop): the step's K/V row is an operand,
    quantized and patched over its slot inside the kernel, so the step reads
    no stored copy of it; C's bits after the cache write;
  * P, in-kernel write (`decode_attention_write`, BLAMA_ATTN_WRITE): N that
    also stores the row (codes and scales) in the cache; C's bits and the
    cache write's bytes;
  * O, head-batched (BLAMA_ATTN_HB, read here at import): its own split and
    tile (`hb_split`, `hb_tile`), so its own numerics; a CTA per (row, kv
    head, chunk of query heads, split) (`hb_plan`).

On a CPU tensor each wrapper runs the plain PyTorch version in this module; on
a CUDA tensor it launches the kernel or raises. The `supports` /
`prefill_supports` / `write_supports` / `fresh_supports` gates and O's route
mirror the reference's, so the same geometry takes the same route in both
packages, and the kernels take every geometry the gates admit: any even
head dim up to 256 (the bodies are built at a padded width, `padded_head_dim`)
and any number of query heads per kv head.

Decode (C, N, P and the paged E) cuts a row's slots into splits at fixed
logical slots (`decode_plan`: every DECODE_SPLIT slots, for every B and S),
so a row's output depends only on its own q, position and logical store:
a row decoded alone and in a batch, or with empty slots appended, gives the
same bits.

Numerics differ from the two-pass chain (online vs two-pass softmax), so
fused attention is an engine *mode*: prover and verifier pick the same mode.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import numpy as np
import torch

from . import kernels
from .kv_cache import quantize_kv, write_rows
from .rope import yarn_corr_dim

NEG_INF = -1e30
TILE_S = 32        # slots per page tile of kernels E and F (pages are whole tiles)

# the reference's probe flags, read once at import as it reads them
# (blama_tpu/ops/pallas/decode_attention.py:46-48); tests set the attributes
_HB = os.environ.get("BLAMA_ATTN_HB", "0") == "1"
# cap on the decode kernels' slots per split (the reference's int8 decode
# block cap), rounded down to whole DECODE_GRAIN; at its default it leaves
# DECODE_SPLIT as it is
_BLOCK_CAP = int(os.environ.get("BLAMA_ATTN_BLOCK_CAP", "1024"))


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


def write_supports(S: int, head_dim: int, k_dtype, batch: int = 1) -> bool:
    """Whether the in-kernel write mode (kernel P) serves this geometry: the
    reference's gate (`decode_attention.py:890`), argument for argument."""
    if not (supports(S, head_dim, k_dtype, batch) and head_dim % 128 == 0
            and S % 32 == 0):
        return False
    bs = _pick_block_s(S, _itemsize(k_dtype), batch)
    return bs is not None and bs % 32 == 0


def fresh_supports(S: int, head_dim: int, k_dtype, batch: int = 1) -> bool:
    """Whether the fresh-operand mode (kernel N) serves this geometry: the
    reference's gate (`decode_attention.py:901`), the same as write mode's."""
    return write_supports(S, head_dim, k_dtype, batch)


def hb_split(S: int, head_dim: int, n_kv_head: int, k_dtype, batch: int = 1,
             scales_t: bool = False, fresh: bool = False) -> int | None:
    """Slots per block of the head-batched kernel O, or None where the
    reference's `_call` (`decode_attention.py:449-461`) keeps its per-head
    kernel: BLAMA_ATTN_HB off, D % 128 != 0, the transposed-scale or
    fresh-operand modes, or no block under O's cap of max(128, 4096 / Hkv)
    slots."""
    if not (_HB and head_dim % 128 == 0 and not scales_t and not fresh):
        return None
    return _pick_block_s(S, _itemsize(k_dtype), batch, cap=max(128, 4096 // n_kv_head))


HB_TILE = 32          # slots a tile of kernel O at most (one a lane)
HB_SMEM = 227 * 1024  # dynamic shared memory a block can take (MAX_SMEM)
HB_HEADS = 4          # query heads a CTA of kernel O at most (HB_HEADS there)


def hb_tile(H: int, Hkv: int, D: int) -> int:
    """Slots per tile of kernel O: HB_TILE, halved while the buffers of the
    port's first O (one block per (row, split) over all kv heads: q and acc
    [H, D], a rotated tile [Hkv, ts, D + 1], probabilities [H, 32], m, l,
    alpha [H], scales [Hkv, ts], positions [ts], all 4 bytes) outgrew
    HB_SMEM. The tile sets where O's online softmax folds and so its bits;
    it stays the first O's for every geometry, whatever the kernel needs
    now. Raises where no tile fits, as that kernel did."""
    def nbytes(ts):
        return 4 * (2 * H * D + Hkv * ts * (D + 1) + H * 32 + 3 * H + 2 * Hkv * ts + ts)

    ts = HB_TILE
    while ts > 1 and nbytes(ts) > HB_SMEM:
        ts //= 2
    if nbytes(ts) > HB_SMEM:
        raise ValueError(f"kernel O takes no tile at H={H} Hkv={Hkv} D={D}")
    return ts


class HbPlan(NamedTuple):
    ts: int        # slots a tile (hb_tile)
    heads: int     # query heads a CTA
    grid: tuple    # (rows x kv heads x head chunks, splits)


def hb_plan(B: int, H: int, Hkv: int, D: int, S: int, chunk: int) -> HbPlan:
    """The launch of kernel O: a CTA per (row, kv head, chunk of up to
    HB_HEADS of its query heads, split of `chunk` slots), tiles of hb_tile
    slots. Each head's sums are its own, so the head chunks move no bit;
    the kernel picks its ring and steps from its shared memory, which move
    none either."""
    g = H // Hkv
    heads = min(g, HB_HEADS)
    return HbPlan(hb_tile(H, Hkv, D), heads, (B * Hkv * -(-g // heads), -(-S // chunk)))


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


def fresh_attention_plain(q, k_cache, v_cache, q_pos, kv_pos, inv_freq_e, k_new,
                          v_new, slot, k_scale=None, v_scale=None, scale: float = 1.0):
    """Kernel N's function: flash_attention_plain over the cache with each
    row's fresh K/V row [B, Hkv, D] stored at its slot (slot >= S: a pad row,
    nothing patched) the way the cache write stores it; the cache itself is
    left as it is. q [B, 1, H, D], q_pos [B, 1]."""
    B, S = kv_pos.shape
    live = (slot < S).nonzero().flatten()
    kc, vc = k_cache.clone(), v_cache.clone()
    ksc = None if k_scale is None else k_scale.clone()
    vsc = None if v_scale is None else v_scale.clone()
    flat = live * S + slot[live].long()
    write_rows(kc.view(B * S, *kc.shape[2:]), vc.view(B * S, *vc.shape[2:]),
               None if ksc is None else ksc.view(B * S, -1),
               None if vsc is None else vsc.view(B * S, -1),
               flat, k_new[live], v_new[live])
    return flash_attention_plain(q, kc, vc, q_pos, kv_pos, inv_freq_e, ksc, vsc, scale)


def write_attention_plain(q, k_store, v_store, q_pos, kv_pos, inv_freq_e, k_new,
                          v_new, slot, k_scale=None, v_scale=None, scale: float = 1.0):
    """Kernel P's function: store each row's fresh K/V row [B, Hkv, D] in
    the layer's store [B*S + 1, Hkv, D] at its flat slot (a pad row's at the
    spare slot B*S), as the cache write does, then flash_attention_plain over
    the rows. q [B, 1, H, D], q_pos [B, 1]."""
    B, S = kv_pos.shape
    rows = torch.arange(B, device=slot.device) * S
    flat = torch.where(slot < S, rows + slot.long(), B * S)
    write_rows(k_store, v_store, k_scale, v_scale, flat, k_new, v_new)

    def rows_of(t):
        return None if t is None else t[:B * S].view(B, S, *t.shape[1:])

    return flash_attention_plain(q, rows_of(k_store), rows_of(v_store), q_pos, kv_pos,
                                 inv_freq_e, rows_of(k_scale), rows_of(v_scale), scale)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

KV_TYPES = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}


def kv_type_of(k_cache, v_cache, k_scale, v_scale) -> int:
    """The kernels' store type: 0 = int8 codes with f32 scales, 1 = bf16 or
    2 = f32 values with none."""
    if k_cache.dtype != v_cache.dtype:
        raise TypeError("k and v caches must share a dtype")
    kv_type = KV_TYPES.get(k_cache.dtype)
    if kv_type is None or (kv_type == 0) != (k_scale is not None and v_scale is not None):
        raise NotImplementedError(
            "the CUDA attention kernels take an INT8 cache with scales or a bf16 "
            f"or f32 cache without, got {k_cache.dtype} "
            f"{'with' if k_scale is not None else 'without'} scales")
    return kv_type


PADDED_HEAD_DIMS = (64, 128, 256)   # the widths the kernels' bodies are built at


def padded_head_dim(head_dim: int) -> int:
    """The width whose body serves `head_dim` (an even D <= 256): the
    smallest of PADDED_HEAD_DIMS that holds it; the body reads zeros past D
    and writes the first D outputs."""
    if head_dim < 2 or head_dim % 2 or head_dim > PADDED_HEAD_DIMS[-1]:
        raise ValueError(f"the attention kernels take an even head dim <= 256, not {head_dim}")
    return next(dp for dp in PADDED_HEAD_DIMS if head_dim <= dp)


def require_kernel_geometry(device, n_head: int, n_head_kv: int, head_dim: int,
                            kv_dtype) -> None:
    """Refuse, where a cache is created for a card, what no attention kernel
    takes: a head dim the fused gates refuse (odd or above 256; the
    reference runs those through its two-pass chain), query heads that are
    not a whole multiple of the kv heads, or a store type other than INT8,
    bf16 and f32. Every geometry the gates admit runs on the card; on the
    CPU the plain versions serve all of it. On a card the owner of the cache
    calls this at construction, so no step fails in the middle of
    `forward`."""
    if torch.device(device).type == "cpu":
        return
    if head_dim % 2 or head_dim > PADDED_HEAD_DIMS[-1] or n_head % n_head_kv:
        raise NotImplementedError(
            f"the CUDA attention kernels take an even head_dim <= 256 and a whole "
            f"number of query heads per KV head, got n_head={n_head} "
            f"n_head_kv={n_head_kv} head_dim={head_dim} (the two-pass chain, "
            "attn=\"xla\": ROADMAP.md §1 item 9)")
    if kv_dtype not in KV_TYPES:
        raise NotImplementedError(
            f"the CUDA attention kernels read an INT8, a bf16 or an f32 cache, "
            f"got {kv_dtype} (ROADMAP.md §1 item 9, other engines)")


# the query (and output) types the kernels take: bf16 (the packed engines and
# the bfloat16 engine) and f32 (the float32 engine; kernels C, D, E and F
# only, ops/csrc/attention_f32.cu)
Q_TYPES = (torch.bfloat16, torch.float32)


def check_cuda_common(q, inv_freq_e, q_pos, kv_pos, Hkv):
    B, T, H, D = q.shape
    if q.dtype not in Q_TYPES:
        raise TypeError(f"queries must be bf16 or f32, got {q.dtype}")
    if D % 2 or D > PADDED_HEAD_DIMS[-1] or H % Hkv:
        raise ValueError(f"unsupported head geometry H={H} Hkv={Hkv} D={D}")
    if kv_pos.dtype != torch.int32 or q_pos.dtype != torch.int32:
        raise TypeError("positions must be int32")
    if inv_freq_e.dtype != torch.float32:
        raise TypeError("inv_freq_e must be f32")


def check_tensors(device, expect: dict) -> None:
    for name, (t, shp, dtype) in expect.items():
        if t is None:
            continue
        if (tuple(t.shape) != shp or t.device != device or not t.is_contiguous()
                or (dtype is not None and t.dtype != dtype)):
            raise ValueError(
                f"{name}: need a contiguous {shp} {dtype or ''} tensor on {device}")


def ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _check_cuda(q, k_cache, v_cache, k_scale, v_scale, kv_pos, q_pos, inv_freq_e):
    B, T, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    kv_type = kv_type_of(k_cache, v_cache, k_scale, v_scale)
    check_cuda_common(q, inv_freq_e, q_pos, kv_pos, Hkv)
    check_tensors(q.device, {
        "k_cache": (k_cache, (B, S, Hkv, D), None),
        "v_cache": (v_cache, (B, S, Hkv, D), None),
        "k_scale": (k_scale, (B, S, Hkv), torch.float32),
        "v_scale": (v_scale, (B, S, Hkv), torch.float32),
        "kv_pos": (kv_pos, (B, S), None), "inv_freq_e": (inv_freq_e, (D,), None)})
    return B, T, H, D, S, Hkv, kv_type


DECODE_SPLIT = 128   # slots per split of a row's slot range, for every B and S
DECODE_GRAIN = 64    # a split is whole grains (every body's tile divides it)


def decode_heads(head_dim: int, group: int) -> int:
    """Query heads of one kv head a CTA of the decode body takes (its GC,
    attention_common.cuh): 4, or 8 for a group of more than 4 at a padded
    width of at most 128 (registers bound the 256-wide body to 4)."""
    return 8 if group > 4 and padded_head_dim(head_dim) <= 128 else 4


def decode_plan(B: int, H: int, Hkv: int, S: int, D: int,
                split: int | None = None) -> tuple[int, int, tuple]:
    """The launch of the decode body (kernels C, E, N, P): (slots per split,
    query heads per CTA, grid). The split width is one constant,
    DECODE_SPLIT, capped by BLAMA_ATTN_BLOCK_CAP in whole DECODE_GRAIN, so
    split boundaries sit at the same logical slots whatever B and S are and
    a row's bits do not depend on them; empty slots appended past the row's
    last visible one only add splits the query does not see. A CTA takes one
    (row, kv head, split) and up to `decode_heads` query heads of the kv
    head (each head its own sums, so the chunking moves no bit). `split` (a
    multiple of DECODE_GRAIN) is for measuring only: it moves the
    boundaries, and with them the bits."""
    if split is None:
        split = min(DECODE_SPLIT, max(DECODE_GRAIN, _BLOCK_CAP // DECODE_GRAIN * DECODE_GRAIN))
    if split < 1 or split % DECODE_GRAIN:
        raise ValueError(f"split must be a positive multiple of {DECODE_GRAIN}, not {split}")
    heads = decode_heads(D, H // Hkv)
    chunks = -(-(H // Hkv) // heads)
    return split, heads, (B * Hkv * chunks, -(-S // split))


_TICKETS: dict = {}


def tickets(device, n: int) -> torch.Tensor:
    """The decode body's arrival tickets on `device`: int32, zero between
    calls (the last CTA of each group leaves its ticket at zero), at least
    `n` of them. A larger set replaces a smaller one; the old set stays
    alive, so a CUDA graph captured with it stays valid."""
    key = torch.device(device)
    held = _TICKETS.setdefault(key, [])
    if not held or held[-1].numel() < n:
        held.append(torch.zeros(max(n, 4096), dtype=torch.int32, device=key))
    return held[-1]


def decode_work(B: int, H: int, D: int, nsplit: int, dev) -> torch.Tensor | None:
    """The decode body's partials for a row that spans more than one split,
    one allocation: f32 m and l [B, H, nsplit], acc [B, H, nsplit, D]. The
    stream orders the kernel before any later use of the memory."""
    if nsplit == 1:
        return None
    return torch.empty(B * H * nsplit * (2 + D), dtype=torch.float32, device=dev)


def require_bf16_query(q, kernel: str) -> None:
    """Kernels N, P and O have bf16-query instances only."""
    if q.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"kernel {kernel} takes bf16 queries only, got {q.dtype}: the float32 "
            "engine runs C, D, E and F (ROADMAP.md §1 item 9, the rest of it)")


def decode_launch(lib, name, q, k, v, k_scale, v_scale, kv_pos, q_pos, inv_freq_e, out,
                  S, kv_type, scale, split=None, fresh=None, write=0, paged=None):
    """Launch kernel C, N or P (dense; `fresh` = (k_new, v_new, slot)) or E
    (`paged` = (page_table, MP, G)) through the decode plan and count it; at
    f32 queries C or E from the f32 library (attention_f32.cu), counted
    under `name` + "_f32q"."""
    B, _, H, D = q.shape
    f32 = q.dtype == torch.float32
    if f32:
        if fresh is not None:
            require_bf16_query(q, "P" if write else "N")
        lib, name = kernels.lib("attention_f32"), name + "_f32q"
    Hkv = k.shape[-2]
    split, heads, grid = decode_plan(B, H, Hkv, S, D, split)
    work = decode_work(B, H, D, grid[1], q.device)
    tk = tickets(q.device, grid[0]) if grid[1] > 1 else None
    stream = kernels.stream_ptr(q.device)
    if paged is not None:
        table, MP, G = paged
        fn = lib.paged_decode_attention_f32_launch if f32 else lib.paged_decode_attention_launch
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(k_scale), ptr(v_scale),
                kv_pos.data_ptr(), table.data_ptr(), q_pos.data_ptr(), inv_freq_e.data_ptr(),
                ptr(work), ptr(tk), out.data_ptr(), B, H, Hkv, D, MP, G, split, heads, kv_type,
                float(scale), stream)
    elif f32:
        rc = lib.decode_attention_f32_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(k_scale), ptr(v_scale),
            kv_pos.data_ptr(), q_pos.data_ptr(), inv_freq_e.data_ptr(), ptr(work), ptr(tk),
            out.data_ptr(), B, H, Hkv, D, S, split, heads, kv_type, float(scale), stream)
    else:
        k_new, v_new, slot = fresh or (None, None, None)
        rc = lib.decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(k_scale), ptr(v_scale),
            kv_pos.data_ptr(), q_pos.data_ptr(), inv_freq_e.data_ptr(), ptr(k_new),
            ptr(v_new), ptr(slot), ptr(work), ptr(tk), out.data_ptr(), B, H, Hkv, D, S,
            split, heads, kv_type, write, float(scale), stream)
    kernels.check(rc, name)
    kernels.count(name)
    return out


PREFILL_ROWS = 64     # MMA rows (query token x head) per CTA of D and F (PF_ROWS)
PREFILL_SPLIT = 512   # slots per split of a row's slot range, for every B, T and S
PREFILL_TILE = 32     # slots per staged tile of D and F (PF_TS)


def prefill_plan(B: int, T: int, H: int, Hkv: int, S: int,
                 split: int = PREFILL_SPLIT) -> tuple[int, int, tuple]:
    """The launch of kernels D and F: (query tokens per CTA, slots per
    split, grid). A CTA packs `tq` tokens times the H / Hkv query heads of
    one kv head into at most PREFILL_ROWS MMA rows; a group of more heads
    is cut into slices of PREFILL_ROWS heads, one token a CTA. The split
    width is fixed, so split boundaries sit at the same logical slots
    whatever B, T and S are, and a query's bits do not depend on them. The
    token blocking and the head slices move no bit (each MMA row is its
    own). `split` other than PREFILL_SPLIT (a multiple of PREFILL_TILE) is
    for measuring only: it moves the boundaries, and with them the bits."""
    if split < 1 or split % PREFILL_TILE:
        raise ValueError(f"split must be a positive multiple of {PREFILL_TILE}, not {split}")
    g = H // Hkv
    tq = max(1, min(PREFILL_ROWS // g, T))
    slices = -(-g // PREFILL_ROWS)
    return tq, split, (B * Hkv, -(-T // tq) * slices, -(-S // split))


def require_aligned(**tensors) -> None:
    """Kernels D and F stage 16-byte pieces with cp.async."""
    for name, t in tensors.items():
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def prefill_buffers(B: int, T: int, H: int, Hkv: int, D: int, S: int, nsplit: int,
                    kv_type: int, dev) -> tuple[torch.Tensor, list[int]]:
    """Kernels D and F's device scratch, one allocation per call, and the
    pointers into it (0 for a part not needed): the staged rows at the
    padded width DP = padded_head_dim(D) (rotated K as a high and a low bf16
    half [B, Hkv, Sp, 2, DP], V in bf16 [B, Hkv, Sp, 1, DP], or [.., 2, DP]
    as two halves from an f32 store, positions [B, Sp], each tile's least
    visible position [B, Sp / tile], the int8 store's scales [B, Hkv, Sp];
    Sp = S in whole tiles) and the split partials (m, l [B, T, H, nsplit],
    acc [.., D]; none for one split). The stream orders the kernel before
    any later use of the memory, so the caching allocator may hand it out
    again on return."""
    ts = PREFILL_TILE
    sp = -(-S // ts) * ts
    dp = padded_head_dim(D)
    rows, parts = B * Hkv * sp, B * T * H * nsplit
    quantized, nv = kv_type == 0, 2 if kv_type == 2 else 1
    sizes = [4 * rows * dp, 2 * nv * rows * dp, 4 * B * sp, 4 * B * (sp // ts),
             4 * rows * quantized, 4 * rows * quantized,
             4 * parts * (nsplit > 1), 4 * parts * (nsplit > 1), 4 * parts * D * (nsplit > 1)]
    offs, n = [], 0
    for size in sizes:
        offs.append(n if size else None)
        n += -(-size // 256) * 256
    buf = torch.empty(n, dtype=torch.uint8, device=dev)
    return buf, [0 if o is None else buf.data_ptr() + o for o in offs]


def _check_fresh(q, k_new, v_new, slot, Hkv):
    B, _, H, D = q.shape
    check_tensors(q.device, {"k_new": (k_new, (B, Hkv, D), torch.bfloat16),
                             "v_new": (v_new, (B, Hkv, D), torch.bfloat16),
                             "slot": (slot, (B,), torch.int32)})


def decode_attention(
    q: torch.Tensor,          # [B, 1, H, D] rotated query (one decode token)
    k_cache: torch.Tensor,    # [B, S, Hkv, D] unrotated; int8 codes, bf16 or f32
    v_cache: torch.Tensor,    # [B, S, Hkv, D]
    q_pos: torch.Tensor,      # [B] int32
    kv_pos: torch.Tensor,     # [B, S] int32, -1 = empty slot
    inv_freq_e: torch.Tensor,  # [head_dim] f32 from effective_inv_freq
    k_scale: torch.Tensor | None = None,  # [B, S, Hkv] f32 (INT8-KV mode)
    v_scale: torch.Tensor | None = None,
    logit_scale: float | None = None,
    mscale: float = 1.0,
    scales_t: bool = False,   # the loops' transposed-scale mode: no kernel O
    k_new: torch.Tensor | None = None,  # [B, Hkv, D] fresh-token K (kernel N)
    v_new: torch.Tensor | None = None,
    slot: torch.Tensor | None = None,   # [B] int32 slot of the fresh token
    split: int | None = None,  # slots per split, for measuring only (decode_plan)
) -> torch.Tensor:
    """Fused single-token attention; returns [B, 1, H, D] in q.dtype (bf16,
    or f32: C's f32-query instance; N, P and O take bf16 only).

    Kernel C; kernel N when the fresh row is given (the cache need not hold
    it yet: it is patched over `slot`, a pad row's slot >= S patches
    nothing); kernel O where `hb_split` takes the head-batched route (on the
    CPU its plain version is C's function)."""
    B, T, H, D = q.shape
    if T != 1:
        raise ValueError(f"decode_attention is the T == 1 path, got T={T}")
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    fresh = k_new is not None
    scale = (logit_scale if logit_scale is not None else 1.0 / (D ** 0.5)) * mscale
    if q.device.type == "cpu":
        if fresh:
            return fresh_attention_plain(q, k_cache, v_cache, q_pos.reshape(B, 1), kv_pos,
                                         inv_freq_e, k_new, v_new, slot.reshape(B),
                                         k_scale, v_scale, scale)
        return flash_attention_plain(q, k_cache, v_cache, q_pos.reshape(B, 1),
                                     kv_pos, inv_freq_e, k_scale, v_scale, scale)
    q = q.contiguous()
    q_pos = q_pos.reshape(B).contiguous()
    B, T, H, D, S, Hkv, kv_type = _check_cuda(q, k_cache, v_cache, k_scale, v_scale,
                                              kv_pos, q_pos, inv_freq_e)
    out = torch.empty((B, 1, H, D), dtype=q.dtype, device=q.device)
    lib = kernels.lib("decode_attention")
    hb = hb_split(S, D, Hkv, k_cache.dtype, B, scales_t, fresh)
    if hb:
        require_bf16_query(q, "O")
        plan = hb_plan(B, H, Hkv, D, S, hb)
        groups, nsplit = plan.grid
        # one scratch: the rope angles [B*S, D], the partials m, l [B, H,
        # nsplit] and acc [B, H, nsplit, D], all f32
        n_ang, n_ml = B * S * D, B * H * nsplit
        work = torch.empty(n_ang + n_ml * (2 + D), dtype=torch.float32, device=q.device)
        at = work.data_ptr()
        rc = lib.decode_attention_hb_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), ptr(k_scale),
            ptr(v_scale), kv_pos.data_ptr(), q_pos.data_ptr(), inv_freq_e.data_ptr(), at,
            at + 4 * n_ang, at + 4 * (n_ang + n_ml), at + 4 * (n_ang + 2 * n_ml),
            tickets(q.device, groups).data_ptr(), out.data_ptr(), B, H, Hkv, D, S, hb, plan.ts,
            plan.heads, kv_type, float(scale), kernels.stream_ptr(q.device))
        kernels.check(rc, "decode_attention_hb")
        kernels.count("decode_attention_hb")
        return out
    if fresh:
        require_bf16_query(q, "N")
        slot = slot.reshape(B)
        _check_fresh(q, k_new, v_new, slot, Hkv)
    return decode_launch(lib, "decode_attention_fresh" if fresh else "decode_attention", q,
                         k_cache, v_cache, k_scale, v_scale, kv_pos, q_pos, inv_freq_e, out,
                         S, kv_type, scale, split, (k_new, v_new, slot) if fresh else None)


def decode_attention_write(
    q: torch.Tensor,          # [B, 1, H, D] rotated query
    k_store: torch.Tensor,    # [B*S + 1, Hkv, D] the layer's store, spare slot last
    v_store: torch.Tensor,
    q_pos: torch.Tensor,      # [B] int32
    kv_pos: torch.Tensor,     # [B, S] int32 (already holds this token's position)
    inv_freq_e: torch.Tensor,  # [head_dim] f32
    k_new: torch.Tensor,      # [B, Hkv, D] fresh (unrotated) K
    v_new: torch.Tensor,
    slot: torch.Tensor,       # [B] int32 row slot to write (>= S: a pad row)
    k_scale: torch.Tensor | None = None,  # [B*S + 1, Hkv] f32 (INT8-KV mode)
    v_scale: torch.Tensor | None = None,
    logit_scale: float | None = None,
    mscale: float = 1.0,
    split: int | None = None,  # slots per split, for measuring only (decode_plan)
) -> torch.Tensor:
    """Kernel P: fused single-token attention that also quantizes the fresh
    K/V row and writes it (codes and scales, or the values) into the store,
    in place, at the slot `KVCache.flat_slots` gives (a pad row's at the
    spare slot). Returns [B, 1, H, D]; the output and the store equal C's
    after `SlotStore.write`, bit for bit."""
    B, T, H, D = q.shape
    if T != 1:
        raise ValueError(f"decode_attention_write is the T == 1 path, got T={T}")
    S, Hkv = kv_pos.shape[1], k_store.shape[1]
    scale = (logit_scale if logit_scale is not None else 1.0 / (D ** 0.5)) * mscale
    slot = slot.reshape(B)
    if q.device.type == "cpu":
        return write_attention_plain(q, k_store, v_store, q_pos.reshape(B, 1), kv_pos,
                                     inv_freq_e, k_new, v_new, slot, k_scale, v_scale,
                                     scale)
    q = q.contiguous()
    q_pos = q_pos.reshape(B).contiguous()
    kv_type = kv_type_of(k_store, v_store, k_scale, v_scale)
    check_cuda_common(q, inv_freq_e, q_pos, kv_pos, Hkv)
    n = B * S + 1
    check_tensors(q.device, {
        "k_store": (k_store, (n, Hkv, D), None), "v_store": (v_store, (n, Hkv, D), None),
        "k_scale": (k_scale, (n, Hkv), torch.float32),
        "v_scale": (v_scale, (n, Hkv), torch.float32),
        "kv_pos": (kv_pos, (B, S), None), "inv_freq_e": (inv_freq_e, (D,), None)})
    require_bf16_query(q, "P")
    _check_fresh(q, k_new, v_new, slot, Hkv)
    out = torch.empty((B, 1, H, D), dtype=q.dtype, device=q.device)
    return decode_launch(kernels.lib("decode_attention"), "decode_attention_write", q,
                         k_store, v_store, k_scale, v_scale, kv_pos, q_pos, inv_freq_e, out,
                         S, kv_type, scale, split, (k_new, v_new, slot), write=1)


def prefill_attention(
    q: torch.Tensor,          # [B, T, H, D] rotated queries (prompt chunk)
    k_cache: torch.Tensor,    # [B, S, Hkv, D] unrotated; int8 codes, bf16 or f32
    v_cache: torch.Tensor,    # [B, S, Hkv, D]
    q_pos: torch.Tensor,      # [B, T] int32
    kv_pos: torch.Tensor,     # [B, S] int32, -1 = empty slot
    inv_freq_e: torch.Tensor,  # [head_dim] f32 from effective_inv_freq
    k_scale: torch.Tensor | None = None,  # [B, S, Hkv] f32 (INT8-KV mode)
    v_scale: torch.Tensor | None = None,
    logit_scale: float | None = None,
    mscale: float = 1.0,
    split: int = PREFILL_SPLIT,
) -> torch.Tensor:
    """Kernel D: fused causal chunk attention; returns [B, T, H, D] in
    q.dtype (bf16, or f32: the f32-query instance). `split` is for
    measuring only (prefill_plan)."""
    B, T, H, D = q.shape
    scale = (logit_scale if logit_scale is not None else 1.0 / (D ** 0.5)) * mscale
    if q.device.type == "cpu":
        return flash_attention_plain(q, k_cache, v_cache, q_pos, kv_pos,
                                     inv_freq_e, k_scale, v_scale, scale)
    q = q.contiguous()
    q_pos = q_pos.contiguous()
    B, T, H, D, S, Hkv, kv_type = _check_cuda(q, k_cache, v_cache, k_scale, v_scale,
                                     kv_pos, q_pos, inv_freq_e)
    if tuple(q_pos.shape) != (B, T):
        raise ValueError(f"q_pos must be [B, T] = {(B, T)}")
    require_aligned(q=q, k_cache=k_cache, v_cache=v_cache)
    tq, split, grid = prefill_plan(B, T, H, Hkv, S, split)
    # the scratch tensor owns the memory the pointers address until the launch
    scratch, bufs = prefill_buffers(B, T, H, Hkv, D, S, grid[2], kv_type, q.device)
    out = torch.empty_like(q)
    if q.dtype == torch.float32:
        name = "prefill_attention_f32q"
        fn = kernels.lib("attention_f32").prefill_attention_f32_launch
    else:
        name, fn = "prefill_attention", kernels.lib("decode_attention").prefill_attention_launch
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), ptr(k_scale),
            ptr(v_scale), kv_pos.data_ptr(), q_pos.data_ptr(), inv_freq_e.data_ptr(),
            *bufs, out.data_ptr(), B, T, H, Hkv, D, S, tq, split,
            kv_type, float(scale), kernels.stream_ptr(q.device))
    kernels.check(rc, name)
    kernels.count(name)
    return out
