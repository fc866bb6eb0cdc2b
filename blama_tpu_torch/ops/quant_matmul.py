"""Q4_K weights for the W4A8 engine (`q4k_a8`) and the matmul dispatch.

Counterpart of blama_tpu/ops/pallas/quant_matmul.py for the `q4k_a8`
engine. The weight layout is chosen for a GEMV that streams each output
column's weights along K:

  codes  uint8 [N, K/2]  row n holds K/32 groups of 16 bytes; byte i of
                         group g = code[32g + i] | code[32g + 16 + i] << 4
  scales bf16  [N, K/32] d·sc of each 32-group
  mins   bf16  [N, K/32] dmin·mn of each 32-group

  value[k, n] = codes(n, k) · scales[n, k//32] − mins[n, k//32]

(K = n_in, N = n_out.) bf16 scales/mins keep the reference's 5 bits/weight.

`qmm` dispatches on the number of flat rows as the reference's
_quant_kernel_call does: up to A8S_MAX_BATCH rows take kernel A (W4A8:
activations quantized per 32-group to int8, int8 dots against the 4-bit
codes), more rows take kernel B (exact dequant-matmul in f32, min term
outside the kernel). Both kernels are CUDA C++ (ops/csrc/quant_matmul.cu).
On a CPU tensor each wrapper runs its plain PyTorch version below; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import kernels

GROUP = 32        # Q4_K sub-block size
QK_K = 256        # Q4_K superblock
# row count up to which the W4A8 kernel serves (reference A8S_MAX_BATCH)
A8S_MAX_BATCH = 16


@dataclass
class QuantTensorA8S:
    """Packed Q4_K weight of the W4A8 engine, x @ W semantics (n_in, n_out)."""

    codes: torch.Tensor    # uint8 [N, K/2]
    scales: torch.Tensor   # bf16  [N, K/32]
    mins: torch.Tensor     # bf16  [N, K/32]

    @property
    def n_out(self) -> int:
        return self.codes.shape[0]

    @property
    def shape(self):
        return (self.codes.shape[1] * 2, self.codes.shape[0])

    @property
    def device(self):
        return self.codes.device


@dataclass
class QuantEmbedding:
    """Row-gatherable packed Q4_K embedding table (dequant on gather), the
    reference's layout: codes pack the halves (j, j + E/2) of each row, and
    f32 scales keep dequantized values bitwise equal to the host dequant."""

    codes: torch.Tensor    # uint8 [V, E/2]: code[j] | code[j + E/2] << 4
    scales: torch.Tensor   # f32   [V, E/32]
    mins: torch.Tensor     # f32   [V, E/32]

    @property
    def shape(self):
        return (self.codes.shape[0], self.codes.shape[1] * 2)


# ---------------------------------------------------------------------------
# repack from GGUF Q4_K bytes (runs on the target device, one tensor at a time)
# ---------------------------------------------------------------------------

def _unpack_scale_min_k4(q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """12-byte Q4_K scale block [n, 12] → (sc, mn) int32 [n, 8]."""
    q = q.to(torch.int32)
    sc_lo = q[:, 0:4] & 63
    mn_lo = q[:, 4:8] & 63
    sc_hi = (q[:, 8:12] & 0xF) | ((q[:, 0:4] >> 6) << 4)
    mn_hi = (q[:, 8:12] >> 4) | ((q[:, 4:8] >> 6) << 4)
    return torch.cat([sc_lo, sc_hi], dim=1), torch.cat([mn_lo, mn_hi], dim=1)


def unpack_q4k(data, n_rows: int, row_len: int, device="cuda"):
    """GGUF Q4_K bytes → (codes u8 [N, K] in element order, scales f32
    [N, K/32], mins f32 [N, K/32]) on `device`. Same bit walk and the same
    f32 products as the reference's host unpack (unpack_q4k_arrays)."""
    device = kernels.resolve_device(device)
    raw = torch.from_numpy(np.array(data, dtype=np.uint8, copy=True))
    blk = raw.to(device).view(-1, 144)
    nb = blk.shape[0]
    d = blk[:, 0:2].contiguous().view(torch.float16).float()      # [nb, 1]
    dmin = blk[:, 2:4].contiguous().view(torch.float16).float()
    sc, mn = _unpack_scale_min_k4(blk[:, 4:16])
    qs = blk[:, 16:].reshape(nb, 4, 32)
    # chunk c: low nibbles are elements 64c..64c+31, high nibbles 64c+32..
    codes = torch.stack([qs & 0x0F, qs >> 4], dim=2).reshape(n_rows, row_len)
    scales = (d * sc.float()).reshape(n_rows, row_len // GROUP)
    mins = (dmin * mn.float()).reshape(n_rows, row_len // GROUP)
    return codes, scales, mins


def pack_a8s(codes: torch.Tensor, scales: torch.Tensor,
             mins: torch.Tensor) -> QuantTensorA8S:
    """Element-order codes u8 [N, K] + f32 scales/mins [N, K/32] → the
    kernel layout (bf16 scales/mins)."""
    N, K = codes.shape
    c = codes.reshape(N, K // GROUP, GROUP)
    packed = (c[..., :16] | (c[..., 16:] << 4)).reshape(N, K // 2)
    return QuantTensorA8S(packed.contiguous(), scales.to(torch.bfloat16).contiguous(),
                          mins.to(torch.bfloat16).contiguous())


def repack_q4k_a8s(data, n_rows: int, row_len: int, device="cuda") -> QuantTensorA8S:
    """GGUF Q4_K tensor bytes → QuantTensorA8S on `device`."""
    return pack_a8s(*unpack_q4k(data, n_rows, row_len, device))


def repack_q4k_embedding(data, n_rows: int, row_len: int, device="cuda") -> QuantEmbedding:
    """GGUF Q4_K token_embd bytes → row-major QuantEmbedding on `device`."""
    codes, scales, mins = unpack_q4k(data, n_rows, row_len, device)
    half = row_len // 2
    packed = codes[:, :half] | (codes[:, half:] << 4)
    return QuantEmbedding(packed.contiguous(), scales.contiguous(), mins.contiguous())


def unpair_codes(codes: torch.Tensor) -> torch.Tensor:
    """QuantTensorA8S codes [N, K/2] → element-order codes u8 [N, K]."""
    N = codes.shape[0]
    c = codes.reshape(N, -1, 16)
    return torch.cat([c & 0x0F, c >> 4], dim=-1).reshape(N, -1)


def emb_lookup(emb: QuantEmbedding, tokens: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Packed embedding row gather, dequantized on the fly."""
    ci = emb.codes[tokens].to(torch.int32)               # [..., E/2]
    q = torch.cat([ci & 0xF, (ci >> 4) & 0xF], dim=-1).float()
    s = emb.scales[tokens]                                # [..., E/32]
    m = emb.mins[tokens]
    lead = q.shape[:-1]
    qg = q.reshape(*lead, -1, GROUP)
    vals = qg * s[..., None] - m[..., None]
    return vals.reshape(*lead, -1).to(dtype)


# ---------------------------------------------------------------------------
# kernel A: W4A8 for 1..16 rows
# ---------------------------------------------------------------------------

def quant_acts(x: torch.Tensor):
    """[M, K] float → (xq int8 [M, K], xs f32 [M, K/32], sxm f32 [M, K/32]):
    per-32-group scale amax/127, codes round(x·(1/scale)), and
    scale·Σcodes (the min-term weight). Plain version of kernel A's prologue."""
    M, K = x.shape
    xg = x.float().reshape(M, K // GROUP, GROUP)
    amax = torch.amax(torch.abs(xg), dim=-1)
    # a tensor divisor: torch divides by a Python scalar on CUDA through its
    # reciprocal, which is not the reference's IEEE division
    scale = amax / torch.full_like(amax, 127.0)
    inv = torch.where(scale > 0, 1.0 / torch.where(scale > 0, scale, 1.0), 0.0)
    xqg = torch.round(xg * inv[..., None]).to(torch.int8)
    xsum = torch.sum(xqg.to(torch.int32), dim=-1).float()
    return xqg.reshape(M, K), scale, scale * xsum


def w4a8_matmul_plain(x: torch.Tensor, w: QuantTensorA8S) -> torch.Tensor:
    """Plain version of kernel A: x [M, K] → [M, N] f32."""
    xq, xs, sxm = quant_acts(x)
    M, K = xq.shape
    G = K // GROUP
    codes = unpair_codes(w.codes).reshape(-1, G, GROUP).float()  # [N, G, 32]
    # int8 x 4-bit dots of one group stay below 2^24: exact in f32
    dots = torch.einsum("mgi,ngi->mng", xq.reshape(M, G, GROUP).float(), codes)
    ws, wm = w.scales.float(), w.mins.float()                   # [N, G]
    terms = dots * ws[None] * xs[:, None, :] - sxm[:, None, :] * wm[None]
    return terms.sum(dim=-1)


def _check_cuda_weight(x: torch.Tensor, w: QuantTensorA8S) -> tuple[int, int, int]:
    M, K = x.shape
    N = w.n_out
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"activations must be bf16 or f32, got {x.dtype}")
    if K % GROUP or w.codes.shape != (N, K // 2):
        raise ValueError(f"x {tuple(x.shape)} does not match codes {tuple(w.codes.shape)}")
    for t, dt in ((w.codes, torch.uint8), (w.scales, torch.bfloat16),
                  (w.mins, torch.bfloat16)):
        if t.device != x.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError("weight arrays must be contiguous on x's device")
    if not x.is_contiguous():
        raise ValueError("activations must be contiguous")
    return M, K, N


def w4a8_launch(x: torch.Tensor, w: QuantTensorA8S):
    """Launch kernel A on CUDA tensors. Returns (out [M, N] f32, and the
    prologue's xq, xs, sxm, so a check can compare the activation codes)."""
    M, K, N = _check_cuda_weight(x, w)
    if not 1 <= M <= A8S_MAX_BATCH:
        raise ValueError(f"kernel A takes 1..{A8S_MAX_BATCH} rows, got {M}")
    dev = x.device
    xq = torch.empty((M, K), dtype=torch.int8, device=dev)
    xs = torch.empty((M, K // GROUP), dtype=torch.float32, device=dev)
    sxm = torch.empty_like(xs)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    rc = kernels.lib("quant_matmul").w4a8_matmul_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), w.codes.data_ptr(),
        w.scales.data_ptr(), w.mins.data_ptr(), xq.data_ptr(), xs.data_ptr(),
        sxm.data_ptr(), out.data_ptr(), M, K, N, kernels.stream_ptr(dev))
    kernels.check(rc, "w4a8_gemv")
    kernels.count("w4a8_gemv")
    return out, xq, xs, sxm


def w4a8_matmul(x: torch.Tensor, w: QuantTensorA8S) -> torch.Tensor:
    """Kernel A: x [M <= 16, K] @ W → [M, N] f32."""
    if x.device.type == "cpu":
        return w4a8_matmul_plain(x, w)
    return w4a8_launch(x, w)[0]


# ---------------------------------------------------------------------------
# kernel B: exact dequant-matmul for more than 16 rows
# ---------------------------------------------------------------------------

def q4k_pos_plain(x: torch.Tensor, w: QuantTensorA8S) -> torch.Tensor:
    """Plain version of kernel B: x [M, K] @ (code·scale) → [M, N] f32."""
    N = w.n_out
    codes = unpair_codes(w.codes).reshape(N, -1, GROUP).float()
    wdq = (codes * w.scales.float()[..., None]).reshape(N, -1)   # [N, K] f32
    return x.float() @ wdq.t()


def q4k_pos(x: torch.Tensor, w: QuantTensorA8S) -> torch.Tensor:
    """Kernel B: positive part x @ (code·scale) → [M, N] f32."""
    if x.device.type == "cpu":
        return q4k_pos_plain(x, w)
    M, K, N = _check_cuda_weight(x, w)
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    rc = kernels.lib("quant_matmul").q4k_dequant_mm_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), w.codes.data_ptr(),
        w.scales.data_ptr(), out.data_ptr(), M, K, N, kernels.stream_ptr(x.device))
    kernels.check(rc, "q4k_dequant_matmul")
    kernels.count("q4k_dequant_matmul")
    return out


def q4k_matmul(x: torch.Tensor, w: QuantTensorA8S) -> torch.Tensor:
    """x [M, K] @ packed W → [M, N] f32, exact dequant numerics. The affine
    min term Σ_g (Σ_{k∈g} x_k)·min_g is a small f32 product outside the
    kernel, as in the reference."""
    M, K = x.shape
    pos = q4k_pos(x, w)
    xg_sum = x.float().reshape(M, K // GROUP, GROUP).sum(dim=-1)
    return pos - xg_sum @ w.mins.float().t()


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def _quant_kernel_call(flat: torch.Tensor, w: QuantTensorA8S) -> torch.Tensor:
    if flat.shape[0] <= A8S_MAX_BATCH:
        return w4a8_matmul(flat, w)
    return q4k_matmul(flat, w)


def qmm(x: torch.Tensor, w: QuantTensorA8S) -> torch.Tensor:
    """x [..., K] @ W → [..., N] in x's dtype (f32 accumulation inside)."""
    lead = x.shape[:-1]
    flat = x.reshape(-1, x.shape[-1]).contiguous()
    out = _quant_kernel_call(flat, w)
    return out.reshape(*lead, -1).to(x.dtype)
