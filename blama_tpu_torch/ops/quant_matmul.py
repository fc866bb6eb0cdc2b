"""Packed GGUF weights, their matmul kernels' wrappers and the dispatch.

Counterpart of blama_tpu/ops/pallas/quant_matmul.py for the single-card
engines. Every layout keeps one output column's weights contiguous along K
(K = n_in, N = n_out; all arrays are [N, ...] row-major), so a warp streams a
column with 16-byte loads; none carries the reference's K-major transposition,
(j, j+128) row pairing or lane padding, which are TPU artefacts. `n_out` is
the arrays' own first dimension.

  QuantTensor      `q4k_fused`, exact: the reference's class of the same name
                   (its repack is repack_q4k_for_tpu, here repack_q4k_exact).
                     codes  uint8 [N, K/2]  group g of row n owns 16 bytes;
                            byte i = code[32g + i] | code[32g + 16 + i] << 4
                     scales f32 [N, K/32]   d·sc of each 32-group
                     mins   f32 [N, K/32]   dmin·mn
                   value[k, n] = code · scale − min, bitwise the host dequant
                   (gguf.quants.dequantize_q4_k takes the same f32 products).
  QuantTensorA8S   `q4k_a8`, W4A8: the same arrays with bf16 scales and mins
                   (5 bits/weight).
  QuantTensorK4    `q4k_fused_k4`, exact on 4.5 bits/weight: the GGUF tensor's
                   own bytes, uint8 [N, K/256 · 144], not repacked at all.
                   The file already stores each row's superblocks one after
                   another (144 bytes: f16 d, f16 dmin, 12 bytes of 6-bit
                   sc/mn, 128 code bytes; 144 = 9 · 16 keeps every block
                   16-byte aligned), which is the layout a column-streaming
                   warp wants; the kernels decode d·sc and dmin·mn as they go.
                   (The reference splits the block into codes/ddm/scmn arrays
                   because its kernels read K-major planes.)
  QuantTensorA8K4  `q4k_a8_k4`, W4A8 on the same bytes, f32 d·sc and dmin·mn
                   (not bf16-rounded: other numerics than `q4k_a8`).
  QuantTensorQ8    Q8_0 and Q6_K tensors under every fused engine, exact:
                     codes  int8 [N, K]          Q8_0 codes, or Q6_K's q − 32
                     scales f32  [N, K/group]    group 32: f32(d); group 16:
                                                 f32(d)·sc (Q6_K expanded)
                   value = code · scale, bitwise the host dequant.
  QuantTensorA8    `q4k_a8_xla`: int8 codes [N, K] (0..15), f16 scales/mins
                   [N, K/32]; plain PyTorch on every device, as the reference
                   leaves this engine to XLA.
  torch.Tensor     any other tensor type: dense bf16 [K, N] through matmul.
  LoraWrapped      any of these with runtime LoRA terms (runtime/lora.py on
                   the packed engines): the base product, then + (x·a)·b per
                   column segment (lora_term: two rows_mm products, f32).

`qmm` dispatches on the class and the number of flat rows as the reference's
_quant_kernel_call does. The kernels are CUDA C++
(ops/csrc/quant_matmul.cu): A (W4A8 GEMV, 1..16 rows, QuantTensorA8S; one
launch that quantizes x in the kernel, its group dots on int8 tensor cores,
columns planned by gemv_plan), I (the same on QuantTensorA8K4), and one
exact dequant GEMM with a weight loader each for B (Q4_K positive part, bf16
or f32 scales; the min term is a small product outside, as in the
reference), G (int8 codes, group 32 or 16) and H (native Q4_K, min term
inside): pipelined, warp-specialized f32 tiles of the shape tile_plan picks,
and at one row the same body at a one-row shape (one consumer warp of 32
chains; row_plan picks it), one f32 chain per output element at every row
count. MoE expert banks (QuantExperts, the stacked arrays of Ne
QuantTensors) go through J (kernel A over selected experts, one launch) and
K (B's loader with the min term inside, over selected experts). The
tp_blocks mode (qmm_blocked, qmm_nblocked) adds L (K's function per K-block,
or pinned at one block) and M (kernel A per K-block, one launch). The tools'
W4A8 variants, which no engine reaches, are Q (w4a8_swar_matmul: A's terms
summed per K-slab, the min term after it; in ops/csrc/slab_gemv.cu, its CTA
from slab_plan) and T (x2_matmul: I's terms in the same grouping), and
ubench_q4k's U (q4k_matmul_v1: an f32 two-dot, in ops/csrc/twodot.cu, its
CTA from twodot_plan) and V (w4a8_plane_matmul / w4a8_packed_matmul: Q's
body on two other code layouts). On a CPU tensor
each wrapper runs its plain PyTorch version below; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from . import kernels

GROUP = 32        # Q4_K sub-block size
QK_K = 256        # K-quant superblock
Q4K_BLOCK = 144   # bytes of one Q4_K superblock
# row count up to which the W4A8 kernels serve (reference A8S_MAX_BATCH)
A8S_MAX_BATCH = 16


class _Packed:
    """Shape protocol of the packed classes: x @ W semantics (n_in, n_out)."""

    @property
    def n_out(self) -> int:
        return self.codes.shape[0]

    @property
    def device(self):
        return self.codes.device


@dataclass
class QuantTensor(_Packed):
    """Packed Q4_K weight of the exact engine (f32 scales and mins)."""

    codes: torch.Tensor    # uint8 [N, K/2]
    scales: torch.Tensor   # f32   [N, K/32]
    mins: torch.Tensor     # f32   [N, K/32]

    @property
    def shape(self):
        return (self.codes.shape[1] * 2, self.codes.shape[0])


@dataclass
class QuantTensorA8S(QuantTensor):
    """The same arrays with bf16 scales and mins; marks dispatch to the W4A8
    kernel for up to 16 rows."""


@dataclass
class QuantTensorK4(_Packed):
    """Native-layout Q4_K weight: the GGUF bytes, one row per output column."""

    codes: torch.Tensor    # uint8 [N, K/256 * 144] superblocks as in the file

    @property
    def shape(self):
        return (self.codes.shape[1] // Q4K_BLOCK * QK_K, self.codes.shape[0])


@dataclass
class QuantTensorA8K4(QuantTensorK4):
    """The same bytes; marks dispatch to the W4A8 kernel for up to 16 rows."""


@dataclass
class QuantTensorQ8(_Packed):
    """int8-code weight: Q8_0 (group 32) or Q6_K expanded (group 16)."""

    codes: torch.Tensor    # int8 [N, K]
    scales: torch.Tensor   # f32  [N, K/group]
    group: int = 32

    @property
    def shape(self):
        return (self.codes.shape[1], self.codes.shape[0])


@dataclass
class QuantTensorA8(_Packed):
    """int8-code Q4_K weight of the plain-PyTorch W4A8 engine."""

    codes: torch.Tensor    # int8 [N, K], values 0..15
    scales: torch.Tensor   # f16  [N, K/32]
    mins: torch.Tensor     # f16  [N, K/32]

    @property
    def shape(self):
        return (self.codes.shape[1], self.codes.shape[0])


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

    @property
    def dtype(self):
        # the rows it gathers (emb_lookup) and the reference's class's dtype
        return torch.bfloat16


# ---------------------------------------------------------------------------
# runtime LoRA terms (runtime/lora.py attaches them on the packed engines)
# ---------------------------------------------------------------------------

@dataclass
class LoraSegment:
    """Output columns [off, off + n) of a LoraWrapped weight and the
    low-rank term they take: + (x·a)·b, a f32 [K, R], b f32 [R, n] with the
    adapters' effective scales folded in. Adapters on these columns stack
    along the rank axis; `tags` holds their (tag, rank) pieces in stacking
    order."""

    off: int
    a: torch.Tensor
    b: torch.Tensor
    tags: tuple = ()


@dataclass
class LoraWrapped:
    """A weight with runtime LoRA terms, the reference's LoraWrapped
    (blama_tpu/ops/pallas/quant_matmul.py:385): y = qmm(x, base) + (x_f32·a)·b,
    cast back to the base product's dtype, the base never touched. The
    reference pads b into a fused tensor's (wqkv, wgu) column segments;
    here each segment keeps its own a and b (`segments`, ordered by column),
    so a fused layout computes each part's term at the unfused shapes and
    keeps the unfused bits."""

    base: object          # a packed class or a dense [K, N] tensor
    segments: tuple       # LoraSegment, by column

    @property
    def shape(self):
        return self.base.shape

    @property
    def n_out(self) -> int:
        return self.base.shape[1]

    @property
    def device(self):
        return self.base.device


def lora_term(flat: torch.Tensor, seg: LoraSegment) -> torch.Tensor:
    """(x_f32·a)·b of rows flat [M, K] → [M, n] f32: two rows_mm products,
    f32 and never TF32, each row's bits its own (a decode row and the same
    row in a replay chunk sum the rank axis in one order). A library
    product, as in the reference, which computes it outside any kernel."""
    return rows_mm(rows_mm(flat.float(), seg.a), seg.b)


def _with_lora(out: torch.Tensor, flat: torch.Tensor, w: LoraWrapped,
               out_dtype=None) -> torch.Tensor:
    """out [M, N] (the base product in its dtype) with each segment's term
    added in f32 and the sum cast to out_dtype (default out's), in the
    reference's order; columns outside the segments pass as they are."""
    out_dtype = out_dtype or out.dtype
    parts, at = [], 0
    for s in w.segments:
        n = s.b.shape[1]
        if s.off > at:
            parts.append(out[:, at:s.off].to(out_dtype))
        parts.append((out[:, s.off:s.off + n].float() + lora_term(flat, s)).to(out_dtype))
        at = s.off + n
    if at < out.shape[1]:
        parts.append(out[:, at:].to(out_dtype))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


# ---------------------------------------------------------------------------
# repacks from GGUF bytes (run on the target device, one tensor at a time)
# ---------------------------------------------------------------------------

def _blocks_on(data, block_bytes: int, device) -> torch.Tensor:
    """GGUF tensor bytes → uint8 [n_blocks, block_bytes] on `device`."""
    device = kernels.resolve_device(device)
    raw = torch.from_numpy(np.array(data, dtype=np.uint8, copy=True))
    return raw.to(device).view(-1, block_bytes)


def _f16_col(blk: torch.Tensor, a: int) -> torch.Tensor:
    """The f16 scalar at byte column `a` of every block → f32 [nb, 1] (exact)."""
    return blk[:, a:a + 2].contiguous().view(torch.float16).float()


def _unpack_scale_min_k4(q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """12-byte Q4_K scale block [n, 12] → (sc, mn) int32 [n, 8]."""
    q = q.to(torch.int32)
    sc_lo = q[:, 0:4] & 63
    mn_lo = q[:, 4:8] & 63
    sc_hi = (q[:, 8:12] & 0xF) | ((q[:, 0:4] >> 6) << 4)
    mn_hi = (q[:, 8:12] >> 4) | ((q[:, 4:8] >> 6) << 4)
    return torch.cat([sc_lo, sc_hi], dim=1), torch.cat([mn_lo, mn_hi], dim=1)


def decode_q4k_blocks(blk: torch.Tensor, n_rows: int):
    """Q4_K superblocks uint8 [nb, 144] → (codes u8 [N, K] in element order,
    scales f32 [N, K/32], mins f32 [N, K/32]). Same bit walk and the same f32
    products as the reference's host unpack (unpack_q4k_arrays)."""
    nb = blk.shape[0]
    sc, mn = _unpack_scale_min_k4(blk[:, 4:16])
    qs = blk[:, 16:].reshape(nb, 4, 32)
    # chunk c: low nibbles are elements 64c..64c+31, high nibbles 64c+32..
    codes = torch.stack([qs & 0x0F, qs >> 4], dim=2).reshape(n_rows, -1)
    scales = (_f16_col(blk, 0) * sc.float()).reshape(n_rows, -1)
    mins = (_f16_col(blk, 2) * mn.float()).reshape(n_rows, -1)
    return codes, scales, mins


def unpack_q4k(data, n_rows: int, row_len: int, device="cuda"):
    """GGUF Q4_K bytes → decode_q4k_blocks' arrays on `device`."""
    return decode_q4k_blocks(_blocks_on(data, Q4K_BLOCK, device), n_rows)


def _pack_q4k(cls, dtype, codes, scales, mins):
    N, K = codes.shape
    c = codes.reshape(N, K // GROUP, GROUP)
    packed = (c[..., :16] | (c[..., 16:] << 4)).reshape(N, K // 2)
    return cls(packed.contiguous(), scales.to(dtype).contiguous(),
               mins.to(dtype).contiguous())


def pack_a8s(codes: torch.Tensor, scales: torch.Tensor,
             mins: torch.Tensor) -> QuantTensorA8S:
    """Element-order codes u8 [N, K] + f32 scales/mins [N, K/32] → the
    kernel layout with bf16 scales/mins."""
    return _pack_q4k(QuantTensorA8S, torch.bfloat16, codes, scales, mins)


def pack_exact(codes: torch.Tensor, scales: torch.Tensor,
               mins: torch.Tensor) -> QuantTensor:
    """The same codes with the f32 scales/mins kept as they are."""
    return _pack_q4k(QuantTensor, torch.float32, codes, scales, mins)


def repack_q4k_a8s(data, n_rows: int, row_len: int, device="cuda") -> QuantTensorA8S:
    """GGUF Q4_K tensor bytes → QuantTensorA8S on `device`."""
    return pack_a8s(*unpack_q4k(data, n_rows, row_len, device))


def repack_q4k_exact(data, n_rows: int, row_len: int, device="cuda") -> QuantTensor:
    """GGUF Q4_K tensor bytes → QuantTensor (f32 scales) on `device`."""
    return pack_exact(*unpack_q4k(data, n_rows, row_len, device))


def repack_q4k_native(data, n_rows: int, row_len: int, device="cuda") -> QuantTensorK4:
    """GGUF Q4_K tensor bytes → QuantTensorK4: an upload, nothing else."""
    return QuantTensorK4(_blocks_on(data, Q4K_BLOCK, device).view(n_rows, -1))


def repack_q4k_a8k4(data, n_rows: int, row_len: int, device="cuda") -> QuantTensorA8K4:
    return QuantTensorA8K4(repack_q4k_native(data, n_rows, row_len, device).codes)


def repack_q4k_w4a8(data, n_rows: int, row_len: int, device="cuda") -> QuantTensorA8:
    """GGUF Q4_K tensor bytes → QuantTensorA8 (int8 codes, f16 scales/mins)."""
    codes, scales, mins = unpack_q4k(data, n_rows, row_len, device)
    return QuantTensorA8(codes.to(torch.int8).contiguous(),
                         scales.to(torch.float16).contiguous(),
                         mins.to(torch.float16).contiguous())


def repack_q8_0(data, n_rows: int, row_len: int, device="cuda") -> QuantTensorQ8:
    """GGUF Q8_0 tensor bytes (34-byte blocks: f16 d, 32 int8 codes) →
    QuantTensorQ8 with group 32."""
    blk = _blocks_on(data, 34, device)
    codes = blk[:, 2:].contiguous().view(torch.int8).reshape(n_rows, row_len)
    return QuantTensorQ8(codes, _f16_col(blk, 0).reshape(n_rows, -1).contiguous(), 32)


def repack_q6_k_expanded(data, n_rows: int, row_len: int, device="cuda") -> QuantTensorQ8:
    """GGUF Q6_K tensor bytes (210-byte superblocks: 128 B ql, 64 B qh, 16
    int8 scales, f16 d) → QuantTensorQ8 with group 16: the 6-bit codes widened
    to int8 (q − 32) and the two-level scale f32(d)·sc multiplied out in f32,
    the association gguf.quants.dequantize_q6_k uses."""
    blk = _blocks_on(data, 210, device)
    nb = blk.shape[0]
    ql = blk[:, 0:128].reshape(nb, 2, 2, 32)     # [half, lql | lql2, 32]
    qh = blk[:, 128:192].reshape(nb, 2, 1, 32)
    lo, hi = ql & 0xF, ql >> 4
    # element 128h + 32s + i of a superblock, s = 0..3: (lql, lql2) low
    # nibbles then high nibbles, with bit pair s of qh on top
    q = torch.cat([lo[:, :, 0:1] | ((qh & 3) << 4),
                   lo[:, :, 1:2] | (((qh >> 2) & 3) << 4),
                   hi[:, :, 0:1] | (((qh >> 4) & 3) << 4),
                   hi[:, :, 1:2] | ((qh >> 6) << 4)], dim=2)        # [nb, 2, 4, 32]
    codes = (q.reshape(n_rows, row_len).to(torch.int16) - 32).to(torch.int8)
    sc = blk[:, 192:208].contiguous().view(torch.int8).float()       # [nb, 16]
    scales = (_f16_col(blk, 208) * sc).reshape(n_rows, -1)
    return QuantTensorQ8(codes.contiguous(), scales.contiguous(), 16)


def repack_q4k_embedding(data, n_rows: int, row_len: int, device="cuda") -> QuantEmbedding:
    """GGUF Q4_K token_embd bytes → row-major QuantEmbedding on `device`."""
    codes, scales, mins = unpack_q4k(data, n_rows, row_len, device)
    half = row_len // 2
    packed = codes[:, :half] | (codes[:, half:] << 4)
    return QuantEmbedding(packed.contiguous(), scales.contiguous(), mins.contiguous())


def reference_lane_width(N: int) -> int:
    """The width the reference pads a packed tensor of N output columns to:
    a multiple of 256, then (past 4096) a multiple of 4096 or 2048 where
    that wastes at most 5% (its _widen_target). The port pads nothing; it
    reads this only to fuse where the reference fuses (fusable)."""
    N = -(-N // 256) * 256
    if N <= 4096:
        return N
    for t in (4096, 2048):
        if N % t == 0:
            return N
        wide = -(-N // t) * t
        if (wide - N) / N <= 0.05:
            return wide
    return N


def fusable(ws: list) -> bool:
    """Whether packed weights fuse into one wide product (the reference's
    load_llama_params `_fusable`): all of one packed class, none padded in
    the reference's layout (reference_lane_width), and Q8 parts of one scale
    group (the reference asserts that; a mix stays apart here)."""
    cls = type(ws[0])
    return (all(type(w) is cls for w in ws)
            and isinstance(ws[0], (QuantTensor, QuantTensorA8, QuantTensorK4, QuantTensorQ8))
            and all(reference_lane_width(w.n_out) == w.n_out for w in ws)
            and len({getattr(w, "group", None) for w in ws}) == 1)


def concat_quant(ws: list):
    """Packed weights of one class concatenated along the output columns,
    the reference's concat_quant (BLAMA_FUSE_PROJ / BLAMA_FUSE_KV): every
    layout here is [N, ...] with a column's weights its own row, so the
    result is each array's rows one part after another, and a Q8 tensor
    keeps its scale group. Every kernel sums each column alone, so a column
    of the wide product has the bits of the same column of its part."""
    cls = type(ws[0])
    if not fusable(ws):
        raise ValueError(f"cannot fuse {[type(w).__name__ for w in ws]}")
    out = {f.name: torch.cat([getattr(w, f.name) for w in ws]).contiguous()
           for f in fields(cls) if f.name != "group"}
    if cls is QuantTensorQ8:
        out["group"] = ws[0].group
    return cls(**out)


def unpair_codes(codes: torch.Tensor) -> torch.Tensor:
    """QuantTensor codes [N, K/2] → element-order codes u8 [N, K]."""
    N = codes.shape[0]
    c = codes.reshape(N, -1, 16)
    return torch.cat([c & 0x0F, c >> 4], dim=-1).reshape(N, -1)


def dequantize(w) -> torch.Tensor:
    """The f32 values [N, K] a packed weight stands for (tests and the smoke
    run's yardsticks; no engine calls it)."""
    if isinstance(w, QuantTensorK4):
        codes, scales, mins = decode_q4k_blocks(w.codes.view(-1, Q4K_BLOCK), w.n_out)
    elif isinstance(w, QuantTensorQ8):
        return (w.codes.float().reshape(w.n_out, -1, w.group)
                * w.scales[..., None]).reshape(w.n_out, -1)
    elif isinstance(w, QuantTensorA8):
        codes, scales, mins = w.codes, w.scales.float(), w.mins.float()
    else:
        codes, scales, mins = unpair_codes(w.codes), w.scales.float(), w.mins.float()
    q = codes.float().reshape(w.n_out, -1, GROUP)
    return (q * scales[..., None] - mins[..., None]).reshape(w.n_out, -1)


def emb_lookup(emb, tokens: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Embedding row gather; a QuantEmbedding is dequantized on the fly, a
    dense table is gathered as it is."""
    if not isinstance(emb, QuantEmbedding):
        return emb[tokens]
    ci = emb.codes[tokens].to(torch.int32)               # [..., E/2]
    q = torch.cat([ci & 0xF, (ci >> 4) & 0xF], dim=-1).float()
    s = emb.scales[tokens]                                # [..., E/32]
    m = emb.mins[tokens]
    lead = q.shape[:-1]
    qg = q.reshape(*lead, -1, GROUP)
    vals = qg * s[..., None] - m[..., None]
    return vals.reshape(*lead, -1).to(dtype)


# ---------------------------------------------------------------------------
# launch plumbing
# ---------------------------------------------------------------------------

def _check_cuda(x: torch.Tensor, arrays, k_multiple: int = GROUP) -> tuple[int, int]:
    """Raise on what the kernels do not take; `arrays` is ((tensor, dtype,
    shape), ...) of the weight's arrays. Returns (M, K)."""
    M, K = x.shape
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"activations must be bf16 or f32, got {x.dtype}")
    if K % k_multiple:
        raise ValueError(f"K={K} is not a multiple of {k_multiple}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("activations must be contiguous and 16-byte aligned")
    if arrays[0][0].data_ptr() % 16:
        raise ValueError("weight codes must be 16-byte aligned")
    for t, dt, shape in arrays:
        if tuple(t.shape) != shape:
            raise ValueError(f"x {tuple(x.shape)} does not match weight array "
                             f"{tuple(t.shape)} (expected {shape})")
        if t.device != x.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError("weight arrays must be contiguous on x's device")
    return M, K


def _q4k_arrays(w: QuantTensor, K: int, scale_dtype):
    N, G = w.n_out, K // GROUP
    return ((w.codes, torch.uint8, (N, K // 2)), (w.scales, scale_dtype, (N, G)),
            (w.mins, scale_dtype, (N, G)))


def _k4_arrays(w: QuantTensorK4, K: int):
    return ((w.codes, torch.uint8, (w.n_out, K // QK_K * Q4K_BLOCK)),)


def _is_bf16(x: torch.Tensor) -> int:
    return int(x.dtype == torch.bfloat16)


def _w4a8_buffers(M: int, K: int, N: int, dev):
    xq = torch.empty((M, K), dtype=torch.int8, device=dev)
    xs = torch.empty((M, K // GROUP), dtype=torch.float32, device=dev)
    return xq, xs, torch.empty_like(xs), torch.empty((M, N), dtype=torch.float32, device=dev)


def _act_buffers(rows: int, K: int, dev, codes: bool):
    """The W4A8 GEMV's optional outputs of x's quantization (xq, xs, sxm),
    and the pointers it takes (0: not written)."""
    if not codes:
        return (None, None, None), (0, 0, 0)
    bufs = _w4a8_buffers(rows, K, 0, dev)[:3]
    return bufs, tuple(t.data_ptr() for t in bufs)


def _check_aligned(*arrays) -> None:
    """The W4A8 GEMV stages scales and mins with 16-byte copies."""
    if any(t.data_ptr() % 16 for t in arrays):
        raise ValueError("weight scales and mins must be 16-byte aligned")


def _check_rows(M: int, what: str) -> None:
    if not 1 <= M <= A8S_MAX_BATCH:
        raise ValueError(f"{what} takes 1..{A8S_MAX_BATCH} rows, got {M}")


# ---------------------------------------------------------------------------
# kernels A and I: W4A8 for 1..16 rows
# ---------------------------------------------------------------------------

def quant_acts(x: torch.Tensor):
    """[M, K] float → (xq int8 [M, K], xs f32 [M, K/32], sxm f32 [M, K/32]):
    per-32-group scale amax/127, codes round(x·(1/scale)), and
    scale·Σcodes (the min-term weight). Plain version of the W4A8 kernels'
    prologue."""
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


def _w4a8_plain(x: torch.Tensor, codes: torch.Tensor, ws: torch.Tensor,
                wm: torch.Tensor) -> torch.Tensor:
    """Σ_g dot_g·ws_g·xs_g − sxm_g·wm_g over element-order codes [N, K] and
    f32 group scales/mins [N, K/32]: the W4A8 kernels' sum, group by group."""
    xq, xs, sxm = quant_acts(x)
    M, K = xq.shape
    G = K // GROUP
    # int8 x 4-bit dots of one group stay below 2^24: exact in f32
    dots = torch.einsum("mgi,ngi->mng", xq.reshape(M, G, GROUP).float(),
                        codes.reshape(-1, G, GROUP).float())
    terms = dots * ws[None] * xs[:, None, :] - sxm[:, None, :] * wm[None]
    return terms.sum(dim=-1)


def w4a8_matmul_plain(x: torch.Tensor, w: QuantTensorA8S) -> torch.Tensor:
    """Plain version of kernel A: x [M, K] → [M, N] f32."""
    return _w4a8_plain(x, unpair_codes(w.codes), w.scales.float(), w.mins.float())


# The W4A8 GEMV's column plan (kernels A, I, J, M). A CTA owns tiles of 64 /
# rw columns of one matrix (the weight, a K-block or a selected expert); its
# 8 warps split a tile's columns 8 apiece and the sum's 32 residues rw ways.
# rw and the grid move no bit: every output keeps its one sum order.
GEMV_SPLITS = (1, 2, 4, 8)
# per-tile cost beyond its columns (the epilogue, the residue tree), in
# columns, and how many times its share of the card's bytes one SM streams
GEMV_TILE_OVERHEAD = 8
GEMV_SM_RATE = 2.0


def gemv_tiles(rw: int, N: int, n_mat: int = 1) -> int:
    """Tiles of 64 / rw columns for n_mat matrices of N columns."""
    return -(-N // (64 // rw)) * n_mat


def gemv_cost(rw: int, N: int, n_mat: int = 1) -> float:
    """The plan's estimate, in columns an SM streams: the card's bytes
    spread over every SM, or the busiest SM's tiles (one CTA an SM walks
    ceil(tiles / N_SMS) of them) at GEMV_SM_RATE times its share."""
    busiest = -(-gemv_tiles(rw, N, n_mat) // N_SMS) * (64 // rw + GEMV_TILE_OVERHEAD)
    return max(N * n_mat / N_SMS, busiest / GEMV_SM_RATE)


def gemv_plan(N: int, n_mat: int = 1, rw: int | None = None) -> tuple[int, int]:
    """(rw, grid) for n_mat matrices of N columns: the cheapest split by
    gemv_cost (the fewest residue splits among equals), and one CTA an SM at
    most, each walking its tiles. `rw` forces a split (tests: any split gives
    the same bits)."""
    if rw is None:
        rw = min(GEMV_SPLITS, key=lambda r: (gemv_cost(r, N, n_mat), r))
    elif rw not in GEMV_SPLITS:
        raise ValueError(f"rw must be one of {GEMV_SPLITS}, got {rw}")
    return rw, min(gemv_tiles(rw, N, n_mat), N_SMS)


def _gemv_launch(fn: str, name: str, x: torch.Tensor, weights, out: torch.Tensor,
                 rows: int, N: int, n_mat: int, codes: bool, rw: int | None):
    """One launch of the W4A8 GEMV: `weights` are the arguments between x's
    and the activation buffers (weight arrays, a K-block count, expert ids);
    `rows` x's rows in all. Returns (xq, xs, sxm) when `codes`, else
    Nones."""
    M, K = x.shape[-2], x.shape[-1]
    bufs, ptrs = _act_buffers(rows, K, x.device, codes)
    rw, grid = gemv_plan(N, n_mat, rw)
    rc = getattr(kernels.lib("quant_matmul"), fn)(
        x.data_ptr(), _is_bf16(x), *weights, *ptrs, out.data_ptr(), M, K, N, rw, grid,
        kernels.stream_ptr(x.device))
    kernels.check(rc, name)
    kernels.count(name)
    return bufs


def w4a8_launch(x: torch.Tensor, w: QuantTensorA8S, codes: bool = True,
                rw: int | None = None):
    """Launch kernel A on CUDA tensors (K % 256 == 0). Returns (out [M, N]
    f32, and x's codes xq, scales xs and scale·sum sxm, written by the
    kernel when `codes`, so a check can compare them; else Nones). `rw`
    forces a column split (tests)."""
    M, K = _check_cuda(x, _q4k_arrays(w, x.shape[1], torch.bfloat16), QK_K)
    _check_rows(M, "kernel A")
    _check_aligned(w.scales, w.mins)
    out = torch.empty((M, w.n_out), dtype=torch.float32, device=x.device)
    bufs = _gemv_launch("w4a8_matmul_launch", "w4a8_gemv", x,
                        (w.codes.data_ptr(), w.scales.data_ptr(), w.mins.data_ptr(), 1),
                        out, M, w.n_out, 1, codes, rw)
    return (out, *bufs)


def w4a8_matmul(x: torch.Tensor, w: QuantTensorA8S) -> torch.Tensor:
    """Kernel A (CUDA C++, replaces the TPU kernels _a8s_xin_kernel and
    _a8s_pinned_kernel): x [M <= 16, K] @ W → [M, N] f32, one launch that
    quantizes x in the kernel."""
    if x.device.type == "cpu":
        return w4a8_matmul_plain(x, w)
    return w4a8_launch(x, w, codes=False)[0]


def a8k4_matmul_plain(x: torch.Tensor, w: QuantTensorA8K4) -> torch.Tensor:
    """Plain version of kernel I: kernel A's sum with the f32 d·sc and
    dmin·mn decoded from the native superblocks."""
    return _w4a8_plain(x, *decode_q4k_blocks(w.codes.view(-1, Q4K_BLOCK), w.n_out))


def a8k4_launch(x: torch.Tensor, w: QuantTensorA8K4, codes: bool = True,
                rw: int | None = None):
    """Launch kernel I on CUDA tensors; returns (out, xq, xs, sxm) as
    w4a8_launch does."""
    M, K = _check_cuda(x, _k4_arrays(w, x.shape[1]), QK_K)
    _check_rows(M, "kernel I")
    out = torch.empty((M, w.n_out), dtype=torch.float32, device=x.device)
    bufs = _gemv_launch("w4a8k4_matmul_launch", "w4a8k4_gemv", x, (w.codes.data_ptr(),),
                        out, M, w.n_out, 1, codes, rw)
    return (out, *bufs)


def a8k4_matmul(x: torch.Tensor, w: QuantTensorA8K4) -> torch.Tensor:
    """Kernel I (CUDA C++, replaces the TPU kernel _a8k4_kernel):
    x [M <= 16, K] @ native-layout W → [M, N] f32 (W4A8), one launch."""
    if x.device.type == "cpu":
        return a8k4_matmul_plain(x, w)
    return a8k4_launch(x, w, codes=False)[0]


def w4a8_xla_matmul(x: torch.Tensor, w: QuantTensorA8) -> torch.Tensor:
    """The `q4k_a8_xla` matmul, plain PyTorch on every device (the reference's
    w4a8_matmul is plain XLA): exact int group dots, then the positive and
    the min sums taken apart, pos − neg. Materializes [M, N, K/32] floats, so
    it serves small models only."""
    xq, xs, sxm = quant_acts(x)
    M, K = xq.shape
    G = K // GROUP
    dots = torch.einsum("mgi,ngi->mng", xq.reshape(M, G, GROUP).float(),
                        w.codes.reshape(-1, G, GROUP).float())
    pos = (dots * xs[:, None, :] * w.scales.float()[None]).sum(dim=-1)
    return pos - sxm @ w.mins.float().t()


# ---------------------------------------------------------------------------
# kernels Q and T: the tools' W4A8 variants, summed per K-slab
# ---------------------------------------------------------------------------
#
# The reference's _a8s_kernel (w4a8_swar_matmul) and tools/ab_a8k4.py's
# _x2_kernel (x2_matmul) take kernel A's and I's group terms in another
# grouping: the K axis in slabs of kb superblocks, each slab's sum the sum of
# its low-nibble group terms (groups 0-3 of each superblock, in superblock
# order) plus the sum of its high-nibble ones (groups 4-7), the slabs added in
# K order. So kb is a parameter of their numerics; block_n, the reference's
# column tile, moves no bit: it only passes the reference's clamp, and both
# kernels' CTAs (slab_gemv.cu) come from slab_plan. No engine reaches
# either: the tools do.

def _col_tile(what: str, K: int, N: int, block_n: int, kb: int) -> int:
    """The column tile both references clamp alike: block_n halved until it
    divides N."""
    if K % QK_K or kb < 1 or block_n < 1:
        raise ValueError(f"kernel {what} takes K % {QK_K} == 0, kb >= 1, block_n >= 1; "
                         f"got K={K}, kb={kb}, block_n={block_n}")
    bn = min(block_n, N)
    while N % bn:
        bn //= 2
    return bn


# the tools' block_n unless the caller says otherwise (the reference's 2048
# is a TPU VMEM tile); kernels Q, T, U and V only pass it through the
# reference's clamp
SLAB_BLOCK_N = 8

# kernels Q, V and T's CTA (slab_gemv.cu): T tiles of 16 columns, R consumer
# warps a tile (T·R <= SG_MAX_WARPS), beside one producer thread that keeps
# a ring of D slots full; a slot is one superblock of K (8 groups): x's
# codes and scales (T: and sxm), the CTA's codes and scales (T: its native
# superblocks, header and codes)
SG_MAX_WARPS = 8
SG_MAX_SLOTS = 32
SG_WAVE = 128        # column groups that make up (most of) a wave of 132 SMs
SG_INFLIGHT = 64 << 10   # bytes a CTA's ring aims to keep in flight


def slab_slot_bytes(M: int, cols: int, int8: bool = False, x2: bool = False) -> int:
    """Bytes of one slot of Q's, V's (int8: V's int8 codes) or T's (x2)
    ring (slab_gemv.cu sg_slot_bytes, which slab_slot_size gives): x's
    codes (8 rows at M <= 8, else 16; two 128-byte halves), the cols
    columns' codes (128 bytes each, 256 as int8), x's scales (8 f32 a row;
    T: and as many of x's sxm) and the columns' scales (8 bf16 each; T: the
    16-byte headers of its 144-byte superblocks), on 1024 bytes; at one row
    no x (the CTA holds x's row whole)."""
    xr = 0 if M == 1 else 8 if M <= 8 else 16
    tx = 256 * xr + (256 if int8 else 128) * cols + (2 if x2 else 1) * 32 * xr + 16 * cols
    return -(-tx // 1024) * 1024


def _slab_outs(M: int) -> int:
    """Outputs a lane of Q, V or T holds (slab_gemv.cu Outs::NO)."""
    return 2 if M == 1 else 4 if M <= 8 else 8


def slab_smem(M: int, plan: tuple[int, int, int], int8: bool = False, K: int = 0,
              x2: bool = False) -> int:
    """Dynamic shared memory of kernel Q, V or T (x2) under plan (T, R, D)
    (slab_gemv.cu sg_smem_bytes, which slab_smem_size gives): 1024 bytes to
    align the ring, the ring, its 2·D barriers, where R > 1 the partial sums
    a tile's warps hand each other (two buffers), and at one row x's row
    quantized (K codes and K/32 f32 scales; T: and K/32 sxm)."""
    t, r, d = plan
    xch = 512 * t * r * _slab_outs(M) if r > 1 else 0
    row = K + (8 if x2 else 4) * (K // GROUP) if M == 1 else 0
    return 1024 + d * slab_slot_bytes(M, 16 * t, int8, x2) + 16 * d + xch + row


def x2_step_slots(kb: int) -> int:
    """Slots one step of kernel T's takes at most (slab_gemv.cu
    x2_step_slots): where kb <= 8 two emulated lanes of one superblock each,
    else one lane's chain of ceil(kb / 8)."""
    return 2 if kb <= 8 else -(-kb // 8)


def slab_plan(M: int, N: int, kb: int, int8: bool = False, K: int = 0,
              x2: bool = False) -> tuple[int, int, int]:
    """Kernel Q's, V's or T's (x2) plan (T tiles of 16 columns a CTA, R
    warps a tile, D ring slots) for M rows, N columns and slabs of kb
    superblocks (int8: V's int8 codes, twice the bytes a slot; K: x's
    width, which one row keeps whole in shared memory). T: the most tiles
    (up to 8) that still leave SG_WAVE column groups, so the groups fill a
    wave of CTAs, one an SM; R: the warps left (8 // T), which take a
    tile's superblocks in turn, so a narrow N (wk/wv's 64 tiles) or a long
    K (down's 56 superblocks on 2 tiles an SM) still keeps 8 warps an SM
    busy. D: enough slots for SG_INFLIGHT bytes, at least 4 and a round of
    the tile's warps (R steps: two slots each, kernel T's x2_step_slots),
    within one CTA's shared memory and SG_MAX_SLOTS; R shrinks until a
    round fits (T's long chains). A deeper ring was slower on the card (PERF.md §6):
    with every slot of every CTA requested at once, a CTA's first slots
    arrive later. Each output keeps the parent's lane order whatever the
    plan, so the plan moves no bit."""
    if not x2 and not 1 <= kb <= 8:
        raise ValueError(f"kernels Q and V take slabs of 1..8 superblocks, got kb={kb}")
    if x2 and kb < 1:
        raise ValueError(f"kernel T takes slabs of kb >= 1 superblocks, got kb={kb}")
    t = min(SG_MAX_WARPS, max(1, -(-N // 16) // SG_WAVE))
    r = SG_MAX_WARPS // t
    step = x2_step_slots(kb) if x2 else 2
    slot = slab_slot_bytes(M, 16 * t, int8, x2)

    def fit(r):
        room = (SMEM_MAX - slab_smem(M, (t, r, 0), int8, K, x2)) // (slot + 16)
        return min(SG_MAX_SLOTS, room)

    while r > 1 and fit(r) < r * step:
        r -= 1
    return t, r, min(fit(r), max(step * r, 4, -(-SG_INFLIGHT // slot)))


def a8s_clamp(K: int, N: int, block_n: int, kb: int) -> tuple[int, int]:
    """The reference's clamping of w4a8_swar_matmul's tiles (_a8s_pos): the
    column tile halves until it divides N, kb until its slab divides K."""
    bn = _col_tile("Q", K, N, block_n, kb)
    while K % (kb * QK_K):
        kb //= 2
    return bn, kb


def x2_clamp(K: int, N: int, block_n: int, kb: int) -> tuple[int, int]:
    """tools/ab_a8k4.py x2_matmul's clamping: kb at most the superblock
    count, halved until it divides it, and the whole K as one slab when the
    result is not a multiple of 8."""
    bn = _col_tile("T", K, N, block_n, kb)
    nsb = K // QK_K
    kb = min(kb, nsb)
    while kb > 1 and nsb % kb:
        kb //= 2
    if kb % 8 and kb != nsb:
        kb = nsb
    return bn, kb


def _seq_sum(a: torch.Tensor) -> torch.Tensor:
    """Σ over the last axis, left to right."""
    s = a[..., 0]
    for i in range(1, a.shape[-1]):
        s = s + a[..., i]
    return s


def slab_sums(terms: torch.Tensor, kb: int) -> torch.Tensor:
    """Group terms [M, N, K/32] in K order → [M, N]: per slab of kb
    superblocks Σ lo + Σ hi (groups 0-3 and 4-7 of each superblock, each sum
    left to right in superblock order), the slabs added in K order."""
    M, N, G = terms.shape
    t = terms.reshape(M, N, G // (8 * kb), kb, 8)
    lo = t[..., :4].reshape(M, N, -1, 4 * kb)
    hi = t[..., 4:].reshape(M, N, -1, 4 * kb)
    return _seq_sum(_seq_sum(lo) + _seq_sum(hi))


def _group_dots(xq: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """int8 codes [M, K] · element-order 4-bit codes [N, K] per 32-group →
    [M, N, K/32] f32 (each dot below 2^24: exact)."""
    M, K = xq.shape
    G = K // GROUP
    return torch.einsum("mgi,ngi->mng", xq.reshape(M, G, GROUP).float(),
                        codes.reshape(-1, G, GROUP).float())


def a8s_pos_plain(x: torch.Tensor, w: QuantTensorA8S, kb: int = 4) -> torch.Tensor:
    """Plain version of kernel Q: the positive part Σ dot·(d·sc)·xscale in
    slab grouping → [M, N] f32 (kb as the kernel clamps it)."""
    kb = a8s_clamp(x.shape[1], w.n_out, 1, kb)[1]
    xq, xs, _ = quant_acts(x)
    terms = _group_dots(xq, unpair_codes(w.codes)) * w.scales.float()[None] * xs[:, None, :]
    return slab_sums(terms, kb)


def _a8s_min(w: QuantTensorA8S, sxm: torch.Tensor) -> torch.Tensor:
    """The min correction (xscale·Σcodes) @ mins, an f32 product outside the
    kernel as in the reference."""
    return sxm @ w.mins.float().t()


def w4a8_swar_matmul_plain(x: torch.Tensor, w: QuantTensorA8S,
                           block_n: int = SLAB_BLOCK_N, kb: int = 4) -> torch.Tensor:
    """Plain version of w4a8_swar_matmul (block_n does not enter it)."""
    return a8s_pos_plain(x, w, kb) - _a8s_min(w, quant_acts(x)[2])


def a8s_launch(x: torch.Tensor, w: QuantTensorA8S, block_n: int = SLAB_BLOCK_N,
               kb: int = 4):
    """Launch kernel Q on CUDA tensors. Returns (pos [M, N] f32, and the
    prologue's xq, xs, sxm, as w4a8_launch does). block_n is the
    reference's column tile, checked as the reference clamps it; the CTA
    comes from slab_plan."""
    M, K = _check_cuda(x, _q4k_arrays(w, x.shape[1], torch.bfloat16), QK_K)
    _check_rows(M, "kernel Q")
    _check_aligned(w.scales)
    kb = a8s_clamp(K, w.n_out, block_n, kb)[1]
    if kb > 8:
        raise ValueError(f"kernel Q takes slabs of at most 8 superblocks, got kb={kb}")
    nt, nr, nd = slab_plan(M, w.n_out, kb, K=K)
    xq, xs, sxm, out = _w4a8_buffers(M, K, w.n_out, x.device)
    rc = kernels.lib("slab_gemv").w4a8_slab_launch(
        x.data_ptr(), _is_bf16(x), w.codes.data_ptr(), w.scales.data_ptr(), nt, nr, nd, kb,
        xq.data_ptr(), xs.data_ptr(), sxm.data_ptr(), out.data_ptr(), M, K, w.n_out,
        kernels.stream_ptr(x.device))
    kernels.check(rc, "w4a8_slab_gemv")
    kernels.count("w4a8_slab_gemv")
    return out, xq, xs, sxm


def w4a8_swar_matmul(x: torch.Tensor, w: QuantTensorA8S, block_n: int = SLAB_BLOCK_N,
                     kb: int = 4) -> torch.Tensor:
    """Kernel Q (CUDA C++, replaces the TPU kernel _a8s_kernel): x [M <= 16,
    K] @ W → [M, N] f32, W4A8 summed per slab of kb superblocks, the min
    term an f32 product after the kernel. block_n is the reference's column
    tile (2048 by default there: a TPU VMEM tile); here it only passes the
    reference's clamp and moves no bit."""
    if x.device.type == "cpu":
        return w4a8_swar_matmul_plain(x, w, block_n, kb)
    pos, _, _, sxm = a8s_launch(x, w, block_n, kb)
    return pos - _a8s_min(w, sxm)


def x2_matmul_plain(x: torch.Tensor, w: QuantTensorA8K4, block_n: int = SLAB_BLOCK_N,
                    kb: int = 8) -> torch.Tensor:
    """Plain version of kernel T: kernel I's group terms dot·(d·sc)·xscale −
    (xscale·Σcodes)·(dmin·mn) in slab grouping → [M, N] f32."""
    K = x.shape[1]
    kb = x2_clamp(K, w.n_out, block_n, kb)[1]
    codes, ws, wm = decode_q4k_blocks(w.codes.view(-1, Q4K_BLOCK), w.n_out)
    xq, xs, sxm = quant_acts(x)
    terms = _group_dots(xq, codes) * ws[None] * xs[:, None, :] - sxm[:, None, :] * wm[None]
    return slab_sums(terms, kb)


def x2_launch(x: torch.Tensor, w: QuantTensorA8K4, block_n: int = SLAB_BLOCK_N,
              kb: int = 8):
    """Launch kernel T on CUDA tensors; returns (out, xq, xs, sxm). block_n
    is the reference's column tile, checked as the reference clamps it; the
    CTA comes from slab_plan."""
    M, K = _check_cuda(x, _k4_arrays(w, x.shape[1]), QK_K)
    _check_rows(M, "kernel T")
    kb = x2_clamp(K, w.n_out, block_n, kb)[1]
    nt, nr, nd = slab_plan(M, w.n_out, kb, K=K, x2=True)
    xq, xs, sxm, out = _w4a8_buffers(M, K, w.n_out, x.device)
    rc = kernels.lib("slab_gemv").w4a8k4_slab_launch(
        x.data_ptr(), _is_bf16(x), w.codes.data_ptr(), nt, nr, nd, kb, xq.data_ptr(),
        xs.data_ptr(), sxm.data_ptr(), out.data_ptr(), M, K, w.n_out,
        kernels.stream_ptr(x.device))
    kernels.check(rc, "w4a8k4_slab_gemv")
    kernels.count("w4a8k4_slab_gemv")
    return out, xq, xs, sxm


def x2_matmul(x: torch.Tensor, w: QuantTensorA8K4, block_n: int = SLAB_BLOCK_N,
              kb: int = 8) -> torch.Tensor:
    """Kernel T (CUDA C++, replaces tools/ab_a8k4.py's TPU kernel
    _x2_kernel): kernel I's function on the native superblocks, x [M <= 16,
    K] → [M, N] f32, the min term folded into each group term and the sum
    taken per slab of kb superblocks (x2_clamp)."""
    if x.device.type == "cpu":
        return x2_matmul_plain(x, w, block_n, kb)
    return x2_launch(x, w, block_n, kb)[0]


# ---------------------------------------------------------------------------
# kernels U and V: ubench_q4k's variants v1, v2 and v3
# ---------------------------------------------------------------------------
#
# blama_tpu/tools/ubench_q4k.py times dequant-matmul designs on raw arrays,
# and so do these, in the port's orientation ([N, ...], a column contiguous
# along K). Their packed codes are ubench's tile pairing (pack_pairs): uint8
# [N, K/2], the 128 bytes of 256-element tile t at 128t, byte j = element
# 256t+j (low nibble) | element 256t+128+j (high). kb (tiles per K-block or
# slab) is a parameter of their numerics; block_n, the columns one CTA owns,
# moves no bit. The min terms are small f32 products outside the kernels, as
# in the reference. No engine reaches U or V: the tools do.

def unpair_tiles(codes: torch.Tensor) -> torch.Tensor:
    """Tile-paired codes [N, K/2] → element-order codes u8 [N, K]."""
    N = codes.shape[0]
    c = codes.reshape(N, -1, 1, QK_K // 2)
    return torch.cat([c & 0x0F, c >> 4], dim=2).reshape(N, -1)


def _tile_clamp(what: str, K: int, N: int, block_n: int, kb: int) -> int:
    """The references' column tile (block_n halved until it divides N); kb
    is not clamped there, so a K that is not whole K-blocks is refused."""
    bn = _col_tile(what, K, N, block_n, kb)
    if K % (kb * QK_K):
        raise ValueError(f"kernel {what}: K={K} is not a multiple of kb*256 = {kb * QK_K}")
    return bn


def _check_uv(what: str, x: torch.Tensor, arrays, kb: int) -> tuple[int, int]:
    M, K = _check_cuda(x, arrays, QK_K)
    _check_rows(M, f"kernel {what}")
    if kb > 8:
        raise ValueError(f"kernel {what} takes K-blocks of at most 8 tiles, got kb={kb}")
    return M, K


def twodot_pos_plain(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
                     kb: int = 8) -> torch.Tensor:
    """Plain version of kernel U: per K-block of kb tiles x_lo @ (lo·scale) +
    x_hi @ (hi·scale) (the low / high halves of each tile), the blocks added
    in K order → [M, N] f32."""
    M, K = x.shape
    N, T = codes.shape[0], K // QK_K
    _tile_clamp("U", K, N, 1, kb)
    c = codes.reshape(N, T, 4, GROUP)
    s = scales.float().reshape(N, T, 8, 1)
    w_lo = ((c & 0x0F).float() * s[:, :, :4]).reshape(N, T, QK_K // 2)
    w_hi = ((c >> 4).float() * s[:, :, 4:]).reshape(N, T, QK_K // 2)
    xt = x.float().reshape(M, T, 2, QK_K // 2)
    out = None
    for t0 in range(0, T, kb):
        blk = slice(t0, t0 + kb)
        p = (xt[:, blk, 0].reshape(M, -1) @ w_lo[:, blk].reshape(N, -1).t()
             + xt[:, blk, 1].reshape(M, -1) @ w_hi[:, blk].reshape(N, -1).t())
        out = p if out is None else out + p
    return out


# kernel U's CTA (twodot.cu q4k_twodot_kernel): U_PAIRS pairs of consumer
# warps (the low and the high chains of C columns) beside one producer warp
# that keeps a ring of D slots full, S tiles of x's rows and of the CTA's
# codes and scales a slot
U_PAIRS = 8
U_MAX_SLOTS = 8
U_RING = 128 + 2 * U_PAIRS * 64 * 4   # the ring's barriers and the pairs' block sums
U_MIN_CTAS = 128     # the CTAs that make up (most of) a wave
SMEM_SM = 233472     # an H100 SM's shared memory; each CTA holds 1 KB of it beside its own


def _row_tile(M: int) -> int:
    """The rows kernel U's instance holds (its template MT)."""
    return next(mt for mt in (1, 2, 4, 8, 16) if M <= mt)


def twodot_slot_bytes(mt: int, c: int, s: int) -> int:
    """Bytes of one slot of U's ring (twodot.cu u_slot_bytes): S tiles of
    x's mt rows (f32), then of the CTA's U_PAIRS * c columns their codes
    (128 bytes a tile) and scales (8 f32 a tile)."""
    return mt * s * QK_K * 4 + U_PAIRS * c * s * (QK_K // 2 + 8 * 4)


def twodot_smem(M: int, plan: tuple[int, int, int]) -> int:
    """Dynamic shared memory of kernel U under plan (C, S, D)."""
    c, s, d = plan
    return U_RING + d * twodot_slot_bytes(_row_tile(M), c, s)


def twodot_plan(M: int, N: int, kb: int = 8) -> tuple[int, int, int]:
    """Kernel U's plan (C columns a warp pair, S tiles a slot, D slots) for M
    rows, N columns and K-blocks of kb tiles. C: 4 while those CTAs still
    make up a wave (one float4 of x read from shared memory feeds 4
    columns' FMAs), else 1 (wk/wv's 1024 columns: 128 CTAs). S: 4, 2 or 1,
    the most that divides kb, so a K-block ends with a slot. D: as many
    slots as fit, up to U_MAX_SLOTS, in two CTAs an SM at 1..2 rows and in
    one beyond. Each column keeps the parent's chains whatever the plan, so
    the plan moves no bit."""
    mt = _row_tile(M)
    c = 4 if -(-N // (U_PAIRS * 4)) >= U_MIN_CTAS else 1
    s = next(t for t in (4, 2, 1) if kb % t == 0)
    room = (SMEM_MAX if mt > 2 else SMEM_SM // 2 - 1024) - U_RING
    return c, s, min(U_MAX_SLOTS, room // twodot_slot_bytes(mt, c, s))


def twodot_launch(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
                  block_n: int = SLAB_BLOCK_N, kb: int = 8, plan=None) -> torch.Tensor:
    """Launch kernel U on CUDA tensors → the positive part [M, N] f32.
    block_n is the reference's column tile, checked as the reference clamps
    it; the CTA's columns come from twodot_plan (`plan`, a (C, S, D), forces
    one: for tests and measuring; it moves no bit)."""
    N, K = codes.shape[0], x.shape[1]
    if x.dtype != torch.float32:
        raise TypeError(f"kernel U takes f32 activations, got {x.dtype}")
    M, K = _check_uv("U", x, ((codes, torch.uint8, (N, K // 2)),
                              (scales, torch.float32, (N, K // GROUP))), kb)
    _check_aligned(scales)
    _tile_clamp("U", K, N, block_n, kb)
    c, s, d = twodot_plan(M, N, kb) if plan is None else plan
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    rc = kernels.lib("twodot").q4k_twodot_launch(
        x.data_ptr(), codes.data_ptr(), scales.data_ptr(), c, s, d, kb, out.data_ptr(), M, K,
        N, kernels.stream_ptr(x.device))
    kernels.check(rc, "q4k_twodot_matmul")
    kernels.count("q4k_twodot_matmul")
    return out


def q4k_matmul_v1(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
                  mins: torch.Tensor, block_n: int = SLAB_BLOCK_N, kb: int = 8) -> torch.Tensor:
    """Kernel U (CUDA C++, replaces blama_tpu/tools/ubench_q4k.py's TPU kernel
    _v1_kernel): x [M <= 16, K] f32 @ tile-paired Q4_K codes with f32 scales
    and mins [N, K/32] → [M, N] f32; the min term Σx_g @ mins after it."""
    M, K = x.shape
    pos = (twodot_pos_plain(x, codes, scales, kb) if x.device.type == "cpu"
           else twodot_launch(x, codes, scales, block_n, kb))
    xg_sum = x.float().reshape(M, K // GROUP, GROUP).sum(dim=-1)
    return pos - xg_sum @ mins.float().t()


def plane_pos_plain(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
                    kb: int = 4) -> torch.Tensor:
    """Plain version of kernel V on element-order codes [N, K] (int8, or
    unpair_tiles' uint8): the int32 group dots of the activation codes, each
    term dot·ws·xscale, summed per tile (its 8 groups in order), the tiles
    of a slab of kb in order, the slabs in K order → [M, N] f32."""
    M, K = x.shape
    _tile_clamp("V", K, codes.shape[0], 1, kb)
    xq, xs, _ = quant_acts(x)
    terms = _group_dots(xq, codes) * scales.float()[None] * xs[:, None, :]
    t = terms.reshape(M, codes.shape[0], K // (kb * QK_K), kb, 8)
    return _seq_sum(_seq_sum(_seq_sum(t)))


def plane_launch(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor, packed: bool,
                 block_n: int = SLAB_BLOCK_N, kb: int = 4):
    """Launch kernel V on CUDA tensors, int8 codes [N, K] or (packed)
    tile-paired uint8 [N, K/2]. Returns (pos [M, N] f32, xq, xs, sxm).
    block_n passes the reference's clamp; the CTA comes from slab_plan."""
    N, K = codes.shape[0], x.shape[1]
    carr = (codes, torch.uint8, (N, K // 2)) if packed else (codes, torch.int8, (N, K))
    M, K = _check_uv("V", x, (carr, (scales, torch.bfloat16, (N, K // GROUP))), kb)
    _check_aligned(scales)
    _tile_clamp("V", K, N, block_n, kb)
    nt, nr, nd = slab_plan(M, N, kb, int8=not packed, K=K)
    xq, xs, sxm, out = _w4a8_buffers(M, K, N, x.device)
    name = "w4a8_packed_matmul" if packed else "w4a8_plane_matmul"
    rc = kernels.lib("slab_gemv").w4a8_plane_launch(
        x.data_ptr(), _is_bf16(x), codes.data_ptr(), int(packed), scales.data_ptr(), nt, nr, nd,
        kb,
        xq.data_ptr(), xs.data_ptr(), sxm.data_ptr(), out.data_ptr(), M, K, N,
        kernels.stream_ptr(x.device))
    kernels.check(rc, name)
    kernels.count(name)
    return out, xq, xs, sxm


def _plane_matmul(x, codes, scales, mins, packed, block_n, kb):
    if x.device.type == "cpu":
        elem = unpair_tiles(codes) if packed else codes
        pos, sxm = plane_pos_plain(x, elem, scales, kb), quant_acts(x)[2]
    else:
        pos, _, _, sxm = plane_launch(x, codes, scales, packed, block_n, kb)
    return pos - sxm @ mins.float().t()


def w4a8_plane_matmul(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
                      mins: torch.Tensor, block_n: int = SLAB_BLOCK_N,
                      kb: int = 4) -> torch.Tensor:
    """Kernel V on int8 codes [N, K] (CUDA C++, replaces
    blama_tpu/tools/ubench_q4k.py's TPU kernel _v2_kernel): W4A8, x [M <= 16,
    K] → [M, N] f32 with bf16 scales / mins [N, K/32]; the min term
    (xscale·Σcodes) @ mins after the kernel."""
    return _plane_matmul(x, codes, scales, mins, False, block_n, kb)


def w4a8_packed_matmul(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
                       mins: torch.Tensor, block_n: int = SLAB_BLOCK_N,
                       kb: int = 8) -> torch.Tensor:
    """Kernel V on tile-paired codes [N, K/2], unpacked in the kernel (CUDA
    C++, replaces ubench_q4k.py's TPU kernel _v3_kernel): the numbers of
    w4a8_plane_matmul on the same codes."""
    return _plane_matmul(x, codes, scales, mins, True, block_n, kb)


# ---------------------------------------------------------------------------
# kernels B, G, H: exact dequant matmuls
# ---------------------------------------------------------------------------

# rows of the zeroed block each row of an exact product goes through
_ROW_BLOCK = 16


def require_ieee_f32(t: torch.Tensor) -> None:
    """Refuse an f32 product on the card while the caller allows TF32
    (torch.backends.cuda.matmul.allow_tf32, a process-wide setting): cuBLAS
    would then round the operands to TF32, and the product would no longer
    be the reference's f32 dot. The setting is read, never changed."""
    if t.is_cuda and t.dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("f32 products need TF32 off "
                           "(torch.backends.cuda.matmul.allow_tf32 = False)")


def rows_mm(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """a [M, K] @ b [K, N], each row's bits independent of the rows beside
    it, as the exact kernels give them (a MoE decode step and its padded
    replay rest on it, and so does a dense engine's replay). A BLAS picks
    its kernel, and with it a row's sum order, by the row count (cuBLAS: a
    GEMV at one row, other GEMM tiles at 4, 8 or 128), and on the CPU also
    by the thread count and the operand's alignment; so no row goes through
    a product whose shape follows M. On the CPU every row goes alone, as row
    0 of a zeroed 16-row block in a buffer of its own (at 16 rows the BLAS
    takes its GEMM kernel, whose sum order the reference's CPU dot shares),
    in f32 (bf16 products are exact there). On the card the rows are padded
    with zero rows to whole 16-row blocks and each block is one [16, K] @
    [K, N] product: one cuBLAS kernel whatever M, and a GEMM sums each output
    element in an order that does not depend on its row.

    The operands are taken in b's dtype (f32, or bf16: a dense engine's
    weight) and summed in f32, as the reference's dot: bf16 blocks through
    `torch.mm(..., out_dtype=float32)` (split-K partials never reduced in
    bf16), f32 blocks never through TF32 (require_ieee_f32: a call with TF32
    allowed raises). The result is in `out_dtype`, a's dtype by default."""
    out_dtype = out_dtype or a.dtype
    a = a.to(b.dtype)
    M, K = a.shape
    if a.device.type == "cpu":
        bf = b.float()
        rows = []
        for i in range(M):
            blk = a.new_zeros((_ROW_BLOCK, K), dtype=torch.float32)
            blk[0] = a[i]
            rows.append((blk @ bf)[:1])
        return (torch.cat(rows) if rows else a.float() @ bf).to(out_dtype)
    pad = torch.nn.functional.pad(a, (0, 0, 0, -M % _ROW_BLOCK))
    if b.dtype == torch.bfloat16:
        outs = [torch.mm(pad[i:i + _ROW_BLOCK], b, out_dtype=torch.float32)
                for i in range(0, pad.shape[0], _ROW_BLOCK)]
    else:
        require_ieee_f32(b)
        outs = [pad[i:i + _ROW_BLOCK] @ b for i in range(0, pad.shape[0], _ROW_BLOCK)]
    if not outs:
        return (a.float() @ b.float()).to(out_dtype)
    return (outs[0] if len(outs) == 1 else torch.cat(outs))[:M].to(out_dtype)


def _q4k_values(w: QuantTensor) -> torch.Tensor:
    """code·scale of a split Q4_K weight → f32 [N, K] (the min term apart)."""
    N = w.n_out
    codes = unpair_codes(w.codes).reshape(N, -1, GROUP).float()
    return (codes * w.scales.float()[..., None]).reshape(N, -1)


def q4k_pos_plain(x: torch.Tensor, w: QuantTensor) -> torch.Tensor:
    """Plain version of kernel B: x [M, K] @ (code·scale) → [M, N] f32."""
    return rows_mm(x.float(), _q4k_values(w).t())


# The exact dequant GEMM's tile shapes, output rows x columns per CTA, in the
# order of ops/csrc/quant_matmul.cu's Tile0 .. Tile7 (8 x 8, 8 x 8, 4 x 8,
# 8 x 4, 4 x 4, 4 x 2, 4 x 1 and 2 x 1 outputs per consumer thread), and each
# tile's rate: its outputs' throughput relative to the 128 x 128 tile's, as
# chip_smoke.py's tile sweep measures it at 2048 rows of the 8B projections
# on an H100 (the larger a thread's register tile, the more FMAs per
# shared-memory read).
# Every output element is one f32 chain whatever the tile: the shape moves
# no bit.
TILES = ((128, 128), (128, 64), (64, 112), (64, 64), (64, 32), (32, 32), (16, 32), (8, 32))
TILE_RATE = (1.0, 0.9, 0.78, 0.77, 0.53, 0.435, 0.38, 0.255)
N_SMS = 132   # an H100 SXM's streaming multiprocessors: one wave of CTAs


def tile_ctas(t: int, M: int, N: int, n_mat: int = 1) -> int:
    """CTAs tile t launches for n_mat products of [M, N] outputs."""
    bm, bn = TILES[t]
    return -(-M // bm) * -(-N // bn) * n_mat


def tile_fits(M: int) -> list[int]:
    """The tiles tile_plan considers at M rows: no taller than M rounded up
    to a power of two (at least 8), largest first."""
    cap = max(8, 1 << (M - 1).bit_length())
    return [t for t, (bm, _) in enumerate(TILES) if bm <= cap]


def tile_cost(t: int, M: int, N: int, n_mat: int = 1) -> float:
    """The plan's estimate of tile t's time: the outputs the busiest SM
    computes (whole waves of N_SMS CTAs) over the tile's rate."""
    bm, bn = TILES[t]
    return -(-tile_ctas(t, M, N, n_mat) // N_SMS) * bm * bn / TILE_RATE[t]


def tile_plan(M: int, N: int, n_mat: int = 1) -> int:
    """The tile (index into TILES) for n_mat products (K-blocks or selected
    experts) of [M, N] outputs, M > 1: among the tiles no taller than M
    needs (tile_fits) that launch a wave of N_SMS CTAs, the cheapest by
    tile_cost; where none does, the one that launches the most. Each CTA
    covers its own outputs over the whole K (or K-block): no K split."""
    fits = tile_fits(M)
    full = [t for t in fits if tile_ctas(t, M, N, n_mat) >= N_SMS]
    if not full:
        return max(fits, key=lambda t: (tile_ctas(t, M, N, n_mat), -t))
    return min(full, key=lambda t: (tile_cost(t, M, N, n_mat), t))


def _tile(tile, M: int, N: int, n_mat: int = 1) -> int:
    """The plan's tile, or the one a test forces (any shape gives the same
    bits, which the card tests hold)."""
    if tile is None:
        return tile_plan(M, N, n_mat)
    if not 0 <= tile < len(TILES):
        raise ValueError(f"tile must be 0..{len(TILES) - 1}, got {tile}")
    return tile


# The one-row shapes of the exact GEMM (M = 1: every solo decode step of
# the exact engines): the tiles' body with one row, one consumer warp
# running 32 columns' chains (a thread each) from the converted buffers and
# PW producer warps staging the weights with cp.async and dequantizing them.
# (BN columns, SG groups a stage, ring stages, producer warps) per shape, in
# the kernel's order (quant_matmul.cu RowTile0, RowTile1); chip_smoke.py's
# row sweep times each at the 8B shapes.
ROW_TILES = ((32, 8, 4, 4), (32, 4, 4, 2))
# the loaders, in the order the kernel numbers them (dequant_row_shape), and
# the bytes one column of a stage of SG groups takes in the ring (the
# loaders' raw_bytes<SG>: codes, then the scale and min words)
ROW_LOADERS = ("b_f32", "b_bf16", "min_f32", "min_bf16", "g32", "g16", "h")
ROW_MIN_TERM = ("min_f32", "min_bf16", "h")   # the group sums of x and the -mins staged
SMEM_MAX = 232448   # an H100's shared memory for one CTA


def _round16(b: int) -> int:
    return -(-b // 16) * 16


def row_raw_bytes(loader: str, sg: int) -> int:
    """quant_matmul.cu's raw_bytes<SG>() of a loader."""
    if loader == "h":
        return 16 * (1 + 2 * ((sg + 1) // 2))
    if loader in ("g32", "g16"):
        return _round16(32 * sg + 4 * (32 // int(loader[1:])) * sg)
    words = sg if loader.endswith("f32") else sg // 2 + 1
    return _round16(16 * sg + (8 if loader.startswith("min") else 4) * words)


def row_smem(t: int, loader: str, x_bf16: bool) -> int:
    """Dynamic shared memory of one-row tile t (quant_matmul.cu
    tile_smem_bytes at BM = 1): the ring (per stage x's row, 16 bytes of
    padding, BN columns of raw weights), then two converted buffers (x and
    the weights as f32, rows of SG·32 + 4 floats; the group sums and -mins
    beside them with the min term). It does not depend on K: x is staged
    with the weights."""
    bn, sg, stages, _ = ROW_TILES[t]
    ks, xsz = sg * GROUP, 2 if x_bf16 else 4
    slot = ks * xsz + 16 + bn * row_raw_bytes(loader, sg)
    buf = (1 + bn) * (ks + 4) + ((1 + bn) * sg if loader in ROW_MIN_TERM else 0)
    return stages * slot + 2 * 4 * buf


def row_ctas(t: int, N: int, n_mat: int = 1) -> int:
    """CTAs one-row tile t launches for n_mat products of N columns."""
    return -(-N // ROW_TILES[t][0]) * n_mat


def row_plan(kb: int, N: int, loader: str, n_mat: int = 1) -> int:
    """The one-row tile (index into ROW_TILES) for n_mat products (K-blocks
    of kb elements, or selected experts) of N columns through `loader`: the
    8-group stages with four producer warps while the CTAs fit two an SM in
    one wave (the chain-bound shapes: wq/wo, wk/wv, down), the 4-group
    stages with two (four CTAs an SM) beyond. Every shape has 32-column
    CTAs, the most the columns allow; each column keeps its one chain
    whatever the shape, so the plan moves no bit, and it reads no row
    count."""
    if loader not in ROW_LOADERS or kb % GROUP:
        raise ValueError(f"no one-row plan for loader {loader!r} at K-blocks of {kb}")
    return 0 if row_ctas(0, N, n_mat) <= 2 * N_SMS else 1


def _plan(tile, row_tile, M: int, kb: int, N: int, loader: str, n_mat: int = 1) -> int:
    """The launch's plan argument: at one row the one-row tile (row_plan, or
    `row_tile` forced by a test), else the tile (_tile)."""
    if M != 1:
        return _tile(tile, M, N, n_mat)
    if row_tile is None:
        return row_plan(kb, N, loader, n_mat)
    if not 0 <= row_tile < len(ROW_TILES):
        raise ValueError(f"row_tile must be 0..{len(ROW_TILES) - 1}, got {row_tile}")
    return row_tile


def _tile_launch(fn: str, name: str, x: torch.Tensor, N: int, tile, row_tile, loader: str,
                 *args) -> torch.Tensor:
    M, K = x.shape
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    rc = getattr(kernels.lib("quant_matmul"), fn)(
        x.data_ptr(), _is_bf16(x), *args, _plan(tile, row_tile, M, K, N, loader),
        out.data_ptr(), M, K, N, kernels.stream_ptr(x.device))
    kernels.check(rc, name)
    kernels.count(name)
    return out


def q4k_min_plain(x: torch.Tensor, w: QuantTensor) -> torch.Tensor:
    """x [M, K] @ (code·scale − min) → [M, N] f32 with the min term taken
    with the product (the function of kernels K and L): x @ (code·scale)
    minus (Σ x over each 32-group) @ min, every row alone (rows_mm). The
    weights go in as contiguous [K, N]: the CPU's BLAS then gives a column
    the same bits at any N (a transposed operand's column may not), so a
    column shard of the weight computes its columns of the whole product."""
    M, K = x.shape
    xf = x.float()
    xg = xf.reshape(M, K // GROUP, GROUP).sum(dim=-1)
    return (rows_mm(xf, _q4k_values(w).t().contiguous())
            - rows_mm(xg, w.mins.float().t().contiguous()))


def q4k_pos(x: torch.Tensor, w: QuantTensor, tile: int | None = None,
            row_tile: int | None = None) -> torch.Tensor:
    """Kernel B (CUDA C++, replaces the TPU kernel _q4k_matmul_kernel):
    positive part x @ (code·scale) → [M, N] f32; bf16 scales
    (QuantTensorA8S) or f32 scales (QuantTensor). `tile` forces a shape of
    TILES on more than one row, `row_tile` a shape of ROW_TILES on one row
    (tests); the defaults are tile_plan's and row_plan's."""
    if x.device.type == "cpu":
        return q4k_pos_plain(x, w)
    f32 = not isinstance(w, QuantTensorA8S)
    _check_cuda(x, _q4k_arrays(w, x.shape[1], torch.float32 if f32 else torch.bfloat16))
    return _tile_launch("q4k_dequant_mm_launch", "q4k_dequant_matmul", x, w.n_out, tile,
                        row_tile, "b_f32" if f32 else "b_bf16",
                        w.codes.data_ptr(), w.scales.data_ptr(), int(f32))


def q4k_matmul(x: torch.Tensor, w: QuantTensor) -> torch.Tensor:
    """x [M, K] @ packed W → [M, N] f32, exact dequant numerics. The affine
    min term Σ_g (Σ_{k∈g} x_k)·min_g is a small f32 product outside the
    kernel, as in the reference."""
    M, K = x.shape
    pos = q4k_pos(x, w)
    xg_sum = x.float().reshape(M, K // GROUP, GROUP).sum(dim=-1)
    return pos - rows_mm(xg_sum, w.mins.float().t())


def q8_0_matmul_plain(x: torch.Tensor, w: QuantTensorQ8) -> torch.Tensor:
    """Plain version of kernel G: x [M, K] @ (code·scale) → [M, N] f32."""
    return x.float() @ dequantize(w).t()


def q8_0_matmul(x: torch.Tensor, w: QuantTensorQ8, tile: int | None = None,
                row_tile: int | None = None) -> torch.Tensor:
    """Kernel G (CUDA C++, replaces the TPU kernel _q8_matmul_kernel):
    x [M, K] @ int8-code W → [M, N] f32, scale group 32 or 16 (`tile` and
    `row_tile` as for q4k_pos)."""
    if x.device.type == "cpu":
        return q8_0_matmul_plain(x, w)
    if w.group not in (16, 32):
        raise ValueError(f"kernel G takes scale groups of 16 or 32, got {w.group}")
    K = x.shape[1]
    _check_cuda(x, ((w.codes, torch.int8, (w.n_out, K)),
                    (w.scales, torch.float32, (w.n_out, K // w.group))))
    return _tile_launch("q8_dequant_mm_launch", "q8_dequant_matmul", x, w.n_out, tile,
                        row_tile, f"g{w.group}", w.codes.data_ptr(), w.scales.data_ptr(),
                        w.group)


def q4k_native_matmul_plain(x: torch.Tensor, w: QuantTensorK4) -> torch.Tensor:
    """Plain version of kernel H: per 32-group the positive dot
    x_g · (code·scale) minus (Σ x_g)·min, the groups then summed."""
    codes, scales, mins = decode_q4k_blocks(w.codes.view(-1, Q4K_BLOCK), w.n_out)
    M, K = x.shape
    G = K // GROUP
    xg = x.float().reshape(M, G, GROUP)
    wdq = codes.float().reshape(-1, G, GROUP) * scales[..., None]
    pos = torch.einsum("mgi,ngi->mng", xg, wdq)
    return (pos - xg.sum(dim=-1)[:, None, :] * mins[None]).sum(dim=-1)


def q4k_native_matmul(x: torch.Tensor, w: QuantTensorK4, tile: int | None = None,
                      row_tile: int | None = None) -> torch.Tensor:
    """Kernel H (CUDA C++, replaces the TPU kernel _q4k_native_kernel):
    x [M, K] @ native-layout W → [M, N] f32, exact dequant numerics, scales
    decoded and min term applied inside the kernel (`tile` and `row_tile`
    as for q4k_pos)."""
    if x.device.type == "cpu":
        return q4k_native_matmul_plain(x, w)
    _check_cuda(x, _k4_arrays(w, x.shape[1]), QK_K)
    return _tile_launch("q4k_native_mm_launch", "q4k_native_matmul", x, w.n_out, tile,
                        row_tile, "h", w.codes.data_ptr())


# ---------------------------------------------------------------------------
# MoE expert banks: kernels J and K
# ---------------------------------------------------------------------------

@dataclass
class QuantExperts:
    """Expert bank kept 4-bit packed (the reference's class of the same name):
    the Ne experts' QuantTensor arrays stacked, N-major as every layout here.
    Expert e's arrays are [e] of each; a8 selects the W4A8 engine's bf16
    scales and dispatch (kernel J up to 16 rows), else f32 scales (exact)."""

    codes: torch.Tensor    # uint8 [Ne, N, K/2]
    scales: torch.Tensor   # f32 (exact) / bf16 (a8) [Ne, N, K/32]
    mins: torch.Tensor     # the same
    a8: bool = False

    @property
    def n_expert(self) -> int:
        return self.codes.shape[0]

    @property
    def n_out(self) -> int:
        return self.codes.shape[1]

    @property
    def shape(self):
        return (self.codes.shape[2] * 2, self.codes.shape[1])

    @property
    def device(self):
        return self.codes.device

    def expert(self, e: int) -> QuantTensor:
        """Expert e as a QuantTensor (A8S when a8): views, no copy."""
        cls = QuantTensorA8S if self.a8 else QuantTensor
        return cls(self.codes[e], self.scales[e], self.mins[e])


def repack_q4k_bank(data, n_expert: int, n_rows: int, row_len: int, a8: bool,
                    device="cuda") -> QuantExperts:
    """GGUF Q4_K expert-bank bytes (ggml ne = (K, N, Ne)): expert e's N rows
    are rows e·N .. e·N + N − 1 of one [Ne·N, K] matrix, so the whole bank is
    repacked in one call and split by a view (the port's counterpart of the
    reference's _repack_bank)."""
    w = (repack_q4k_a8s if a8 else repack_q4k_exact)(data, n_expert * n_rows,
                                                     row_len, device)

    def split(a):
        return a.view(n_expert, n_rows, -1)

    return QuantExperts(split(w.codes), split(w.scales), split(w.mins), a8)


def _bank_rows(x: torch.Tensor, n_sel: int):
    """x [R, K] (shared by every selected expert) or [n_sel, R, K] (one input
    per expert) → (per_expert, R, K, expert j's input as a function of j)."""
    if x.dim() == 2:
        return False, x.shape[0], x.shape[1], lambda j: x
    if x.dim() != 3 or x.shape[0] != n_sel:
        raise ValueError(f"bank input must be [R, K] or [{n_sel}, R, K], got {tuple(x.shape)}")
    return True, x.shape[1], x.shape[2], lambda j: x[j]


@kernels.plain_version
def w4a8_bank_plain(x: torch.Tensor, bank: QuantExperts, eids: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel J: kernel A's sum against each selected expert
    → [n_sel, R, N] f32."""
    ids = eids.tolist()
    _, _, _, xj = _bank_rows(x, len(ids))
    return torch.stack([w4a8_matmul_plain(xj(j), bank.expert(e)) for j, e in enumerate(ids)])


@kernels.plain_version
def q4k_bank_plain(x: torch.Tensor, bank: QuantExperts, eids: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel K: q4k_min_plain against each selected expert
    → [n_sel, R, N] f32."""
    ids = eids.tolist()
    xj = _bank_rows(x, len(ids))[3]
    return torch.stack([q4k_min_plain(xj(j), bank.expert(e)) for j, e in enumerate(ids)])


def _check_bank(x: torch.Tensor, bank: QuantExperts, eids: torch.Tensor, scale_dtype):
    n_sel = eids.shape[0]
    per, R, K = _bank_rows(x, n_sel)[:3]
    Ne, N, G = bank.n_expert, bank.n_out, K // GROUP
    _check_cuda(x.reshape(-1, K), ((bank.codes, torch.uint8, (Ne, N, K // 2)),
                                   (bank.scales, scale_dtype, (Ne, N, G)),
                                   (bank.mins, scale_dtype, (Ne, N, G))))
    if eids.dim() != 1 or eids.dtype != torch.int32 or eids.device != x.device \
            or not eids.is_contiguous() or not 1 <= n_sel <= 65535:
        raise ValueError("eids must be a contiguous int32 vector on x's device")
    return per, R, K, N, n_sel


def w4a8_bank_launch(x: torch.Tensor, bank: QuantExperts, eids: torch.Tensor,
                     codes: bool = True, rw: int | None = None):
    """Launch kernel J on CUDA tensors. Returns (out [n_sel, R, N] f32, and
    x's xq, xs, sxm of every quantized input row when `codes`, else Nones)."""
    per, R, K, N, n_sel = _check_bank(x, bank, eids, torch.bfloat16)
    _check_rows(R, "kernel J")
    if K % QK_K:
        raise ValueError(f"kernel J takes K % {QK_K} == 0, got K={K}")
    _check_aligned(bank.scales, bank.mins)
    out = torch.empty((n_sel, R, N), dtype=torch.float32, device=x.device)
    bufs = _gemv_launch("w4a8_bank_launch", "w4a8_bank_gemv", x,
                        (int(per), bank.codes.data_ptr(), bank.scales.data_ptr(),
                         bank.mins.data_ptr(), eids.data_ptr(), n_sel, bank.n_expert),
                        out, (n_sel if per else 1) * R, N, n_sel, codes, rw)
    return (out, *bufs)


def w4a8_bank_matmul(x: torch.Tensor, bank: QuantExperts, eids: torch.Tensor) -> torch.Tensor:
    """Kernel J (CUDA C++, replaces the TPU kernel _a8s_bank_kernel): x [R <= 16,
    K] or [n_sel, R, K] @ bank[eids[j]] → [n_sel, R, N] f32 (W4A8), one
    launch."""
    if x.device.type == "cpu":
        return w4a8_bank_plain(x, bank, eids)
    return w4a8_bank_launch(x, bank, eids, codes=False)[0]


def q4k_bank_matmul(x: torch.Tensor, bank: QuantExperts, eids: torch.Tensor,
                    tile: int | None = None, row_tile: int | None = None) -> torch.Tensor:
    """Kernel K (CUDA C++, replaces the TPU kernel _q4k_bank_kernel): x [R, K]
    or [n_sel, R, K] @ bank[eids[j]] → [n_sel, R, N] f32, exact dequant with
    the min term inside; the bank's own scale dtype (f32 or bf16); `tile`
    and `row_tile` as for q4k_pos."""
    if x.device.type == "cpu":
        return q4k_bank_plain(x, bank, eids)
    f32 = not bank.a8
    per, R, K, N, n_sel = _check_bank(x, bank, eids, torch.float32 if f32 else torch.bfloat16)
    out = torch.empty((n_sel, R, N), dtype=torch.float32, device=x.device)
    rc = kernels.lib("quant_matmul").q4k_bank_mm_launch(
        x.data_ptr(), _is_bf16(x), int(per), bank.codes.data_ptr(), bank.scales.data_ptr(),
        bank.mins.data_ptr(), int(f32), eids.data_ptr(), n_sel, bank.n_expert,
        _plan(tile, row_tile, R, K, N, "min_f32" if f32 else "min_bf16", n_sel),
        out.data_ptr(), R, K, N, kernels.stream_ptr(x.device))
    kernels.check(rc, "q4k_bank_matmul")
    kernels.count("q4k_bank_matmul")
    return out


def bank_matmul(x: torch.Tensor, bank: QuantExperts, eids: torch.Tensor) -> torch.Tensor:
    """x [R, K] (or one [R, K] per selected expert, [n_sel, R, K]) against
    bank[eids[j]] → [n_sel, R, N] f32, the experts' packed bytes read in
    place. The reference's routing by row count: a W4A8 bank with at most
    A8S_MAX_BATCH rows goes to kernel J, everything else to kernel K."""
    if bank.a8 and x.shape[-2] <= A8S_MAX_BATCH:
        return w4a8_bank_matmul(x, bank, eids)
    return q4k_bank_matmul(x, bank, eids)


# ---------------------------------------------------------------------------
# tp_blocks: kernels L and M, per-K-block partials and pinned products
# ---------------------------------------------------------------------------
#
# The reference's fixed-topology mode: a prover sharded over tp devices and a
# verifier on one card give the same logits when both run tp_blocks = nb.
# Contraction-sharded projections (wo, w_down) take nb per-K-block partials
# [nb, M, N] from one dispatch, combined by a balanced halving tree
# (tree_combine): a tp device holds nb/tp contiguous blocks, so every side
# adds the same partials in the same association. Output-sharded projections
# (wq/wk/wv, gate/up, the lm head) take a pinned product: the min term
# inside the kernel and each output column's arithmetic independent of the
# columns computed beside it (the kernels here sum a column alone at any N,
# so the reference's fixed lane block TPB_BLOCK_N has no counterpart).


def _parts_supported(w, nb: int) -> bool:
    """Whether w takes the K-blocked partials at nb blocks: the exact split
    classes only (not a subclass of them), nb a power of two, K a multiple
    of nb superblocks; anything else falls through to qmm."""
    return (type(w) in (QuantTensor, QuantTensorA8S) and nb > 0 and nb & (nb - 1) == 0
            and w.shape[0] % (nb * QK_K) == 0)


def _pinned_supported(w) -> bool:
    return type(w) in (QuantTensor, QuantTensorA8S)


def tree_combine(parts: torch.Tensor) -> torch.Tensor:
    """Balanced halving tree over the leading (block) axis, parts[0::2] +
    parts[1::2] until one block is left: the association every engine
    shares. Each level's input is released once the next is formed."""
    while parts.shape[0] > 1:
        parts = parts[0::2] + parts[1::2]
    return parts[0]


def _check_blocks(nb: int) -> None:
    if not 1 <= nb <= 65535:
        raise ValueError(f"the K-blocked kernels take 1..65535 blocks, got {nb}")


def _sliced(w: QuantTensor, rows: slice, cols: slice, gcols: slice,
            contiguous: bool) -> QuantTensor:
    parts = (w.codes[rows, cols], w.scales[rows, gcols], w.mins[rows, gcols])
    return type(w)(*(t.contiguous() if contiguous else t for t in parts))


def k_slice(w: QuantTensor, i: int, nb: int, contiguous: bool = False) -> QuantTensor:
    """K-block i of nb of a split Q4_K weight, as a weight of its own (views,
    or with contiguous=True the arrays a tp device holding that K-slice
    stores, which the kernels take)."""
    cb, gb = w.codes.shape[1] // nb, w.scales.shape[1] // nb
    return _sliced(w, slice(None), slice(i * cb, (i + 1) * cb), slice(i * gb, (i + 1) * gb),
                   contiguous)


def column_slice(w: QuantTensor, lo: int, hi: int) -> QuantTensor:
    """Output columns lo .. hi-1 of a split Q4_K weight, contiguous: what a
    tp device holding that column shard stores."""
    return _sliced(w, slice(lo, hi), slice(None), slice(None), True)


def _parts_plain(fn, x: torch.Tensor, w: QuantTensor, nb: int) -> torch.Tensor:
    kb = x.shape[1] // nb
    return torch.stack([fn(x[:, i * kb:(i + 1) * kb], k_slice(w, i, nb)) for i in range(nb)])


def q4k_matmul_parts_plain(x: torch.Tensor, w: QuantTensor, nb: int) -> torch.Tensor:
    """Plain version of kernel L: q4k_min_plain on each K-block's slice of x
    and w → [nb, M, N] f32."""
    return _parts_plain(q4k_min_plain, x, w, nb)


def q4k_matmul_pinned_plain(x: torch.Tensor, w: QuantTensor) -> torch.Tensor:
    """Plain version of kernel L at nb = 1 → [M, N] f32."""
    return q4k_matmul_parts_plain(x, w, 1)[0]


def a8s_matmul_parts_plain(x: torch.Tensor, w: QuantTensorA8S, nb: int) -> torch.Tensor:
    """Plain version of kernel M: kernel A's plain version on each K-block's
    slice → [nb, M, N] f32 (the activation codes are per 32-group, so
    quantizing a slice gives the codes of the whole row's)."""
    return _parts_plain(w4a8_matmul_plain, x, w, nb)


def q4k_matmul_parts(x: torch.Tensor, w: QuantTensor, nb: int, tile: int | None = None,
                     row_tile: int | None = None) -> torch.Tensor:
    """Kernel L (CUDA C++, replaces the TPU kernels _q4k_parts_kernel and, at
    nb = 1, _q4k_pinned_kernel): x [M, K] @ packed W per K-block → [nb, M, N]
    f32 partials, exact dequant with the min term inside; f32 scales
    (QuantTensor) or bf16 (QuantTensorA8S above 16 rows); `tile` and
    `row_tile` as for q4k_pos."""
    if x.device.type == "cpu":
        return q4k_matmul_parts_plain(x, w, nb)
    _check_blocks(nb)
    f32 = not isinstance(w, QuantTensorA8S)
    M, K = _check_cuda(x, _q4k_arrays(w, x.shape[1], torch.float32 if f32 else torch.bfloat16),
                       nb * QK_K)
    out = torch.empty((nb, M, w.n_out), dtype=torch.float32, device=x.device)
    plan = _plan(tile, row_tile, M, K // nb, w.n_out, "min_f32" if f32 else "min_bf16", nb)
    rc = kernels.lib("quant_matmul").q4k_parts_mm_launch(
        x.data_ptr(), _is_bf16(x), w.codes.data_ptr(), w.scales.data_ptr(), w.mins.data_ptr(),
        int(f32), nb, plan, out.data_ptr(), M, K, w.n_out, kernels.stream_ptr(x.device))
    kernels.check(rc, "q4k_parts_matmul")
    kernels.count("q4k_parts_matmul")
    return out


def q4k_matmul_pinned(x: torch.Tensor, w: QuantTensor) -> torch.Tensor:
    """Kernel L at nb = 1: the pinned exact product [M, N] f32, min term
    inside (each column's bits independent of N and of the row count)."""
    return q4k_matmul_parts(x, w, 1)[0]


def a8s_parts_launch(x: torch.Tensor, w: QuantTensorA8S, nb: int, codes: bool = True,
                     rw: int | None = None):
    """Launch kernel M on CUDA tensors. Returns (out [nb, M, N] f32, and
    x's xq, xs, sxm when `codes`, as w4a8_launch does)."""
    _check_blocks(nb)
    M, K = _check_cuda(x, _q4k_arrays(w, x.shape[1], torch.bfloat16), nb * QK_K)
    _check_rows(M, "kernel M")
    _check_aligned(w.scales, w.mins)
    out = torch.empty((nb, M, w.n_out), dtype=torch.float32, device=x.device)
    bufs = _gemv_launch("w4a8_matmul_launch", "w4a8_parts_gemv", x,
                        (w.codes.data_ptr(), w.scales.data_ptr(), w.mins.data_ptr(), nb),
                        out, M, w.n_out, nb, codes, rw)
    return (out, *bufs)


def a8s_matmul_parts(x: torch.Tensor, w: QuantTensorA8S, nb: int) -> torch.Tensor:
    """Kernel M (CUDA C++, replaces the TPU kernel _a8s_parts_kernel):
    x [M <= 16, K] @ W per K-block → [nb, M, N] f32 partials (W4A8, min term
    inside), one launch."""
    if x.device.type == "cpu":
        return a8s_matmul_parts_plain(x, w, nb)
    return a8s_parts_launch(x, w, nb, codes=False)[0]


def _quant_parts_call(flat: torch.Tensor, w, nb: int) -> torch.Tensor:
    """The reference's routing of the partials by class and row count."""
    if type(w) is QuantTensorA8S and flat.shape[0] <= A8S_MAX_BATCH:
        return a8s_matmul_parts(flat, w, nb)
    return q4k_matmul_parts(flat, w, nb)


def _quant_kernel_call_pinned(flat: torch.Tensor, w) -> torch.Tensor:
    if type(w) is QuantTensorA8S and flat.shape[0] <= A8S_MAX_BATCH:
        # the reference's w4a8_swar_pinned (_a8s_pinned_kernel) is kernel A:
        # A already sums each column alone with the min term inside
        return w4a8_matmul(flat, w)
    return q4k_matmul_pinned(flat, w)


def qmm_blocked(x: torch.Tensor, w, nb: int) -> torch.Tensor:
    """Contraction-sharded matmul of tp_blocks mode (wo, w_down): x [..., K]
    @ W → [..., N] in x's dtype, the K axis in nb blocks whose f32 partials
    tree_combine adds. An eligible packed weight takes kernel L or M (one
    dispatch for all blocks); a dense [K, N] tensor nb products of K/nb
    rows; nb = 0, a non-power-of-two nb, a K that does not split, or an
    ineligible packed class: qmm. A LoraWrapped weight: its base through
    this dispatch, then its runtime term (the reference's branch)."""
    if nb and isinstance(w, LoraWrapped):
        flat = x.reshape(-1, x.shape[-1]).contiguous()
        base = qmm_blocked(flat, w.base, nb)
        return _with_lora(base, flat, w).reshape(*x.shape[:-1], -1)
    if nb and _parts_supported(w, nb):
        lead = x.shape[:-1]
        flat = x.reshape(-1, x.shape[-1]).contiguous()
        return tree_combine(_quant_parts_call(flat, w, nb)).reshape(*lead, -1).to(x.dtype)
    if not nb or not isinstance(w, torch.Tensor) or x.shape[-1] % nb or nb & (nb - 1):
        return qmm(x, w)
    lead, K = x.shape[:-1], x.shape[-1]
    xf, kb = x.reshape(-1, K).float(), K // nb
    parts = torch.stack([rows_mm(xf[:, i * kb:(i + 1) * kb], w[i * kb:(i + 1) * kb].float())
                         for i in range(nb)])
    return tree_combine(parts).reshape(*lead, -1).to(x.dtype)


def qmm_nblocked(x: torch.Tensor, w, nb: int, out_dtype=None) -> torch.Tensor:
    """Output-sharded matmul of tp_blocks mode (wq/wk/wv, gate/up, the lm
    head): x [..., K] @ W → [..., N] in out_dtype (default x's). An eligible
    packed weight takes the pinned product (kernel A up to 16 rows of a
    QuantTensorA8S, else kernel L at nb = 1); a dense [K, N] tensor nb
    column blocks of N/nb, each its own product; nb = 0, an N that does not
    split or an ineligible packed class: qmm (in x's dtype, as the
    reference). A LoraWrapped weight: its base through this dispatch, then
    its runtime term, the sum in out_dtype (the reference's branch)."""
    if nb and isinstance(w, LoraWrapped):
        flat = x.reshape(-1, x.shape[-1]).contiguous()
        base = qmm_nblocked(flat, w.base, nb)
        return _with_lora(base, flat, w, out_dtype).reshape(*x.shape[:-1], -1)
    if nb and _pinned_supported(w):
        lead = x.shape[:-1]
        flat = x.reshape(-1, x.shape[-1]).contiguous()
        out = _quant_kernel_call_pinned(flat, w)
        return out.reshape(*lead, -1).to(out_dtype or x.dtype)
    if not nb or not isinstance(w, torch.Tensor) or w.shape[-1] % nb:
        return qmm(x, w)
    lead, (K, N) = x.shape[:-1], w.shape
    xf, nw = x.reshape(-1, K).float(), N // nb
    out = torch.cat([rows_mm(xf, w[:, i * nw:(i + 1) * nw].float()) for i in range(nb)], dim=1)
    return out.reshape(*lead, N).to(out_dtype or x.dtype)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def _quant_kernel_call(flat: torch.Tensor, w) -> torch.Tensor:
    """The reference's routing by class and row count."""
    few = flat.shape[0] <= A8S_MAX_BATCH
    if isinstance(w, QuantTensorA8K4):
        return a8k4_matmul(flat, w) if few else q4k_native_matmul(flat, w)
    if isinstance(w, QuantTensorK4):
        return q4k_native_matmul(flat, w)
    if isinstance(w, QuantTensorA8S):
        return w4a8_matmul(flat, w) if few else q4k_matmul(flat, w)
    if isinstance(w, QuantTensorA8):
        return w4a8_xla_matmul(flat, w)
    if isinstance(w, QuantTensorQ8):
        return q8_0_matmul(flat, w)
    return q4k_matmul(flat, w)


def qmm(x: torch.Tensor, w) -> torch.Tensor:
    """x [..., K] @ W → [..., N] in x's dtype: a packed weight through its
    kernel (f32 accumulation inside), a dense [K, N] tensor through rows_mm
    (f32 sums, each row's bits its own), a LoraWrapped weight its base and
    then its runtime term (lora_term), added in f32 and cast back to x's
    dtype as the reference does."""
    lead = x.shape[:-1]
    flat = x.reshape(-1, x.shape[-1]).contiguous()
    if isinstance(w, LoraWrapped):
        return _with_lora(qmm(flat, w.base), flat, w).reshape(*lead, -1)
    if isinstance(w, torch.Tensor):
        return rows_mm(flat, w).reshape(*lead, -1)
    out = _quant_kernel_call(flat, w)
    return out.reshape(*lead, -1).to(x.dtype)
