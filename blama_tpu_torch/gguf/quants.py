"""GGML block-quantization formats the port reads: F32, F16, BF16, Q4_0,
Q4_1, Q5_0, Q5_1, Q8_0, Q2_K, Q3_K, Q4_K, Q5_K, Q6_K, Q8_K, IQ4_NL and
IQ4_XS, every type the JAX package's gguf/quants.py reads.

Vectorized numpy reference implementations (copied from the JAX package's
host code, which the port does not import; the JAX package's threaded C++
fast path is left out, and these are the functions it is held equal to).
Bit layouts follow the public GGML/GGUF spec, so existing GGUF files load
unmodified. The other GGML types (the IQ2 / IQ3 / IQ1 families, TQ*) raise
NotImplementedError, as they do in the JAX package.

Conventions:
  * A tensor's quantization runs along its *row* (ggml ne[0], the contiguous
    dimension). All (de)quantize functions take/return 2-D arrays shaped
    (n_rows, row_len) and flat uint8 byte arrays.
  * Quantizers here are valid encoders for the formats (dequant(quant(x)) ≈ x)
    but are not required to be bit-identical to llama.cpp's encoder search;
    the *decoder* layout is what the compatibility contract pins down.
"""

from __future__ import annotations

import numpy as np

from .constants import GGMLType, QK_K


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _f16(x: np.ndarray) -> np.ndarray:
    return x.astype(np.float16)


def _round_half_away(x: np.ndarray) -> np.ndarray:
    """Round half away from zero (C roundf), unlike numpy's banker's rounding."""
    return np.trunc(x + np.copysign(0.5, x))


def _nearest_int(x: np.ndarray) -> np.ndarray:
    return _round_half_away(x).astype(np.int32)



def _f16_col(blk: "np.ndarray", a: int, b: int) -> "np.ndarray":
    """Read fp16 scalars from byte columns [a:b) -> float32 shape (nb,)."""
    return blk[:, a:b].copy().view(np.float16).astype(np.float32).reshape(-1)

def _blocks(x: np.ndarray, block: int) -> np.ndarray:
    """Reshape (n_rows, row_len) -> (n_blocks_total, block)."""
    if x.ndim != 2:
        raise ValueError("expected 2-D (n_rows, row_len)")
    n_rows, row_len = x.shape
    if row_len % block != 0:
        raise ValueError(f"row length {row_len} not divisible by block {block}")
    return np.ascontiguousarray(x, dtype=np.float32).reshape(-1, block)


# ---------------------------------------------------------------------------
# Q8_0 : 32-elem blocks, fp16 scale + int8 values  (34 bytes)
# ---------------------------------------------------------------------------

def quantize_q8_0(x: np.ndarray) -> np.ndarray:
    b = _blocks(x, 32)
    amax = np.abs(b).max(axis=1)
    d = (amax / 127.0).astype(np.float32)
    d16 = _f16(d)
    d = d16.astype(np.float32)  # store/compute with the rounded scale
    inv = np.where(d > 0, 1.0 / np.where(d > 0, d, 1.0), 0.0)
    q = np.clip(_nearest_int(b * inv[:, None]), -127, 127).astype(np.int8)
    out = np.empty((b.shape[0], 34), dtype=np.uint8)
    out[:, 0:2] = d16.view(np.uint8).reshape(-1, 2)
    out[:, 2:] = q.view(np.uint8)
    return out.reshape(-1)


def dequantize_q8_0(data: np.ndarray, n_rows: int, row_len: int) -> np.ndarray:
    blk = data.reshape(-1, 34)
    d = _f16_col(blk, 0, 2)[:, None]
    q = blk[:, 2:].view(np.int8).astype(np.float32)
    return (q * d).reshape(n_rows, row_len)


# ---------------------------------------------------------------------------
# Q4_0 / Q4_1 / Q5_0 / Q5_1 : 32-elem blocks with nibble packing
# low nibbles hold elements 0..15, high nibbles hold elements 16..31
# ---------------------------------------------------------------------------

def quantize_q4_0(x: np.ndarray) -> np.ndarray:
    b = _blocks(x, 32)
    # value with largest magnitude determines the scale (sign included)
    idx = np.abs(b).argmax(axis=1)
    vmax = b[np.arange(b.shape[0]), idx]
    d = vmax / -8.0
    d16 = _f16(d)
    d = d16.astype(np.float32)
    inv = np.where(d != 0, 1.0 / np.where(d != 0, d, 1.0), 0.0)
    q = np.clip((b * inv[:, None] + 8.5).astype(np.int32), 0, 15).astype(np.uint8)
    out = np.empty((b.shape[0], 18), dtype=np.uint8)
    out[:, 0:2] = d16.view(np.uint8).reshape(-1, 2)
    out[:, 2:] = q[:, :16] | (q[:, 16:] << 4)
    return out.reshape(-1)


def dequantize_q4_0(data: np.ndarray, n_rows: int, row_len: int) -> np.ndarray:
    blk = data.reshape(-1, 18)
    d = _f16_col(blk, 0, 2)[:, None]
    qs = blk[:, 2:]
    lo = (qs & 0x0F).astype(np.int32) - 8
    hi = (qs >> 4).astype(np.int32) - 8
    vals = np.concatenate([lo, hi], axis=1).astype(np.float32) * d
    return vals.reshape(n_rows, row_len)


def quantize_q4_1(x: np.ndarray) -> np.ndarray:
    b = _blocks(x, 32)
    mn = b.min(axis=1)
    mx = b.max(axis=1)
    d = (mx - mn) / 15.0
    d16, m16 = _f16(d), _f16(mn)
    d = d16.astype(np.float32)
    mn = m16.astype(np.float32)
    inv = np.where(d != 0, 1.0 / np.where(d != 0, d, 1.0), 0.0)
    q = np.clip(((b - mn[:, None]) * inv[:, None] + 0.5).astype(np.int32), 0, 15).astype(np.uint8)
    out = np.empty((b.shape[0], 20), dtype=np.uint8)
    out[:, 0:2] = d16.view(np.uint8).reshape(-1, 2)
    out[:, 2:4] = m16.view(np.uint8).reshape(-1, 2)
    out[:, 4:] = q[:, :16] | (q[:, 16:] << 4)
    return out.reshape(-1)


def dequantize_q4_1(data: np.ndarray, n_rows: int, row_len: int) -> np.ndarray:
    blk = data.reshape(-1, 20)
    d = _f16_col(blk, 0, 2)[:, None]
    m = _f16_col(blk, 2, 4)[:, None]
    qs = blk[:, 4:]
    lo = (qs & 0x0F).astype(np.float32)
    hi = (qs >> 4).astype(np.float32)
    vals = np.concatenate([lo, hi], axis=1) * d + m
    return vals.reshape(n_rows, row_len)


def quantize_q5_0(x: np.ndarray) -> np.ndarray:
    b = _blocks(x, 32)
    idx = np.abs(b).argmax(axis=1)
    vmax = b[np.arange(b.shape[0]), idx]
    d = vmax / -16.0
    d16 = _f16(d)
    d = d16.astype(np.float32)
    inv = np.where(d != 0, 1.0 / np.where(d != 0, d, 1.0), 0.0)
    q = np.clip((b * inv[:, None] + 16.5).astype(np.int32), 0, 31).astype(np.uint8)
    qh = np.zeros(b.shape[0], dtype=np.uint32)
    for j in range(32):
        qh |= ((q[:, j].astype(np.uint32) >> 4) & 1) << j
    out = np.empty((b.shape[0], 22), dtype=np.uint8)
    out[:, 0:2] = d16.view(np.uint8).reshape(-1, 2)
    out[:, 2:6] = qh.view(np.uint8).reshape(-1, 4)
    out[:, 6:] = (q[:, :16] & 0xF) | ((q[:, 16:] & 0xF) << 4)
    return out.reshape(-1)


def _unpack_q5_bits(blk_qh: np.ndarray, blk_qs: np.ndarray) -> np.ndarray:
    """Return integer values 0..31 for 32-element blocks given qh u32 + qs bytes."""
    qh = blk_qh.astype(np.uint32)
    lo = (blk_qs & 0x0F).astype(np.int32)
    hi = (blk_qs >> 4).astype(np.int32)
    j = np.arange(16)
    bit_lo = ((qh[:, None] >> j[None, :]) & 1).astype(np.int32) << 4
    bit_hi = ((qh[:, None] >> (j[None, :] + 16)) & 1).astype(np.int32) << 4
    return np.concatenate([lo | bit_lo, hi | bit_hi], axis=1)


def dequantize_q5_0(data: np.ndarray, n_rows: int, row_len: int) -> np.ndarray:
    blk = data.reshape(-1, 22)
    d = _f16_col(blk, 0, 2)[:, None]
    qh = blk[:, 2:6].copy().view(np.uint32).reshape(-1)
    q = _unpack_q5_bits(qh, blk[:, 6:])
    return ((q - 16).astype(np.float32) * d).reshape(n_rows, row_len)


def quantize_q5_1(x: np.ndarray) -> np.ndarray:
    b = _blocks(x, 32)
    mn, mx = b.min(axis=1), b.max(axis=1)
    d = (mx - mn) / 31.0
    d16, m16 = _f16(d), _f16(mn)
    d = d16.astype(np.float32)
    mn = m16.astype(np.float32)
    inv = np.where(d != 0, 1.0 / np.where(d != 0, d, 1.0), 0.0)
    q = np.clip(((b - mn[:, None]) * inv[:, None] + 0.5).astype(np.int32), 0, 31).astype(np.uint8)
    qh = np.zeros(b.shape[0], dtype=np.uint32)
    for j in range(32):
        qh |= ((q[:, j].astype(np.uint32) >> 4) & 1) << j
    out = np.empty((b.shape[0], 24), dtype=np.uint8)
    out[:, 0:2] = d16.view(np.uint8).reshape(-1, 2)
    out[:, 2:4] = m16.view(np.uint8).reshape(-1, 2)
    out[:, 4:8] = qh.view(np.uint8).reshape(-1, 4)
    out[:, 8:] = (q[:, :16] & 0xF) | ((q[:, 16:] & 0xF) << 4)
    return out.reshape(-1)


def dequantize_q5_1(data: np.ndarray, n_rows: int, row_len: int) -> np.ndarray:
    blk = data.reshape(-1, 24)
    d = _f16_col(blk, 0, 2)[:, None]
    m = _f16_col(blk, 2, 4)[:, None]
    qh = blk[:, 4:8].copy().view(np.uint32).reshape(-1)
    q = _unpack_q5_bits(qh, blk[:, 8:])
    return (q.astype(np.float32) * d + m).reshape(n_rows, row_len)


# ---------------------------------------------------------------------------
# K-quants: 256-element superblocks
# ---------------------------------------------------------------------------

def _pack_scale_min_k4(sc: np.ndarray, mn: np.ndarray) -> np.ndarray:
    """Pack 8x 6-bit scales + 8x 6-bit mins into 12 bytes (Q4_K/Q5_K layout)."""
    n = sc.shape[0]
    scales = np.zeros((n, 12), dtype=np.uint8)
    sc = sc.astype(np.uint8)
    mn = mn.astype(np.uint8)
    for j in range(8):
        if j < 4:
            scales[:, j] = sc[:, j] & 63
            scales[:, j + 4] = mn[:, j] & 63
        else:
            scales[:, j + 4] = (sc[:, j] & 0xF) | ((mn[:, j] & 0xF) << 4)
            scales[:, j - 4] |= (sc[:, j] >> 4) << 6
            scales[:, j] |= (mn[:, j] >> 4) << 6
    return scales


def _unpack_scale_min_k4(scales: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of _pack_scale_min_k4. scales: (n, 12) uint8 -> (n, 8), (n, 8)."""
    n = scales.shape[0]
    sc = np.zeros((n, 8), dtype=np.int32)
    mn = np.zeros((n, 8), dtype=np.int32)
    q = scales.astype(np.int32)
    for j in range(8):
        if j < 4:
            sc[:, j] = q[:, j] & 63
            mn[:, j] = q[:, j + 4] & 63
        else:
            sc[:, j] = (q[:, j + 4] & 0xF) | ((q[:, j - 4] >> 6) << 4)
            mn[:, j] = (q[:, j + 4] >> 4) | ((q[:, j] >> 6) << 4)
    return sc, mn


def _kquant_affine_params(b: np.ndarray, nsub: int, qmax: int):
    """Per-sub-block affine quantization params for Q4_K/Q5_K style formats.

    Returns (d, dmin, sc, mn) with value ≈ d*sc*q - dmin*mn, q ∈ [0, qmax].
    """
    nb = b.shape[0]
    sub = b.reshape(nb, nsub, -1)
    smin = np.minimum(sub.min(axis=2), 0.0)          # ≤ 0
    smax = np.maximum(sub.max(axis=2), 0.0)
    scale = (smax - smin) / qmax                     # ≥ 0 per sub-block
    neg_min = -smin                                  # ≥ 0
    d = scale.max(axis=1) / 63.0
    dmin = neg_min.max(axis=1) / 63.0
    inv_d = np.where(d > 0, 1.0 / np.where(d > 0, d, 1.0), 0.0)
    inv_m = np.where(dmin > 0, 1.0 / np.where(dmin > 0, dmin, 1.0), 0.0)
    sc = np.clip(_nearest_int(scale * inv_d[:, None]), 0, 63)
    mn = np.clip(_nearest_int(neg_min * inv_m[:, None]), 0, 63)
    d16 = _f16(d)
    dmin16 = _f16(dmin)
    return d16, dmin16, sc, mn, sub


def quantize_q4_k(x: np.ndarray) -> np.ndarray:
    b = _blocks(x, QK_K)
    d16, dmin16, sc, mn, sub = _kquant_affine_params(b, 8, 15)
    d = d16.astype(np.float32)[:, None]
    dmin = dmin16.astype(np.float32)[:, None]
    eff_scale = d * sc            # (nb, 8)
    eff_min = dmin * mn
    inv = np.where(eff_scale > 0, 1.0 / np.where(eff_scale > 0, eff_scale, 1.0), 0.0)
    q = np.clip(_nearest_int((sub + eff_min[:, :, None]) * inv[:, :, None]), 0, 15).astype(np.uint8)
    q = q.reshape(b.shape[0], QK_K)
    nb = b.shape[0]
    out = np.empty((nb, 144), dtype=np.uint8)
    out[:, 0:2] = d16.view(np.uint8).reshape(-1, 2)
    out[:, 2:4] = dmin16.view(np.uint8).reshape(-1, 2)
    out[:, 4:16] = _pack_scale_min_k4(sc, mn)
    qs = out[:, 16:]
    for c in range(4):  # 64-element chunks
        chunk = q[:, 64 * c: 64 * (c + 1)]
        qs[:, 32 * c: 32 * (c + 1)] = chunk[:, :32] | (chunk[:, 32:] << 4)
    return out.reshape(-1)


def dequantize_q4_k(data: np.ndarray, n_rows: int, row_len: int) -> np.ndarray:
    blk = data.reshape(-1, 144)
    nb = blk.shape[0]
    d = _f16_col(blk, 0, 2)
    dmin = _f16_col(blk, 2, 4)
    sc, mn = _unpack_scale_min_k4(blk[:, 4:16])
    qs = blk[:, 16:]
    y = np.empty((nb, QK_K), dtype=np.float32)
    for c in range(4):
        lo = (qs[:, 32 * c: 32 * (c + 1)] & 0x0F).astype(np.float32)
        hi = (qs[:, 32 * c: 32 * (c + 1)] >> 4).astype(np.float32)
        d1 = (d * sc[:, 2 * c])[:, None]
        m1 = (dmin * mn[:, 2 * c])[:, None]
        d2 = (d * sc[:, 2 * c + 1])[:, None]
        m2 = (dmin * mn[:, 2 * c + 1])[:, None]
        y[:, 64 * c: 64 * c + 32] = d1 * lo - m1
        y[:, 64 * c + 32: 64 * c + 64] = d2 * hi - m2
    return y.reshape(n_rows, row_len)


def quantize_q5_k(x: np.ndarray) -> np.ndarray:
    b = _blocks(x, QK_K)
    d16, dmin16, sc, mn, sub = _kquant_affine_params(b, 8, 31)
    d = d16.astype(np.float32)[:, None]
    dmin = dmin16.astype(np.float32)[:, None]
    eff_scale = d * sc
    eff_min = dmin * mn
    inv = np.where(eff_scale > 0, 1.0 / np.where(eff_scale > 0, eff_scale, 1.0), 0.0)
    q = np.clip(_nearest_int((sub + eff_min[:, :, None]) * inv[:, :, None]), 0, 31).astype(np.uint8)
    q = q.reshape(b.shape[0], QK_K)
    nb = b.shape[0]
    out = np.zeros((nb, 176), dtype=np.uint8)
    out[:, 0:2] = d16.view(np.uint8).reshape(-1, 2)
    out[:, 2:4] = dmin16.view(np.uint8).reshape(-1, 2)
    out[:, 4:16] = _pack_scale_min_k4(sc, mn)
    qh = out[:, 16:48]
    qs = out[:, 48:]
    for c in range(4):
        chunk = q[:, 64 * c: 64 * (c + 1)]
        qs[:, 32 * c: 32 * (c + 1)] = (chunk[:, :32] & 0xF) | ((chunk[:, 32:] & 0xF) << 4)
        qh[:, :] |= ((chunk[:, :32] >> 4) & 1) << (2 * c)
        qh[:, :] |= ((chunk[:, 32:] >> 4) & 1) << (2 * c + 1)
    return out.reshape(-1)


def dequantize_q5_k(data: np.ndarray, n_rows: int, row_len: int) -> np.ndarray:
    blk = data.reshape(-1, 176)
    nb = blk.shape[0]
    d = _f16_col(blk, 0, 2)
    dmin = _f16_col(blk, 2, 4)
    sc, mn = _unpack_scale_min_k4(blk[:, 4:16])
    qh = blk[:, 16:48]
    qs = blk[:, 48:]
    y = np.empty((nb, QK_K), dtype=np.float32)
    for c in range(4):
        lo = (qs[:, 32 * c: 32 * (c + 1)] & 0x0F).astype(np.int32)
        hi = (qs[:, 32 * c: 32 * (c + 1)] >> 4).astype(np.int32)
        lo |= ((qh >> (2 * c)) & 1).astype(np.int32) << 4
        hi |= ((qh >> (2 * c + 1)) & 1).astype(np.int32) << 4
        d1 = (d * sc[:, 2 * c])[:, None]
        m1 = (dmin * mn[:, 2 * c])[:, None]
        d2 = (d * sc[:, 2 * c + 1])[:, None]
        m2 = (dmin * mn[:, 2 * c + 1])[:, None]
        y[:, 64 * c: 64 * c + 32] = d1 * lo.astype(np.float32) - m1
        y[:, 64 * c + 32: 64 * c + 64] = d2 * hi.astype(np.float32) - m2
    return y.reshape(n_rows, row_len)


def quantize_q6_k(x: np.ndarray) -> np.ndarray:
    b = _blocks(x, QK_K)
    nb = b.shape[0]
    sub = b.reshape(nb, 16, 16)
    # per-sub-block symmetric scale; int8 super-scale encoding
    amax = np.abs(sub).max(axis=2)
    s = amax / 31.0                                 # q-32 in [-32,31]
    d = s.max(axis=1) / 127.0
    d16 = _f16(d)
    d = d16.astype(np.float32)
    inv_d = np.where(d > 0, 1.0 / np.where(d > 0, d, 1.0), 0.0)
    sc = np.clip(_nearest_int(s * inv_d[:, None]), -128, 127).astype(np.int8)
    eff = d[:, None] * sc.astype(np.float32)        # (nb, 16)
    inv = np.where(eff != 0, 1.0 / np.where(eff != 0, eff, 1.0), 0.0)
    q = np.clip(_nearest_int(sub * inv[:, :, None]) + 32, 0, 63).astype(np.uint8)
    q = q.reshape(nb, QK_K)
    out = np.empty((nb, 210), dtype=np.uint8)
    ql = out[:, 0:128]
    qh = out[:, 128:192]
    for h in range(2):  # halves of 128
        qq = q[:, 128 * h: 128 * (h + 1)]
        q1, q2, q3, q4 = qq[:, 0:32], qq[:, 32:64], qq[:, 64:96], qq[:, 96:128]
        ql[:, 64 * h: 64 * h + 32] = (q1 & 0xF) | ((q3 & 0xF) << 4)
        ql[:, 64 * h + 32: 64 * h + 64] = (q2 & 0xF) | ((q4 & 0xF) << 4)
        qh[:, 32 * h: 32 * (h + 1)] = (
            (q1 >> 4) | ((q2 >> 4) << 2) | ((q3 >> 4) << 4) | ((q4 >> 4) << 6)
        )
    out[:, 192:208] = sc.view(np.uint8)
    out[:, 208:210] = d16.view(np.uint8).reshape(-1, 2)
    return out.reshape(-1)


def dequantize_q6_k(data: np.ndarray, n_rows: int, row_len: int) -> np.ndarray:
    blk = data.reshape(-1, 210)
    nb = blk.shape[0]
    ql = blk[:, 0:128]
    qh = blk[:, 128:192]
    sc = blk[:, 192:208].view(np.int8).astype(np.float32)
    d = _f16_col(blk, 208, 210)[:, None]
    y = np.empty((nb, QK_K), dtype=np.float32)
    l16 = np.arange(32) // 16  # sub-block index within a 32-chunk (0 or 1)
    for h in range(2):
        lql = ql[:, 64 * h: 64 * h + 32]
        lql2 = ql[:, 64 * h + 32: 64 * h + 64]
        lqh = qh[:, 32 * h: 32 * (h + 1)].astype(np.int32)
        q1 = (lql & 0xF).astype(np.int32) | ((lqh & 3) << 4)
        q2 = (lql2 & 0xF).astype(np.int32) | (((lqh >> 2) & 3) << 4)
        q3 = (lql >> 4).astype(np.int32) | (((lqh >> 4) & 3) << 4)
        q4 = (lql2 >> 4).astype(np.int32) | (((lqh >> 6) & 3) << 4)
        base = 8 * h
        s1 = sc[:, base + l16]
        s2 = sc[:, base + 2 + l16]
        s3 = sc[:, base + 4 + l16]
        s4 = sc[:, base + 6 + l16]
        y[:, 128 * h + 0: 128 * h + 32] = d * s1 * (q1 - 32)
        y[:, 128 * h + 32: 128 * h + 64] = d * s2 * (q2 - 32)
        y[:, 128 * h + 64: 128 * h + 96] = d * s3 * (q3 - 32)
        y[:, 128 * h + 96: 128 * h + 128] = d * s4 * (q4 - 32)
    return y.reshape(n_rows, row_len)


def quantize_q2_k(x: np.ndarray) -> np.ndarray:
    """2-bit K-quant: 16 sub-blocks of 16 with 4-bit scale + 4-bit min each
    (valid encoder; decoder layout is the compatibility contract)."""
    b = _blocks(x, QK_K)
    nb = b.shape[0]
    sub = b.reshape(nb, 16, 16)
    smin = np.minimum(sub.min(axis=2), 0.0)
    smax = np.maximum(sub.max(axis=2), 0.0)
    scale = (smax - smin) / 3.0
    neg_min = -smin
    d = scale.max(axis=1) / 15.0
    dmin = neg_min.max(axis=1) / 15.0
    d16, dmin16 = _f16(d), _f16(dmin)
    d = d16.astype(np.float32)
    dmin = dmin16.astype(np.float32)
    inv_d = np.where(d > 0, 1.0 / np.where(d > 0, d, 1.0), 0.0)
    inv_m = np.where(dmin > 0, 1.0 / np.where(dmin > 0, dmin, 1.0), 0.0)
    sc = np.clip(_nearest_int(scale * inv_d[:, None]), 0, 15)
    mn = np.clip(_nearest_int(neg_min * inv_m[:, None]), 0, 15)
    eff_scale = d[:, None] * sc
    eff_min = dmin[:, None] * mn
    inv = np.where(eff_scale > 0, 1.0 / np.where(eff_scale > 0, eff_scale, 1.0), 0.0)
    q = np.clip(_nearest_int((sub + eff_min[:, :, None]) * inv[:, :, None]),
                0, 3).astype(np.uint8)                     # (nb, 16, 16)
    out = np.zeros((nb, 84), dtype=np.uint8)
    out[:, 0:16] = (sc | (mn << 4)).astype(np.uint8)
    qs = out[:, 16:80]
    # byte l of 32-byte group h holds sub-blocks 8h+2j (+1) at bit 2j
    for h in range(2):
        for j in range(4):
            qs[:, 32 * h: 32 * h + 16] |= q[:, 8 * h + 2 * j] << (2 * j)
            qs[:, 32 * h + 16: 32 * h + 32] |= q[:, 8 * h + 2 * j + 1] << (2 * j)
    out[:, 80:82] = d16.view(np.uint8).reshape(-1, 2)
    out[:, 82:84] = dmin16.view(np.uint8).reshape(-1, 2)
    return out.reshape(-1)


def dequantize_q2_k(data: np.ndarray, n_rows: int, row_len: int) -> np.ndarray:
    blk = data.reshape(-1, 84)
    nb = blk.shape[0]
    scales = blk[:, 0:16]
    qs = blk[:, 16:80]
    d = _f16_col(blk, 80, 82)
    dmin = _f16_col(blk, 82, 84)
    dl = d[:, None] * (scales & 0xF).astype(np.float32)    # (nb, 16)
    ml = dmin[:, None] * (scales >> 4).astype(np.float32)
    y = np.empty((nb, QK_K), dtype=np.float32)
    for h in range(2):
        qb = qs[:, 32 * h: 32 * (h + 1)]
        for j in range(4):
            for half16 in range(2):
                s = 8 * h + 2 * j + half16
                qv = ((qb[:, 16 * half16: 16 * half16 + 16] >> (2 * j)) & 3)
                y[:, 16 * s: 16 * (s + 1)] = (
                    dl[:, s, None] * qv.astype(np.float32) - ml[:, s, None])
    return y.reshape(n_rows, row_len)


def _q3k_unpack_scales(s: np.ndarray) -> np.ndarray:
    """12 packed bytes -> 16 6-bit scales (as int32, stored-value form;
    usage subtracts 32). Mirrors ggml's kmask bit shuffle."""
    s = s.astype(np.int32)
    o = np.empty(s.shape[:-1] + (16,), dtype=np.int32)
    lo, hi, top = s[..., 0:4], s[..., 4:8], s[..., 8:12]
    o[..., 0:4] = (lo & 0xF) | ((top & 3) << 4)
    o[..., 4:8] = (hi & 0xF) | (((top >> 2) & 3) << 4)
    o[..., 8:12] = (lo >> 4) | (((top >> 4) & 3) << 4)
    o[..., 12:16] = (hi >> 4) | (((top >> 6) & 3) << 4)
    return o


def _q3k_pack_scales(sc: np.ndarray) -> np.ndarray:
    """Inverse of _q3k_unpack_scales: 16 6-bit values -> 12 bytes."""
    sc = sc.astype(np.uint32)
    out = np.zeros(sc.shape[:-1] + (12,), dtype=np.uint8)
    out[..., 0:4] = ((sc[..., 0:4] & 0xF) | ((sc[..., 8:12] & 0xF) << 4)).astype(np.uint8)
    out[..., 4:8] = ((sc[..., 4:8] & 0xF) | ((sc[..., 12:16] & 0xF) << 4)).astype(np.uint8)
    out[..., 8:12] = ((sc[..., 0:4] >> 4) | ((sc[..., 4:8] >> 4) << 2)
                      | ((sc[..., 8:12] >> 4) << 4)
                      | ((sc[..., 12:16] >> 4) << 6)).astype(np.uint8)
    return out


def quantize_q3_k(x: np.ndarray) -> np.ndarray:
    """3-bit K-quant: 16 sub-blocks of 16, 6-bit signed scales (stored +32),
    values in [-4, 3] split as 2 low bits (qs) + 1 high bit (hmask)."""
    b = _blocks(x, QK_K)
    nb = b.shape[0]
    sub = b.reshape(nb, 16, 16)
    # signed-max scale: map the extreme value to -4 exactly (the asymmetric
    # [-4, 3] range wastes a level under a plain amax/4 scale; the signed
    # 6-bit sc absorbs the sign, same trick as Q4_0's vmax/-8)
    idx = np.abs(sub).argmax(axis=2)
    vmax = np.take_along_axis(sub, idx[:, :, None], axis=2)[:, :, 0]
    s = vmax / -4.0
    d = np.abs(s).max(axis=1) / 31.0
    d16 = _f16(d)
    d = d16.astype(np.float32)
    inv_d = np.where(d > 0, 1.0 / np.where(d > 0, d, 1.0), 0.0)
    sc = np.clip(_nearest_int(s * inv_d[:, None]), -32, 31)
    eff = d[:, None] * sc.astype(np.float32)
    inv = np.where(eff != 0, 1.0 / np.where(eff != 0, eff, 1.0), 0.0)
    q = (np.clip(_nearest_int(sub * inv[:, :, None]), -4, 3) + 4).astype(np.uint8)
    out = np.zeros((nb, 110), dtype=np.uint8)
    hmask = out[:, 0:32]
    qs = out[:, 32:96]
    for h in range(2):
        for j in range(4):
            for half16 in range(2):
                sidx = 8 * h + 2 * j + half16
                qv = q[:, sidx]                       # (nb, 16), values 0..7
                qs[:, 32 * h + 16 * half16: 32 * h + 16 * half16 + 16] |= (
                    (qv & 3) << (2 * j))
                hmask[:, 16 * half16: 16 * half16 + 16] |= (
                    (qv >> 2) << (4 * h + j))
    out[:, 96:108] = _q3k_pack_scales(sc + 32)
    out[:, 108:110] = d16.view(np.uint8).reshape(-1, 2)
    return out.reshape(-1)


def dequantize_q3_k(data: np.ndarray, n_rows: int, row_len: int) -> np.ndarray:
    blk = data.reshape(-1, 110)
    nb = blk.shape[0]
    hmask = blk[:, 0:32]
    qs = blk[:, 32:96]
    sc = _q3k_unpack_scales(blk[:, 96:108]) - 32            # (nb, 16)
    d = _f16_col(blk, 108, 110)
    dl = d[:, None] * sc.astype(np.float32)
    y = np.empty((nb, QK_K), dtype=np.float32)
    for h in range(2):
        qb = qs[:, 32 * h: 32 * (h + 1)]
        for j in range(4):
            mbit = 4 * h + j
            for half16 in range(2):
                s = 8 * h + 2 * j + half16
                lo = ((qb[:, 16 * half16: 16 * half16 + 16] >> (2 * j)) & 3).astype(np.int32)
                hi = ((hmask[:, 16 * half16: 16 * half16 + 16] >> mbit) & 1).astype(np.int32)
                qv = lo - np.where(hi == 1, 0, 4)
                y[:, 16 * s: 16 * (s + 1)] = dl[:, s, None] * qv.astype(np.float32)
    return y.reshape(n_rows, row_len)


def quantize_q8_k(x: np.ndarray) -> np.ndarray:
    """Q8_K: 256-elem blocks, f32 scale + int8 values + per-16 bsums (the
    K-quant dot-product activation format; storable like any other type)."""
    b = _blocks(x, QK_K)
    amax = np.abs(b).max(axis=1)
    d = (amax / 127.0).astype(np.float32)
    inv = np.where(d > 0, 1.0 / np.where(d > 0, d, 1.0), 0.0)
    q = np.clip(_nearest_int(b * inv[:, None]), -128, 127).astype(np.int8)
    bsums = q.astype(np.int32).reshape(-1, 16, 16).sum(axis=2)
    out = np.empty((b.shape[0], 292), dtype=np.uint8)
    out[:, 0:4] = d.view(np.uint8).reshape(-1, 4)
    out[:, 4:260] = q.view(np.uint8)
    out[:, 260:292] = bsums.astype(np.int16).view(np.uint8).reshape(-1, 32)
    return out.reshape(-1)


def dequantize_q8_k(data: np.ndarray, n_rows: int, row_len: int) -> np.ndarray:
    blk = data.reshape(-1, 292)
    d = blk[:, 0:4].copy().view(np.float32).reshape(-1, 1)
    q = blk[:, 4:260].view(np.int8).astype(np.float32)
    return (q * d).reshape(n_rows, row_len)


# non-linear 4-bit codebook shared by IQ4_NL and IQ4_XS (public ggml LUT)
KVALUES_IQ4NL = np.array(
    [-127, -104, -83, -65, -49, -35, -22, -10, 1, 13, 25, 38, 53, 69, 89, 113],
    dtype=np.int8)


def _nearest_iq4_index(t: np.ndarray) -> np.ndarray:
    """Index of the nearest KVALUES_IQ4NL entry for each element of t."""
    kv = KVALUES_IQ4NL.astype(np.float32)
    edges = (kv[:-1] + kv[1:]) / 2.0
    return np.searchsorted(edges, t).astype(np.uint8)


def quantize_iq4_nl(x: np.ndarray) -> np.ndarray:
    """IQ4_NL: 32-elem blocks, fp16 scale + 4-bit indices into the shared
    non-linear codebook (valid nearest-codeword encoder; llama.cpp's scale
    search is not required for decode compatibility)."""
    b = _blocks(x, 32)
    amax = np.abs(b).max(axis=1)
    d = (amax / 127.0).astype(np.float32)
    d16 = _f16(d)
    d = d16.astype(np.float32)
    inv = np.where(d > 0, 1.0 / np.where(d > 0, d, 1.0), 0.0)
    idx = _nearest_iq4_index(b * inv[:, None])
    out = np.empty((b.shape[0], 18), dtype=np.uint8)
    out[:, 0:2] = d16.view(np.uint8).reshape(-1, 2)
    out[:, 2:] = idx[:, :16] | (idx[:, 16:] << 4)
    return out.reshape(-1)


def dequantize_iq4_nl(data: np.ndarray, n_rows: int, row_len: int) -> np.ndarray:
    blk = data.reshape(-1, 18)
    d = _f16_col(blk, 0, 2)[:, None]
    qs = blk[:, 2:]
    kv = KVALUES_IQ4NL.astype(np.float32)
    lo = kv[(qs & 0x0F).astype(np.intp)]
    hi = kv[(qs >> 4).astype(np.intp)]
    return (np.concatenate([lo, hi], axis=1) * d).reshape(n_rows, row_len)


def quantize_iq4_xs(x: np.ndarray) -> np.ndarray:
    """IQ4_XS: 256-elem superblocks, 8 sub-blocks of 32 sharing the IQ4_NL
    codebook, 6-bit per-sub scales (stored-value - 32) under an fp16 super
    scale."""
    b = _blocks(x, QK_K)
    nb = b.shape[0]
    sub = b.reshape(nb, 8, 32)
    amax = np.abs(sub).max(axis=2)
    t = amax / 127.0                       # ideal per-sub scale
    d = t.max(axis=1) / 31.0
    d16 = _f16(d)
    d = d16.astype(np.float32)
    inv_d = np.where(d > 0, 1.0 / np.where(d > 0, d, 1.0), 0.0)
    ls = np.clip(_nearest_int(t * inv_d[:, None]), 0, 31) + 32   # stored 32..63
    dl = d[:, None] * (ls - 32).astype(np.float32)
    inv = np.where(dl > 0, 1.0 / np.where(dl > 0, dl, 1.0), 0.0)
    idx = _nearest_iq4_index(sub * inv[:, :, None])              # (nb, 8, 32)
    out = np.zeros((nb, 136), dtype=np.uint8)
    out[:, 0:2] = d16.view(np.uint8).reshape(-1, 2)
    scales_h = np.zeros(nb, dtype=np.uint32)
    for ib in range(8):
        scales_h |= ((ls[:, ib].astype(np.uint32) >> 4) & 3) << (2 * ib)
        out[:, 4 + ib // 2] |= ((ls[:, ib] & 0xF) << (4 * (ib % 2))).astype(np.uint8)
        out[:, 8 + 16 * ib: 8 + 16 * (ib + 1)] = (
            idx[:, ib, :16] | (idx[:, ib, 16:] << 4))
    out[:, 2:4] = scales_h.astype(np.uint16).view(np.uint8).reshape(-1, 2)
    return out.reshape(-1)


def dequantize_iq4_xs(data: np.ndarray, n_rows: int, row_len: int) -> np.ndarray:
    blk = data.reshape(-1, 136)
    nb = blk.shape[0]
    d = _f16_col(blk, 0, 2)
    scales_h = blk[:, 2:4].copy().view(np.uint16).astype(np.int32).reshape(-1)
    kv = KVALUES_IQ4NL.astype(np.float32)
    y = np.empty((nb, QK_K), dtype=np.float32)
    for ib in range(8):
        ls = (((blk[:, 4 + ib // 2] >> (4 * (ib % 2))) & 0xF).astype(np.int32)
              | (((scales_h >> (2 * ib)) & 3) << 4))
        dl = (d * (ls - 32))[:, None]
        qs = blk[:, 8 + 16 * ib: 8 + 16 * (ib + 1)]
        lo = kv[(qs & 0x0F).astype(np.intp)]
        hi = kv[(qs >> 4).astype(np.intp)]
        y[:, 32 * ib: 32 * ib + 16] = dl * lo
        y[:, 32 * ib + 16: 32 * (ib + 1)] = dl * hi
    return y.reshape(n_rows, row_len)


# ---------------------------------------------------------------------------
# plain float formats
# ---------------------------------------------------------------------------

def _bf16_to_f32(u16: np.ndarray) -> np.ndarray:
    return (u16.astype(np.uint32) << 16).view(np.float32)


def _f32_to_bf16(x: np.ndarray) -> np.ndarray:
    u = x.astype(np.float32).view(np.uint32)
    # round-to-nearest-even on the mantissa
    rounding = ((u >> 16) & 1) + 0x7FFF
    return ((u + rounding) >> 16).astype(np.uint16)


# ---------------------------------------------------------------------------
# dispatch tables
# ---------------------------------------------------------------------------

_QUANTIZERS = {
    GGMLType.Q8_0: quantize_q8_0,
    GGMLType.Q4_0: quantize_q4_0,
    GGMLType.Q4_1: quantize_q4_1,
    GGMLType.Q5_0: quantize_q5_0,
    GGMLType.Q5_1: quantize_q5_1,
    GGMLType.Q4_K: quantize_q4_k,
    GGMLType.Q5_K: quantize_q5_k,
    GGMLType.Q6_K: quantize_q6_k,
    GGMLType.Q2_K: quantize_q2_k,
    GGMLType.Q3_K: quantize_q3_k,
    GGMLType.Q8_K: quantize_q8_k,
    GGMLType.IQ4_NL: quantize_iq4_nl,
    GGMLType.IQ4_XS: quantize_iq4_xs,
}

_DEQUANTIZERS = {
    GGMLType.Q8_0: dequantize_q8_0,
    GGMLType.Q4_0: dequantize_q4_0,
    GGMLType.Q4_1: dequantize_q4_1,
    GGMLType.Q5_0: dequantize_q5_0,
    GGMLType.Q5_1: dequantize_q5_1,
    GGMLType.Q4_K: dequantize_q4_k,
    GGMLType.Q5_K: dequantize_q5_k,
    GGMLType.Q6_K: dequantize_q6_k,
    GGMLType.Q2_K: dequantize_q2_k,
    GGMLType.Q3_K: dequantize_q3_k,
    GGMLType.Q8_K: dequantize_q8_k,
    GGMLType.IQ4_NL: dequantize_iq4_nl,
    GGMLType.IQ4_XS: dequantize_iq4_xs,
}


def quantize(x: np.ndarray, t: GGMLType) -> np.ndarray:
    """Quantize a 2-D float array (n_rows, row_len) to packed GGUF bytes."""
    x = np.asarray(x)
    if x.ndim == 1:
        x = x[None, :]
    if t == GGMLType.F32:
        return np.ascontiguousarray(x, dtype=np.float32).view(np.uint8).reshape(-1)
    if t == GGMLType.F16:
        return np.ascontiguousarray(x, dtype=np.float16).view(np.uint8).reshape(-1)
    if t == GGMLType.BF16:
        return _f32_to_bf16(np.ascontiguousarray(x, dtype=np.float32)).view(np.uint8).reshape(-1)
    try:
        fn = _QUANTIZERS[t]
    except KeyError:
        raise NotImplementedError(f"no quantizer for {t!r}") from None
    return fn(x)


def dequantize(data: np.ndarray, t: GGMLType, shape: tuple[int, ...]) -> np.ndarray:
    """Dequantize packed GGUF bytes to float32 with numpy `shape`.

    `shape` is the numpy (row-major) shape, i.e. reversed ggml ne; the last
    axis is the quantized row.
    """
    data = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray, memoryview)) else data
    n_elements = int(np.prod(shape)) if shape else 1
    row_len = shape[-1] if shape else 1
    n_rows = n_elements // row_len
    if t == GGMLType.F32:
        return data.view(np.float32).reshape(shape).astype(np.float32)
    if t == GGMLType.F16:
        return data.view(np.float16).reshape(shape).astype(np.float32)
    if t == GGMLType.BF16:
        return _bf16_to_f32(data.view(np.uint16)).reshape(shape)
    try:
        fn = _DEQUANTIZERS[t]
    except KeyError:
        raise NotImplementedError(f"no dequantizer for {t!r}") from None
    return fn(data, n_rows, row_len).reshape(shape)
