"""GGML block-quantization formats the port reads: F32, F16 and Q4_K.

Vectorized numpy reference implementations (copied from the JAX package's
host code, which the port does not import). Bit layouts follow the public
GGML/GGUF spec, so existing GGUF files load unmodified. Every other GGML type
raises NotImplementedError until the engine that serves it is ported
(ROADMAP.md §1 item 9).

Conventions:
  * A tensor's quantization runs along its *row* (ggml ne[0], the contiguous
    dimension). All (de)quantize functions take/return 2-D arrays shaped
    (n_rows, row_len) and flat uint8 byte arrays.
  * The quantizer is a valid encoder for the format (dequant(quant(x)) ≈ x)
    but not bit-identical to llama.cpp's encoder search; the *decoder* layout
    is what the compatibility contract pins down.
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
# Q4_K: 256-element superblocks
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


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def _unsupported(t: GGMLType) -> NotImplementedError:
    return NotImplementedError(
        f"GGML type {t!r} is not supported by the port yet "
        "(ROADMAP.md §1 item 9, other engines)")


def quantize(x: np.ndarray, t: GGMLType) -> np.ndarray:
    """Quantize a 2-D float array (n_rows, row_len) to packed GGUF bytes."""
    x = np.asarray(x)
    if x.ndim == 1:
        x = x[None, :]
    if t == GGMLType.F32:
        return np.ascontiguousarray(x, dtype=np.float32).view(np.uint8).reshape(-1)
    if t == GGMLType.F16:
        return np.ascontiguousarray(x, dtype=np.float16).view(np.uint8).reshape(-1)
    if t == GGMLType.Q4_K:
        return quantize_q4_k(x)
    raise _unsupported(t)


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
    if t == GGMLType.Q4_K:
        return dequantize_q4_k(data, n_rows, row_len).reshape(shape)
    raise _unsupported(t)
