"""GGML block formats dequantized on the device (plain PyTorch).

The dense engines (`ModelParams(dtype="float32" | "bfloat16")`) load every
tensor as float, as the reference's `reader.tensor_float` does on its host.
At 8B that is 8 G values a load, too slow in host numpy (PERF.md §3 has
the two times, from tools/profile_load), so every type gguf/quants.py
dequantizes is dequantized here instead, on the tensor's own device, from
its GGUF bytes. Every function repeats its numpy counterpart in
gguf/quants.py operation for operation, in the dtype numpy computes it in
(numpy widens an f32 array times an int32 array to f64; so does this code,
where it happens there), so the values are bit-equal to the host's
(tests/test_torch_quants.py holds them so for every type, and chip_smoke.py
on the card).

A tensor is dequantized in slices of whole blocks, so a temporary holds at
most CHUNK values at a time.
"""

from __future__ import annotations

import numpy as np
import torch

from ..gguf.constants import GGML_BLOCK_INFO, GGMLType
from ..gguf.quants import KVALUES_IQ4NL

# values dequantized at a time (an f64 temporary of CHUNK values is 128 MiB)
CHUNK = 1 << 24


def _f16_col(blk: torch.Tensor, a: int) -> torch.Tensor:
    """The f16 scalar at bytes [a, a+2) of each block → f32 [nb]."""
    return blk[:, a:a + 2].contiguous().view(torch.float16).float().reshape(-1)


def _unpack_scale_min_k4(q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(nb, 12) uint8 → 6-bit scales and mins (nb, 8) int32
    (quants._unpack_scale_min_k4)."""
    q = q.to(torch.int32)
    lo_sc, lo_mn = q[:, 0:4] & 63, q[:, 4:8] & 63
    hi_sc = (q[:, 8:12] & 0xF) | ((q[:, 0:4] >> 6) << 4)
    hi_mn = (q[:, 8:12] >> 4) | ((q[:, 4:8] >> 6) << 4)
    return torch.cat([lo_sc, hi_sc], 1), torch.cat([lo_mn, hi_mn], 1)


def _nibbles(qs: torch.Tensor) -> torch.Tensor:
    """(nb, 16) packed bytes → (nb, 32) int32 codes: the low nibbles are
    elements 0..15, the high ones 16..31."""
    qs = qs.to(torch.int32)
    return torch.cat([qs & 0x0F, qs >> 4], 1)


def _q5_codes(qh: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """(nb, 4) little-endian u32 bytes of fifth bits and (nb, 16) nibbles →
    (nb, 32) codes 0..31 (quants._unpack_q5_bits)."""
    h = qh.to(torch.int64)
    h = h[:, 0] | (h[:, 1] << 8) | (h[:, 2] << 16) | (h[:, 3] << 24)
    bits = (h[:, None] >> torch.arange(32, device=qs.device)) & 1
    return _nibbles(qs) | (bits.to(torch.int32) << 4)


def _q4_0(blk: torch.Tensor) -> torch.Tensor:
    return (_nibbles(blk[:, 2:]) - 8).float() * _f16_col(blk, 0)[:, None]


def _q4_1(blk: torch.Tensor) -> torch.Tensor:
    return _nibbles(blk[:, 4:]).float() * _f16_col(blk, 0)[:, None] + _f16_col(blk, 2)[:, None]


def _q5_0(blk: torch.Tensor) -> torch.Tensor:
    return (_q5_codes(blk[:, 2:6], blk[:, 6:]) - 16).float() * _f16_col(blk, 0)[:, None]


def _q5_1(blk: torch.Tensor) -> torch.Tensor:
    return (_q5_codes(blk[:, 4:8], blk[:, 8:]).float() * _f16_col(blk, 0)[:, None]
            + _f16_col(blk, 2)[:, None])


def _q8_k(blk: torch.Tensor) -> torch.Tensor:
    d = blk[:, 0:4].contiguous().view(torch.float32)
    return blk[:, 4:260].contiguous().view(torch.int8).float() * d


def _iq4_values(device) -> torch.Tensor:
    return torch.tensor(KVALUES_IQ4NL, dtype=torch.float32, device=device)


def _iq4_nl(blk: torch.Tensor) -> torch.Tensor:
    return _iq4_values(blk.device)[_nibbles(blk[:, 2:]).long()] * _f16_col(blk, 0)[:, None]


def _iq4_xs(blk: torch.Tensor) -> torch.Tensor:
    """numpy: d (f32) times the int32 scale is f64, and so is its product
    with the codebook value until the store."""
    d = _f16_col(blk, 0).double()
    b = blk.to(torch.int32)
    sh = b[:, 2] | (b[:, 3] << 8)
    kv = _iq4_values(blk.device).double()
    parts = []
    for ib in range(8):
        ls = ((b[:, 4 + ib // 2] >> (4 * (ib % 2))) & 0xF) | (((sh >> (2 * ib)) & 3) << 4)
        dl = (d * (ls - 32).double())[:, None]
        parts.append(dl * kv[_nibbles(blk[:, 8 + 16 * ib: 8 + 16 * (ib + 1)]).long()])
    return torch.cat(parts, 1).float()


def _q8_0(blk: torch.Tensor) -> torch.Tensor:
    d = _f16_col(blk, 0)[:, None]
    q = blk[:, 2:].contiguous().view(torch.int8).float()
    return q * d


def _affine_k(blk: torch.Tensor, qs: torch.Tensor, qh: torch.Tensor | None) -> torch.Tensor:
    """Q4_K (qh None) and Q5_K: d·sc·q − dmin·mn over groups of 32, q a
    nibble of qs plus, for Q5_K, a fifth bit from qh. numpy computes d·sc
    (an f32 array times an int32 one) in f64, and so the rest until the
    store."""
    d, dmin = _f16_col(blk, 0).double(), _f16_col(blk, 2).double()
    sc, mn = _unpack_scale_min_k4(blk[:, 4:16])
    parts = []
    for c in range(4):
        q = qs[:, 32 * c: 32 * (c + 1)]
        lo, hi = q & 0x0F, q >> 4
        if qh is not None:
            lo = lo | (((qh >> (2 * c)) & 1) << 4)
            hi = hi | (((qh >> (2 * c + 1)) & 1) << 4)
        for j, v in ((2 * c, lo), (2 * c + 1, hi)):
            parts.append((d * sc[:, j])[:, None] * v.float().double()
                         - (dmin * mn[:, j])[:, None])
    return torch.cat(parts, 1).float()


def _q4_k(blk: torch.Tensor) -> torch.Tensor:
    return _affine_k(blk, blk[:, 16:].to(torch.int32), None)


def _q5_k(blk: torch.Tensor) -> torch.Tensor:
    return _affine_k(blk, blk[:, 48:].to(torch.int32), blk[:, 16:48].to(torch.int32))


def _q6_k(blk: torch.Tensor) -> torch.Tensor:
    ql = blk[:, 0:128].to(torch.int32)
    qh = blk[:, 128:192].to(torch.int32)
    sc = blk[:, 192:208].contiguous().view(torch.int8).float()
    d = _f16_col(blk, 208)[:, None]
    l16 = torch.arange(32, device=blk.device) // 16
    parts = []
    for h in range(2):
        lql, lql2 = ql[:, 64 * h: 64 * h + 32], ql[:, 64 * h + 32: 64 * h + 64]
        lqh = qh[:, 32 * h: 32 * (h + 1)]
        qv = ((lql & 0xF) | ((lqh & 3) << 4), (lql2 & 0xF) | (((lqh >> 2) & 3) << 4),
              (lql >> 4) | (((lqh >> 4) & 3) << 4), (lql2 >> 4) | (((lqh >> 6) & 3) << 4))
        for i, q in enumerate(qv):
            # numpy: d * s (f32) times the int32 codes, in f64
            parts.append((d * sc[:, 8 * h + 2 * i + l16]).double() * (q - 32).double())
    return torch.cat(parts, 1).float()


def _q2_k(blk: torch.Tensor) -> torch.Tensor:
    scales = blk[:, 0:16].to(torch.int32)
    qs = blk[:, 16:80].to(torch.int32)
    d, dmin = _f16_col(blk, 80)[:, None], _f16_col(blk, 82)[:, None]
    dl = d * (scales & 0xF).float()
    ml = dmin * (scales >> 4).float()
    parts = [None] * 16
    for h in range(2):
        qb = qs[:, 32 * h: 32 * (h + 1)]
        for j in range(4):
            for half in range(2):
                s = 8 * h + 2 * j + half
                qv = (qb[:, 16 * half: 16 * half + 16] >> (2 * j)) & 3
                parts[s] = dl[:, s, None] * qv.float() - ml[:, s, None]
    return torch.cat(parts, 1)


def _q3k_unpack_scales(s: torch.Tensor) -> torch.Tensor:
    """12 packed bytes → 16 6-bit scales, int32 (quants._q3k_unpack_scales)."""
    s = s.to(torch.int32)
    lo, hi, top = s[:, 0:4], s[:, 4:8], s[:, 8:12]
    return torch.cat([(lo & 0xF) | ((top & 3) << 4), (hi & 0xF) | (((top >> 2) & 3) << 4),
                      (lo >> 4) | (((top >> 4) & 3) << 4),
                      (hi >> 4) | (((top >> 6) & 3) << 4)], 1)


def _q3_k(blk: torch.Tensor) -> torch.Tensor:
    hmask = blk[:, 0:32].to(torch.int32)
    qs = blk[:, 32:96].to(torch.int32)
    sc = _q3k_unpack_scales(blk[:, 96:108]) - 32
    d = _f16_col(blk, 108)
    dl = d[:, None] * sc.float()
    parts = [None] * 16
    for h in range(2):
        qb = qs[:, 32 * h: 32 * (h + 1)]
        for j in range(4):
            for half in range(2):
                s = 8 * h + 2 * j + half
                lo = (qb[:, 16 * half: 16 * half + 16] >> (2 * j)) & 3
                hi = (hmask[:, 16 * half: 16 * half + 16] >> (4 * h + j)) & 1
                qv = lo - torch.where(hi == 1, 0, 4)
                parts[s] = dl[:, s, None] * qv.float()
    return torch.cat(parts, 1)


_BLOCK_FNS = {GGMLType.Q8_0: _q8_0, GGMLType.Q4_0: _q4_0, GGMLType.Q4_1: _q4_1,
              GGMLType.Q5_0: _q5_0, GGMLType.Q5_1: _q5_1, GGMLType.Q2_K: _q2_k,
              GGMLType.Q3_K: _q3_k, GGMLType.Q4_K: _q4_k, GGMLType.Q5_K: _q5_k,
              GGMLType.Q6_K: _q6_k, GGMLType.Q8_K: _q8_k, GGMLType.IQ4_NL: _iq4_nl,
              GGMLType.IQ4_XS: _iq4_xs}


def dequantize(data, t: GGMLType, shape: tuple[int, ...], device,
               dtype=torch.float32) -> torch.Tensor:
    """GGUF bytes of one tensor (a uint8 numpy array or tensor) → its values
    on `device` with numpy `shape` (reversed ggml ne), computed in f32 as
    gguf/quants.dequantize computes them and then converted to `dtype`. A
    type gguf/quants.py does not read raises as it does there."""
    if t not in _BLOCK_FNS and t not in (GGMLType.F32, GGMLType.F16, GGMLType.BF16):
        raise NotImplementedError(f"no dequantizer for {t!r}")
    raw = data if torch.is_tensor(data) else torch.from_numpy(np.array(data, copy=True))
    raw = raw.to(device)
    if t == GGMLType.F32:
        return raw.view(torch.float32).reshape(shape).to(dtype)
    if t == GGMLType.F16:
        return raw.view(torch.float16).float().reshape(shape).to(dtype)
    if t == GGMLType.BF16:
        return raw.view(torch.bfloat16).float().reshape(shape).to(dtype)
    block, nbytes = GGML_BLOCK_INFO[t]
    blk = raw.reshape(-1, nbytes)
    per = max(1, CHUNK // block)
    out = torch.empty((blk.shape[0], block), dtype=dtype, device=raw.device)
    for i in range(0, blk.shape[0], per):
        out[i:i + per] = _BLOCK_FNS[t](blk[i:i + per]).to(dtype)
    return out.reshape(shape)
