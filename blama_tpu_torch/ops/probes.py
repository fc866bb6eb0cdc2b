"""The tools' card microbenchmark kernels, their wrappers and plain versions.

Both kernels are CUDA C++ for sm_90a (ops/csrc/probes.cu):

  R  stream (replaces the TPU kernel _stream_kernel of
     blama_tpu/tools/probe_bw.py): codes uint8 [R, N] in [bk, bn] blocks,
     grid (N // bn, R // bk); out [1, N] f32 is, per column, the sum over its
     blocks of each block's first 8 rows. One CTA brings every byte of its
     block into shared memory (cp.async) and sums those rows there, as the TPU
     kernel sums them in VMEM, so its time is the time to stream the blocks.
     Columns past (N // bn)·bn are 0 (the TPU kernel leaves them unwritten).
  S  add_one (replaces the TPU kernel _tiny_kernel of
     blama_tpu/tools/probe_overhead.py): o = x + 1.0 on a small f32 array, one
     CTA, the least work a launch carries.
  W  the SWAR probes of blama_tpu/tools/probe_swar.py: swar_roundtrip (u8 →
     32-bit words → u8, the identity), swar_lo_hi (x & 0xF and x >> 4 by
     0x0F0F0F0F masks on words), swar_dot (a @ lo + a @ hi, int32).
  X  the Mosaic probes of blama_tpu/tools/probe_mosaic.py: u8_bitops
     ((x & 0xF) + (x >> 4) in uint8), i16_bitops (the same through int16),
     i8_dot (int8 @ int8 → int32), unpack_dot (a @ concat([c & 0xF, c >> 4])).
  Y  the twelve layout and cast probes of tools/probe_casts.py (casts, CASTS).

W and X take uint8 arrays as 32-bit words of four bytes along the last axis,
so they want a contiguous array whose rows are whole words (N % 4 == 0,
4-byte aligned) and raise otherwise. The int8 dots do their products in the
kernel (__dp4a); their plain versions multiply in float64, exact for these
integers. On a CPU tensor each wrapper runs its plain version; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import kernels


def stream_plain(codes: torch.Tensor, bk: int, bn: int) -> torch.Tensor:
    """Plain version of kernel R → [1, N] f32 (exact integer sums)."""
    R, N = codes.shape
    nk, nn = R // bk, N // bn
    blocks = codes[:nk * bk, :nn * bn].reshape(nk, bk, nn * bn)[:, :8]
    out = torch.zeros((1, N), dtype=torch.float32, device=codes.device)
    out[0, :nn * bn] = blocks.to(torch.int32).sum(dim=(0, 1)).float()
    return out


def stream_launch(codes: torch.Tensor, bk: int, bn: int, total: bool = False):
    """Launch kernel R on a CUDA tensor. Returns (out [1, N] f32, and with
    total=True the per-column sum of every byte the CTAs staged, [1, N] f32,
    else None)."""
    R, N = codes.shape
    if codes.dtype != torch.uint8 or not codes.is_contiguous() or codes.data_ptr() % 16:
        raise ValueError("codes must be a contiguous, 16-byte aligned uint8 [R, N] array")
    if bk < 1 or bn < 16 or bn % 16 or bn > 16384 or N % 16 or R // bk < 1 or N // bn < 1:
        raise ValueError(f"kernel R takes bn % 16 == 0, 16 <= bn <= 16384, N % 16 == 0 "
                         f"and at least one block; got R={R}, N={N}, bk={bk}, bn={bn}")
    out = torch.zeros((1, N), dtype=torch.float32, device=codes.device)
    tot = torch.zeros((1, N), dtype=torch.float32, device=codes.device) if total else None
    rc = kernels.lib("probes").stream_rows_launch(
        codes.data_ptr(), R, N, bk, bn, out.data_ptr(), tot.data_ptr() if total else None,
        kernels.stream_ptr(codes.device))
    kernels.check(rc, "stream_rows")
    kernels.count("stream_rows")
    return out, tot


def stream(codes: torch.Tensor, bk: int, bn: int) -> torch.Tensor:
    """Kernel R (CUDA C++, replaces the TPU kernel _stream_kernel): the first
    8 rows of every [bk, bn] block of codes, summed per column → [1, N] f32."""
    if codes.device.type == "cpu":
        return stream_plain(codes, bk, bn)
    return stream_launch(codes, bk, bn)[0]


def add_one_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel S."""
    return x + 1.0


def add_one(x: torch.Tensor) -> torch.Tensor:
    """Kernel S (CUDA C++, replaces the TPU kernel _tiny_kernel): x + 1.0 on
    a contiguous f32 array of at most 2^20 elements, one CTA."""
    if x.device.type == "cpu":
        return add_one_plain(x)
    if x.dtype != torch.float32 or not x.is_contiguous() or x.numel() > 1 << 20:
        raise ValueError("kernel S takes a contiguous f32 array of at most 2^20 elements")
    o = torch.empty_like(x)
    rc = kernels.lib("probes").add_one_launch(x.data_ptr(), o.data_ptr(), x.numel(),
                                              kernels.stream_ptr(x.device))
    kernels.check(rc, "add_one")
    kernels.count("add_one")
    return o


# ---------------------------------------------------------------------------
# kernels W and X: byte operations on 32-bit words, and the int8 dots
# ---------------------------------------------------------------------------

_BYTE_OPS = {"swar_roundtrip": 0, "swar_lo_hi": 1, "u8_bitops": 2, "i16_bitops": 3}
_DOTS = {"swar_dot": 0, "i8_dot": 1, "unpack_dot": 2}
DOT_MAX_ROWS = 32


def _check_words(t: torch.Tensor, dtype, what: str) -> None:
    if (t.dtype != dtype or t.dim() != 2 or not t.is_contiguous() or t.data_ptr() % 4
            or t.shape[1] % 4 or t.numel() == 0):
        raise ValueError(f"{what}: wants a contiguous, 4-byte aligned {dtype} [R, N] array "
                         f"with N % 4 == 0; got {t.dtype} {tuple(t.shape)}")


def _bytes_launch(name: str, x: torch.Tensor, outs: int, dtype) -> list[torch.Tensor]:
    _check_words(x, torch.uint8, name)
    o = [torch.empty(x.shape, dtype=dtype, device=x.device) for _ in range(outs)]
    rc = kernels.lib("probes").bytes_launch(
        _BYTE_OPS[name], x.data_ptr(), o[0].data_ptr(), o[-1].data_ptr(), x.numel() // 4,
        kernels.stream_ptr(x.device))
    kernels.check(rc, name)
    kernels.count(name)
    return o


def swar_roundtrip_plain(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


def swar_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """Kernel W (CUDA C++, replaces probe_swar.py's TPU kernel k_roundtrip):
    uint8 [R, N] read as 32-bit words and written back as bytes."""
    if x.device.type == "cpu":
        return swar_roundtrip_plain(x)
    return _bytes_launch("swar_roundtrip", x, 1, torch.uint8)[0]


def swar_lo_hi_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return (x & 0x0F).to(torch.int8), (x >> 4).to(torch.int8)


def swar_lo_hi(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel W (replaces probe_swar.py's k_swar_lo_hi): the low and high
    nibble of every byte as int8 [R, N], by masks on 32-bit words."""
    if x.device.type == "cpu":
        return swar_lo_hi_plain(x)
    lo, hi = _bytes_launch("swar_lo_hi", x, 2, torch.int8)
    return lo, hi


def u8_bitops_plain(x: torch.Tensor) -> torch.Tensor:
    return (x & 0x0F) + (x >> 4)


def u8_bitops(x: torch.Tensor) -> torch.Tensor:
    """Kernel X (replaces probe_mosaic.py's k_u8_bitops): (x & 0xF) + (x >> 4)
    of uint8 [R, N] in uint8 arithmetic."""
    if x.device.type == "cpu":
        return u8_bitops_plain(x)
    return _bytes_launch("u8_bitops", x, 1, torch.uint8)[0]


def i16_bitops_plain(x: torch.Tensor) -> torch.Tensor:
    h = x.to(torch.int16)
    return ((h & 0x0F) + ((h >> 4) & 0x0F)).to(torch.uint8)


def i16_bitops(x: torch.Tensor) -> torch.Tensor:
    """Kernel X (replaces probe_mosaic.py's k_u8_upcast_i16): the same sum
    through int16, back to uint8."""
    if x.device.type == "cpu":
        return i16_bitops_plain(x)
    return _bytes_launch("i16_bitops", x, 1, torch.uint8)[0]


def _dot_launch(name: str, a: torch.Tensor, b: torch.Tensor, a_cols: int) -> torch.Tensor:
    K, N = b.shape
    _check_words(b, torch.int8 if name == "i8_dot" else torch.uint8, name)
    if (a.dtype != torch.int8 or a.dim() != 2 or not a.is_contiguous()
            or a.shape[1] != a_cols * K or not 1 <= a.shape[0] <= DOT_MAX_ROWS
            or a.device != b.device):
        raise ValueError(f"{name}: a must be a contiguous int8 [1..{DOT_MAX_ROWS}, "
                         f"{a_cols * K}] array on b's device; got {a.dtype} {tuple(a.shape)}")
    out = torch.empty((a.shape[0], N), dtype=torch.int32, device=a.device)
    rc = kernels.lib("probes").int8_dot_launch(
        _DOTS[name], a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0], K, N,
        kernels.stream_ptr(a.device))
    kernels.check(rc, name)
    kernels.count(name)
    return out


def swar_dot_plain(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    af = a.double()
    return (af @ (c & 0x0F).double() + af @ (c >> 4).double()).to(torch.int32)


def swar_dot(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Kernel W (replaces probe_swar.py's k_swar_dot): int8 a [M <= 32, K]
    with the nibbles of uint8 c [K, N], a @ lo + a @ hi → int32 [M, N]."""
    if a.device.type == "cpu":
        return swar_dot_plain(a, c)
    return _dot_launch("swar_dot", a, c, 1)


def i8_dot_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.double() @ b.double()).to(torch.int32)


def i8_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Kernel X (replaces probe_mosaic.py's k_i8_dot): int8 a [M <= 32, K] @
    int8 b [K, N] → int32 [M, N]."""
    if a.device.type == "cpu":
        return i8_dot_plain(a, b)
    return _dot_launch("i8_dot", a, b, 1)


def unpack_dot_plain(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    q = torch.cat([c & 0x0F, c >> 4], dim=0)
    return (a.double() @ q.double()).to(torch.int32)


def unpack_dot(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Kernel X (replaces probe_mosaic.py's k_i8_from_unpack_dot): int8 a
    [M <= 32, 2K] @ concat([c & 0xF, c >> 4]) for uint8 c [K, N] → int32."""
    if a.device.type == "cpu":
        return unpack_dot_plain(a, c)
    return _dot_launch("unpack_dot", a, c, 2)


# ---------------------------------------------------------------------------
# kernel Y: probe_casts' layout and cast probes
# ---------------------------------------------------------------------------

def _even_rows(x: torch.Tensor) -> torch.Tensor:
    """E [4, 8] @ x [8, 4] with E[i, k] = (k == 2i), in float64 (exact, and
    free of the TF32 setting on the card)."""
    i = torch.arange(4, device=x.device)[:, None]
    e = (torch.arange(8, device=x.device)[None, :] == 2 * i).double()
    return (e @ x.double()).float()


def _round_int8(x: torch.Tensor) -> torch.Tensor:
    # a tensor factor: the f32 product the reference takes with 3.7
    k = torch.tensor(3.7, dtype=torch.float32, device=x.device)
    return torch.round(x * k).to(torch.int8).float()


# (name, input shape, output shape, plain version), in probe_casts.py's order
CASTS = (
    ("reshape_8x128", (1, 1024), (8, 128), lambda x: x.reshape(8, 128)),
    ("reshape_1x1024", (8, 128), (1, 1024), lambda x: x.reshape(1, 1024)),
    ("reshape_32x1", (8, 4), (32, 1), lambda x: x.reshape(32, 1)),
    ("lane_slice", (1, 1024), (1, 128), lambda x: x[:, 128:256]),
    ("lane_concat", (1, 1024), (1, 512),
     lambda x: torch.cat([x[:, i * 128:(i + 1) * 128] for i in range(4)], dim=1)),
    ("sublane_stride", (8, 128), (4, 128), lambda x: x[0::2]),
    ("group_max", (8, 128), (8, 4), lambda x: x.abs().reshape(8, 4, 32).amax(dim=-1)),
    ("reshape_4d", (1, 1024), (1, 4, 2, 128), lambda x: x.reshape(1, 4, 2, 128)),
    ("reshape_3d", (16, 512), (16, 1, 512), lambda x: x.reshape(16, 1, 512)),
    ("round_int8", (8, 128), (8, 128), _round_int8),
    ("row_select_dot", (8, 4), (4, 4), _even_rows),
    ("scratch_store", (1, 1024), (1, 128), lambda x: x[:, :128]),
)
_CAST = {name: (i + 1, shape_in, shape_out, plain)
         for i, (name, shape_in, shape_out, plain) in enumerate(CASTS)}


def cast_plain(name: str, x: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel Y's probe `name` (a fresh contiguous tensor)."""
    return _CAST[name][3](x).contiguous().clone()


def cast(name: str, x: torch.Tensor) -> torch.Tensor:
    """Kernel Y (CUDA C++, replaces the TPU kernel of tools/probe_casts.py's
    probe `name`): the probe's f32 layout or cast op on its own input shape."""
    probe, shape_in, shape_out, _ = _CAST[name]
    if x.device.type == "cpu":
        return cast_plain(name, x)
    if x.dtype != torch.float32 or tuple(x.shape) != shape_in or not x.is_contiguous():
        raise ValueError(f"cast {name}: wants a contiguous f32 {shape_in} array; "
                         f"got {x.dtype} {tuple(x.shape)}")
    o = torch.empty(shape_out, dtype=torch.float32, device=x.device)
    rc = kernels.lib("probes").casts_launch(probe, x.data_ptr(), o.data_ptr(),
                                            kernels.stream_ptr(x.device))
    kernels.check(rc, f"casts_{name}")
    kernels.count(f"casts_{name}")
    return o
