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

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises.
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
