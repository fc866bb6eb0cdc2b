"""KV cache with a position map, and its sequence edits.

Fixed-shape per-layer K/V tensors [L, B, S, H_kv, D] plus an explicit
`positions` tensor [B, S] (int32, -1 = empty slot). K is stored UNROTATED;
attention rotates K by the position map on read, so every position edit
(context shift, Self-Extend grouped attention) is an elementwise update of
`positions` with no KV data movement, with llama.cpp's cell-position edit
semantics (llama_kv_self_seq_rm/add/div).

Unlike the JAX package, whose arrays are immutable, the port updates the
cache in place: the forward pass writes K/V rows into the layer tensors and
the edits rewrite `positions`. Each function still returns the cache.

Slot allocation is host-side and strictly sequential per sequence, so the
same token stream always lands in the same slots and replays bit-exactly.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .kernels import resolve_device

_I32_MIN, _I32_MAX = -(2 ** 31), 2 ** 31 - 1


@dataclass
class KVCache:
    """INT8 KV store: k/v hold int8 codes with per-(slot, head) max-abs
    scales k_scale/v_scale (f32 [L, B, S, H_kv]). The reference's float
    caches are not ported (ROADMAP.md §1 item 9)."""

    k: torch.Tensor          # [L, B, S, H_kv, D] int8 codes of unrotated keys
    v: torch.Tensor          # [L, B, S, H_kv, D]
    positions: torch.Tensor  # [B, S] int32; -1 = empty
    k_scale: torch.Tensor | None = None  # [L, B, S, H_kv] f32
    v_scale: torch.Tensor | None = None

    @property
    def n_slots(self) -> int:
        return self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @classmethod
    def create(cls, n_layer: int, batch: int, n_slots: int, n_kv_head: int,
               head_dim: int, dtype="int8", device="cuda"):
        if dtype not in (torch.int8, "int8"):
            raise NotImplementedError(
                f"KV dtype {dtype!r}: only the INT8 cache is ported "
                "(ROADMAP.md §1 item 9, other engines)")
        shape = (n_layer, batch, n_slots, n_kv_head, head_dim)
        device = resolve_device(device)
        return cls(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            positions=torch.full((batch, n_slots), -1, dtype=torch.int32, device=device),
            k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        )


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, T, H, D] → (int8 codes, f32 scales [B, T, H]); max-abs symmetric.
    Multiplies by the reciprocal scale and rounds half to even, as the
    reference does."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=-1)
    # a tensor divisor: torch divides by a Python scalar on CUDA through its
    # reciprocal, which is not the reference's IEEE division
    scale = amax / torch.full_like(amax, 127.0)
    inv = torch.where(scale > 0, 1.0 / torch.where(scale > 0, scale, 1.0), 0.0)
    codes = torch.round(xf * inv[..., None]).to(torch.int8)
    return codes, scale


def dequantize_kv(codes: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    return (codes.float() * scale[..., None]).to(dtype)


def clear(cache: KVCache) -> KVCache:
    """llama_kv_self_clear: mark all slots empty (data left in place)."""
    cache.positions.fill_(-1)
    return cache


def _hit(pos: torch.Tensor, p0: int, p1: int) -> torch.Tensor:
    p1 = _I32_MAX if p1 < 0 else p1
    return (pos >= p0) & (pos < p1) & (pos >= 0)


def seq_rm(cache: KVCache, p0: int, p1: int) -> KVCache:
    """Remove entries with position in [p0, p1) (negative bounds = open)."""
    p0, p1 = int(p0), int(p1)
    p0 = _I32_MIN if p0 < 0 else p0
    pos = cache.positions
    cache.positions = torch.where(_hit(pos, p0, p1), -1, pos).to(torch.int32)
    return cache


def seq_add(cache: KVCache, p0: int, p1: int, delta: int) -> KVCache:
    """Shift positions in [p0, p1) by delta; entries shifted below 0 are
    removed (llama.cpp semantics)."""
    pos = cache.positions
    shifted = torch.where(_hit(pos, int(p0), int(p1)), pos + int(delta), pos)
    cache.positions = torch.where(shifted < 0, -1, shifted).to(torch.int32)
    return cache


def seq_div(cache: KVCache, p0: int, p1: int, divisor: int) -> KVCache:
    """Integer-divide positions in [p0, p1) (Self-Extend grouped attention)."""
    pos = cache.positions
    div = torch.div(pos, int(divisor), rounding_mode="floor")
    cache.positions = torch.where(_hit(pos, int(p0), int(p1)), div, pos).to(torch.int32)
    return cache


class SlotAllocator:
    """Host-side sequential slot allocator for one sequence.

    Slots are assigned in ring order; `record` and the apply_* edits keep the
    host view of the position map in step with the device edits so freed
    slots become reusable.
    """

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self.host_positions = np.full(n_slots, -1, np.int64)
        self._cursor = 0

    def allocate(self, n: int) -> np.ndarray:
        free = np.flatnonzero(self.host_positions < 0)
        # rotate free list so allocation continues after the last cursor
        order = np.argsort((free - self._cursor) % self.n_slots, kind="stable")
        free = free[order]
        if len(free) < n:
            raise RuntimeError(f"KV cache full: need {n} slots, have {len(free)}")
        slots = free[:n]
        if len(slots):
            self._cursor = int(slots[-1]) + 1
        return slots.astype(np.int32)

    def record(self, slots: np.ndarray, positions: np.ndarray) -> None:
        self.host_positions[slots] = positions

    def apply_rm(self, p0: int, p1: int) -> None:
        hp = self.host_positions
        hit = (hp >= p0) & (hp < (p1 if p1 >= 0 else np.iinfo(np.int64).max)) & (hp >= 0)
        hp[hit] = -1

    def apply_add(self, p0: int, p1: int, delta: int) -> None:
        hp = self.host_positions
        hit = (hp >= p0) & (hp < (p1 if p1 >= 0 else np.iinfo(np.int64).max)) & (hp >= 0)
        hp[hit] += delta
        hp[hp < 0] = -1  # entries shifted below zero are removed

    def apply_div(self, p0: int, p1: int, divisor: int) -> None:
        hp = self.host_positions
        hit = (hp >= p0) & (hp < (p1 if p1 >= 0 else np.iinfo(np.int64).max)) & (hp >= 0)
        hp[hit] //= divisor

    def clear(self) -> None:
        self.host_positions[:] = -1
        self._cursor = 0
