"""KV cache with a position map, and its sequence edits.

Fixed-shape per-layer K/V tensors [L, B, S, H_kv, D] plus an explicit
`positions` tensor [B, S] (int32, -1 = empty slot). K is stored UNROTATED;
attention rotates K by the position map on read, so every position edit
(context shift, Self-Extend grouped attention) is an elementwise update of
`positions` with no KV data movement, with llama.cpp's cell-position edit
semantics (llama_kv_self_seq_rm/add/div).

Unlike the JAX package, whose arrays are immutable, the port updates the
cache in place: the forward pass writes K/V rows into the layer tensors and
the edits rewrite `positions`. Each function still returns the cache. The
JAX package drops a pad token's out-of-range write; the port sends it to a
spare slot that nothing reads (SlotStore).

Slot allocation is host-side and strictly sequential per sequence, so the
same token stream always lands in the same slots and replays bit-exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels import resolve_device

_I32_MIN, _I32_MAX = -(2 ** 31), 2 ** 31 - 1


def resolve_kv_dtype(dtype) -> torch.dtype:
    """The store's element type: int8 codes (with scales), bf16 or f32."""
    table = {"int8": torch.int8, "bfloat16": torch.bfloat16,
             "float32": torch.float32}
    dt = table.get(dtype, dtype)
    if dt not in table.values():
        raise ValueError(f"unsupported KV dtype {dtype!r}")
    return dt


class SlotStore:
    """Per-layer K/V slots, their positions and (INT8 mode) their scales,
    stored flat with ONE SPARE SLOT at the end of every tensor.

    A pad token's writes go to the spare slot, so a step needs no host sync
    to find the pads and a row with no real token (an idle scheduler row) is
    as safe as any other. No view, position map or page table ever exposes
    the spare slot; what it holds is never read.

    k_store/v_store [L, N + 1, H_kv, D], pos_store [N + 1] int32 (-1 = empty),
    k_scale_store/v_scale_store [L, N + 1, H_kv] f32 or None (float stores).
    """

    def __init__(self, k_store, v_store, pos_store, k_scale_store=None,
                 v_scale_store=None):
        self.k_store, self.v_store, self.pos_store = k_store, v_store, pos_store
        self.k_scale_store, self.v_scale_store = k_scale_store, v_scale_store

    @staticmethod
    def _alloc(n_layer, n, n_kv_head, head_dim, dtype, device):
        dt = resolve_kv_dtype(dtype)
        device = resolve_device(device)
        shape = (n_layer, n + 1, n_kv_head, head_dim)
        scales = (None, None)
        if dt == torch.int8:
            scales = tuple(torch.zeros(shape[:-1], dtype=torch.float32, device=device)
                           for _ in range(2))
        return (torch.zeros(shape, dtype=dt, device=device),
                torch.zeros(shape, dtype=dt, device=device),
                torch.full((n + 1,), -1, dtype=torch.int32, device=device), *scales)

    @property
    def pad_slot(self) -> int:
        """Flat index of the spare slot (the target of dropped writes)."""
        return self.pos_store.shape[0] - 1

    @property
    def quantized(self) -> bool:
        return self.k_scale_store is not None

    @property
    def device(self) -> torch.device:
        return self.k_store.device

    def write(self, li: int, flat: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> None:
        """Write K/V [B, T, H_kv, D] of layer `li` at flat slots [B*T]
        (quantizing on write in INT8 mode). Unique indices apart from the
        spare slot, whose content is never read."""
        write_rows(self.k_store[li], self.v_store[li],
                   self.k_scale_store[li] if self.quantized else None,
                   self.v_scale_store[li] if self.quantized else None,
                   flat, k.flatten(0, 1), v.flatten(0, 1))


class KVCache(SlotStore):
    """Dense rows: B rows of S slots. In float mode k/v hold values; in INT8
    mode int8 codes with per-(slot, head) max-abs scales (f32). The
    [L, B, S, ...] tensors are views of the flat stores."""

    def __init__(self, k, v, positions, k_scale=None, v_scale=None):
        """From whole tensors (k/v [L, B, S, H_kv, D], positions [B, S],
        scales [L, B, S, H_kv]): copied into a fresh store."""
        L, B, S, Hkv, D = k.shape
        stores = self._alloc(L, B * S, Hkv, D, k.dtype, k.device)
        super().__init__(*stores)
        self.batch, self.n_slots = B, S
        self.k.copy_(k)
        self.v.copy_(v)
        self.positions.copy_(positions)
        if self.quantized:
            self.k_scale.copy_(k_scale)
            self.v_scale.copy_(v_scale)

    @classmethod
    def create(cls, n_layer: int, batch: int, n_slots: int, n_kv_head: int,
               head_dim: int, dtype="bfloat16", device="cuda"):
        self = cls.__new__(cls)
        SlotStore.__init__(self, *cls._alloc(n_layer, batch * n_slots, n_kv_head,
                                             head_dim, dtype, device))
        self.batch, self.n_slots = batch, n_slots
        return self

    def _rows(self, store, lead: int):
        n = self.batch * self.n_slots
        body = store[:n] if lead == 0 else store[:, :n]
        shape = store.shape[:lead] + (self.batch, self.n_slots) + store.shape[lead + 1:]
        return body.view(shape)

    @property
    def k(self) -> torch.Tensor:          # [L, B, S, H_kv, D] unrotated keys
        return self._rows(self.k_store, 1)

    @property
    def v(self) -> torch.Tensor:          # [L, B, S, H_kv, D]
        return self._rows(self.v_store, 1)

    @property
    def positions(self) -> torch.Tensor:  # [B, S] int32; -1 = empty
        return self._rows(self.pos_store, 0)

    @positions.setter
    def positions(self, value: torch.Tensor) -> None:
        self.positions.copy_(value)

    @property
    def k_scale(self) -> torch.Tensor | None:   # [L, B, S, H_kv] f32
        return self._rows(self.k_scale_store, 1) if self.quantized else None

    @property
    def v_scale(self) -> torch.Tensor | None:
        return self._rows(self.v_scale_store, 1) if self.quantized else None

    def flat_slots(self, slots: torch.Tensor) -> torch.Tensor:
        """[B, T] per-row slots (>= n_slots = pad) -> [B*T] flat store slots."""
        B = slots.shape[0]
        rows = torch.arange(B, device=slots.device)[:, None] * self.n_slots
        return torch.where(slots < self.n_slots, rows + slots,
                           self.pad_slot).reshape(-1)


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., D] → (int8 codes, f32 scales [...]); max-abs symmetric over the
    last dim. The scale is amax / 127 as an IEEE division, the codes the
    rows times 1 / scale rounded half to even, as the reference does (and
    kernels N and P, ops/csrc/attention_common.cuh stage_row)."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=-1)
    # a tensor divisor: torch divides by a Python scalar on CUDA through its
    # reciprocal, which is not the reference's IEEE division
    scale = amax / torch.full_like(amax, 127.0)
    inv = torch.where(scale > 0, 1.0 / torch.where(scale > 0, scale, 1.0), 0.0)
    codes = torch.round(xf * inv[..., None]).to(torch.int8)
    return codes, scale


def write_rows(k_store, v_store, k_scale_store, v_scale_store, flat: torch.Tensor,
               k: torch.Tensor, v: torch.Tensor) -> None:
    """Store K/V rows [N, H_kv, D] of one layer at flat slots [N]: quantized
    by quantize_kv when the layer has scale stores, else cast to the store's
    type. The cache write and the plain versions of the write and fresh
    kernels (ops/decode_attention.py) all store a row through this."""
    if k_scale_store is not None:
        k, k_sc = quantize_kv(k)
        v, v_sc = quantize_kv(v)
        k_scale_store[flat] = k_sc
        v_scale_store[flat] = v_sc
    k_store[flat] = k.to(k_store.dtype)
    v_store[flat] = v.to(v_store.dtype)


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
