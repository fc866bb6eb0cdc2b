"""Paged KV cache: a shared page pool with per-sequence page tables.

Counterpart of blama_tpu/ops/paged_kv.py. The physical store is ONE pool of
`n_pages` pages of `page_size` slots shared by every scheduler row; a
sequence holds only the pages its context covers, and admission is bound by
free pages, not rows.

Design (keeps every invariant of ops/kv_cache.py):

  * physical K/V: [L, n_pages, page_size, Hkv, D], page-major, stored flat
    as [L, P*G + 1, Hkv, D] (kv_cache.SlotStore: the last slot is the spare
    one that takes the writes of pad tokens and idle rows). K stays
    UNROTATED; positions live in the pool ([n_pages, page_size], -1 = empty)
    and are edited in place (ctx-shift / Self-Extend stay pure metadata
    edits).
  * logical view: `page_table` [B, max_pages] int32 (-1 = unmapped) maps a
    row's page index p to a physical page. Slot s of a row lives at
    (page_table[b, s // G], s % G). Because rows allocate logical pages in
    order, the gathered view of a row is ELEMENT-IDENTICAL to a dense
    [S, Hkv, D] cache row no matter where its pages sit physically, so
    logits are bit-exact vs the dense layout (verification contract; tested
    with scrambled physical placement).
  * writes are flat scatters: the host allocator hands the forward FLAT pool
    slot indices (page * G + offset), one scatter per layer, unique indices.

The attention read path has two engines, mirroring the dense cache:
  * plain: gather the row view and run the dense attention on it (the CPU
    device, the tests, and the two-pass chain where the fused gates refuse).
  * kernels E and F (ops/paged_attention.py) stream pages straight from the
    pool through the page table, no gathered copy, in the dense kernels'
    slot order.
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels import resolve_device
from .kv_cache import SlotStore

_I32_MIN, _I32_MAX = -(2 ** 31), 2 ** 31 - 1


class PagedKVCache(SlotStore):
    """Pool-backed KV store. In float mode k/v hold values; in INT8 mode
    int8 codes with per-(slot, head) max-abs scales (same quantizer as the
    dense cache, ops/kv_cache.py:quantize_kv). The [L, P, G, ...] tensors
    are views of the flat stores."""

    def __init__(self, stores, page_table: torch.Tensor, page_size: int):
        super().__init__(*stores)
        self.page_table = page_table   # [B, MP] int32; -1 = unmapped
        self.page_size = page_size

    @classmethod
    def create(cls, n_layer: int, batch: int, n_pages: int, page_size: int,
               max_pages: int, n_kv_head: int, head_dim: int,
               dtype="bfloat16", device="cuda") -> "PagedKVCache":
        device = resolve_device(device)
        stores = cls._alloc(n_layer, n_pages * page_size, n_kv_head, head_dim,
                            dtype, device)
        table = torch.full((batch, max_pages), -1, dtype=torch.int32, device=device)
        return cls(stores, table, page_size)

    def _pages(self, store, lead: int):
        n = self.n_slots
        body = store[:n] if lead == 0 else store[:, :n]
        shape = store.shape[:lead] + (self.n_pages, self.page_size) + store.shape[lead + 1:]
        return body.view(shape)

    @property
    def k(self) -> torch.Tensor:          # [L, P, G, Hkv, D] unrotated keys
        return self._pages(self.k_store, 1)

    @property
    def v(self) -> torch.Tensor:          # [L, P, G, Hkv, D]
        return self._pages(self.v_store, 1)

    @property
    def positions(self) -> torch.Tensor:  # [P, G] int32; -1 = empty slot
        return self._pages(self.pos_store, 0)

    @positions.setter
    def positions(self, value: torch.Tensor) -> None:
        self.positions.copy_(value)

    @property
    def k_scale(self) -> torch.Tensor | None:   # [L, P, G, Hkv] f32
        return self._pages(self.k_scale_store, 1) if self.quantized else None

    @property
    def v_scale(self) -> torch.Tensor | None:
        return self._pages(self.v_scale_store, 1) if self.quantized else None

    @property
    def n_slots(self) -> int:
        """Total pool slots (the scatter-index space for writes); a slot
        index >= n_slots is a pad and goes to the spare slot."""
        return self.pad_slot

    @property
    def n_pages(self) -> int:
        return self.n_slots // self.page_size

    @property
    def view_slots(self) -> int:
        """Per-row logical window (max_pages * page_size)."""
        return self.page_table.shape[1] * self.page_size

    def with_table(self, table: np.ndarray) -> "PagedKVCache":
        """Install a host page-table snapshot (in place; returns self)."""
        self.page_table.copy_(torch.from_numpy(np.array(table, dtype=np.int32)))
        return self

    def flat_slots(self, slots: torch.Tensor) -> torch.Tensor:
        """[B, T] flat pool slots (>= n_slots = pad) -> [B*T] store slots."""
        return torch.clamp(slots, max=self.pad_slot).reshape(-1)


def view_slot_map(page_table: torch.Tensor, page_size: int) -> torch.Tensor:
    """[B, MP] page table -> [B, MP*G] flat pool slot per logical slot.

    Unmapped pages map to slot 0; callers must mask them via `view_positions`
    (which forces their positions to -1, the empty-slot sentinel attention
    already honors)."""
    pt = torch.clamp(page_table, min=0).long()
    off = torch.arange(page_size, device=page_table.device)
    flat = pt[:, :, None] * page_size + off[None, None, :]
    return flat.reshape(page_table.shape[0], -1)


def view_positions(cache: PagedKVCache) -> torch.Tensor:
    """Per-row position map [B, MP*G] of the logical view (-1 on unmapped)."""
    G = cache.page_size
    slot_map = view_slot_map(cache.page_table, G)
    pos = cache.pos_store[slot_map]
    mapped = torch.repeat_interleave(cache.page_table >= 0, G, dim=1)
    return torch.where(mapped, pos, -1).to(torch.int32)


def gather_view(cache: PagedKVCache, layer_k, layer_v, layer_ks=None,
                layer_vs=None):
    """Materialize the dense per-row view of one layer's pool slices:
    [P, G, Hkv, D] pool -> [B, MP*G, Hkv, D] rows (the plain read path)."""
    G = cache.page_size
    slot_map = view_slot_map(cache.page_table, G)
    Hkv, D = layer_k.shape[-2], layer_k.shape[-1]
    k = layer_k.reshape(-1, Hkv, D)[slot_map]
    v = layer_v.reshape(-1, Hkv, D)[slot_map]
    if layer_ks is not None:
        ks = layer_ks.reshape(-1, Hkv)[slot_map]
        vs = layer_vs.reshape(-1, Hkv)[slot_map]
        return k, v, ks, vs
    return k, v, None, None


# -- position edits (llama_kv_self_* analogs over the pool) ------------------
# Pool positions are global, but edits must touch only ONE row's slots: the
# mask is the row's slot membership (from its page table), matching the
# per-sequence semantics of llama.cpp's seq_rm/add/div.

def _row_mask(cache: PagedKVCache, row: int) -> torch.Tensor:
    """[P, 1] bool: pages owned by `row`."""
    pages = cache.page_table[row]
    owned = torch.zeros(cache.n_pages + 1, dtype=torch.bool, device=pages.device)
    owned[torch.where(pages >= 0, pages, cache.n_pages).long()] = True
    return owned[:cache.n_pages, None]


def _hit(cache, row, p0: int, p1: int) -> torch.Tensor:
    pos = cache.positions
    p1 = _I32_MAX if p1 < 0 else p1
    return (pos >= p0) & (pos < p1) & (pos >= 0) & _row_mask(cache, row)


def seq_rm(cache: PagedKVCache, row: int, p0: int, p1: int) -> PagedKVCache:
    p0, p1 = int(p0), int(p1)
    hit = _hit(cache, row, _I32_MIN if p0 < 0 else p0, p1)
    cache.positions = torch.where(hit, -1, cache.positions)
    return cache


def seq_add(cache: PagedKVCache, row: int, p0: int, p1: int, delta: int) -> PagedKVCache:
    pos = cache.positions
    shifted = torch.where(_hit(cache, row, int(p0), int(p1)), pos + int(delta), pos)
    cache.positions = torch.where(shifted < 0, -1, shifted)
    return cache


def seq_div(cache: PagedKVCache, row: int, p0: int, p1: int, divisor: int) -> PagedKVCache:
    pos = cache.positions
    div = torch.div(pos, int(divisor), rounding_mode="floor")
    cache.positions = torch.where(_hit(cache, row, int(p0), int(p1)), div, pos)
    return cache


class PageAllocator:
    """Host-side page pool bookkeeping for the scheduler.

    Deterministic: free pages are handed out lowest-physical-index first
    (a sorted free set), so a given admission order always produces the same
    physical placement, and logits are
    reproducible run-to-run (placement does not affect logits at all — the
    logical view is placement-invariant — but determinism here keeps traces
    and profiles stable too)."""

    def __init__(self, n_pages: int, page_size: int, max_pages_per_row: int,
                 n_rows: int):
        self.n_pages = n_pages
        self.G = page_size
        self.MP = max_pages_per_row
        self._free = list(range(n_pages - 1, -1, -1))  # pop() -> lowest idx
        self.tables = np.full((n_rows, max_pages_per_row), -1, np.int64)
        self._row_len = np.zeros(n_rows, np.int64)  # slots in use per row

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_for(self, n_slots: int) -> int:
        return -(-n_slots // self.G)

    def can_admit(self, n_slots: int) -> bool:
        """Enough pool for `n_slots` new slots on a fresh row (+1 headroom
        page so the first decode steps cannot stall immediately)."""
        return self.free_pages >= self.pages_for(n_slots) + 1

    def allocate_slots(self, row: int, n: int) -> np.ndarray | None:
        """Extend `row` by n slots; returns FLAT pool indices [n] (for the
        forward's scatter writes) or None if the pool/window is exhausted."""
        start = int(self._row_len[row])
        end = start + n
        if end > self.MP * self.G:
            return None  # logical window exhausted
        first_page, last_page = start // self.G, (end - 1) // self.G
        for lp in range(first_page, last_page + 1):
            if self.tables[row, lp] < 0:
                if not self._free:
                    return None  # pool exhausted
                self.tables[row, lp] = self._free.pop()
        self._row_len[row] = end
        logical = np.arange(start, end)
        phys = self.tables[row, logical // self.G] * self.G + logical % self.G
        return phys.astype(np.int32)

    def max_extend(self, row: int, n: int, free_budget: int | None = None) -> int:
        """Largest m <= n for which allocate_slots(row, m) would succeed
        (logical-window + free-pool bound). Allocates nothing — the
        scheduler's horizon loop uses it to clamp a multi-step plan before
        committing pages. `free_budget` caps the free pages this row may
        claim (the scheduler threads a shrinking budget through a multi-row
        plan so rows do not all count the same last free pages)."""
        start = int(self._row_len[row])
        n = min(n, self.MP * self.G - start)
        if n <= 0:
            return 0
        lp = start // self.G
        while lp < self.MP and self.tables[row, lp] >= 0:
            lp += 1
        covered = max(0, lp * self.G - start)  # slots on already-mapped pages
        free = len(self._free)
        if free_budget is not None:
            free = min(free, max(0, free_budget))
        return min(n, covered + free * self.G)

    def free_row(self, row: int) -> list[int]:
        """Release a finished row's pages back to the pool (sorted re-insert
        keeps allocation deterministic). Returns the freed physical pages so
        the caller can clear their pool positions (stale positions would
        leak into the next owner's masks)."""
        pages = [int(p) for p in self.tables[row] if p >= 0]
        self.tables[row] = -1
        self._row_len[row] = 0
        self._free = sorted(set(self._free) | set(pages), reverse=True)
        return pages

    def row_len(self, row: int) -> int:
        return int(self._row_len[row])
