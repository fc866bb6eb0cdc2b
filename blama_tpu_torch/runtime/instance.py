"""Instance: execution context binding a Model to device KV state.

Mirror of the reference Instance (Instance.{hpp,cpp}): owns the
context-length/batch configuration, enforces one active Session, provides
warmup, and owns the step function and the KV slot allocator. The KV cache
lives on the model's device.

Decode requests are padded to power-of-two bucket lengths up to
ubatch_size, as in the JAX package, so a chunk of n tokens runs at the same
shape (and through the same kernels) in both; pad tokens target an
out-of-range slot and write nothing.

On the card each bucket's step runs as a captured CUDA graph (the
reference's jitted step; ops/step_graph.py), as do the session's device
loops: `warmup` captures T = 1 and its own bucket, any other bucket is
captured at its first use. `InstanceInitParams.graphs=False` launches
eagerly, for comparison; on the CPU the step runs eagerly.
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import decode_attention as dattn
from ..ops import kv_cache as kvc
from ..ops.step_graph import StepGraphs
from .session import Session, SessionInitParams


def _bucket(n: int, cap: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


@dataclass
class InstanceInitParams:
    """Reference: Instance::InitParams (Instance.hpp:21-26)."""

    ctx_size: int = 0            # 0 = train context length
    batch_size: int = 2048
    ubatch_size: int = 512
    # the fused attention kernels for this instance even where the model
    # was loaded with attn="xla" (Instance.hpp:24); a model loaded with
    # attn="fused" takes them without it
    flash_attn: bool = False
    kv_dtype: str = "float32"    # float32 | bfloat16 | int8
    fast_greedy: bool = True     # device-loop fast path for eligible complete()
    ring_mesh: object = None     # sequence-parallel prefill (not ported)
    ring_min_prompt: int = 32
    # on the card, the steps and the session's loops replay captured CUDA
    # graphs; False launches every kernel from Python (for comparison)
    graphs: bool = True


class Instance:
    def __init__(self, model, params: InstanceInitParams | None = None):
        self.model = model
        self.params = params or InstanceInitParams()
        cfg = model.config
        kv_dtype = kvc.resolve_kv_dtype(self.params.kv_dtype)
        if self.params.ring_mesh is not None:
            raise NotImplementedError(
                "ring (sequence-parallel) prefill is not ported "
                "(ROADMAP.md §1 item 13, multi-GPU)")
        self.ctx_len = self.params.ctx_size or cfg.n_ctx_train
        if self.ctx_len > cfg.n_ctx_train:
            logging.getLogger("blama_tpu_torch").warning(
                "Instance requested context length %d is greater than the "
                "model's training context length %d", self.ctx_len, cfg.n_ctx_train,
            )
        self.batch_size = self.params.batch_size
        self.ubatch_size = min(self.params.ubatch_size, self.batch_size)
        self.device = model.device
        self.cache = kvc.KVCache.create(cfg.n_layer, 1, self.ctx_len, cfg.n_head_kv,
                                        cfg.head_dim_, kv_dtype, device=self.device)
        self.allocator = kvc.SlotAllocator(self.ctx_len)

        from ..ops.generate_loop import static_of

        # session fast paths derive statics from this; its attn_fused is the
        # mode the session's records are made in
        self.step_config = self._attention_mode(cfg, kv_dtype)
        self._st = static_of(self.step_config)
        # the step's and the loops' graphs (False: eager launches)
        self.graphs = (StepGraphs(self.device)
                       if self.params.graphs and self.device.type == "cuda" else False)
        self._session: Session | None = None

    def _attention_mode(self, cfg, kv_dtype):
        """The step config's attention mode, as the reference's Instance
        picks it (blama_tpu/runtime/instance.py:118-150): the fused kernels
        when the model was loaded with attn="fused" or flash_attn asks for
        them, unless the model is a MoE or the fused gates reject the
        geometry (ctx_size, head dim, store type); then a warning says so,
        and the step config records attn_fused=False: the two-pass chain,
        a mode of its own numerics, never a quiet substitute. A geometry the
        gates admit is checked against the kernels where the cache lives on
        a card (decode_attention.require_kernel_geometry)."""
        if not (self.params.flash_attn or cfg.attn_fused):
            return cfg
        log = logging.getLogger("blama_tpu_torch")
        if cfg.is_moe:
            log.warning("flash_attn requested but unsupported with MoE; using XLA attention")
        elif not dattn.supports(self.ctx_len, cfg.head_dim_, self.cache.k.dtype):
            log.warning(
                "flash_attn requested but the fused kernel rejects this geometry "
                "(ctx_size=%d head_dim=%d kv_dtype=%s); using XLA attention",
                self.ctx_len, cfg.head_dim_, self.params.kv_dtype)
        else:
            dattn.require_kernel_geometry(self.device, cfg.n_head, cfg.n_head_kv,
                                          cfg.head_dim_, kv_dtype)
            return dataclasses.replace(cfg, attn_fused=True)
        return dataclasses.replace(cfg, attn_fused=False)

    # -- session lifecycle (single active session, Instance.cpp:121-131) -----

    def start_session(self, params: SessionInitParams | None = None) -> Session:
        if self._session is not None:
            raise RuntimeError("Another session is currently active")
        self._session = Session(self, params)
        return self._session

    def stop_session(self) -> None:
        self._session = None

    # -- adapters --------------------------------------------------------------

    def add_lora(self, adapter, scale: float = 1.0) -> None:
        raise NotImplementedError("LoRA adapters are not ported (ROADMAP.md §1 item 11)")

    def clear_lora_state(self) -> None:
        raise NotImplementedError("LoRA adapters are not ported (ROADMAP.md §1 item 11)")

    def apply_control_vector(self, cvec, layer_start: int = 1,
                             layer_end: int | None = None) -> None:
        raise NotImplementedError("control vectors are not ported (ROADMAP.md §1 item 11)")

    def warmup(self) -> None:
        """Single decode of [BOS, EOS] then clear (Instance.cpp:86-119). As
        the reference's warm-up decode first compiles its step
        (blama_tpu/runtime/instance.py:251-259), this one captures the step
        graph of its own bucket and that of T = 1 (a decode step)."""
        vocab = self.model.vocab
        tokens = [t for t in (vocab.bos(), vocab.eos()) if t >= 0] or [0]
        self.decode(tokens, np.arange(len(tokens), dtype=np.int64))
        if self.graphs:
            self.graphs.prepare_step(self._st, self.model.weights, self.cache, 1, 1)
        self.clear_cache()

    # -- KV management --------------------------------------------------------

    def clear_cache(self) -> None:
        kvc.clear(self.cache)
        self.allocator.clear()

    def kv_seq_rm(self, p0: int, p1: int) -> None:
        kvc.seq_rm(self.cache, p0, p1)
        self.allocator.apply_rm(p0, p1)

    def kv_seq_add(self, p0: int, p1: int, delta: int) -> None:
        kvc.seq_add(self.cache, p0, p1, delta)
        self.allocator.apply_add(p0, p1, delta)

    def kv_seq_div(self, p0: int, p1: int, divisor: int) -> None:
        kvc.seq_div(self.cache, p0, p1, divisor)
        self.allocator.apply_div(p0, p1, divisor)

    def cache_host(self):
        c = self.cache

        def host(t):
            if t is None:
                return None
            return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()

        return tuple(host(t) for t in (c.k, c.v, c.positions, c.k_scale, c.v_scale))

    def restore_cache(self, k, v, pos, k_scale=None, v_scale=None) -> None:
        dev = self.device

        def t(a, dtype):
            return torch.as_tensor(np.asarray(a)).to(dev, dtype)

        self.cache = kvc.KVCache(
            t(k, self.cache.k.dtype), t(v, self.cache.v.dtype), t(pos, torch.int32),
            t(k_scale, torch.float32) if k_scale is not None else None,
            t(v_scale, torch.float32) if v_scale is not None else None,
        )
        if self.graphs:
            self.graphs.retain(self.cache)   # free the old stores and their graphs

    # -- decode ---------------------------------------------------------------

    def decode(self, tokens: list[int], positions: np.ndarray) -> np.ndarray:
        """Decode ≤ ubatch tokens per chunk, returning the last real token's
        full-vocab logits as host float32."""
        n = len(tokens)
        assert n > 0
        out = None
        off = 0
        while off < n:
            chunk = tokens[off: off + self.ubatch_size]
            pos = positions[off: off + self.ubatch_size]
            out = self._decode_chunk(chunk, pos)
            off += len(chunk)
        return out

    def _decode_chunk(self, tokens: list[int], positions: np.ndarray) -> np.ndarray:
        n = len(tokens)
        T = _bucket(n, self.ubatch_size)
        slots = self.allocator.allocate(n)
        self.allocator.record(slots, positions)

        tok_pad = np.zeros((1, T), np.int32)
        tok_pad[0, :n] = tokens
        pos_pad = np.full((1, T), 0, np.int32)
        pos_pad[0, :n] = positions
        slot_pad = np.full((1, T), self.ctx_len, np.int32)  # out-of-range → dropped
        slot_pad[0, :n] = slots
        dev = self.device
        li = torch.tensor([n - 1])
        if self.graphs:
            logits = self.graphs.step(self._st, self.model.weights, self.cache,
                                      *map(torch.from_numpy, (tok_pad, pos_pad, slot_pad)), li)
        else:
            logits, self.cache = self._st.step(
                self.model.weights, torch.from_numpy(tok_pad).to(dev),
                torch.from_numpy(pos_pad).to(dev), torch.from_numpy(slot_pad).to(dev),
                self.cache, li.to(dev))
        return logits[0].float().cpu().numpy()
