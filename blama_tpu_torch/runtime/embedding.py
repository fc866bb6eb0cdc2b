"""InstanceEmbedding: embedding extraction with pooling and normalization.

Counterpart of blama_tpu/runtime/embedding.py (the reference
InstanceEmbedding, InstanceEmbedding.{hpp,cpp}): an encoder-only model
(bert) encodes the prompt, a decoder-only one decodes it
(InstanceEmbedding.cpp:129-137); per-token embeddings at the last token
when pooling is NONE, else per-sequence pooling (cpp:147-157); and the
exact normalization modes of normalizeEmbedding (cpp:58-92):
  -1 none | 0 max-absolute scaled to int16 range | 2 euclidean | p ≥ 1 p-norm

The bert path pads the prompt to T = max(8, the next power of two) with a
key mask and pools on the host. The decoder path runs the llama forward
over a fresh f32 store of T slots and takes the final normed hidden state
at the last token (models/llama.last_hidden), through the engine's kernels
(A or B for the projections, D for the prompt under attn="fused"). Prompts
are token ids: the reference has no WordPiece tokenizer
(blama_tpu/runtime/vocab.py:374-381), so a real bge GGUF loads on neither
side (ROADMAP.md §3).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models.bert import POOLING_LAST, POOLING_MEAN, POOLING_NONE


def normalize_embedding(inp: np.ndarray, embd_norm: int) -> np.ndarray:
    """Reference: normalizeEmbedding (InstanceEmbedding.cpp:58-92)."""
    inp = np.asarray(inp, np.float64)
    if embd_norm == -1:
        s = 1.0
    elif embd_norm == 0:
        s = np.abs(inp).max(initial=0.0) / 32760.0  # int16 range
    elif embd_norm == 2:
        s = float(np.sqrt(np.sum(inp * inp)))
    else:
        s = float(np.sum(np.abs(inp) ** embd_norm) ** (1.0 / embd_norm))
    scale = 1.0 / s if s > 0.0 else 0.0
    return (inp * scale).astype(np.float32)


@dataclass
class EmbeddingInitParams:
    """Reference: InstanceEmbedding::InitParams (ctxSize/batchSize/ubatchSize)."""

    ctx_size: int = 0
    batch_size: int = 512


def _padded(n: int) -> int:
    return max(8, 1 << (n - 1).bit_length())


def _host(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


class InstanceEmbedding:
    def __init__(self, model, params: EmbeddingInitParams | None = None):
        self.model = model
        self.params = params or EmbeddingInitParams()
        cfg = model.config
        self._arch = cfg.arch
        if cfg.arch == "bert":
            from ..models.bert import BertStatic

            self._st = BertStatic.of(cfg)
            self._pooling = cfg.pooling_type
        else:
            # the reference runs every other file through LlamaStatic and the
            # llama forward, which a MoE's expert banks and gpt2's layout
            # fail in (a KeyError on a weight the forward reads): refused
            # here with the reason
            if cfg.is_moe or cfg.arch == "gpt2":
                raise NotImplementedError(
                    f"embeddings of a {'MoE' if cfg.is_moe else 'gpt2'} model: the "
                    "reference's decoder path runs the llama forward, which fails on "
                    "this layout, so neither side serves it (ROADMAP.md §3)")
            from ..models.llama import LlamaStatic

            self._st = LlamaStatic.of(cfg)
            self._pooling = POOLING_NONE

    def embedding_dim(self) -> int:
        return self.model.config.n_embd

    def get_embedding_vector(self, prompt: list[int], normalization: int = 2) -> np.ndarray:
        """Reference: getEmbeddingVector (InstanceEmbedding.cpp:113-164)."""
        cfg = self.model.config
        n = len(prompt)
        if n == 0:
            return np.zeros(cfg.n_embd, np.float32)
        T = _padded(n)
        toks = torch.zeros((1, T), dtype=torch.int32)
        toks[0, :n] = torch.as_tensor(prompt, dtype=torch.int32)
        if self._arch == "bert":
            hidden = _host(self._bert_hidden(toks, n))            # [T, E]
            if self._pooling in (POOLING_NONE, POOLING_LAST):
                emb = hidden[n - 1]
            elif self._pooling == POOLING_MEAN:
                emb = hidden[:n].mean(axis=0)
            else:  # CLS
                emb = hidden[0]
        else:
            emb = _host(self._decoder_hidden(toks, n, T))[0]
        return normalize_embedding(emb, normalization)

    def _bert_hidden(self, toks: torch.Tensor, n: int) -> torch.Tensor:
        from ..models.bert import bert_forward

        mask = torch.zeros(toks.shape, dtype=torch.bool)
        mask[0, :n] = True
        return bert_forward(self._st, self.model.weights, toks, mask)[0]

    def _decoder_hidden(self, toks: torch.Tensor, n: int, T: int) -> torch.Tensor:
        """Last-token final (normed) hidden state [1, E] of a decoder-only
        model, over a fresh f32 store of T slots (pads to the spare slot)."""
        from ..models.llama import last_hidden
        from ..ops import kv_cache as kvc

        cfg, dev = self.model.config, self.model.device
        cache = kvc.KVCache.create(cfg.n_layer, 1, T, cfg.n_head_kv, cfg.head_dim_,
                                   torch.float32, device=dev)
        pos = torch.zeros((1, T), dtype=torch.int32)
        pos[0, :n] = torch.arange(n)
        slots = torch.full((1, T), T, dtype=torch.int32)
        slots[0, :n] = torch.arange(n)
        return last_hidden(self._st, self.model.weights, toks.to(dev), pos.to(dev),
                           slots.to(dev), cache, torch.tensor([n - 1], device=dev))
