"""Greedy and teacher-forced decode loops.

Counterpart of blama_tpu/ops/generate_loop.py. Each loop is a Python loop
of T == 1 forwards whose token choice (torch.argmax) and top-10 capture
(torch.topk) stay on the device; nothing is pulled to the host inside the
loop. The prover's loops (greedy_generate, continue_greedy) and the
verifier's (teacher_forced) run the same per-step forward at the same
shapes, so a same-backend replay reproduces the prover's logits bit for
bit. Slots are sequential (slot = position), matching the SlotAllocator.
"""

from __future__ import annotations

import torch

from ..models import llama as llama_mod
from .kv_cache import KVCache


def _step(st, params, cache, tok, pos):
    B = tok.shape[0]
    zero = torch.zeros((B,), dtype=torch.long, device=tok.device)
    return llama_mod.forward(params, st, tok[:, None], pos[:, None],
                             pos[:, None], cache, zero)


@torch.no_grad()
def greedy_generate(
    st: "llama_mod.LlamaStatic",
    params,
    prompt_tokens: torch.Tensor,   # [B, P] int32, already-tokenized prompt
    cache: KVCache,
    n_prompt: int,                 # true prompt length (P)
    n_steps: int,                  # number of tokens to generate
):
    """Prefill the prompt then generate n_steps greedily.

    Returns (tokens [B, n_steps], top_ids [B, n_steps, 10],
             top_vals [B, n_steps, 10], cache). The logits recorded for
    generated token i are the ones computed AFTER decoding it (the
    distribution token i+1 is sampled from)."""
    dev = cache.k.device
    prompt_tokens = prompt_tokens.to(dev)
    B, P = prompt_tokens.shape
    positions = torch.arange(P, dtype=torch.int32, device=dev).expand(B, P)
    li = torch.full((B,), n_prompt - 1, dtype=torch.long, device=dev)
    logits, cache = llama_mod.forward(params, st, prompt_tokens, positions,
                                      positions, cache, li)
    pos = torch.full((B,), n_prompt, dtype=torch.int32, device=dev)
    toks, ids, vals = [], [], []
    for _ in range(n_steps):
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        logits, cache = _step(st, params, cache, tok, pos)
        top_vals, top_ids = torch.topk(logits, 10, dim=-1)
        toks.append(tok)
        ids.append(top_ids)
        vals.append(top_vals)
        pos = pos + 1
    return (torch.stack(toks, 1), torch.stack(ids, 1), torch.stack(vals, 1), cache)


@torch.no_grad()
def teacher_forced(
    st: "llama_mod.LlamaStatic",
    params,
    cache: KVCache,
    tokens: torch.Tensor,     # [B, n] claimed tokens to force
    start_pos: torch.Tensor,  # [B] next position (= slot) per row
):
    """Teacher-forced decode loop (fillCtx): feed the given tokens one per
    step and capture each step's full logits. The step is continue_greedy's
    with the argmax replaced by the claimed token. Returns
    (all_logits [B, n, V] f32, cache)."""
    dev = cache.k.device
    tokens = tokens.to(dev)
    pos = start_pos.to(dev, torch.int32)
    out = []
    for i in range(tokens.shape[1]):
        logits, cache = _step(st, params, cache, tokens[:, i].to(torch.int32), pos)
        out.append(logits)
        pos = pos + 1
    return torch.stack(out, 1), cache


@torch.no_grad()
def continue_greedy(
    st: "llama_mod.LlamaStatic",
    params,
    cache: KVCache,
    logits0: torch.Tensor,    # [B, V] current logits
    start_pos: torch.Tensor,  # [B] next position (= slot) per row
    n_steps: int,
):
    """Continue greedy generation from an existing session state: argmax the
    current logits, decode that token at the next sequential slot, capture
    the new logits. Returns (tokens [B, n], full_logits [B, n, V] f32,
    cache)."""
    dev = cache.k.device
    logits = logits0.to(dev)
    pos = start_pos.to(dev, torch.int32)
    toks, out = [], []
    for _ in range(n_steps):
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        logits, cache = _step(st, params, cache, tok, pos)
        toks.append(tok)
        out.append(logits)
        pos = pos + 1
    return torch.stack(toks, 1), torch.stack(out, 1), cache
