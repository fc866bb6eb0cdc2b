"""Greedy, teacher-forced and scheduler decode loops.

Counterpart of blama_tpu/ops/generate_loop.py. Each loop is a Python loop
of T == 1 forwards whose token choice (torch.argmax) and top-10 capture
(torch.topk) stay on the device; nothing is pulled to the host inside the
loop. `scheduler_loop` is the continuous-batching scheduler's horizon: the
same step over a batch that mixes greedy, teacher-forced and idle rows, on
dense rows or the paged pool. The prover's loops (greedy_generate, continue_greedy) and the
verifier's (teacher_forced) run the same per-step forward at the same
shapes, so a same-backend replay reproduces the prover's logits bit for
bit. Slots are sequential (slot = position), matching the SlotAllocator.
Every loop serves llama and MoE models alike: it calls its static config's
step (static_of, the reference's _forward_for), upgraded by `_mode_for` to
the reference's opt-in decode-attention mode for the loop's cache.

On the card each loop runs its decode steps as replays of one captured
graph (ops/step_graph.py, the counterpart of the reference's lax.scan):
`graphs` is the owner's StepGraphs, None (a new one for the call) or False
(eager launches, for comparison). On the CPU the loops run eagerly.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from ..models import gpt2 as gpt2_mod
from ..models import llama as llama_mod
from ..models import moe as moe_mod
from . import decode_attention as dattn
from . import paged_kv as pkv
from .kv_cache import KVCache, SlotStore
from .step_graph import graphs_for

# the reference's opt-in decode-attention modes, read once at import as it
# reads them (blama_tpu/ops/generate_loop.py:37, :49); tests set the
# attributes. BLAMA_ATTN_WRITE=1: kernel P stores the token's K/V row and
# attends in one launch; BLAMA_ATTN_FRESH=1 (INT8 KV): kernel N attends with
# the fresh row as an operand, before the cache write. Both give the bits of
# the cache write followed by kernel C; off by default, as in the reference.
_WRITE_IN_KERNEL = os.environ.get("BLAMA_ATTN_WRITE", "0") == "1"
_FRESH_OPERAND = os.environ.get("BLAMA_ATTN_FRESH", "0") == "1"


def _mode_for(st, cache):
    """The loop body's static for this cache: the reference's `_fused_merge`
    + `_st_for` (its generate_loop.py:52-179) without their relayouts (the
    merged, grouped and transposed carries are TPU layouts; the port's
    stores stay [L, B*S, Hkv, D]). Dense rows of a llama model whose T == 1
    steps take the fused kernel get write mode where `write_supports` passes
    (any store type); else an INT8 store gets fresh mode where
    `fresh_supports` passes, else the transposed-scale mode (which keeps the
    head-batched kernel off, as there). Anything else (the two-pass mode,
    attn_fused=False, among it) keeps `st`."""
    if not isinstance(st, llama_mod.LlamaStatic) or not isinstance(cache, KVCache):
        return st
    S, D, B, dtype = cache.n_slots, st.head_dim, cache.batch, cache.k_store.dtype
    if (not st.attn_fused or not st.causal or (st.yarn is not None and st.rope_dim < D)
            or not dattn.supports(S, D, dtype, B)):
        return st
    if _WRITE_IN_KERNEL and dattn.write_supports(S, D, dtype, B):
        return dataclasses.replace(st, attn_write=True)
    if not cache.quantized:
        return st
    fresh = _FRESH_OPERAND and dattn.fresh_supports(S, D, dtype, B)
    return dataclasses.replace(st, attn_scales_t=True, attn_fresh=fresh)


def static_of(cfg):
    """The static config of a model config, which carries its forward as
    `step`: GPT2Static for a gpt2 model, MoEStatic for a MoE (Mixtral-family)
    one, else LlamaStatic. The one place the loops, the session, the
    instance and the scheduler tell the families apart."""
    if cfg.arch == "gpt2":
        return gpt2_mod.GPT2Static.of(cfg)
    return (moe_mod.MoEStatic if cfg.is_moe else llama_mod.LlamaStatic).of(cfg)


def _step(st, params, cache, tok, pos):
    B = tok.shape[0]
    zero = torch.zeros((B,), dtype=torch.long, device=tok.device)
    return st.step(params, tok[:, None], pos[:, None], pos[:, None], cache, zero)


@torch.no_grad()
def greedy_generate(
    st: llama_mod.LlamaStatic | moe_mod.MoEStatic,
    params,
    prompt_tokens: torch.Tensor,   # [B, P] int32, already-tokenized prompt
    cache: KVCache,
    n_prompt: int,                 # true prompt length (P)
    n_steps: int,                  # number of tokens to generate
    graphs=None,
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
    logits, cache = st.step(params, prompt_tokens, positions, positions, cache, li)
    st = _mode_for(st, cache)
    pos = torch.full((B,), n_prompt, dtype=torch.int32, device=dev)
    sg = graphs_for(graphs, dev)
    if sg is not None:
        o = sg.loop(st, params, cache, logits, pos, n_steps, top=True)
        return o["toks"], o["top_ids"], o["top_vals"], cache
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
    st: llama_mod.LlamaStatic | moe_mod.MoEStatic,
    params,
    cache: KVCache,
    tokens: torch.Tensor,     # [B, n] claimed tokens to force
    start_pos: torch.Tensor,  # [B] next position (= slot) per row
    graphs=None,
):
    """Teacher-forced decode loop (fillCtx): feed the given tokens one per
    step and capture each step's full logits. The step is continue_greedy's
    with the argmax replaced by the claimed token. Returns
    (all_logits [B, n, V] f32, cache)."""
    dev = cache.k.device
    st = _mode_for(st, cache)
    tokens = tokens.to(dev)
    pos = start_pos.to(dev, torch.int32)
    sg = graphs_for(graphs, dev)
    if sg is not None:
        # every token is forced, so the carried logits' argmax is never read
        logits0 = torch.zeros((tokens.shape[0], 1), dtype=torch.float32, device=dev)
        o = sg.loop(st, params, cache, logits0, pos, tokens.shape[1],
                    forced=tokens.to(torch.int32), full=True)
        return o["full"], cache
    out = []
    for i in range(tokens.shape[1]):
        logits, cache = _step(st, params, cache, tokens[:, i].to(torch.int32), pos)
        out.append(logits)
        pos = pos + 1
    return torch.stack(out, 1), cache


@torch.no_grad()
def continue_greedy(
    st: llama_mod.LlamaStatic | moe_mod.MoEStatic,
    params,
    cache: KVCache,
    logits0: torch.Tensor,    # [B, V] current logits
    start_pos: torch.Tensor,  # [B] next position (= slot) per row
    n_steps: int,
    graphs=None,
):
    """Continue greedy generation from an existing session state: argmax the
    current logits, decode that token at the next sequential slot, capture
    the new logits. Returns (tokens [B, n], full_logits [B, n, V] f32,
    cache)."""
    dev = cache.k.device
    st = _mode_for(st, cache)
    logits = logits0.to(dev)
    pos = start_pos.to(dev, torch.int32)
    sg = graphs_for(graphs, dev)
    if sg is not None:
        o = sg.loop(st, params, cache, logits, pos, n_steps, full=True)
        return o["toks"], o["full"], cache
    toks, out = [], []
    for _ in range(n_steps):
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        logits, cache = _step(st, params, cache, tok, pos)
        toks.append(tok)
        out.append(logits)
        pos = pos + 1
    return torch.stack(toks, 1), torch.stack(out, 1), cache


@torch.no_grad()
def scheduler_loop(
    st: llama_mod.LlamaStatic | moe_mod.MoEStatic,
    params,
    cache: SlotStore,
    logits0: torch.Tensor,      # [B, V] f32, stays on the device between horizons
    start_pos: torch.Tensor,    # [B] int32 next position (= slot, dense rows)
    forced_toks: torch.Tensor,  # [B, H] int32; -1 = greedy-argmax this row/step
    claimed_ids: torch.Tensor,  # [B, H, 10] int32 ids to gather (verify rows)
    n_steps: int,
    graphs=None,
):
    """H decode steps for the continuous-batching scheduler with the logits
    kept ON the device (carried in and out as a device tensor). Mixes greedy
    rows (argmax) and teacher-forced verification rows (forced_toks >= 0)
    per step and returns only small per-step outputs: sampled tokens, the
    top-10 capture, and the logit values at each verify row's claimed top-10
    ids. Inactive rows (forced_toks == -2) pass a pad slot, so their writes
    go to the store's spare slot (kernel P's too, in write mode).

    Per-row arithmetic is the batched T == 1 step the per-token path runs,
    so greedy tokens match the per-token scheduler. Returns (toks [B, H],
    top_ids [B, H, 10], top_vals [B, H, 10], claimed_vals [B, H, 10],
    logits [B, V], cache)."""
    dev = cache.device
    st = _mode_for(st, cache)
    logits = logits0.to(dev)
    pos = start_pos.to(dev, torch.int32)
    forced_toks = forced_toks.to(dev, torch.int32)
    claimed_ids = claimed_ids.to(dev).long()
    sg = graphs_for(graphs, dev)
    if sg is not None:
        o = sg.loop(st, params, cache, logits, pos, n_steps, forced=forced_toks,
                    claimed=claimed_ids, top=True)
        return (o["toks"], o["top_ids"], o["top_vals"], o["claimed_vals"], o["logits"],
                cache)
    B = logits.shape[0]
    paged = isinstance(cache, pkv.PagedKVCache)
    n_slots = cache.n_slots      # a slot >= n_slots is a pad
    zero = torch.zeros((B,), dtype=torch.long, device=dev)
    toks, tids, tvals, cvals = [], [], [], []
    for i in range(n_steps):
        forced = forced_toks[:, i]
        greedy = torch.argmax(logits, dim=-1).to(torch.int32)
        tok = torch.where(forced >= 0, torch.clamp(forced, min=0), greedy)
        inactive = forced == -2
        if paged:
            # flat pool slot via the row's page table (pages pre-allocated
            # host-side for the whole horizon before the loop)
            G = cache.page_size
            page = torch.gather(cache.page_table, 1,
                                torch.div(pos, G, rounding_mode="floor")[:, None].long())[:, 0]
            slot = torch.where(inactive, n_slots, page * G + pos % G)
        else:
            slot = torch.where(inactive, n_slots, pos)
        logits, cache = st.step(params, tok[:, None], pos[:, None], slot[:, None],
                                cache, zero)
        top_vals, top_ids = torch.topk(logits, 10, dim=-1)
        toks.append(tok)
        tids.append(top_ids)
        tvals.append(top_vals)
        cvals.append(torch.gather(logits, 1, claimed_ids[:, i]))
        pos = pos + 1
    return (torch.stack(toks, 1), torch.stack(tids, 1), torch.stack(tvals, 1),
            torch.stack(cvals, 1), logits, cache)
