"""Perplexity evaluation over a token stream.

Counterpart of blama_tpu/tools/perplexity.py: PPL = exp(mean NLL of
next-token prediction) over a token corpus, windowed like llama.cpp's
perplexity example (non-overlapping context windows of `ctx` tokens, the
first half of the first window skipped as warm-up when the corpus is longer
than one window). Each window is one forward of the model's own engine and
attention mode over a fresh f32 KV store, with the logits of every position
(models/llama.all_logits).

Usage: python -m blama_tpu_torch.tools.perplexity <model.gguf> <text-file>
                [--ctx 512] [--dtype bfloat16] [--device cuda]
"""

from __future__ import annotations

import math

import numpy as np
import torch


def perplexity(model, tokens: list[int], ctx: int = 512) -> dict:
    """Windowed next-token NLL over `tokens` → {ppl, nll, count}."""
    from ..models.llama import LlamaStatic, all_logits
    from ..ops.kv_cache import KVCache

    cfg = model.config
    if cfg.is_moe:
        raise NotImplementedError("perplexity runs llama-family files (models/llama.all_logits)")
    st = LlamaStatic.of(cfg)
    dev = model.device

    total_nll = 0.0
    count = 0
    for start in range(0, max(len(tokens) - 1, 1), ctx):
        window = tokens[start: start + ctx + 1]
        if len(window) < 2:
            break
        T = ctx
        n = min(len(window) - 1, T)
        inp = np.zeros((1, T), np.int32)
        inp[0, :n] = window[:n]
        pos = np.zeros((1, T), np.int32)
        pos[0, :n] = np.arange(n)
        slots = np.full((1, T), T, np.int32)
        slots[0, :n] = np.arange(n)
        cache = KVCache.create(cfg.n_layer, 1, T, cfg.n_head_kv, cfg.head_dim_,
                               torch.float32, device=dev)
        logits = all_logits(st, model.weights, *(torch.from_numpy(a).to(dev)
                                                 for a in (inp, pos, slots)), cache)
        lg = logits[0, :n].double().cpu().numpy()                       # [n, V]
        targets = np.asarray(window[1: n + 1])
        lo = n // 2 if start == 0 and len(tokens) > ctx else 0
        lse = np.log(np.exp(lg - lg.max(-1, keepdims=True)).sum(-1)) + lg.max(-1)
        nll = lse - lg[np.arange(n), targets]
        total_nll += float(nll[lo:].sum())
        count += n - lo
    ppl = math.exp(total_nll / count) if count else float("inf")
    return {"ppl": ppl, "nll": total_nll / max(count, 1), "count": count}


def main(argv=None) -> dict:
    import argparse

    from ..runtime.model import Model, ModelParams
    from .common import add_device, setup

    ap = argparse.ArgumentParser()
    ap.add_argument("model")
    ap.add_argument("textfile")
    ap.add_argument("--ctx", type=int, default=512)
    ap.add_argument("--dtype", default="bfloat16")
    add_device(ap)
    args = ap.parse_args(argv)
    dev, _ = setup(args)

    model = Model(args.model, ModelParams(dtype=args.dtype, device=str(dev)))
    with open(args.textfile, encoding="utf-8") as f:
        text = f.read()
    tokens = model.vocab.tokenize(text, True, False)
    result = perplexity(model, tokens, args.ctx)
    model.close()
    print(f"perplexity: {result['ppl']:.4f}  (nll {result['nll']:.4f} over "
          f"{result['count']} tokens)")
    return result


if __name__ == "__main__":
    main()
