"""Quantization perplexity delta across weight engines.

Counterpart of blama_tpu/tools/ppl_compare.py: the same synthesized GGUF
(random weights, real layouts) evaluated under `bfloat16` (every tensor
dequantized) and the packed engines `q4k_fused` and `q4k_a8`, over a
deterministic pseudo-token corpus. The model is synthetic, so the
informative number is the DELTA (quantization noise on the next-token
distribution), not the absolute perplexity.

Usage: python -m blama_tpu_torch.tools.ppl_compare [preset] [ctx] [windows]
           [--layers N] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

ENGINES = ("bfloat16", "q4k_fused", "q4k_a8")


def corpus(n_vocab: int, ctx: int, windows: int) -> list[int]:
    """The deterministic pseudo-token corpus: `windows` windows of `ctx`
    tokens and the last one's target."""
    rng = np.random.default_rng(42)
    return rng.integers(3, n_vocab - 1, ctx * windows + 1).tolist()


def main(argv=None) -> dict:
    from ..runtime.model import Model, ModelParams
    from ..testing import cached_llama_gguf
    from .common import add_device, setup
    from .perplexity import perplexity

    ap = argparse.ArgumentParser()
    ap.add_argument("preset", nargs="?", default="tinyllama-1.1b")
    ap.add_argument("ctx", nargs="?", type=int, default=512)
    ap.add_argument("windows", nargs="?", type=int, default=2)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the preset's depth (its widths stay)")
    add_device(ap)
    args = ap.parse_args(argv)
    dev, card = setup(args)

    path = cached_llama_gguf(args.preset, n_layer=args.layers)
    probe = Model(path, ModelParams(vocab_only=True, device=str(dev)))
    n_vocab = probe.config.n_vocab
    probe.close()
    tokens = corpus(n_vocab, args.ctx, args.windows)

    out = {}
    for dtype in ENGINES:
        m = Model(path, ModelParams(dtype=dtype, device=str(dev)))
        r = perplexity(m, tokens, ctx=args.ctx)
        m.close()
        out[dtype] = r
        print(f"# {dtype}: ppl={r['ppl']:.4f} nll={r['nll']:.5f} n={r['count']}",
              file=sys.stderr)
    base = out["bfloat16"]["ppl"]
    result = {
        "preset": args.preset, "layers": args.layers, "ctx": args.ctx,
        "windows": args.windows, "device": card,
        "ppl": {k: round(v["ppl"], 4) for k, v in out.items()},
        "delta_vs_bf16_pct": {k: round(100.0 * (v["ppl"] - base) / base, 3)
                              for k, v in out.items() if k != "bfloat16"},
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
