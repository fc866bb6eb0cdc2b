"""Serving throughput of the continuous-batching scheduler (port of
blama_tpu/tools/bench_serving.py).

    python -m blama_tpu_torch.tools.bench_serving [preset] [dtype]
        [--device cpu] [--layers N]
      BLAMA_SERVE_STREAMS   concurrent requests (default 16)
      BLAMA_SERVE_BATCH     scheduler max_batch (default 8)
      BLAMA_SERVE_TOKENS    tokens per request (default 48)
      BLAMA_SERVE_PROMPT    prompt length (default 64)
      BLAMA_SERVE_PAGED     1 = the paged KV pool
      BLAMA_SERVE_CTX       per-row context window (default 2048)
      BLAMA_SERVE_HORIZON   device decode steps per scheduler call (default 8)

The preset is a synthesized file (testing.cached_llama_gguf, or
cached_moe_gguf for a MoE preset: random weights, the preset's widths,
`--layers` cuts the depth) or `tiny` (testing.write_tiny_llama). One warm-up
request runs first, then BLAMA_SERVE_STREAMS greedy requests of random prompt
tokens are submitted at once and the scheduler runs until idle. Prints one
JSON line: tokens/s over all rows, wall seconds, latency p50 / p90 from
submission to completion, the mean decode step and the scheduler's counters,
and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from .common import add_device, model_path, setup, sync


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device(ap)
    ap.add_argument("preset", nargs="?", default="llama3-8b")
    ap.add_argument("dtype", nargs="?", default="q4k_a8")
    ap.add_argument("--layers", type=int, default=None, help="cut the file's depth")
    args = ap.parse_args(argv)
    dev, card = setup(args)
    env = os.environ.get
    n_streams, max_batch = int(env("BLAMA_SERVE_STREAMS", "16")), int(env("BLAMA_SERVE_BATCH", "8"))
    n_tokens, n_prompt = int(env("BLAMA_SERVE_TOKENS", "48")), int(env("BLAMA_SERVE_PROMPT", "64"))
    paged = env("BLAMA_SERVE_PAGED", "0") == "1"
    ctx, horizon = int(env("BLAMA_SERVE_CTX", "2048")), int(env("BLAMA_SERVE_HORIZON", "8"))

    from ..runtime.model import Model, ModelParams
    from ..runtime.sampler import SamplerParams
    from ..server.scheduler import ContinuousBatchingScheduler, GenRequest

    path = model_path(args.preset, args.layers)
    t0 = time.perf_counter()
    model = Model(path, ModelParams(dtype=args.dtype, device=str(dev)))
    sync(dev)
    load_s = time.perf_counter() - t0
    sched = ContinuousBatchingScheduler(model, max_batch=max_batch, ctx_size=ctx, paged=paged,
                                        horizon=horizon)
    rng = np.random.default_rng(0)
    done, t_submit = {}, {}

    def mk_req(i):
        prompt = rng.integers(3, model.config.n_vocab - 1, n_prompt).tolist()

        def on_done(preds, i=i):
            done[i] = (time.perf_counter(), len(preds))
        return GenRequest(prompt=prompt, max_tokens=n_tokens,
                          sampler_params=SamplerParams(temp=0.0), on_done=on_done)

    sched.submit(mk_req(-1))                  # warm-up: the kernels' first launches
    t0 = time.perf_counter()
    sched.run_until_idle()
    warm_s = time.perf_counter() - t0
    done.clear()
    sched.metrics.reset()
    t_start = time.perf_counter()
    for i in range(n_streams):
        t_submit[i] = time.perf_counter()
        sched.submit(mk_req(i))
    sched.run_until_idle()
    sync(dev)
    wall = time.perf_counter() - t_start
    total = sum(n for _, n in done.values())
    lats = sorted(done[i][0] - t_submit[i] for i in done)
    counters = sched.metrics.counters
    out = dict(
        metric=f"serving_tokens_per_sec_{args.preset}_{args.dtype}",
        value=total / wall, unit="tokens/s over all rows", card=card,
        detail=dict(streams=n_streams, max_batch=max_batch, tokens_per_req=n_tokens,
                    prompt_len=n_prompt, paged=paged, ctx=ctx, horizon=sched.horizon,
                    layers=model.config.n_layer, load_s=load_s, warmup_s=warm_s,
                    wall_s=wall, completed=len(done),
                    latency_p50_s=lats[len(lats) // 2] if lats else None,
                    latency_p90_s=lats[int(len(lats) * 0.9)] if lats else None,
                    decode_step_ms=1e3 * counters["decode_step"].mean_s
                    if "decode_step" in counters else None,
                    tokens_decoded=sched.metrics.tokens_decoded,
                    timers_s={k: c.total_s for k, c in counters.items()}))
    print(json.dumps(out), flush=True)
    model.close()
    return out


if __name__ == "__main__":
    main()
