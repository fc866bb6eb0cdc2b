"""A profiler trace of a few decode steps, with per-op totals (port of
blama_tpu/tools/trace_step.py).

    python -m blama_tpu_torch.tools.trace_step [preset] [n_steps]
        [--device cpu] [--dtype q4k_a8] [--layers N] [--kv int8|bf16|f32]
        [--ctx 2048] [--top 25]

Loads the preset's file (a synthesized one, or `tiny`, as bench_serving),
prefills an 8-token prompt on a solo Instance, runs n_steps greedy decode
steps (ops/generate_loop.continue_greedy) to warm up (on the card: the
capture of the Instance's loop graph, replayed in the window), then the
same number again inside one torch.profiler window (CPU and CUDA
activity). Prints the
device time per kernel name over the window (the host's op times on the
CPU), each also per step, and writes the window's Chrome trace to
build/traces/ at the repository root (not tracked), which chrome://tracing
or Perfetto open.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops.kernels import BUILD_DIR
from .common import add_device, model_path, setup, sync

KV = {"int8": "int8", "bf16": "bfloat16", "f32": "float32"}
TRACE_DIR = BUILD_DIR.parent / "traces"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device(ap)
    ap.add_argument("preset", nargs="?", default="llama3-8b")
    ap.add_argument("n_steps", nargs="?", type=int, default=8)
    ap.add_argument("--dtype", default="q4k_a8")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--kv", choices=list(KV), default="int8")
    ap.add_argument("--ctx", type=int, default=2048)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    dev, card = setup(args)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..ops.generate_loop import continue_greedy, static_of
    from ..runtime.instance import Instance, InstanceInitParams
    from ..runtime.model import Model, ModelParams

    model = Model(model_path(args.preset, args.layers),
                  ModelParams(dtype=args.dtype, device=str(dev)))
    inst = Instance(model, InstanceInitParams(ctx_size=args.ctx, flash_attn=True,
                                              kv_dtype=KV[args.kv]))
    prompt = [1] + np.random.default_rng(0).integers(3, model.config.n_vocab - 1, 7).tolist()
    logits = inst.decode(prompt, np.arange(len(prompt)))
    st = static_of(inst.step_config)
    n_past, n = len(prompt), args.n_steps

    def steps():
        nonlocal n_past
        _, lg, inst.cache = continue_greedy(
            st, model.weights, inst.cache, torch.from_numpy(logits[None]),
            torch.tensor([n_past], dtype=torch.int32), n, graphs=inst.graphs)
        n_past += n

    steps()                                            # warm
    sync(dev)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts, acc_events=True) as prof:
        steps()
        sync(dev)
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    trace = TRACE_DIR / f"trace_step-{args.preset}-{args.dtype}-{dev.type}.json"
    prof.export_chrome_trace(str(trace))

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)

    ev = prof.key_averages()
    if dev.type == "cuda":
        rows = [(e.key, dev_us(e) / 1e3, e.count) for e in ev
                if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    else:
        rows = [(e.key, e.self_cpu_time_total / 1e3, e.count) for e in ev
                if e.self_cpu_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    what = "device" if dev.type == "cuda" else "host (cpu)"
    print(f"# traced {n} decode steps to {trace}", flush=True)
    print(f"{what} op total: {total:.3f} ms over {len(rows)} op names "
          f"({total / n:.4f} ms/step)", flush=True)
    for name, ms, count in rows[:args.top]:
        print(f"  {ms:9.3f} ms  {ms / n:8.4f} ms/step  x{count:<6d} {name[:90]}", flush=True)
    model.close()
    return dict(card=card, steps=n, trace=str(trace), total_ms=total,
                top=[dict(name=k, ms=t, count=c) for k, t, c in rows[:args.top]])


if __name__ == "__main__":
    main()
