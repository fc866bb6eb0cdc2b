"""Where a decode step's time goes on the card.

    python -m blama_tpu_torch.tools.profile_step [--steps 16] [--ctx 2048]

Loads the synthesized llama3-8b `q4k_a8` GGUF (testing.cached_llama_gguf),
prefills a 128-token prompt, then times greedy decode steps
(generate_loop.continue_greedy): wall time per step with the device
synchronized, and one torch.profiler window over the same steps for the
device time per kernel. Prints one JSON object: wall ms/step, device-busy
ms/step (the sum of kernel times), the idle share 1 - busy/wall, the top
kernels and host ops, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--ctx", type=int, default=2048)
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..models.llama import LlamaStatic
    from ..ops.generate_loop import continue_greedy
    from ..runtime.instance import Instance, InstanceInitParams
    from ..runtime.model import Model, ModelParams
    from ..testing import cached_llama_gguf

    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    model = Model(cached_llama_gguf("llama3-8b", seed=7),
                  ModelParams(dtype="q4k_a8", attn="fused"))
    inst = Instance(model, InstanceInitParams(ctx_size=args.ctx, flash_attn=True,
                                              kv_dtype="int8"))
    rng = np.random.default_rng(7)
    prompt = [1] + rng.integers(259, model.config.n_vocab, 127).tolist()
    logits = inst.decode(prompt, np.arange(len(prompt)))
    st = LlamaStatic.of(inst.step_config)
    n_past = len(prompt)

    def steps(n):
        nonlocal n_past
        _, lg, inst.cache = continue_greedy(
            st, model.weights, inst.cache, torch.from_numpy(logits[None]),
            torch.tensor([n_past], dtype=torch.int32), n)
        n_past += n
        return lg

    steps(2)                                   # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps(args.steps)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / args.steps

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        steps(args.steps)
        torch.cuda.synchronize()
    ev = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)

    # device-side events only (the aten ops also carry their kernels' time)
    kern = sorted(((e.key, dev_us(e) / args.steps / 1e3, e.count // args.steps)
                   for e in ev if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                  key=lambda r: -r[1])
    host = sorted(((e.key, e.self_cpu_time_total / args.steps / 1e3, e.count // args.steps)
                   for e in ev if e.self_cpu_time_total > 0), key=lambda r: -r[1])
    busy = sum(r[1] for r in kern)
    print(json.dumps(dict(
        card=smi, steps=args.steps, ctx=args.ctx, wall_ms_per_step=wall_ms,
        device_busy_ms_per_step=busy,
        idle_share=(1 - busy / wall_ms) if busy else None,
        top_kernels=[dict(name=k[:80], ms_per_step=t, calls_per_step=c) for k, t, c in kern[:12]],
        top_host_ops=[dict(name=k[:80], ms_per_step=t, calls_per_step=c) for k, t, c in host[:12]],
    ), indent=1))


if __name__ == "__main__":
    main()
