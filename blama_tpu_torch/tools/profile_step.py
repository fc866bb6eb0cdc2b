"""Where a decode step's time goes on the card, graphed and eager.

    python -m blama_tpu_torch.tools.profile_step [--steps 16] [--ctx 2048] [--scheduler]
        [--dtype q4k_a8] [--quant Q4_K] [--layers N] [--moe] [--tp-blocks N]
        [--kv int8|bf16|f32] [--attn-mode write|fresh|hb] [--prompt 128] [--eager]

Loads the synthesized llama3-8b GGUF (testing.cached_llama_gguf; `--quant`
Q4_K, Q8_0 or Q4_K_M, `--layers` cuts its depth) as engine `--dtype` (any of
runtime.model.ENGINES, e.g. `q4k_fused`, or `q8_0_fused` with `--quant Q8_0`);
with `--moe` the synthesized mixtral-8x7b GGUF (testing.cached_moe_gguf,
Mixtral-8x7B's widths, `--layers` deep, default 8) as `q4k_a8` or
`q4k_fused` with the two-pass attention chain (attn="xla"). `--tp-blocks N`
loads it in the fixed-topology tp_blocks mode (ModelParams.tp_blocks; the
mode a solo verifier of a prover sharded over tp | N devices runs). `--kv`
is the solo cache's store type (default INT8), `--attn-mode` turns on one of
the reference's opt-in decode-attention modes (BLAMA_ATTN_WRITE: kernel P,
BLAMA_ATTN_FRESH: N on an INT8 store, BLAMA_ATTN_HB: O). It
prefills a `--prompt`-token prompt (default 128; near `--ctx` the decode
attention reads a filled context), then times greedy decode steps
(generate_loop.continue_greedy) as the loops run them on the card: replays
of the captured step graph (ops/step_graph.py). `--eager` also times the
same steps with every kernel launched from Python (graphs=False), in the
same process, and prints the ratios. With `--scheduler` the step is the
serving step: the continuous-batching scheduler with 8 rows on the paged
bf16 pool, each row a greedy request over a 128-token prompt, driven one
horizon of 8 batched decode steps at a time (ops.generate_loop.scheduler_loop,
host bookkeeping included).

For each way it prints: wall ms/step with the device synchronized; the
device span ms/step (CUDA events around the timed steps: device time from
the first kernel to the last, gaps between kernels included); one
torch.profiler window over the same steps for the device time per kernel
(device-busy ms/step, the sum of kernel times, and the device activities a
step), the idle share 1 - busy/wall, the top kernels and host ops, the
one-row exact kernels' device time and calls a step (B, G, H, K and L at one
row) and the decode attention kernels' (C, N, O, P and O's combine). Where the profiler attributes no kernel to a graph's replays, busy and
the kernel list read null and the span stands in for busy (printed as
`busy_from`). Also: the seconds to synthesize (or find) the file and to load
it, the GiB on the card after the load, the graphs' captures (seconds, GiB
the reserved memory grew by), and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import time

KV_DTYPES = {"int8": "int8", "bf16": "bfloat16", "f32": "float32"}
# the one-row calls of B, G, H, K and L by kernel name: the exact tiles at a
# one-row shape (Tile<1, ...>),
# and the column-per-thread kernels they replaced (dequant_row_kernel,
# dequant_parts_row_kernel, dequant_bank_row_kernel), so the tool reads a
# tree of either
ONE_ROW_KERNELS = re.compile(
    r"\bdequant_(parts_|bank_)?row_kernel\b|\bdequant_(bank_)?tile_kernel<[^,]*::Tile<1, ")
# the decode step's attention kernels by name: the body of C, E, N and P
# (decode_kernel), O's (hb_angles_kernel and decode_hb_kernel; its first
# form decode_attn_hb_kernel and the combine launched after it, so the tool
# reads a tree of either)
DECODE_ATTENTION_KERNELS = re.compile(
    r"\b(decode_kernel|hb_angles_kernel|decode_hb_kernel|decode_attn_hb_kernel)<"
    r"|\bdecode_combine_kernel\b")


def solo_steps(model, kv="int8", ctx=2048, graphs=True, prompt_len=128, seed=7):
    """(steps(n), graphs): n greedy decode steps of one solo Instance after
    a `prompt_len`-token prompt, through the Instance's graphs (False:
    eager)."""
    import numpy as np
    import torch

    from ..ops.generate_loop import continue_greedy, static_of
    from ..runtime.instance import Instance, InstanceInitParams

    inst = Instance(model, InstanceInitParams(ctx_size=ctx, flash_attn=True, kv_dtype=kv,
                                              graphs=graphs))
    rng = np.random.default_rng(seed)
    prompt = [1] + rng.integers(259, model.config.n_vocab, prompt_len - 1).tolist()
    logits = inst.decode(prompt, np.arange(len(prompt)))
    st = static_of(inst.step_config)
    n_past = len(prompt)

    def steps(n):
        nonlocal n_past
        _, lg, inst.cache = continue_greedy(
            st, model.weights, inst.cache, torch.from_numpy(logits[None]),
            torch.tensor([n_past], dtype=torch.int32), n, graphs=inst.graphs)
        n_past += n
        return lg
    return steps, inst.graphs


def scheduler_steps(model, n_steps, ctx=2048, graphs=True, rows=8, horizon=8, seed=7):
    """(steps(n), graphs): batched decode steps of the paged scheduler, a
    horizon at a time, after admitting `rows` greedy 128-token requests and
    one horizon; the rows last n_steps steps and three more horizons."""
    import numpy as np

    from ..runtime.sampler import SamplerParams
    from ..server.scheduler import ContinuousBatchingScheduler, GenRequest

    rng = np.random.default_rng(seed)
    sched = ContinuousBatchingScheduler(model, max_batch=rows, ctx_size=ctx, paged=True,
                                        horizon=horizon, graphs=graphs)
    for _ in range(rows):
        sched.submit(GenRequest(
            prompt=[1] + rng.integers(259, model.config.n_vocab, 127).tolist(),
            max_tokens=n_steps + 4 * horizon, sampler_params=SamplerParams(temp=0.0)))

    def steps(n):
        for _ in range(n // horizon):
            sched._iteration()

    steps(horizon)                     # admission, joint prefill, one horizon
    return steps, sched._graphs


def measure(steps, n_steps, warm_steps, host_ops=True):
    """Wall, device span and the profiler's view of n_steps steps (the host
    ops too unless `host_ops` is false: a device-only trace is cheaper)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    steps(warm_steps)                          # warm (and capture, graphed)
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.record()
    steps(n_steps)
    e.record()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / n_steps
    span_ms = s.elapsed_time(e) / n_steps

    acts = [ProfilerActivity.CPU] * host_ops + [ProfilerActivity.CUDA]
    with profile(activities=acts, acc_events=True) as prof:
        steps(n_steps)
        torch.cuda.synchronize()
    ev = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)

    # device-side events only (the aten ops also carry their kernels' time)
    kern = sorted(((e.key, dev_us(e) / n_steps / 1e3, e.count // n_steps)
                   for e in ev if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                  key=lambda r: -r[1])
    host = sorted(((e.key, e.self_cpu_time_total / n_steps / 1e3, e.count // n_steps)
                   for e in ev if e.self_cpu_time_total > 0), key=lambda r: -r[1])
    busy = sum(r[1] for r in kern) or None
    one_row = [r for r in kern if ONE_ROW_KERNELS.search(r[0])]
    attn = [r for r in kern if DECODE_ATTENTION_KERNELS.search(r[0])]
    # device activities a step (kernels, copies, sets)
    launches = sum(e.count for e in ev
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0) / n_steps
    idle_of = busy or span_ms
    return dict(
        wall_ms_per_step=wall_ms, device_span_ms_per_step=span_ms,
        device_busy_ms_per_step=busy, busy_from="profiler" if busy else "span",
        device_launches_per_step=launches if busy else None,
        idle_share=1 - idle_of / wall_ms,
        one_row_kernels=dict(ms_per_step=sum(r[1] for r in one_row),
                             calls_per_step=sum(r[2] for r in one_row)),
        decode_attention_kernels=dict(
            ms_per_step=sum(r[1] for r in attn), calls_per_step=sum(r[2] for r in attn),
            each=[dict(name=k[:80], ms_per_step=t, calls_per_step=c) for k, t, c in attn]),
        top_kernels=[dict(name=k[:80], ms_per_step=t, calls_per_step=c) for k, t, c in kern[:16]],
        top_host_ops=[dict(name=k[:80], ms_per_step=t, calls_per_step=c)
                      for k, t, c in host[:12]])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--ctx", type=int, default=2048)
    ap.add_argument("--scheduler", action="store_true",
                    help="profile the batched paged serving step (8 rows)")
    ap.add_argument("--dtype", default="q4k_a8", help="weight engine (runtime.model.ENGINES)")
    ap.add_argument("--quant", default="Q4_K", choices=["Q4_K", "Q8_0", "Q4_K_M"],
                    help="tensor types of the synthesized file")
    ap.add_argument("--layers", type=int, default=None, help="cut the file's depth")
    ap.add_argument("--moe", action="store_true",
                    help="the mixtral-8x7b MoE file (default depth 8 layers)")
    ap.add_argument("--tp-blocks", type=int, default=-1,
                    help="ModelParams.tp_blocks (fixed-topology blocks; -1: none)")
    ap.add_argument("--kv", default="int8", choices=list(KV_DTYPES),
                    help="the solo cache's store type")
    ap.add_argument("--attn-mode", choices=["write", "fresh", "hb"], default=None,
                    help="a decode-attention mode (BLAMA_ATTN_WRITE / _FRESH / _HB)")
    ap.add_argument("--prompt", type=int, default=128,
                    help="the solo prompt's tokens (the context the steps read)")
    ap.add_argument("--eager", action="store_true",
                    help="also time the steps with eager launches (graphs=False)")
    args = ap.parse_args()

    import torch

    from ..gguf import GGMLType
    from ..ops import decode_attention as dattn
    from ..ops import generate_loop as gl
    from ..runtime.model import Model, ModelParams
    from ..testing import Q4_K_M, cached_llama_gguf, cached_moe_gguf

    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")
    # the modes' flags, as their env vars would set them at import
    gl._WRITE_IN_KERNEL = args.attn_mode == "write"
    gl._FRESH_OPERAND = args.attn_mode == "fresh"
    dattn._HB = args.attn_mode == "hb"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    if args.moe:
        path = cached_moe_gguf("mixtral-8x7b", seed=11, n_layer=args.layers or 8)
    else:
        quant = Q4_K_M if args.quant == Q4_K_M else GGMLType[args.quant]
        path = cached_llama_gguf("llama3-8b", seed=7, quant=quant, n_layer=args.layers)
    file_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = Model(path, ModelParams(dtype=args.dtype, tp_blocks=args.tp_blocks,
                                    attn="xla" if args.moe else "fused"))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    weights_gib = torch.cuda.memory_allocated() / 2 ** 30
    rows, horizon = (8, 8) if args.scheduler else (1, 1)
    if args.steps % horizon:
        raise SystemExit(f"--steps must be a multiple of the horizon ({horizon})")
    if not args.scheduler and args.prompt + 2 * args.steps + 2 > args.ctx:
        raise SystemExit("--prompt and twice --steps (and 2 warm steps) must fit --ctx")

    out = dict(card=smi, mode="scheduler" if args.scheduler else "solo", rows=rows,
               engine=args.dtype, tp_blocks=model.config.tp_blocks,
               kv=args.kv if not args.scheduler else "bf16", attn_mode=args.attn_mode,
               file="mixtral-8x7b" if args.moe else args.quant,
               layers=model.config.n_layer, file_s=file_s, load_s=load_s,
               weights_gib=weights_gib, steps=args.steps, ctx=args.ctx,
               prompt=None if args.scheduler else args.prompt)
    for way in ("graphed", "eager") if args.eager else ("graphed",):
        graphs = way == "graphed"
        if args.scheduler:
            steps, held = scheduler_steps(model, 2 * args.steps, args.ctx, graphs)
        else:
            steps, held = solo_steps(model, KV_DTYPES[args.kv], args.ctx, graphs, args.prompt)
        out[way] = measure(steps, args.steps, 2 * horizon)
        if graphs:
            out[way]["captures"] = held.captures
            out[way]["graphs_gib"] = held.pool_gib()
        del steps, held
        torch.cuda.empty_cache()
    if args.eager:
        g, e = out["graphed"], out["eager"]
        out["graphed_over_eager"] = dict(
            wall=g["wall_ms_per_step"] / e["wall_ms_per_step"],
            busy=(g["device_busy_ms_per_step"] / e["device_busy_ms_per_step"]
                  if g["device_busy_ms_per_step"] and e["device_busy_ms_per_step"] else None))
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
