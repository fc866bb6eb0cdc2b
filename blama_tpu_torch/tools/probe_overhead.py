"""Fixed cost per op of small chains, eager and replayed from a CUDA graph
(port of blama_tpu/tools/probe_overhead.py).

    python -m blama_tpu_torch.tools.probe_overhead [--device cpu] [--r 32]
        [--n-lo 8] [--n-hi 64] [--reps 3]

Six probes, each a chain of n elements repeated R times: an elementwise
rsqrt chain on [1, 4096] f32; a norm chain (mean of squares, rsqrt, scale);
cache-row writes of [512, 8, 128] bf16 rows into [32, 1, 512, 8, 128]; the
W4A8 activation prologue (quant_matmul.quant_acts) at K = 4096; ops/rope on
q [1, 1, 32, 128] bf16; kernel S (ops/probes.add_one, x + 1 on [8, 128]
f32, one CTA). Per element it prints (t(n_hi) - t(n_lo)) / (R (n_hi - n_lo))
of the host clock around the R repetitions and a synchronize, so the fixed
cost of a run cancels: eagerly (each element's torch ops or ctypes launch
dispatched from Python), and on the card with one chain of n captured in a
torch.cuda.CUDAGraph and replayed R times. The graph run of kernel S checks
that its ctypes launch, made on the capturing stream, was captured: a
replay must add n to the state, exactly. LAUNCHES counts host calls, so
under capture it counts each captured launch once, and a replay not at all.
"""

from __future__ import annotations

import argparse

import torch

from ..ops import kernels, probes
from ..ops import quant_matmul as qm
from ..ops.rope import apply_rope, rope_angles
from .common import add_device, graphed, setup, sync, wall_ms


def _chains(dev):
    """name → (unit, make(n) → step(): one chain of n elements applied to a
    persistent state in place)."""

    def elementwise(n):
        st = torch.ones((1, 4096), dtype=torch.float32, device=dev)

        def step():
            x = st
            for i in range(n):
                x = torch.rsqrt(torch.abs(x) + (1.0 + i * 1e-6))
            st.copy_(x)
        return step

    def norm(n):
        st = torch.ones((1, 4096), dtype=torch.float32, device=dev)

        def step():
            x = st
            for i in range(n):
                m = torch.mean(x * x, dim=-1, keepdim=True)
                x = x * torch.rsqrt(m + (1e-5 + i * 1e-9))
            st.copy_(x)
        return step

    def cache_write(n):
        c = torch.zeros((32, 1, 512, 8, 128), dtype=torch.bfloat16, device=dev)
        u0 = torch.ones((1, 512, 8, 128), dtype=torch.bfloat16, device=dev)

        def step():
            for i in range(n):
                c[i % 32] = u0 * float(i + 1)
        return step

    def prologue(n):
        st = torch.ones((1, 4096), dtype=torch.float32, device=dev)

        def step():
            x = st
            for i in range(n):
                xq, xs, sxm = qm.quant_acts(x + i * 1e-9)
                x = x + xq[:, :1].float() * 1e-30 + xs[:, :1] * 1e-30
            st.copy_(x)
        return step

    def rope(n):
        st = torch.ones((1, 1, 32, 128), dtype=torch.bfloat16, device=dev)
        pos = torch.ones((1, 1), dtype=torch.int32, device=dev)
        cs = rope_angles(pos, 128, 500000.0)

        def step():
            q = st
            for i in range(n):
                q = apply_rope(q, pos, 128, 500000.0, True, cos_sin=cs) + i * 1e-9
            st.copy_(q)
        return step

    def kernel_s(n):
        st = torch.zeros((8, 128), dtype=torch.float32, device=dev)

        def step():
            x = st
            for _ in range(n):
                x = probes.add_one(x)
            st.copy_(x)
        step.state = st
        return step

    return {"elementwise rsqrt [1,4096]": elementwise, "norm (reduce+scale) [1,4096]": norm,
            "cache row write [512,8,128] bf16": cache_write,
            "W4A8 prologue K=4096": prologue, "rope q [1,1,32,128]": rope,
            "kernel S (x+1, one CTA)": kernel_s}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device(ap)
    ap.add_argument("--r", type=int, default=32, help="repetitions of a chain")
    ap.add_argument("--n-lo", type=int, default=8)
    ap.add_argument("--n-hi", type=int, default=64)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    dev, card = setup(args)
    R, lo, hi = args.r, args.n_lo, args.n_hi
    res = {}
    for name, make in _chains(dev).items():
        row = {}
        t = {n: wall_ms(lambda s=make(n): [s() for _ in range(R)], dev, args.reps)
             for n in (lo, hi)}
        row["eager_us"] = 1e3 * (t[hi] - t[lo]) / (R * (hi - lo))
        if dev.type == "cuda":
            t = {}
            for n in (lo, hi):
                step = make(n)
                before = kernels.LAUNCHES["add_one"]
                replay = graphed(step, dev)
                counted = kernels.LAUNCHES["add_one"] - before
                t[n] = wall_ms(lambda r=replay: [r() for _ in range(R)], dev, args.reps)
                if hasattr(step, "state"):
                    v0 = step.state[0, 0].item()
                    replay()
                    sync(dev)
                    captured = step.state[0, 0].item() == v0 + n
                    if not captured:
                        raise AssertionError("kernel S: the ctypes launch was not captured")
                    row["captured"] = captured
                    row[f"launches_counted_n{n}"] = counted
            row["graph_us"] = 1e3 * (t[hi] - t[lo]) / (R * (hi - lo))
        res[name] = row
        extra = ""
        if "captured" in row:
            extra = (f"  (ctypes launch on the capturing stream captured: {row['captured']}; "
                     f"LAUNCHES counted {row[f'launches_counted_n{hi}']} host calls for the warm "
                     f"call and the capture of n={hi}, none per replay)")
        graph = f"{row['graph_us']:8.2f} us graph" if "graph_us" in row else ""
        print(f"{name:34s} {row['eager_us']:8.2f} us eager {graph}{extra}", flush=True)
    return dict(card=card, r=R, n_lo=lo, n_hi=hi, probes=res)


if __name__ == "__main__":
    main()
