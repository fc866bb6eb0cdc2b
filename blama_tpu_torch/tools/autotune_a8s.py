"""Sweep kernel Q's (block_n, kb) per 8B decode shape, against kernel A
(port of blama_tpu/tools/autotune_a8s.py).

    python -m blama_tpu_torch.tools.autotune_a8s [--device cpu] [--rows 1]
        [--shapes wqkv,wo,wgu,down,head] [--block-n 8,16,32,64,256,2048]
        [--kb 4,8] [--r-lo 2] [--r-hi 26] [--scale 1.0]

For each production shape (llama3-8b with the fused q/k/v and gate/up
layouts, and the lm head) L distinct random W4A8 weights (about 1.2 GB in all,
2 to 16 copies, so no pass finds a weight in L2) are multiplied by x [rows,
K] in turn; a configuration's time per call is (t(r_hi) - t(r_lo)) /
((r_hi - r_lo) L) of CUDA-event times of r repetitions of the L calls, each
count one CUDA graph (the reference's one jitted scan), so the fixed cost of
a pass cancels, as in the reference. Configurations: kernel
Q (w4a8_swar_matmul: the min term an f32 product after it) at each block_n
and kb, and kernel A (w4a8_matmul), which folds the min term into its group
terms (the reference's fold=1 variant). block_n is the reference's column
tile (its values, 1024-4096, are TPU tiles, listed beside small ones): here
it only passes the reference's clamp, and Q's CTA comes from
quant_matmul.slab_plan, so every block_n of a kb runs the same launch and
gives the same bits; the flag stays, as the reference's tool has it.
`--scale` shrinks every width for a dry run on the CPU.
"""

from __future__ import annotations

import argparse
import gc

import torch

from ..ops import quant_matmul as qm
from .common import add_device, reps_ms, setup

SHAPES = {"wqkv": (4096, 6144), "wo": (4096, 4096), "wgu": (4096, 28672),
          "down": (14336, 4096), "head": (4096, 129024)}


def fake_a8s(K: int, N: int, gen, dev) -> qm.QuantTensorA8S:
    """Random codes, bf16 scales and mins of one W4A8 weight (the kernels'
    time does not depend on the values)."""
    codes = torch.randint(0, 256, (N, K // 2), generator=gen, dtype=torch.uint8, device=dev)
    scales = (torch.randn((N, K // 32), generator=gen, device=dev) * 0.01).to(torch.bfloat16)
    mins = (torch.randn((N, K // 32), generator=gen, device=dev) * 0.01).to(torch.bfloat16)
    return qm.QuantTensorA8S(codes, scales, mins)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device(ap)
    ap.add_argument("--rows", type=int, default=1)
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--block-n", default="8,16,32,64,256,2048")
    ap.add_argument("--kb", default="4,8")
    ap.add_argument("--r-lo", type=int, default=2)
    ap.add_argument("--r-hi", type=int, default=26)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--scale", type=float, default=1.0)
    args = ap.parse_args(argv)
    dev, card = setup(args)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = dict(card=card, rows=args.rows, shapes={})
    for name in args.shapes.split(","):
        K, N = (max(256, int(v * args.scale) // 256 * 256) for v in SHAPES[name])
        bytes_w = K * N // 2 + 2 * (K // 32) * N * 2
        L = max(2, min(16, int(1.2e9 / bytes_w)))
        ws = [fake_a8s(K, N, gen, dev) for _ in range(L)]
        x = torch.randn((args.rows, K), generator=gen, device=dev)
        print(f"== {name} K={K} N={N} ({bytes_w / 1e6:.0f} MB/layer, {L} layers)", flush=True)
        configs = [(f"Q bn={bn} kb={kb}", lambda xx, w, bn=bn, kb=kb:
                    qm.w4a8_swar_matmul(xx, w, bn, kb))
                   for bn in map(int, args.block_n.split(",")) if bn <= N
                   for kb in map(int, args.kb.split(",")) if (K // 256) % kb == 0]
        configs.append(("A (min term folded)", qm.w4a8_matmul))
        rows = []
        for label, call in configs:
            def run(r, call=call):
                for _ in range(r):
                    for w in ws:
                        call(x, w)

            ms = reps_ms(run, dev, args.r_lo, args.r_hi, args.reps) / L
            rows.append(dict(config=label, ms=ms, gb_s=bytes_w / ms / 1e6))
            print(f"  {label:22s} {ms:8.4f} ms {bytes_w / ms / 1e6:8.1f} GB/s", flush=True)
        best = min(rows, key=lambda r: r["ms"])
        print(f"  BEST {name}: {best['config']} {best['ms']:.4f} ms {best['gb_s']:.1f} GB/s",
              flush=True)
        out["shapes"][name] = dict(K=K, N=N, layers=L, configs=rows, best=best["config"])
        del ws
        gc.collect()
    return out


if __name__ == "__main__":
    main()
