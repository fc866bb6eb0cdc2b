"""Paged against dense fused decode attention at the serving geometry,
kernels E and C (port of blama_tpu/tools/ubench_paged.py).

    python -m blama_tpu_torch.tools.ubench_paged [--device cpu] [B [S [G]]]
        [--r-lo 4] [--r-hi 28] [--reps 3]

B rows of S bf16 cache slots, H32 / Hkv8 / D128, the reference's draws from
default_rng(0); the paged pool holds the same rows in pages of G slots under
the identity page table (each page is one read either way). r calls, each
folding a droplet of its output into the next query, are one CUDA graph; a
call's time is (t(r_hi) - t(r_lo)) / (r_hi - r_lo), the reference's
differenced repetitions. Prints ms and GB/s (the K and V bytes a call reads)
of the dense kernel C and the paged kernel E, and their ratio.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import decode_attention as da
from ..ops import paged_attention as pa
from .common import add_device, reps_ms, setup

H, HKV, D = 32, 8, 128   # Llama-3-8B


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device(ap)
    ap.add_argument("dims", nargs="*", type=int, help="B S page (default 4 2048 128)")
    ap.add_argument("--r-lo", type=int, default=4)
    ap.add_argument("--r-hi", type=int, default=28)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    dev, card = setup(args)
    B, S, G = (args.dims + [4, 2048, 128][len(args.dims):])[:3]
    MP = S // G
    P = B * MP
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((B, 1, H, D))).to(torch.bfloat16).to(dev)
    kd = torch.from_numpy(rng.standard_normal((B, S, HKV, D))).to(torch.bfloat16).to(dev)
    vd = torch.from_numpy(rng.standard_normal((B, S, HKV, D))).to(torch.bfloat16).to(dev)
    kv_pos = torch.arange(S, dtype=torch.int32, device=dev)[None].repeat(B, 1)
    q_pos = torch.full((B,), S - 1, dtype=torch.int32, device=dev)
    inv = da.effective_inv_freq(D, D, 500000.0)[0].to(dev)
    kp, vp = kd.reshape(P, G, HKV, D), vd.reshape(P, G, HKV, D)
    pool_pos = kv_pos.reshape(P, G)
    table = torch.arange(P, dtype=torch.int32, device=dev).reshape(B, MP)

    def chain(call):
        def run(r):
            acc = q
            for _ in range(r):
                acc = acc + call(acc) * 1e-8
            return acc
        return run

    dense = chain(lambda qq: da.decode_attention(qq, kd, vd, q_pos, kv_pos, inv))
    paged = chain(lambda qq: pa.paged_decode_attention(qq, kp, vp, pool_pos, table, q_pos, inv))
    td = reps_ms(dense, dev, args.r_lo, args.r_hi, args.reps)
    tp = reps_ms(paged, dev, args.r_lo, args.r_hi, args.reps)
    kv_mb = 2 * B * S * HKV * D * 2 / 1e6
    print(f"B={B} S={S} page={G} (KV {kv_mb:.0f} MB/dispatch)", flush=True)
    print(f"dense fused (kernel C): {td:7.3f} ms/dispatch  {kv_mb / td:6.1f} GB/s", flush=True)
    print(f"paged (kernel E):       {tp:7.3f} ms/dispatch  {kv_mb / tp:6.1f} GB/s", flush=True)
    print(f"ratio paged/dense: {tp / td:.3f}", flush=True)
    return dict(card=card, B=B, S=S, page=G, dense_ms=td, paged_ms=tp, ratio=tp / td)


if __name__ == "__main__":
    main()
