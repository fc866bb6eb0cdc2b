"""Kernel C's sequence block cap at the 8B INT8 decode geometry (port of
blama_tpu/tools/ubench_attn.py).

    BLAMA_ATTN_BLOCK_CAP=2048 python -m blama_tpu_torch.tools.ubench_attn
        [--device cpu] [S [L]] [--r-lo 8] [--r-hi 40] [--reps 3]

One row, H32 / Hkv8 / D128, an INT8 cache of S slots in L distinct layers
(codes, f32 scales), the reference's draws from default_rng(0). r calls of
kernel C (decode_attention), chained through their outputs over the L
layers (r / L passes, each folding a droplet of the last output into q),
are one CUDA graph; a call's time is (t(r_hi) - t(r_lo)) / (r_hi - r_lo),
the reference's differenced repetitions. BLAMA_ATTN_BLOCK_CAP, the most
slots a block of kernel C takes, is read when ops/decode_attention is
imported, so one cap per process. Prints "cap=.. S=..: us/call (GB/s of
the MB of INT8 codes a call reads)".
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import decode_attention as da
from .common import add_device, reps_ms, setup

H, HKV, D = 32, 8, 128   # Llama-3-8B


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device(ap)
    ap.add_argument("dims", nargs="*", type=int, help="S L (default 2048 4)")
    ap.add_argument("--r-lo", type=int, default=8)
    ap.add_argument("--r-hi", type=int, default=40)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    dev, card = setup(args)
    S, L = (args.dims + [2048, 4][len(args.dims):])[:2]
    if args.r_lo % L or args.r_hi % L or args.r_hi <= args.r_lo:
        raise ValueError(f"--r-lo / --r-hi must be multiples of L={L}, r_lo < r_hi")
    B = 1
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((B, 1, H, D))).to(torch.bfloat16).to(dev)
    k = torch.from_numpy(rng.integers(-127, 128, (L, B, S, HKV * D), dtype=np.int8))
    v = torch.from_numpy(rng.integers(-127, 128, (L, B, S, HKV * D), dtype=np.int8))
    k, v = (t.reshape(L, B, S, HKV, D).to(dev) for t in (k, v))
    ks = torch.from_numpy(rng.random((L, B, S, HKV)) * 0.01 + 0.01).float().to(dev)
    vs = torch.from_numpy(rng.random((L, B, S, HKV)) * 0.01 + 0.01).float().to(dev)
    kv_pos = torch.arange(S, dtype=torch.int32, device=dev)[None].repeat(B, 1)
    q_pos = torch.full((B,), S - 1, dtype=torch.int32, device=dev)
    inv, mscale = da.effective_inv_freq(D, D, 500000.0)
    inv = inv.to(dev)

    def run(r):
        acc = q
        for _ in range(r // L):
            out = acc
            for li in range(L):
                out = da.decode_attention(out, k[li], v[li], q_pos, kv_pos, inv, ks[li], vs[li],
                                          mscale=mscale)
            acc = acc + out * 1e-8
        return acc

    per_call = reps_ms(run, dev, args.r_lo, args.r_hi, args.reps)
    kv_mb = 2 * B * S * HKV * D / 1e6
    print(f"cap={da._BLOCK_CAP} S={S}: {per_call * 1e3:.1f} us/call "
          f"({kv_mb / per_call:.0f} GB/s of {kv_mb:.1f} MB/call)", flush=True)
    return dict(card=card, cap=da._BLOCK_CAP, S=S, layers=L, us_per_call=per_call * 1e3,
                gb_s=kv_mb / per_call)


if __name__ == "__main__":
    main()
