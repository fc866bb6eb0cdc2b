"""A/B of three W4A8 kernels on one decode shape: a8s (kernel Q), a8k4
(kernel I) and X2 (kernel T) (port of tools/ab_a8k4.py).

    python -m blama_tpu_torch.tools.ab_a8k4 [--device cpu] [K N B]
        [--layers 8] [--reps 40]

L distinct random Q4_K weights of [K, N] are packed both ways from the same
bytes: the split W4A8 layout (QuantTensorA8S: 4-bit codes with bf16 d·sc and
dmin·mn, 5 bits a weight) and the GGUF's own superblocks (QuantTensorA8K4,
4.5 bits a weight). X2 is kernel I's function (native superblocks, f32 scales
decoded in the kernel, the min term in each group term) summed in Q's slab
grouping. Prints the correctness line "x2 vs a8k4" (max |T − I| / max |I|:
the same function in another grouping), then per kernel the ms a call of a
pass over the L weights repeated `--reps` times (one CUDA graph, CUDA
events), and the effective GB/s of its layout's bytes.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import quant_matmul as qm
from ..testing import random_q4k
from .common import add_device, pass_ms, setup


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device(ap)
    ap.add_argument("dims", nargs="*", type=int, help="K N B (default 4096 14336 1)")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--reps", type=int, default=40)
    args = ap.parse_args(argv)
    dev, card = setup(args)
    K, N, B = (args.dims + [4096, 14336, 1][len(args.dims):])[:3]
    rng = np.random.default_rng(0)
    x0 = torch.from_numpy(rng.standard_normal((B, K)).astype(np.float32)).to(dev)
    ws_a8s, ws_a8k4 = [], []
    for _ in range(args.layers):
        data = random_q4k(rng, N, K, 0.05)
        ws_a8s.append(qm.repack_q4k_a8s(data, N, K, dev))
        ws_a8k4.append(qm.repack_q4k_a8k4(data, N, K, dev))
    bytes_a8s = K * N // 2 + 2 * (K // 32) * N * 2
    bytes_k4 = K * N // 256 * 144

    y_ref = qm.a8k4_matmul(x0, ws_a8k4[0])
    y_x2 = qm.x2_matmul(x0, ws_a8k4[0])
    rel = ((y_x2 - y_ref).abs().max() / y_ref.abs().max()).item()
    print(f"correctness x2 vs a8k4: {rel:.2e}", flush=True)
    res = dict(card=card, K=K, N=N, B=B, layers=args.layers, x2_vs_a8k4=rel)
    n = args.layers * args.reps
    for name, call, ws, nbytes in (("a8s", qm.w4a8_swar_matmul, ws_a8s, bytes_a8s),
                                   ("a8k4", qm.a8k4_matmul, ws_a8k4, bytes_k4),
                                   ("x2", qm.x2_matmul, ws_a8k4, bytes_k4)):
        def run(call=call, ws=ws):
            for _ in range(args.reps):
                for w in ws:
                    call(x0, w)

        ms = pass_ms(run, dev, 3) / n
        res[name] = dict(ms=ms, gb_s=nbytes / ms / 1e6)
        print(f"{name:5s} ({nbytes * 8 / (K * N):.2f} b/w) {ms:8.4f} ms {nbytes / ms / 1e6:8.1f} "
              "GB/s eff", flush=True)
    return res


if __name__ == "__main__":
    main()
