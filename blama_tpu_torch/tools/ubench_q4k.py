"""Q4_K dequant-matmul variants on the card: kernels B, U, V and Q beside
the plain W4A8 engine and a bf16 product (port of
blama_tpu/tools/ubench_q4k.py).

    python -m blama_tpu_torch.tools.ubench_q4k [--device cpu] [K N [B]]
        [--layers 16] [--reps 3]

L = `--layers` distinct synthetic Q4_K-style weights [K, N] (make_weights:
random codes, scales and mins, the reference's draws from default_rng(0))
in each variant's layout, x [B, K] f32 from the same generator. A variant's
pass over the L weights (every weight read once, no L2 reuse) is one CUDA
graph timed by CUDA events, the reference's one jitted scan; it prints ms a
step (pass / L) and the effective GB/s of the reference's byte count for
its layout, then each variant's max relative error against v0 on layer 0:

  v0  kernel B: q4k_matmul on a QuantTensor (exact engine, f32 scales)
  v1  kernel U: q4k_matmul_v1, f32 two-dot, kb 8
  v2  kernel V: w4a8_plane_matmul on int8 codes, kb 4
  v3  kernel V: w4a8_packed_matmul on tile-paired codes, kb 8
  v6  kernel Q: w4a8_swar_matmul, kb 8 (the reference's v6 is Q's body;
      Q, as the reference's v6, halves kb until its slab divides K, and so
      does this tool for v1-v3, where the reference would drop the tail)
  v4  w4a8_xla_matmul, plain PyTorch (the reference's pure-XLA W4A8)
  v5  torch.matmul of bf16 x by the dequantized bf16 weights (jnp.dot)

block_n is each kernel's default, the columns a CTA owns on the card (the
reference's 2048 / 4096 are TPU VMEM tiles); it moves no bit.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import quant_matmul as qm
from .common import add_device, pass_ms, setup

KT = qm.QK_K


def make_weights(K: int, N: int, L: int, rng):
    """L layers of synthetic Q4_K-style data, the reference's draws: codes
    uint8 [L, K, N], f32 scales and mins [L, K/32, N]."""
    codes = rng.integers(0, 16, (L, K, N), dtype=np.uint8)
    scales = rng.random((L, K // 32, N), dtype=np.float32) * 0.02 + 0.01
    mins = rng.random((L, K // 32, N), dtype=np.float32) * 0.01
    return codes, scales, mins


def pack_pairs(codes: torch.Tensor) -> torch.Tensor:
    """Element-order codes uint8 [N, K] → tile-paired [N, K/2]: byte j of
    tile t = code 256t+j | code 256t+128+j << 4 (the reference's pack_pairs
    on the transposed array)."""
    N, K = codes.shape
    c = codes.reshape(N, K // KT, 2, KT // 2)
    return (c[:, :, 0] | (c[:, :, 1] << 4)).reshape(N, K // 2).contiguous()


def layer_weights(codes, scales, mins, dev) -> dict:
    """One layer's arrays ([K, N] numpy, the reference's orientation) in
    every variant's layout on `dev`."""
    ce = torch.from_numpy(codes).to(dev).t().contiguous()          # u8 [N, K]
    sc = torch.from_numpy(scales).to(dev).t().contiguous()         # f32 [N, K/32]
    mn = torch.from_numpy(mins).to(dev).t().contiguous()
    paired, i8 = pack_pairs(ce), ce.to(torch.int8)
    sb, mb = sc.to(torch.bfloat16), mn.to(torch.bfloat16)
    dense = (ce.float().reshape(*sc.shape, 32) * sc[..., None]
             - mn[..., None]).reshape(ce.shape)
    return dict(v0=qm.pack_exact(ce, sc, mn), v1=(paired, sc, mn), v2=(i8, sb, mb),
                v3=(paired, sb, mb), v6=qm.pack_a8s(ce, sc, mn),
                v4=qm.QuantTensorA8(i8, sb, mb), v5=dense.t().to(torch.bfloat16).contiguous())


def kb_for(K: int, kb: int) -> int:
    """A variant's kb, halved until its K-block divides K (the reference's
    v1-v3 would leave the tail out)."""
    while K % (kb * KT):
        kb //= 2
    return kb


# (name, label, call, byte count of the reference's weight_bytes)
VARIANTS = (
    ("v0", "v0 kernel B (exact, f32 scales)", lambda x, w: qm.q4k_matmul(x, w), "q4k_packed"),
    ("v1", "v1 kernel U two-dot f32",
     lambda x, w: qm.q4k_matmul_v1(x, *w, kb=kb_for(x.shape[1], 8)), "q4k_packed"),
    ("v2", "v2 kernel V i8-stored (9 b/w)",
     lambda x, w: qm.w4a8_plane_matmul(x, *w, kb=kb_for(x.shape[1], 4)), "w4a8_i8"),
    ("v3", "v3 kernel V packed4 unpack",
     lambda x, w: qm.w4a8_packed_matmul(x, *w, kb=kb_for(x.shape[1], 8)), "q4k_packed"),
    ("v6", "v6 kernel Q SWAR packed4", lambda x, w: qm.w4a8_swar_matmul(x, w, kb=8),
     "q4k_packed"),
    ("v4", "v4 plain W4A8 (9 b/w)", lambda x, w: qm.w4a8_xla_matmul(x, w), "w4a8_i8"),
    ("v5", "v5 bf16 dense (torch.matmul)",
     lambda x, w: torch.matmul(x.to(torch.bfloat16), w), "bf16"),
)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device(ap)
    ap.add_argument("dims", nargs="*", type=int, help="K N B (default 4096 14336 1)")
    ap.add_argument("--layers", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    dev, card = setup(args)
    K, N, B = (args.dims + [4096, 14336, 1][len(args.dims):])[:3]
    L = args.layers
    rng = np.random.default_rng(0)
    codes, scales, mins = make_weights(K, N, L, rng)
    x0 = torch.from_numpy(rng.standard_normal((B, K), dtype=np.float32)).to(dev)
    ws = [layer_weights(codes[i], scales[i], mins[i], dev) for i in range(L)]
    del codes, scales, mins
    weight_bytes = {"q4k_packed": K * N // 2 + 2 * (K // 32) * N * 4,
                    "w4a8_i8": K * N + 2 * (K // 32) * N * 2, "bf16": K * N * 2}
    res = dict(card=card, K=K, N=N, B=B, layers=L, variants={}, rel_err={})
    ref = None
    for name, label, call, kind in VARIANTS:
        out = call(x0, ws[0][name])
        if ref is None:
            ref = out
        else:
            rel = ((out - ref).abs().max() / (ref.abs().max() + 1e-9)).item()
            res["rel_err"][name] = rel

        def one_pass(call=call, name=name):
            for w in ws:
                call(x0, w[name])

        ms = pass_ms(one_pass, dev, args.reps) / L
        gbs = weight_bytes[kind] / ms / 1e6
        res["variants"][name] = dict(ms=ms, gb_s=gbs)
        print(f"{label:34s} {ms:8.4f} ms/step {gbs:8.1f} GB/s eff", flush=True)
    for name, rel in res["rel_err"].items():
        print(f"correctness {name}: max rel err vs v0 = {rel:.2e}", flush=True)
    return res


if __name__ == "__main__":
    main()
