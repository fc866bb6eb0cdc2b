"""The card's achievable streaming ceiling, and the decode kernels against it
(port of blama_tpu/tools/probe_ceiling.py).

    python -m blama_tpu_torch.tools.probe_ceiling [--device cpu] [--gb 6.0]
        [--mm-layers 48] [--q-layers 64] [--shape-layers 16] [--reps 3]
        [--width 4096] [--ffn 14336] [--vocab 128256] [--ctx 2048]
        [--skip read,matmul,q,shapes,attn]

Every measurement is one pass over an operand set that no earlier pass left
in the 50 MB L2: one call that reads a multi-GB array once, or a chain of
distinct per-layer weights, each read once, captured as one CUDA graph (the
reference's one jitted program). Times are CUDA events on the card, so no
dispatch overhead needs subtracting (the reference measured its own
tunnel's and took it off).

  dispatch   host ms of a tiny op and a synchronize
  read       torch.sum over `--gb` of bf16, then of uint8, in one call each
  matmul     bf16 x[1, W] @ W_l[W, F] over `--mm-layers` distinct layers
  q          kernel Q (w4a8_swar_matmul, min term included) over `--q-layers`
             distinct FFN-shaped Q4_K layers, x [1, W]
  shapes     kernel Q per 8B projection (wq/wo, wkv, ffn, down, head) over
             distinct copies, by differencing two repetition counts
  attn       kernel C (decode_attention) at S = `--ctx`, H32 / Hkv8 / D128,
             one row, over 8 distinct bf16 and INT8 caches

Each line gives ms and GB/s of the bytes the pass must read.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..ops import decode_attention as da
from ..ops import quant_matmul as qm
from ..ops.kv_cache import quantize_kv
from ..testing import random_q4k
from .common import add_device, best_ms, pass_ms, reps_ms, setup, sync


def _line(name, nbytes, ms):
    print(f"{name:40s} {nbytes / 1e9:6.2f} GB {ms:9.3f} ms/pass {nbytes / ms / 1e6:8.1f} GB/s",
          flush=True)
    return dict(gb=nbytes / 1e9, ms=ms, gb_s=nbytes / ms / 1e6)


def _a8s_copies(K, N, L, dev, seed):
    """L distinct W4A8 weights of one shape: one packed Q4_K weight (at most
    4096 columns synthesized, tiled up to N) whose codes are shifted by l."""
    n0 = min(N, 4096)
    w0 = qm.repack_q4k_a8s(random_q4k(np.random.default_rng(seed), n0, K, K ** -0.5), n0, K, dev)
    reps = -(-N // n0)

    def tile(a):
        return a.repeat(reps, 1)[:N].contiguous()

    codes, scales, mins = tile(w0.codes), tile(w0.scales), tile(w0.mins)
    return [qm.QuantTensorA8S(codes + l, scales, mins) for l in range(L)]


def _layer_bytes(w):
    return sum(t.numel() * t.element_size() for t in (w.codes, w.scales, w.mins))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device(ap)
    ap.add_argument("--gb", type=float, default=6.0)
    ap.add_argument("--mm-layers", type=int, default=48)
    ap.add_argument("--q-layers", type=int, default=64)
    ap.add_argument("--shape-layers", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--width", type=int, default=4096)
    ap.add_argument("--ffn", type=int, default=14336)
    ap.add_argument("--vocab", type=int, default=128256)
    ap.add_argument("--ctx", type=int, default=2048)
    ap.add_argument("--skip", default="", help="comma-separated probes to leave out")
    args = ap.parse_args(argv)
    dev, card = setup(args)
    skip = set(filter(None, args.skip.split(",")))
    W, F = args.width, args.ffn
    res = dict(card=card)

    x = torch.ones((8, 128), device=dev)
    disp = []
    for _ in range(10):
        t0 = time.perf_counter()
        torch.sum(x)
        sync(dev)
        disp.append(1e3 * (time.perf_counter() - t0))
    res["dispatch_ms"] = min(disp)
    print(f"dispatch: {res['dispatch_ms']:.4f} ms (host, one op and a synchronize)", flush=True)

    if "read" not in skip:
        for dt in (torch.bfloat16, torch.uint8):
            n = int(args.gb * 1e9) // torch.empty((), dtype=dt).element_size() // 4096 * 4096
            a = torch.ones(n, dtype=dt, device=dev)
            acc = torch.int32 if dt == torch.uint8 else torch.float32
            ms = best_ms(lambda a=a, acc=acc: torch.sum(a, dtype=acc), dev, args.reps)
            res[f"read_{str(dt).split('.')[-1]}"] = _line(
                f"read {str(dt).split('.')[-1]} (torch.sum)", a.numel() * a.element_size(), ms)
            del a

    if "matmul" not in skip:
        w = torch.ones((args.mm_layers, W, F), dtype=torch.bfloat16, device=dev)
        x0 = torch.ones((1, W), dtype=torch.bfloat16, device=dev)

        def chain():
            for wl in w:
                torch.matmul(x0, wl)

        res["matmul_bf16"] = _line(f"matmul bf16 x[1,{W}] @ [{W},{F}] x{args.mm_layers}",
                                   w.numel() * 2, pass_ms(chain, dev, args.reps))
        del w

    x1 = torch.ones((1, W), dtype=torch.float32, device=dev)
    if "q" not in skip:
        ws = _a8s_copies(W, F, args.q_layers, dev, 0)

        def chain():
            for wl in ws:
                qm.w4a8_swar_matmul(x1, wl)

        res["kernel_q"] = _line(f"kernel Q ({W}x{F}) x{args.q_layers}",
                                _layer_bytes(ws[0]) * len(ws), pass_ms(chain, dev, args.reps))
        del ws

    if "shapes" not in skip:
        Ls = args.shape_layers
        shapes = {"wq/wo": (W, W, Ls), "wkv": (W, W // 4, Ls), "ffn": (W, F, Ls),
                  "down": (F, W, Ls), "head": (W, args.vocab, max(2, Ls // 4))}
        res["shapes"] = {}
        for name, (K, N, L) in shapes.items():
            ws = _a8s_copies(K, N, L, dev, 1)
            xk = torch.ones((1, K), dtype=torch.float32, device=dev)

            def run(r, ws=ws, xk=xk):
                for _ in range(r):
                    for wl in ws:
                        qm.w4a8_swar_matmul(xk, wl)

            ms = reps_ms(run, dev, 1, 3, args.reps) / L
            res["shapes"][name] = _line(f"kernel Q {name} {K}x{N} (per call)",
                                        _layer_bytes(ws[0]), ms)
            del ws

    if "attn" not in skip:
        H, Hkv, D, S = 32, 8, 128, args.ctx
        gen = torch.Generator(device=dev).manual_seed(0)
        inv, mscale = da.effective_inv_freq(D, D, 500000.0)
        inv = inv.to(dev)
        q = torch.randn((1, 1, H, D), generator=gen, device=dev).to(torch.bfloat16)
        kv_pos = torch.arange(S, dtype=torch.int32, device=dev)[None]
        q_pos = torch.full((1,), S - 1, dtype=torch.int32, device=dev)
        for tag in ("bf16", "int8"):
            caches = []
            for _ in range(8):
                k = torch.randn((1, S, Hkv, D), generator=gen, device=dev)
                v = torch.randn((1, S, Hkv, D), generator=gen, device=dev)
                if tag == "int8":
                    (kc, ksc), (vc, vsc) = quantize_kv(k), quantize_kv(v)
                    caches.append((kc, vc, ksc, vsc))
                else:
                    caches.append((k.to(torch.bfloat16), v.to(torch.bfloat16), None, None))

            def chain(caches=caches):
                for k, v, ks, vs in caches:
                    da.decode_attention(q, k, v, q_pos, kv_pos, inv, ks, vs, mscale=mscale)

            nbytes = sum(sum(t.numel() * t.element_size() for t in c if t is not None)
                         for c in caches)
            ms = pass_ms(chain, dev, args.reps) / len(caches)
            res[f"attn_{tag}"] = _line(f"kernel C S={S} {tag} (per layer)",
                                       nbytes // len(caches), ms)
            del caches
    return res


if __name__ == "__main__":
    main()
