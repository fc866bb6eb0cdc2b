"""Streaming bandwidth through kernel R's blocks (port of
blama_tpu/tools/probe_bw.py).

    python -m blama_tpu_torch.tools.probe_bw [--device cpu] [--layers 16]
        [--rows 2048] [--cols 14336] [--reps 3] [--blocks ref|card|all]

Kernel R (ops/probes.stream) brings every byte of each [bk, bn] block of a
uint8 [rows, cols] layer into shared memory and sums 8 rows of it, so its
time is the time to stream the layer through blocks of that shape. The
layers are `--layers` distinct arrays (the reference's 16 of 2048 x 14336:
470 MB, nine times the card's 50 MB L2), and one pass reads each once, so no
layer is read from L2. A pass is one CUDA graph (its launches back to back,
as the reference's one jitted scan), timed by CUDA events. Prints one line
per block: ms per layer and GB/s of the bytes its grid covers, after
checking the first layer against the plain version (exact) and that the
CTAs staged every byte; then the library line,
torch.sum(dtype=int32) over all layers in one call (the reference's
xla_baseline). The reference's eight blocks give a card 2 to 14 CTAs, which
is few for 132 SMs, so `--blocks card` (and `all`) add blocks of the card's
own size.
"""

from __future__ import annotations

import argparse

import torch

from ..ops import probes
from .common import add_device, best_ms, pass_ms, setup

REF_BLOCKS = [(1024, 4096), (1024, 2048), (512, 7168), (2048, 2048),
              (2048, 7168), (512, 14336), (256, 14336), (1024, 14336)]
CARD_BLOCKS = [(32, 1024), (64, 2048), (128, 512), (256, 256)]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device(ap)
    ap.add_argument("--layers", type=int, default=16)
    ap.add_argument("--rows", type=int, default=2048)
    ap.add_argument("--cols", type=int, default=14336)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--blocks", choices=["ref", "card", "all"], default="all")
    args = ap.parse_args(argv)
    dev, card = setup(args)
    L, R, N = args.layers, args.rows, args.cols
    gen = torch.Generator(device=dev).manual_seed(0)
    codes = torch.randint(0, 256, (L, R, N), generator=gen, dtype=torch.uint8, device=dev)
    blocks = {"ref": REF_BLOCKS, "card": CARD_BLOCKS, "all": REF_BLOCKS + CARD_BLOCKS}[args.blocks]
    rows = []
    for bk, bn in blocks:
        if bk > R or bn > N:
            continue
        ref = probes.stream_plain(codes[0], bk, bn)
        if dev.type == "cuda":
            out, tot = probes.stream_launch(codes[0], bk, bn, total=True)
            covered = codes[0][:R // bk * bk, :N // bn * bn]
            staged = torch.zeros((1, N), dtype=torch.float32, device=dev)
            staged[0, :covered.shape[1]] = covered.to(torch.int32).sum(0).float()
            if not (torch.equal(out, ref) and torch.equal(tot, staged)):
                raise AssertionError(f"kernel R block ({bk}, {bn}): sums differ from the plain "
                                     "version or a byte was not staged")
        elif not torch.equal(probes.stream(codes[0], bk, bn), ref):
            raise AssertionError(f"block ({bk}, {bn}): plain version disagrees")

        def one_pass(bk=bk, bn=bn):
            for i in range(L):
                probes.stream(codes[i], bk, bn)

        ms = pass_ms(one_pass, dev, args.reps) / L
        nbytes = (R // bk * bk) * (N // bn * bn)
        rows.append(dict(bk=bk, bn=bn, ctas=(R // bk) * (N // bn), ms_per_layer=ms,
                         gb_s=nbytes / ms / 1e6))
        print(f"block ({bk:5d},{bn:6d}) {rows[-1]['ctas']:5d} CTAs: {ms:8.4f} ms/layer "
              f"{rows[-1]['gb_s']:8.1f} GB/s", flush=True)
    ms = best_ms(lambda: torch.sum(codes, dtype=torch.int32), dev, args.reps)
    lib = dict(ms=ms, gb_s=codes.numel() / ms / 1e6)
    print(f"torch.sum(dtype=int32) over {codes.numel() / 1e6:.0f} MB: {ms:.3f} ms "
          f"{lib['gb_s']:.1f} GB/s", flush=True)
    return dict(card=card, layers=L, rows=R, cols=N, blocks=rows, library=lib)


if __name__ == "__main__":
    main()
