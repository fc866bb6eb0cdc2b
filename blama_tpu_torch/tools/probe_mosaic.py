"""Byte ops and int8 dots on the card, kernel X (port of
blama_tpu/tools/probe_mosaic.py).

    python -m blama_tpu_torch.tools.probe_mosaic [--device cpu] [--rows 256]
        [--cols 512]

The reference's draws from default_rng(0): xu8 uint8 [rows, cols], a8 int8
[32, rows], b8 int8 [rows, cols] in [-8, 8), c8 uint8 [rows/2, cols]. Four
probes: (x & 0xF) + (x >> 4) in uint8 and through int16, a8 @ b8 in int32,
and a8 @ concat([c8 & 0xF, c8 >> 4]) (a8's first rows/2 columns meet the
low nibbles). Prints "OK   <name>: <first values>" when the kernel equals
its plain version exactly, else a FAIL line, and exits non-zero on any FAIL
(mismatch, build or launch). `--rows 2048 --cols 14336` is one code plane of
an 8B FFN weight.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import probes
from .common import add_device, exit_on_fail, run_probe, setup


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device(ap)
    ap.add_argument("--rows", type=int, default=256)
    ap.add_argument("--cols", type=int, default=512)
    args = ap.parse_args(argv)
    dev, card = setup(args)
    R, N = args.rows, args.cols
    rng = np.random.default_rng(0)
    xu8 = torch.from_numpy(rng.integers(0, 255, (R, N), dtype=np.uint8)).to(dev)
    a8 = torch.from_numpy(rng.integers(-127, 127, (32, R), dtype=np.int8)).to(dev)
    b8 = torch.from_numpy(rng.integers(-8, 8, (R, N), dtype=np.int8)).to(dev)
    c8 = torch.from_numpy(rng.integers(0, 255, (R // 2, N), dtype=np.uint8)).to(dev)
    fails: list[str] = []
    for label, kernel, plain, args_ in (
            ("u8 bitops native", probes.u8_bitops, probes.u8_bitops_plain, (xu8,)),
            ("i16 bitops", probes.i16_bitops, probes.i16_bitops_plain, (xu8,)),
            ("i8xi8->i32 dot", probes.i8_dot, probes.i8_dot_plain, (a8, b8)),
            ("unpack->i8 dot", probes.unpack_dot, probes.unpack_dot_plain, (a8, c8))):
        def fn(kernel=kernel, plain=plain, args_=args_):
            out = kernel(*args_)
            return torch.equal(out, plain(*args_)), out.ravel()[:4].tolist()

        run_probe(label, fn, fails)
    exit_on_fail(fails)
    return dict(card=card, rows=R, cols=N, failed=fails)


if __name__ == "__main__":
    main()
