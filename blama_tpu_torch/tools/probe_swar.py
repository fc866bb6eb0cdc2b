"""SWAR nibble unpack on the card, kernel W (port of
blama_tpu/tools/probe_swar.py).

    python -m blama_tpu_torch.tools.probe_swar [--device cpu] [--rows 256]
        [--cols 512]

x is uint8 [rows, cols] and a int8 [32, rows], the reference's draws from
default_rng(0). Kernel W reads x as 32-bit words: k_roundtrip writes them
back as bytes (the identity), k_swar_lo_hi masks each word with 0x0F0F0F0F
into the low and the high nibbles, k_swar_dot takes a @ lo + a @ hi in int32
with the products in the kernel. Prints the reference's four lines
("roundtrip identity: True", ...), True meaning the kernel equals its plain
version exactly; any mismatch, build or launch failure prints a FAIL line
and the tool exits non-zero. `--rows 2048 --cols 14336` is one code plane of
an 8B FFN weight.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import probes
from .common import add_device, exit_on_fail, run_probe, setup


def _bool_line(label, shown):
    return f"{label}: {shown}"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device(ap)
    ap.add_argument("--rows", type=int, default=256)
    ap.add_argument("--cols", type=int, default=512)
    args = ap.parse_args(argv)
    dev, card = setup(args)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 255, (args.rows, args.cols), dtype=np.uint8)).to(dev)
    a = torch.from_numpy(rng.integers(-127, 127, (32, args.rows), dtype=np.int8)).to(dev)
    fails: list[str] = []
    lohi = {}

    def roundtrip():
        out = probes.swar_roundtrip(x)
        ok = torch.equal(out, x) and torch.equal(out, probes.swar_roundtrip_plain(x))
        return ok, ok

    def nibble(i):
        if not lohi:
            lohi.update(out=probes.swar_lo_hi(x), plain=probes.swar_lo_hi_plain(x))
        ok = torch.equal(lohi["out"][i], lohi["plain"][i])
        return ok, ok

    def dot():
        ok = torch.equal(probes.swar_dot(a, x), probes.swar_dot_plain(a, x))
        return ok, ok

    for label, fn in (("roundtrip identity", roundtrip), ("lo matches x&0xF", lambda: nibble(0)),
                      ("hi matches x>>4", lambda: nibble(1)), ("swar dot correct", dot)):
        run_probe(label, fn, fails, _bool_line)
    exit_on_fail(fails)
    return dict(card=card, rows=args.rows, cols=args.cols, failed=fails)


if __name__ == "__main__":
    main()
