"""Layout and cast probes on the card, kernel Y (port of
tools/probe_casts.py).

    python -m blama_tpu_torch.tools.probe_casts [--device cpu]

The reference's twelve probes, each on its own f32 shapes: five reshapes, a
lane slice, a lane concat, a sublane stride, a per-row max of |x| over
32-lane groups, round(x * 3.7) through int8, the even-row selector E @ x as
an f32 dot, and a store into a shared-memory scratch at lane offset 128.
Each input is the first draws of a fresh default_rng(0).standard_normal,
as in the reference's try_op; the scratch probe's input is ones. Prints
"OK   <name>" when the kernel equals its plain version exactly, else a FAIL
line, and exits non-zero on any FAIL (mismatch, build or launch).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops import probes
from .common import add_device, exit_on_fail, run_probe, setup

# the reference's line for each probe of ops/probes.CASTS
LABELS = {"reshape_8x128": "reshape (1,1024)->(8,128)",
          "reshape_1x1024": "reshape (8,128)->(1,1024)",
          "reshape_32x1": "reshape (8,4)->(32,1)",
          "lane_slice": "lane slice", "lane_concat": "lane concat",
          "sublane_stride": "sublane stride 2", "group_max": "masked group max -> (8,4)",
          "reshape_4d": "reshape (1,1024)->(1,4,2,128)",
          "reshape_3d": "reshape (16,512)->(16,1,512)", "round_int8": "round->int8->f32",
          "row_select_dot": "const-E row select dot",
          "scratch_store": "scratch dyn lane store"}


def probe_input(name: str, shape) -> np.ndarray:
    """A probe's input: try_op's fresh default_rng(0) draws, ones for the
    scratch probe."""
    if name == "scratch_store":
        return np.ones(shape, np.float32)
    return np.random.default_rng(0).standard_normal(shape).astype(np.float32)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device(ap)
    args = ap.parse_args(argv)
    dev, card = setup(args)
    fails: list[str] = []
    for name, shape_in, _, _ in probes.CASTS:
        x = torch.from_numpy(probe_input(name, shape_in)).to(dev)

        def fn(name=name, x=x):
            return torch.equal(probes.cast(name, x), probes.cast_plain(name, x)), None

        run_probe(LABELS[name], fn, fails, lambda label, _: f"OK   {label}")
    exit_on_fail(fails)
    return dict(card=card, failed=fails)


if __name__ == "__main__":
    main()
