"""What the tools share: the device argument, the card's name and power
limit, and the timers (CUDA events on the card, the host clock on the CPU,
where no number is a device metric)."""

from __future__ import annotations

import argparse
import os
import subprocess
import tempfile
import time

import torch

from ..ops.kernels import resolve_device


def add_device(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu: the "
                         "plain versions at the sizes given, host-clock times")


def setup(args) -> tuple[torch.device, str]:
    """The tool's device (resolve_device: no quiet fall-back to the CPU) and
    the line that names it: nvidia-smi's name and power limit on the card."""
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True, timeout=60).stdout.strip().splitlines()[0]
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        card = "cpu (host clock: no device metric)"
    print(f"# device: {card}", flush=True)
    return dev, card


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def elapsed_ms(fn, dev: torch.device) -> float:
    """Milliseconds of one call of fn: CUDA events around it on the card
    (device time of the work it enqueues), the host clock on the CPU."""
    if dev.type == "cuda":
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e)
    t0 = time.perf_counter()
    fn()
    return 1e3 * (time.perf_counter() - t0)


def best_ms(fn, dev: torch.device, reps: int = 3, warm: int = 1) -> float:
    """The least of `reps` timed calls after `warm` untimed ones."""
    for _ in range(warm):
        fn()
    sync(dev)
    return min(elapsed_ms(fn, dev) for _ in range(reps))


def wall_ms(fn, dev: torch.device, reps: int = 3, warm: int = 1) -> float:
    """The least host-clock milliseconds of fn followed by a synchronize
    (what a caller waits: launch overhead included)."""
    for _ in range(warm):
        fn()
    sync(dev)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync(dev)
        best = min(best, 1e3 * (time.perf_counter() - t0))
    return best


def graphed(fn, dev: torch.device):
    """fn as one device program: on the card captured once in a
    torch.cuda.CUDAGraph (after a warm call on a side stream) and returned as
    its replay, so a timed pass runs its launches back to back with no
    Python dispatch between them, as the reference timed one jitted program;
    on the CPU fn itself."""
    if dev.type != "cuda":
        return fn
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(dev).wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return g.replay


def pass_ms(fn, dev: torch.device, reps: int = 3) -> float:
    """The least time of one replay of fn's pass (graphed)."""
    return best_ms(graphed(fn, dev), dev, reps)


def reps_ms(run, dev: torch.device, r_lo: int, r_hi: int, reps: int = 3) -> float:
    """Per-repetition time by differencing two repetition counts,
    (t(r_hi) - t(r_lo)) / (r_hi - r_lo), as the reference's tools do: the
    fixed cost of a pass cancels. run(r) performs r repetitions; each count
    is one graphed pass."""
    t_lo = pass_ms(lambda: run(r_lo), dev, reps)
    t_hi = pass_ms(lambda: run(r_hi), dev, reps)
    return (t_hi - t_lo) / (r_hi - r_lo)


def model_path(preset: str, layers: int | None = None) -> str:
    """The file a tool runs on: `tiny` (the tests' fixture) or a synthesized
    preset (random weights, the preset's widths, `layers` cuts the depth),
    cached in the temp directory."""
    from ..testing import MOE_PRESETS, cached_llama_gguf, cached_moe_gguf, write_tiny_llama

    if preset == "tiny":
        path = os.path.join(tempfile.gettempdir(), "blama_tpu_torch-tools-tiny.gguf")
        if not os.path.exists(path):
            write_tiny_llama(path)
        return path
    if preset in MOE_PRESETS:
        return cached_moe_gguf(preset, n_layer=layers)
    return cached_llama_gguf(preset, n_layer=layers)
