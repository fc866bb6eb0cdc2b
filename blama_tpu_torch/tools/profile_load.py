"""Where a GGUF load's time goes: parse, page-in, upload, on-card repack,
commit (port of blama_tpu/tools/profile_load.py).

    python -m blama_tpu_torch.tools.profile_load [gguf_path | preset]
        [--device cpu] [--dtype q4k_a8] [--layers N]

Walks the port's load path one phase at a time over every Q4_K tensor of the
file (every tensor for a dense engine, `--dtype float32` or `bfloat16`; a
path, or a preset synthesized as bench_serving does; default llama3-8b):

  parse    GGUFReader: the header and the tensor table
  page-in  touch every 4 KiB page of each tensor's mapped bytes (the host's
           page cache as it finds it: nothing is dropped)
  upload   the raw bytes to the device, enqueued (torch .to(device))
  repack   the engine's repack of the uploaded bytes on the device
           (decode_q4k_blocks, then the engine's packed layout; for a dense
           engine ops/dequant's values in its dtype), enqueued
  commit   a synchronize: until every array is resident

for a dense engine then the path its loader does not take (numpy: every
tensor dequantized on the host by gguf/quants.py, converted and uploaded),
and the port's whole load (runtime.model.Model) of the same file for
comparison. Prints one line a phase and the total.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .common import add_device, model_path, setup, sync


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device(ap)
    ap.add_argument("path", nargs="?", default="llama3-8b",
                    help="a GGUF file, or a preset to synthesize")
    ap.add_argument("--dtype", default="q4k_a8", help="weight engine (runtime.model.ENGINES)")
    ap.add_argument("--layers", type=int, default=None)
    args = ap.parse_args(argv)
    dev, card = setup(args)
    from ..gguf.constants import GGMLType
    from ..gguf.reader import GGUFReader
    from ..ops import dequant
    from ..runtime.model import DENSE_ENGINES, ENGINES, Model, ModelParams

    path = args.path if os.path.exists(args.path) else model_path(args.path, args.layers)
    res = dict(card=card, file=os.path.basename(path), dtype=args.dtype)

    def phase(name, seconds, note=""):
        res[name + "_s"] = seconds
        print(f"{name:8s} {seconds:8.3f} s {note}", flush=True)

    t0 = time.perf_counter()
    r = GGUFReader(path)
    phase("parse", time.perf_counter() - t0, f"({len(r.tensors)} tensors)")
    dense = DENSE_ENGINES.get(args.dtype)
    names = [n for n in r.tensor_names()
             if dense is not None or r.tensors[n].ggml_type == GGMLType.Q4_K]
    total = sum(r.tensors[n].nbytes for n in names)
    t0 = time.perf_counter()
    acc = 0
    for n in names:
        acc += int(r.tensor_bytes(n)[::4096].sum())
    dt = time.perf_counter() - t0
    phase("page-in", dt, f"({total / 1e9:.2f} GB{'' if dense else ' of Q4_K'}, "
                         f"{total / dt / 1e9:.2f} GB/s)")
    sync(dev)
    t0 = time.perf_counter()
    raw = [torch.from_numpy(np.array(r.tensor_bytes(n), copy=True)).to(dev) for n in names]
    phase("upload", time.perf_counter() - t0, "(enqueued)")
    t0 = time.perf_counter()
    if dense is None:
        packed = [_repack(ENGINES[args.dtype], b, r.tensors[n].ne[1])
                  for b, n in zip(raw, names)]
    else:
        packed = [dequant.dequantize(b, r.tensors[n].ggml_type, r.tensors[n].shape, dev, dense)
                  for b, n in zip(raw, names)]
    phase("repack", time.perf_counter() - t0, f"(on the {dev.type}, enqueued)")
    t0 = time.perf_counter()
    sync(dev)
    phase("commit", time.perf_counter() - t0)
    out_bytes = sum(t.numel() * t.element_size() for w in packed
                    for t in ([w] if torch.is_tensor(w) else vars(w).values())
                    if torch.is_tensor(t))
    total_s = sum(res[k + "_s"] for k in ("parse", "page-in", "upload", "repack", "commit"))
    phase("total", total_s, f"({out_bytes / 1e9:.2f} GB packed)")
    del raw, packed
    if dense is not None:
        t0 = time.perf_counter()
        for n in names:
            torch.from_numpy(r.tensor_float(n)).to(dev).to(dense)
        sync(dev)
        phase("numpy", time.perf_counter() - t0,
              "(every tensor dequantized on the host instead, converted, uploaded)")
    r.close()
    t0 = time.perf_counter()
    m = Model(path, ModelParams(dtype=args.dtype, device=str(dev)))
    sync(dev)
    phase("Model()", time.perf_counter() - t0, "(the port's whole load, every tensor)")
    m.close()
    return res


def _repack(kind, b: torch.Tensor, n_rows: int):
    """Engine kind `kind`'s repack of uploaded Q4_K bytes on their device:
    what models/llama.Q4K_REPACKS does after its own upload."""
    from ..ops import quant_matmul as qm

    if kind in ("k4", "a8k4"):
        return (qm.QuantTensorK4 if kind == "k4" else qm.QuantTensorA8K4)(b.view(n_rows, -1))
    codes, scales, mins = qm.decode_q4k_blocks(b.view(-1, qm.Q4K_BLOCK), n_rows)
    if kind == "a8x":
        return qm.QuantTensorA8(codes.to(torch.int8).contiguous(),
                                scales.to(torch.float16).contiguous(),
                                mins.to(torch.float16).contiguous())
    return (qm.pack_a8s if kind == "a8" else qm.pack_exact)(codes, scales, mins)


if __name__ == "__main__":
    main()
