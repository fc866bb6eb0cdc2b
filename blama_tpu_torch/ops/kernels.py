"""Build, load and count the hand-written CUDA kernels.

Every kernel source under ``ops/csrc/`` is compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes``. Libraries are built at first use into ``build/kernels/`` at the
repository root, named by a hash of the source, the shared ``*.cuh`` headers
and the flags, so an edited source is rebuilt and an unchanged one is reused.
All sources build in parallel, one ``nvcc`` per source.

Each wrapper that launches a kernel adds one to its entry in ``LAUNCHES``
at the launch and nowhere else, so a run can show which kernels it went
through (``reset_launches`` before, read ``LAUNCHES`` after). Under a CUDA
graph's capture (``ops/step_graph.py``) a launch only records itself in the
capture's ``recording``; each replay of the graph adds what its capture
recorded (``add_launches``), so a graphed run counts what the same run
counts eagerly. The capture's warm-up run, whose results are dropped, counts
nothing (``uncounted``).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points of each source, with their argument types
SIGNATURES = {
    "quant_matmul": {
        "w4a8_matmul_launch": [_P, _I, _P, _P, _P, _I, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _P],
        "w4a8k4_matmul_launch": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "q4k_dequant_mm_launch": [_P, _I, _P, _P, _I, _I, _P, _I, _I, _I, _P],
        "q8_dequant_mm_launch": [_P, _I, _P, _P, _I, _I, _P, _I, _I, _I, _P],
        "q4k_native_mm_launch": [_P, _I, _P, _I, _P, _I, _I, _I, _P],
        "w4a8_bank_launch": [_P, _I, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _P],
        "q4k_bank_mm_launch": [_P, _I, _I, _P, _P, _P, _I, _P, _I, _I, _I, _P,
                               _I, _I, _I, _P],
        "q4k_parts_mm_launch": [_P, _I, _P, _P, _P, _I, _I, _I, _P, _I, _I, _I, _P],
        "dequant_tile_shape": [_I, _P],
        "dequant_row_shape": [_I, _I, _I, _P],
    },
    "slab_gemv": {
        "w4a8_slab_launch": [_P, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I,
                             _P],
        "w4a8_plane_launch": [_P, _I, _P, _I, _P, _I, _I, _I, _I, _P, _P, _P, _P, _I, _I,
                              _I, _P],
        "w4a8k4_slab_launch": [_P, _I, _P, _I, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _P],
        "slab_slot_size": [_I, _I, _I],
        "slab_smem_size": [_I] * 6,
    },
    "twodot": {
        "q4k_twodot_launch": [_P, _P, _P, _I, _I, _I, _I, _P, _I, _I, _I, _P],
    },
    "decode_attention": {
        "decode_attention_launch": [_P] * 14 + [_I] * 9 + [_F, _P],
        "decode_attention_hb_launch": [_P] * 14 + [_I] * 9 + [_F, _P],
        "prefill_attention_launch": [_P] * 18 + [_I] * 9 + [_F, _P],
    },
    "probes": {
        "stream_rows_launch": [_P, _I, _I, _I, _I, _I, _I, _P, _P, _P],
        "add_one_launch": [_P, _P, _I, _P],
        "bytes_launch": [_I, _P, _P, _P, _I, _P],
        "int8_dot_launch": [_I, _P, _P, _P, _I, _I, _I, _P],
        "casts_launch": [_I, _P, _P, _P],
    },
    "paged_attention": {
        "paged_decode_attention_launch": [_P] * 12 + [_I] * 9 + [_F, _P],
        "paged_prefill_attention_launch": [_P] * 19 + [_I] * 10 + [_F, _P],
    },
    "attention_f32": {
        "decode_attention_f32_launch": [_P] * 11 + [_I] * 8 + [_F, _P],
        "prefill_attention_f32_launch": [_P] * 18 + [_I] * 9 + [_F, _P],
        "paged_decode_attention_f32_launch": [_P] * 12 + [_I] * 9 + [_F, _P],
        "paged_prefill_attention_f32_launch": [_P] * 19 + [_I] * 10 + [_F, _P],
    },
}

# launch counts per kernel (see module docstring)
LAUNCHES = {"w4a8_gemv": 0, "q4k_dequant_matmul": 0, "q8_dequant_matmul": 0,
            "q4k_native_matmul": 0, "w4a8k4_gemv": 0,
            "w4a8_bank_gemv": 0, "q4k_bank_matmul": 0,
            "q4k_parts_matmul": 0, "w4a8_parts_gemv": 0,
            "w4a8_slab_gemv": 0, "w4a8k4_slab_gemv": 0,
            "q4k_twodot_matmul": 0, "w4a8_plane_matmul": 0, "w4a8_packed_matmul": 0,
            "stream_rows": 0, "add_one": 0,
            "swar_roundtrip": 0, "swar_lo_hi": 0, "swar_dot": 0,
            "u8_bitops": 0, "i16_bitops": 0, "i8_dot": 0, "unpack_dot": 0,
            **{f"casts_{p}": 0 for p in (
                "reshape_8x128", "reshape_1x1024", "reshape_32x1", "lane_slice",
                "lane_concat", "sublane_stride", "group_max", "reshape_4d", "reshape_3d",
                "round_int8", "row_select_dot", "scratch_store")},
            "decode_attention": 0, "prefill_attention": 0,
            "decode_attention_fresh": 0, "decode_attention_hb": 0,
            "decode_attention_write": 0,
            "paged_decode_attention": 0, "paged_prefill_attention": 0,
            "decode_attention_f32q": 0, "prefill_attention_f32q": 0,
            "paged_decode_attention_f32q": 0, "paged_prefill_attention_f32q": 0}

_libs: dict[str, ctypes.CDLL] = {}
# where count() adds: LAUNCHES, a capture's record, or nowhere (a warm-up)
_sink: dict | None = LAUNCHES


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def count(name: str) -> None:
    if _sink is not None:
        _sink[name] = _sink.get(name, 0) + 1


def add_launches(counts: dict) -> None:
    """A graph's replay: the launches its capture recorded, once more."""
    for k, n in counts.items():
        LAUNCHES[k] += n


@contextlib.contextmanager
def _counting_into(sink):
    global _sink
    held, _sink = _sink, sink
    try:
        yield sink
    finally:
        _sink = held


_plain = threading.local()


def plain_version(fn):
    """Marks a kernel's plain version: it stands in for the kernel on the
    CPU, so the host-read guard of a captured step
    (ops/step_graph.capture_guard) does not reach into it; on the card the
    kernel runs in its place."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        _plain.depth = getattr(_plain, "depth", 0) + 1
        try:
            return fn(*args, **kwargs)
        finally:
            _plain.depth -= 1
    return run


def in_plain_version() -> bool:
    return getattr(_plain, "depth", 0) > 0


def recording():
    """Within it, launches are recorded into the dict it yields, not
    counted: the capture of a graph, whose kernels run at its replays."""
    return _counting_into({})


def uncounted():
    """Within it, launches count nowhere: a capture's warm-up run."""
    return _counting_into(None)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):   # shared device code
        src += header.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{tag}.so"


def build_all() -> float:
    """Compile every source that has no library yet, all in parallel.
    Returns the seconds spent; raises with nvcc's output on a failure."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in SIGNATURES:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = BUILD_DIR / f"{name}.nvcc.log"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        fh = open(log, "w")
        procs.append((name, out, tmp, log, fh,
                      subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, log, fh, proc in procs:
        rc = proc.wait()
        fh.close()
        if rc != 0:
            failed.append(f"{name}: nvcc exit {rc}\n{log.read_text()}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of source `name`, building the kernels if needed."""
    if name not in _libs:
        path = _lib_path(name)
        if not path.exists():
            build_all()
        so = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(so, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _libs[name] = so
    return _libs[name]


def resolve_device(device) -> torch.device:
    """The torch device for `device`; raises if it names CUDA and no card is
    present, so an entry point never carries on on the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: launch failed (CUDA error {rc})")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
