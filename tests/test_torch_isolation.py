"""The port stands alone: importing every module of blama_tpu_torch and the
chip smoke script loads neither jax nor anything of blama_tpu, and its
entry points refuse to fall back to the CPU when no card is present."""

import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, json, pkgutil, sys
sys.path.insert(0, {root!r})
import blama_tpu_torch
names = [m.name for m in pkgutil.walk_packages(blama_tpu_torch.__path__, "blama_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "blama_tpu"
             or m.startswith("blama_tpu."))
print(json.dumps({{"modules": names, "bad": bad}}))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _PROBE.format(root=str(ROOT))],
                         capture_output=True, text=True, check=True, cwd=ROOT)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert "blama_tpu_torch.runtime.session" in res["modules"]
    assert "blama_tpu_torch.ops.decode_attention" in res["modules"]
    for name in ("ops.paged_kv", "ops.paged_attention", "runtime.chat", "runtime.grammar",
                 "runtime.antiprompt", "server.scheduler", "server.scheduler_server",
                 "server.server", "server.http", "utils.logging", "utils.metrics",
                 "tools.profile_step", "models.moe", "testing", "ops.probes",
                 "tools.common", "tools.probe_bw", "tools.probe_overhead",
                 "tools.probe_ceiling", "tools.autotune_a8s", "tools.ab_a8k4",
                 "tools.bench_serving", "tools.profile_load", "tools.trace_step",
                 "tools.ubench_q4k", "tools.probe_swar", "tools.probe_mosaic",
                 "tools.probe_casts", "tools.ubench_attn", "tools.ubench_paged",
                 "ops.dequant", "tools.perplexity", "tools.ppl_compare"):
        assert f"blama_tpu_torch.{name}" in res["modules"], name


_NO_CUDA = r"""
import sys
sys.path.insert(0, {root!r})
import numpy as np
import torch
assert not torch.cuda.is_available()
from blama_tpu_torch.models.llama import params_from_jax
from blama_tpu_torch.ops import quant_matmul as qm
from blama_tpu_torch.runtime.model import Model, ModelParams
from blama_tpu_torch.models.moe import params_from_jax as params_from_jax_moe
from blama_tpu_torch.testing import synthesize_moe_gguf, write_tiny_llama
write_tiny_llama({path!r})
moe_path = {path!r} + ".moe.gguf"
synthesize_moe_gguf(moe_path, "mixtral-debug")
q4k = np.zeros(144, np.uint8)
calls = {{
    "Model": lambda: Model({path!r}, ModelParams(dtype="q4k_a8", attn="fused")),
    "params_from_jax": lambda: params_from_jax({{}}),
    "unpack_q4k": lambda: qm.unpack_q4k(q4k, 1, 256),
    "repack_q4k_a8s": lambda: qm.repack_q4k_a8s(q4k, 1, 256),
    "repack_q4k_embedding": lambda: qm.repack_q4k_embedding(q4k, 1, 256),
    "repack_q4k_exact": lambda: qm.repack_q4k_exact(q4k, 1, 256),
    "repack_q4k_native": lambda: qm.repack_q4k_native(q4k, 1, 256),
    "repack_q4k_a8k4": lambda: qm.repack_q4k_a8k4(q4k, 1, 256),
    "repack_q4k_w4a8": lambda: qm.repack_q4k_w4a8(q4k, 1, 256),
    "repack_q8_0": lambda: qm.repack_q8_0(np.zeros(34 * 8, np.uint8), 1, 256),
    "repack_q6_k_expanded": lambda: qm.repack_q6_k_expanded(np.zeros(210, np.uint8), 1, 256),
    "Model q4k_fused": lambda: Model({path!r}, ModelParams(dtype="q4k_fused")),
    "Model q4k_a8_k4": lambda: Model({path!r}, ModelParams(dtype="q4k_a8_k4")),
    "Model tp_blocks": lambda: Model({path!r}, ModelParams(dtype="q4k_fused", tp_blocks=8)),
    "repack_q4k_bank": lambda: qm.repack_q4k_bank(q4k, 1, 1, 256, True),
    "Model MoE q4k_a8": lambda: Model(moe_path, ModelParams(dtype="q4k_a8", attn="xla")),
    "Model MoE q4k_fused": lambda: Model(moe_path, ModelParams(dtype="q4k_fused", attn="xla")),
    "moe.params_from_jax": lambda: params_from_jax_moe({{}}),
    "Model float32": lambda: Model({path!r}),
    "Model bfloat16 xla": lambda: Model({path!r}, ModelParams(dtype="bfloat16", attn="xla")),
}}
for name, call in calls.items():
    try:
        call()
    except RuntimeError as e:
        print(name, "refused:", e)
    else:
        print(name, "ran on the CPU")
"""


def test_model_without_cuda_raises(tmp_path):
    """Without device="cpu" the Model and the weight entry points want the
    card; on a machine without one each raises instead of running on the
    CPU."""
    code = _NO_CUDA.format(root=str(ROOT), path=str(tmp_path / "t.gguf"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 20, out.stdout
    for line in lines:
        assert " refused: no CUDA device" in line, line


def test_chip_smoke_fails_without_a_card(tmp_path):
    """The smoke script exits non-zero and prints no result line when
    torch.cuda.is_available() is false."""
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, cwd=tmp_path,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


_NO_CUDA_SERVING = r"""
import os, sys
sys.path.insert(0, {root!r})
import torch
assert not torch.cuda.is_available()
from blama_tpu_torch.ops.kv_cache import KVCache
from blama_tpu_torch.ops.paged_kv import PagedKVCache
from blama_tpu_torch.models.llama import cache_from_jax, paged_cache_from_jax
from blama_tpu_torch.server import http
from blama_tpu_torch.testing import write_tiny_llama
write_tiny_llama({path!r})
os.environ.update(BLAMA_MODEL={path!r}, BLAMA_SCHEDULER="2", BLAMA_PAGED_KV="1",
                  BLAMA_HOST="127.0.0.1", BLAMA_PORT="7331")
calls = {{
    "KVCache.create": lambda: KVCache.create(1, 1, 8, 1, 8, "bfloat16"),
    "PagedKVCache.create": lambda: PagedKVCache.create(1, 1, 2, 128, 1, 1, 8),
    "cache_from_jax": lambda: cache_from_jax({{}}),
    "paged_cache_from_jax": lambda: paged_cache_from_jax({{}}),
    "http.main": http.main,
}}
for name, call in calls.items():
    try:
        call()
    except RuntimeError as e:
        print(name, "refused:", e)
    else:
        print(name, "ran on the CPU")
"""


def test_serving_entry_points_without_cuda_raise(tmp_path):
    """The server's main, the caches and the cache conversions want the card
    unless the caller asks for the CPU; without one each raises."""
    code = _NO_CUDA_SERVING.format(root=str(ROOT), path=str(tmp_path / "t.gguf"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    lines = [l for l in out.stdout.strip().splitlines() if "refused" in l or "ran on" in l]
    assert len(lines) == 5, out.stdout
    for line in lines:
        assert " refused: no CUDA device" in line, line


def test_http_main_serves_on_the_cpu_when_asked(tmp_path):
    """`python -m blama_tpu_torch.server.http` with BLAMA_DEVICE=cpu: starts,
    answers a request over the paged scheduler and drains on SIGTERM."""
    import json
    import signal
    import socket
    import time
    import urllib.request

    from blama_tpu_torch.testing import write_tiny_llama

    path = str(tmp_path / "t.gguf")
    write_tiny_llama(path)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "BLAMA_MODEL": path, "BLAMA_DEVICE": "cpu", "BLAMA_HOST": "127.0.0.1",
           "BLAMA_PORT": str(port), "BLAMA_SCHEDULER": "2", "BLAMA_PAGED_KV": "1",
           "BLAMA_HORIZON": "4", "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}
    proc = subprocess.Popen([sys.executable, "-m", "blama_tpu_torch.server.http"], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        body = json.dumps({"prompt": "hello world", "max_tokens": 4, "temp": 0.0}).encode()
        out, deadline = None, time.time() + 120
        while out is None and time.time() < deadline and proc.poll() is None:
            try:
                req = urllib.request.Request(f"http://127.0.0.1:{port}/complete", body,
                                             method="POST")
                with urllib.request.urlopen(req, timeout=60) as r:
                    out = json.loads(r.read())
            except OSError:
                time.sleep(0.2)
        assert out is not None and len(out["tokenData"]) == 4, proc.poll()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        assert "continuous batching enabled (max_batch=2, paged KV)" in proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


_NO_CUDA_TOOLS = r"""
import sys
sys.path.insert(0, {root!r})
import importlib
import torch
assert not torch.cuda.is_available()
args = {{"perplexity": ["model.gguf", "text.txt"]}}
for name in ("probe_bw", "probe_overhead", "probe_ceiling", "autotune_a8s", "ab_a8k4",
             "bench_serving", "profile_load", "trace_step", "ubench_q4k", "probe_swar",
             "probe_mosaic", "probe_casts", "ubench_attn", "ubench_paged", "perplexity",
             "ppl_compare"):
    try:
        importlib.import_module("blama_tpu_torch.tools." + name).main(args.get(name, []))
    except RuntimeError as e:
        print(name, "refused:", e)
    else:
        print(name, "ran on the CPU")
"""


def test_tools_without_cuda_raise():
    """Each tool runs on the card unless given --device cpu: without a card
    its main raises before it builds anything."""
    out = subprocess.run([sys.executable, "-c", _NO_CUDA_TOOLS.format(root=str(ROOT))],
                         capture_output=True, text=True, check=True, cwd=ROOT, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 16, out.stdout
    for line in lines:
        assert " refused: no CUDA device" in line, line
