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


_NO_CUDA = r"""
import sys
sys.path.insert(0, {root!r})
import numpy as np
import torch
assert not torch.cuda.is_available()
from blama_tpu_torch.models.llama import params_from_jax
from blama_tpu_torch.ops import quant_matmul as qm
from blama_tpu_torch.runtime.model import Model, ModelParams
from blama_tpu_torch.testing import write_tiny_llama
write_tiny_llama({path!r})
q4k = np.zeros(144, np.uint8)
calls = {{
    "Model": lambda: Model({path!r}, ModelParams(dtype="q4k_a8", attn="fused")),
    "params_from_jax": lambda: params_from_jax({{}}),
    "unpack_q4k": lambda: qm.unpack_q4k(q4k, 1, 256),
    "repack_q4k_a8s": lambda: qm.repack_q4k_a8s(q4k, 1, 256),
    "repack_q4k_embedding": lambda: qm.repack_q4k_embedding(q4k, 1, 256),
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
    assert len(lines) == 5, out.stdout
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
