"""blama_tpu_torch — the PyTorch/CUDA port of blama_tpu for NVIDIA Hopper.

Verifiable GGUF inference: every generated token is recorded with its
top-10 logits, and a verifier replays the claimed tokens (fill_ctx) and
scores the agreement (LogitComparer). The port mirrors blama_tpu's layout;
plain tensor code is PyTorch and every kernel the TPU package wrote in Pallas
is a hand-written CUDA C++ kernel for sm_90a (ops/csrc/).

Layers:
  gguf/      GGUF container + F32/F16/Q4_K formats (host, numpy)
  models/    model config, weight loading, the llama forward pass
  ops/       quantized matmul, attention, rope, KV cache, decode loops;
             ops/csrc/ holds the CUDA kernels, ops/kernels.py builds them
  runtime/   Model / Instance / Session, sampler, verification

Entry points run on the CUDA card unless the caller passes device="cpu";
on the CPU every kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"
