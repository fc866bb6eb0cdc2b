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
  server/    HTTP server, continuous-batching scheduler
  examples/  the reference's four example programs

Entry points run on the CUDA card unless the caller passes device="cpu";
on the CPU every kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"


def init_library() -> None:
    """One-time library init (the reference's initLibrary(), Init.cpp:34-38).

    PyTorch sets its devices up lazily; this exists for API parity and logs
    the platform: the torch version and the CUDA cards (none: the CPU).
    """
    import logging

    import torch

    cards = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
    logging.getLogger("blama_tpu_torch").info(
        "blama_tpu_torch %s: torch %s, devices: %s", __version__, torch.__version__,
        cards or ["cpu"])
