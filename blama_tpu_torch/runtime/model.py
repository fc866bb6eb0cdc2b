"""Model: GGUF load → config + vocab + device weights.

Mirror of the reference Model facade (Model.{hpp,cpp}): owns the loaded
weights and vocab and answers metadata queries. Weights go to
`ModelParams.device`, the CUDA card unless the caller asks for the CPU; a
missing card is an error, never a silent fall back to the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..gguf.reader import GGUFReader
from ..models.config import ModelConfig
from ..ops.kernels import resolve_device
from .vocab import Vocab

ModelLoadProgressCb = Callable[[float], None]

# ModelParams.dtype → load_llama_params' fused_quant (the reference's map):
# how a Q4_K tensor is packed. Q8_0 and Q6_K tensors take the exact int8-code
# kernel under every one of them, so `q8_0_fused` / `q6_k_fused` are the
# exact engine under the name of the file type they are meant for.
ENGINES = {"q4k_fused": True, "q4k_fused_k4": "k4", "q4k_a8": "a8",
           "q4k_a8_k4": "a8k4", "q4k_a8_xla": "a8x",
           "q8_0_fused": True, "q6_k_fused": True}
# the dense engines of a llama file (the reference's `dtype` for anything not
# in its fused map): every tensor dequantized to this dtype
# (models/llama.load_dense_params)
DENSE_ENGINES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the engines that serve a MoE (Mixtral-family) file: packed Q4_K expert banks
# for the exact engine and for W4A8 (models/moe.load_moe_params)
MOE_ENGINES = {"q4k_fused": True, "q4k_a8": "a8"}


@dataclass
class ModelParams:
    """Reference: Model::Params (Model.hpp:28-34). `dtype` selects the
    weight engine; the port serves the dense engines of DENSE_ENGINES (the
    reference's default, "float32", among them) and the packed engines of
    ENGINES on a llama file, those of MOE_ENGINES on a MoE file."""

    vocab_only: bool = False
    prefix_inputs_with_bos: bool = False
    dtype: str = "float32"
    mesh: object = None
    sharding_rules: object = None
    # fixed-topology blocks (sharding-invariant logits): -1 resolves to 0
    # (plain products) without a mesh, as in the reference; a solo verifier
    # replaying a tp-sharded prover sets the prover's value (8 on its mesh)
    tp_blocks: int = -1
    moe_ragged: bool | None = None
    # "fused": the flash attention kernels (own numerics: prover and verifier
    # pick the same mode); "xla": the two-pass chain at every chunk (the
    # reference's default, and the only mode of a MoE file, as there); None:
    # "fused" on a llama file, "xla" on a MoE file
    attn: str | None = None
    device: str = "cuda"


class Model:
    def __init__(self, gguf_path: str, params: ModelParams | None = None,
                 progress_cb: ModelLoadProgressCb | None = None):
        self.params = params or ModelParams()
        self.device = resolve_device(self.params.device)
        if self.params.mesh is not None or self.params.sharding_rules is not None:
            raise NotImplementedError(
                "meshes and sharding are not ported (ROADMAP.md §1 item 13, multi-GPU)")
        if self.params.attn not in ("xla", "fused", None):
            raise ValueError(
                f"ModelParams.attn must be 'xla' or 'fused', got {self.params.attn!r}")
        self.reader = GGUFReader(gguf_path)
        self.config = ModelConfig.from_gguf(self.reader)
        tpb = self.params.tp_blocks
        self.config.tp_blocks = 0 if tpb < 0 else tpb
        from ..models.llama import ARCHS

        if self.config.arch not in ARCHS:
            raise NotImplementedError(
                f"architecture {self.config.arch!r} is not ported "
                "(ROADMAP.md §1 item 12, other families)")
        if self.config.is_moe and self.params.attn == "fused":
            # the reference's refusal: fused attention is a verification
            # mode, and the MoE forward runs the two-pass chain only
            raise ValueError(
                "attn='fused' is unsupported with a MoE model; "
                "use attn='xla' (the MoE forward is XLA-attention only)")
        # moe_ragged picks the reference's mixture for DENSE expert banks only:
        # packed Q4_K banks take moe_ffn_quant before it is read
        # (blama_tpu/models/moe.py:374-377), and a llama file has no mixture
        if (self.params.moe_ragged is not None and self.config.is_moe
                and self.params.dtype not in MOE_ENGINES):
            raise NotImplementedError(
                f"moe_ragged with dtype={self.params.dtype!r}: the dense MoE "
                "engines, whose mixture it picks, are not ported "
                "(ROADMAP.md §1 item 10, the rest of MoE)")
        # the attention mode the model runs (Instance and the scheduler read it)
        self.config.attn_fused = (self.params.attn or
                                  ("xla" if self.config.is_moe else "fused")) == "fused"
        self.vocab = Vocab.from_gguf(self.reader)
        self.weights = None
        if not self.params.vocab_only:
            self.weights = self._load_weights(progress_cb)

    def _load_weights(self, progress_cb: ModelLoadProgressCb | None):
        engines = MOE_ENGINES if self.config.is_moe else {**ENGINES, **DENSE_ENGINES}
        if self.params.dtype not in engines:
            raise NotImplementedError(
                f"dtype={self.params.dtype!r} is not ported for "
                f"{'MoE' if self.config.is_moe else 'llama'} files; the port serves "
                f"{sorted(engines)} (ROADMAP.md §1 item 9, other engines"
                f"{'; item 10, dense MoE banks' if self.config.is_moe else ''})")
        if progress_cb:
            progress_cb(0.0)
        if self.config.is_moe:
            from ..models.moe import load_moe_params

            w = load_moe_params(self.reader, self.config, fused_quant=engines[self.params.dtype],
                                device=self.device, progress_cb=progress_cb)
        else:
            from ..models.llama import load_llama_params

            dense = DENSE_ENGINES.get(self.params.dtype)
            w = load_llama_params(self.reader, self.config,
                                  fused_quant=False if dense else engines[self.params.dtype],
                                  device=self.device, progress_cb=progress_cb,
                                  dtype=dense or torch.bfloat16)
        if progress_cb:
            progress_cb(1.0)
        return w

    # -- reference Model API -------------------------------------------------

    def train_ctx_length(self) -> int:
        return self.config.n_ctx_train

    def should_add_bos_token(self) -> bool:
        return self.vocab.should_add_bos()

    def has_encoder(self) -> bool:
        return self.config.has_encoder

    def get_chat_template_id(self) -> str:
        return self.config.chat_template_id()

    def prefix_inputs_with_bos(self) -> bool:
        return self.params.prefix_inputs_with_bos

    def close(self) -> None:
        self.reader.close()
