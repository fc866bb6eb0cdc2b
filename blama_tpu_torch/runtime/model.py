"""Model: GGUF load → config + vocab + device weights.

Mirror of the reference Model facade (Model.{hpp,cpp}): owns the loaded
weights and vocab and answers metadata queries. Weights go to
`ModelParams.device`, the CUDA card unless the caller asks for the CPU; a
missing card is an error, never a silent fall back to the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from ..gguf.reader import GGUFReader
from ..models.config import ModelConfig
from ..ops.kernels import resolve_device
from .vocab import Vocab

ModelLoadProgressCb = Callable[[float], None]



@dataclass
class ModelParams:
    """Reference: Model::Params (Model.hpp:28-34). `dtype` selects the
    weight engine; the port serves `q4k_a8` (W4A8 on packed Q4_K)."""

    vocab_only: bool = False
    prefix_inputs_with_bos: bool = False
    dtype: str = "float32"
    mesh: object = None
    sharding_rules: object = None
    tp_blocks: int = -1
    moe_ragged: bool | None = None
    # flash attention kernels (own numerics: prover and verifier pick the
    # same mode); the reference's "xla" mode is not ported
    attn: str = "fused"
    device: str = "cuda"


class Model:
    def __init__(self, gguf_path: str, params: ModelParams | None = None,
                 progress_cb: ModelLoadProgressCb | None = None):
        self.params = params or ModelParams()
        self.device = resolve_device(self.params.device)
        if (self.params.mesh is not None or self.params.sharding_rules is not None
                or self.params.tp_blocks > 0 or self.params.moe_ragged is not None):
            raise NotImplementedError(
                "meshes, sharding and tp_blocks are not ported "
                "(ROADMAP.md §1 item 13, multi-GPU)")
        if self.params.attn == "xla":
            raise NotImplementedError(
                "attn='xla' (the two-pass chain for every chunk) is not ported; "
                "the port serves attn='fused' (ROADMAP.md §1 item 9, other engines)")
        if self.params.attn != "fused":
            raise ValueError(
                f"ModelParams.attn must be 'fused', got {self.params.attn!r}")
        self.reader = GGUFReader(gguf_path)
        self.config = ModelConfig.from_gguf(self.reader)
        from ..models.llama import ARCHS

        if self.config.is_moe:
            raise NotImplementedError(
                "MoE models are not ported (ROADMAP.md §1 item 10)")
        if self.config.arch not in ARCHS:
            raise NotImplementedError(
                f"architecture {self.config.arch!r} is not ported "
                "(ROADMAP.md §1 item 12, other families)")
        self.config.attn_fused = True
        self.vocab = Vocab.from_gguf(self.reader)
        self.weights = None
        if not self.params.vocab_only:
            self.weights = self._load_weights(progress_cb)

    def _load_weights(self, progress_cb: ModelLoadProgressCb | None):
        if self.params.dtype != "q4k_a8":
            raise NotImplementedError(
                f"dtype={self.params.dtype!r} is not ported; the port serves "
                "'q4k_a8' (ROADMAP.md §1 item 9, other engines)")
        from ..models.llama import load_llama_params

        if progress_cb:
            progress_cb(0.0)
        w = load_llama_params(self.reader, self.config, fused_quant="a8",
                              device=self.device, progress_cb=progress_cb)
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
