"""Model configuration parsed from GGUF metadata.

Analog of llama.cpp's llm hyperparameter loading, exposing the
query surface the reference uses: train context length, embedding width,
layer count, encoder presence, chat template id
(reference llama/Model.cpp:57-83).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

SUPPORTED_ARCHS = ("llama", "mistral", "mixtral", "qwen2", "gpt2", "bert", "gemma", "phi3", "t5")


@dataclass
class ModelConfig:
    arch: str = "llama"
    n_layer: int = 0
    n_embd: int = 0
    n_head: int = 0
    n_head_kv: int = 0
    n_ff: int = 0
    n_vocab: int = 0
    n_ctx_train: int = 2048
    rope_freq_base: float = 10000.0
    rope_dim: int = 0                  # rotary dims per head (0 → head_dim)
    rope_scaling_type: str = "none"    # none | linear | yarn
    rope_scale_factor: float = 1.0
    rope_attn_factor: float = 1.0      # YaRN attention magnitude scale
    rope_orig_ctx: int = 0             # YaRN original context (0 → n_ctx_train)
    rms_norm_eps: float = 1e-5
    layer_norm_eps: float = 1e-5
    n_expert: int = 0
    n_expert_used: int = 0
    head_dim: int = 0                  # 0 → n_embd // n_head
    # model-family toggles
    parallel_residual: bool = False
    use_rms_norm: bool = True          # llama family; gpt2/bert use layernorm
    tie_word_embeddings: bool = False
    causal: bool = True                # bert: False
    pooling_type: int = 0              # 0 none, 1 mean, 2 cls (bert family)
    has_encoder: bool = False
    act_fn: str = "silu"               # silu | gelu
    emb_scale: float = 1.0             # input embedding multiplier (gemma: sqrt(E))
    norm_plus_one: bool = False        # RMSNorm weight applied as (1 + w) (gemma)
    # the (1 + w) sum rounds to bf16: the dense bfloat16 engine, whose norm
    # weights the reference keeps in bf16. Set by Model from ModelParams.
    norm_bf16: bool = False
    chat_template: str = ""
    # fixed-topology contraction blocks for sharding-invariant logits
    # (power of two ≥ max tp degree; 0 = plain contraction). Set by Model
    # from ModelParams, not from GGUF metadata.
    tp_blocks: int = 0
    # fused flash attention over the KV cache (in-kernel rope/INT8
    # dequant); False: the two-pass chain at every chunk (attn="xla"). Set
    # by Model from ModelParams (False for a MoE file) and by Instance where
    # the fused gates refuse its geometry.
    attn_fused: bool = True
    # extra raw metadata for model-specific needs
    extra: dict[str, Any] = field(default_factory=dict)

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.n_embd // self.n_head if self.n_head else 0)

    @property
    def rope_dim_(self) -> int:
        return self.rope_dim or self.head_dim_

    @property
    def is_moe(self) -> bool:
        return self.n_expert > 0

    def chat_template_id(self) -> str:
        """Reference: Model::getChatTemplateId with "chatml" fallback
        (Model.cpp:70-83)."""
        return self.chat_template or "chatml"

    @classmethod
    def from_metadata(cls, md: dict[str, Any]) -> "ModelConfig":
        arch = md.get("general.architecture", "llama")

        def g(key: str, default=None):
            return md.get(f"{arch}.{key}", default)

        n_head = int(g("attention.head_count", 0) or 0)
        cfg = cls(
            arch=arch,
            n_layer=int(g("block_count", 0) or 0),
            n_embd=int(g("embedding_length", 0) or 0),
            n_head=n_head,
            n_head_kv=int(g("attention.head_count_kv", n_head) or n_head),
            n_ff=int(g("feed_forward_length", 0) or 0),
            n_ctx_train=int(g("context_length", 2048) or 2048),
            rope_freq_base=float(g("rope.freq_base", 10000.0) or 10000.0),
            rope_dim=int(g("rope.dimension_count", 0) or 0),
            rms_norm_eps=float(g("attention.layer_norm_rms_epsilon", 1e-5) or 1e-5),
            layer_norm_eps=float(g("attention.layer_norm_epsilon", 1e-5) or 1e-5),
            n_expert=int(g("expert_count", 0) or 0),
            n_expert_used=int(g("expert_used_count", 0) or 0),
            head_dim=int(g("attention.key_length", 0) or 0),
            chat_template=str(md.get("tokenizer.chat_template", "") or ""),
        )
        scaling = g("rope.scaling.type")
        if scaling:
            cfg.rope_scaling_type = str(scaling)
            cfg.rope_scale_factor = float(g("rope.scaling.factor", 1.0) or 1.0)
            cfg.rope_attn_factor = float(g("rope.scaling.attn_factor", 1.0) or 1.0)
            cfg.rope_orig_ctx = int(g("rope.scaling.original_context_length", 0) or 0)

        tokens = md.get("tokenizer.ggml.tokens")
        cfg.n_vocab = int(g("vocab_size", 0) or (len(tokens) if tokens is not None else 0))

        if arch == "gpt2":
            cfg.use_rms_norm = False
            cfg.act_fn = "gelu"
        elif arch == "bert":
            cfg.use_rms_norm = False
            cfg.act_fn = "gelu"
            cfg.causal = False
            cfg.pooling_type = int(g("pooling_type", 2) or 2)
        elif arch in ("gemma", "gemma2"):
            cfg.act_fn = "gelu"
            cfg.tie_word_embeddings = True
            cfg.emb_scale = float(cfg.n_embd) ** 0.5
            cfg.norm_plus_one = True
        elif arch == "t5":
            cfg.has_encoder = True
            cfg.extra["rel_buckets"] = int(g("attention.relative_buckets_count", 32) or 32)
            cfg.extra["rel_max_distance"] = int(g("attention.relative_max_distance", 128) or 128)
            cfg.extra["decoder_start_token_id"] = g("decoder_start_token_id")

        return cfg

    @classmethod
    def from_gguf(cls, reader) -> "ModelConfig":
        return cls.from_metadata(reader.metadata)
