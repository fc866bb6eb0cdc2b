"""Deterministic model fixtures for the port's tests and its chip smoke run.

Tiny-but-real GGUF models (genuine Q4_K tensors, SPM-style vocab with byte
fallback) with seeded weights, and a direct-packed synthesizer for full-size
geometries. A copy of the JAX package's fixtures, so the port and its smoke
script never import that package; the same seed writes the same file.
"""

from __future__ import annotations

import numpy as np

from .gguf import GGMLType, GGUFWriter
from .runtime.vocab import TT_BYTE, TT_CONTROL, TT_NORMAL, TT_UNKNOWN


def tiny_spm_vocab() -> tuple[list[str], list[float], list[int]]:
    """SPM-style vocab: specials + 256 byte tokens + merge chains for a few
    words, so 'hello world' tokenizes to whole-word pieces and anything else
    falls back to bytes."""
    tokens = ["<unk>", "<s>", "</s>"]
    types = [TT_UNKNOWN, TT_CONTROL, TT_CONTROL]
    scores = [-1e9, 0.0, 0.0]
    for b in range(256):
        tokens.append(f"<0x{b:02X}>")
        types.append(TT_BYTE)
        scores.append(-1e6)

    words = ["hello", "world", "president", "george", "bush", "the", "cat", "sat"]
    for w in words:
        piece = "▁" + w
        for ln in range(2, len(piece) + 1):
            sub = piece[:ln]
            if sub not in tokens:
                tokens.append(sub)
                types.append(TT_NORMAL)
                scores.append(-float(ln))
    # common suffix fragments for multi-token words
    for frag in ["ing", "ed", "er", "s"]:
        if frag not in tokens:
            tokens.append(frag)
            types.append(TT_NORMAL)
            scores.append(-20.0)
    # FIM (fill-in-middle) control tokens
    for t in ["<|fim_pre|>", "<|fim_suf|>", "<|fim_mid|>"]:
        tokens.append(t)
        types.append(TT_CONTROL)
        scores.append(0.0)
    return tokens, scores, types


TINY_LLAMA_SPEC = dict(
    n_layer=2,
    n_embd=256,
    n_head=4,
    n_head_kv=2,
    n_ff=512,
    n_ctx=512,
    rope_freq_base=10000.0,
    rms_eps=1e-5,
)


def write_tiny_llama(
    path: str,
    quant: GGMLType = GGMLType.Q4_K,
    seed: int = 1234,
    chat_template: str = "",
    spec: dict | None = None,
) -> None:
    """Write a deterministic tiny llama-architecture GGUF model."""
    s = dict(TINY_LLAMA_SPEC)
    if spec:
        s.update(spec)
    tokens, scores, types = tiny_spm_vocab()
    n_vocab = len(tokens)
    E, H, HKV, F, L = s["n_embd"], s["n_head"], s["n_head_kv"], s["n_ff"], s["n_layer"]
    D = E // H

    rng = np.random.default_rng(seed)

    def w(shape, scale=None):
        scale = scale if scale is not None else (1.0 / np.sqrt(shape[-1]))
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    g = GGUFWriter(path)
    g.add_kv("general.architecture", "llama")
    g.add_kv("general.name", "tiny-llama-fixture")
    g.add_kv("llama.block_count", L)
    g.add_kv("llama.embedding_length", E)
    g.add_kv("llama.feed_forward_length", F)
    g.add_kv("llama.attention.head_count", H)
    g.add_kv("llama.attention.head_count_kv", HKV)
    g.add_kv("llama.attention.layer_norm_rms_epsilon", float(s["rms_eps"]))
    g.add_kv("llama.context_length", s["n_ctx"])
    g.add_kv("llama.rope.freq_base", float(s["rope_freq_base"]))
    g.add_kv("llama.rope.dimension_count", D)
    g.add_kv("llama.vocab_size", n_vocab)
    g.add_kv("tokenizer.ggml.model", "llama")
    g.add_kv("tokenizer.ggml.tokens", tokens)
    g.add_kv("tokenizer.ggml.scores", scores)
    g.add_kv("tokenizer.ggml.token_type", types)
    g.add_kv("tokenizer.ggml.bos_token_id", 1)
    g.add_kv("tokenizer.ggml.eos_token_id", 2)
    g.add_kv("tokenizer.ggml.unknown_token_id", 0)
    g.add_kv("tokenizer.ggml.add_bos_token", True)
    g.add_kv("tokenizer.ggml.add_space_prefix", True)
    g.add_kv("tokenizer.ggml.fim_pre_token_id", tokens.index("<|fim_pre|>"))
    g.add_kv("tokenizer.ggml.fim_suf_token_id", tokens.index("<|fim_suf|>"))
    g.add_kv("tokenizer.ggml.fim_mid_token_id", tokens.index("<|fim_mid|>"))
    if chat_template:
        g.add_kv("tokenizer.chat_template", chat_template)

    # norms stay f32 (as real GGUF files do)
    g.add_tensor("token_embd.weight", w((n_vocab, E), 0.05), quant)
    g.add_tensor("output_norm.weight", np.ones(E, np.float32) + w((E,), 0.01), GGMLType.F32)
    if not s.get("tie_output"):  # tied-embedding models omit output.weight
        g.add_tensor("output.weight", w((n_vocab, E)), quant)
    for i in range(L):
        g.add_tensor(f"blk.{i}.attn_norm.weight", np.ones(E, np.float32) + w((E,), 0.01), GGMLType.F32)
        g.add_tensor(f"blk.{i}.attn_q.weight", w((H * D, E)), quant)
        g.add_tensor(f"blk.{i}.attn_k.weight", w((HKV * D, E)), quant)
        g.add_tensor(f"blk.{i}.attn_v.weight", w((HKV * D, E)), quant)
        g.add_tensor(f"blk.{i}.attn_output.weight", w((E, H * D)), quant)
        g.add_tensor(f"blk.{i}.ffn_norm.weight", np.ones(E, np.float32) + w((E,), 0.01), GGMLType.F32)
        g.add_tensor(f"blk.{i}.ffn_gate.weight", w((F, E)), quant)
        g.add_tensor(f"blk.{i}.ffn_up.weight", w((F, E)), quant)
        g.add_tensor(f"blk.{i}.ffn_down.weight", w((E, F)), quant)
    g.write()


# ---------------------------------------------------------------------------
# fast direct-packed synthesis (for benchmarks: no float source material)
# ---------------------------------------------------------------------------

MODEL_PRESETS = {
    # TinyLlama-1.1B geometry
    "tinyllama-1.1b": dict(n_layer=22, n_embd=2048, n_head=32, n_head_kv=4,
                           n_ff=5632, n_ctx=2048, n_vocab=32000),
    # Llama-3-8B geometry
    "llama3-8b": dict(n_layer=32, n_embd=4096, n_head=32, n_head_kv=8,
                      n_ff=14336, n_ctx=8192, n_vocab=128256,
                      rope_freq_base=500000.0),
    # ~0.3B debug size
    "debug-0.3b": dict(n_layer=8, n_embd=1024, n_head=16, n_head_kv=4,
                       n_ff=2816, n_ctx=2048, n_vocab=32000),
}


def _pack_q4_k_direct(rng: np.random.Generator, n_rows: int, row_len: int,
                      sigma: float) -> bytes:
    """Directly synthesize packed Q4_K superblocks with plausible statistics:
    random 4-bit codes, fixed mid scales, and d chosen so dequantized values
    have std ≈ sigma. ~100x faster than quantizing random floats."""
    n_blocks = (n_rows * row_len) // 256
    out = np.zeros((n_blocks, 144), dtype=np.uint8)
    # std of uniform q in [0,15] is ~4.61; effective scale = d*sc with sc=32
    d = np.float16(sigma / (32 * 4.61))
    dmin = np.float16(float(d) * 32 * 7.5 / 32)  # centers E[q]=7.5
    out[:, 0:2] = np.frombuffer(d.tobytes(), dtype=np.uint8)
    out[:, 2:4] = np.frombuffer(dmin.tobytes(), dtype=np.uint8)
    from .gguf.quants import _pack_scale_min_k4

    sc = np.full((1, 8), 32, np.int64)
    out[:, 4:16] = _pack_scale_min_k4(sc, sc)[0]
    out[:, 16:] = rng.integers(0, 256, size=(n_blocks, 128), dtype=np.uint8)
    return out.tobytes()


def _pack_f32_norm(n: int) -> tuple[bytes, tuple[int, ...]]:
    return np.ones(n, np.float32).tobytes(), (n,)


def synthesize_llama_gguf(path: str, preset: str = "tinyllama-1.1b",
                          seed: int = 7, quant: GGMLType = GGMLType.Q4_K) -> dict:
    """Write a realistic-size llama GGUF with direct-packed quantized tensors.

    Weight *values* are random (throughput benchmarking does not depend on
    them) but every byte layout, metadata key, and tensor name is real, so the
    full load path (parse → dequant/repack → upload) is exercised.
    """
    if quant != GGMLType.Q4_K:
        raise NotImplementedError("direct synthesis packs Q4_K only in the port")
    s = dict(MODEL_PRESETS[preset])
    E, H, HKV, F, L, V = (s["n_embd"], s["n_head"], s["n_head_kv"],
                          s["n_ff"], s["n_layer"], s["n_vocab"])
    D = E // H
    rng = np.random.default_rng(seed)

    tokens = ["<unk>", "<s>", "</s>"]
    types = [TT_UNKNOWN, TT_CONTROL, TT_CONTROL]
    scores = [-1e9, 0.0, 0.0]
    for b in range(256):
        tokens.append(f"<0x{b:02X}>")
        types.append(TT_BYTE)
        scores.append(-1e6)
    for i in range(V - len(tokens)):
        tokens.append(f"▁tok{i}")
        types.append(TT_NORMAL)
        scores.append(-10.0)

    g = GGUFWriter(path)
    g.add_kv("general.architecture", "llama")
    g.add_kv("general.name", f"synthetic-{preset}")
    g.add_kv("llama.block_count", L)
    g.add_kv("llama.embedding_length", E)
    g.add_kv("llama.feed_forward_length", F)
    g.add_kv("llama.attention.head_count", H)
    g.add_kv("llama.attention.head_count_kv", HKV)
    g.add_kv("llama.attention.layer_norm_rms_epsilon", 1e-5)
    g.add_kv("llama.context_length", s["n_ctx"])
    g.add_kv("llama.rope.freq_base", float(s.get("rope_freq_base", 10000.0)))
    g.add_kv("llama.rope.dimension_count", D)
    g.add_kv("llama.vocab_size", V)
    g.add_kv("tokenizer.ggml.model", "llama")
    g.add_kv("tokenizer.ggml.tokens", tokens)
    g.add_kv("tokenizer.ggml.scores", scores)
    g.add_kv("tokenizer.ggml.token_type", types)
    g.add_kv("tokenizer.ggml.bos_token_id", 1)
    g.add_kv("tokenizer.ggml.eos_token_id", 2)
    g.add_kv("tokenizer.ggml.unknown_token_id", 0)
    g.add_kv("tokenizer.ggml.add_bos_token", True)

    def q(name, n_out, n_in, sigma=None):
        sigma = sigma if sigma is not None else 1.0 / np.sqrt(n_in)
        g.add_tensor(name, None, quant,
                     raw_bytes=_pack_q4_k_direct(rng, n_out, n_in, sigma),
                     ne=(n_in, n_out))

    def norm(name, n):
        data, ne = _pack_f32_norm(n)
        g.add_tensor(name, None, GGMLType.F32, raw_bytes=data, ne=ne)

    q("token_embd.weight", V, E, 0.02)
    norm("output_norm.weight", E)
    q("output.weight", V, E)
    for i in range(L):
        norm(f"blk.{i}.attn_norm.weight", E)
        q(f"blk.{i}.attn_q.weight", H * D, E)
        q(f"blk.{i}.attn_k.weight", HKV * D, E)
        q(f"blk.{i}.attn_v.weight", HKV * D, E)
        q(f"blk.{i}.attn_output.weight", E, H * D)
        norm(f"blk.{i}.ffn_norm.weight", E)
        q(f"blk.{i}.ffn_gate.weight", F, E)
        q(f"blk.{i}.ffn_up.weight", F, E)
        q(f"blk.{i}.ffn_down.weight", E, F)
    g.write()
    return s


def cached_llama_gguf(preset: str = "llama3-8b", seed: int = 7) -> str:
    """Path of synthesize_llama_gguf(preset, seed) in the temp directory,
    written once (atomically) and reused by later runs."""
    import os
    import tempfile

    path = os.path.join(tempfile.gettempdir(),
                        f"blama_tpu_torch-{preset}-seed{seed}.gguf")
    if not os.path.exists(path):
        tmp = f"{path}.{os.getpid()}.tmp"
        synthesize_llama_gguf(tmp, preset, seed=seed)
        os.replace(tmp, path)
    return path
