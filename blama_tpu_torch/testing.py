"""Deterministic model fixtures for the port's tests and its chip smoke run.

Tiny-but-real GGUF models (genuine Q4_K, Q8_0 or Q6_K tensors, SPM-style
vocab with byte fallback) with seeded weights, and a direct-packed synthesizer
for full-size geometries. A copy of the JAX package's fixtures, so the port
and its smoke script never import that package; `write_tiny_llama` writes the
same file from the same seed. Beyond the copy: the mixed-type layout of
llama.cpp's Q4_K_M, Q5_K_M and Q3_K_M files (`quant=Q4_K_M` ...), direct
Q6_K, Q5_K and Q3_K packers, a
`n_layer` cut of the presets, and the Mixtral-8x7B widths as a MoE preset.
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


# `quant` values selecting llama.cpp's LLAMA_FTYPE_MOSTLY_Q4_K_M,
# _Q5_K_M and _Q3_K_M tensor types (mixed_type)
Q4_K_M = "Q4_K_M"
Q5_K_M = "Q5_K_M"
Q3_K_M = "Q3_K_M"
MIXED = (Q4_K_M, Q5_K_M, Q3_K_M)


def _use_more_bits(i: int, n_layer: int) -> bool:
    """llama.cpp's use_more_bits: the first and last eighth of the layers
    and every third layer between."""
    return i < n_layer // 8 or i >= 7 * n_layer // 8 or (i - n_layer // 8) % 3 == 2


def mixed_type(recipe: str, name: str, n_layer: int) -> GGMLType:
    """The type llama.cpp's recipe (llama_tensor_get_type) gives a matmul
    tensor of a llama file. Q4_K_M / Q5_K_M: output.weight Q6_K; attn_v and
    ffn_down Q6_K where use_more_bits says so; everything else, token_embd
    included, Q4_K / Q5_K. Q3_K_M: output.weight Q6_K; attn_v Q5_K in the
    first two layers, else Q4_K; attn_output Q4_K; ffn_down Q5_K in the
    first sixteenth of the layers, else Q4_K; everything else Q3_K."""
    if name == "output.weight":
        return GGMLType.Q6_K
    i = int(name.split(".")[1]) if name.startswith("blk.") else -1
    if recipe == Q3_K_M:
        if name.endswith(".attn_v.weight"):
            return GGMLType.Q5_K if i < 2 else GGMLType.Q4_K
        if name.endswith(".attn_output.weight"):
            return GGMLType.Q4_K
        if name.endswith(".ffn_down.weight"):
            return GGMLType.Q5_K if i < n_layer // 16 else GGMLType.Q4_K
        return GGMLType.Q3_K
    if name.endswith((".attn_v.weight", ".ffn_down.weight")) and _use_more_bits(i, n_layer):
        return GGMLType.Q6_K
    return {Q4_K_M: GGMLType.Q4_K, Q5_K_M: GGMLType.Q5_K}[recipe]


def q4_k_m_type(name: str, n_layer: int) -> GGMLType:
    """The type llama.cpp's Q4_K_M recipe gives a matmul tensor
    (mixed_type)."""
    return mixed_type(Q4_K_M, name, n_layer)


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


# a tiny geometry the tp_blocks mode takes at tp_blocks = 4 (the reference's
# tests/test_parallel.py quant_gguf): every contraction width a multiple of
# 4 · 256 (E 1024, F 2048), so wo and w_down split into 4 K-blocks
TP_TINY_SPEC = dict(n_layer=2, n_embd=1024, n_ff=2048, n_head=8, n_head_kv=4)


def write_tiny_llama(
    path: str,
    quant: GGMLType | str = GGMLType.Q4_K,
    seed: int = 1234,
    chat_template: str = "",
    spec: dict | None = None,
) -> None:
    """Write a deterministic tiny llama-architecture GGUF model. `quant` is
    one GGML type for every matmul tensor, or Q4_K_M, Q5_K_M or Q3_K_M for
    llama.cpp's mixed layouts (mixed_type)."""
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

    def add(name, data):
        g.add_tensor(name, data, mixed_type(quant, name, L) if quant in MIXED else quant)

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
    add("token_embd.weight", w((n_vocab, E), 0.05))
    g.add_tensor("output_norm.weight", np.ones(E, np.float32) + w((E,), 0.01), GGMLType.F32)
    if not s.get("tie_output"):  # tied-embedding models omit output.weight
        add("output.weight", w((n_vocab, E)))
    for i in range(L):
        g.add_tensor(f"blk.{i}.attn_norm.weight", np.ones(E, np.float32) + w((E,), 0.01), GGMLType.F32)
        add(f"blk.{i}.attn_q.weight", w((H * D, E)))
        add(f"blk.{i}.attn_k.weight", w((HKV * D, E)))
        add(f"blk.{i}.attn_v.weight", w((HKV * D, E)))
        add(f"blk.{i}.attn_output.weight", w((E, H * D)))
        g.add_tensor(f"blk.{i}.ffn_norm.weight", np.ones(E, np.float32) + w((E,), 0.01), GGMLType.F32)
        add(f"blk.{i}.ffn_gate.weight", w((F, E)))
        add(f"blk.{i}.ffn_up.weight", w((F, E)))
        add(f"blk.{i}.ffn_down.weight", w((E, F)))
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
    # a llama-architecture file at Phi-3-mini's widths
    # (microsoft/Phi-3-mini-4k-instruct config.json: hidden 3072, 32 heads,
    # 32 KV heads, FFN 8192, vocab 32064, rope theta 10000, 4k context):
    # head dim 96, one query head per KV head
    "phi3-mini": dict(n_layer=32, n_embd=3072, n_head=32, n_head_kv=32,
                      n_ff=8192, n_ctx=4096, n_vocab=32064, rope_freq_base=10000.0),
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


def random_q4k(rng: np.random.Generator, n_rows: int, row_len: int,
               sigma: float) -> np.ndarray:
    """Q4_K superblocks (uint8, flat) with random codes, d, dmin and 6-bit
    sc/mn, so every group has its own scale and min (a scale indexing error
    shows): the kernel checks' and the tools' weights."""
    from .gguf.quants import _pack_scale_min_k4

    nb = n_rows * row_len // 256
    out = np.empty((nb, 144), np.uint8)
    d = (sigma / (48 * 4.61) * rng.uniform(0.5, 1.5, nb)).astype(np.float16)
    dmin = (d.astype(np.float32) * 7.5 * rng.uniform(0.5, 1.5, nb)).astype(np.float16)
    out[:, 0:2] = d.view(np.uint8).reshape(-1, 2)
    out[:, 2:4] = dmin.view(np.uint8).reshape(-1, 2)
    out[:, 4:16] = _pack_scale_min_k4(rng.integers(16, 64, (nb, 8)),
                                      rng.integers(16, 64, (nb, 8)))
    out[:, 16:] = rng.integers(0, 256, (nb, 128), dtype=np.uint8)
    return out.reshape(-1)


def _pack_q8_0_direct(rng: np.random.Generator, n_rows: int, row_len: int,
                      sigma: float) -> bytes:
    """Directly synthesize packed Q8_0 blocks (34 B: f16 d + 32 int8 codes)
    with plausible statistics. The codes are drawn as int8 (a 64-bit draw of
    a full-size tensor takes gigabytes), so the bytes differ from the JAX
    package's packer for the same seed."""
    n_blocks = (n_rows * row_len) // 32
    out = np.zeros((n_blocks, 34), dtype=np.uint8)
    # std of uniform int8 codes in [-127, 127] is ~73.3
    d = np.float16(sigma / 73.3)
    out[:, 0:2] = np.frombuffer(d.tobytes(), dtype=np.uint8)
    out[:, 2:] = rng.integers(-127, 128, size=(n_blocks, 32),
                              dtype=np.int8).view(np.uint8)
    return out.tobytes()


def _pack_q6_k_direct(rng: np.random.Generator, n_rows: int, row_len: int,
                      sigma: float) -> bytes:
    """Directly synthesize packed Q6_K superblocks (210 B: 128 B ql, 64 B qh,
    16 int8 scales, f16 d): random 6-bit codes, random signed scales of
    magnitude 32..96, and d chosen so dequantized values have std ≈ sigma."""
    n_blocks = (n_rows * row_len) // 256
    out = np.empty((n_blocks, 210), dtype=np.uint8)
    out[:, :192] = rng.integers(0, 256, size=(n_blocks, 192), dtype=np.uint8)
    sc = rng.integers(32, 97, size=(n_blocks, 16), dtype=np.int8)
    sc *= rng.integers(0, 2, size=(n_blocks, 16), dtype=np.int8) * 2 - 1
    out[:, 192:208] = sc.view(np.uint8)
    # rms of the scales is ~66.6; std of uniform q - 32 in [-32, 31] is ~18.5
    d = np.float16(sigma / (66.6 * 18.5))
    out[:, 208:210] = np.frombuffer(d.tobytes(), dtype=np.uint8)
    return out.tobytes()


def _pack_q5_k_direct(rng: np.random.Generator, n_rows: int, row_len: int,
                      sigma: float) -> bytes:
    """Directly synthesize packed Q5_K superblocks (176 B: f16 d, f16 dmin,
    12 B of 6-bit scales and mins, 32 B high bits, 128 B low nibbles):
    random 5-bit codes, fixed mid scales, d chosen so dequantized values
    have std ≈ sigma and dmin so they centre on 0."""
    from .gguf.quants import _pack_scale_min_k4

    n_blocks = (n_rows * row_len) // 256
    out = np.empty((n_blocks, 176), dtype=np.uint8)
    # std of uniform q in [0, 31] is ~9.23; effective scale = d*sc with sc=32
    d = np.float16(sigma / (32 * 9.23))
    dmin = np.float16(float(d) * 15.5)             # centres E[q] = 15.5
    out[:, 0:2] = np.frombuffer(d.tobytes(), dtype=np.uint8)
    out[:, 2:4] = np.frombuffer(dmin.tobytes(), dtype=np.uint8)
    sc = np.full((1, 8), 32, np.int64)
    out[:, 4:16] = _pack_scale_min_k4(sc, sc)[0]
    out[:, 16:] = rng.integers(0, 256, size=(n_blocks, 160), dtype=np.uint8)
    return out.tobytes()


def _pack_q3_k_direct(rng: np.random.Generator, n_rows: int, row_len: int,
                      sigma: float) -> bytes:
    """Directly synthesize packed Q3_K superblocks (110 B: 32 B high-bit
    mask, 64 B low 2-bit codes, 12 B of 6-bit scales, f16 d): random 3-bit
    codes in [-4, 3], signed scales of magnitude 8..31, d chosen so
    dequantized values have std ≈ sigma."""
    from .gguf.quants import _q3k_pack_scales

    n_blocks = (n_rows * row_len) // 256
    out = np.empty((n_blocks, 110), dtype=np.uint8)
    out[:, :96] = rng.integers(0, 256, size=(n_blocks, 96), dtype=np.uint8)
    sc = rng.integers(8, 32, size=(n_blocks, 16), dtype=np.int8)
    sc *= rng.integers(0, 2, size=(n_blocks, 16), dtype=np.int8) * 2 - 1
    out[:, 96:108] = _q3k_pack_scales(sc.astype(np.int32) + 32)
    # rms of the scales is ~20.6; std of uniform q in [-4, 3] is ~2.29
    d = np.float16(sigma / (20.6 * 2.29))
    out[:, 108:110] = np.frombuffer(d.tobytes(), dtype=np.uint8)
    return out.tobytes()


_DIRECT_PACKERS = {GGMLType.Q4_K: _pack_q4_k_direct, GGMLType.Q8_0: _pack_q8_0_direct,
                   GGMLType.Q6_K: _pack_q6_k_direct, GGMLType.Q5_K: _pack_q5_k_direct,
                   GGMLType.Q3_K: _pack_q3_k_direct}


def _pack_f32_norm(n: int) -> tuple[bytes, tuple[int, ...]]:
    return np.ones(n, np.float32).tobytes(), (n,)


def _synthetic_header(path: str, preset: str, s: dict,
                      arch: str = "llama") -> GGUFWriter:
    """A GGUFWriter holding the metadata of a synthesized preset `s`: the
    architecture keys of `arch` (the expert counts when `s` has them) and a
    vocabulary of specials, 256 byte tokens and numbered pieces."""
    E, H, V = s["n_embd"], s["n_head"], s["n_vocab"]
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
    g.add_kv("general.architecture", arch)
    g.add_kv("general.name", f"synthetic-{preset}")
    g.add_kv(f"{arch}.block_count", s["n_layer"])
    g.add_kv(f"{arch}.embedding_length", E)
    g.add_kv(f"{arch}.feed_forward_length", s["n_ff"])
    g.add_kv(f"{arch}.attention.head_count", H)
    g.add_kv(f"{arch}.attention.head_count_kv", s["n_head_kv"])
    g.add_kv(f"{arch}.attention.layer_norm_rms_epsilon", 1e-5)
    g.add_kv(f"{arch}.context_length", s["n_ctx"])
    g.add_kv(f"{arch}.rope.freq_base", float(s.get("rope_freq_base", 10000.0)))
    g.add_kv(f"{arch}.rope.dimension_count", E // H)
    if "n_expert" in s:
        g.add_kv(f"{arch}.expert_count", s["n_expert"])
        g.add_kv(f"{arch}.expert_used_count", s["n_expert_used"])
    g.add_kv(f"{arch}.vocab_size", V)
    g.add_kv("tokenizer.ggml.model", "llama")
    g.add_kv("tokenizer.ggml.tokens", tokens)
    g.add_kv("tokenizer.ggml.scores", scores)
    g.add_kv("tokenizer.ggml.token_type", types)
    g.add_kv("tokenizer.ggml.bos_token_id", 1)
    g.add_kv("tokenizer.ggml.eos_token_id", 2)
    g.add_kv("tokenizer.ggml.unknown_token_id", 0)
    g.add_kv("tokenizer.ggml.add_bos_token", True)
    return g


def synthesize_llama_gguf(path: str, preset: str = "tinyllama-1.1b",
                          seed: int = 7, quant: GGMLType | str = GGMLType.Q4_K,
                          n_layer: int | None = None) -> dict:
    """Write a realistic-size llama GGUF with direct-packed quantized tensors.

    Weight *values* are random (throughput benchmarking does not depend on
    them) but every byte layout, metadata key, and tensor name is real, so the
    full load path (parse → dequant/repack → upload) is exercised. `quant`
    is Q4_K, Q5_K, Q3_K, Q8_0, Q6_K or one of llama.cpp's mixed layouts
    (Q4_K_M, Q5_K_M, Q3_K_M: mixed_type); `n_layer` cuts the
    preset's depth (its widths stay).
    """
    if quant not in MIXED and quant not in _DIRECT_PACKERS:
        raise NotImplementedError(
            "direct synthesis packs Q4_K, Q5_K, Q3_K, Q8_0, Q6_K, Q4_K_M, Q5_K_M or Q3_K_M")
    s = dict(MODEL_PRESETS[preset])
    if n_layer is not None:
        s["n_layer"] = n_layer
    E, H, HKV, F, L, V = (s["n_embd"], s["n_head"], s["n_head_kv"],
                          s["n_ff"], s["n_layer"], s["n_vocab"])
    D = E // H
    rng = np.random.default_rng(seed)
    g = _synthetic_header(path, preset, s)

    def q(name, n_out, n_in, sigma=None):
        sigma = sigma if sigma is not None else 1.0 / np.sqrt(n_in)
        t = mixed_type(quant, name, L) if quant in MIXED else quant
        g.add_tensor(name, None, t,
                     raw_bytes=_DIRECT_PACKERS[t](rng, n_out, n_in, sigma),
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


def _cached(name: str, write) -> str:
    """Path `name` in the temp directory, written by write(path) once
    (atomically) and reused by later runs."""
    import os
    import tempfile

    path = os.path.join(tempfile.gettempdir(), name)
    if not os.path.exists(path):
        tmp = f"{path}.{os.getpid()}.tmp"
        write(tmp)
        os.replace(tmp, path)
    return path


def cached_llama_gguf(preset: str = "llama3-8b", seed: int = 7,
                      quant: GGMLType | str = GGMLType.Q4_K,
                      n_layer: int | None = None) -> str:
    """Path of synthesize_llama_gguf(preset, seed, quant, n_layer) in the temp
    directory, written once (atomically) and reused by later runs."""
    tag = "" if quant == GGMLType.Q4_K else f"-{getattr(quant, 'name', quant)}"
    if n_layer is not None:
        tag += f"-L{n_layer}"
    return _cached(f"blama_tpu_torch-{preset}{tag}-seed{seed}.gguf",
                   lambda p: synthesize_llama_gguf(p, preset, seed=seed, quant=quant,
                                                   n_layer=n_layer))


# ---------------------------------------------------------------------------
# Mixtral-family (MoE) fixtures: llama architecture + 3-D expert banks
# ---------------------------------------------------------------------------

MOE_PRESETS = {
    # tiny: the tests' fixture
    "mixtral-debug": dict(n_layer=2, n_embd=256, n_head=4, n_head_kv=2,
                          n_ff=512, n_ctx=512, n_vocab=512,
                          n_expert=4, n_expert_used=2,
                          rope_freq_base=10000.0),
    # Mixtral-8x7B's published widths (mistralai/Mixtral-8x7B-v0.1
    # config.json: hidden 4096, intermediate 14336, 32 layers, 32 / 8 heads,
    # vocab 32000, 8 experts, 2 per token, rope_theta 1e6); a fixture geometry
    # for the card, whose depth `n_layer=` cuts
    "mixtral-8x7b": dict(n_layer=32, n_embd=4096, n_head=32, n_head_kv=8,
                         n_ff=14336, n_ctx=32768, n_vocab=32000,
                         n_expert=8, n_expert_used=2,
                         rope_freq_base=1000000.0),
}


def synthesize_moe_gguf(path: str, preset: str = "mixtral-debug",
                        seed: int = 11, n_layer: int | None = None,
                        arch: str = "llama") -> dict:
    """Write a Mixtral-family GGUF of a preset's geometry with direct-packed
    Q4_K expert banks (random codes, plausible scales: the load path depends on
    the layout, not on the values). The JAX package's synthesizer writes the
    same bytes for the same preset and seed; `n_layer` cuts the depth (the
    layers kept are the uncut file's first ones). `arch` names the file's
    `general.architecture` and its metadata keys' prefix: "llama" (the JAX
    synthesizer's) or "mixtral", which llama.cpp's converter writes for
    Mixtral checkpoints."""
    s = dict(MOE_PRESETS[preset])
    if n_layer is not None:
        s["n_layer"] = n_layer
    E, H, HKV, F, L, V = (s["n_embd"], s["n_head"], s["n_head_kv"],
                          s["n_ff"], s["n_layer"], s["n_vocab"])
    Ne = s["n_expert"]
    D = E // H
    rng = np.random.default_rng(seed)
    g = _synthetic_header(path, preset, s, arch)

    def q(name, ne, sigma=None):
        # ne is the ggml dim order (innermost first); rows = prod(ne[1:])
        n_rows = int(np.prod(ne[1:]))
        sigma = sigma if sigma is not None else 1.0 / np.sqrt(ne[0])
        g.add_tensor(name, None, GGMLType.Q4_K,
                     raw_bytes=_pack_q4_k_direct(rng, n_rows, ne[0], sigma),
                     ne=tuple(ne))

    def norm(name, n):
        data, ne = _pack_f32_norm(n)
        g.add_tensor(name, None, GGMLType.F32, raw_bytes=data, ne=ne)

    q("token_embd.weight", (E, V), 0.02)
    norm("output_norm.weight", E)
    q("output.weight", (E, V))
    for i in range(L):
        norm(f"blk.{i}.attn_norm.weight", E)
        q(f"blk.{i}.attn_q.weight", (E, H * D))
        q(f"blk.{i}.attn_k.weight", (E, HKV * D))
        q(f"blk.{i}.attn_v.weight", (E, HKV * D))
        q(f"blk.{i}.attn_output.weight", (H * D, E))
        norm(f"blk.{i}.ffn_norm.weight", E)
        g.add_tensor(f"blk.{i}.ffn_gate_inp.weight",
                     (rng.standard_normal((Ne, E)) / np.sqrt(E)).astype(np.float32))
        q(f"blk.{i}.ffn_gate_exps.weight", (E, F, Ne))
        q(f"blk.{i}.ffn_up_exps.weight", (E, F, Ne))
        q(f"blk.{i}.ffn_down_exps.weight", (F, E, Ne))
    g.write()
    return s


def cached_moe_gguf(preset: str = "mixtral-8x7b", seed: int = 11,
                    n_layer: int | None = None) -> str:
    """Path of synthesize_moe_gguf(preset, seed, n_layer) in the temp
    directory, written once (atomically) and reused by later runs."""
    tag = "" if n_layer is None else f"-L{n_layer}"
    return _cached(f"blama_tpu_torch-{preset}{tag}-seed{seed}.gguf",
                   lambda p: synthesize_moe_gguf(p, preset, seed=seed, n_layer=n_layer))


def write_tiny_moe(path: str, seed: int = 77, n_expert: int = 4,
                   n_expert_used: int = 2) -> None:
    """Tiny Mixtral-architecture GGUF (llama arch + expert FFN tensors), every
    tensor F32 as in the JAX package's fixture of the same name."""
    E, H, HKV, F, L = 256, 4, 2, 512, 2
    tokens, scores, types = tiny_spm_vocab()
    n_vocab = len(tokens)
    D = E // H
    rng = np.random.default_rng(seed)

    def w(shape, scale=None):
        scale = scale if scale is not None else (1.0 / np.sqrt(shape[-1]))
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    g = GGUFWriter(path)
    g.add_kv("general.architecture", "llama")
    g.add_kv("general.name", "tiny-moe-fixture")
    g.add_kv("llama.block_count", L)
    g.add_kv("llama.embedding_length", E)
    g.add_kv("llama.feed_forward_length", F)
    g.add_kv("llama.attention.head_count", H)
    g.add_kv("llama.attention.head_count_kv", HKV)
    g.add_kv("llama.attention.layer_norm_rms_epsilon", 1e-5)
    g.add_kv("llama.context_length", 512)
    g.add_kv("llama.rope.freq_base", 10000.0)
    g.add_kv("llama.rope.dimension_count", D)
    g.add_kv("llama.expert_count", n_expert)
    g.add_kv("llama.expert_used_count", n_expert_used)
    g.add_kv("llama.vocab_size", n_vocab)
    g.add_kv("tokenizer.ggml.model", "llama")
    g.add_kv("tokenizer.ggml.tokens", tokens)
    g.add_kv("tokenizer.ggml.scores", scores)
    g.add_kv("tokenizer.ggml.token_type", types)
    g.add_kv("tokenizer.ggml.bos_token_id", 1)
    g.add_kv("tokenizer.ggml.eos_token_id", 2)
    g.add_kv("tokenizer.ggml.unknown_token_id", 0)
    g.add_kv("tokenizer.ggml.add_bos_token", True)

    g.add_tensor("token_embd.weight", w((n_vocab, E), 0.05))
    g.add_tensor("output_norm.weight", np.ones(E, np.float32))
    g.add_tensor("output.weight", w((n_vocab, E)))
    for i in range(L):
        g.add_tensor(f"blk.{i}.attn_norm.weight", np.ones(E, np.float32))
        g.add_tensor(f"blk.{i}.attn_q.weight", w((H * D, E)))
        g.add_tensor(f"blk.{i}.attn_k.weight", w((HKV * D, E)))
        g.add_tensor(f"blk.{i}.attn_v.weight", w((HKV * D, E)))
        g.add_tensor(f"blk.{i}.attn_output.weight", w((E, H * D)))
        g.add_tensor(f"blk.{i}.ffn_norm.weight", np.ones(E, np.float32))
        g.add_tensor(f"blk.{i}.ffn_gate_inp.weight", w((n_expert, E)))
        g.add_tensor(f"blk.{i}.ffn_gate_exps.weight", w((n_expert, F, E)))
        g.add_tensor(f"blk.{i}.ffn_up_exps.weight", w((n_expert, F, E)))
        g.add_tensor(f"blk.{i}.ffn_down_exps.weight", w((n_expert, E, F)))
    g.write()


# ---------------------------------------------------------------------------
# graphed against eager launches (ops/step_graph.py)
# ---------------------------------------------------------------------------

def store_bits(cache) -> list:
    """A store's tensors on the host but its spare slot (the target of pad
    writes, which nothing reads: graph warm-ups and captures write there)."""
    out = [cache.k_store[:, :-1], cache.v_store[:, :-1], cache.pos_store[:-1]]
    if cache.quantized:
        out += [cache.k_scale_store[:, :-1], cache.v_scale_store[:, :-1]]
    return [t.cpu() for t in out]


def step_and_loop_outputs(model, kv: str, graphs: bool, prompt: list[int], n: int,
                          ctx: int = 2048) -> tuple[list, dict]:
    """What a solo Instance and the loops give on `model`, through graphs
    or eager launches: the prompt's logits (its bucket's step), a T = 1
    step's and a T = 4 chunk's, continue_greedy's tokens and full logits
    over n steps, teacher_forced's full logits over those tokens (all on
    the Instance's store), greedy_generate's tokens and top-10 over the
    prompt on a fresh store, and both stores' bits, as host tensors; and
    the kernels' launch counts over the run."""
    import torch

    from .ops import generate_loop as gl
    from .ops import kernels
    from .ops import kv_cache as kvc
    from .runtime.instance import Instance, InstanceInitParams

    kernels.reset_launches()
    inst = Instance(model, InstanceInitParams(ctx_size=ctx, kv_dtype=kv, graphs=graphs))
    inst.warmup()
    P = len(prompt)
    logits = [inst.decode(prompt, np.arange(P)), inst.decode([77], np.array([P])),
              inst.decode([78, 79, 80], np.arange(P + 1, P + 4))]
    st = gl.static_of(inst.step_config)
    toks, full, cache = gl.continue_greedy(st, model.weights, inst.cache,
                                           torch.from_numpy(logits[-1][None]),
                                           torch.tensor([P + 4], dtype=torch.int32), n,
                                           graphs=inst.graphs)
    forced, cache = gl.teacher_forced(st, model.weights, cache, toks,
                                      torch.tensor([P + 4 + n], dtype=torch.int32),
                                      graphs=inst.graphs)
    c = model.config
    fresh = kvc.KVCache.create(c.n_layer, 1, ctx, c.n_head_kv, c.head_dim_, kv,
                               device=model.device)
    gen = gl.greedy_generate(st, model.weights, torch.tensor([prompt], dtype=torch.int32),
                             fresh, P, n, graphs=None if graphs else False)
    outs = [torch.from_numpy(a) for a in logits]
    outs += [t.cpu() for t in (toks, full, forced, *gen[:3])]
    return outs + store_bits(cache) + store_bits(gen[3]), dict(kernels.LAUNCHES)


def graphs_equal_eager(model, kv: str, prompt: list[int], n: int, ctx: int = 2048) -> dict:
    """Raise unless step_and_loop_outputs through graphs equals the eager
    run's with torch.equal, output by output, and its launch counts are
    the eager run's. Returns the launch counts."""
    import torch

    eager, e_launches = step_and_loop_outputs(model, kv, False, prompt, n, ctx)
    graphed, g_launches = step_and_loop_outputs(model, kv, True, prompt, n, ctx)
    for i, (a, b) in enumerate(zip(eager, graphed, strict=True)):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"graphed output {i} differs from the eager one")
    if g_launches != e_launches:
        raise AssertionError(f"launches graphed {g_launches} != eager {e_launches}")
    return g_launches


def fma_f32(a, b, c):
    """fmaf on f32 tensors, rounded once as the card rounds it: a*b is exact
    in f64, the f64 sum s rounds to nearest, and its error e (TwoSum) breaks
    the one case where rounding s again to f32 differs from rounding the
    exact a*b + c: s exactly halfway between two floats while e != 0.
    Infinities and NaNs come out as fmaf gives them."""
    import torch

    p, c = a.double() * b.double(), c.double()
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    r = s.float()
    d = s - r.double()
    nb = torch.nextafter(r, torch.where(d > 0, torch.inf, -torch.inf).float())
    tie = torch.isfinite(s) & (d != 0) & ((r.double() + nb.double()) * 0.5 == s) & (e != 0)
    return torch.where(tie & ((e > 0) == (d > 0)), nb, r)


def twodot_lane_order(x, codes, scales, kb: int):
    """Kernel U's positive part in the order of its lane chains, bit for bit:
    lane l of a column takes byte word l of each 256-element tile (elements
    4l..4l+3 of the low half and of the high half, scales 8t + l/8 and
    8t + 4 + l/8), lo = fmaf(x, code * scale, lo) over the low elements, hi
    over the high ones, from 0 at each K-block of kb tiles; at the block's
    end each is summed over the 32 lanes by the xor butterfly (o = 1, 2, 4,
    8, 16), and lo + hi goes into the column's sum in K order, the first
    block assigned. x [M, K] f32, tile-paired codes u8 [N, K/2], scales f32
    [N, K/32] → [M, N] f32, on x's device."""
    import torch

    M, K = x.shape
    N, T = codes.shape[0], K // 256
    c = codes.reshape(N, T, 32, 4)
    lane = torch.arange(32, device=x.device)
    sc = scales.float().reshape(N, T, 8)
    wl = (c & 0x0F).float() * sc[:, :, lane // 8, None]
    wh = (c >> 4).float() * sc[:, :, 4 + lane // 8, None]
    xv = x.float().reshape(M, T, 2, 32, 4)
    run = None
    for b0 in range(0, T, kb):
        lo = torch.zeros((M, N, 32), dtype=torch.float32, device=x.device)
        hi = torch.zeros_like(lo)
        for t in range(b0, b0 + kb):
            for i in range(4):
                lo = fma_f32(xv[:, None, t, 0, :, i], wl[None, :, t, :, i], lo)
                hi = fma_f32(xv[:, None, t, 1, :, i], wh[None, :, t, :, i], hi)
        for o in (1, 2, 4, 8, 16):
            lo = lo + lo[..., lane ^ o]
            hi = hi + hi[..., lane ^ o]
        p = lo[..., 0] + hi[..., 0]
        run = p if run is None else run + p
    return run


def slab_lane_order(xq, xs, codes, scales, kb: int, hb: int, fused: bool = True):
    """Kernels Q and V's positive part in the order of the parent's lanes,
    bit for bit: per output column, per slab of 8·kb groups, lane l takes
    groups l and l + 32 of the slab (where they exist), each term
    (float)dot · ws · xs with dot the exact int32 group dot, t = dot · ws
    rounded once, and the lane's part, from +0, takes the terms in group
    order as fmaf(t, xs, part) (`fused`: each term rounded once into part,
    testing.fma_f32; False: part + t · xs, two roundings). The slab's sum
    is slab_sum<hb>: hb = 4 (Q) an xor butterfly over lane bits 0, 1, 3, 4,
    then lo + hi (lanes with bit 2 clear and set); hb = 0 (V) over all five
    bits. The slabs go into the column's sum in K order, the first one
    assigned. xq int8 [M, K], xs f32 [M, K/32], element-order codes [N, K]
    (int8, or uint8 0..15), bf16 scales [N, K/32] → [M, N] f32, on xq's
    device."""
    import torch

    M, K = xq.shape
    N, G = codes.shape[0], K // 32
    sg = 8 * kb
    if xq.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("slab_lane_order needs TF32 off: its group dots are f32 products")
    # exact in f32: every product and partial sum is an integer below 2^24
    dots = torch.einsum("mgi,ngi->mng", xq.reshape(M, G, 32).float(),
                        codes.reshape(N, G, 32).float())
    t = dots * scales.float()[None]               # one rounding
    x = xs.float()[:, None, :].expand(M, N, G)
    lane = torch.arange(32, device=xq.device)
    run = None
    for s0 in range(0, G, sg):
        part = torch.zeros((M, N, 32), dtype=torch.float32, device=xq.device)
        for j0 in range(s0, s0 + sg, 32):
            n = min(32, s0 + sg - j0)
            tj, xj, pj = t[..., j0:j0 + n], x[..., j0:j0 + n], part[..., :n]
            part[..., :n] = fma_f32(tj, xj, pj) if fused else pj + tj * xj
        for o in (1, 2, 4, 8, 16):
            if o != hb:
                part = part + part[..., lane ^ o]
        acc = part[..., 0] + part[..., hb] if hb else part[..., 0]
        run = acc if run is None else run + acc
    return run


# kernel T's compiled group term, t = dot·ws: fma(t, xs, −(sxm·wm)), fma(−sxm,
# wm, t·xs), or neither (t·xs − sxm·wm, three roundings)
X2_FORMS = ("fma_xs", "fma_min", "unfused")


def x2_lane_order(xq, xs, sxm, codes, ws, wm, kb: int, form: str = "fma_xs"):
    """Kernel T's output in the order of the one-warp-per-column kernel's
    lanes, bit for bit: per output column, K in steps of 8 superblocks;
    in step j of a slab, lane (tl, c) = 4·tl + c takes superblock 8j + tl
    of the slab (where it exists) and from it groups 2c, then 2c + 1 (the
    low and high nibbles of the superblock's 32-byte chunk c); each term is
    (float)dot · ws · xs − sxm · wm in `form` (X2_FORMS; dot the exact int32
    group dot, dot · ws rounded once), and the lane's part, from +0 at each
    slab, adds the terms in that order. A slab (kb superblocks: a multiple
    of 8, or K/256, the whole K) ends in slab_sum<2>: an xor butterfly over
    lane bits 0, 2, 3, 4, then lo + hi (lanes with bit 1 clear and set:
    groups 0-3 and 4-7 of each superblock). The slabs go into the column's
    sum in K order, the first assigned. xq int8 [M, K], xs and sxm f32
    [M, K/32], element-order codes uint8 [N, K], ws = d·sc and wm = dmin·mn
    f32 [N, K/32] (quant_matmul.decode_q4k_blocks) → [M, N] f32, on xq's
    device."""
    import torch

    if form not in X2_FORMS:
        raise ValueError(f"form must be one of {X2_FORMS}, got {form!r}")
    M, K = xq.shape
    N, G, nsb = codes.shape[0], K // 32, K // 256
    if nsb % kb or (kb % 8 and kb != nsb):
        raise ValueError(f"kb={kb}: kernel T's slabs are a multiple of 8 superblocks "
                         f"that divides K/256={nsb}, or the whole K")
    if xq.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("x2_lane_order needs TF32 off: its group dots are f32 products")
    dots = torch.einsum("mgi,ngi->mng", xq.reshape(M, G, 32).float(),
                        codes.reshape(N, G, 32).float())
    t = dots * ws.float()[None]                   # one rounding
    x = xs.float()[:, None, :]
    q = sxm.float()[:, None, :] * wm.float()[None]
    if form == "fma_xs":
        term = fma_f32(t, x.expand_as(t), -q)
    elif form == "fma_min":
        term = fma_f32(-sxm.float()[:, None, :].expand_as(t), wm.float()[None].expand_as(t),
                       t * x)
    else:
        term = t * x - q
    term = term.reshape(M, N, nsb, 4, 2)          # [.., superblock, chunk c, nibble]
    lane = torch.arange(32, device=xq.device)
    run = None
    for s0 in range(0, nsb, kb):
        part = torch.zeros((M, N, 8, 4), dtype=torch.float32, device=xq.device)
        for j0 in range(s0, s0 + kb, 8):          # a step: lanes tl take superblock j0 + tl
            n = min(8, s0 + kb - j0)
            for h in range(2):
                part[:, :, :n] = part[:, :, :n] + term[:, :, j0:j0 + n, :, h]
        part = part.reshape(M, N, 32)
        for o in (1, 4, 8, 16):
            part = part + part[..., lane ^ o]
        acc = part[..., 0] + part[..., 2]
        run = acc if run is None else run + acc
    return run
