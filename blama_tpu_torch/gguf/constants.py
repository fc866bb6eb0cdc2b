"""GGUF/GGML container constants.

Spec-conformant constants for parsing and writing GGUF files, built from the
public GGUF specification (the on-disk format consumed by the reference via
llama.cpp's gguf.h — see reference llama/ControlVector.cpp:24-59
for the reference's direct gguf API usage).
"""

from __future__ import annotations

import enum

GGUF_MAGIC = 0x46554747  # b"GGUF" little-endian
GGUF_VERSION = 3
GGUF_DEFAULT_ALIGNMENT = 32


class GGUFValueType(enum.IntEnum):
    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


class GGMLType(enum.IntEnum):
    """ggml tensor dtypes (subset relevant to LLM GGUF files)."""

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    # 4, 5 removed upstream (Q4_2/Q4_3)
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    IQ2_XXS = 16
    IQ2_XS = 17
    IQ3_XXS = 18
    IQ1_S = 19
    IQ4_NL = 20
    IQ3_S = 21
    IQ2_S = 22
    IQ4_XS = 23
    I8 = 24
    I16 = 25
    I32 = 26
    I64 = 27
    F64 = 28
    IQ1_M = 29
    BF16 = 30


# (block_size_elements, block_size_bytes) for each supported ggml type.
GGML_BLOCK_INFO: dict[GGMLType, tuple[int, int]] = {
    GGMLType.F32: (1, 4),
    GGMLType.F16: (1, 2),
    GGMLType.BF16: (1, 2),
    GGMLType.F64: (1, 8),
    GGMLType.I8: (1, 1),
    GGMLType.I16: (1, 2),
    GGMLType.I32: (1, 4),
    GGMLType.I64: (1, 8),
    GGMLType.Q4_0: (32, 18),    # fp16 d + 16B nibbles
    GGMLType.Q4_1: (32, 20),    # fp16 d + fp16 m + 16B nibbles
    GGMLType.Q5_0: (32, 22),    # fp16 d + u32 qh + 16B nibbles
    GGMLType.Q5_1: (32, 24),    # fp16 d + fp16 m + u32 qh + 16B nibbles
    GGMLType.Q8_0: (32, 34),    # fp16 d + 32 int8
    GGMLType.Q2_K: (256, 84),   # 16B scales + 64B 2-bit + fp16 d + fp16 dmin
    GGMLType.Q3_K: (256, 110),  # 32B hmask + 64B qs + 12B scales + fp16 d
    GGMLType.Q4_K: (256, 144),  # fp16 d + fp16 dmin + 12B scales + 128B nibbles
    GGMLType.Q5_K: (256, 176),  # ... + 32B high bits
    GGMLType.Q6_K: (256, 210),  # 128B ql + 64B qh + 16 int8 scales + fp16 d
    GGMLType.Q8_K: (256, 292),  # f32 d + 256 int8 + 16 int16 bsums
    GGMLType.IQ4_NL: (32, 18),  # fp16 d + 16B nibble indices into kvalues LUT
    GGMLType.IQ4_XS: (256, 136),  # fp16 d + u16 scales_h + 4B scales_l + 128B nibbles
}

QK_K = 256  # K-quant superblock size


def ggml_type_size(t: GGMLType) -> tuple[int, int]:
    """Return (elements_per_block, bytes_per_block) for ggml type `t`."""
    try:
        return GGML_BLOCK_INFO[t]
    except KeyError:
        raise NotImplementedError(f"unsupported ggml type {t!r}") from None


def tensor_nbytes(ne: tuple[int, ...], t: GGMLType) -> int:
    """On-disk byte size of a tensor with ggml dims `ne` (ne[0] contiguous)."""
    block_elems, block_bytes = ggml_type_size(t)
    n_elements = 1
    for d in ne:
        n_elements *= d
    if ne and ne[0] % block_elems != 0:
        raise ValueError(f"row length {ne[0]} not divisible by block size {block_elems} for {t!r}")
    return (n_elements // block_elems) * block_bytes
