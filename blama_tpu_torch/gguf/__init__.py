"""GGUF container + the GGML block formats the port reads (host side):
reader, writer, and numpy reference (de)quantizers for F32/F16/Q4_K."""

from .constants import GGMLType, GGUFValueType, QK_K, ggml_type_size, tensor_nbytes
from .reader import GGUFReader, TensorInfo
from .writer import GGUFWriter
from . import quants

__all__ = [
    "GGMLType",
    "GGUFValueType",
    "QK_K",
    "GGUFReader",
    "GGUFWriter",
    "TensorInfo",
    "ggml_type_size",
    "tensor_nbytes",
    "quants",
]
