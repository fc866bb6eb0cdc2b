"""GGUF container writer.

Used for building test fixtures (tiny models with real K-quant tensors), for
exporting control vectors / LoRA adapters, and for round-trip testing the
reader. Produces GGUF v3 files that llama.cpp-based tooling can read.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

from .constants import (
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGUF_VERSION,
    GGMLType,
    GGUFValueType,
    tensor_nbytes,
)
from . import quants

_SCALAR_PACK = {
    GGUFValueType.UINT8: "<B",
    GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H",
    GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I",
    GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f",
    GGUFValueType.UINT64: "<Q",
    GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}


def _infer_type(v: Any) -> GGUFValueType:
    if isinstance(v, bool):
        return GGUFValueType.BOOL
    if isinstance(v, int):
        return GGUFValueType.INT64 if (v < 0 or v >= 1 << 32) else GGUFValueType.UINT32
    if isinstance(v, float):
        return GGUFValueType.FLOAT32
    if isinstance(v, str):
        return GGUFValueType.STRING
    if isinstance(v, (list, tuple, np.ndarray)):
        return GGUFValueType.ARRAY
    raise TypeError(f"cannot infer GGUF type for {type(v)}")


class GGUFWriter:
    def __init__(self, path: str, alignment: int = GGUF_DEFAULT_ALIGNMENT):
        self.path = path
        self.alignment = alignment
        self._kv: list[tuple[str, Any, GGUFValueType | None]] = []
        self._tensors: list[tuple[str, tuple[int, ...], GGMLType, bytes]] = []

    def add_kv(self, key: str, value: Any, vtype: GGUFValueType | None = None) -> None:
        self._kv.append((key, value, vtype))

    def add_tensor(
        self,
        name: str,
        array: np.ndarray,
        ggml_type: GGMLType | None = None,
        raw_bytes: bytes | None = None,
        ne: tuple[int, ...] | None = None,
    ) -> None:
        """Add a tensor.

        `array` is in numpy (row-major) convention; its *last* axis becomes
        ggml ne[0] (the quantized/contiguous row). Pass `raw_bytes` + `ne` to
        write pre-packed data directly.
        """
        if raw_bytes is not None:
            assert ne is not None
            self._tensors.append((name, tuple(ne), ggml_type or GGMLType.F32, raw_bytes))
            return
        array = np.asarray(array)
        if ggml_type is None:
            ggml_type = GGMLType.F32
        ne = tuple(reversed(array.shape)) if array.ndim else (1,)
        flat = array.reshape(-1, array.shape[-1]) if array.ndim > 1 else array.reshape(1, -1)
        data = quants.quantize(flat, ggml_type).tobytes()
        expect = tensor_nbytes(ne, ggml_type)
        assert len(data) == expect, (name, len(data), expect)
        self._tensors.append((name, ne, ggml_type, data))

    # -- serialization ------------------------------------------------------

    def _pack_string(self, s: str) -> bytes:
        b = s.encode("utf-8")
        return struct.pack("<Q", len(b)) + b

    def _pack_value(self, v: Any, vtype: GGUFValueType, etype: GGUFValueType | None = None) -> bytes:
        if vtype == GGUFValueType.STRING:
            return self._pack_string(v)
        if vtype == GGUFValueType.BOOL:
            return struct.pack("<B", 1 if v else 0)
        if vtype == GGUFValueType.ARRAY:
            items = list(v)
            if etype is None:
                etype = _infer_type(items[0]) if items else GGUFValueType.UINT32
            head = struct.pack("<I", int(etype)) + struct.pack("<Q", len(items))
            # one join: a vocabulary holds 10^5 items, and `+=` on bytes is
            # quadratic in them
            return head + b"".join(self._pack_value(item, etype) for item in items)
        return struct.pack(_SCALAR_PACK[vtype], v)

    def write(self) -> None:
        align = self.alignment
        header = struct.pack("<IIQQ", GGUF_MAGIC, GGUF_VERSION, len(self._tensors), len(self._kv))
        kv_blob = b""
        for key, value, vtype in self._kv:
            if vtype is None:
                vtype = _infer_type(value)
            etype = None
            if vtype == GGUFValueType.ARRAY and len(value):
                etype = _infer_type(value[0])
            kv_blob += self._pack_string(key) + struct.pack("<I", int(vtype))
            kv_blob += self._pack_value(value, vtype, etype)

        info_blob = b""
        offset = 0
        offsets = []
        for name, ne, t, data in self._tensors:
            offsets.append(offset)
            info_blob += self._pack_string(name)
            info_blob += struct.pack("<I", len(ne))
            for d in ne:
                info_blob += struct.pack("<Q", d)
            info_blob += struct.pack("<I", int(t))
            info_blob += struct.pack("<Q", offset)
            offset += len(data)
            offset += -offset % align

        head_len = len(header) + len(kv_blob) + len(info_blob)
        pad0 = -head_len % align

        with open(self.path, "wb") as f:
            f.write(header)
            f.write(kv_blob)
            f.write(info_blob)
            f.write(b"\x00" * pad0)
            pos = 0
            for (name, ne, t, data), off in zip(self._tensors, offsets):
                assert pos == off, (name, pos, off)
                f.write(data)
                pos += len(data)
                pad = -pos % align
                f.write(b"\x00" * pad)
                pos += pad
