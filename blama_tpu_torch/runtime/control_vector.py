"""Control vectors (activation steering).

Counterpart of blama_tpu/runtime/control_vector.py (the reference
ControlVector, ControlVector.{hpp,cpp}): control-vector GGUF files hold
tensors named `direction.<layer>`, F32 1-D (ControlVector.cpp:39-69); their
strength-scaled directions add up per layer across files
(ControlVector.cpp:105-127) and apply to a layer range as a residual-stream
bias after each layer (llama_apply_adapter_cvec, Instance.cpp:73-84;
Instance.apply_control_vector, models/llama.py forward). Host numpy only.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..gguf.reader import GGUFReader


@dataclass
class ControlVectorLoadInfo:
    """Reference: ControlVector::LoadInfo (ControlVector.hpp:19-22)."""

    gguf_path: str
    strength: float = 1.0


class ControlVector:
    """Accumulated per-layer steering directions: data[layer] → [n_embd]."""

    def __init__(self, infos: list[ControlVectorLoadInfo] | ControlVectorLoadInfo):
        if isinstance(infos, ControlVectorLoadInfo):
            infos = [infos]
        self.n_embd = 0
        directions: dict[int, np.ndarray] = {}
        for info in infos:
            r = GGUFReader(info.gguf_path)
            try:
                for name in r.tensor_names():
                    if not name.startswith("direction."):
                        raise ValueError(
                            f"invalid control vector tensor name: {name!r}"
                        )
                    layer = int(name.split(".", 1)[1])
                    if layer <= 0:
                        raise ValueError(
                            f"invalid control vector layer {layer} (must be > 0)"
                        )
                    info_t = r.tensors[name]
                    if len(info_t.ne) != 1:
                        raise ValueError(f"control vector tensor {name!r} must be 1-D")
                    vec = r.tensor_float(name) * info.strength
                    if self.n_embd == 0:
                        self.n_embd = vec.shape[0]
                    elif vec.shape[0] != self.n_embd:
                        raise ValueError("control vector dimension mismatch")
                    if layer in directions:
                        directions[layer] = directions[layer] + vec
                    else:
                        directions[layer] = vec
            finally:
                r.close()
        self.directions = directions

    def as_layer_bias(self, n_layer: int, layer_start: int, layer_end: int) -> np.ndarray:
        """Dense [n_layer, n_embd] bias, zero outside [layer_start, layer_end]
        (1-based layer indices, like llama.cpp cvec application)."""
        out = np.zeros((n_layer, self.n_embd), np.float32)
        for layer, vec in self.directions.items():
            idx = layer - 1  # 1-based on disk
            if 0 <= idx < n_layer and layer_start <= layer <= layer_end:
                out[idx] = vec
        return out


def write_control_vector(path: str, directions: dict[int, np.ndarray]) -> None:
    """Export helper (and test fixture): write a control-vector GGUF."""
    from ..gguf import GGMLType, GGUFWriter

    w = GGUFWriter(path)
    w.add_kv("general.architecture", "controlvector")
    for layer, vec in sorted(directions.items()):
        w.add_tensor(f"direction.{layer}", np.asarray(vec, np.float32), GGMLType.F32)
    w.write()
