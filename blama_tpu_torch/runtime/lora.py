"""LoRA adapter loading and application.

Counterpart of blama_tpu/runtime/lora.py (the reference LoraAdapter,
LoraAdapter.{hpp,cpp}, and the Instance attach path, Instance.cpp:52-61): a
LoRA GGUF (tensors `<base>.lora_a` / `<base>.lora_b`, metadata
`adapter.lora.alpha`), attached to a model's weights with a scale and
removed again. The reference's two modes, chosen here by engine (the port's
weights are a list of per-layer dicts under every engine, so the container
cannot choose):

* the dense engines (runtime.model.DENSE_ENGINES, `float32` / `bfloat16`):
  the scaled delta scale·α/r·(B·A)ᵀ is folded into each target weight in
  f32 and cast back to the weight's dtype, in place on the weight's device
  (no second copy of a matrix, and a captured graph's pointers stay valid).
  Detach subtracts the same delta: back within rounding, not bit for bit
  (ROADMAP.md §3, reference properties);
* the packed engines (ENGINES, MOE_ENGINES): each target weight becomes a
  quant_matmul.LoraWrapped whose runtime term (x_f32·a)·b is added to the
  base product (ops/quant_matmul.py lora_term, through rows_mm). Adapters
  stack along the rank axis in (tag, rank) pieces; detach strips one piece,
  and the base is never touched, so a cleared model gives its bare bits.
  The weights dict and its layer dicts are new objects after every attach
  and detach, as the reference's are, so a graph captured on the old dict
  is never replayed on the new one (ops/step_graph.py).

Fused layouts: an adapter on wq / wk / wv lands on its column segment of
wqkv (BLAMA_FUSE_PROJ), on wk / wv of wkv (BLAMA_FUSE_KV: the reference
skips that layout and drops the adapter, ROADMAP.md §3; the port applies
it), on w_gate / w_up of wgu. Tensors outside the seven llama projections
(phi3's attn_qkv, a MoE file's expert banks) are skipped, as there.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..gguf.reader import GGUFReader
from ..ops.quant_matmul import LoraSegment, LoraWrapped, require_ieee_f32


@dataclass
class LoraTensors:
    a: np.ndarray  # (r, n_in)
    b: np.ndarray  # (n_out, r)


class LoraAdapter:
    def __init__(self, gguf_path: str):
        self.path = gguf_path
        r = GGUFReader(gguf_path)
        try:
            md = r.metadata
            if md.get("adapter.type", "lora") != "lora":
                raise ValueError(f"not a lora adapter: {gguf_path}")
            self.alpha = float(md.get("adapter.lora.alpha", 0.0))
            self.tensors: dict[str, LoraTensors] = {}
            pairs: dict[str, dict[str, np.ndarray]] = {}
            for name in r.tensor_names():
                if name.endswith(".lora_a"):
                    base = name[: -len(".lora_a")]
                    pairs.setdefault(base, {})["a"] = r.tensor_float(name)
                elif name.endswith(".lora_b"):
                    base = name[: -len(".lora_b")]
                    pairs.setdefault(base, {})["b"] = r.tensor_float(name)
            for base, ab in pairs.items():
                if "a" not in ab or "b" not in ab:
                    raise ValueError(f"incomplete lora pair for {base}")
                self.tensors[base] = LoraTensors(ab["a"], ab["b"])
        finally:
            r.close()

    def rank(self) -> int:
        for t in self.tensors.values():
            return t.a.shape[0]
        return 0

    def effective_scale(self, user_scale: float) -> float:
        """llama.cpp: scale = alpha ? user_scale * alpha / r : user_scale."""
        r = self.rank()
        return user_scale * self.alpha / r if self.alpha and r else user_scale


# base tensor name → the layer dict's key
_LAYER_KEYS = {
    "attn_q.weight": "wq",
    "attn_k.weight": "wk",
    "attn_v.weight": "wv",
    "attn_output.weight": "wo",
    "ffn_gate.weight": "w_gate",
    "ffn_up.weight": "w_up",
    "ffn_down.weight": "w_down",
}


def _targets(adapter: LoraAdapter):
    """(layer, key, tensors) of each adapter tensor on a llama projection."""
    for base, t in adapter.tensors.items():
        if not base.startswith("blk."):
            continue
        parts = base.split(".", 2)
        key = _LAYER_KEYS.get(parts[2])
        if key is not None:
            yield int(parts[1]), key, t


def lora_deltas(adapter: LoraAdapter, n_layer: int, user_scale: float) -> dict:
    """Per-tensor deltas (n_in, n_out) f32 on the host, {key: {layer:
    delta}}: the reference's function, for inspection (the fold computes
    the same delta on the weight's device)."""
    scale = adapter.effective_scale(user_scale)
    out: dict[str, dict[int, np.ndarray]] = {}
    for layer, key, t in _targets(adapter):
        delta = (t.b.astype(np.float32) @ t.a.astype(np.float32)).T * scale
        out.setdefault(key, {})[layer] = delta
    return out


def _site(p: dict, key: str, seg: int) -> tuple[str | None, int]:
    """(key, column offset) where an adapter on `key` of width `seg` lands
    in layer dict p: its own weight, its segment of a fused one, or (None,
    0) where the layer has no such projection."""
    if key in p:
        return key, 0
    if key in ("wq", "wk", "wv") and "wqkv" in p:
        total = p["wqkv"].shape[1]
        return "wqkv", {"wq": 0, "wk": total - 2 * seg, "wv": total - seg}[key]
    if key in ("wk", "wv") and "wkv" in p:
        return "wkv", 0 if key == "wk" else p["wkv"].shape[1] // 2
    if key in ("w_gate", "w_up") and "wgu" in p:
        return "wgu", 0 if key == "w_gate" else p["wgu"].shape[1] // 2
    return None, 0


def _wrap(w, off: int, a: torch.Tensor, b: torch.Tensor, tag) -> LoraWrapped:
    """w with the piece (a [K, r], b [r, n]) stacked onto the segment at
    column `off` (a new segment where there is none)."""
    base, segs = (w.base, list(w.segments)) if isinstance(w, LoraWrapped) else (w, [])
    r = a.shape[1]
    for i, s in enumerate(segs):
        if s.off == off:
            if s.b.shape[1] != b.shape[1]:
                raise ValueError(f"lora segment at column {off}: width {b.shape[1]} "
                                 f"against {s.b.shape[1]}")
            segs[i] = LoraSegment(off, torch.cat([s.a, a], dim=1), torch.cat([s.b, b], dim=0),
                                  s.tags + ((tag, r),))
            break
    else:
        segs.append(LoraSegment(off, a, b, ((tag, r),)))
    return LoraWrapped(base, tuple(sorted(segs, key=lambda s: s.off)))


def _unwrap(w, off: int, tag):
    """w without the piece tagged `tag` of the segment at column `off`; the
    bare base when no piece is left (the base was never modified)."""
    if not isinstance(w, LoraWrapped):
        return w
    segs = list(w.segments)
    for i, s in enumerate(segs):
        if s.off != off:
            continue
        at = 0
        for j, (t, r) in enumerate(s.tags):
            if t == tag:
                tags = s.tags[:j] + s.tags[j + 1:]
                if tags:
                    segs[i] = LoraSegment(off, torch.cat([s.a[:, :at], s.a[:, at + r:]], dim=1),
                                          torch.cat([s.b[:at], s.b[at + r:]]), tags)
                else:
                    del segs[i]
                return LoraWrapped(w.base, tuple(segs)) if segs else w.base
            at += r
    return w


def _apply_runtime(weights: dict, adapter: LoraAdapter, user_scale: float,
                   sign: float) -> dict:
    """The packed engines' attach (sign > 0) or detach: new layer dicts with
    the targets wrapped or unwrapped, in a new weights dict."""
    tag = (id(adapter), float(user_scale))
    scale = adapter.effective_scale(user_scale)
    layers = [dict(p) for p in weights["layers"]]
    for layer, key, t in _targets(adapter):
        if layer >= len(layers):
            continue
        p = layers[layer]
        key, off = _site(p, key, t.b.shape[0])
        if key is None:
            continue
        if sign > 0:
            # uploaded as stored, transposed on the device (the f32 product
            # by the scale rounds as the reference's numpy one)
            dev = p[key].device
            a = torch.from_numpy(np.asarray(t.a, np.float32)).to(dev).t().contiguous()
            b = (torch.from_numpy(np.asarray(t.b, np.float32)).to(dev).t() * scale).contiguous()
            p[key] = _wrap(p[key], off, a, b, tag)
        else:
            p[key] = _unwrap(p[key], off, tag)
    return {**weights, "layers": layers}


@torch.no_grad()
def _fold(weights: dict, adapter: LoraAdapter, user_scale: float, sign: float) -> dict:
    """The dense engines' fold (sign +1) or unfold (-1), in place: each
    target weight w (n_in, n_out) becomes dtype(f32(w) + sign·delta), delta
    = ((b·a)ᵀ·scale) computed in f32 on w's device (never TF32), as the
    reference's numpy fold. A layer or key the model lacks raises, as the
    reference's indexing does."""
    scale = adapter.effective_scale(user_scale)
    layers = weights["layers"]
    for layer, key, t in _targets(adapter):
        if layer >= len(layers):
            raise IndexError(f"lora tensor of layer {layer}: the model has {len(layers)}")
        w = layers[layer][key]
        a = torch.from_numpy(t.a.astype(np.float32)).to(w.device)
        b = torch.from_numpy(t.b.astype(np.float32)).to(w.device)
        require_ieee_f32(b)
        delta = (b @ a).t() * scale
        w.copy_((w.float() + sign * delta).to(w.dtype))
    return weights


def apply_lora(weights: dict, adapter: LoraAdapter, user_scale: float, sign: float = 1.0,
               fold: bool = False) -> dict:
    """Attach (sign=+1) or detach (sign=-1) the adapter: folded into the
    dense weights in place (`fold`, the dense engines), or as runtime terms
    in a new weights dict (the packed engines). Returns the weights."""
    if fold:
        return _fold(weights, adapter, user_scale, sign)
    return _apply_runtime(weights, adapter, user_scale, sign)
