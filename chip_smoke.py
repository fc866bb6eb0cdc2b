#!/usr/bin/env python3
"""Chip smoke run of blama_tpu_torch on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the checkout (nvcc, sm_90a), then:

1. device: prints the card's name and power limit (nvidia-smi) and the CUDA
   version, builds the kernels and prints the build time;
2. kernels: holds each kernel against its plain PyTorch version on the card,
   at the Llama-3-8B shapes of the main path, and times it (median of CUDA
   event timings, L2 flushed before every launch) beside its bound, its
   plain version and one PyTorch library call computing the same function;
3. end to end: synthesizes the llama3-8b Q4_K GGUF from a seed (reused from
   the temp directory when present), loads it as `q4k_a8` with fused
   attention and an INT8 cache (ctx 2048), warms up, and answers three
   prove-and-verify requests; every same-backend replay must score exactly
   1.0 and every kernel must have launched during this phase;
4. small reference: the tiny llama fixture proven on the card and replayed
   by the port on the CPU must meet the cross-backend thresholds.

Any failure raises and the script exits non-zero. The last line of standard
output is {"ok": true, "device": {...}}; the line before it lists every
kernel with its launches, error and times. Detailed results also go to
chiprun_out/chip_smoke.json. Imports nothing of JAX or blama_tpu.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor cores
INT8_OPS = 1979e12             # H100 SXM dense int8 tensor cores
# tolerances (reasons in PERF.md and at each check):
MATMUL_TOL = 1e-4   # x max|ref|: f32 sums over groups (A) or K (B) in another order
ATTN_TOL = 2.0 ** -7  # x max|ref|: bf16 outputs, one rounding flip is 2^-8 of an element

# 8B (K, N) of the main path's matmuls
SHAPES = {"wq/wo": (4096, 4096), "wk/wv": (4096, 1024),
          "gate/up": (4096, 14336), "down": (14336, 4096),
          "lm_head": (4096, 128256)}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def random_q4k(rng, n_rows: int, row_len: int, sigma: float) -> bytes:
    """Q4_K superblocks with random codes, d, dmin and 6-bit sc/mn, so every
    group has its own scale and min (a scale indexing error shows)."""
    import numpy as np

    from blama_tpu_torch.gguf.quants import _pack_scale_min_k4

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


class Timer:
    """Median CUDA-event time of single launches, L2 flushed before each."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, reps: int = 15, warm: int = 2) -> float:
        torch = self.torch
        for _ in range(warm):
            fn()
        pairs = []
        for _ in range(reps):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def dequant_bf16(w):
    """[N, K] bf16 weights (code·scale − min) for the library yardstick."""
    from blama_tpu_torch.ops.quant_matmul import GROUP, unpair_codes

    n = w.n_out
    c = unpair_codes(w.codes).reshape(n, -1, GROUP).float()
    return (c * w.scales.float()[..., None] - w.mins.float()[..., None]) \
        .reshape(n, -1).to(w.scales.dtype)


def check_close(name, out, ref, tol):
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    if not err <= tol * scale:
        raise AssertionError(f"{name}: max_abs_err {err} > {tol} x {scale}")
    return err


def kernel_phase(torch, timer, rng):
    """Each kernel against its plain version at the 8B shapes."""
    from blama_tpu_torch.ops import decode_attention as da
    from blama_tpu_torch.ops import quant_matmul as qm

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for label, (K, N) in SHAPES.items():
        w = qm.repack_q4k_a8s(random_q4k(rng, N, K, K ** -0.5), N, K, "cuda")
        wb = dequant_bf16(w)
        ms = (1, 8) if label != "lm_head" else (1,)
        for M in ms:
            # the lm head takes f32 input (bf16-valued), the projections bf16
            x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
            if label == "lm_head":
                x = x.float()
            out, xq, xs, sxm = qm.w4a8_launch(x, w)
            pxq, pxs, psxm = qm.quant_acts(x)
            for a, b, what in ((xq, pxq, "codes"), (xs, pxs, "scales"),
                               (sxm, psxm, "scale*sum")):
                if not torch.equal(a, b):
                    raise AssertionError(f"kernel A {label} M={M}: activation {what} differ")
            ref = qm.w4a8_matmul_plain(x, w)
            err = check_close(f"kernel A {label} M={M}", out, ref, MATMUL_TOL)
            xb = x.to(torch.bfloat16)
            nbytes = K * N // 2 + 4 * (K // 32) * N + x.numel() * x.element_size() + M * N * 4
            t_b, t_o = nbytes / HBM_BYTES_PER_S, 2 * M * K * N / INT8_OPS
            rows.append(dict(
                kernel="w4a8_gemv", shape=f"{label} K={K} N={N} M={M}",
                max_abs_err=err, kernel_ms=timer(lambda: qm.w4a8_launch(x, w)),
                plain_ms=timer(lambda: qm.w4a8_matmul_plain(x, w), reps=3, warm=1),
                library_ms=timer(lambda: torch.matmul(xb, wb.t())),
                bound_ms=1e3 * max(t_b, t_o), bound_by="bytes" if t_b >= t_o else "operations"))
            log(f"kernel A {rows[-1]}")
        if label != "lm_head":
            M = 128
            x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
            out = qm.q4k_pos(x, w)
            ref = qm.q4k_pos_plain(x, w)
            err = check_close(f"kernel B {label} M={M}", out, ref, MATMUL_TOL)
            nbytes = K * N // 2 + 2 * (K // 32) * N + M * K * 2 + M * N * 4
            # the same products fit bf16 tensor cores (4-bit code x bf16 x,
            # f32 accumulate per group), so their rate is the floor
            t_b, t_o = nbytes / HBM_BYTES_PER_S, 2 * M * K * N / BF16_FLOPS
            rows.append(dict(
                kernel="q4k_dequant_matmul", shape=f"{label} K={K} N={N} M={M}",
                max_abs_err=err, kernel_ms=timer(lambda: qm.q4k_pos(x, w)),
                plain_ms=timer(lambda: qm.q4k_pos_plain(x, w), reps=3, warm=1),
                library_ms=timer(lambda: torch.matmul(x, wb.t())),
                bound_ms=1e3 * max(t_b, t_o), bound_by="bytes" if t_b >= t_o else "operations"))
            log(f"kernel B {rows[-1]}")
        del w, wb
        torch.cuda.empty_cache()

    # attention: one 8B layer's INT8 cache at S=2048 with empty slots and
    # slots positioned past the queries
    B, H, Hkv, D, S = 1, 32, 8, 128, 2048
    k = torch.randint(-127, 128, (B, S, Hkv, D), generator=gen, device="cuda", dtype=torch.int8)
    v = torch.randint(-127, 128, (B, S, Hkv, D), generator=gen, device="cuda", dtype=torch.int8)
    ks = torch.rand((B, S, Hkv), generator=gen, device="cuda") * 0.02 + 1e-3
    vs = torch.rand((B, S, Hkv), generator=gen, device="cuda") * 0.02 + 1e-3
    pos = torch.arange(S, dtype=torch.int32, device="cuda")[None].clone()
    pos[0, ::37] = -1
    pos[0, 1900:] = -1
    pos[0, 1200:1260] = 4000
    inv, mscale = da.effective_inv_freq(D, D, 500000.0)
    inv = inv.cuda()
    scale = D ** -0.5

    def sdpa_inputs(q_pos):
        """Dequantized, pre-rotated cache with GQA heads expanded, and the
        boolean visibility mask, for the library yardstick."""
        theta = pos.float()[0][:, None] * inv
        kf = k.float()
        sw = kf.reshape(B, S, Hkv, D // 2, 2).flip(-1).reshape(kf.shape)
        even = torch.arange(D, device="cuda") % 2 == 0
        sin = torch.sin(theta)[None, :, None, :]
        krot = kf * torch.cos(theta)[None, :, None, :] + sw * torch.where(even, -sin, sin)
        kd = (krot * ks[..., None]).to(torch.bfloat16).permute(0, 2, 1, 3)
        vd = (v.float() * vs[..., None]).to(torch.bfloat16).permute(0, 2, 1, 3)
        kd = kd.repeat_interleave(H // Hkv, dim=1).contiguous()
        vd = vd.repeat_interleave(H // Hkv, dim=1).contiguous()
        mask = (pos[:, None, None, :] >= 0) & (pos[:, None, None, :] <= q_pos[:, None, :, None])
        return kd, vd, mask

    sdpa = torch.nn.functional.scaled_dot_product_attention
    q_pos = torch.tensor([1800], dtype=torch.int32, device="cuda")
    q = torch.randn((B, 1, H, D), generator=gen, device="cuda").to(torch.bfloat16)
    out = da.decode_attention(q, k, v, q_pos, pos, inv, ks, vs, mscale=mscale)
    ref = da.flash_attention_plain(q, k, v, q_pos[:, None], pos, inv, ks, vs, scale)
    err = check_close("kernel C", out, ref, ATTN_TOL)
    vis = int(((pos >= 0) & (pos <= 1800)).sum())
    nbytes = vis * Hkv * (2 * D + 8) + S * 4 + 2 * B * H * D * 2 + D * 4
    t_b, t_o = nbytes / HBM_BYTES_PER_S, 4 * H * D * vis / BF16_FLOPS
    kd, vd, mask = sdpa_inputs(q_pos[:, None])
    qh = q.permute(0, 2, 1, 3)
    rows.append(dict(
        kernel="decode_attention", shape=f"H={H} Hkv={Hkv} D={D} S={S} visible={vis}",
        max_abs_err=err,
        kernel_ms=timer(lambda: da.decode_attention(q, k, v, q_pos, pos, inv, ks, vs, mscale=mscale)),
        plain_ms=timer(lambda: da.flash_attention_plain(q, k, v, q_pos[:, None], pos, inv,
                                                       ks, vs, scale), reps=5, warm=1),
        library_ms=timer(lambda: sdpa(qh, kd, vd, attn_mask=mask)),
        bound_ms=1e3 * max(t_b, t_o), bound_by="bytes" if t_b >= t_o else "operations"))
    log(f"kernel C {rows[-1]}")

    T = 128
    qp = torch.arange(1672, 1672 + T, dtype=torch.int32, device="cuda")[None]
    q = torch.randn((B, T, H, D), generator=gen, device="cuda").to(torch.bfloat16)
    out = da.prefill_attention(q, k, v, qp, pos, inv, ks, vs, mscale=mscale)
    ref = da.flash_attention_plain(q, k, v, qp, pos, inv, ks, vs, scale)
    err = check_close("kernel D", out, ref, ATTN_TOL)
    seen = (pos[0][None, :] >= 0) & (pos[0][None, :] <= qp[0][:, None])      # [T, S]
    pairs = int(seen.sum())
    slots = int(seen.any(0).sum())
    nbytes = slots * Hkv * (2 * D + 8) + S * 4 + 2 * B * T * H * D * 2 + T * 4 + D * 4
    t_b, t_o = nbytes / HBM_BYTES_PER_S, 4 * H * D * pairs / BF16_FLOPS
    kd, vd, mask = sdpa_inputs(qp)
    qh = q.permute(0, 2, 1, 3)
    rows.append(dict(
        kernel="prefill_attention", shape=f"T={T} H={H} Hkv={Hkv} D={D} S={S} pairs={pairs}",
        max_abs_err=err,
        kernel_ms=timer(lambda: da.prefill_attention(q, k, v, qp, pos, inv, ks, vs, mscale=mscale)),
        plain_ms=timer(lambda: da.flash_attention_plain(q, k, v, qp, pos, inv, ks, vs, scale),
                       reps=5, warm=1),
        library_ms=timer(lambda: sdpa(qh, kd, vd, attn_mask=mask)),
        bound_ms=1e3 * max(t_b, t_o), bound_by="bytes" if t_b >= t_o else "operations"))
    log(f"kernel D {rows[-1]}")
    return rows


def prove_and_verify(inst, prompt, n):
    """One request: a prover session generates n greedy tokens with top-10
    capture, a fresh session replays them; returns the replay score."""
    import torch

    from blama_tpu_torch.runtime.session import CompleteParams, SessionInitParams
    from blama_tpu_torch.runtime.verify import LogitComparer, MetricsAggregator

    s = inst.start_session(SessionInitParams(seed=7, temperature=0.0))
    t0 = time.perf_counter()
    s.set_initial_prompt(prompt)
    torch.cuda.synchronize()
    ttft = time.perf_counter() - t0
    t1 = time.perf_counter()
    preds = s.complete(CompleteParams(max_tokens=n))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    inst.stop_session()
    if not preds or any(len(p.logits) != 10 for p in preds):
        raise AssertionError("prover returned no tokens or a short top-10")
    for p in preds:
        for td in p.logits:
            if not (td.logit == td.logit and abs(td.logit) < float("inf")):
                raise AssertionError("non-finite logit captured")
    v = inst.start_session(SessionInitParams(seed=7, temperature=0.0))
    v.set_initial_prompt(prompt)
    replayed = v.fill_ctx(preds)
    inst.stop_session()
    agg = MetricsAggregator()
    score = 0.0
    for a, b in zip(preds, replayed, strict=True):
        score = agg.push_and_verify(LogitComparer.compare(a.logits, b.logits))
    return dict(prompt=len(prompt), tokens=len(preds), ttft_s=ttft,
                decode_tok_s=len(preds) / dt, score=score)


def e2e_phase(torch, kind):
    import numpy as np

    from blama_tpu_torch.ops import kernels
    from blama_tpu_torch.runtime.instance import Instance, InstanceInitParams
    from blama_tpu_torch.runtime.model import Model, ModelParams
    from blama_tpu_torch.testing import cached_llama_gguf

    t0 = time.perf_counter()
    path = Path(cached_llama_gguf("llama3-8b", seed=7))
    log(f"e2e: llama3-8b GGUF ready in {time.perf_counter() - t0:.1f} s "
        f"({path.stat().st_size / 2**30:.2f} GiB)")
    t0 = time.perf_counter()
    model = Model(str(path), ModelParams(dtype="q4k_a8", attn="fused"))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    log(f"e2e: load {load_s:.1f} s on {kind}; depth {model.config.n_layer} layers "
        f"(not cut), width {model.config.n_embd}")
    kernels.reset_launches()
    inst = Instance(model, InstanceInitParams(ctx_size=2048, flash_attn=True,
                                              kv_dtype="int8"))
    inst.warmup()
    rng = np.random.default_rng(7)
    vocab = model.config.n_vocab
    requests = [(128, 32), (5, 32), (3, 16)]
    results = []
    for n_prompt, n_gen in requests:
        prompt = [1] + rng.integers(259, vocab, n_prompt - 1).tolist()
        r = prove_and_verify(inst, prompt, n_gen)
        log(f"e2e request {r} on {kind}")
        if r["score"] != 1.0:
            raise AssertionError(f"same-backend replay scored {r['score']}, not 1.0")
        results.append(r)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    log(f"e2e launches {launches}")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    model.close()
    del inst, model
    torch.cuda.empty_cache()
    return dict(load_s=load_s, requests=results), launches


def small_reference_phase(torch):
    """Tiny fixture: prove on the card, replay with the port on the CPU."""
    from blama_tpu_torch.runtime.instance import Instance, InstanceInitParams
    from blama_tpu_torch.runtime.model import Model, ModelParams
    from blama_tpu_torch.runtime.session import CompleteParams, SessionInitParams
    from blama_tpu_torch.runtime.verify import LogitComparer, MetricsAggregator
    from blama_tpu_torch.testing import write_tiny_llama

    path = str(Path(tempfile.gettempdir()) / "blama_tpu_torch-tiny.gguf")
    write_tiny_llama(path)
    out = {}
    for dev in ("cuda", "cpu"):
        m = Model(path, ModelParams(dtype="q4k_a8", attn="fused", device=dev))
        inst = Instance(m, InstanceInitParams(ctx_size=64, flash_attn=True, kv_dtype="int8"))
        s = inst.start_session(SessionInitParams(seed=11, temperature=0.0))
        s.set_initial_prompt(m.vocab.tokenize("hello world the cat sat", True, True))
        if dev == "cuda":
            out["preds"] = s.complete(CompleteParams(max_tokens=12))
        else:
            out["replayed"] = s.fill_ctx(out["preds"])
        m.close()
    agg = MetricsAggregator()
    sims = []
    for a, b in zip(out["preds"], out["replayed"], strict=True):
        score = agg.push_and_verify(LogitComparer.compare(a.logits, b.logits))
        sims.append(LogitComparer.logit_similarity(a.logits, b.logits))
    res = dict(tokens=len(sims), score=score, mean_similarity=sum(sims) / len(sims))
    log(f"small reference (card prover -> CPU verifier): {res}")
    if not (res["score"] >= 0.95 and res["mean_similarity"] >= 0.98):
        raise AssertionError(f"cross-backend replay below thresholds: {res}")
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from blama_tpu_torch.ops import kernels

    t_start = time.perf_counter()
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}")
    build_s = kernels.build_all()
    for name in kernels.SIGNATURES:
        kernels.lib(name)
    log(f"kernels built in {build_s:.1f} s")
    for f in sorted(kernels.BUILD_DIR.glob("*.nvcc.log")):
        log(f"--- {f.name}\n{f.read_text().strip()}")

    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        timer = Timer(torch)
        rows = kernel_phase(torch, timer, np.random.default_rng(0))
        del timer
        torch.cuda.empty_cache()
        e2e, launches = e2e_phase(torch, kind)
        small = small_reference_phase(torch)

    replaces = {
        "w4a8_gemv": "blama_tpu/ops/pallas/quant_matmul.py:1629",
        "q4k_dequant_matmul": "blama_tpu/ops/pallas/quant_matmul.py:221",
        "decode_attention": "blama_tpu/ops/pallas/decode_attention.py:106",
        "prefill_attention": "blama_tpu/ops/pallas/decode_attention.py:976",
    }
    source = {"w4a8_gemv": "blama_tpu_torch/ops/csrc/quant_matmul.cu",
              "q4k_dequant_matmul": "blama_tpu_torch/ops/csrc/quant_matmul.cu",
              "decode_attention": "blama_tpu_torch/ops/csrc/decode_attention.cu",
              "prefill_attention": "blama_tpu_torch/ops/csrc/decode_attention.cu"}
    # the line's entry per kernel: its main-path representative shape
    rep = {"w4a8_gemv": "gate/up K=4096 N=14336 M=1",
           "q4k_dequant_matmul": "gate/up K=4096 N=14336 M=128"}
    kernels_line = []
    for name in replaces:
        cands = [r for r in rows if r["kernel"] == name]
        r = next((c for c in cands if c["shape"] == rep.get(name)), cands[0])
        kernels_line.append(dict(
            name=name, route="cuda", source=source[name], replaces=replaces[name],
            launches=launches[name], max_abs_err=r["max_abs_err"], ms=r["kernel_ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], shape=r["shape"]))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(dict(
        nvidia_smi=smi, device=kind, torch=torch.__version__, cuda=torch.version.cuda,
        build_s=build_s, kernel_rows=rows, e2e=e2e, launches=launches,
        small_reference=small, seconds=time.perf_counter() - t_start), indent=1))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
