#!/usr/bin/env python3
"""Chip smoke run of blama_tpu_torch on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the checkout (nvcc, sm_90a), then:

1. device: prints the card's name and power limit (nvidia-smi) and the CUDA
   version, builds the kernels and prints the build time;
2. kernels, attention: holds each kernel against its plain PyTorch version on
   the card, at the Llama-3-8B shapes the main paths give it (kernel A at 1
   and 8 rows, the lm head included; kernel B at 64, 128 and 2048 flattened
   rows; attention at T = 1, 8, 128 and 256 on one row and on 8), and times
   it (median of CUDA event timings, L2 flushed before every launch; the
   decode kernels C, E, N, O and P, whose single launch is short enough for
   host gaps to dominate it, in a CUDA graph, GraphTimer, with the event
   figure beside) beside its bound, its plain version and one PyTorch
   library call computing the same function. The attention kernels run on
   INT8, bf16 and f32 stores; the paged kernels E and F must equal the dense
   C and D bit for bit over the same logical rows under scrambled page
   placement; D's solo INT8 chunk of 128 must equal the same queries in 16
   chunks of 8, and every serving chunk's row 3 run alone its row of the
   8-row batch; a decode row (C and E) run alone, and alone with S padded
   from 2048 to 4096, must equal its row of the 8-row step; C at one row
   and the preset's full context, S = 8192; C-F at head dims 80, 96 and 100
   and at 64 and 33 query heads over one KV head (the geometry phase); D
   also at T = 512 (one row), and under each fixed split width of the
   prefill sweep, C under each of the decode sweep. Kernel B also at 8 and
   16 rows, every row of its 8- to 128-row outputs equal bit for bit to the
   one-row kernel's, and every tile shape of the plan forced at 8 to 2048
   rows (the tile sweep: the evidence for tile_plan, each shape's bits equal
   to the plan's), and the one-row calls of B, G, H and L at the five 8B
   shapes (L's partials on wo and down too) and of K over two Mixtral
   experts under every one-row shape (the row sweep: the evidence for
   row_plan, each shape's bits equal to the plan's). The one-row calls of
   B, G, H, K and L are graph-timed (GraphTimer), their kernel and library
   times alike, the single launch's event figure beside them. The exact
   tiles (B, G, H, K, L) also carry library_f32_ms
   (one f32 torch.matmul over the f32 weights, TF32 off) and bound_f32_ms
   (the floor of a design that keeps their f32 chain: bytes, f32 operations
   or the chain's latency). The other engines'
   kernels at the same shapes: B on f32 scales, G (int8 codes, scale group
   32 and 16) and H (native Q4_K) at 1, 8 and 128 rows, I (W4A8 on native
   Q4_K) at 1 and 8 rows, every row of 8 and 128 equal to the one-row
   kernel's; the MoE expert-bank kernels at Mixtral-8x7B's bank shapes (8
   experts of gate/up 4096 -> 14336 and down 14336 -> 4096): J at 1 and 8
   rows over 2 selected experts and at 4 and 8 rows over all 8, each expert
   equal bit for bit to kernel A on it alone; K on f32 scales at 1 row over 2
   experts and at 4, 8 and 128 rows over 8, on bf16 scales at 128 rows over
   8, every row of 4, 8 and 128 equal to the one-row kernel's; and the MoE path's
   other shapes: A and B on f32 scales at the projections' 4 rows, A at 1
   and 4 rows and B on f32 scales at 1 row of Mixtral's lm head (N=32000);
   and the tp_blocks kernels at TP_BLOCKS = 8: L's per-K-block partials for
   wo and down at 1, 8 and 128 rows (f32 scales; bf16 at 128), L at one
   block for wq, wk, gate and the lm head, M for wo and down at 1 and 8
   rows, each partial against its plain version, and bit for bit the
   partials of tp = 2, 4, 8 K-slices computed alone equal to the
   one-dispatch partials, each column shard of a pinned product equal to
   its columns, every row equal to the row alone; and the tools'
   kernels: Q (w4a8_swar_matmul's positive part) and T (X2) at the 8B
   projections and lm head, 1 and 8 rows, two kb each, activation codes
   bit for bit and bits equal across block_n; R on a 2048 x 14336 layer at
   a block of the reference's and one of the card's size, exact, every byte
   staged; S exact; ubench_q4k's U (f32 two-dot) and V (int8 and
   tile-paired codes, the loaders bit-equal) at the 8B projections and lm
   head, 1 and 8 rows, two kb each, bits equal across block_n, U beside
   the f32 torch.matmul that computes its function; the probes W and X at
   [256, 512] and an 8B code plane (2048 x 14336), Y at its twelve shapes,
   all exact; and rows_mm's host cost at the decode step's shapes;
3. solo: synthesizes the llama3-8b Q4_K GGUF from a seed (reused from the
   temp directory when present), loads it as `q4k_a8` with fused attention,
   and on an INT8 cache (ctx 2048) one solo Session answers three
   prove-and-verify requests; every same-backend replay must score exactly
   1.0 (kernels A, B, C, D). Then the modes phase on the same model: the
   decode-attention modes, write (kernel P; INT8 and f32 stores), fresh (N;
   INT8) and head-batched (O; bf16 and f32), three shorter requests each,
   every replay 1.0, the mode's kernel launched and C on no step; write and
   fresh give the mode-off tokens and top-10 bit for bit, head-batched
   replays the mode-off records at 0.95 / 0.98; the solo HTTP server on its
   default f32 store verifies at 1.0; the dense scheduler in write mode gives
   the mode-off tokens. Its kernels are held in the kernel phase at H32 /
   Hkv8 / D128, S = 2048, 1 and 8 rows: N and P bit for bit equal to C after
   the cache write on every store type (P's store equal to the write's, a
   pad row's write in the spare slot), O within tolerance of its plain
   version;
4. serving: the port's HttpServer in-process on 127.0.0.1 over the
   continuous-batching scheduler (8 rows, paged bf16 pool, horizon 8,
   ctx 2048) answers 12 concurrent /complete and /chat/completions requests,
   ten greedy and two sampled; every greedy response must verify to exactly
   1.0 over /verify_completion and /chat/verify_completion (kernels A, B, E,
   F). On a pool of 3 pages the server must preempt, resume and finish every
   request, each with the uncontended run's tokens up to its preemption;
   the same pool driven synchronously (one fixed admission order) must give
   those tokens, after each resume the tokens and top-10 logits of its
   re-prefill served alone, and, driven twice, the same tokens and logits
   bit for bit (where a resumed row first leaves the uncontended tokens, the
   margin and the drift there are logged); dense rows (kernels C and D on bf16)
   must give the paged run's tokens;
   then the head-dim-96 phase: a llama-architecture file at Phi-3-mini's
   widths (head dim 96, 32 / 32 heads; testing.MODEL_PRESETS["phi3-mini"])
   cut to HD96_LAYERS layers, `q4k_a8`, two solo requests on an INT8 cache
   replayed at exactly 1.0 (C, D) and four behind the HTTP server on the
   paged scheduler verified at 1.0 (E, F);
5. engines: at full 8B width, `q4k_fused` (kernel B on f32 scales),
   `q4k_fused_k4` (H) and `q4k_a8_k4` (I, H) load the same Q4_K file at full
   depth, `q8_0_fused` (G) a synthesized Q8_0 file and `q4k_a8` a mixed Q4_K
   + Q6_K file in llama.cpp's Q4_K_M pattern (A, B, G), the last two cut to
   ENGINE_FILE_LAYERS layers; one model on the card at a time, the solo
   phase's three request shapes each, every same-backend replay exactly 1.0,
   and each engine must have launched its own kernels and no other matmul
   kernel;
6. moe: the `mixtral-8x7b` preset (Mixtral-8x7B's widths, 8 experts, 2 per
   token) synthesized from a seed and cut to MOE_FILE_LAYERS layers, loaded
   as `q4k_a8` and then `q4k_fused` with the two-pass attention chain, INT8
   KV, ctx 2048: the solo phase's three request shapes each, every replay
   exactly 1.0, kernels J / K (and A, B for the projections) launched and no
   attention kernel; a token's logits decoded routed at one row equal to its
   row in a padded 4- and 8-row chunk bit for bit, on INT8 and bf16 stores,
   empty and after a prefix; `q4k_fused` replays `q4k_a8`'s records (printed); the
   `q4k_a8` model behind the HTTP server on the paged pool answers four
   concurrent requests, each verified at exactly 1.0;
7. tp_blocks: the fixed-topology mode a solo verifier of a prover sharded
   over 8 cards runs (tp_blocks=8): the llama3-8b file at full depth as
   `q4k_fused` (kernel L) and `q4k_a8` (A, M, L), the engines phase's three
   requests each, every same-backend replay exactly 1.0, only the mode's
   matmul kernels launched; each engine's verifier in this mode replays its
   tp_blocks=0 records at the cross-engine thresholds (0.95 / 0.98);
   `q4k_a8` behind the HTTP server on the paged scheduler, every verify
   1.0; the Mixtral file as `q4k_fused` (L, K), one request, replay 1.0;
8. small: the tiny llama fixture proven on the card and replayed by the port
   on the CPU must meet the cross-backend thresholds, and so must, on the
   card, `q4k_a8` replayed by `q4k_fused` and `q4k_a8_xla` by `q4k_a8`;
9. tools: each tool of blama_tpu_torch/tools/ (probe_bw, probe_overhead,
   probe_ceiling, autotune_a8s, ab_a8k4, bench_serving, profile_load,
   trace_step, ubench_q4k, probe_swar, probe_mosaic, probe_casts,
   ubench_attn, ubench_paged) through its main once, at short settings on
   the 8B shapes and file (the probes at an 8B code plane); kernels Q to Y
   must have launched, ab_a8k4's "x2 vs a8k4" within the matmul tolerance,
   ubench_q4k's v1 within it of v0 and every variant within 2e-2, no probe
   a FAIL (a probe tool exits non-zero on one), probe_overhead's kernel S
   captured;
10. dense: the reference's defaults (dense_phase): the `bfloat16` engine on
   the llama3-8b Q4_K file at full depth (every tensor dequantized on the
   card at load), the solo phase's three request shapes under attn="fused"
   (bf16 C, D) and attn="xla" (the two-pass chain, no attention kernel),
   every replay exactly 1.0, then `python -m blama_tpu_torch.server.http`
   with BLAMA_DTYPE unset (bfloat16) on the paged scheduler, four requests
   verified at 1.0; the `float32` engine at full width cut to
   ENGINE_FILE_LAYERS layers on f32 KV, the same requests in both modes
   (C and D at f32 queries) and four requests through the paged scheduler
   (E and F at f32 queries), verified at 1.0; Q5_K_M- and Q3_K_M-pattern
   files at ENGINE_FILE_LAYERS layers, each GGML type's values dequantized
   on the card equal to the numpy function's, loaded as `bfloat16` and
   replayed at 1.0. The kernel phase holds C, D, E and F at f32 queries
   against their plain versions at the bf16 rows' shapes on every store
   (f32_query_attention_phase), and prices the dense engines' row-invariant
   16-row-block product on 128- and 512-token prompts (dense_prompt_cost).

Launch counts are set to 0 just before each path and read just after. Any
failure raises and the script exits non-zero. The W4A8 GEMV (A, I, J, M) is
graph-timed as the decode kernels are, each row of 1-16 held equal to the
row alone. `python3 chip_smoke.py --decode-timing DIR` runs only
decode_timing, on the kernels of the tree at DIR (C, E, N, P and D timed at
the 8B shapes, for a before / after in one call); `--matmul-timing DIR`
runs only matmul_timing (A, I, J, M, and the one-row calls of B, G, H, K
and L, graph-timed beside the f32 and bf16 library calls, their outputs
compared with another tree's); `--tools-timing DIR` runs only the tools'
kernel phases (Q to Y, graph-timed, U beside its f32 library call, their
outputs compared with another tree's). The last line of standard
output is {"ok": true, "device": {...}}; the line before it lists every
kernel with its launches, error and times. Detailed results also go to
chiprun_out/chip_smoke.json. Imports nothing of JAX or blama_tpu.
"""

from __future__ import annotations

import contextlib
import gc
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
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
SM_CLOCK_HZ = 1.98e9           # H100 SXM boost clock
FMA_CYCLES = 4                 # latency of a dependent f32 FMA
# tolerances (reasons in PERF.md and at each check):
MATMUL_TOL = 1e-4   # x max|ref|: f32 sums over groups (A) or K (B) in another order
ATTN_TOL = 2.0 ** -7  # x max|ref|: bf16 outputs, one rounding flip is 2^-8 of an element
# x max|ref|: the f32-query instances (f32 q and output, D and F's products on
# both halves of q): far below ATTN_TOL, which a bf16-grade answer would meet
F32Q_TOL = 1e-4

# 8B (K, N) of the main path's matmuls
SHAPES = {"wq/wo": (4096, 4096), "wk/wv": (4096, 1024),
          "gate/up": (4096, 14336), "down": (14336, 4096),
          "lm_head": (4096, 128256)}
# depth of the synthesized Q8_0 and mixed files of the engines phase (the
# all-Q4_K file has the full 32 layers); widths are not cut
ENGINE_FILE_LAYERS = 8
# Mixtral-8x7B's expert banks (K, N) per projection, 8 experts, 2 per token;
# the MoE file is cut from 32 to MOE_FILE_LAYERS layers (a 32-layer Q4_K file
# is ~26 GB, held whole in host memory by the writer); widths are not cut
MOE_SHAPES = {"gate/up": (4096, 14336), "down": (14336, 4096)}
MOE_EXPERTS = 8
MOE_FILE_LAYERS = 8
# the MoE path's attention projections and lm head (K, N) at Mixtral's widths
MOE_DENSE_SHAPES = {"wq/wo": (4096, 4096), "wk/wv": (4096, 1024), "lm_head": (4096, 32000)}
# tp_blocks of the fixed-topology phase: the reference's value on any mesh
TP_BLOCKS = 8
# kernel Y's probes (ops/probes.CASTS): the line of tools/probe_casts.py that
# holds each probe's TPU kernel, and the probe's shapes
CAST_LINES = {
    "reshape_8x128": (21, "(1, 1024) -> (8, 128)"), "reshape_1x1024": (25, "(8, 128) -> (1, 1024)"),
    "reshape_32x1": (29, "(8, 4) -> (32, 1)"), "lane_slice": (32, "(1, 1024) -> (1, 128)"),
    "lane_concat": (35, "(1, 1024) -> (1, 512)"), "sublane_stride": (38, "(8, 128) -> (4, 128)"),
    "group_max": (41, "(8, 128) -> (8, 4)"), "reshape_4d": (47, "(1, 1024) -> (1, 4, 2, 128)"),
    "reshape_3d": (51, "(16, 512) -> (16, 1, 512)"), "round_int8": (54, "(8, 128) -> (8, 128)"),
    "row_select_dot": (58, "(8, 4) -> (4, 4)"), "scratch_store": (63, "(1, 1024) -> (1, 128)")}
CAST_NAMES = tuple(CAST_LINES)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def random_q4k(rng, n_rows: int, row_len: int, sigma: float):
    """Q4_K superblocks with random codes, d, dmin and 6-bit sc/mn
    (testing.random_q4k)."""
    from blama_tpu_torch.testing import random_q4k as make

    return make(rng, n_rows, row_len, sigma)


def random_q8_0(rng, n_rows: int, row_len: int, sigma: float):
    """Q8_0 blocks with random int8 codes and a random f16 d per block."""
    import numpy as np

    nb = n_rows * row_len // 32
    out = np.empty((nb, 34), np.uint8)
    d = (sigma / 73.3 * rng.uniform(0.5, 1.5, nb)).astype(np.float16)
    out[:, 0:2] = d.view(np.uint8).reshape(-1, 2)
    out[:, 2:] = rng.integers(-127, 128, (nb, 32), dtype=np.int8).view(np.uint8)
    return out.reshape(-1)


def random_q6_k(rng, n_rows: int, row_len: int, sigma: float):
    """Q6_K superblocks with random 6-bit codes, random signed int8 scales
    (a sign or sub-block indexing error shows) and a random f16 d."""
    import numpy as np

    nb = n_rows * row_len // 256
    out = np.empty((nb, 210), np.uint8)
    out[:, :192] = rng.integers(0, 256, (nb, 192), dtype=np.uint8)
    sc = rng.integers(16, 128, (nb, 16), dtype=np.int8)
    sc *= rng.integers(0, 2, (nb, 16), dtype=np.int8) * 2 - 1
    out[:, 192:208] = sc.view(np.uint8)
    d = (sigma / (78.0 * 18.5) * rng.uniform(0.5, 1.5, nb)).astype(np.float16)
    out[:, 208:210] = d.view(np.uint8).reshape(-1, 2)
    return out.reshape(-1)


# rows of the prompts dense_prompt_cost prices
DENSE_PROMPTS = (128, 512)


def dense_prompt_cost(torch, timer):
    """What the dense engines' row-invariant product (quant_matmul.rows_mm:
    whole zero-padded 16-row blocks, one [16, K] @ [K, N] bf16 product each,
    f32 sums) costs a prompt at 8B against one product of all its rows: the
    device ms of the seven projections of a layer at 128 and 512 rows,
    times 32 layers. Also holds a row's bits equal at 1, 4, 8, 16 and 128
    rows at each shape, and the f32 operands' product within f32 rounding
    of an f64 one (no TF32)."""
    from blama_tpu_torch.ops import quant_matmul as qm

    gen = torch.Generator(device="cuda").manual_seed(21)
    per_layer = {"wq": SHAPES["wq/wo"], "wk": SHAPES["wk/wv"], "wv": SHAPES["wk/wv"],
                 "wo": SHAPES["wq/wo"], "gate": SHAPES["gate/up"], "up": SHAPES["gate/up"],
                 "down": SHAPES["down"]}
    out = {}
    for M in DENSE_PROMPTS:
        blocks = one = 0.0
        for name, (K, N) in per_layer.items():
            w = (torch.randn((K, N), generator=gen, device="cuda") / K ** 0.5).to(torch.bfloat16)
            x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
            blocks += timer(lambda: qm.rows_mm(x, w), reps=5)
            one += timer(lambda: torch.mm(x, w, out_dtype=torch.float32).to(torch.bfloat16),
                         reps=5)
            if M == DENSE_PROMPTS[0]:
                full = qm.rows_mm(x, w)
                for m in (1, 4, 8, 16):
                    if not torch.equal(qm.rows_mm(x[:m], w), full[:m]):
                        raise AssertionError(f"rows_mm {name}: {m} rows differ from the "
                                             "same rows of 128")
        out[f"prompt_{M}"] = dict(blocks_ms=32 * blocks, one_product_ms=32 * one,
                                  ratio=blocks / one)
    a = torch.randn((16, 14336), generator=gen, device="cuda")
    w = torch.randn((14336, 4096), generator=gen, device="cuda")
    torch.backends.cuda.matmul.allow_tf32 = True     # a caller's TF32 is refused, not changed
    try:
        qm.rows_mm(a, w)
    except RuntimeError as e:
        if not torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("rows_mm f32 changed the caller's TF32 setting") from e
    else:
        raise AssertionError("rows_mm f32 ran with TF32 allowed")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    got = qm.rows_mm(a, w)
    ref = a.double() @ w.double()
    out["f32_rel_err"] = ((got.double() - ref).abs().max() / ref.abs().max()).item()
    if not out["f32_rel_err"] < 1e-5:
        raise AssertionError(f"rows_mm f32: {out['f32_rel_err']} off an f64 product (TF32?)")
    log(f"rows_mm at 8B, 32 layers' projections (device ms, bf16): {out}; rows 1/4/8/16 "
        "equal their rows of 128")
    return out


class Timer:
    """Median CUDA-event time of single launches, L2 flushed before each."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
        self.graph = GraphTimer(torch)

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


class GraphTimer:
    """Median device time per call for kernels whose single launch is short
    enough that host gaps inside an event pair dominate (kernels C, E, N,
    P): the calls captured in one CUDA graph, an external event on each side
    of each call, so no host gap lies inside a pair; the median over the
    calls of `replays` replays. Either one call per copy of the inputs (the
    copies together outrun the 50 MB L2, so each call finds its bytes in
    device memory), or `reps` calls of one function with the L2 flushed
    before each by a read of 256 MB (a read leaves no dirty lines to write
    back during the call)."""

    def __init__(self, torch, reps: int = 24, replays: int = 3):
        self.torch, self.reps, self.replays = torch, reps, replays
        self.flush = torch.ones(64 << 20, dtype=torch.float32, device="cuda")

    def __call__(self, calls, flush: bool) -> float:
        torch = self.torch
        if callable(calls):
            calls = [calls] * self.reps
        for fn in calls:            # libraries loaded, persistent buffers made
            fn()
        torch.cuda.synchronize()
        pairs = [(torch.cuda.Event(enable_timing=True, external=True),
                  torch.cuda.Event(enable_timing=True, external=True)) for _ in calls]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for (s, e), fn in zip(pairs, calls, strict=True):
                if flush:
                    self.flush.sum()
                s.record()
                fn()
                e.record()
        per = []
        for _ in range(self.replays):
            graph.replay()
            torch.cuda.synchronize()
            per += [s.elapsed_time(e) for s, e in pairs]
        del graph
        return statistics.median(per)


def check_close(name, out, ref, tol):
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    if not err <= tol * scale:
        raise AssertionError(f"{name}: max_abs_err {err} > {tol} x {scale}")
    return err


def _graph_row(timer, kernel, library):
    """Times of a call short enough that host gaps inside one launch's event
    pair dominate it (the W4A8 GEMV A, I, J, M; the tools' kernels Q-Y):
    the graph-timed figures (GraphTimer, the L2 flushed before each call)
    for the line, the single launch's event figures beside them; `library`
    None: the kernel's alone."""
    row = dict(kernel_ms=timer.graph(kernel, flush=True), event_ms=timer(kernel))
    if library is not None:
        row.update(library_ms=timer.graph(library, flush=True), library_event_ms=timer(library))
    return row


def _rows_alone_in_batches(torch, fn, x16, what):
    """Bit for bit: each row of a batch of m = 1 .. 16 rows equals the same
    row computed alone (the W4A8 GEMV's sum order does not depend on M)."""
    alone = torch.cat([fn(x16[r:r + 1].contiguous()) for r in range(16)], dim=-2)
    for m in range(1, 17):
        if not torch.equal(fn(x16[:m].contiguous()), alone[..., :m, :]):
            raise AssertionError(f"{what}: a row of {m} differs from the row alone")


def _codes_equal(torch, qm, x, xq, xs, sxm, what):
    """The kernel's activation codes, scales and scale*sum equal the plain
    quantizer's bit for bit."""
    pxq, pxs, psxm = qm.quant_acts(x)
    for a, b, part in ((xq, pxq, "codes"), (xs, pxs, "scales"), (sxm, psxm, "scale*sum")):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: activation {part} differ")


def kernel_phase(torch, timer, rng):
    """Each kernel against its plain version at the 8B shapes."""
    from blama_tpu_torch.ops import quant_matmul as qm

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for label, (K, N) in SHAPES.items():
        w = qm.repack_q4k_a8s(random_q4k(rng, N, K, K ** -0.5), N, K, "cuda")
        wb = qm.dequantize(w).to(torch.bfloat16)   # the library yardstick's weights
        # 1 row: a solo decode step; 8 rows: a solo T=8 chunk and every
        # serving decode step (the lm head too: forward takes the logits of
        # [max_batch, E] rows)
        # the lm head takes f32 input (bf16-valued), the projections bf16
        x8 = torch.randn((8, K), generator=gen, device="cuda").to(torch.bfloat16)
        if label == "lm_head":
            x8 = x8.float()
        outs = {}
        for M in (1, 8):
            x = x8[8 - M:].contiguous()
            out, xq, xs, sxm = qm.w4a8_launch(x, w)
            outs[M] = out
            _codes_equal(torch, qm, x, xq, xs, sxm, f"kernel A {label} M={M}")
            if not torch.equal(qm.w4a8_matmul(x, w), out):
                raise AssertionError(f"kernel A {label} M={M}: the main path's call (no codes "
                                     "written) differs from the checked one")
            ref = qm.w4a8_matmul_plain(x, w)
            err = check_close(f"kernel A {label} M={M}", out, ref, MATMUL_TOL)
            xb = x.to(torch.bfloat16)
            nbytes = K * N // 2 + 4 * (K // 32) * N + x.numel() * x.element_size() + M * N * 4
            rows.append(dict(
                kernel="w4a8_gemv", shape=f"{label} K={K} N={N} M={M}", max_abs_err=err,
                plain_ms=timer(lambda: qm.w4a8_matmul_plain(x, w), reps=3, warm=1),
                **_graph_row(timer, lambda: qm.w4a8_matmul(x, w),
                             lambda: torch.matmul(xb, wb.t())),
                **_bound(nbytes, 2 * M * K * N, INT8_OPS)))
            log(f"kernel A {rows[-1]}")
        # batch invariance, which the scheduler's exact replay rests on: a
        # row's result depends neither on the row count nor on its index
        if not torch.equal(outs[8][7:], outs[1]):
            raise AssertionError(f"kernel A {label}: row 7 of 8 differs from the row alone")
        x16 = torch.randn((16, K), generator=gen, device="cuda").to(x8.dtype)
        _rows_alone_in_batches(torch, lambda x: qm.w4a8_matmul(x, w), x16, f"kernel A {label}")
        # kernel B takes every chunk of more than 16 flattened rows: a solo
        # T=128 chunk, and the scheduler's joint prefill of 8 rows x T=8..256
        # (64 to 2048 rows); on bf16 scales it also serves 8 and 16 rows of
        # the W4A8 engine's tp_blocks prompt and MoE chunks; the lm head only
        # ever sees the rows' last tokens
        x2048 = torch.randn((2048, K), generator=gen, device="cuda").to(torch.bfloat16)
        wf = qm._q4k_values(w)      # code x scale, f32: kernel B's weights
        # the one-row kernel on each of the last 128 rows: the chain every
        # row of the tiles must give bit for bit
        alone = torch.cat([qm.q4k_pos(x2048[r:r + 1].contiguous(), w)
                           for r in range(1920, 2048)]) if label != "lm_head" else None
        for M in (8, 16, 64, 128, 2048) if label != "lm_head" else ():
            x = x2048[2048 - M:].contiguous()
            out = qm.q4k_pos(x, w)
            outs[M] = out
            ref = qm.q4k_pos_plain(x, w)
            err = check_close(f"kernel B {label} M={M}", out, ref, MATMUL_TOL)
            if M <= 128 and not torch.equal(out, alone[128 - M:]):
                raise AssertionError(f"kernel B {label} M={M}: a row differs from the "
                                     "one-row kernel's")
            nbytes = K * N // 2 + 2 * (K // 32) * N + M * K * 2 + M * N * 4
            # bf16 tensor cores would take these products (4-bit code x bf16
            # x), but only in a design that gives up the f32 chain; the floor
            # of one that keeps it is bound_f32_ms
            rows.append(dict(
                kernel="q4k_dequant_matmul", shape=f"{label} K={K} N={N} M={M}",
                max_abs_err=err, kernel_ms=timer(lambda: qm.q4k_pos(x, w)),
                plain_ms=timer(lambda: qm.q4k_pos_plain(x, w), reps=3, warm=1),
                library_ms=timer(lambda: torch.matmul(x, wb.t())),
                **_f32_yardstick(torch, timer, x, wf, nbytes, K, N),
                **_bound(nbytes, 2 * M * K * N, BF16_FLOPS)))
            log(f"kernel B {rows[-1]}")
        if label != "lm_head" and not (torch.equal(outs[2048][-64:], outs[64])
                                       and torch.equal(outs[2048][-128:], outs[128])):
            raise AssertionError(f"kernel B {label}: rows of 2048 differ from the same rows "
                                 "in a chunk of 64 or 128")
        del w, wb, wf, outs, alone
        torch.cuda.empty_cache()

    return rows


def tile_sweep(torch, timer, rng):
    """Kernel B (bf16 scales) at the 8B projections under every tile shape
    tile_plan weighs at each row count, forced, beside the plan's pick: the
    evidence for the plan. Every shape must give the plan's bits."""
    from blama_tpu_torch.ops import quant_matmul as qm

    gen = torch.Generator(device="cuda").manual_seed(17)
    rows = []
    for label, (K, N) in SHAPES.items():
        if label == "lm_head":
            continue
        w = qm.repack_q4k_a8s(random_q4k(rng, N, K, K ** -0.5), N, K, "cuda")
        x2048 = torch.randn((2048, K), generator=gen, device="cuda").to(torch.bfloat16)
        for M in (8, 16, 64, 128, 2048):
            x = x2048[:M].contiguous()
            plan = qm.tile_plan(M, N)
            ref = qm.q4k_pos(x, w)
            ms = {}
            for t in qm.tile_fits(M):
                if not torch.equal(qm.q4k_pos(x, w, tile=t), ref):
                    raise AssertionError(f"tile sweep {label} M={M}: tile {qm.TILES[t]} "
                                         "differs from the plan's")
                ms["x".join(map(str, qm.TILES[t]))] = timer(
                    lambda: qm.q4k_pos(x, w, tile=t), reps=7, warm=1)
            rows.append(dict(shape=f"{label} K={K} N={N} M={M}",
                             plan="x".join(map(str, qm.TILES[plan])), ms=ms))
            log(f"tile sweep {rows[-1]}")
        del w, x2048
        torch.cuda.empty_cache()
    return rows


def row_sweep(torch, timer, rng):
    """The one-row calls of B (f32 scales), L (pinned, and its partials at
    TP_BLOCKS on wo and down), H and G (groups 32 and 16) at the five 8B
    shapes, and of K over two of Mixtral-8x7B's experts, under every shape of
    ROW_TILES, forced, beside row_plan's pick, graph-timed (GraphTimer, the
    L2 flushed before each call): the evidence for the plan. Every shape
    must give the plan's bits."""
    from blama_tpu_torch.ops import quant_matmul as qm

    gen = torch.Generator(device="cuda").manual_seed(19)
    rows = []

    def sweep(loader, shape, plan, fn):
        ref = fn(None)
        ms = {}
        for r in range(len(qm.ROW_TILES)):
            if not torch.equal(fn(r), ref):
                raise AssertionError(f"row sweep {loader} {shape}: one-row shape {r} differs "
                                     "from the plan's")
            ms[r] = timer.graph(lambda: fn(r), flush=True)
        rows.append(dict(loader=loader, shape=shape, plan=plan, ms=ms))
        log(f"row sweep {rows[-1]}")

    for label, (K, N) in SHAPES.items():
        sigma = K ** -0.5
        x = torch.randn((1, K), generator=gen, device="cuda").to(torch.bfloat16)
        if label == "lm_head":
            x = x.float()
        q4k = random_q4k(rng, N, K, sigma)
        exact = qm.repack_q4k_exact(q4k, N, K, "cuda")
        native = qm.repack_q4k_native(q4k, N, K, "cuda")
        q8 = qm.repack_q8_0(random_q8_0(rng, N, K, sigma), N, K, "cuda")
        q6 = qm.repack_q6_k_expanded(random_q6_k(rng, N, K, sigma), N, K, "cuda")
        cases = (("b_f32", lambda r: qm.q4k_pos(x, exact, row_tile=r)),
                 ("min_f32", lambda r: qm.q4k_matmul_parts(x, exact, 1, row_tile=r)),
                 ("h", lambda r: qm.q4k_native_matmul(x, native, row_tile=r)),
                 ("g32", lambda r: qm.q8_0_matmul(x, q8, row_tile=r)),
                 ("g16", lambda r: qm.q8_0_matmul(x, q6, row_tile=r)))
        for loader, fn in cases:
            sweep(loader, f"{label} K={K} N={N} M=1", qm.row_plan(K, N, loader), fn)
        if label in ("wq/wo", "down"):   # L's partials, the tp_blocks mode's wo and w_down
            sweep("min_f32", f"{label} K={K} N={N} M=1 nb={TP_BLOCKS}",
                  qm.row_plan(K // TP_BLOCKS, N, "min_f32", TP_BLOCKS),
                  lambda r: qm.q4k_matmul_parts(x, exact, TP_BLOCKS, row_tile=r))
        del exact, native, q8, q6, cases
        torch.cuda.empty_cache()
    two = torch.tensor([1, 6], dtype=torch.int32, device="cuda")
    for label, (K, N) in MOE_SHAPES.items():   # K at the routed decode step
        bank = qm.repack_q4k_bank(random_q4k(rng, MOE_EXPERTS * N, K, K ** -0.5), MOE_EXPERTS,
                                  N, K, False, "cuda")
        x = torch.randn((2, 1, K) if label == "down" else (1, K), generator=gen,
                        device="cuda").to(torch.bfloat16)
        sweep("min_f32", f"{label} K={K} N={N} M=1 sel=2", qm.row_plan(K, N, "min_f32", 2),
              lambda r: qm.q4k_bank_matmul(x, bank, two, row_tile=r))
        del bank
        torch.cuda.empty_cache()
    return rows


def _bound(nbytes, ops, rate):
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / rate
    return dict(bound_ms=1e3 * max(t_b, t_o), bound_by="bytes" if t_b >= t_o else "operations")


def _bound_f32(nbytes, ops, chain):
    """The floor of a design that keeps the exact tiles' chain (one f32 FMA
    chain of `chain` dependent steps per output): the largest of the bytes
    at the memory rate, the operations at the f32 rate, the chain's latency."""
    terms = {"bytes": nbytes / HBM_BYTES_PER_S, "operations": ops / F32_FLOPS,
             "chain": chain * FMA_CYCLES / SM_CLOCK_HZ}
    by = max(terms, key=terms.get)
    return dict(bound_f32_ms=1e3 * terms[by], bound_f32_by=by)


def _exact_time(timer, fn, one_row):
    """Time of an exact kernel's call (B, G, H, K, L) or of its yardstick: at
    one row graph-timed (GraphTimer, the L2 flushed before each call), since
    a single launch's event pair there holds host gaps of its size; above it
    the median single launch between events."""
    return timer.graph(fn, flush=True) if one_row else timer(fn)


def _exact_row(timer, M, kernel, library):
    """kernel_ms and library_ms of an exact kernel's line (_exact_time), and
    at one row the single launch's event figure beside them (event_ms)."""
    times = dict(kernel_ms=_exact_time(timer, kernel, M == 1),
                 library_ms=_exact_time(timer, library, M == 1))
    if M == 1:
        times["event_ms"] = timer(kernel)
    return times


def _f32_yardstick(torch, timer, x, wf, nbytes, K, N, min_row=False, n_mat=1, kb=None):
    """library_f32_ms (one f32 torch.matmul over the f32-dequantized weights
    wf [N, K] or [n_mat, N, K], TF32 off: the one call that computes the
    tiles' function; _exact_time) and bound_f32_ms (_bound_f32; chain over a
    K-block of kb elements, the min term a 33rd step of each group)."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the f32 yardstick needs TF32 off")
    xf = x.float()
    lib = (lambda: torch.matmul(xf, wf.t())) if wf.dim() == 2 else \
        (lambda: torch.matmul(xf, wf.transpose(1, 2)))
    kb = kb or K
    M = x.shape[-2]
    return dict(library_f32_ms=_exact_time(timer, lib, M == 1),
                **_bound_f32(nbytes, 2 * M * K * N * n_mat, kb + (kb // 32 if min_row else 0)))


def engine_kernel_phase(torch, timer, rng):
    """The other engines' kernels against their plain versions at the 8B
    shapes: B on f32 scales, G with scale groups 32 and 16, H at 1, 8 and 128
    rows (the lm head at 1 and 8: forward takes the logits of the rows' last
    tokens only), I at 1 and 8 rows. The exact engines send every row count
    through one kernel, so a row's result must not depend on the rows beside
    it: every row of 8 and of 128 is held equal to the one-row kernel's
    (I: row 7 of 8 to the row alone)."""
    from blama_tpu_torch.ops import quant_matmul as qm

    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for label, (K, N) in SHAPES.items():
        sigma = K ** -0.5
        q4k = random_q4k(rng, N, K, sigma)
        x128 = torch.randn((128, K), generator=gen, device="cuda").to(torch.bfloat16)
        if label == "lm_head":      # f32 input (bf16-valued), as forward feeds it
            x128 = x128.float()
        xsz = x128.element_size()
        # (row name, weight, kernel, plain version, weight bytes the kernel reads)
        exact = qm.repack_q4k_exact(q4k, N, K, "cuda")
        native = qm.repack_q4k_native(q4k, N, K, "cuda")
        tiles = [
            ("q4k_dequant_matmul_f32", exact, qm.q4k_pos, qm.q4k_pos_plain,
             K * N // 2 + 4 * (K // 32) * N, "kernel B (f32 scales)"),
            ("q8_dequant_matmul_g32", qm.repack_q8_0(random_q8_0(rng, N, K, sigma), N, K, "cuda"),
             qm.q8_0_matmul, qm.q8_0_matmul_plain, K * N + 4 * (K // 32) * N, "kernel G (group 32)"),
            ("q8_dequant_matmul_g16",
             qm.repack_q6_k_expanded(random_q6_k(rng, N, K, sigma), N, K, "cuda"),
             qm.q8_0_matmul, qm.q8_0_matmul_plain, K * N + 4 * (K // 16) * N, "kernel G (group 16)"),
            ("q4k_native_matmul", native, qm.q4k_native_matmul, qm.q4k_native_matmul_plain,
             (K // 256) * 144 * N, "kernel H"),
        ]
        for name, w, kernel, plain, wbytes, what in tiles:
            # the yardsticks: bf16 and f32 matmul over the dequantized weights
            # (for B the positive part alone, which is what the kernel computes)
            wf = qm._q4k_values(w) if name == "q4k_dequant_matmul_f32" else qm.dequantize(w)
            wb = wf.to(torch.bfloat16)
            outs = {}
            counts = (1, 8, 128) if label != "lm_head" else (1, 8)
            # the one-row kernel on each of the last rows: the chain every row
            # of the tiles must give bit for bit
            alone = torch.cat([kernel(x128[r:r + 1].contiguous(), w)
                               for r in range(128 - max(counts), 128)])
            for M in counts:
                x = x128[128 - M:].contiguous()
                out = kernel(x, w)
                torch.cuda.synchronize()
                outs[M] = out
                err = check_close(f"{what} {label} M={M}", out, plain(x, w), MATMUL_TOL)
                if not torch.equal(out, alone[len(alone) - M:]):
                    raise AssertionError(f"{what} {label}: a row of {M} differs from the "
                                         "one-row kernel's")
                xb = x.to(torch.bfloat16)
                nbytes = wbytes + M * K * xsz + M * N * 4
                rows.append(dict(
                    kernel=name, shape=f"{label} K={K} N={N} M={M}", max_abs_err=err,
                    plain_ms=timer(lambda: plain(x, w), reps=3, warm=1),
                    **_exact_row(timer, M, lambda: kernel(x, w),
                                 lambda: torch.matmul(xb, wb.t())),
                    **_f32_yardstick(torch, timer, x, wf, nbytes, K, N,
                                     min_row=name == "q4k_native_matmul"),
                    # as for kernel B: bf16 tensor cores only without the chain
                    **_bound(nbytes, 2 * M * K * N, BF16_FLOPS)))
                log(f"{what} {rows[-1]}")
            del w, wb, wf, outs, alone
            torch.cuda.empty_cache()
        # printed, not gated: the exact engine's min term is a library product
        # outside kernel B, whose sum order may depend on the row count
        same = torch.equal(qm.q4k_matmul(x128[-8:].contiguous(), exact)[-1:],
                           qm.q4k_matmul(x128[-1:].contiguous(), exact))
        log(f"q4k_matmul (kernel B + outside min term) {label}: row 7 of 8 "
            f"{'equals' if same else 'differs from'} the row alone")
        next(r for r in rows if r["kernel"] == "q4k_dequant_matmul_f32"
             and r["shape"] == f"{label} K={K} N={N} M=8")["min_term_row_invariant"] = same
        # kernel I, on the same native bytes as H
        w = qm.QuantTensorA8K4(native.codes)
        wb = qm.dequantize(w).to(torch.bfloat16)
        outs = {}
        for M in (1, 8):
            x = x128[128 - M:].contiguous()
            out, xq, xs, sxm = qm.a8k4_launch(x, w)
            torch.cuda.synchronize()
            outs[M] = out
            _codes_equal(torch, qm, x, xq, xs, sxm, f"kernel I {label} M={M}")
            err = check_close(f"kernel I {label} M={M}", out, qm.a8k4_matmul_plain(x, w),
                              MATMUL_TOL)
            xb = x.to(torch.bfloat16)
            rows.append(dict(
                kernel="w4a8k4_gemv", shape=f"{label} K={K} N={N} M={M}", max_abs_err=err,
                plain_ms=timer(lambda: qm.a8k4_matmul_plain(x, w), reps=3, warm=1),
                **_graph_row(timer, lambda: qm.a8k4_matmul(x, w),
                             lambda: torch.matmul(xb, wb.t())),
                **_bound((K // 256) * 144 * N + M * K * xsz + M * N * 4, 2 * M * K * N, INT8_OPS)))
            log(f"kernel I {rows[-1]}")
        if not torch.equal(outs[8][7:], outs[1]):
            raise AssertionError(f"kernel I {label}: row 7 of 8 differs from the row alone")
        _rows_alone_in_batches(torch, lambda x: qm.a8k4_matmul(x, w), x128[:16],
                               f"kernel I {label}")
        del w, wb, outs, exact, native
        torch.cuda.empty_cache()
    return rows


def bank_kernel_phase(torch, timer, rng):
    """Kernels J and K against their plain versions at Mixtral-8x7B's bank
    shapes (8 experts): the routed decode step's one row over 2 selected
    experts, the masked chunks' and serving steps' 4, 8 and 128 rows over all
    8; gate/up share one input, down takes one input per expert, as the MoE
    FFN feeds them. J is held equal bit for bit to kernel A on each selected
    expert alone, and K's rows to themselves at 1, 4, 8 and 128 rows."""
    from blama_tpu_torch.ops import quant_matmul as qm

    gen = torch.Generator(device="cuda").manual_seed(9)
    rows = []
    for label, (K, N) in MOE_SHAPES.items():
        q4k = random_q4k(rng, MOE_EXPERTS * N, K, K ** -0.5)
        per = label == "down"
        x128 = torch.randn((MOE_EXPERTS, 128, K), generator=gen, device="cuda") \
            .to(torch.bfloat16)

        def inputs(M, eids):
            """The last M rows: one input shared by the experts, or expert e's
            own rows x128[e] (so an expert sees the same rows in every call)."""
            return x128[eids.long(), 128 - M:].contiguous() if per \
                else x128[0, 128 - M:].contiguous()

        def library(bank, x, eids, f32=False):
            """bf16 (or f32) torch.bmm over the gathered, dequantized experts."""
            dt = torch.float32 if f32 else torch.bfloat16
            wb = torch.stack([qm.dequantize(bank.expert(e)) for e in eids.tolist()]).to(dt)
            xb = (x if per else x.expand(len(eids), *x.shape)).to(dt).contiguous()
            return lambda: torch.bmm(xb, wb.transpose(1, 2))

        def f32_yardstick(bank, x, eids, nbytes):
            """library_f32_ms (TF32 off) and the chain-keeping floor of kernel K."""
            if torch.backends.cuda.matmul.allow_tf32:
                raise AssertionError("the f32 yardstick needs TF32 off")
            M, n_sel = x.shape[-2], len(eids)
            return dict(library_f32_ms=_exact_time(timer, library(bank, x, eids, f32=True),
                                                   M == 1),
                        **_bound_f32(nbytes, 2 * M * K * N * n_sel, K + K // 32))

        for a8 in (True, False):
            bank = qm.repack_q4k_bank(q4k, MOE_EXPERTS, N, K, a8, "cuda")
            sbytes = 2 if a8 else 4
            wbytes = K * N // 2 + 2 * sbytes * (K // 32) * N      # one expert
            all8 = torch.arange(MOE_EXPERTS, dtype=torch.int32, device="cuda")
            two = torch.tensor([1, 6], dtype=torch.int32, device="cuda")
            # 1 row over 2: the routed decode step; 4 and 8 rows over all 8:
            # the 3- and 5-token prompts' masked chunks and the 4-row serving
            # step; 128 rows: the 128-token prompt's chunk
            cases = [(1, two), (4, all8), (8, all8), (128, all8)]
            if a8:      # J: up to 16 rows; the 8-row chunk also over 2 experts
                cases = [(1, two), (4, all8), (8, two), (8, all8)]
            outs = {}
            for M, eids in cases:
                n_sel = len(eids)
                x = inputs(M, eids)
                nbytes = n_sel * wbytes + x.numel() * 2 + n_sel * M * N * 4
                ops = 2 * M * K * N * n_sel
                shape = f"{label} K={K} N={N} M={M} sel={n_sel} scales={'bf16' if a8 else 'f32'}"
                lib_fn = library(bank, x, eids)
                if a8:
                    out, xq, xs, sxm = qm.w4a8_bank_launch(x, bank, eids)
                    torch.cuda.synchronize()
                    _codes_equal(torch, qm, x.reshape(-1, K), xq, xs, sxm, f"kernel J {shape}")
                    for j, e in enumerate(eids.tolist()):
                        xj = x[j] if per else x
                        if not torch.equal(out[j], qm.w4a8_matmul(xj, bank.expert(e))):
                            raise AssertionError(f"kernel J {shape}: expert {e} differs from "
                                                 "kernel A on that expert alone")
                    err = check_close(f"kernel J {shape}", out, qm.w4a8_bank_plain(x, bank, eids),
                                      MATMUL_TOL)
                    rows.append(dict(
                        kernel="w4a8_bank_gemv", shape=shape, max_abs_err=err,
                        plain_ms=timer(lambda: qm.w4a8_bank_plain(x, bank, eids), reps=3, warm=1),
                        **_graph_row(timer, lambda: qm.w4a8_bank_matmul(x, bank, eids), lib_fn),
                        **_bound(nbytes, ops, INT8_OPS)))
                    log(f"kernel J {rows[-1]}")
                # K on every case of the exact bank, and above 16 rows of the
                # W4A8 bank's (bf16 scales) at the 128-row chunk below
                if not a8:
                    out = qm.q4k_bank_matmul(x, bank, eids)
                    torch.cuda.synchronize()
                    outs[M] = out
                    err = check_close(f"kernel K {shape}", out, qm.q4k_bank_plain(x, bank, eids),
                                      MATMUL_TOL)
                    rows.append(dict(
                        kernel="q4k_bank_matmul", shape=shape, max_abs_err=err,
                        plain_ms=timer(lambda: qm.q4k_bank_plain(x, bank, eids), reps=3, warm=1),
                        **_exact_row(timer, M, lambda: qm.q4k_bank_matmul(x, bank, eids), lib_fn),
                        **f32_yardstick(bank, x, eids, nbytes),
                        # as for kernel B: bf16 tensor cores only without the chain
                        **_bound(nbytes, ops, BF16_FLOPS)))
                    log(f"kernel K {rows[-1]}")
                del lib_fn
            if a8:      # K on bf16 scales: the W4A8 engine's 128-row chunk
                x = inputs(128, all8)
                out = qm.q4k_bank_matmul(x, bank, all8)
                torch.cuda.synchronize()
                err = check_close(f"kernel K bf16 {label}", out,
                                  qm.q4k_bank_plain(x, bank, all8), MATMUL_TOL)
                lib_fn = library(bank, x, all8)
                nbytes = MOE_EXPERTS * wbytes + x.numel() * 2 + MOE_EXPERTS * 128 * N * 4
                rows.append(dict(
                    kernel="q4k_bank_matmul",
                    shape=f"{label} K={K} N={N} M=128 sel={MOE_EXPERTS} scales=bf16",
                    max_abs_err=err, kernel_ms=timer(lambda: qm.q4k_bank_matmul(x, bank, all8)),
                    plain_ms=timer(lambda: qm.q4k_bank_plain(x, bank, all8), reps=3, warm=1),
                    library_ms=timer(lib_fn), **f32_yardstick(bank, x, all8, nbytes),
                    **_bound(nbytes, 2 * 128 * K * N * MOE_EXPERTS, BF16_FLOPS)))
                log(f"kernel K {rows[-1]}")
                one = qm.q4k_bank_matmul(inputs(1, all8), bank, all8)
                if not torch.equal(out[:, -1:], one):
                    raise AssertionError(f"kernel K bf16 {label}: the last row of 128 differs "
                                         "from the row alone")
                del lib_fn
            else:       # every row of 4, 8 and 128 equals the one-row kernel's
                def row(r):
                    return (x128[all8.long(), r:r + 1] if per else x128[0, r:r + 1]).contiguous()
                alone = torch.cat([qm.q4k_bank_matmul(row(r), bank, all8) for r in range(128)],
                                  dim=1)
                one = alone[:, -1:]
                for M in (4, 8, 128):
                    if not torch.equal(outs[M], alone[:, 128 - M:]):
                        raise AssertionError(f"kernel K {label}: a row of {M} differs from "
                                             "the one-row kernel's")
                if not torch.equal(outs[1], one[[1, 6]]):
                    raise AssertionError(f"kernel K {label}: the routed row differs from the "
                                         "same row among all experts")
            del bank, outs
            torch.cuda.empty_cache()
    return rows


def moe_dense_kernel_phase(torch, timer, rng):
    """Kernels A and B (f32 scales) at the shapes the MoE path gives them
    beyond the 8B phases': the projections at 4 rows (the 3-token prompt's
    T=4 chunk, and A in the 4-row serving step) and Mixtral's lm head
    (N=32000) through A at 1 and 4 rows and through B on f32 scales at one
    row (the exact engine's decode step). Each against its plain version, a
    row's bits held equal to the row alone."""
    from blama_tpu_torch.ops import quant_matmul as qm

    gen = torch.Generator(device="cuda").manual_seed(13)
    rows = []
    for label, (K, N) in MOE_DENSE_SHAPES.items():
        head = label == "lm_head"
        q4k = random_q4k(rng, N, K, K ** -0.5)
        x4 = torch.randn((4, K), generator=gen, device="cuda").to(torch.bfloat16)
        if head:        # f32 input (bf16-valued), as forward feeds the lm head
            x4 = x4.float()
        wbytes = K * N // 2 + 4 * (K // 32) * N     # codes + bf16 sc/mn or f32 sc
        a8 = qm.repack_q4k_a8s(q4k, N, K, "cuda")
        exact = qm.repack_q4k_exact(q4k, N, K, "cuda")
        # (row name, what, weight, kernel, plain version, row counts, rate)
        for name, what, w, kernel, plain, counts, rate in (
                ("w4a8_gemv", "kernel A", a8, qm.w4a8_matmul,
                 qm.w4a8_matmul_plain, (1, 4) if head else (4,), INT8_OPS),
                ("q4k_dequant_matmul_f32", "kernel B (f32 scales)", exact, qm.q4k_pos,
                 qm.q4k_pos_plain, (1,) if head else (4,), BF16_FLOPS)):
            wd = qm.dequantize(w)       # the yardstick (for B its positive part)
            if w is exact:
                wd = wd + w.mins.repeat_interleave(32, dim=1)
            wb = wd.to(torch.bfloat16)
            del wd
            one = kernel(x4[-1:].contiguous(), w)
            for M in counts:
                x = x4[4 - M:].contiguous()
                out = kernel(x, w)
                torch.cuda.synchronize()
                shape = f"moe {label} K={K} N={N} M={M}"
                err = check_close(f"{what} {shape}", out, plain(x, w), MATMUL_TOL)
                if not torch.equal(out[-1:], one):
                    raise AssertionError(f"{what} {shape}: the last row differs from the "
                                         "row alone")
                xb = x.to(torch.bfloat16)
                library = lambda: torch.matmul(xb, wb.t())  # noqa: E731
                times = _graph_row(timer, lambda: kernel(x, w), library) \
                    if name == "w4a8_gemv" else _exact_row(timer, M, lambda: kernel(x, w), library)
                rows.append(dict(
                    kernel=name, shape=shape, max_abs_err=err,
                    plain_ms=timer(lambda: plain(x, w), reps=3, warm=1), **times,
                    **_bound(wbytes + x.numel() * x.element_size() + M * N * 4,
                             2 * M * K * N, rate)))
                log(f"{what} {rows[-1]}")
            del wb
        del a8, exact
        torch.cuda.empty_cache()
    return rows


def _parts_equal_shards(torch, qm, fn, x, w, nb, parts, what):
    """Bit for bit: the partials each of tp devices computes on its K-slice
    alone, concatenated and combined by the tree, equal the one-dispatch
    partials after the tree (and the concatenated partials equal them
    before it)."""
    K = x.shape[1]
    whole = qm.tree_combine(parts)
    for tp in (2, 4, 8):
        kb = K // tp
        shards = torch.cat([fn(x[:, d * kb:(d + 1) * kb].contiguous(),
                               qm.k_slice(w, d, tp, contiguous=True), nb // tp)
                            for d in range(tp)])
        if not (torch.equal(shards, parts) and torch.equal(qm.tree_combine(shards), whole)):
            raise AssertionError(f"{what}: partials of tp={tp} K-slices differ from the "
                                 "one-dispatch partials")


def _rows_alone(torch, fn, x, out, what):
    """Bit for bit: each row of x computed alone (L: the one-row kernel)
    gives that row of `out` ([nb, M, N] partials of all of x), every row."""
    alone = torch.cat([fn(x[r:r + 1].contiguous()) for r in range(x.shape[0])], dim=1)
    for r in range(x.shape[0]):
        if not torch.equal(alone[:, r], out[:, r]):
            raise AssertionError(f"{what}: row {r} of {x.shape[0]} differs from the row alone")


def tp_kernel_phase(torch, timer, rng):
    """Kernels L and M against their plain versions at the 8B shapes of the
    tp_blocks mode at TP_BLOCKS = 8: L's per-K-block partials for wo and down
    (512- and 1792-wide blocks) at 1, 4, 8 and 128 rows on f32 scales and at
    128 on bf16 (the W4A8 engine's prompt chunk), L at one block (the pinned
    product) for wq, wk, gate and the lm head at 1, 4, 8 and 128 rows (head:
    1, 4 and 8) and for Mixtral's lm head at one row, M for wo and down at 1,
    4 and 8 rows (4: the instance's 3-token prompt chunk and the scheduler's
    4-row decode, M's and A's 4-row build). Bit for bit: parts = shards
    (tp = 2, 4, 8 K-slices computed alone), pinned = column shard (each of tp
    column shards of the weight), and each row (up to 8, and the last) alone
    against the same row among the others."""
    from blama_tpu_torch.ops import quant_matmul as qm

    gen = torch.Generator(device="cuda").manual_seed(9)
    nb = TP_BLOCKS
    rows = []
    # label, (K, N), parts (contraction-sharded) or pinned (output-sharded),
    # row counts of L on f32 scales
    cases = [("wq/wo", SHAPES["wq/wo"], True, (1, 4, 8, 128)),
             ("down", SHAPES["down"], True, (1, 4, 8, 128)),
             ("wq/wo", SHAPES["wq/wo"], False, (1, 4, 8, 128)),
             ("wk/wv", SHAPES["wk/wv"], False, (1, 4, 8, 128)),
             ("gate/up", SHAPES["gate/up"], False, (1, 4, 8, 128)),
             ("lm_head", SHAPES["lm_head"], False, (1, 4, 8)),
             ("moe lm_head", MOE_DENSE_SHAPES["lm_head"], False, (1,))]
    for label, (K, N), parts, counts in cases:
        q4k = random_q4k(rng, N, K, K ** -0.5)
        x128 = torch.randn((128, K), generator=gen, device="cuda").to(torch.bfloat16)
        if label.endswith("lm_head"):   # f32 input (bf16-valued), as forward feeds it
            x128 = x128.float()
        exact = qm.repack_q4k_exact(q4k, N, K, "cuda")
        wf = qm.dequantize(exact)                      # the library yardsticks' weights
        wb = wf.to(torch.bfloat16)
        runs = [(exact, "f32", M) for M in counts]
        if parts:
            a8 = qm.repack_q4k_a8s(q4k, N, K, "cuda")
            runs.append((a8, "bf16", 128))
        for w, sc, M in runs:
            x = x128[128 - M:].contiguous()
            xb = x.to(torch.bfloat16)
            wbytes = K * N // 2 + (8 if sc == "f32" else 4) * (K // 32) * N
            blocks = nb if parts else 1
            shape = f"{label} K={K} N={N} M={M} nb={blocks} scales={sc}"
            out = qm.q4k_matmul_parts(x, w, blocks)
            torch.cuda.synchronize()
            ref = qm.q4k_matmul_parts_plain(x, w, blocks)
            err = max(check_close(f"kernel L {shape} block {i}", out[i], ref[i], MATMUL_TOL)
                      for i in range(blocks))
            if parts:
                _parts_equal_shards(torch, qm, qm.q4k_matmul_parts, x, w, nb, out,
                                    f"kernel L {shape}")
            else:
                for tp in (2, 4, 8):
                    n = N // tp
                    for d in range(tp):
                        cols = qm.column_slice(w, d * n, (d + 1) * n)
                        if not torch.equal(qm.q4k_matmul_pinned(x, cols),
                                           out[0][:, d * n:(d + 1) * n]):
                            raise AssertionError(f"kernel L {shape}: column shard {d} of "
                                                 f"{tp} differs from its columns")
            _rows_alone(torch, lambda xr: qm.q4k_matmul_parts(xr, w, blocks), x, out,
                        f"kernel L {shape}")
            nbytes = wbytes + M * K * x.element_size() + blocks * M * N * 4
            rows.append(dict(
                kernel="q4k_parts_matmul", shape=shape, max_abs_err=err,
                plain_ms=timer(lambda: qm.q4k_matmul_parts_plain(x, w, blocks), reps=3, warm=1),
                **_exact_row(timer, M, lambda: qm.q4k_matmul_parts(x, w, blocks),
                             lambda: torch.matmul(xb, wb.t())),
                **_f32_yardstick(torch, timer, x, wf, nbytes, K, N, min_row=True,
                                 kb=K // blocks),
                **_bound(nbytes, 2 * M * K * N, BF16_FLOPS)))
            log(f"kernel L {rows[-1]}")
        if parts:
            # kernel M: the W4A8 engine's partials up to 16 rows
            for M in (1, 4, 8):
                x = x128[128 - M:].contiguous()
                xb = x.to(torch.bfloat16)
                shape = f"{label} K={K} N={N} M={M} nb={nb}"
                out, xq, xs, sxm = qm.a8s_parts_launch(x, a8, nb)
                torch.cuda.synchronize()
                _codes_equal(torch, qm, x, xq, xs, sxm, f"kernel M {shape}")
                kb = K // nb
                for i in range(nb):
                    xi = x[:, i * kb:(i + 1) * kb].contiguous()
                    if not torch.equal(out[i], qm.w4a8_matmul(xi, qm.k_slice(a8, i, nb, True))):
                        raise AssertionError(f"kernel M {shape}: block {i} differs from kernel "
                                             "A on its K-slice alone")
                ref = qm.a8s_matmul_parts_plain(x, a8, nb)
                err = max(check_close(f"kernel M {shape} block {i}", out[i], ref[i],
                                      MATMUL_TOL) for i in range(nb))
                _parts_equal_shards(torch, qm, qm.a8s_matmul_parts, x, a8, nb, out,
                                    f"kernel M {shape}")
                _rows_alone(torch, lambda xr: qm.a8s_matmul_parts(xr, a8, nb), x, out,
                            f"kernel M {shape}")
                rows.append(dict(
                    kernel="w4a8_parts_gemv", shape=shape, max_abs_err=err,
                    plain_ms=timer(lambda: qm.a8s_matmul_parts_plain(x, a8, nb), reps=3,
                                   warm=1),
                    **_graph_row(timer, lambda: qm.a8s_matmul_parts(x, a8, nb),
                                 lambda: torch.matmul(xb, wb.t())),
                    **_bound(K * N // 2 + 4 * (K // 32) * N + M * K * 2 + nb * M * N * 4,
                             2 * M * K * N, INT8_OPS)))
                log(f"kernel M {rows[-1]}")
            del a8
        del exact, wb, wf
        torch.cuda.empty_cache()
    return rows


# kernel R's blocks held in the kernel phase: one of the reference's (2 x 3
# CTAs on a 2048 x 14336 layer) and one of the card's own size (224 CTAs)
STREAM_BLOCKS = ((1024, 4096), (64, 2048))


def _keep(keep, kernel, shape, out):
    """Into `keep` (when given): `out` (a tensor or a tuple of them) on the
    host under "<kernel> <shape>", for --tools-timing's comparison of trees."""
    if keep is not None:
        keep[f"{kernel} {shape}"] = (tuple(o.cpu() for o in out) if isinstance(out, tuple)
                                     else out.cpu())


def tools_kernel_phase(torch, timer, rng, keep=None):
    """The tools' kernels against their plain versions at the tools' shapes:
    Q (w4a8_swar_matmul's positive part) at the 8B projections and lm head,
    1 and 8 rows, kb 4 and 8, its bits equal at every block_n; T (X2) at the
    same shapes, kb 8 and 16; Q at gate/up, 8 rows, kb 4 equal bit for bit to
    its lane order (testing.slab_lane_order), T there at kb 8 and 16 to its
    own (testing.x2_lane_order); R on a 2048 x 14336 layer at
    two blocks, exact, every byte staged; S on [8, 128], exact. And rows_mm (the exact
    engines' min term, the MoE router) at the decode step's shapes: its
    16-row blocks against one plain product, host ms per call. Each output
    goes into `keep` (_keep)."""
    from blama_tpu_torch import testing
    from blama_tpu_torch.ops import probes
    from blama_tpu_torch.ops import quant_matmul as qm

    # the lane orders Q, V and T keep (a tree timed by --tools-timing may be older)
    lane_order = getattr(testing, "slab_lane_order", None)
    x2_order = getattr(testing, "x2_lane_order", None)
    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = []
    for label, (K, N) in SHAPES.items():
        data = random_q4k(rng, N, K, K ** -0.5)
        w, w4 = qm.repack_q4k_a8s(data, N, K, "cuda"), qm.repack_q4k_a8k4(data, N, K, "cuda")
        wb = qm.dequantize(w).to(torch.bfloat16)
        x8 = torch.randn((8, K), generator=gen, device="cuda").to(torch.bfloat16)
        for M in (1, 8):
            x = x8[8 - M:].contiguous()
            xb = x.to(torch.bfloat16)
            pxq = qm.quant_acts(x)[0]
            for kind, kbs in (("Q", (4, 8)), ("T", (8, 16))):
                for kb in kbs:
                    if kind == "Q":
                        launch = lambda bn=qm.SLAB_BLOCK_N, kb=kb: qm.a8s_launch(x, w, bn, kb)
                        plain = lambda kb=kb: qm.a8s_pos_plain(x, w, kb)
                        nbytes = K * N // 2 + 2 * (K // 32) * N
                        name = "w4a8_slab_gemv"
                    else:
                        launch = lambda bn=qm.SLAB_BLOCK_N, kb=kb: qm.x2_launch(x, w4, bn, kb)
                        plain = lambda kb=kb: qm.x2_matmul_plain(x, w4, kb=kb)
                        nbytes = K * N // 256 * 144
                        name = "w4a8k4_slab_gemv"
                    out, xq = launch()[:2]
                    if not torch.equal(xq, pxq):
                        raise AssertionError(f"kernel {kind} {label} M={M}: activation codes "
                                             "differ from the plain quantizer's")
                    err = check_close(f"kernel {kind} {label} M={M} kb={kb}", out, plain(),
                                      MATMUL_TOL)
                    for bn in (1, 16, 64, 2048):
                        if not torch.equal(launch(bn)[0], out):
                            raise AssertionError(f"kernel {kind} {label} M={M} kb={kb}: "
                                                 f"block_n={bn} moved a bit")
                    if lane_order and kind == "Q" and (label, M, kb) == ("gate/up", 8, 4):
                        _, xq, xs, _ = launch()
                        order = lane_order(xq, xs, qm.unpair_codes(w.codes), w.scales, kb, 4)
                        if not torch.equal(out, order):
                            raise AssertionError(f"kernel Q {label} M={M} kb={kb}: not its "
                                                 "lane order")
                    if x2_order and kind == "T" and (label, M) == ("gate/up", 8):
                        _, xq, xs, sxm = launch()
                        codes, ws, wm = qm.decode_q4k_blocks(w4.codes.view(-1, 144), N)
                        order = x2_order(xq, xs, sxm, codes, ws, wm, qm.x2_clamp(K, N, 8, kb)[1])
                        del codes
                        if not torch.equal(out, order):
                            raise AssertionError(f"kernel T {label} M={M} kb={kb}: not its "
                                                 "lane order")
                    nbytes += x.numel() * x.element_size() + M * N * 4
                    _keep(keep, name, f"{label} K={K} N={N} M={M} kb={kb}", out)
                    rows.append(dict(
                        kernel=name, shape=f"{label} K={K} N={N} M={M} kb={kb}",
                        max_abs_err=err, plain_ms=timer(plain, reps=3, warm=1),
                        **_graph_row(timer, launch, lambda: torch.matmul(xb, wb.t())),
                        **_bound(nbytes, 2 * M * K * N, INT8_OPS)))
                    log(f"kernel {kind} {rows[-1]}")
        del w, w4, wb
        torch.cuda.empty_cache()

    R, N = 2048, 14336
    codes = torch.randint(0, 256, (R, N), generator=gen, dtype=torch.uint8, device="cuda")
    for bk, bn in STREAM_BLOCKS:
        out, tot = probes.stream_launch(codes, bk, bn, total=True)
        if not torch.equal(out, probes.stream_plain(codes, bk, bn)):
            raise AssertionError(f"kernel R ({bk}, {bn}): sums differ from the plain version")
        staged = torch.zeros_like(tot)
        nn = N // bn * bn
        staged[0, :nn] = codes[:R // bk * bk, :nn].to(torch.int32).sum(0).float()
        if not torch.equal(tot, staged):
            raise AssertionError(f"kernel R ({bk}, {bn}): a byte of a block was not staged")
        nbytes = (R // bk * bk) * nn + N * 4
        _keep(keep, "stream_rows", f"{R}x{N} bk={bk} bn={bn}", (out, tot))
        rows.append(dict(
            kernel="stream_rows", shape=f"{R}x{N} bk={bk} bn={bn} CTAs={(R // bk) * (N // bn)}",
            max_abs_err=0.0,
            plain_ms=timer(lambda: probes.stream_plain(codes, bk, bn), reps=3, warm=1),
            **_graph_row(timer, lambda: probes.stream_launch(codes, bk, bn),
                         lambda: torch.sum(codes, dtype=torch.int32)),
            **_bound(nbytes, 8 * (R // bk) * nn, F32_FLOPS)))
        log(f"kernel R {rows[-1]}")
    del codes
    x = torch.randn((8, 128), generator=gen, device="cuda")
    if not torch.equal(probes.add_one(x), probes.add_one_plain(x)):
        raise AssertionError("kernel S differs from x + 1")
    _keep(keep, "add_one", "x [8, 128] f32", probes.add_one(x))
    rows.append(dict(kernel="add_one", shape="x [8, 128] f32", max_abs_err=0.0,
                     plain_ms=timer(lambda: probes.add_one_plain(x), reps=3, warm=1),
                     **_graph_row(timer, lambda: probes.add_one(x), lambda: x + 1),
                     **_bound(2 * x.numel() * 4, x.numel(), F32_FLOPS)))
    log(f"kernel S {rows[-1]}")
    return rows


def ubench_kernel_phase(torch, timer, keep=None):
    """ubench_q4k's kernels against their plain versions at the 8B
    projections and lm head, 1 and 8 rows (f32 x, as the tool's): U at kb 8
    (the reference's v1 default) and 4, V at kb 4 (v2) and 8 (v3) on both
    code layouts, the two loaders bit-equal, block_n moving no bit, and at
    gate/up, 8 rows, kb 4 equal to its lane order (testing.slab_lane_order). Beside
    the bf16 library call over the dequantized weights, U's rows carry the
    one call that computes U's function, f32 `torch.matmul` over the f32
    weights (codes times scales, TF32 off): `library_f32_ms`. Each output
    goes into `keep` (_keep)."""
    from blama_tpu_torch import testing
    from blama_tpu_torch.ops import quant_matmul as qm
    from blama_tpu_torch.tools.ubench_q4k import pack_pairs

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("U's f32 yardstick needs TF32 off")
    lane_order = getattr(testing, "slab_lane_order", None)   # as in tools_kernel_phase
    gen = torch.Generator(device="cuda").manual_seed(9)
    rows = []
    for label, (K, N) in SHAPES.items():
        codes = torch.randint(0, 16, (N, K), generator=gen, dtype=torch.uint8, device="cuda")
        sc = torch.rand((N, K // 32), generator=gen, device="cuda") * 0.02 + 0.01
        mn = torch.rand((N, K // 32), generator=gen, device="cuda") * 0.01
        paired, i8 = pack_pairs(codes), codes.to(torch.int8)
        sb = sc.to(torch.bfloat16)
        wb = (codes.float().reshape(N, K // 32, 32) * sc[..., None]
              - mn[..., None]).reshape(N, K).to(torch.bfloat16)
        wf = (codes.float().reshape(N, K // 32, 32) * sc[..., None]).reshape(N, K)
        x8 = torch.randn((8, K), generator=gen, device="cuda")
        for M in (1, 8):
            x = x8[8 - M:].contiguous()
            xb = x.to(torch.bfloat16)
            lib = _graph_row(timer, lambda: torch.matmul(xb, wb.t()), None)
            lib = dict(library_ms=lib["kernel_ms"], library_event_ms=lib["event_ms"])
            lib_f32 = timer.graph(lambda: torch.matmul(x, wf.t()), flush=True)
            pxq = qm.quant_acts(x)[0]
            for kb in (8, 4):
                out = qm.twodot_launch(x, paired, sc, qm.SLAB_BLOCK_N, kb)
                err = check_close(f"kernel U {label} M={M} kb={kb}", out,
                                  qm.twodot_pos_plain(x, paired, sc, kb), MATMUL_TOL)
                for bn in (1, 16, 64, 2048):
                    if not torch.equal(qm.twodot_launch(x, paired, sc, bn, kb), out):
                        raise AssertionError(f"kernel U {label} M={M} kb={kb}: block_n={bn} "
                                             "moved a bit")
                nbytes = K * N // 2 + 4 * (K // 32) * N + 4 * M * K + 4 * M * N
                _keep(keep, "q4k_twodot_matmul", f"{label} K={K} N={N} M={M} kb={kb}", out)
                rows.append(dict(
                    kernel="q4k_twodot_matmul", shape=f"{label} K={K} N={N} M={M} kb={kb}",
                    max_abs_err=err, library_f32_ms=lib_f32,
                    **_graph_row(timer, lambda kb=kb: qm.twodot_launch(x, paired, sc,
                                                                       qm.SLAB_BLOCK_N, kb),
                                 None),
                    plain_ms=timer(lambda kb=kb: qm.twodot_pos_plain(x, paired, sc, kb),
                                   reps=3, warm=1),
                    **lib, **_bound(nbytes, 2 * M * K * N, F32_FLOPS)))
                log(f"kernel U {rows[-1]}")
            for kb in (4, 8):
                ref = qm.plane_pos_plain(x, i8, sb, kb)
                outs = {}
                for packed, codes_v, name in ((False, i8, "w4a8_plane_matmul"),
                                              (True, paired, "w4a8_packed_matmul")):
                    out, xq = qm.plane_launch(x, codes_v, sb, packed, qm.SLAB_BLOCK_N, kb)[:2]
                    if not torch.equal(xq, pxq):
                        raise AssertionError(f"kernel V {label} M={M}: activation codes "
                                             "differ from the plain quantizer's")
                    err = check_close(f"kernel V {name} {label} M={M} kb={kb}", out, ref,
                                      MATMUL_TOL)
                    for bn in (1, 16, 64, 2048):
                        if not torch.equal(qm.plane_launch(x, codes_v, sb, packed, bn, kb)[0],
                                           out):
                            raise AssertionError(f"kernel V {name} {label} M={M} kb={kb}: "
                                                 f"block_n={bn} moved a bit")
                    outs[packed] = out
                    _keep(keep, name, f"{label} K={K} N={N} M={M} kb={kb}", out)
                    nbytes = ((K * N // 2 if packed else K * N) + 2 * (K // 32) * N
                              + 4 * M * K + 4 * M * N)
                    rows.append(dict(
                        kernel=name, shape=f"{label} K={K} N={N} M={M} kb={kb}",
                        max_abs_err=err,
                        **_graph_row(timer, lambda c=codes_v, p=packed, kb=kb: qm.plane_launch(
                            x, c, sb, p, qm.SLAB_BLOCK_N, kb), None),
                        plain_ms=timer(lambda kb=kb: qm.plane_pos_plain(x, i8, sb, kb),
                                       reps=3, warm=1),
                        **lib, **_bound(nbytes, 2 * M * K * N, INT8_OPS)))
                    log(f"kernel V {rows[-1]}")
                if not torch.equal(outs[False], outs[True]):
                    raise AssertionError(f"kernel V {label} M={M} kb={kb}: the int8 and the "
                                         "tile-paired loaders differ")
                if lane_order and (label, M, kb) == ("gate/up", 8, 4):
                    _, xq, xs, _ = qm.plane_launch(x, i8, sb, False, qm.SLAB_BLOCK_N, kb)
                    if not torch.equal(outs[False], lane_order(xq, xs, codes, sb, kb, 0)):
                        raise AssertionError(f"kernel V {label} M={M} kb={kb}: not its lane "
                                             "order")
        del codes, paired, i8, wb, wf
        torch.cuda.empty_cache()
    return rows


# the probes' shapes: the references' [256, 512] and one code plane of an 8B
# FFN weight (2048 x 14336 uint8 with a [32, 2048] int8 operand)
PROBE_SHAPES = ((256, 512), (2048, 14336))


def probes_kernel_phase(torch, timer, keep=None):
    """Kernels W and X at PROBE_SHAPES and Y at its twelve shapes, each
    exactly equal to its plain version, with the reference tools' inputs.
    Each output goes into `keep` (_keep)."""
    import numpy as np

    from blama_tpu_torch.ops import probes
    from blama_tpu_torch.tools.probe_casts import probe_input

    rows = []

    def row(name, shape, out, plain, kernel, plain_fn, library, nbytes, ops, rate):
        if isinstance(out, tuple):
            same = all(torch.equal(o, p) for o, p in zip(out, plain))
        else:
            same = torch.equal(out, plain)
        if not same:
            raise AssertionError(f"{name} {shape}: differs from its plain version")
        _keep(keep, name, shape, out)
        lib = dict(library_ms=None)
        if library:
            try:
                lib = _graph_row(timer, library, None)
                lib = dict(library_ms=lib["kernel_ms"], library_event_ms=lib["event_ms"])
            except RuntimeError as e:   # a yardstick the library refuses is left out
                log(f"probe {name} {shape}: library call refused: {e}")
        rows.append(dict(kernel=name, shape=shape, max_abs_err=0.0,
                         **_graph_row(timer, kernel, None),
                         plain_ms=timer(plain_fn, reps=3, warm=1), **lib,
                         **_bound(nbytes, ops, rate)))
        log(f"probe {rows[-1]}")

    for R, N in PROBE_SHAPES:
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.integers(0, 255, (R, N), dtype=np.uint8)).cuda()
        a = torch.from_numpy(rng.integers(-127, 127, (32, R), dtype=np.int8)).cuda()
        b8 = torch.from_numpy(rng.integers(-8, 8, (R, N), dtype=np.int8)).cuda()
        c8 = x[:R // 2]
        lohi = (x & 0x0F) + (x >> 4)          # the swar dot's operand, unpacked
        q8 = torch.cat([c8 & 0x0F, c8 >> 4]).to(torch.int8)
        tag = f"x {R}x{N}"
        for name, fn, plain, lib, nbytes in (
                ("swar_roundtrip", probes.swar_roundtrip, probes.swar_roundtrip_plain,
                 lambda: x.clone(), 2 * R * N),
                ("swar_lo_hi", probes.swar_lo_hi, probes.swar_lo_hi_plain, None, 3 * R * N),
                ("u8_bitops", probes.u8_bitops, probes.u8_bitops_plain, None, 2 * R * N),
                ("i16_bitops", probes.i16_bitops, probes.i16_bitops_plain, None, 2 * R * N)):
            row(name, tag, fn(x), plain(x), lambda fn=fn: fn(x), lambda p=plain: p(x), lib,
                nbytes, 3 * R * N, F32_FLOPS)
        M = 32
        for name, fn, plain, lhs, rhs, lib, K, n_dots in (
                ("swar_dot", probes.swar_dot, probes.swar_dot_plain, a, x,
                 lambda: torch._int_mm(a, lohi.to(torch.int8)), R, 2),
                ("i8_dot", probes.i8_dot, probes.i8_dot_plain, a, b8,
                 lambda: torch._int_mm(a, b8), R, 1),
                ("unpack_dot", probes.unpack_dot, probes.unpack_dot_plain, a, c8,
                 lambda: torch._int_mm(a, q8), R // 2, 2)):
            shape = f"a {M}x{lhs.shape[1]} b {K}x{N}"
            row(name, shape, fn(lhs, rhs), plain(lhs, rhs),
                lambda fn=fn, l=lhs, r=rhs: fn(l, r), lambda p=plain, l=lhs, r=rhs: p(l, r),
                lib, lhs.numel() + rhs.numel() + 4 * M * N, 2 * M * K * N * n_dots, INT8_OPS)
        del x, a, b8, c8, lohi, q8
    # kernel Y: the library call is the one torch op that does the probe's
    # copy (or cat, norm, matmul), where there is one; it must give the
    # probe's result. E is built beforehand, as lohi and q8 are above, and
    # f32 matmul runs without TF32 here, so E @ x is exact.
    sel = torch.arange(8, device="cuda")[None, :] == 2 * torch.arange(4, device="cuda")[:, None]
    E = sel.float()
    libs = {"lane_concat": lambda x: torch.cat([x[:, i * 128:(i + 1) * 128] for i in range(4)],
                                               dim=1),
            "group_max": lambda x: torch.linalg.vector_norm(x.view(8, 4, 32), ord=float("inf"),
                                                            dim=-1),
            "row_select_dot": lambda x: torch.matmul(E, x),
            "round_int8": None}
    for name, shape_in, shape_out, plain in probes.CASTS:
        x = torch.from_numpy(probe_input(name, shape_in)).cuda()
        lib = libs.get(name, lambda x, p=plain: p(x).clone())
        if lib is not None and not torch.equal(lib(x), probes.cast_plain(name, x)):
            raise AssertionError(f"casts_{name}: the library yardstick differs from the probe")
        n_in, n_out = x.numel(), int(np.prod(shape_out))
        row(f"casts_{name}", f"{shape_in} -> {shape_out}", probes.cast(name, x),
            probes.cast_plain(name, x), lambda n=name, x=x: probes.cast(n, x),
            lambda n=name, x=x: probes.cast_plain(n, x), lib and (lambda f=lib, x=x: f(x)),
            4 * (n_in + n_out), n_out, F32_FLOPS)
    return rows


def rows_mm_cost(torch):
    """Host ms per call of rows_mm (16-row blocks: a zeroed buffer, a copy,
    one [16, K] @ [K, N] product) against one plain product, at the exact
    engines' decode step shapes (the min term of each projection, M = 1)
    and the MoE router; the device synchronized after each run of calls."""
    from blama_tpu_torch.ops import quant_matmul as qm

    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    for label, (K, N) in (("wq/wo min", (128, 4096)), ("wk/wv min", (128, 1024)),
                          ("gate/up min", (128, 14336)), ("down min", (448, 4096)),
                          ("lm head min", (128, 128256)), ("MoE router", (4096, 8))):
        a = torch.randn((1, K), generator=gen, device="cuda")
        b = torch.randn((N, K), generator=gen, device="cuda").t()
        row = {}
        for name, fn in (("plain", lambda: a @ b), ("rows_mm", lambda: qm.rows_mm(a, b)),
                         ("plain again", lambda: a @ b)):
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            torch.cuda.synchronize()
            row[name] = 1e3 * (time.perf_counter() - t0) / 200
        out[label] = row
    log(f"rows_mm host ms per call at the decode step's shapes (plain a @ b beside): {out}")
    return out


def _sdpa_inputs(torch, k, v, ks, vs, pos, q_pos, inv, H, dtype=None):
    """Dequantized, pre-rotated dense rows with GQA heads expanded, in
    `dtype` (the queries': bf16, or f32 for the f32-query instances), and the
    boolean visibility mask, for the library yardstick."""
    dtype = dtype or torch.bfloat16
    B, S, Hkv, D = k.shape
    theta = pos.float()[:, :, None] * inv                       # [B, S, D]
    kf = k.float()
    sw = kf.reshape(B, S, Hkv, D // 2, 2).flip(-1).reshape(kf.shape)
    even = torch.arange(D, device=k.device) % 2 == 0
    sin = torch.sin(theta)[:, :, None, :]
    krot = kf * torch.cos(theta)[:, :, None, :] + sw * torch.where(even, -sin, sin)
    vf = v.float()
    if ks is not None:
        krot, vf = krot * ks[..., None], vf * vs[..., None]
    kd = krot.to(dtype).permute(0, 2, 1, 3)
    vd = vf.to(dtype).permute(0, 2, 1, 3)
    kd = kd.repeat_interleave(H // Hkv, dim=1).contiguous()
    vd = vd.repeat_interleave(H // Hkv, dim=1).contiguous()
    mask = (pos[:, None, None, :] >= 0) & (pos[:, None, None, :] <= q_pos[:, None, :, None])
    return kd, vd, mask


def _attn_row(torch, timer, name, label, kernel, plain, q, dense, q_pos, inv, extra_bytes):
    """Check one attention kernel against its plain version and time it
    beside its bound and the library yardstick. `dense` = (k, v, ks, vs,
    pos) is the logical [B, S, ...] view the queries attend to."""
    k, v, ks, vs, pos = dense
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    out = kernel()
    torch.cuda.synchronize()
    ref = plain()
    tol = F32Q_TOL if q.dtype == torch.float32 else ATTN_TOL
    err = check_close(f"{name} {label}", out, ref, tol)
    bound, bound_by, slots, pairs = _attn_bound_ms(q, k, ks, pos, q_pos, extra_bytes)
    kd, vd, mask = _sdpa_inputs(torch, k, v, ks, vs, pos, q_pos, inv, H, q.dtype)
    qh = q.permute(0, 2, 1, 3)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library = lambda: sdpa(qh, kd, vd, attn_mask=mask)   # noqa: E731
    row = dict(
        kernel=name, shape=f"{label} B={B} T={T} H={H} Hkv={Hkv} D={D} S={k.shape[1]} "
                           f"slots={slots} pairs={pairs}",
        max_abs_err=err, rel_err=err / ref.float().abs().max().item(), tol=tol,
        differ_share=(out != ref).float().mean().item(),
        kernel_ms=timer(kernel), plain_ms=timer(plain, reps=5, warm=1),
        library_ms=timer(library), bound_ms=bound, bound_by=bound_by)
    if T == 1:
        # a decode call is short: the single launch's event pair holds host
        # gaps, so the line carries the graph-timed figures (GraphTimer, the
        # L2 flushed before each call); the single-launch ones stay beside
        row.update(event_ms=row["kernel_ms"], library_event_ms=row["library_ms"],
                   kernel_ms=timer.graph(kernel, flush=True),
                   library_ms=timer.graph(library, flush=True))
    log(f"{name} {row}")
    return row, out


def attention_phase(torch, timer):
    """Kernels C, D (dense rows) and E, F (paged pool) against their plain
    versions at the 8B shapes, INT8, bf16 and f32; E and F must equal C and D
    bit for bit over the same logical rows under scrambled page placement."""
    from blama_tpu_torch.ops import decode_attention as da
    from blama_tpu_torch.ops import paged_attention as pa
    from blama_tpu_torch.ops import paged_kv as pkv

    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    H, Hkv, D = 32, 8, 128
    inv, mscale = da.effective_inv_freq(D, D, 500000.0)
    inv = inv.cuda()
    scale = D ** -0.5

    def rand_store(shape, tag):
        return _rand_store(torch, gen, shape, tag)

    # -- solo shape: one INT8 (then bf16) row at S=2048 with empty slots
    # and slots positioned past the queries ------------------------------------
    B, S = 1, 2048
    pos = torch.arange(S, dtype=torch.int32, device="cuda")[None].clone()
    pos[0, ::37] = -1
    pos[0, 1900:] = -1
    pos[0, 1200:1260] = 4000
    for tag in STORES:
        # one row at the 8B preset's full context, S = 8192
        pos_l = torch.arange(8192, dtype=torch.int32, device="cuda")[None].clone()
        pos_l[0, ::37] = -1
        kl, vl, ksl, vsl = rand_store((1, 8192, Hkv, D), tag)
        qp_l = torch.tensor([[8191]], dtype=torch.int32, device="cuda")
        q = torch.randn((1, 1, H, D), generator=gen, device="cuda").to(torch.bfloat16)
        rows.append(_attn_row(
            torch, timer, "decode_attention", f"full-context {tag}",
            lambda: da.decode_attention(q, kl, vl, qp_l[:, 0], pos_l, inv, ksl, vsl,
                                        mscale=mscale),
            lambda: da.flash_attention_plain(q, kl, vl, qp_l, pos_l, inv, ksl, vsl, scale),
            q, (kl, vl, ksl, vsl, pos_l), qp_l, inv, 0)[0])
        del kl, vl, ksl, vsl
        k, v, ks, vs = rand_store((B, S, Hkv, D), tag)
        dense = (k, v, ks, vs, pos)
        q_pos = torch.tensor([[1800]], dtype=torch.int32, device="cuda")
        q = torch.randn((B, 1, H, D), generator=gen, device="cuda").to(torch.bfloat16)
        rows.append(_attn_row(
            torch, timer, "decode_attention", f"solo {tag}",
            lambda: da.decode_attention(q, k, v, q_pos[:, 0], pos, inv, ks, vs, mscale=mscale),
            lambda: da.flash_attention_plain(q, k, v, q_pos, pos, inv, ks, vs, scale),
            q, dense, q_pos, inv, 0)[0])
        T = 128
        qp = torch.arange(1672, 1672 + T, dtype=torch.int32, device="cuda")[None]
        q = torch.randn((B, T, H, D), generator=gen, device="cuda").to(torch.bfloat16)
        row, out = _attn_row(
            torch, timer, "prefill_attention", f"solo {tag}",
            lambda: da.prefill_attention(q, k, v, qp, pos, inv, ks, vs, mscale=mscale),
            lambda: da.flash_attention_plain(q, k, v, qp, pos, inv, ks, vs, scale),
            q, dense, qp, inv, 0)
        rows.append(row)
        if tag == "int8":
            # a query's bits do not depend on its chunk: 16 chunks of 8
            chunks = [da.prefill_attention(q[:, i:i + 8].contiguous(), k, v,
                                           qp[:, i:i + 8].contiguous(), pos, inv, ks, vs,
                                           mscale=mscale) for i in range(0, T, 8)]
            if not torch.equal(torch.cat(chunks, dim=1), out):
                raise AssertionError("prefill_attention solo int8: T=128 differs from the "
                                     "same queries in 16 chunks of 8")
            log("prefill_attention solo int8: T=128 bit-identical to 16 chunks of 8")
            # the first TTFT-scale chunk: 512 tokens ending at the same place
            T = 512
            qp = torch.arange(1288, 1288 + T, dtype=torch.int32, device="cuda")[None]
            q = torch.randn((B, T, H, D), generator=gen, device="cuda").to(torch.bfloat16)
            rows.append(_attn_row(
                torch, timer, "prefill_attention", f"long {tag}",
                lambda: da.prefill_attention(q, k, v, qp, pos, inv, ks, vs, mscale=mscale),
                lambda: da.flash_attention_plain(q, k, v, qp, pos, inv, ks, vs, scale),
                q, dense, qp, inv, 0)[0])

    # -- serving shape: 8 rows on a scrambled pool, G=128, MP=16 ----------------
    B, G, MP, P = 8, 128, 16, 160
    S = MP * G
    lens = [300, 0, 1500, 2047, 129, 640, 256, 1000]     # row 1 is idle (no page)
    perm = torch.randperm(P, generator=torch.Generator().manual_seed(3)).tolist()
    table = torch.full((B, MP), -1, dtype=torch.int32)
    # pages no row owns hold live-looking positions: reading one would show
    pool_pos = torch.randint(0, 2048, (P, G), generator=torch.Generator().manual_seed(4),
                             dtype=torch.int32)
    for b, n in enumerate(lens):
        for lp in range(-(-n // G)):
            page = perm.pop()
            table[b, lp] = page
            p = torch.arange(lp * G, (lp + 1) * G, dtype=torch.int32)
            pool_pos[page] = torch.where(p < n, p, -1)
    pool_pos[table[2, 3], 5:40] = -1          # an edited position map: holes
    pool_pos[table[3, 7], 10:20] = 5000       # and slots past every query
    table, pool_pos = table.cuda(), pool_pos.cuda()
    for tag in ("bf16", "int8", "f32"):
        kp, vp, ksp, vsp = rand_store((P, G, Hkv, D), tag)
        # the logical rows, gathered: what kernels C and D read
        mapped = torch.repeat_interleave(table >= 0, G, dim=1)
        pos_v = torch.where(mapped, pool_pos.reshape(-1)[pkv.view_slot_map(table, G)],
                            -1).to(torch.int32).contiguous()
        kd, vd, ksd, vsd = _gather(pkv, table, G, kp, vp, ksp, vsp)
        dense = (kd, vd, ksd, vsd, pos_v)
        for T in (1, 8, 128, 256):
            if T == 1:
                qp = torch.tensor([[max(n - 1, 0)] for n in lens], dtype=torch.int32, device="cuda")
            else:
                qp = torch.stack([torch.arange(T, dtype=torch.int32) + max(n - T, 0)
                                  for n in lens]).cuda()
            q = torch.randn((B, T, H, D), generator=gen, device="cuda").to(torch.bfloat16)
            if T == 1:
                paged = lambda: pa.paged_decode_attention(          # noqa: E731
                    q, kp, vp, pool_pos, table, qp[:, 0], inv, ksp, vsp, mscale=mscale)
                dense_fn = lambda: da.decode_attention(             # noqa: E731
                    q, kd, vd, qp[:, 0], pos_v, inv, ksd, vsd, mscale=mscale)
                names = ("paged_decode_attention", "decode_attention")
            else:
                paged = lambda: pa.paged_prefill_attention(         # noqa: E731
                    q, kp, vp, pool_pos, table, qp, inv, ksp, vsp, mscale=mscale)
                dense_fn = lambda: da.prefill_attention(            # noqa: E731
                    q, kd, vd, qp, pos_v, inv, ksd, vsd, mscale=mscale)
                names = ("paged_prefill_attention", "prefill_attention")
            r_p, out_p = _attn_row(
                torch, timer, names[0], f"serving {tag}", paged,
                lambda: pa.paged_attention_plain(q, kp, vp, pool_pos, table, qp, inv,
                                                 ksp, vsp, scale),
                q, dense, qp, inv, table.numel() * 4)
            r_d, out_d = _attn_row(
                torch, timer, names[1], f"serving {tag}", dense_fn,
                lambda: da.flash_attention_plain(q, kd, vd, qp, pos_v, inv, ksd, vsd, scale),
                q, dense, qp, inv, 0)
            if not torch.equal(out_p, out_d):
                raise AssertionError(
                    f"{names[0]} {tag} T={T}: differs from {names[1]} over the same "
                    f"logical rows (max {(out_p.float() - out_d.float()).abs().max().item()})")
            if not (out_p[1] == 0).all():
                raise AssertionError(f"{names[0]} {tag} T={T}: idle row is not zero")
            log(f"{names[0]} {tag} T={T}: bit-identical to {names[1]} under scrambled pages")
            if T == 1:
                _decode_row_invariance(torch, da, pa, tag, q, kd, vd, ksd, vsd, pos_v, qp,
                                       inv, mscale, out_d, (kp, vp, ksp, vsp, pool_pos, table),
                                       out_p)
            if T > 1:
                # a row's bits do not depend on the batch: row 3 alone
                one = [None if a is None else a[3:4].contiguous()
                       for a in (q, kd, vd, qp, pos_v, ksd, vsd)]
                alone = da.prefill_attention(*one[:5], inv, *one[5:], mscale=mscale)
                if not torch.equal(alone, out_d[3:4]):
                    raise AssertionError(f"prefill_attention {tag} T={T}: row 3 alone differs "
                                         "from row 3 of the 8-row batch")
                log(f"prefill_attention {tag} T={T}: row 3 alone bit-identical to the batch's")
            if tag == "f32" and T > 1:
                # the f32 store stages V as two bf16 halves: against the
                # same store with V rounded to bf16 first (one bf16 V), its
                # outputs must leave the plain version's bits less often
                ref = da.flash_attention_plain(q, kd, vd, qp, pos_v, inv, ksd, vsd, scale)
                one_v = da.prefill_attention(q, kd, vd.to(torch.bfloat16).float(), qp, pos_v,
                                             inv, ksd, vsd, mscale=mscale)
                r_d.update(v_bf16_differ_share=(one_v != ref).float().mean().item(),
                           v_bf16_max_abs_err=(one_v.float() - ref.float()).abs().max().item())
                log(f"prefill_attention f32 T={T}: outputs off the plain version's bits "
                    f"{r_d['differ_share']:.5f} with V's two halves, "
                    f"{r_d['v_bf16_differ_share']:.5f} with V in bf16 (max error "
                    f"{r_d['max_abs_err']} / {r_d['v_bf16_max_abs_err']})")
                if not r_d["differ_share"] < r_d["v_bf16_differ_share"]:
                    raise AssertionError(f"prefill_attention f32 T={T}: V's low half did not "
                                         "bring the outputs closer to the plain version")
            rows += [r_p, r_d]
    return rows


def _decode_row_invariance(torch, da, pa, tag, q, kd, vd, ksd, vsd, pos, qp, inv, mscale,
                           out_d, pool, out_p):
    """Kernels C and E give a row the bits it has alone: row 3 of the 8-row
    decode step run alone, and alone with S padded from 2048 to 4096 by
    empty slots holding random K / V, equal its row of the batch; E's row 3
    alone (its page-table row) equals E's batch row."""
    one = [None if a is None else a[3:4].contiguous() for a in (q, kd, vd, qp, pos, ksd, vsd)]
    alone = da.decode_attention(one[0], one[1], one[2], one[3][:, 0], one[4], inv, *one[5:],
                                mscale=mscale)

    def padded(a):
        if a is None:
            return None
        extra = torch.full_like(a, -1) if a.dtype == torch.int32 else \
            (torch.rand_like(a.float()) * 100).to(a.dtype)
        return torch.cat([a, extra], dim=1).contiguous()

    long = da.decode_attention(one[0], padded(one[1]), padded(one[2]), one[3][:, 0],
                               padded(one[4]), inv, padded(one[5]), padded(one[6]),
                               mscale=mscale)
    kp, vp, ksp, vsp, pool_pos, table = pool
    paged = pa.paged_decode_attention(one[0], kp, vp, pool_pos, table[3:4].contiguous(),
                                      one[3][:, 0], inv, ksp, vsp, mscale=mscale)
    for what, got, want in (("C alone", alone, out_d[3:4]), ("C alone at S=4096", long, out_d[3:4]),
                            ("E alone", paged, out_p[3:4])):
        if not torch.equal(got, want):
            raise AssertionError(f"decode {tag}: row 3 {what} differs from its row of the "
                                 "8-row batch")
    log(f"decode {tag}: row 3 alone, alone at S=4096 and E's row alone bit-identical to "
        "the 8-row batch's")


def f32_query_attention_phase(torch, timer):
    """Kernels C, D, E and F at f32 queries (the float32 engine's
    instances, ops/csrc/attention_f32.cu) against their plain versions at
    the bf16 rows' 8B shapes on INT8, bf16 and f32 stores: one row at S =
    2048 (C at T = 1, D at T = 128), 8 rows on a scrambled pool of 128-slot
    pages (E at T = 1, F at T = 256), each beside f32 SDPA over the
    dequantized rows. E and F must equal C and D over the same logical rows
    bit for bit, a decode row (C and E) and a prefill row (D) alone their
    row of the 8-row batch, and the T = 128 chunk 16 chunks of 8; each
    wrapper must count its launches under its f32q name and launch no bf16
    instance."""
    from blama_tpu_torch.ops import decode_attention as da
    from blama_tpu_torch.ops import kernels
    from blama_tpu_torch.ops import paged_attention as pa

    gen = torch.Generator(device="cuda").manual_seed(12)
    rows = []
    H, Hkv, D = 32, 8, 128
    inv, mscale = da.effective_inv_freq(D, D, 500000.0)
    inv = inv.cuda()
    scale = D ** -0.5
    pos = torch.arange(2048, dtype=torch.int32, device="cuda")[None].clone()
    pos[0, ::37] = -1
    pos[0, 1900:] = -1
    pos[0, 1200:1260] = 4000
    B = 8
    kernels.reset_launches()
    for tag in STORES:
        # -- one row at S = 2048: C (T = 1) and D (T = 128) ---------------------
        k, v, ks, vs = _rand_store(torch, gen, (1, 2048, Hkv, D), tag)
        dense = (k, v, ks, vs, pos)
        qp1 = torch.tensor([[1800]], dtype=torch.int32, device="cuda")
        q = torch.randn((1, 1, H, D), generator=gen, device="cuda")
        rows.append(_attn_row(
            torch, timer, "decode_attention_f32q", f"solo {tag}",
            lambda: da.decode_attention(q, k, v, qp1[:, 0], pos, inv, ks, vs, mscale=mscale),
            lambda: da.flash_attention_plain(q, k, v, qp1, pos, inv, ks, vs, scale),
            q, dense, qp1, inv, 0)[0])
        T = 128
        qp = torch.arange(1672, 1672 + T, dtype=torch.int32, device="cuda")[None]
        q = torch.randn((1, T, H, D), generator=gen, device="cuda")
        row, out = _attn_row(
            torch, timer, "prefill_attention_f32q", f"solo {tag}",
            lambda: da.prefill_attention(q, k, v, qp, pos, inv, ks, vs, mscale=mscale),
            lambda: da.flash_attention_plain(q, k, v, qp, pos, inv, ks, vs, scale),
            q, dense, qp, inv, 0)
        rows.append(row)
        chunks = [da.prefill_attention(q[:, i:i + 8].contiguous(), k, v,
                                       qp[:, i:i + 8].contiguous(), pos, inv, ks, vs,
                                       mscale=mscale) for i in range(0, T, 8)]
        if out.dtype != torch.float32 or not torch.equal(torch.cat(chunks, dim=1), out):
            raise AssertionError(f"prefill_attention_f32q solo {tag}: T=128 differs from "
                                 "the same queries in 16 chunks of 8")
        del k, v, ks, vs, dense
        # -- 8 rows on a scrambled pool: E (T = 1) and F (T = 256) -------------
        lens, _, pool, dense = _serving_pool(torch, gen, tag, Hkv, D)
        kp, vp, ksp, vsp, pool_pos, table = pool
        kd, vd, ksd, vsd, pos_v = dense
        for T in (1, 256):
            if T == 1:
                qp = torch.tensor([[max(n - 1, 0)] for n in lens], dtype=torch.int32,
                                  device="cuda")
            else:
                qp = torch.stack([torch.arange(T, dtype=torch.int32) + max(n - T, 0)
                                  for n in lens]).cuda()
            q = torch.randn((B, T, H, D), generator=gen, device="cuda")
            if T == 1:
                paged = lambda: pa.paged_decode_attention(          # noqa: E731
                    q, kp, vp, pool_pos, table, qp[:, 0], inv, ksp, vsp, mscale=mscale)
                dense_fn = lambda: da.decode_attention(             # noqa: E731
                    q, kd, vd, qp[:, 0], pos_v, inv, ksd, vsd, mscale=mscale)
                name = "paged_decode_attention_f32q"
            else:
                paged = lambda: pa.paged_prefill_attention(         # noqa: E731
                    q, kp, vp, pool_pos, table, qp, inv, ksp, vsp, mscale=mscale)
                dense_fn = lambda: da.prefill_attention(            # noqa: E731
                    q, kd, vd, qp, pos_v, inv, ksd, vsd, mscale=mscale)
                name = "paged_prefill_attention_f32q"
            r_p, out_p = _attn_row(
                torch, timer, name, f"serving {tag}", paged,
                lambda: pa.paged_attention_plain(q, kp, vp, pool_pos, table, qp, inv,
                                                 ksp, vsp, scale),
                q, dense, qp, inv, table.numel() * 4)
            rows.append(r_p)
            out_d = dense_fn()
            if out_p.dtype != torch.float32 or not torch.equal(out_p, out_d):
                raise AssertionError(f"{name} {tag} T={T}: differs from the dense kernel "
                                     "over the same logical rows")
            if not (out_p[1] == 0).all():
                raise AssertionError(f"{name} {tag} T={T}: idle row is not zero")
            if T == 1:
                _decode_row_invariance(torch, da, pa, f"f32q {tag}", q, kd, vd, ksd, vsd,
                                       pos_v, qp, inv, mscale, out_d,
                                       pool, out_p)
            else:
                one = [None if a is None else a[3:4].contiguous()
                       for a in (q, kd, vd, qp, pos_v, ksd, vsd)]
                alone = da.prefill_attention(*one[:5], inv, *one[5:], mscale=mscale)
                if not torch.equal(alone, out_d[3:4]):
                    raise AssertionError(f"prefill_attention_f32q {tag} T={T}: row 3 alone "
                                         "differs from row 3 of the 8-row batch")
            log(f"{name} {tag} T={T}: bit-identical to the dense f32q kernel, row 3 alone "
                "equal to the batch's")
        del kp, vp, ksp, vsp, kd, vd, ksd, vsd, dense, pool
    torch.cuda.synchronize()
    launched = {n: kernels.LAUNCHES[n] for n in ("decode_attention_f32q",
                                                 "prefill_attention_f32q",
                                                 "paged_decode_attention_f32q",
                                                 "paged_prefill_attention_f32q",
                                                 "decode_attention", "prefill_attention",
                                                 "paged_decode_attention",
                                                 "paged_prefill_attention")}
    if any(launched[n] for n in launched if not n.endswith("_f32q")) or \
            not all(launched[n] for n in launched if n.endswith("_f32q")):
        raise AssertionError(f"f32-query phase launched {launched}")
    log(f"f32-query attention phase launches {launched}")
    _f32q_control(torch, gen, da, Hkv, H, D, pos, inv, mscale, scale)
    return rows


def _f32q_control(torch, gen, da, Hkv, H, D, pos, inv, mscale, scale):
    """F32Q_TOL tells an f32-grade answer from a bf16-grade one: the bf16
    instances of C and D on the f32 store, given the same f32 queries
    rounded to bf16, fall outside it against the f32 plain version."""
    k, v, _, _ = _rand_store(torch, gen, (1, 2048, Hkv, D), "f32")
    for T, fn in ((1, da.decode_attention), (128, da.prefill_attention)):
        qp = torch.arange(1672, 1672 + T, dtype=torch.int32, device="cuda")[None]
        q = torch.randn((1, T, H, D), generator=gen, device="cuda")
        ref = da.flash_attention_plain(q, k, v, qp, pos, inv, None, None, scale)
        out = fn(q.to(torch.bfloat16), k, v, qp[:, 0] if T == 1 else qp, pos, inv,
                 mscale=mscale).float()
        rel = ((out - ref).abs().max() / ref.abs().max()).item()
        if not rel > F32Q_TOL:
            raise AssertionError(f"f32-query control T={T}: the bf16 instance on bf16-rounded "
                                 f"queries is within F32Q_TOL ({rel})")
        log(f"f32-query control T={T}: the bf16 instance on rounded queries is {rel:.3g} "
            f"x max|ref| off, outside F32Q_TOL {F32Q_TOL}")


# head geometries the reference's fused gates admit beyond the 8B one: head
# dims that are not a padded width (Phi-2's 80, Phi-3's 96, open_llama_3b's
# 100) at 32 / 8 heads, and more than 32 query heads per kv head at D = 128
GEOMETRIES = ((32, 8, 80), (32, 8, 96), (32, 8, 100), (64, 1, 128), (33, 1, 128))


def geometry_phase(torch, timer):
    """Kernels C, D, E and F at GEOMETRIES on INT8, bf16 and f32 stores: the
    serving shape's 8 rows (S = 2048) on a scrambled pool of 128-slot pages,
    decode (T = 1) and a 128-token chunk, each within ATTN_TOL of its plain
    version, E equal to C and F to D bit for bit over the same logical rows."""
    from blama_tpu_torch.ops import decode_attention as da
    from blama_tpu_torch.ops import paged_attention as pa

    gen = torch.Generator(device="cuda").manual_seed(31)
    rows = []
    for H, Hkv, D in GEOMETRIES:
        inv, mscale = da.effective_inv_freq(D, D, 10000.0)
        inv = inv.cuda()
        scale = D ** -0.5
        for tag in STORES:
            lens, G, (kp, vp, ksp, vsp, pool_pos, table), (kd, vd, ksd, vsd, pos_v) = \
                _serving_pool(torch, gen, tag, Hkv, D)
            dense = (kd, vd, ksd, vsd, pos_v)
            label = f"geometry {tag}"
            for T in (1, 128):
                qp = torch.stack([torch.arange(T, dtype=torch.int32) + max(n - T, 0)
                                  for n in lens]).cuda()
                q = torch.randn((8, T, H, D), generator=gen, device="cuda").to(torch.bfloat16)
                if T == 1:
                    paged = lambda: pa.paged_decode_attention(          # noqa: E731
                        q, kp, vp, pool_pos, table, qp[:, 0], inv, ksp, vsp, mscale=mscale)
                    dense_fn = lambda: da.decode_attention(             # noqa: E731
                        q, kd, vd, qp[:, 0], pos_v, inv, ksd, vsd, mscale=mscale)
                    names = ("paged_decode_attention", "decode_attention")
                else:
                    paged = lambda: pa.paged_prefill_attention(         # noqa: E731
                        q, kp, vp, pool_pos, table, qp, inv, ksp, vsp, mscale=mscale)
                    dense_fn = lambda: da.prefill_attention(            # noqa: E731
                        q, kd, vd, qp, pos_v, inv, ksd, vsd, mscale=mscale)
                    names = ("paged_prefill_attention", "prefill_attention")
                r_p, out_p = _attn_row(
                    torch, timer, names[0], label, paged,
                    lambda: pa.paged_attention_plain(q, kp, vp, pool_pos, table, qp, inv, ksp,
                                                     vsp, scale),
                    q, dense, qp, inv, table.numel() * 4)
                r_d, out_d = _attn_row(
                    torch, timer, names[1], label, dense_fn,
                    lambda: da.flash_attention_plain(q, kd, vd, qp, pos_v, inv, ksd, vsd, scale),
                    q, dense, qp, inv, 0)
                if not torch.equal(out_p, out_d):
                    raise AssertionError(f"{names[0]} {label} T={T}: differs from {names[1]}")
                rows += [r_p, r_d]
            log(f"{label} H={H} Hkv={Hkv} D={D}: C, D within ATTN_TOL; E = C and F = D bit "
                "for bit")
            del kp, vp, ksp, vsp, kd, vd, ksd, vsd
            torch.cuda.empty_cache()
    return rows


def _serving_pool(torch, gen, tag, Hkv, D):
    """The serving shape's 8 rows (lengths `lens`, row 1 idle, holes and
    slots past every query) on a scrambled pool of 128-slot pages (16 a row)
    of store type `tag`, and the same logical rows gathered dense:
    (lens, G, pool (k, v, ks, vs, pool_pos, table), dense (k, v, ks, vs, pos))."""
    from blama_tpu_torch.ops import paged_kv as pkv

    B, G, MP, P = 8, 128, 16, 160
    lens = [300, 0, 1500, 2047, 129, 640, 256, 1000]
    perm = torch.randperm(P, generator=torch.Generator().manual_seed(3)).tolist()
    table = torch.full((B, MP), -1, dtype=torch.int32)
    pool_pos = torch.randint(0, 2048, (P, G), generator=torch.Generator().manual_seed(4),
                             dtype=torch.int32)
    for b, n in enumerate(lens):
        for lp in range(-(-n // G)):
            page = perm.pop()
            table[b, lp] = page
            p = torch.arange(lp * G, (lp + 1) * G, dtype=torch.int32)
            pool_pos[page] = torch.where(p < n, p, -1)
    pool_pos[table[2, 3], 5:40] = -1
    pool_pos[table[3, 7], 10:20] = 5000
    table, pool_pos = table.cuda(), pool_pos.cuda()
    kp, vp, ksp, vsp = _rand_store(torch, gen, (P, G, Hkv, D), tag)
    mapped = torch.repeat_interleave(table >= 0, G, dim=1)
    pos_v = torch.where(mapped, pool_pos.reshape(-1)[pkv.view_slot_map(table, G)],
                        -1).to(torch.int32).contiguous()
    kd, vd, ksd, vsd = _gather(pkv, table, G, kp, vp, ksp, vsp)
    return lens, G, (kp, vp, ksp, vsp, pool_pos, table), (kd, vd, ksd, vsd, pos_v)


# the fixed split widths the decode sweep weighs
DECODE_SPLITS = (64, 128, 256, 512, 1024)


def decode_split_sweep(torch, timer):
    """Kernel C under each fixed split width (the split moves a row's bits,
    so the width is one constant, ops/decode_attention.DECODE_SPLIT; the
    wrapper's `split=` is for this measurement): one row at S = 2048 and
    8192 (INT8) and the serving step's 8 rows (bf16), graph-timed with the
    L2 flushed; every width within ATTN_TOL of the plain version."""
    from blama_tpu_torch.ops import decode_attention as da

    gen = torch.Generator(device="cuda").manual_seed(9)
    H, Hkv, D = 32, 8, 128
    inv = da.effective_inv_freq(D, D, 500000.0)[0].cuda()
    lens = [300, 0, 1500, 2047, 129, 640, 256, 1000]
    cases = []
    for S in (2048, 8192):
        pos = torch.arange(S, dtype=torch.int32, device="cuda")[None].clone()
        pos[0, ::37] = -1
        cases.append(("solo int8", [S - 1], pos))
    pos8 = torch.full((8, 2048), -1, dtype=torch.int32)
    for b, n in enumerate(lens):
        pos8[b, :n] = torch.arange(n, dtype=torch.int32)
    cases.append(("serving bf16", [max(n - 1, 0) for n in lens], pos8.cuda()))
    rows = []
    for label, ends, pos in cases:
        B, S = pos.shape
        k, v, ks, vs = _rand_store(torch, gen, (B, S, Hkv, D), label.split()[1])
        q = torch.randn((B, 1, H, D), generator=gen, device="cuda").to(torch.bfloat16)
        qp = torch.tensor(ends, dtype=torch.int32, device="cuda")
        ref = da.flash_attention_plain(q, k, v, qp[:, None], pos, inv, ks, vs, D ** -0.5)
        ms = {}
        for split in DECODE_SPLITS:
            run = lambda w=split: da.decode_attention(q, k, v, qp, pos, inv, ks, vs,  # noqa
                                                      split=w)
            check_close(f"decode split {split} {label} S={S}", run(), ref, ATTN_TOL)
            ms[str(split)] = timer.graph(run, flush=True)
        rows.append(dict(shape=f"{label} B={B} S={S}", plan=str(da.DECODE_SPLIT), ms=ms))
        log(f"decode split sweep {rows[-1]}")
    return rows


def _attn_bound_ms(q, k, ks, pos, q_pos, extra_bytes=0):
    """The least time for one attention call: each visible slot's K and V
    (and scales) read once, the positions, q and the output, against the
    bf16 tensor rate for 4 H D flops a visible pair. An f32 query's products
    are f32-grade only on bf16 halves: Q K in three bf16 products (Q_hi K_hi,
    Q_hi K_lo, Q_lo K_hi) and P V in two (P_hi V, P_lo V; three with an f32
    store's V_lo), 2 H D flops each, at the same rate. Returns (ms, what
    bounds it, visible slots, visible pairs)."""
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    seen = (pos[:, None, :] >= 0) & (pos[:, None, :] <= q_pos[:, :, None])
    pairs, slots = int(seen.sum()), int(seen.any(1).sum())
    per_slot = Hkv * (2 * D * k.element_size() + (8 if ks is not None else 0))
    nbytes = slots * per_slot + pos.numel() * 4 + 2 * q.numel() * q.element_size() \
        + q_pos.numel() * 4 + D * 4 + extra_bytes
    products = (3 + 2 + (k.element_size() == 4)) if q.element_size() == 4 else 2
    t_b, t_o = nbytes / HBM_BYTES_PER_S, 2 * products * H * D * pairs / BF16_FLOPS
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations", slots, pairs


@contextlib.contextmanager
def _hb_mode(da):
    """Within it, `da` (a tree's decode_attention module) routes to kernel
    O as BLAMA_ATTN_HB would; on leaving, its mode is what it was."""
    was, da._HB = da._HB, True
    try:
        yield
    finally:
        da._HB = was


def _hb_partials(torch, da, q, k, v, ks, vs, pos, q_pos, inv, mscale):
    """Kernel O's split partials, f32 m and l [B, H, nsplit] and acc [B, H,
    nsplit, D] (the state its bf16 output rounds away), from the tree's own
    entry point: where the tree's module has no hb_plan (its first O picks
    the tile itself) the launch takes the split alone, else the split and
    hb_plan's tile and heads, its angles' scratch and its tickets. Returns
    them on the host."""
    import importlib

    kernels = importlib.import_module(da.__package__ + ".kernels")
    B, _, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    chunk = da.hb_split(S, D, Hkv, k.dtype, B)
    nsplit = -(-S // chunk)
    f32 = dict(dtype=torch.float32, device=q.device)
    pm, pl, pacc = (torch.full((B, H, nsplit), float("nan"), **f32),
                    torch.full((B, H, nsplit), float("nan"), **f32),
                    torch.full((B, H, nsplit, D), float("nan"), **f32))
    out = torch.empty_like(q)
    plan, ang, tickets = [chunk], [], []
    if hasattr(da, "hb_plan"):
        hp = da.hb_plan(B, H, Hkv, D, S, chunk)
        plan += [hp.ts, hp.heads]
        ang, tickets = [torch.empty(B * S * D, **f32)], [da.tickets(q.device, hp.grid[0])]
    rc = kernels.lib("decode_attention").decode_attention_hb_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), da.ptr(ks), da.ptr(vs), pos.data_ptr(),
        q_pos.data_ptr(), inv.data_ptr(), *[t.data_ptr() for t in ang], pm.data_ptr(),
        pl.data_ptr(), pacc.data_ptr(), *[t.data_ptr() for t in tickets], out.data_ptr(), B,
        H, Hkv, D, S, *plan, da.KV_TYPES[k.dtype], float((1.0 / (D ** 0.5)) * mscale),
        kernels.stream_ptr(q.device))
    kernels.check(rc, "decode_attention_hb partials")
    torch.cuda.synchronize()
    return pm.cpu(), pl.cpu(), pacc.cpu()


def decode_timing(torch, da, pa, copies: int = 24):
    """Kernels C, E, N, P and O at the 8B decode shapes (H32 / Hkv8 / D128)
    on INT8, bf16 and f32 stores, each timed four ways: `event_ms` (Timer: one
    host call between two events, L2 flushed before it), `graph_ms`
    (GraphTimer over `copies` copies of the store: device time per call, no
    host gap, cold L2), `graph_flushed_ms` (GraphTimer over one copy, the L2
    flushed before each call: the figure the kernel line carries) and
    `graph_warm_ms` (one copy, no flush: L2 warm), beside the bound and SDPA
    over the dequantized rows (graph-timed over four copies, and
    event-timed); and kernel D at one row x T = 128 and 8 rows x T = 128 /
    256, event-timed as its kernel rows are. `da` and `pa` are the dense and
    paged attention modules, so the same timing runs on another tree's
    kernels. Shapes: one row at S = 2048 (1694 visible) and S = 8192; 8 rows
    (5827 visible) dense (C and O) and on a scrambled pool of 128-slot pages
    (E); N and P at the modes phase's one row and 8 rows (one a pad row); O
    (head-batched, BLAMA_ATTN_HB) on C's inputs. Inputs come from fixed
    seeds, so two trees' outputs can be compared: returns (rows, {label:
    output on the host}), O's split partials (f32) beside its outputs."""
    from blama_tpu_torch.ops import paged_kv as pkv

    timer = Timer(torch)
    gtimer = timer.graph
    gen = torch.Generator(device="cuda").manual_seed(21)
    H, Hkv, D = 32, 8, 128
    inv, mscale = da.effective_inv_freq(D, D, 500000.0)
    inv = inv.cuda()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows, outs = [], {}

    def one_row(S):
        pos = torch.arange(S, dtype=torch.int32, device="cuda")[None].clone()
        if S == 2048:
            pos[0, ::37] = -1
            pos[0, 1900:] = -1
            pos[0, 1200:1260] = 4000
            return pos, torch.tensor([1800], dtype=torch.int32, device="cuda")
        pos[0, ::37] = -1
        return pos, torch.tensor([S - 1], dtype=torch.int32, device="cuda")

    lens = [300, 0, 1500, 2047, 129, 640, 256, 1000]

    def eight_rows():
        pos = torch.full((8, 2048), -1, dtype=torch.int32)
        for b, n in enumerate(lens):
            pos[b, :n] = torch.arange(n, dtype=torch.int32)
        pos[2, 3 * 128 + 5:3 * 128 + 40] = -1       # holes
        pos[3, 7 * 128 + 10:7 * 128 + 20] = 5000    # slots past every query
        return pos.cuda(), torch.tensor([max(n - 1, 0) for n in lens], dtype=torch.int32,
                                        device="cuda")

    def record(label, kernel_name, run, q, store, pos, q_pos, extra_bytes=0, sdpa_rows=None,
               parts=None):
        """`run(i)` calls the kernel on copy i; `store` = (k, ks) of copy 0;
        `parts()` gives kernel O's partials on copy 0."""
        calls = [lambda i=i: run(i) for i in range(copies)]
        bound, by, slots, _ = _attn_bound_ms(q, store[0], store[1], pos, q_pos[:, None],
                                             extra_bytes)
        shape = f"{label} B={q.shape[0]} S={pos.shape[1]} slots={slots}"
        out = run(0)
        torch.cuda.synchronize()
        outs[f"{kernel_name} {shape}"] = out.cpu()
        if parts is not None:
            outs[f"{kernel_name} {shape} partials"] = parts()
        row = dict(kernel=kernel_name, shape=shape,
                   event_ms=timer(lambda: run(0)), graph_ms=gtimer(calls, flush=False),
                   graph_flushed_ms=gtimer(lambda: run(0), flush=True),
                   graph_warm_ms=gtimer([lambda: run(0)] * copies, flush=False),
                   bound_ms=bound, bound_by=by)
        if sdpa_rows is not None:
            qh = q.permute(0, 2, 1, 3)
            row["library_event_ms"] = timer(lambda: sdpa(qh, *sdpa_rows[0]))
            row["library_graph_ms"] = gtimer(
                [lambda i=i: sdpa(qh, *sdpa_rows[i % len(sdpa_rows)]) for i in range(copies)],
                flush=False)
        log(f"decode timing {row}")
        rows.append(row)

    def sdpa_of(k, v, ks, vs, pos, q_pos):
        return _sdpa_inputs(torch, k, v, ks, vs, pos, q_pos[:, None], inv, H)

    for tag in STORES:
        # C, one row at S = 2048 and at the preset's full context, S = 8192
        for S in (2048, 8192):
            pos, q_pos = one_row(S)
            stores = [_rand_store(torch, gen, (1, S, Hkv, D), tag) for _ in range(copies)]
            q = torch.randn((1, 1, H, D), generator=gen, device="cuda").to(torch.bfloat16)
            run = lambda i, q=q, pos=pos, q_pos=q_pos, st=stores: da.decode_attention(  # noqa
                q, st[i][0], st[i][1], q_pos, pos, inv, st[i][2], st[i][3], mscale=mscale)
            lib = [sdpa_of(*st, pos, q_pos) for st in stores[:4]]
            record(f"solo {tag}", "decode_attention", run, q, (stores[0][0], stores[0][2]),
                   pos, q_pos, sdpa_rows=lib)
            with _hb_mode(da):
                record(f"solo {tag}", "decode_attention_hb", run, q,
                       (stores[0][0], stores[0][2]), pos, q_pos, sdpa_rows=lib,
                       parts=lambda q=q, pos=pos, q_pos=q_pos, st=stores[0]: _hb_partials(
                           torch, da, q, st[0], st[1], st[2], st[3], pos, q_pos, inv, mscale))
            del stores, lib
        # C (dense rows) and E (the same logical rows on a scrambled pool), 8 rows
        pos, q_pos = eight_rows()
        q = torch.randn((8, 1, H, D), generator=gen, device="cuda").to(torch.bfloat16)
        dense = [_rand_store(torch, gen, (8, 2048, Hkv, D), tag) for _ in range(copies)]
        run = lambda i, q=q, pos=pos, q_pos=q_pos, st=dense: da.decode_attention(  # noqa
            q, st[i][0], st[i][1], q_pos, pos, inv, st[i][2], st[i][3], mscale=mscale)
        lib = [sdpa_of(*st, pos, q_pos) for st in dense[:4]]
        record(f"serving {tag}", "decode_attention", run, q, (dense[0][0], dense[0][2]), pos,
               q_pos, sdpa_rows=lib)
        with _hb_mode(da):
            record(f"serving {tag}", "decode_attention_hb", run, q, (dense[0][0], dense[0][2]),
                   pos, q_pos, sdpa_rows=lib,
                   parts=lambda q=q, pos=pos, q_pos=q_pos, st=dense[0]: _hb_partials(
                       torch, da, q, st[0], st[1], st[2], st[3], pos, q_pos, inv, mscale))
        del lib
        G, MP, P = 128, 16, 160
        perm = torch.randperm(P, generator=torch.Generator().manual_seed(3)).tolist()
        table = torch.full((8, MP), -1, dtype=torch.int32)
        for b, n in enumerate(lens):
            for lp in range(-(-n // G)):
                table[b, lp] = perm.pop()
        table = table.cuda()
        slot_map = pkv.view_slot_map(table, G).reshape(-1)
        mapped = torch.repeat_interleave(table >= 0, G, dim=1).reshape(-1)
        pool_pos = torch.full((P * G,), -1, dtype=torch.int32, device="cuda")
        pool_pos[slot_map[mapped]] = pos.reshape(-1)[mapped]
        pool_pos = pool_pos.view(P, G)
        pools = []
        for k, v, ks, vs in dense:
            out = []
            for t in (k, v, ks, vs):
                if t is None:
                    out.append(None)
                    continue
                flat = torch.zeros((P * G, *t.shape[2:]), dtype=t.dtype, device="cuda")
                flat[slot_map[mapped]] = t.reshape(-1, *t.shape[2:])[mapped]
                out.append(flat.view(P, G, *t.shape[2:]))
            pools.append(out)
        del dense
        run = lambda i, q=q, q_pos=q_pos, pl=pools, tb=table, pp=pool_pos: (  # noqa: E731
            pa.paged_decode_attention(q, pl[i][0], pl[i][1], pp, tb, q_pos, inv, pl[i][2],
                                      pl[i][3], mscale=mscale))
        record(f"serving {tag}", "paged_decode_attention", run, q, (pools[0][0], pools[0][2]),
               pos, q_pos, extra_bytes=table.numel() * 4)
        del pools
        # N and P at the modes phase's shapes: the fresh row at its slot
        for mlens in ([1694], [300, 1500, 2047, 129, 640, 256, 1000, None]):
            B, S = len(mlens), 2048
            slot = torch.tensor([S if n is None else n for n in mlens], dtype=torch.int32,
                                device="cuda")
            q_pos = torch.where(slot < S, slot, 0)
            pos = torch.full((B, S), -1, dtype=torch.int32)
            for b, n in enumerate(mlens):
                if n:
                    pos[b, :n + 1] = torch.arange(n + 1, dtype=torch.int32)
            pos[:, 7::37] = -1
            pos = pos.cuda()
            stores = [_rand_store(torch, gen, (B * S + 1, Hkv, D), tag) for _ in range(copies)]
            kn, vn = (torch.randn((B, Hkv, D), generator=gen, device="cuda").to(torch.bfloat16)
                      for _ in range(2))
            q = torch.randn((B, 1, H, D), generator=gen, device="cuda").to(torch.bfloat16)

            def rows_of(t):
                return None if t is None else t[:B * S].view(B, S, *t.shape[1:])

            fresh = lambda i, q=q, pos=pos, q_pos=q_pos, st=stores, kn=kn, vn=vn, sl=slot: (  # noqa
                da.decode_attention(q, rows_of(st[i][0]), rows_of(st[i][1]), q_pos, pos, inv,
                                    rows_of(st[i][2]), rows_of(st[i][3]), mscale=mscale,
                                    k_new=kn, v_new=vn, slot=sl))
            write = lambda i, q=q, pos=pos, q_pos=q_pos, st=stores, kn=kn, vn=vn, sl=slot: (  # noqa
                da.decode_attention_write(q, st[i][0], st[i][1], q_pos, pos, inv, kn, vn, sl,
                                          st[i][2], st[i][3], mscale=mscale))
            row_bytes = 2 * B * Hkv * D * 2
            k0, ks0 = rows_of(stores[0][0]), rows_of(stores[0][2])
            record(f"modes {tag}", "decode_attention_fresh", fresh, q, (k0, ks0), pos, q_pos,
                   extra_bytes=row_bytes)
            written = 2 * B * Hkv * (D * k0.element_size() + (4 if ks0 is not None else 0))
            record(f"modes {tag}", "decode_attention_write", write, q, (k0, ks0), pos, q_pos,
                   extra_bytes=row_bytes + written)
            del stores
        torch.cuda.empty_cache()
    # D (dense prefill) at the kernel phase's shapes and F on the serving
    # pool, event-timed as their kernel rows are, their outputs kept: the
    # same measurement and outputs on another tree's kernels
    for tag in STORES:
        for B, T in ((1, 128), (8, 128), (8, 256)):
            pos, _ = eight_rows() if B == 8 else one_row(2048)
            k, v, ks, vs = _rand_store(torch, gen, (B, 2048, Hkv, D), tag)
            ends = lens if B == 8 else [1800]
            qp = torch.stack([torch.arange(T, dtype=torch.int32) + max(n - T, 0)
                              for n in ends]).cuda()
            q = torch.randn((B, T, H, D), generator=gen, device="cuda").to(torch.bfloat16)
            fn = lambda: da.prefill_attention(q, k, v, qp, pos, inv, ks, vs,  # noqa: E731
                                              mscale=mscale)
            row = dict(kernel="prefill_attention", shape=f"{tag} B={B} T={T} S=2048",
                       event_ms=timer(fn))
            outs[f"prefill_attention {row['shape']}"] = fn().cpu()
            log(f"decode timing {row}")
            rows.append(row)
        ends, _, (kp, vp, ksp, vsp, pool_pos, table), _ = _serving_pool(torch, gen, tag, Hkv, D)
        for T in (128, 256):
            qp = torch.stack([torch.arange(T, dtype=torch.int32) + max(n - T, 0)
                              for n in ends]).cuda()
            q = torch.randn((8, T, H, D), generator=gen, device="cuda").to(torch.bfloat16)
            fn = lambda: pa.paged_prefill_attention(q, kp, vp, pool_pos, table, qp,  # noqa: E731
                                                    inv, ksp, vsp, mscale=mscale)
            row = dict(kernel="paged_prefill_attention", shape=f"{tag} B=8 T={T} G=128",
                       event_ms=timer(fn))
            outs[f"paged_prefill_attention {row['shape']}"] = fn().cpu()
            log(f"decode timing {row}")
            rows.append(row)
    return rows, outs


def _equal_to_kept(torch, outs, keep: Path, name: str) -> dict:
    """Keep `outs` (label -> a tensor or a tuple of them, on the host) as
    keep/<name>.pt, and hold them with torch.equal against every other
    tree's kept there: {tree: {equal, of, differ}}."""
    keep.mkdir(parents=True, exist_ok=True)
    torch.save(outs, keep / f"{name}.pt")

    def same(a, b):
        if isinstance(a, tuple):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        return torch.equal(a, b)

    equal_to = {}
    for other in sorted(keep.glob("*.pt")):
        if other.stem == name:
            continue
        theirs = torch.load(other)
        shared = [k for k in outs if k in theirs]
        differ = [k for k in shared if not same(outs[k], theirs[k])]
        equal_to[other.stem] = dict(equal=len(shared) - len(differ), of=len(outs),
                                    differ=differ)
        log(f"outputs equal to tree {other.stem}'s: {len(shared) - len(differ)} of "
            f"{len(outs)} ({len(shared)} in both); differ: {differ}")
    return equal_to


def decode_timing_main(root: str) -> int:
    """`python3 chip_smoke.py --decode-timing ROOT`: decode_timing on the
    kernels of the tree at ROOT (this tree: `.`), results printed and written
    to chiprun_out/decode_timing-<name of ROOT>.json; the outputs (and O's
    partials) are kept in build/decode_outputs/<name>.pt beside this script,
    and held with torch.equal against every other tree's kept there (run
    the trees in one call: parent, change, change, parent)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    root = Path(root).resolve()
    sys.path.insert(0, str(root))
    from blama_tpu_torch.ops import decode_attention as da
    from blama_tpu_torch.ops import kernels
    from blama_tpu_torch.ops import paged_attention as pa

    if not Path(da.__file__).resolve().is_relative_to(root):
        raise AssertionError(f"imported {da.__file__}, not the tree at {root}")
    smi = nvidia_smi()
    log(smi)
    build_s = kernels.build_all()
    log(f"kernels of {root} built in {build_s:.1f} s")
    clocks = lambda: subprocess.run(  # noqa: E731
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60).stdout.strip()
    before = clocks()
    with torch.no_grad():
        rows, outs = decode_timing(torch, da, pa)
    equal_to = _equal_to_kept(torch, outs, ROOT / "build" / "decode_outputs", root.name)
    out = dict(nvidia_smi=smi, tree=str(root), build_s=build_s,
               clocks_before=before, clocks_after=clocks(), rows=rows, equal_to=equal_to)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"decode_timing-{root.name}.json").write_text(json.dumps(out, indent=1))
    log(f"clocks (sm, mem, power, temperature) before / after: {before} / {out['clocks_after']}")
    return 0


# --matmul-timing: the row counts of the 8B shapes, Mixtral's bank cases
# (rows, selected experts) and kernel M's row counts at TP_BLOCKS K-blocks
MATMUL_ROWS = (1, 2, 4, 8, 16)
BANK_CASES = ((1, 2), (8, 2), (4, 8), (8, 8))
PARTS_ROWS = (1, 4, 8)


def matmul_timing(torch, qm):
    """Kernels A, I, J and M of the tree whose quant_matmul module is `qm`,
    then the one-row calls of B, G, H, K and L (one_row_timing), through the
    calls every tree with kernels L and M has (w4a8_matmul, a8k4_matmul,
    w4a8_bank_matmul, a8s_matmul_parts): A and I at the five 8B shapes and
    MATMUL_ROWS rows (the lm head on f32 x, as forward feeds it), J at
    Mixtral-8x7B's banks (BANK_CASES; down with one input per expert), M on
    wo and down at TP_BLOCKS K-blocks. Each graph-timed (GraphTimer: the
    calls in one CUDA graph, the L2 flushed before each, median per call)
    beside the graph-timed bf16 library call over the dequantized weights
    (torch.bmm over the selected experts for J) and the byte bound (the
    weights as the kernel reads them, x and out). Inputs come from fixed
    seeds, so two trees' outputs can be compared: returns (rows, {label:
    output on the host})."""
    import hashlib

    import numpy as np

    timer = Timer(torch)
    rng = np.random.default_rng(12)
    gen = torch.Generator(device="cuda").manual_seed(12)
    rows, outs = [], {}

    def record(kernel, shape, fn, library, nbytes, ops):
        out = fn()
        torch.cuda.synchronize()
        host = out.cpu()
        outs[f"{kernel} {shape}"] = host
        rows.append(dict(kernel=kernel, shape=shape,
                         kernel_ms=timer.graph(fn, flush=True),
                         library_ms=timer.graph(library, flush=True),
                         **_bound(nbytes, ops, INT8_OPS),
                         sha256=hashlib.sha256(host.numpy().tobytes()).hexdigest()))
        log(f"matmul timing {rows[-1]}")

    for label, (K, N) in SHAPES.items():
        q4k = random_q4k(rng, N, K, K ** -0.5)
        a8 = qm.repack_q4k_a8s(q4k, N, K, "cuda")
        k4 = qm.repack_q4k_a8k4(q4k, N, K, "cuda")
        wb = qm.dequantize(a8).to(torch.bfloat16)
        wk = qm.dequantize(k4).to(torch.bfloat16)
        x16 = torch.randn((16, K), generator=gen, device="cuda").to(torch.bfloat16)
        if label == "lm_head":
            x16 = x16.float()
        for M in MATMUL_ROWS:
            x = x16[:M].contiguous()
            xb = x.to(torch.bfloat16)
            io = M * K * x.element_size() + M * N * 4
            shape = f"{label} K={K} N={N} M={M}"
            record("w4a8_gemv", shape, lambda: qm.w4a8_matmul(x, a8),
                   lambda: torch.matmul(xb, wb.t()), K * N // 2 + 4 * (K // 32) * N + io,
                   2 * M * K * N)
            record("w4a8k4_gemv", shape, lambda: qm.a8k4_matmul(x, k4),
                   lambda: torch.matmul(xb, wk.t()), (K // 256) * 144 * N + io, 2 * M * K * N)
        del a8, k4, wb, wk
        torch.cuda.empty_cache()
    for label, (K, N) in MOE_SHAPES.items():
        bank = qm.repack_q4k_bank(random_q4k(rng, MOE_EXPERTS * N, K, K ** -0.5),
                                  MOE_EXPERTS, N, K, True, "cuda")
        per = label == "down"
        x8 = torch.randn((MOE_EXPERTS, 8, K), generator=gen, device="cuda").to(torch.bfloat16)
        for M, n_sel in BANK_CASES:
            sel = [1, 6] if n_sel == 2 else list(range(MOE_EXPERTS))
            eids = torch.tensor(sel, dtype=torch.int32, device="cuda")
            x = x8[sel, :M].contiguous() if per else x8[0, :M].contiguous()
            xl = x if per else x.expand(n_sel, M, K).contiguous()
            wsel = torch.stack([qm.dequantize(bank.expert(e)) for e in sel]).to(torch.bfloat16)
            record("w4a8_bank_gemv", f"{label} K={K} N={N} M={M} sel={n_sel}",
                   lambda: qm.w4a8_bank_matmul(x, bank, eids),
                   lambda: torch.bmm(xl, wsel.transpose(1, 2)),
                   n_sel * (K * N // 2 + 4 * (K // 32) * N) + x.numel() * 2 + n_sel * M * N * 4,
                   2 * M * K * N * n_sel)
            del wsel
        del bank
        torch.cuda.empty_cache()
    for label in ("wq/wo", "down"):
        K, N = SHAPES[label]
        a8 = qm.repack_q4k_a8s(random_q4k(rng, N, K, K ** -0.5), N, K, "cuda")
        wb = qm.dequantize(a8).to(torch.bfloat16)
        x8 = torch.randn((8, K), generator=gen, device="cuda").to(torch.bfloat16)
        for M in PARTS_ROWS:
            x = x8[:M].contiguous()
            record("w4a8_parts_gemv", f"{label} K={K} N={N} M={M} nb={TP_BLOCKS}",
                   lambda: qm.a8s_matmul_parts(x, a8, TP_BLOCKS), lambda: torch.matmul(x, wb.t()),
                   K * N // 2 + 4 * (K // 32) * N + M * K * 2 + TP_BLOCKS * M * N * 4,
                   2 * M * K * N)
        del a8, wb
        torch.cuda.empty_cache()
    one_row_timing(torch, qm, timer, outs, rows)
    return rows, outs


def one_row_timing(torch, qm, timer, outs, rows):
    """The one-row calls of kernels B, G, H, K and L (matmul_timing's one-row
    lines), through entry points every tree with kernel L has: B (q4k_pos) on
    f32 scales at the five 8B shapes and on bf16 scales at the lm head, G
    (q8_0_matmul) at scale groups 32 and 16, H (q4k_native_matmul), L
    (q4k_matmul_pinned at the five shapes, q4k_matmul_parts at TP_BLOCKS on
    wo and down), K (q4k_bank_matmul, f32 scales, Mixtral-8x7B's banks over
    two selected experts, down with one input per expert). x bf16, the lm
    head's f32, as forward feeds them. Each line: the kernel, the f32
    library call that computes the same function (torch.matmul over the f32
    weights, TF32 off; torch.bmm over the K-blocks or the selected experts)
    and the bf16 one, all graph-timed (GraphTimer, the L2 flushed before each
    call, median per call); bound_f32_ms (bytes, f32 operations or the
    chain); the output's sha256, the output kept in `outs`."""
    import hashlib

    import numpy as np

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the f32 yardstick needs TF32 off")
    rng = np.random.default_rng(14)
    gen = torch.Generator(device="cuda").manual_seed(14)

    def record(kernel, shape, fn, wf, xf, nbytes, ops, chain):
        """wf: the f32 weights [N, K] or [n, N, K] (then xf [n, 1, K])."""
        out = fn()
        torch.cuda.synchronize()
        host = out.cpu()
        outs[f"{kernel} {shape}"] = host
        wbf, xbf = wf.to(torch.bfloat16), xf.to(torch.bfloat16)
        if wf.dim() == 2:
            lib32, lib16 = (lambda: torch.matmul(xf, wf.t())), (lambda: torch.matmul(xbf, wbf.t()))
        else:
            lib32 = lambda: torch.bmm(xf, wf.transpose(1, 2))  # noqa: E731
            lib16 = lambda: torch.bmm(xbf, wbf.transpose(1, 2))  # noqa: E731
        rows.append(dict(kernel=kernel, shape=shape, kernel_ms=timer.graph(fn, flush=True),
                         library_f32_ms=timer.graph(lib32, flush=True),
                         library_ms=timer.graph(lib16, flush=True),
                         **_bound_f32(nbytes, ops, chain),
                         sha256=hashlib.sha256(host.numpy().tobytes()).hexdigest()))
        del wbf
        log(f"matmul timing {rows[-1]}")

    for label, (K, N) in SHAPES.items():
        sigma = K ** -0.5
        head = label == "lm_head"
        x = torch.randn((1, K), generator=gen, device="cuda").to(torch.bfloat16)
        if head:
            x = x.float()
        xf, io = x.float(), K * x.element_size() + N * 4
        shape = f"{label} K={K} N={N} M=1"
        q4k = random_q4k(rng, N, K, sigma)
        exact = qm.repack_q4k_exact(q4k, N, K, "cuda")
        wf = qm._q4k_values(exact)
        record("q4k_dequant_matmul_f32", shape, lambda: qm.q4k_pos(x, exact), wf, xf,
               K * N // 2 + 4 * (K // 32) * N + io, 2 * K * N, K)
        if head:
            a8 = qm.repack_q4k_a8s(q4k, N, K, "cuda")
            record("q4k_dequant_matmul", shape, lambda: qm.q4k_pos(x, a8), qm._q4k_values(a8),
                   xf, K * N // 2 + 2 * (K // 32) * N + io, 2 * K * N, K)
            del a8
        del wf
        wf = qm.dequantize(exact)
        record("q4k_parts_matmul", f"{shape} nb=1", lambda: qm.q4k_matmul_pinned(x, exact), wf,
               xf, K * N // 2 + 8 * (K // 32) * N + io, 2 * K * N, K + K // 32)
        del wf
        native = qm.repack_q4k_native(q4k, N, K, "cuda")
        wf = qm.dequantize(native)
        record("q4k_native_matmul", shape, lambda: qm.q4k_native_matmul(x, native), wf, xf,
               (K // 256) * 144 * N + io, 2 * K * N, K + K // 32)
        del native, wf, exact, q4k
        for group, w in ((32, qm.repack_q8_0(random_q8_0(rng, N, K, sigma), N, K, "cuda")),
                         (16, qm.repack_q6_k_expanded(random_q6_k(rng, N, K, sigma), N, K,
                                                      "cuda"))):
            wf = qm.dequantize(w)
            record(f"q8_dequant_matmul_g{group}", shape, lambda: qm.q8_0_matmul(x, w), wf, xf,
                   K * N + 4 * (K // group) * N + io, 2 * K * N, K)
            del wf, w
        torch.cuda.empty_cache()
    for label in ("wq/wo", "down"):   # L's partials: the tp_blocks mode's wo and w_down
        K, N = SHAPES[label]
        nb, kb = TP_BLOCKS, K // TP_BLOCKS
        exact = qm.repack_q4k_exact(random_q4k(rng, N, K, K ** -0.5), N, K, "cuda")
        x = torch.randn((1, K), generator=gen, device="cuda").to(torch.bfloat16)
        wf = qm.dequantize(exact).reshape(N, nb, kb).transpose(0, 1).contiguous()
        xf = x.float().reshape(1, nb, kb).transpose(0, 1).contiguous()
        record("q4k_parts_matmul", f"{label} K={K} N={N} M=1 nb={nb}",
               lambda: qm.q4k_matmul_parts(x, exact, nb), wf, xf,
               K * N // 2 + 8 * (K // 32) * N + K * 2 + nb * N * 4, 2 * K * N, kb + kb // 32)
        del exact, wf
        torch.cuda.empty_cache()
    two = [1, 6]
    eids = torch.tensor(two, dtype=torch.int32, device="cuda")
    for label, (K, N) in MOE_SHAPES.items():   # K: the routed decode step
        per = label == "down"
        bank = qm.repack_q4k_bank(random_q4k(rng, MOE_EXPERTS * N, K, K ** -0.5),
                                  MOE_EXPERTS, N, K, False, "cuda")
        x = torch.randn((2, 1, K) if per else (1, K), generator=gen, device="cuda") \
            .to(torch.bfloat16)
        wf = torch.stack([qm.dequantize(bank.expert(e)) for e in two])
        xf = (x if per else x.expand(2, 1, K)).float().contiguous()
        record("q4k_bank_matmul", f"{label} K={K} N={N} M=1 sel=2 scales=f32",
               lambda: qm.q4k_bank_matmul(x, bank, eids), wf, xf,
               2 * (K * N // 2 + 8 * (K // 32) * N) + x.numel() * 2 + 2 * N * 4,
               2 * 2 * K * N, K + K // 32)
        del bank, wf
        torch.cuda.empty_cache()


def matmul_timing_main(root: str) -> int:
    """`python3 chip_smoke.py --matmul-timing ROOT`: matmul_timing on the
    kernels of the tree at ROOT (this tree: `.`), results written to
    chiprun_out/matmul_timing-<name of ROOT>.json; the outputs are kept in
    build/matmul_outputs/<name>.pt beside this script, and held with
    torch.equal against every other tree's kept there (run the trees in one
    call: parent, change, change, parent)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    root = Path(root).resolve()
    sys.path.insert(0, str(root))
    from blama_tpu_torch.ops import kernels
    from blama_tpu_torch.ops import quant_matmul as qm

    if not Path(qm.__file__).resolve().is_relative_to(root):
        raise AssertionError(f"imported {qm.__file__}, not the tree at {root}")
    smi = nvidia_smi()
    log(smi)
    build_s = kernels.build_all()
    log(f"kernels of {root} built in {build_s:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        rows, outs = matmul_timing(torch, qm)
    equal_to = _equal_to_kept(torch, outs, ROOT / "build" / "matmul_outputs", root.name)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"matmul_timing-{root.name}.json").write_text(json.dumps(
        dict(nvidia_smi=smi, tree=str(root), build_s=build_s, rows=rows, equal_to=equal_to),
        indent=1))
    return 0


def tools_timing_main(root: str) -> int:
    """`python3 chip_smoke.py --tools-timing ROOT`: the tools' kernels Q-Y of
    the tree at ROOT (this tree: `.`) through tools_kernel_phase,
    ubench_kernel_phase and probes_kernel_phase (the kernel phase's shapes,
    inputs from fixed seeds, each output held equal to its plain version,
    kernel and library graph-timed with the L2 flushed; U beside the f32
    `torch.matmul` that computes its function), results written to
    chiprun_out/tools_timing-<name of ROOT>.json; the outputs are kept in
    build/tools_outputs/<name>.pt beside this script, and held with
    torch.equal against every other tree's kept there (run the trees in one
    call: parent, change, change, parent)."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    root = Path(root).resolve()
    sys.path.insert(0, str(root))
    from blama_tpu_torch.ops import kernels, probes

    if not Path(probes.__file__).resolve().is_relative_to(root):
        raise AssertionError(f"imported {probes.__file__}, not the tree at {root}")
    smi = nvidia_smi()
    log(smi)
    build_s = kernels.build_all()
    log(f"kernels of {root} built in {build_s:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    outs = {}
    with torch.no_grad():
        timer = Timer(torch)
        rows = tools_kernel_phase(torch, timer, np.random.default_rng(5), outs)
        rows += ubench_kernel_phase(torch, timer, outs)
        rows += probes_kernel_phase(torch, timer, outs)
    equal_to = _equal_to_kept(torch, outs, ROOT / "build" / "tools_outputs", root.name)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"tools_timing-{root.name}.json").write_text(json.dumps(
        dict(nvidia_smi=smi, tree=str(root), build_s=build_s, rows=rows, equal_to=equal_to),
        indent=1))
    return 0


# the attention kernels' store types: int8 codes with f32 scales, bf16, f32
STORES = ("int8", "bf16", "f32")
# the fixed split widths the prefill sweep weighs (None: one pass over S)
PREFILL_SPLITS = (512, 1024, None)


def prefill_split_sweep(torch, timer):
    """Kernel D at the attention phase's prefill shapes under each fixed
    split width (a split changes a query's bits, so the width is one
    constant, ops/decode_attention.PREFILL_SPLIT; the wrapper's `split=`
    is for this measurement): the evidence for it. Every width within
    ATTN_TOL of the plain version."""
    from blama_tpu_torch.ops import decode_attention as da

    gen = torch.Generator(device="cuda").manual_seed(8)
    H, Hkv, D, S = 32, 8, 128, 2048
    inv = da.effective_inv_freq(D, D, 500000.0)[0].cuda()
    lens = [300, 0, 1500, 2047, 129, 640, 256, 1000]
    cases = []
    pos1 = torch.arange(S, dtype=torch.int32, device="cuda")[None].clone()
    pos1[0, 1900:] = -1
    for T in (8, 128, 512):
        cases.append(("solo int8", T, [1800], pos1))
    pos8 = torch.full((8, S), -1, dtype=torch.int32)
    for b, n in enumerate(lens):
        pos8[b, :n] = torch.arange(n, dtype=torch.int32)
    pos8 = pos8.cuda()
    for T in (8, 128, 256):
        cases.append(("serving bf16", T, lens, pos8))
    rows = []
    for label, T, ends, pos in cases:
        B = len(ends)
        k, v, ks, vs = _rand_store(torch, gen, (B, S, Hkv, D), label.split()[1])
        q = torch.randn((B, T, H, D), generator=gen, device="cuda").to(torch.bfloat16)
        qp = torch.stack([torch.arange(T, dtype=torch.int32) + max(n - T, 0)
                          for n in ends]).cuda()
        ref = da.flash_attention_plain(q, k, v, qp, pos, inv, ks, vs, D ** -0.5)
        ms = {}
        for split in PREFILL_SPLITS:
            w = split or S
            check_close(f"prefill split {split} {label} T={T}",
                        da.prefill_attention(q, k, v, qp, pos, inv, ks, vs, split=w), ref,
                        ATTN_TOL)
            ms[str(split)] = timer(lambda: da.prefill_attention(q, k, v, qp, pos, inv, ks, vs,
                                                                split=w), reps=9, warm=1)
        rows.append(dict(shape=f"{label} B={B} T={T} S={S}", plan=str(da.PREFILL_SPLIT), ms=ms))
        log(f"prefill split sweep {rows[-1]}")
    return rows


def _rand_store(torch, gen, shape, tag):
    """Random K and V of a store of type `tag` and their scales (int8)."""
    if tag == "int8":
        kv = [torch.randint(-127, 128, shape, generator=gen, device="cuda",
                            dtype=torch.int8) for _ in range(2)]
        sc = [torch.rand(shape[:-1], generator=gen, device="cuda") * 0.02 + 1e-3
              for _ in range(2)]
        return kv[0], kv[1], sc[0], sc[1]
    dt = torch.bfloat16 if tag == "bf16" else torch.float32
    kv = [torch.randn(shape, generator=gen, device="cuda").to(dt) for _ in range(2)]
    return kv[0], kv[1], None, None


def modes_kernel_phase(torch, timer):
    """Kernels N (fresh operand) and P (in-kernel write) against kernel C
    after the cache write, bit for bit, on INT8, bf16 and f32 stores (P's
    store against the write's, the spare slot included), and O (head-batched)
    against its plain version, at H32 / Hkv8 / D128, S = 2048, one row and 8
    rows (the last a pad row, whose write lands in the spare slot); each
    timed beside its bound and SDPA."""
    from blama_tpu_torch.ops import decode_attention as da
    from blama_tpu_torch.ops import kv_cache as kvc

    gen = torch.Generator(device="cuda").manual_seed(5)
    H, Hkv, D, S = 32, 8, 128, 2048
    inv, mscale = da.effective_inv_freq(D, D, 500000.0)
    inv = inv.cuda()
    scale = D ** -0.5
    rows = []
    # each row's fresh slot (= its position; None: a pad row)
    for lens in ([1694], [300, 1500, 2047, 129, 640, 256, 1000, None]):
        B = len(lens)
        slot = torch.tensor([S if n is None else n for n in lens], dtype=torch.int32,
                            device="cuda")
        q_pos = torch.where(slot < S, slot, 0)
        pos = torch.full((B, S), -1, dtype=torch.int32)
        for b, n in enumerate(lens):
            if n:
                pos[b, :n] = torch.arange(n, dtype=torch.int32)
        pos[:, 7::37] = -1                  # holes in the position map
        pos = pos.cuda()
        for tag in STORES:
            k, v, ks, vs = _rand_store(torch, gen, (1, B, S, Hkv, D), tag)
            base = kvc.KVCache(k, v, pos, ks, vs)
            base.pos_store[base.flat_slots(slot[:, None])] = q_pos
            del k, v, ks, vs

            def clone():
                c = kvc.KVCache(base.k, base.v, base.positions, base.k_scale, base.v_scale)
                c.pos_store.copy_(base.pos_store)
                return c

            kn, vn = (torch.randn((B, Hkv, D), generator=gen, device="cuda")
                      .to(torch.bfloat16) for _ in range(2))
            q = torch.randn((B, 1, H, D), generator=gen, device="cuda").to(torch.bfloat16)
            ref_c = clone()
            ref_c.write(0, ref_c.flat_slots(slot[:, None].long()), kn[:, None], vn[:, None])
            sc = (ref_c.k_scale[0], ref_c.v_scale[0]) if ref_c.quantized else (None, None)
            dense = (ref_c.k[0], ref_c.v[0], *sc, ref_c.positions)
            ref = da.decode_attention(q, ref_c.k[0], ref_c.v[0], q_pos, ref_c.positions, inv,
                                      *sc, mscale=mscale)
            n_c, p_c, pp_c = clone(), clone(), clone()
            n_sc = (n_c.k_scale[0], n_c.v_scale[0]) if n_c.quantized else (None, None)

            def stores(c):
                return ((c.k_store[0], c.v_store[0], c.k_scale_store[0], c.v_scale_store[0])
                        if c.quantized else (c.k_store[0], c.v_store[0], None, None))

            fresh = lambda: da.decode_attention(          # noqa: E731
                q, n_c.k[0], n_c.v[0], q_pos, n_c.positions, inv, *n_sc, mscale=mscale,
                k_new=kn, v_new=vn, slot=slot)
            pk, pv, pks, pvs = stores(p_c)
            write = lambda: da.decode_attention_write(    # noqa: E731
                q, pk, pv, q_pos, p_c.positions, inv, kn, vn, slot, pks, pvs, mscale=mscale)
            for name, fn in (("N", fresh), ("P", write)):
                out = fn()
                torch.cuda.synchronize()
                if not torch.equal(out, ref):
                    raise AssertionError(
                        f"kernel {name} {tag} B={B}: differs from C after the write (max "
                        f"{(out.float() - ref.float()).abs().max().item()})")
            for a, r in zip(stores(p_c), stores(ref_c), strict=True):
                if a is not None and not torch.equal(a, r):
                    raise AssertionError(f"kernel P {tag} B={B}: store differs from the write's")
            log(f"kernels N and P {tag} B={B}: bit-identical to C after the cache write; "
                "P's store (spare slot included) equal to the write's")
            row_bytes = 2 * B * Hkv * D * 2
            written = 2 * B * Hkv * (D * base.k_store.element_size() + (4 if base.quantized else 0))
            rows.append(_attn_row(
                torch, timer, "decode_attention_fresh", f"modes {tag}", fresh,
                lambda: da.fresh_attention_plain(q, n_c.k[0], n_c.v[0], q_pos[:, None],
                                                 n_c.positions, inv, kn, vn, slot, *n_sc,
                                                 scale),
                q, dense, q_pos[:, None], inv, row_bytes)[0])
            ppk, ppv, ppks, ppvs = stores(pp_c)
            rows.append(_attn_row(
                torch, timer, "decode_attention_write", f"modes {tag}", write,
                lambda: da.write_attention_plain(q, ppk, ppv, q_pos[:, None], pp_c.positions,
                                                 inv, kn, vn, slot, ppks, ppvs, scale),
                q, dense, q_pos[:, None], inv, row_bytes + written)[0])
            da._HB = True
            try:
                rows.append(_attn_row(
                    torch, timer, "decode_attention_hb", f"modes {tag}",
                    lambda: da.decode_attention(q, ref_c.k[0], ref_c.v[0], q_pos,
                                                ref_c.positions, inv, *sc, mscale=mscale),
                    lambda: da.flash_attention_plain(q, ref_c.k[0], ref_c.v[0], q_pos[:, None],
                                                     ref_c.positions, inv, *sc, scale),
                    q, dense, q_pos[:, None], inv, 0)[0])
            finally:
                da._HB = False
            del base, ref_c, n_c, p_c, pp_c
            torch.cuda.empty_cache()
    return rows


def _gather(pkv, table, G, kp, vp, ksp, vsp):
    slot_map = pkv.view_slot_map(table, G)
    Hkv, D = kp.shape[-2], kp.shape[-1]
    out = [kp.reshape(-1, Hkv, D)[slot_map].contiguous(),
           vp.reshape(-1, Hkv, D)[slot_map].contiguous()]
    for sc in (ksp, vsp):
        out.append(None if sc is None else sc.reshape(-1, Hkv)[slot_map].contiguous())
    return out


def replay(inst, prompt, preds):
    """A fresh session of `inst` replays a record; returns (the score, the
    mean logit similarity)."""
    from blama_tpu_torch.runtime.session import SessionInitParams
    from blama_tpu_torch.runtime.verify import LogitComparer, MetricsAggregator

    v = inst.start_session(SessionInitParams(seed=7, temperature=0.0))
    v.set_initial_prompt(prompt)
    replayed = v.fill_ctx(preds)
    inst.stop_session()
    agg = MetricsAggregator()
    score, sims = 0.0, []
    for a, b in zip(preds, replayed, strict=True):
        score = agg.push_and_verify(LogitComparer.compare(a.logits, b.logits))
        sims.append(LogitComparer.logit_similarity(a.logits, b.logits))
    return score, sum(sims) / len(sims)


def prove(inst, prompt, n):
    """A prover session generates n greedy tokens with top-10 capture;
    returns (its TTFT and decode tok/s, the predictions)."""
    import torch

    from blama_tpu_torch.runtime.session import CompleteParams, SessionInitParams

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
    return dict(prompt=len(prompt), tokens=len(preds), ttft_s=ttft,
                decode_tok_s=len(preds) / dt), preds


def prove_and_verify(inst, prompt, n, record=None):
    """One request: a prover session generates n greedy tokens with top-10
    capture, a fresh session replays them; returns the replay score. The
    prompt and the predictions are appended to `record` when given."""
    r, preds = prove(inst, prompt, n)
    if record is not None:
        record.append((prompt, preds))
    return dict(r, score=replay(inst, prompt, preds)[0])


# -- the step and the loops as CUDA graphs against eager launches --------------
# Every path of this script runs graphed (the card's default: ops/step_graph.py).
# Where a path's model is on the card, the checks below hold its graphs against
# the same work launched from Python (graphs=False).

GRAPH_LOOP_STEPS = 4           # steps of each loop in loops_equal
GRAPH_PROMPT_LENS = (128, 5, 3)   # the TTFT prompts of step_report
GRAPH_REPORT_STEPS = 8         # timed decode steps a way in step_report


def _record_bits(record):
    """Tokens and top-10 (id, f32 bits of the logit) of a record."""
    import numpy as np

    return [[(p.token, [(t.token, int(np.float32(t.logit).view(np.uint32))) for t in p.logits])
             for p in preds] for _, preds in record]


def eager_twin(torch, model, name, graphed, n_gens, record, launches, kv="int8",
               warmup=False):
    """The graphed run's requests again on an Instance that launches every
    kernel from Python: its predictions must be the graphed prover's, token
    and top-10 logit bit for bit, and its launch counts the graphed run's
    (each request proven, then replayed: here the eager verifier replays the
    graphed prover's record, at exactly 1.0); the graphed verifier replays
    the eager prover's records at exactly 1.0. Returns the eager requests."""
    from blama_tpu_torch.ops import kernels
    from blama_tpu_torch.runtime.instance import Instance, InstanceInitParams

    t0 = time.perf_counter()
    kernels.reset_launches()
    eager = Instance(model, InstanceInitParams(ctx_size=2048, flash_attn=True, kv_dtype=kv,
                                               graphs=False))
    if warmup:
        eager.warmup()
    e_record, results = [], []
    for (prompt, preds), n in zip(record, n_gens, strict=True):
        r, e_preds = prove(eager, prompt, n)
        r["graphed_to_eager"] = replay(eager, prompt, preds)[0]
        e_record.append((prompt, e_preds))
        results.append(r)
    torch.cuda.synchronize()
    e_launches = dict(kernels.LAUNCHES)
    if _record_bits(e_record) != _record_bits(record):
        raise AssertionError(f"{name}: the eager prover's tokens or top-10 differ from the "
                             "graphed prover's")
    if e_launches != launches:
        raise AssertionError(f"{name}: launches eager {e_launches} != graphed {launches}")
    cross = [replay(graphed, p, preds)[0] for p, preds in e_record]
    if cross != [1.0] * len(cross) or any(r["graphed_to_eager"] != 1.0 for r in results):
        raise AssertionError(f"{name}: cross replays {cross}, "
                             f"{[r['graphed_to_eager'] for r in results]}")
    for r, c in zip(results, cross):
        r["eager_to_graphed"] = c
    del eager
    torch.cuda.empty_cache()
    log(f"graphs: {name}: eager records = graphed bit for bit, launches equal, "
        f"cross replays 1.0 both ways ({time.perf_counter() - t0:.1f} s)")
    return results


def loops_equal(torch, model, name, kv="int8"):
    """testing.graphs_equal_eager at the 8B shapes: a 128-token prompt, a
    T = 1 step, a T = 4 chunk, GRAPH_LOOP_STEPS steps of continue_greedy,
    teacher_forced and greedy_generate, every output and both stores'
    bits equal with torch.equal and the launch counts equal; each loop's
    replays under torch.cuda.set_sync_debug_mode("error")."""
    import numpy as np

    from blama_tpu_torch.ops import step_graph
    from blama_tpu_torch.testing import graphs_equal_eager

    t0 = time.perf_counter()
    prompt = [1] + np.random.default_rng(29).integers(
        259, model.config.n_vocab, 127).tolist()
    step_graph.CHECK_SYNC = True
    try:
        graphs_equal_eager(model, kv, prompt, GRAPH_LOOP_STEPS)
    finally:
        step_graph.CHECK_SYNC = False
    torch.cuda.empty_cache()
    log(f"graphs: {name} on {kv}: steps and loops graphed = eager (torch.equal), "
        f"no sync between replays ({time.perf_counter() - t0:.1f} s)")
    return True


def step_report(torch, model, name, kv="int8"):
    """Graphed against eager on one model: the decode step's wall, device
    busy and idle share (tools/profile_step.py's measure over
    GRAPH_REPORT_STEPS steps after a 128-token prompt), decode tok/s, and
    the TTFT of GRAPH_PROMPT_LENS prompts on a fresh Instance, at first use
    (graphed: with its bucket's capture) and warm."""
    import numpy as np

    from blama_tpu_torch.runtime.instance import Instance, InstanceInitParams
    from blama_tpu_torch.tools import profile_step as ps

    out, t_report = {}, time.perf_counter()
    for way in ("graphed", "eager"):
        graphs = way == "graphed"
        steps, held = ps.solo_steps(model, kv, 2048, graphs)
        m = ps.measure(steps, GRAPH_REPORT_STEPS, 2, host_ops=False)
        row = {k: m[k] for k in ("wall_ms_per_step", "device_span_ms_per_step",
                                 "device_busy_ms_per_step", "busy_from",
                                 "device_launches_per_step", "idle_share")}
        row["decode_tok_s"] = 1e3 / m["wall_ms_per_step"]
        del steps
        inst = Instance(model, InstanceInitParams(ctx_size=2048, kv_dtype=kv, graphs=graphs))
        rng = np.random.default_rng(31)
        for n in GRAPH_PROMPT_LENS:
            prompt = [1] + rng.integers(259, model.config.n_vocab, n - 1).tolist()
            for when in ("first", "warm"):
                inst.clear_cache()
                t0 = time.perf_counter()
                inst.decode(prompt, np.arange(n))
                row[f"ttft_{n}_{when}_s"] = time.perf_counter() - t0
        if graphs:
            row["captures"] = held.captures + inst.graphs.captures
            row["graphs_gib"] = held.pool_gib() + inst.graphs.pool_gib()
        del inst, held
        torch.cuda.empty_cache()
        out[way] = row
    g, e = out["graphed"], out["eager"]
    busy = (f"{g['device_busy_ms_per_step']:.2f} / {e['device_busy_ms_per_step']:.2f}"
            if g["device_busy_ms_per_step"] and e["device_busy_ms_per_step"] else
            f"span {g['device_span_ms_per_step']:.2f} / {e['device_busy_ms_per_step']}")
    log(f"graphs: {name} on {kv}, graphed / eager: step wall {g['wall_ms_per_step']:.2f} / "
        f"{e['wall_ms_per_step']:.2f} ms, busy {busy} ms, idle {g['idle_share']:.3f} / "
        f"{e['idle_share']:.3f}, decode {g['decode_tok_s']:.1f} / {e['decode_tok_s']:.1f} tok/s, "
        f"TTFT 128 warm {g['ttft_128_warm_s']:.3f} / {e['ttft_128_warm_s']:.3f} s "
        f"(first use {g['ttft_128_first_s']:.3f} / {e['ttft_128_first_s']:.3f}); "
        f"graphs {g['graphs_gib']:.3f} GiB ({time.perf_counter() - t_report:.1f} s)")
    return out


def load_8b(torch, kind, dtype="q4k_a8", quant=None, n_layer=None, tp_blocks=-1):
    """Synthesize (or reuse) the llama3-8b GGUF of `quant` (default Q4_K) at
    `n_layer` layers (default: all 32) and load it as engine `dtype` (in the
    tp_blocks mode when `tp_blocks` > 0)."""
    from blama_tpu_torch.gguf import GGMLType
    from blama_tpu_torch.runtime.model import Model, ModelParams
    from blama_tpu_torch.testing import cached_llama_gguf

    t0 = time.perf_counter()
    path = Path(cached_llama_gguf("llama3-8b", seed=7, quant=quant or GGMLType.Q4_K,
                                  n_layer=n_layer))
    log(f"e2e: llama3-8b GGUF {path.name} ready in {time.perf_counter() - t0:.1f} s "
        f"({path.stat().st_size / 2**30:.2f} GiB)")
    t0 = time.perf_counter()
    model = Model(str(path), ModelParams(dtype=dtype, attn="fused", tp_blocks=tp_blocks))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    log(f"e2e: {dtype} (tp_blocks {model.config.tp_blocks}) load {load_s:.1f} s on {kind}; "
        f"depth {model.config.n_layer} layers "
        f"({'not cut' if n_layer is None else 'cut from 32'}), width {model.config.n_embd}")
    return model, load_s


def require_launched(launches, names, where):
    missing = [k for k in names if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched in {where}: {missing}")


def solo_phase(torch, model, kind, record):
    """The first slice's main path: one solo Session on an INT8 cache proves and
    verifies three requests (kernels A, B, C, D); the records go to `record`."""
    import numpy as np

    from blama_tpu_torch.ops import kernels
    from blama_tpu_torch.runtime.instance import Instance, InstanceInitParams

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
        r = prove_and_verify(inst, prompt, n_gen, record)
        log(f"solo request {r} on {kind}")
        if r["score"] != 1.0:
            raise AssertionError(f"same-backend replay scored {r['score']}, not 1.0")
        results.append(r)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    log(f"solo launches {launches}")
    require_launched(launches, ("w4a8_gemv", "q4k_dequant_matmul", "decode_attention",
                                "prefill_attention"), "the solo path")
    out = dict(requests=results, captures=inst.graphs.captures,
               graphs_gib=inst.graphs.pool_gib())
    out["eager"] = eager_twin(torch, model, "solo q4k_a8", inst, [n for _, n in requests],
                              record, launches, warmup=True)
    del inst
    torch.cuda.empty_cache()
    out["loops_equal"] = loops_equal(torch, model, "solo q4k_a8")
    out["report"] = step_report(torch, model, "solo q4k_a8")
    return out, launches


# the dense phase: the solo phase's request shapes (prompt, generated)
DENSE_REQUESTS = ((128, 16), (5, 16), (3, 8))


def _dense_solo(torch, model, kind, where, needs, requests=DENSE_REQUESTS):
    """One solo Instance at the reference's defaults (InstanceInitParams():
    f32 KV rows) proves and replays `requests`, each replay exactly 1.0; the
    attention kernels `needs` must have launched (none at all under
    attn="xla"). Returns (results, launches)."""
    import numpy as np

    from blama_tpu_torch.ops import kernels
    from blama_tpu_torch.runtime.instance import Instance, InstanceInitParams

    kernels.reset_launches()
    inst = Instance(model, InstanceInitParams(ctx_size=2048))
    if inst.step_config.attn_fused != model.config.attn_fused:
        raise AssertionError(f"{where}: the instance switched its attention mode")
    inst.warmup()
    rng = np.random.default_rng(7)
    results = []
    for n_prompt, n_gen in requests:
        prompt = [1] + rng.integers(259, model.config.n_vocab, n_prompt - 1).tolist()
        r = prove_and_verify(inst, prompt, n_gen)
        log(f"{where} request {r} on {kind}")
        if r["score"] != 1.0:
            raise AssertionError(f"{where}: same-backend replay scored {r['score']}, not 1.0")
        results.append(r)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    log(f"{where} launches {launches}")
    require_launched(launches, needs, where)
    if not model.config.attn_fused:
        fused = {k: n for k, n in launches.items() if "attention" in k and n}
        if fused:
            raise AssertionError(f"{where}: attn='xla' launched {fused}")
    del inst
    torch.cuda.empty_cache()
    return results, launches


def _dense_model(torch, path, dtype, attn, kind):
    from blama_tpu_torch.runtime.model import Model, ModelParams

    t0 = time.perf_counter()
    model = Model(str(path), ModelParams(dtype=dtype, attn=attn))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    log(f"dense: {Path(path).name} as {dtype} attn={attn} loaded in {load_s:.1f} s on {kind} "
        f"({model.config.n_layer} layers, width {model.config.n_embd}, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card)")
    return model, load_s


def _free(torch, model):
    """Close `model` and give its memory back; returns None for the caller
    to hold in its place (the caller's name is the last reference)."""
    model.close()
    model.weights = None
    gc.collect()
    torch.cuda.empty_cache()


def _default_http_server(torch, path, kind):
    """The reference server's default, as a user starts it: `python -m
    blama_tpu_torch.server.http` with BLAMA_DTYPE unset (the `bfloat16`
    engine, attn fused on a llama file) on the paged scheduler, in a
    process of its own; four concurrent /complete requests, each verified
    over /verify_completion at exactly 1.0; the process stopped with
    SIGTERM."""
    import os
    import signal
    import socket
    import urllib.request

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k != "BLAMA_DTYPE"}
    env.update(BLAMA_MODEL=str(path), BLAMA_HOST="127.0.0.1", BLAMA_PORT=str(port),
               BLAMA_SCHEDULER="4", BLAMA_PAGED_KV="1", PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "blama_tpu_torch.server.http"], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    url = f"http://127.0.0.1:{port}"

    def post(route, body):
        req = urllib.request.Request(url + route, json.dumps(body).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=600) as r:
            return json.loads(r.read())

    try:
        deadline = time.time() + 300
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"default server exited: {proc.stdout.read()[-4000:]}")
            try:
                urllib.request.urlopen(url + "/metrics", timeout=5).read()
                break
            except OSError:
                if time.time() > deadline:
                    raise AssertionError("default server did not start in 300 s") from None
                time.sleep(0.5)
        ready_s = time.perf_counter() - t0
        from concurrent.futures import ThreadPoolExecutor

        bodies = [{"prompt": t, "max_tokens": 16, "temp": 0.0}
                  for t in ("the default engine", "the quick brown fox jumps", "b" * 60,
                            "verifiable inference on a card")]
        t1 = time.perf_counter()
        with ThreadPoolExecutor(4) as ex:
            resps = list(ex.map(lambda b: post("/complete", b), bodies))
        wall = time.perf_counter() - t1
        with ThreadPoolExecutor(4) as ex:
            scores = list(ex.map(lambda br: post("/verify_completion",
                                                 {"request": br[0], "response": br[1]}),
                                 zip(bodies, resps, strict=True)))
        got = [sc["result"] for sc in scores]
        n_tok = sum(len(r["tokenData"]) for r in resps)
        log(f"dense default server (bfloat16, paged, 4 rows): ready in {ready_s:.1f} s, "
            f"{n_tok} tokens in {wall:.2f} s on {kind}; verify {got}")
        if got != [1.0] * len(bodies) or n_tok != 16 * len(bodies):
            raise AssertionError(f"default server: verify {got}, {n_tok} tokens")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        text = proc.stdout.read()
        if rc != 0 or "continuous batching enabled (max_batch=4, paged KV)" not in text:
            raise AssertionError(f"default server exit {rc}: {text[-4000:]}")
        return dict(ready_s=ready_s, tokens=n_tok, wall_s=wall, scores=got)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)


def _dequant_on_card(torch, path):
    """ops/dequant on the card against gguf/quants' numpy function, bit for
    bit: for every GGML type in the file, its smallest matmul tensor (a type
    held only by a tensor of more than 64 M values, the numpy side's minutes,
    is left to the other file)."""
    import numpy as np

    from blama_tpu_torch.gguf import quants
    from blama_tpu_torch.gguf.reader import GGUFReader
    from blama_tpu_torch.ops import dequant

    r = GGUFReader(str(path))
    pick = {}
    for name in r.tensor_names():
        info = r.tensors[name]
        if name.endswith("norm.weight"):
            continue
        if info.ggml_type not in pick or info.n_elements < r.tensors[pick[info.ggml_type]].n_elements:
            pick[info.ggml_type] = name

    def check(t, name):
        info = r.tensors[name]
        data = r.tensor_bytes(name)           # a view of the file's map
        ref = quants.dequantize(data, t, info.shape)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = dequant.dequantize(data, t, info.shape, "cuda")
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        if not np.array_equal(got.cpu().numpy().view(np.uint32), ref.view(np.uint32)):
            raise AssertionError(f"dequant {t.name} {name}: differs from the numpy function")
        return dict(tensor=name, elements=int(info.n_elements), host_to_values_ms=ms)

    out = {t.name: check(t, name) for t, name in sorted(pick.items(), key=lambda kv: kv[0].value)
           if r.tensors[name].n_elements <= 64 << 20}
    r.close()
    log(f"dequant on the card equals numpy, {Path(path).name}: {out}")
    return out


def dense_phase(torch, kind):
    """The reference's defaults on the card: the `bfloat16` engine on the
    llama3-8b all-Q4_K file (seed 7, dequantized at load) at full depth,
    the solo phase's three request shapes under attn="fused" (bf16 C and D)
    and attn="xla" (no attention kernel), each replayed at exactly 1.0, and
    the HTTP server with BLAMA_DTYPE unset on the paged scheduler (E, F),
    verified at 1.0; the `float32` engine on the same file's widths cut to
    ENGINE_FILE_LAYERS layers, f32 KV (the reference's default store), the
    same requests under attn="fused" (the f32-query C and D) and "xla", and
    four requests through the paged scheduler (the f32-query E and F),
    verified at 1.0; a Q5_K_M-pattern and a Q3_K_M-pattern file at
    ENGINE_FILE_LAYERS layers, each type's dequantized values on the card
    equal to the numpy function's, loaded as `bfloat16` and replayed at
    1.0. Decode tok/s and TTFT of each engine graphed and eager
    (step_report)."""
    from blama_tpu_torch.testing import Q3_K_M, Q5_K_M, cached_llama_gguf

    out, t_phase = {}, time.perf_counter()
    path = cached_llama_gguf("llama3-8b", seed=7)
    for attn in ("fused", "xla"):
        model, load_s = _dense_model(torch, path, "bfloat16", attn, kind)
        needs = ("decode_attention", "prefill_attention") if attn == "fused" else ()
        res, launches = _dense_solo(torch, model, kind, f"dense bfloat16 {attn}", needs)
        out[f"bfloat16 {attn}"] = dict(load_s=load_s, requests=res, launches=launches)
        if attn == "fused":
            out["bfloat16 fused"]["report"] = step_report(torch, model, "dense bfloat16",
                                                          kv="float32")
        model = _free(torch, model)
    out["default server"] = _default_http_server(torch, path, kind)
    log(f"dense bfloat16 done in {time.perf_counter() - t_phase:.1f} s")
    path8 = cached_llama_gguf("llama3-8b", seed=7, n_layer=ENGINE_FILE_LAYERS)
    for attn in ("fused", "xla"):
        model, load_s = _dense_model(torch, path8, "float32", attn, kind)
        needs = ("decode_attention_f32q", "prefill_attention_f32q") if attn == "fused" else ()
        res, launches = _dense_solo(torch, model, kind, f"dense float32 {attn}", needs)
        out[f"float32 {attn}"] = dict(load_s=load_s, requests=res, launches=launches)
        if attn == "fused":
            out["float32 fused"]["report"] = step_report(torch, model, "dense float32",
                                                         kv="float32")
            out["float32 serving"], out["float32 serving launches"] = _serve_and_verify(
                torch, model, kind, needs=("paged_decode_attention_f32q",
                                           "paged_prefill_attention_f32q"),
                where="dense float32 serving")
        model = _free(torch, model)
    log(f"dense float32 done in {time.perf_counter() - t_phase:.1f} s")
    for recipe in (Q5_K_M, Q3_K_M):
        p = cached_llama_gguf("llama3-8b", seed=7, quant=recipe, n_layer=ENGINE_FILE_LAYERS)
        dq = _dequant_on_card(torch, p)
        model, load_s = _dense_model(torch, p, "bfloat16", "fused", kind)
        res, launches = _dense_solo(torch, model, kind, f"dense bfloat16 {recipe}",
                                    ("decode_attention", "prefill_attention"),
                                    DENSE_REQUESTS[:2])
        out[f"bfloat16 {recipe}"] = dict(load_s=load_s, dequant=dq, requests=res,
                                         launches=launches)
        model = _free(torch, model)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"dense phase took {out['seconds']:.1f} s")
    return out


# the head-dim-96 phase: a llama-architecture file at Phi-3-mini's widths
# (testing.MODEL_PRESETS), its depth cut to HD96_LAYERS layers
HD96_PRESET, HD96_LAYERS = "phi3-mini", 4


def head_dim_96_phase(torch, kind):
    """Every head geometry the gates admit runs on the card, end to end: the
    HD96_PRESET file (hidden 3072, 32 query and 32 KV heads, so head dim 96
    and one query head per KV head; FFN 8192, vocab 32064), synthesized at
    Q4_K from a seed and cut to HD96_LAYERS layers, loaded as `q4k_a8` with
    fused attention. A solo Session on an INT8 cache proves and replays two
    requests (128 and 5 prompt tokens, 16 tokens each) at exactly 1.0
    (kernels C, D), then the model behind the HTTP server on the paged
    scheduler verifies every response at exactly 1.0 (E, F)."""
    import numpy as np

    from blama_tpu_torch.ops import kernels
    from blama_tpu_torch.runtime.instance import Instance, InstanceInitParams
    from blama_tpu_torch.runtime.model import Model, ModelParams
    from blama_tpu_torch.testing import cached_llama_gguf

    t0 = time.perf_counter()
    path = cached_llama_gguf(HD96_PRESET, seed=7, n_layer=HD96_LAYERS)
    model = Model(path, ModelParams(dtype="q4k_a8", attn="fused"))
    cfg = model.config
    log(f"head-dim-96: {HD96_PRESET} file at {cfg.n_layer} layers (cut), width {cfg.n_embd}, "
        f"{cfg.n_head} / {cfg.n_head_kv} heads, head dim {cfg.head_dim_}, ready in "
        f"{time.perf_counter() - t0:.1f} s on {kind}")
    if cfg.head_dim_ != 96:
        raise AssertionError(f"head-dim-96: the file's head dim is {cfg.head_dim_}")
    try:
        kernels.reset_launches()
        inst = Instance(model, InstanceInitParams(ctx_size=2048, flash_attn=True,
                                                  kv_dtype="int8"))
        rng = np.random.default_rng(96)
        results = []
        for n_prompt, n_gen in ((128, 16), (5, 16)):
            prompt = [1] + rng.integers(259, cfg.n_vocab, n_prompt - 1).tolist()
            r = prove_and_verify(inst, prompt, n_gen)
            log(f"head-dim-96 solo request {r}")
            if r["score"] != 1.0:
                raise AssertionError(f"head-dim-96: replay scored {r['score']}, not 1.0")
            results.append(r)
        del inst
        torch.cuda.synchronize()
        solo_l = dict(kernels.LAUNCHES)
        require_launched(solo_l, ("decode_attention", "prefill_attention"),
                         "the head-dim-96 solo path")
        served, serve_l = _serve_and_verify(
            torch, model, kind, needs=("paged_decode_attention", "paged_prefill_attention"),
            where="head-dim-96 serving")
    finally:
        model.close()
        del model
        torch.cuda.empty_cache()
    return dict(solo=results, serving=served, launches=dict(solo=solo_l, serving=serve_l))


# the decode-attention modes (BLAMA_ATTN_*), each with its kernel, and the
# store types each runs on in the modes phase
MODE_KERNEL = {"write": "decode_attention_write", "fresh": "decode_attention_fresh",
               "hb": "decode_attention_hb"}
MODE_RUNS = (("write", "int8"), ("write", "float32"), ("fresh", "int8"),
             ("hb", "bfloat16"), ("hb", "float32"))
MODE_REQUESTS = ((128, 12), (5, 12), (3, 8))


def _set_mode(mode):
    """Turn one decode-attention mode on (None: all off) through the module
    attributes the reference's tests set, as its env vars would at import."""
    from blama_tpu_torch.ops import decode_attention as da
    from blama_tpu_torch.ops import generate_loop as gl

    gl._WRITE_IN_KERNEL, gl._FRESH_OPERAND = mode == "write", mode == "fresh"
    da._HB = mode == "hb"


def _mode_run(torch, model, kv, mode):
    """The modes phase's three requests on a solo Instance over a `kv` store
    with `mode` on (None: off), each proven and replayed at exactly 1.0, and
    the mode's steps and loops held against eager launches (loops_equal).
    Returns (records, results, launches of the run, the graphs check)."""
    import numpy as np

    from blama_tpu_torch.ops import kernels
    from blama_tpu_torch.runtime.instance import Instance, InstanceInitParams

    _set_mode(mode)
    try:
        kernels.reset_launches()
        inst = Instance(model, InstanceInitParams(ctx_size=2048, flash_attn=True,
                                                  kv_dtype=kv))
        rng = np.random.default_rng(17)
        record, results = [], []
        for n_prompt, n_gen in MODE_REQUESTS:
            prompt = [1] + rng.integers(259, model.config.n_vocab, n_prompt - 1).tolist()
            r = prove_and_verify(inst, prompt, n_gen, record)
            if r["score"] != 1.0:
                raise AssertionError(f"mode {mode} on {kv}: replay scored {r['score']}")
            results.append(r)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        graphs = dict(loops_equal=loops_equal(torch, model, f"mode {mode or 'off'}", kv))
    finally:
        _set_mode(None)
    del inst
    torch.cuda.empty_cache()
    log(f"modes: {mode or 'off'} on {kv}: {results}; launches {launches}")
    return record, results, launches, graphs


def _top10(record):
    return [[(p.token, [(t.token, t.logit) for t in p.logits]) for p in preds]
            for _, preds in record]


def modes_phase(torch, model, kind):
    """This slice's main path, on the solo phase's model: the reference's
    opt-in decode-attention modes through Model -> Instance -> Session, three
    prove-and-verify requests each (replay exactly 1.0), the mode's kernel
    launched and kernel C on no step: write (P) on INT8 and f32 stores and
    fresh (N) on INT8 give the mode-off run's tokens and top-10 bit for bit;
    head-batched (O) on bf16 and f32 replays the mode-off records at the
    cross-mode thresholds (0.95 / 0.98). Then the solo HTTP server on its
    default f32 store verifies a request at 1.0, and the dense-row scheduler
    in write mode gives the mode-off tokens."""
    from blama_tpu_torch.ops import kernels
    from blama_tpu_torch.runtime.instance import Instance, InstanceInitParams
    from blama_tpu_torch.runtime.sampler import SamplerParams
    from blama_tpu_torch.server.scheduler import ContinuousBatchingScheduler, GenRequest
    from blama_tpu_torch.server.server import Server

    out = {}
    off = {}
    for kv in ("int8", "float32", "bfloat16"):
        rec, res, launches, graphs = _mode_run(torch, model, kv, None)
        require_launched(launches, ("decode_attention", "prefill_attention"),
                         f"the mode-off run on {kv}")
        off[kv] = rec
        out[f"off {kv}"] = dict(requests=res, launches=launches, graphs=graphs)
    for mode, kv in MODE_RUNS:
        rec, res, launches, graphs = _mode_run(torch, model, kv, mode)
        require_launched(launches, (MODE_KERNEL[mode],), f"mode {mode} on {kv}")
        if launches["decode_attention"]:
            raise AssertionError(f"mode {mode} on {kv}: kernel C ran on a decode step")
        entry = dict(requests=res, launches=launches, graphs=graphs)
        if mode == "hb":
            _set_mode("hb")
            try:
                inst = Instance(model, InstanceInitParams(ctx_size=2048, flash_attn=True,
                                                          kv_dtype=kv))
                entry["replays_off"] = [replay(inst, prompt, preds) for prompt, preds in off[kv]]
            finally:
                _set_mode(None)
            del inst
            if not all(sc >= 0.95 and sim >= 0.98 for sc, sim in entry["replays_off"]):
                raise AssertionError(f"mode hb on {kv}: replaying the mode-off records "
                                     f"fell below 0.95 / 0.98: {entry['replays_off']}")
        elif _top10(rec) != _top10(off[kv]):
            raise AssertionError(f"mode {mode} on {kv}: tokens or top-10 differ from the "
                                 "mode-off run")
        log(f"modes: {mode} on {kv} holds ({entry.get('replays_off', 'bit-equal to off')})")
        out[f"{mode} {kv}"] = entry
    torch.cuda.empty_cache()

    # the solo HTTP server as `python -m blama_tpu_torch.server.http` builds it
    srv = Served(model, api=Server(model, InstanceInitParams()))
    try:
        store = srv.api._instance.cache.k_store.dtype
        body = _request_body("plain", "the solo server keeps f32 rows", max_tokens=16,
                             temp=0.0)
        resp = srv.post(PATHS["plain"][0], body)
        score = srv.post(PATHS["plain"][1], {"request": body, "response": resp})["result"]
    finally:
        srv.close()
    del srv
    torch.cuda.empty_cache()
    log(f"modes: solo HTTP server, {store} KV: {len(resp['tokenData'])} tokens, verify {score}")
    if store != torch.float32 or len(resp["tokenData"]) != 16 or score != 1.0:
        raise AssertionError(f"solo HTTP server on {store}: verify scored {score}")
    out["solo_http"] = dict(kv=str(store), score=score)

    prompts = [[1] + list(range(300 + 7 * i, 300 + 7 * i + n)) for i, n in
               enumerate((40, 9, 120))]
    toks = {}
    for mode in (None, "write"):
        _set_mode(mode)
        try:
            kernels.reset_launches()
            sched = ContinuousBatchingScheduler(model, max_batch=4, ctx_size=2048,
                                                paged=False, horizon=8)
            got = {}
            for i, p in enumerate(prompts):
                sched.submit(GenRequest(prompt=p, max_tokens=24,
                                        sampler_params=SamplerParams(temp=0.0),
                                        on_done=lambda g, i=i: got.__setitem__(
                                            i, [x.token for x in g])))
            sched.run_until_idle()
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
        finally:
            _set_mode(None)
        del sched
        toks[mode] = [got[i] for i in range(len(prompts))]
        if mode:
            require_launched(launches, (MODE_KERNEL[mode],), "the dense scheduler in write mode")
            out["scheduler_write"] = dict(launches=launches)
    if toks["write"] != toks[None]:
        raise AssertionError("the dense scheduler in write mode gave other tokens")
    log(f"modes: dense scheduler (4 rows, one idle), write mode: the mode-off tokens")
    torch.cuda.empty_cache()
    return out


MATMUL_KERNELS = ("w4a8_gemv", "q4k_dequant_matmul", "q8_dequant_matmul",
                  "q4k_native_matmul", "w4a8k4_gemv", "q4k_parts_matmul", "w4a8_parts_gemv")


def engines_phase(torch, kind, a8_record, records):
    """This slice's main path: every other engine at full 8B width, one model
    on the card at a time, through Model -> Instance -> Session: three solo
    prove-and-verify requests each (prompts of 128, 5 and 3 tokens, so the
    kernels run at 128, 8, 4 and 1 rows), every same-backend replay exactly
    1.0, and each engine must launch its own matmul kernels and no other.
    `q4k_fused`'s records go to `records` (the tp_blocks phase replays them)."""
    import numpy as np

    from blama_tpu_torch.gguf import GGMLType
    from blama_tpu_torch.ops import kernels
    from blama_tpu_torch.runtime.instance import Instance, InstanceInitParams
    from blama_tpu_torch.testing import Q4_K_M

    cut = ENGINE_FILE_LAYERS
    # engine, file type, depth, the matmul kernels it must launch
    engines = [
        ("q4k_fused", None, None, ("q4k_dequant_matmul",)),
        ("q4k_fused_k4", None, None, ("q4k_native_matmul",)),
        ("q4k_a8_k4", None, None, ("w4a8k4_gemv", "q4k_native_matmul")),
        ("q8_0_fused", GGMLType.Q8_0, cut, ("q8_dequant_matmul",)),
        ("q4k_a8", Q4_K_M, cut, ("w4a8_gemv", "q4k_dequant_matmul", "q8_dequant_matmul")),
    ]
    requests = [(128, 16), (5, 16), (3, 8)]
    out, tokens = {}, {}
    for dtype, quant, n_layer, needs in engines:
        name = dtype if quant is None else f"{dtype} on {getattr(quant, 'name', quant)}"
        gc.collect()        # the previous model's arrays
        torch.cuda.empty_cache()
        model, load_s = load_8b(torch, kind, dtype, quant, n_layer)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        inst = Instance(model, InstanceInitParams(ctx_size=2048, flash_attn=True,
                                                  kv_dtype="int8"))
        rng = np.random.default_rng(7)
        record, results = [], []
        for n_prompt, n_gen in requests:
            prompt = [1] + rng.integers(259, model.config.n_vocab, n_prompt - 1).tolist()
            r = prove_and_verify(inst, prompt, n_gen, record)
            log(f"engine {name} request {r} on {kind}")
            if r["score"] != 1.0:
                raise AssertionError(f"{name}: same-backend replay scored {r['score']}, not 1.0")
            results.append(r)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        log(f"engine {name} launches {launches}")
        require_launched(launches, needs + ("decode_attention", "prefill_attention"),
                         f"the {name} engine")
        others = [k for k in MATMUL_KERNELS if k not in needs and launches[k]]
        if others:
            raise AssertionError(f"{name} launched another engine's kernels: {others}")
        res = dict(load_s=load_s, layers=model.config.n_layer, requests=results,
                   launches=launches, peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        if dtype == "q4k_fused":       # the verifier's engine: its records against eager
            res["eager"] = eager_twin(torch, model, name, inst, [n for _, n in requests],
                                      record, launches)
        res["loops_equal"] = loops_equal(torch, model, name)
        res["report"] = step_report(torch, model, name)
        if dtype == "q4k_fused":
            # printed, not gated (random 8B weights have flat logits): the
            # exact engine as verifier of the W4A8 prover's records
            res["replay_of_q4k_a8"] = [replay(inst, p, preds)[0] for p, preds in a8_record]
            log(f"engine q4k_fused replaying q4k_a8's records: {res['replay_of_q4k_a8']}")
            records["q4k_fused"] = record
        if quant is None:
            tokens[dtype] = [[p.token for p in preds] for _, preds in record]
        out[name] = res
        model.close()
        del inst, model, record
        torch.cuda.empty_cache()
    same = tokens["q4k_fused"] == tokens["q4k_fused_k4"]
    log(f"engines q4k_fused and q4k_fused_k4 give {'the same' if same else 'other'} tokens")
    out["fused_and_k4_same_tokens"] = same
    return out


MOE_MATMUL_KERNELS = ("w4a8_gemv", "q4k_dequant_matmul", "w4a8_bank_gemv", "q4k_bank_matmul")


def moe_phase(torch, kind):
    """The fourth slice's main path: the `mixtral-8x7b` preset (Mixtral-8x7B's
    widths, seed 11) cut to MOE_FILE_LAYERS layers, loaded as `q4k_a8` and
    then `q4k_fused`, one model on the card at a time, attn="xla" (the two-pass
    chain), INT8 KV, ctx 2048. Three solo prove-and-verify requests each
    (prompts of 128, 5 and 3 tokens: the masked expert path at 128, 8 and 4
    rows, the routed path at every decode step), every same-backend replay
    exactly 1.0; `q4k_fused` replays `q4k_a8`'s records (printed). Then the
    `q4k_a8` model behind the HTTP server on the scheduler's paged pool
    answers concurrent /complete requests, each verified at exactly 1.0."""
    import numpy as np

    from blama_tpu_torch.ops import kernels
    from blama_tpu_torch.runtime.instance import Instance, InstanceInitParams
    from blama_tpu_torch.runtime.model import Model, ModelParams
    from blama_tpu_torch.testing import cached_moe_gguf

    t0 = time.perf_counter()
    path = Path(cached_moe_gguf("mixtral-8x7b", seed=11, n_layer=MOE_FILE_LAYERS))
    synth_s = time.perf_counter() - t0
    log(f"moe: mixtral-8x7b GGUF {path.name} ready in {synth_s:.1f} s "
        f"({path.stat().st_size / 2**30:.2f} GiB, {MOE_FILE_LAYERS} of 32 layers)")
    out = dict(file=path.name, file_gib=path.stat().st_size / 2 ** 30, synth_s=synth_s,
               layers=MOE_FILE_LAYERS)
    requests = [(128, 16), (5, 16), (3, 8)]
    a8_record = []
    # engine, the matmul kernels it must launch on the solo path
    for dtype, needs in (("q4k_a8", ("w4a8_gemv", "q4k_dequant_matmul", "w4a8_bank_gemv",
                                     "q4k_bank_matmul")),
                         ("q4k_fused", ("q4k_dequant_matmul", "q4k_bank_matmul"))):
        gc.collect()        # the previous model's arrays (the server's cycles)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = Model(str(path), ModelParams(dtype=dtype, attn="xla"))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        gib = torch.cuda.memory_allocated() / 2 ** 30
        log(f"moe: {dtype} load {load_s:.1f} s, {gib:.2f} GiB on the card after load; "
            f"{model.config.n_expert} experts, {model.config.n_expert_used} per token, "
            f"width {model.config.n_embd}, FFN {model.config.n_ff}")
        kernels.reset_launches()
        inst = Instance(model, InstanceInitParams(ctx_size=2048, kv_dtype="int8"))
        rng = np.random.default_rng(7)
        record, results = [], []
        for n_prompt, n_gen in requests:
            prompt = [1] + rng.integers(259, model.config.n_vocab, n_prompt - 1).tolist()
            r = prove_and_verify(inst, prompt, n_gen, record)
            log(f"moe {dtype} request {r} on {kind}")
            if r["score"] != 1.0:
                raise AssertionError(f"moe {dtype}: same-backend replay scored {r['score']}, "
                                     "not 1.0")
            results.append(r)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        log(f"moe {dtype} solo launches {launches}")
        require_launched(launches, needs, f"the MoE {dtype} solo path")
        others = [k for k in MOE_MATMUL_KERNELS + MATMUL_KERNELS
                  if k not in needs and launches[k]]
        if others or any(launches[k] for k in ("decode_attention", "prefill_attention")):
            raise AssertionError(f"moe {dtype} launched kernels off its path: {others}")
        res = dict(load_s=load_s, gib_after_load=gib, requests=results, launches=launches)
        res["loops_equal"] = loops_equal(torch, model, f"moe {dtype}")
        res["report"] = step_report(torch, model, f"moe {dtype}")
        res["routed_equals_padded"] = _moe_routed_equals_padded(torch, model, dtype)
        if dtype == "q4k_a8":
            a8_record = record
            res["serving"], res["serving_launches"] = _serve_and_verify(torch, model, kind)
        else:
            # printed, not gated: the exact engine as verifier of the W4A8
            # prover's records (random weights: flat logits)
            res["replay_of_q4k_a8"] = [replay(inst, p, preds)[0] for p, preds in a8_record]
            log(f"moe q4k_fused replaying q4k_a8's records: {res['replay_of_q4k_a8']}")
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        out[dtype] = res
        model.close()
        del inst, model, record
        torch.cuda.empty_cache()
    return out


def _moe_token_logits(torch, model, T, kv, prefix):
    """Logits of token 7 at position `prefix` after `prefix` prompt tokens,
    fed as row 0 of a T-row chunk whose other rows are pads (slot past the
    cache: dropped): at T = 1 the routed decode step, above it the masked
    chunk over every expert."""
    from blama_tpu_torch.models import moe
    from blama_tpu_torch.ops import kv_cache as kvc

    cfg, S = model.config, 64
    st = moe.MoEStatic.of(cfg)
    cache = kvc.KVCache.create(cfg.n_layer, 1, S, cfg.n_head_kv, cfg.head_dim_, kv,
                               device="cuda")
    if prefix:
        ids = torch.arange(prefix, dtype=torch.int32, device="cuda")[None]
        moe.forward(model.weights, st, ids + 300, ids, ids, cache,
                    torch.tensor([prefix - 1], device="cuda"))
    toks = torch.zeros((1, T), dtype=torch.int32, device="cuda")
    pos = torch.zeros((1, T), dtype=torch.int32, device="cuda")
    slots = torch.full((1, T), S, dtype=torch.int32, device="cuda")
    toks[0, 0], pos[0, 0], slots[0, 0] = 7, prefix, prefix
    return moe.forward(model.weights, st, toks, pos, slots, cache,
                       torch.zeros(1, dtype=torch.long, device="cuda"))[0]


def _moe_routed_equals_padded(torch, model, dtype):
    """The whole layer stack: a token's logits decoded routed at one row equal
    its row in a padded 4- and 8-row chunk bit for bit (rows_mm's fixed-shape
    products, the row-invariant bank kernels), on an empty cache and after a
    5-token prefix, on the INT8 and bf16 stores."""
    out = {}
    for kv in ("int8", "bfloat16"):
        for prefix in (0, 5):
            one = _moe_token_logits(torch, model, 1, kv, prefix)
            for T in (4, 8):
                if not torch.equal(_moe_token_logits(torch, model, T, kv, prefix), one):
                    raise AssertionError(f"moe {dtype}: the routed step's logits differ from "
                                         f"the token's row in a padded {T}-row chunk "
                                         f"({kv}, prefix {prefix})")
            out[f"{kv} prefix {prefix}"] = True
    log(f"moe {dtype}: routed logits equal the padded 4- and 8-row chunks' bit for bit "
        f"({sorted(out)})")
    return out


def _serve_and_verify(torch, model, kind, needs=("w4a8_bank_gemv", "q4k_bank_matmul"),
                 where="moe serving"):
    """The model behind the HTTP server over SchedulerServer(paged=True):
    four concurrent /complete requests (for a MoE model every scheduler step
    runs the masked expert path), each then verified over /verify_completion
    at exactly 1.0; the kernels `needs` must have run."""
    from blama_tpu_torch.ops import kernels

    srv = Served(model, max_batch=4, paged=True, horizon=8)
    try:
        bodies = [{"prompt": t, "max_tokens": 16, "temp": 0.0}
                  for t in ("mixture of experts", "the quick brown fox jumps",
                            "a" * 60, "verifiable inference on a card")]
        kernels.reset_launches()
        resps, wall = srv.post_all([("/complete", b) for b in bodies])
        n_tok = sum(len(r["tokenData"]) for r in resps)
        if any(len(r["tokenData"]) != 16 for r in resps):
            raise AssertionError(f"{where}: a short response")
        scores, vwall = srv.post_all([("/verify_completion", {"request": b, "response": r})
                                      for b, r in zip(bodies, resps, strict=True)])
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        got = [sc["result"] for sc in scores]
        log(f"{where} (paged, 4 rows): {n_tok} tokens in {wall:.2f} s = "
            f"{n_tok / wall:.1f} tok/s over all rows on {kind}; verify {got} in {vwall:.2f} s")
        log(f"{where} launches {launches}")
        if got != [1.0] * len(bodies):
            raise AssertionError(f"{where}: scheduler replay scored {got}, not 1.0")
        require_launched(launches, needs, where)
        return dict(requests=len(bodies), tokens=n_tok, wall_s=wall, verify_s=vwall,
                    scores=got), launches
    finally:
        srv.close()


def tp_blocks_phase(torch, kind, records):
    """This slice's main path: the fixed-topology tp_blocks mode at
    TP_BLOCKS = 8 (the mode a solo verifier of a prover sharded over 8 cards
    runs), one model on the card at a time. The llama3-8b file at full depth
    as `q4k_fused` (kernel L only) and `q4k_a8` (A and M up to 16 rows, L
    above): the engines phase's three requests each, every same-backend
    replay exactly 1.0; each engine's verifier in this mode scores its own
    tp_blocks=0 records (`records`) at the cross-mode thresholds 0.95 / 0.98;
    `q4k_a8` behind the HTTP server on the paged scheduler, every verify 1.0.
    Then the Mixtral file (MOE_FILE_LAYERS of 32 layers) as `q4k_fused`: one
    request, replay 1.0 (L for the attention projections and the head, K for
    the expert banks)."""
    import numpy as np

    from blama_tpu_torch.ops import kernels
    from blama_tpu_torch.runtime.instance import Instance, InstanceInitParams
    from blama_tpu_torch.runtime.model import Model, ModelParams
    from blama_tpu_torch.testing import cached_moe_gguf

    requests = [(128, 16), (5, 16), (3, 8)]
    out = {}
    for dtype, needs in (("q4k_fused", ("q4k_parts_matmul",)),
                         ("q4k_a8", ("w4a8_gemv", "w4a8_parts_gemv", "q4k_parts_matmul"))):
        gc.collect()
        torch.cuda.empty_cache()
        model, load_s = load_8b(torch, kind, dtype, tp_blocks=TP_BLOCKS)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        inst = Instance(model, InstanceInitParams(ctx_size=2048, flash_attn=True,
                                                  kv_dtype="int8"))
        rng = np.random.default_rng(7)
        results = []
        for n_prompt, n_gen in requests:
            prompt = [1] + rng.integers(259, model.config.n_vocab, n_prompt - 1).tolist()
            r = prove_and_verify(inst, prompt, n_gen)
            log(f"tp_blocks={TP_BLOCKS} {dtype} request {r} on {kind}")
            if r["score"] != 1.0:
                raise AssertionError(f"tp_blocks {dtype}: same-backend replay scored "
                                     f"{r['score']}, not 1.0")
            results.append(r)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        log(f"tp_blocks={TP_BLOCKS} {dtype} launches {launches}")
        require_launched(launches, needs + ("decode_attention", "prefill_attention"),
                         f"the tp_blocks {dtype} path")
        others = [k for k in MATMUL_KERNELS if k not in needs and launches[k]]
        if others:
            raise AssertionError(f"tp_blocks {dtype} launched kernels off its path: {others}")
        # another numerics mode (the min term inside, the K-blocked sums):
        # gated at the cross-engine thresholds, not at equality
        cross = [replay(inst, p, preds) for p, preds in records[dtype]]
        log(f"tp_blocks={TP_BLOCKS} {dtype} replaying its tp_blocks=0 records "
            f"(score, mean similarity): {cross}")
        if not all(sc >= 0.95 and sim >= 0.98 for sc, sim in cross):
            raise AssertionError(f"tp_blocks {dtype}: cross-mode replay below thresholds")
        res = dict(load_s=load_s, layers=model.config.n_layer, requests=results,
                   launches=launches, replay_of_tp0=cross,
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        name = f"tp_blocks={TP_BLOCKS} {dtype}"
        res["loops_equal"] = loops_equal(torch, model, name)
        res["report"] = step_report(torch, model, name)
        del inst
        if dtype == "q4k_a8":
            res["serving"], res["serving_launches"] = _serve_and_verify(
                torch, model, kind, needs, f"tp_blocks={TP_BLOCKS} serving")
        out[dtype] = res
        model.close()
        del model
        torch.cuda.empty_cache()
    gc.collect()
    torch.cuda.empty_cache()
    path = cached_moe_gguf("mixtral-8x7b", seed=11, n_layer=MOE_FILE_LAYERS)
    t0 = time.perf_counter()
    model = Model(path, ModelParams(dtype="q4k_fused", attn="xla", tp_blocks=TP_BLOCKS))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    kernels.reset_launches()
    inst = Instance(model, InstanceInitParams(ctx_size=2048, kv_dtype="int8"))
    prompt = [1] + np.random.default_rng(7).integers(259, model.config.n_vocab, 127).tolist()
    r = prove_and_verify(inst, prompt, 16)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    log(f"tp_blocks={TP_BLOCKS} moe q4k_fused ({MOE_FILE_LAYERS} layers) request {r}, load "
        f"{load_s:.1f} s, launches {launches}")
    if r["score"] != 1.0:
        raise AssertionError(f"tp_blocks moe: same-backend replay scored {r['score']}, not 1.0")
    require_launched(launches, ("q4k_parts_matmul", "q4k_bank_matmul"), "the tp_blocks MoE path")
    others = [k for k in MATMUL_KERNELS + MOE_MATMUL_KERNELS
              if k not in ("q4k_parts_matmul", "q4k_bank_matmul") and launches[k]]
    if others:
        raise AssertionError(f"tp_blocks moe launched kernels off its path: {others}")
    out["moe q4k_fused"] = dict(load_s=load_s, layers=model.config.n_layer, requests=[r],
                                launches=launches)
    model.close()
    del inst, model
    torch.cuda.empty_cache()
    return out


class Served:
    """The port's HttpServer in-process on 127.0.0.1 (ephemeral port) over a
    SchedulerServer; `post`/`get` are plain HTTP clients."""

    def __init__(self, model, api=None, **sched):
        import threading

        from blama_tpu_torch.runtime.instance import InstanceInitParams
        from blama_tpu_torch.server.http import HttpServer
        from blama_tpu_torch.server.scheduler_server import SchedulerServer

        self.api = api or SchedulerServer(model, InstanceInitParams(ctx_size=2048), **sched)
        self.srv = HttpServer(("127.0.0.1", 0), self.api, request_timeout=600.0)
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}"
        self.thread = threading.Thread(target=self.srv.serve_forever, daemon=True)
        self.thread.start()

    def post(self, path, body):
        import urllib.request

        req = urllib.request.Request(self.url + path, json.dumps(body).encode(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=900) as r:
            return json.loads(r.read())

    def get(self, path):
        import urllib.request

        with urllib.request.urlopen(self.url + path, timeout=60) as r:
            return json.loads(r.read())

    def post_all(self, jobs):
        """Post (path, body) jobs concurrently; returns (responses, seconds)."""
        from concurrent.futures import ThreadPoolExecutor

        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(jobs)) as ex:
            futs = [ex.submit(self.post, path, body) for path, body in jobs]
            out = [f.result(timeout=900) for f in futs]
        return out, time.perf_counter() - t0

    def close(self):
        self.srv.shutdown()
        self.thread.join(timeout=60)
        self.srv.server_close()
        self.api.close()
        sched = getattr(self.api, "scheduler", None)
        if self.thread.is_alive() or (sched is not None and sched._thread.is_alive()):
            raise AssertionError("server threads did not stop")


def _request_body(kind, text, **kw):
    body = {"messages": [{"role": "user", "content": text}]} if kind == "chat" \
        else {"prompt": text}
    return dict(body, **kw)


PATHS = {"plain": ("/complete", "/verify_completion"),
         "chat": ("/chat/completions", "/chat/verify_completion")}


def time_breakdown(snap, wall):
    """Where the scheduler thread's time went during `wall` seconds of
    serving, from its nested timers (server/scheduler.py `_iteration`)."""
    t = {k: v["total_s"] for k, v in snap["timers"].items()}
    parts = {k: t.get(k, 0.0) for k in ("prefill", "sample", "decode_step", "decode_horizon")}
    out = dict(wall_s=wall, idle_s=t.get("idle", 0.0), iteration_s=t.get("iteration", 0.0),
               **{k + "_s": v for k, v in parts.items()})
    out["bookkeeping_s"] = out["iteration_s"] - sum(parts.values())
    for k in ("decode_step", "decode_horizon", "queue_wait"):
        c = snap["timers"].get(k)
        if c:
            out[k + "_count"], out[k + "_mean_ms"] = c["count"], c["mean_ms"]
    return out


def serving_phase(torch, model, kind):
    """This slice's main path: the HTTP server over the continuous-batching
    scheduler on the paged bf16 pool (kernels A, B, E, F), then the same
    scheduler with a tight pool (forced preemption) and on dense rows
    (kernels C and D on bf16)."""
    import numpy as np

    from blama_tpu_torch.ops import kernels

    rng = np.random.default_rng(11)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))

    def text(n_chars):
        return "".join(rng.choice(letters, n_chars))

    # 12 requests: prompts of 5 to ~300 tokens (the synthetic vocab falls
    # back to one token per byte), 32 tokens each; ten greedy, two sampled
    # with a seed (these force the per-token path and the mode transition)
    n_gen = 32
    specs = [("plain", 1), ("chat", 3), ("plain", 100), ("plain", 100), ("plain", 100),
             ("chat", 40), ("plain", 296), ("chat", 200), ("plain", 17), ("plain", 150),
             ("plain", 30), ("chat", 60)]
    reqs = []
    for i, (kind_i, n_chars) in enumerate(specs):
        sampled = i in (5, 10)
        reqs.append((kind_i, _request_body(
            kind_i, text(n_chars), max_tokens=n_gen,
            **(dict(temp=0.8, seed=100 + i) if sampled else dict(temp=0.0)))))
    greedy = [i for i, (_, body) in enumerate(reqs) if body["temp"] == 0.0]

    def tokens_of(resp):
        return [t["id"] for t in resp["tokenData"]]

    # -- paged pool, horizon 8: the main path --------------------------------
    srv = Served(model, max_batch=8, paged=True, horizon=8)
    try:
        kernels.reset_launches()
        resps, wall = srv.post_all([(PATHS[k][0], body) for k, body in reqs])
        torch.cuda.synchronize()
        gen_launches = dict(kernels.LAUNCHES)
        n_tok = sum(len(r["tokenData"]) for r in resps)
        for i, r in enumerate(resps):
            if len(r["tokenData"]) != n_gen or r.get("finish_reason") != "length" \
                    or any(len(t["logits"]) != 10 for t in r["tokenData"]):
                raise AssertionError(f"request {i}: short or malformed response "
                                     f"({len(r['tokenData'])} tokens, {r.get('finish_reason')})")
            for t in r["tokenData"]:
                for lg in t["logits"]:
                    if not abs(lg["logit"]) < float("inf"):
                        raise AssertionError(f"request {i}: non-finite logit")
        snap = srv.get("/metrics")["scheduler"]
        log(f"serving (paged, horizon 8, 8 rows): {len(reqs)} requests, {n_tok} tokens in "
            f"{wall:.2f} s = {n_tok / wall:.1f} tok/s over all rows on {kind}; "
            f"prefilled {snap['tokens_prefilled']} tokens, TTFT (mean prefill of an "
            f"admission batch) {snap['ttft_mean_s']} s")
        log(f"serving scheduler metrics {snap}")
        breakdown = time_breakdown(snap, wall)
        log(f"serving time breakdown (scheduler thread, generation) {breakdown}")
        log(f"serving launches (generation) {gen_launches}")
        verify_jobs = [(PATHS[reqs[i][0]][1], {"request": reqs[i][1], "response": resps[i]})
                       for i in greedy]
        scores, vwall = srv.post_all(verify_jobs)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        log(f"serving verify: {[s['result'] for s in scores]} in {vwall:.2f} s")
        for i, sc in zip(greedy, scores, strict=True):
            if sc["result"] != 1.0:
                raise AssertionError(
                    f"request {i}: scheduler replay scored {sc['result']}, not 1.0")
        log(f"serving launches (generation + verify) {launches}")
        require_launched(launches, ("w4a8_gemv", "q4k_dequant_matmul",
                                    "paged_decode_attention", "paged_prefill_attention"),
                         "the serving phase")
        if launches["decode_attention"] or launches["prefill_attention"]:
            raise AssertionError("the paged scheduler launched a dense attention kernel")
        result = dict(requests=len(reqs), tokens=n_tok, wall_s=wall, tok_s=n_tok / wall,
                      verify_wall_s=vwall, scheduler=srv.get("/metrics")["scheduler"],
                      generation_breakdown=breakdown)
        # the uncontended reference of the tight-pool run below: three
        # 104-token prompts again, 64 tokens each (two pages per row)
        tight, n_long = [2, 3, 4], 64
        long_jobs = [(PATHS["plain"][0], dict(reqs[i][1], max_tokens=n_long)) for i in tight]
        long_ref = [tokens_of(r) for r in srv.post_all(long_jobs)[0]]
        for i, ref in zip(tight, long_ref, strict=True):
            if len(ref) != n_long or ref[:n_gen] != tokens_of(resps[i]):
                raise AssertionError(f"request {i}: a longer run changed its first tokens")
    finally:
        srv.close()
    del srv
    torch.cuda.empty_cache()

    # -- tight pool over HTTP: the same three requests on 3 pages. Each row
    # needs two pages to finish and a third must stay free for admission, so
    # whatever the arrival order, two rows are admitted, one takes the last
    # page at its boundary (24 tokens in) and the other is preempted there,
    # requeues and resumes by re-prefilling prompt + generated. A resumed row
    # continues with re-prefill numerics (kernels B/F over what A/E decoded),
    # as in the reference: what is guaranteed, and held here, is that every
    # request finishes with its full budget and that its tokens before the
    # preemption are the uncontended run's ----------------------------------
    srv = Served(model, max_batch=8, paged=True, horizon=8, n_pages=3)
    sched = srv.api.scheduler
    seen, submit = [], sched.submit

    def recording_submit(r):
        if not any(r is x for x in seen):
            seen.append(r)
        submit(r)

    sched.submit = recording_submit
    try:
        kernels.reset_launches()
        h_resps, h_wall = srv.post_all(long_jobs)
        torch.cuda.synchronize()
        h_snap = srv.get("/metrics")["scheduler"]
    finally:
        srv.close()
    del srv, sched
    torch.cuda.empty_cache()
    prompts = [model.vocab.tokenize(reqs[i][1]["prompt"], True, True) for i in tight]
    n_prompt = sum(len(p) for p in prompts)
    cuts = []
    for i, p, r, ref in zip(tight, prompts, h_resps, long_ref, strict=True):
        req = next(x for x in seen if x.prompt == p)
        got = tokens_of(r)
        cut = req.preempted_at[0] if req.preempted_at else n_long
        same = sum(1 for a, b in zip(got, ref) if a == b)
        log(f"tight pool over HTTP, request {i}: {r.get('finish_reason')}, {len(got)} tokens, "
            f"preempted at {req.preempted_at}, {same} equal to the uncontended run's")
        if r.get("finish_reason") != "length" or len(got) != n_long:
            raise AssertionError(f"request {i}: tight pool gave {r.get('finish_reason')}, "
                                 f"{len(got)} tokens")
        if got[:cut] != ref[:cut]:
            raise AssertionError(f"request {i}: tokens before the preemption at {cut} "
                                 f"differ: {got[:cut]} vs {ref[:cut]}")
        cuts.append(list(req.preempted_at))
    log(f"tight pool over HTTP (3 pages): {len(tight)} requests x {n_long} tokens in "
        f"{h_wall:.2f} s, prefilled {h_snap['tokens_prefilled']} tokens for {n_prompt} "
        f"prompt tokens; {time_breakdown(h_snap, h_wall)}")
    if not any(cuts) or h_snap["tokens_prefilled"] <= n_prompt:
        raise AssertionError("the tight pool over HTTP forced no preemption")
    result["tight_pool_http"] = dict(
        requests=len(tight), tokens_each=n_long, wall_s=h_wall, preempted_at=cuts,
        prompt_tokens=n_prompt, tokens_prefilled=h_snap["tokens_prefilled"])

    # -- the same pool driven synchronously through the scheduler's own API,
    # 32 tokens each: all three requests are queued before the first
    # iteration, so the admission order, and with it the whole run, is fixed:
    # a second drive must give the same tokens and top-10 logits bit for bit.
    # Two rows reach their page boundary together after 24 tokens; one takes
    # the last free page, the other is preempted, requeues behind the third
    # request and resumes by re-prefilling its prompt and the tokens it had
    # generated. Its tokens up to the preemption equal the uncontended run's;
    # those after it are held exactly against a request whose prompt is that
    # re-prefill, served alone on an ample pool: kernels B and F give a row
    # its bits whatever the chunk, the batch and the page placement, so the
    # two caches and every later token and logit must be the same. (Against
    # the uncontended run the tokens after the resume hold only where the
    # argmax margin exceeds the drift between the decoded and the
    # re-prefilled cache; where the first one does not is logged.) --------
    from blama_tpu_torch.runtime.sampler import SamplerParams
    from blama_tpu_torch.server.scheduler import ContinuousBatchingScheduler, GenRequest

    def drive(jobs, n_pages):
        """Queue (key, prompt, max_tokens) jobs, greedy, and run the
        scheduler until idle; n_pages 0 is the default (ample) pool."""
        sched = ContinuousBatchingScheduler(model, max_batch=8, ctx_size=2048, paged=True,
                                            horizon=8, n_pages=n_pages)
        out = {}
        t_reqs = [GenRequest(prompt=p, max_tokens=n,
                             sampler_params=SamplerParams(rng_seed=0, temp=0.0, top_p=0.95),
                             on_done=lambda preds, i=i: out.__setitem__(i, preds))
                  for i, p, n in jobs]
        kernels.reset_launches()
        t0 = time.perf_counter()
        for r in t_reqs:
            sched.submit(r)
        sched.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        snap = sched.metrics.snapshot()
        del sched
        torch.cuda.empty_cache()
        return t_reqs, out, wall, snap

    tight_jobs = [(i, p, n_gen) for i, p in zip(tight, prompts, strict=True)]
    t_reqs, t_preds, t_wall, snap = drive(tight_jobs, 3)
    again_reqs, again, _, _ = drive(tight_jobs, 3)
    log(f"tight pool (3 pages): {len(tight)} requests ({[len(p) for p in prompts]} prompt "
        f"tokens) in {t_wall:.2f} s, prefilled {snap['tokens_prefilled']} tokens for "
        f"{n_prompt} prompt tokens")
    if snap["tokens_prefilled"] <= n_prompt:
        raise AssertionError("the tight pool forced no preemption (nothing was re-prefilled)")
    resumed, n_held = [], 0
    for i, p, r, r2 in zip(tight, prompts, t_reqs, again_reqs, strict=True):
        got, ref = [x.token for x in t_preds[i]], tokens_of(resps[i])
        cut = r.preempted_at[0] if r.preempted_at else len(ref)
        same = sum(1 for a, b in zip(got, ref) if a == b)
        log(f"tight pool request {i}: {r.finish_reason}, {len(got)} tokens, "
            f"preempted at {r.preempted_at}, {same} equal to the uncontended run's")
        if r.finish_reason != "length" or len(got) != n_gen or got[:cut] != ref[:cut]:
            raise AssertionError(
                f"request {i}: tight-pool run gave {r.finish_reason} {got} vs {ref} "
                f"(preempted at {r.preempted_at})")
        if r2.preempted_at != r.preempted_at or \
                [(x.token, x.logits) for x in again[i]] != [(x.token, x.logits) for x in t_preds[i]]:
            raise AssertionError(f"request {i}: a second drive of the tight pool differs")
        # every resume against its re-prefill served alone, up to the next cut
        for c, e in zip(r.preempted_at, r.preempted_at[1:] + [n_gen]):
            _, alone, _, _ = drive([(i, p + got[:c], e - c)], 0)
            mine = [(x.token, x.logits) for x in t_preds[i][c:e]]
            if [(x.token, x.logits) for x in alone[i]] != mine:
                raise AssertionError(
                    f"request {i}: after the resume at {c} the tokens or logits differ from "
                    f"its re-prefill served alone: {got[c:e]} vs {[x.token for x in alone[i]]}")
            n_held += e - c
            log(f"tight pool request {i}: tokens {c}..{e - 1} after the resume equal, with "
                f"their top-10 logits, those of its re-prefill served alone")
        first = next((k for k, (a, b) in enumerate(zip(got, ref)) if a != b), None)
        if first is not None:
            # the step whose logits chose token `first`: the same input token
            # in both runs, logits apart only by the re-prefilled cache
            mine = {t.token: t.logit for t in t_preds[i][first - 1].logits}
            theirs = sorted(resps[i]["tokenData"][first - 1]["logits"], key=lambda t: -t["logit"])
            margin = theirs[0]["logit"] - theirs[1]["logit"]
            drift = max(abs(mine[t["id"]] - t["logit"]) for t in theirs if t["id"] in mine)
            resumed.append(dict(request=i, first_differing=first, margin=margin, drift=drift))
            log(f"tight pool request {i}: first differs from the uncontended run at token "
                f"{first}, after the resume at {cut}; the uncontended top-1 margin there "
                f"{margin:.5f}, the logit drift {drift:.5f}")
    if not n_held:
        raise AssertionError("the tight pool resumed no request")
    log("tight pool: a second drive gave the same tokens and top-10 logits bit for bit")
    result["tight_pool"] = dict(requests=len(tight), wall_s=t_wall, prompt_tokens=n_prompt,
                                tokens_prefilled=snap["tokens_prefilled"], resumed=resumed,
                                tokens_held_after_resume=n_held)

    # -- dense rows: kernels C and D on the bf16 cache ------------------------
    some = greedy[:6]
    srv = Served(model, max_batch=8, paged=False, horizon=8)
    try:
        kernels.reset_launches()
        d_resps, d_wall = srv.post_all([(PATHS[reqs[i][0]][0], reqs[i][1]) for i in some])
        torch.cuda.synchronize()
        dense_launches = dict(kernels.LAUNCHES)
    finally:
        srv.close()
    del srv
    torch.cuda.empty_cache()
    log(f"dense scheduler: {len(some)} requests in {d_wall:.2f} s; launches {dense_launches}")
    require_launched(dense_launches, ("w4a8_gemv", "q4k_dequant_matmul", "decode_attention",
                                      "prefill_attention"), "the dense-scheduler check")
    for i, r in zip(some, d_resps, strict=True):
        if tokens_of(r) != tokens_of(resps[i]):
            raise AssertionError(f"request {i}: dense rows gave other tokens than the paged pool")
    result["dense"] = dict(requests=len(some), wall_s=d_wall)
    result["graphs"] = scheduler_graphs(torch, model)
    return result, launches, dense_launches


def scheduler_graphs(torch, model):
    """The serving step graphed against eager launches: the paged scheduler,
    8 rows, horizon 8, drives the same 8 requests (six greedy; two sampled
    from a seed, which hold the batch on the per-token step, a graph at
    (8, 1)), then verifies the greedy ones: the graphed run's tokens and
    top-10 logits must be the eager run's bit for bit, its launch counts the
    same, every verify 1.0 (dense rows: the card tests, on the tiny
    fixture). Then the 8-row paged serving step's wall, device busy and
    idle share, graphed and eager (tools/profile_step.py's scheduler_steps
    and measure, 16 steps)."""
    import numpy as np

    from blama_tpu_torch.ops import kernels
    from blama_tpu_torch.runtime.sampler import SamplerParams
    from blama_tpu_torch.server.scheduler import (ContinuousBatchingScheduler, GenRequest,
                                                  VerifyRequest)
    from blama_tpu_torch.tools import profile_step as ps

    rng = np.random.default_rng(37)
    prompts = [[1] + rng.integers(259, model.config.n_vocab, n - 1).tolist()
               for n in (5, 40, 128, 17, 30, 64, 9, 100)]
    sampled = (3, 6)
    runs = {}
    for graphs in (True, False):
        kernels.reset_launches()
        sched = ContinuousBatchingScheduler(model, max_batch=8, ctx_size=2048, paged=True,
                                            horizon=8, graphs=graphs)
        got, scores = {}, {}
        t0 = time.perf_counter()
        for i, p in enumerate(prompts):
            sp = (SamplerParams(rng_seed=100 + i, temp=0.8) if i in sampled
                  else SamplerParams(temp=0.0))
            sched.submit(GenRequest(prompt=p, max_tokens=16, sampler_params=sp,
                                    on_done=lambda g, i=i: got.__setitem__(i, g)))
        sched.run_until_idle()
        for i, p in enumerate(prompts):
            if i not in sampled:
                sched.submit(VerifyRequest(prompt=p, predictions=got[i],
                                           on_done=lambda sc, i=i: scores.__setitem__(i, sc)))
        sched.run_until_idle()
        torch.cuda.synchronize()
        runs[graphs] = dict(bits=_record_bits([(p, got[i]) for i, p in enumerate(prompts)]),
                            scores=scores, launches=dict(kernels.LAUNCHES),
                            wall_s=time.perf_counter() - t0,
                            captures=sched._graphs.captures if graphs else None)
        del sched
        torch.cuda.empty_cache()
    g, e = runs[True], runs[False]
    if g["bits"] != e["bits"]:
        raise AssertionError("paged scheduler: graphed tokens or top-10 differ from eager")
    if g["launches"] != e["launches"]:
        raise AssertionError(f"paged scheduler: launches graphed {g['launches']} != "
                             f"eager {e['launches']}")
    if set(g["scores"].values()) != {1.0} or g["scores"] != e["scores"]:
        raise AssertionError(f"paged scheduler: verify {g['scores']} / {e['scores']}")
    out = dict(paged=dict(wall_s_graphed=g["wall_s"], wall_s_eager=e["wall_s"],
                          captures=g["captures"], launches=g["launches"]))
    log(f"graphs: paged scheduler, 8 requests + 6 verifies: graphed = eager bit for bit, "
        f"launches equal, verify 1.0; {g['wall_s']:.2f} s graphed, {e['wall_s']:.2f} s eager")
    for way in ("graphed", "eager"):
        steps, held = ps.scheduler_steps(model, 48, 2048, way == "graphed")
        m = ps.measure(steps, 16, 16, host_ops=False)
        out[f"step_{way}"] = {k: m[k] for k in (
            "wall_ms_per_step", "device_span_ms_per_step", "device_busy_ms_per_step",
            "busy_from", "device_launches_per_step", "idle_share")}
        if held:
            out[f"step_{way}"].update(captures=held.captures, graphs_gib=held.pool_gib())
        del steps, held
        torch.cuda.empty_cache()
    g, e = out["step_graphed"], out["step_eager"]
    log(f"graphs: the 8-row paged serving step, graphed / eager: wall "
        f"{g['wall_ms_per_step']:.2f} / {e['wall_ms_per_step']:.2f} ms, busy "
        f"{g['device_busy_ms_per_step']} / {e['device_busy_ms_per_step']} ms (span "
        f"{g['device_span_ms_per_step']:.2f} / {e['device_span_ms_per_step']:.2f}), idle "
        f"{g['idle_share']:.3f} / {e['idle_share']:.3f}")
    return out


def _tiny_replay(path, prover, verifier):
    """The tiny fixture: `prover` = (engine, device) generates 12 greedy
    tokens, `verifier` replays them; returns the replay's score."""
    from blama_tpu_torch.runtime.instance import Instance, InstanceInitParams
    from blama_tpu_torch.runtime.model import Model, ModelParams
    from blama_tpu_torch.runtime.session import CompleteParams, SessionInitParams
    from blama_tpu_torch.runtime.verify import LogitComparer, MetricsAggregator

    preds = None
    for dtype, dev in (prover, verifier):
        m = Model(path, ModelParams(dtype=dtype, attn="fused", device=dev))
        inst = Instance(m, InstanceInitParams(ctx_size=64, flash_attn=True, kv_dtype="int8"))
        s = inst.start_session(SessionInitParams(seed=11, temperature=0.0))
        s.set_initial_prompt(m.vocab.tokenize("hello world the cat sat", True, True))
        if preds is None:
            preds = s.complete(CompleteParams(max_tokens=12))
        else:
            replayed = s.fill_ctx(preds)
        m.close()
    agg, sims = MetricsAggregator(), []
    for a, b in zip(preds, replayed, strict=True):
        score = agg.push_and_verify(LogitComparer.compare(a.logits, b.logits))
        sims.append(LogitComparer.logit_similarity(a.logits, b.logits))
    return dict(tokens=len(sims), score=score, mean_similarity=sum(sims) / len(sims))


def small_phase(torch):
    """Tiny fixture, held to the reference's thresholds (score >= 0.95, mean
    similarity >= 0.98): proven on the card and replayed by the port on the
    CPU; and on the card across engines, the W4A8 prover replayed by the exact
    engine, and the plain-PyTorch W4A8 engine (`q4k_a8_xla`, run at this size
    only) replayed by `q4k_a8`."""
    from blama_tpu_torch.testing import write_tiny_llama

    path = str(Path(tempfile.gettempdir()) / "blama_tpu_torch-tiny.gguf")
    write_tiny_llama(path)
    out = {}
    for name, prover, verifier in (
            ("card prover -> CPU verifier", ("q4k_a8", "cuda"), ("q4k_a8", "cpu")),
            ("q4k_a8 -> q4k_fused, on the card", ("q4k_a8", "cuda"), ("q4k_fused", "cuda")),
            ("q4k_a8_xla -> q4k_a8, on the card", ("q4k_a8_xla", "cuda"), ("q4k_a8", "cuda"))):
        res = _tiny_replay(path, prover, verifier)
        log(f"small ({name}): {res}")
        if not (res["score"] >= 0.95 and res["mean_similarity"] >= 0.98):
            raise AssertionError(f"small ({name}): replay below thresholds: {res}")
        out[name] = res
    return out


# the tools phase: each tool's main at short settings (module, argv, env);
# the widths are the tools' own, the repetitions cut
TOOL_RUNS = (
    ("probe_bw", ["--reps", "1"], {}),
    ("probe_overhead", ["--reps", "2"], {}),
    ("probe_ceiling", ["--gb", "2", "--shape-layers", "8", "--reps", "2"], {}),
    ("autotune_a8s", ["--shapes", "wo,down,head", "--block-n", "16,64,2048", "--r-lo", "1",
                      "--r-hi", "3", "--reps", "1"], {}),
    ("ab_a8k4", ["--reps", "10"], {}),
    ("bench_serving", ["llama3-8b", "q4k_a8"],
     dict(BLAMA_SERVE_STREAMS="8", BLAMA_SERVE_TOKENS="16", BLAMA_SERVE_PROMPT="32")),
    ("profile_load", ["llama3-8b"], {}),
    ("trace_step", ["llama3-8b", "4", "--top", "12"], {}),
    ("ubench_q4k", ["--layers", "4", "--reps", "1"], {}),
    ("probe_swar", ["--rows", "2048", "--cols", "14336"], {}),
    ("probe_mosaic", ["--rows", "2048", "--cols", "14336"], {}),
    ("probe_casts", [], {}),
    ("ubench_attn", ["--reps", "1"], {}),
    ("ubench_paged", ["--reps", "1"], {}),
)
PROBE_KERNELS = ("swar_roundtrip", "swar_lo_hi", "swar_dot", "u8_bitops", "i16_bitops",
                 "i8_dot", "unpack_dot")
TOOL_KERNELS = ("w4a8_slab_gemv", "w4a8k4_slab_gemv", "stream_rows", "add_one",
                "q4k_twodot_matmul", "w4a8_plane_matmul", "w4a8_packed_matmul",
                *PROBE_KERNELS, *(f"casts_{c}" for c in CAST_NAMES))


# the perplexity tools' run: the llama3-8b file cut to PPL_LAYERS layers,
# windows of PPL_CTX tokens
PPL_LAYERS, PPL_CTX = 2, 128
PPL_TEXT = " ".join(f"Line {i}: the quick brown fox jumps over the lazy dog, {i * 7} times."
                    for i in range(3))


def _ppl_tools(torch):
    """tools/ppl_compare through its main (two windows of PPL_CTX tokens
    under bfloat16, q4k_fused and q4k_a8 on the llama3-8b file cut to
    PPL_LAYERS layers), then tools/perplexity's main on the same file as
    bfloat16 over a text file: each perplexity finite, and perplexity() on
    ppl_compare's corpus under bfloat16 equal to its bfloat16 line."""
    import math

    from blama_tpu_torch.runtime.model import Model, ModelParams
    from blama_tpu_torch.testing import cached_llama_gguf
    from blama_tpu_torch.tools import perplexity as pp
    from blama_tpu_torch.tools import ppl_compare as pc

    cmp = pc.main(["llama3-8b", str(PPL_CTX), "2", "--layers", str(PPL_LAYERS)])
    path = cached_llama_gguf("llama3-8b", n_layer=PPL_LAYERS)
    with tempfile.TemporaryDirectory() as d:
        text = Path(d) / "text.txt"
        text.write_text(PPL_TEXT, encoding="utf-8")
        res = pp.main([path, str(text), "--ctx", str(PPL_CTX)])
    m = Model(path, ModelParams(dtype="bfloat16"))
    try:
        again = pp.perplexity(m, pc.corpus(m.config.n_vocab, PPL_CTX, 2), PPL_CTX)
    finally:
        m.close()
    ppls = [*cmp["ppl"].values(), res["ppl"], again["ppl"]]
    if not all(math.isfinite(v) and v > 1.0 for v in ppls):
        raise AssertionError(f"perplexity tools: {cmp['ppl']}, text {res}, corpus {again}")
    if round(again["ppl"], 4) != cmp["ppl"]["bfloat16"]:
        raise AssertionError(f"perplexity {again['ppl']} on ppl_compare's corpus differs from "
                             f"its bfloat16 line {cmp['ppl']['bfloat16']}")
    return dict(ppl_compare=cmp, perplexity=res, perplexity_on_corpus=again)


def tools_phase(torch):
    """The tools slices' main path: the card's kernel tools (python -m
    blama_tpu_torch.tools.<name>), each run once through its main at short
    settings on the 8B shapes and file, the launch counts set to 0 before the
    first and read after the last. Q runs in probe_ceiling, autotune_a8s,
    ab_a8k4 and ubench_q4k, T in ab_a8k4, R in probe_bw, S in probe_overhead
    (whose graph run checks that a ctypes launch is captured), U and V in
    ubench_q4k, W in probe_swar, X in probe_mosaic, Y in probe_casts; then
    the perplexity tools (_ppl_tools) on the dense and packed engines."""
    import importlib
    import os

    from blama_tpu_torch.ops import kernels

    out = {}
    kernels.reset_launches()
    for name, argv, env in TOOL_RUNS:
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        t0 = time.perf_counter()
        try:
            res = importlib.import_module(f"blama_tpu_torch.tools.{name}").main(argv)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        out[name] = dict(seconds=time.perf_counter() - t0, result=res)
        log(f"tools: {name} {' '.join(argv)} ran in {out[name]['seconds']:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["perplexity tools"] = dict(_ppl_tools(torch), seconds=time.perf_counter() - t0)
    log(f"tools: perplexity and ppl_compare ran in {out['perplexity tools']['seconds']:.1f} s: "
        f"{out['perplexity tools']}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    log(f"tools launches {launches}")
    require_launched(launches, TOOL_KERNELS, "the tools phase")
    if out["ab_a8k4"]["result"]["x2_vs_a8k4"] > MATMUL_TOL:
        raise AssertionError(f"ab_a8k4: x2 vs a8k4 {out['ab_a8k4']['result']['x2_vs_a8k4']}")
    # ubench_q4k's check against v0: U is the exact function in f32; the W4A8
    # variants and bf16 carry their quantization (the CPU tests: 4.4e-3)
    rel = out["ubench_q4k"]["result"]["rel_err"]
    if rel["v1"] > MATMUL_TOL or max(rel.values()) > 2e-2:
        raise AssertionError(f"ubench_q4k: max rel err vs v0 {rel}")
    return out, launches


# per kernel of the line: source, the TPU kernel it replaces, and the shape
# (a prefix of the row's label) that stands for it on the main path: the
# serving step's 8 rows for A, and the heaviest serving chunk (8 rows x
# T=256) for B, D and F; every other shape's row is in chip_smoke.json
KERNELS = {
    "w4a8_gemv": ("blama_tpu_torch/ops/csrc/quant_matmul.cu",
                  "blama_tpu/ops/pallas/quant_matmul.py:1629", "gate/up K=4096 N=14336 M=8"),
    "q4k_dequant_matmul": ("blama_tpu_torch/ops/csrc/quant_matmul.cu",
                           "blama_tpu/ops/pallas/quant_matmul.py:221",
                           "gate/up K=4096 N=14336 M=2048"),
    "decode_attention": ("blama_tpu_torch/ops/csrc/decode_attention.cu",
                         "blama_tpu/ops/pallas/decode_attention.py:106", "solo int8 "),
    "prefill_attention": ("blama_tpu_torch/ops/csrc/decode_attention.cu",
                          "blama_tpu/ops/pallas/decode_attention.py:976", "solo int8 "),
    "decode_attention_bf16": ("blama_tpu_torch/ops/csrc/decode_attention.cu",
                              "blama_tpu/ops/pallas/decode_attention.py:106",
                              "serving bf16 B=8 T=1 "),
    "prefill_attention_bf16": ("blama_tpu_torch/ops/csrc/decode_attention.cu",
                               "blama_tpu/ops/pallas/decode_attention.py:976",
                               "serving bf16 B=8 T=256 "),
    # the modes phase's kernels at the solo step (one row, S=2048), and C and
    # D on the f32 store (the solo phase's shapes; a 4th item names the row's
    # kernel where the entry's name is not it)
    "decode_attention_write": ("blama_tpu_torch/ops/csrc/decode_attention.cu",
                               "blama_tpu/ops/pallas/decode_attention.py:578",
                               "modes int8 B=1 "),
    "decode_attention_fresh": ("blama_tpu_torch/ops/csrc/decode_attention.cu",
                               "blama_tpu/ops/pallas/decode_attention.py:106",
                               "modes int8 B=1 "),
    "decode_attention_hb": ("blama_tpu_torch/ops/csrc/decode_attention.cu",
                            "blama_tpu/ops/pallas/decode_attention.py:279",
                            "modes bf16 B=1 "),
    "decode_attention_f32": ("blama_tpu_torch/ops/csrc/decode_attention.cu",
                             "blama_tpu/ops/pallas/decode_attention.py:106",
                             "solo f32 ", "decode_attention"),
    "prefill_attention_f32": ("blama_tpu_torch/ops/csrc/decode_attention.cu",
                              "blama_tpu/ops/pallas/decode_attention.py:976",
                              "solo f32 ", "prefill_attention"),
    # C, D, E and F at f32 queries (the float32 engine; the f32 store, its
    # default): C and D at the solo shapes, E and F at the serving ones
    "decode_attention_f32q": ("blama_tpu_torch/ops/csrc/attention_f32.cu",
                              "blama_tpu/ops/pallas/decode_attention.py:106", "solo f32 "),
    "prefill_attention_f32q": ("blama_tpu_torch/ops/csrc/attention_f32.cu",
                               "blama_tpu/ops/pallas/decode_attention.py:976", "solo f32 "),
    "paged_decode_attention_f32q": ("blama_tpu_torch/ops/csrc/attention_f32.cu",
                                    "blama_tpu/ops/pallas/paged_attention.py:155",
                                    "serving f32 B=8 T=1 "),
    "paged_prefill_attention_f32q": ("blama_tpu_torch/ops/csrc/attention_f32.cu",
                                     "blama_tpu/ops/pallas/paged_attention.py:155",
                                     "serving f32 B=8 T=256 "),
    "paged_decode_attention": ("blama_tpu_torch/ops/csrc/paged_attention.cu",
                               "blama_tpu/ops/pallas/paged_attention.py:155",
                               "serving bf16 B=8 T=1 "),
    "paged_prefill_attention": ("blama_tpu_torch/ops/csrc/paged_attention.cu",
                                "blama_tpu/ops/pallas/paged_attention.py:155",
                                "serving bf16 B=8 T=256 "),
    # the engines phase's kernels, at a solo decode step's one row
    "q4k_dequant_matmul_f32": ("blama_tpu_torch/ops/csrc/quant_matmul.cu",
                               "blama_tpu/ops/pallas/quant_matmul.py:221",
                               "gate/up K=4096 N=14336 M=1"),
    "q8_dequant_matmul_g32": ("blama_tpu_torch/ops/csrc/quant_matmul.cu",
                              "blama_tpu/ops/pallas/quant_matmul.py:2056",
                              "gate/up K=4096 N=14336 M=1"),
    "q8_dequant_matmul_g16": ("blama_tpu_torch/ops/csrc/quant_matmul.cu",
                              "blama_tpu/ops/pallas/quant_matmul.py:2056",
                              "lm_head K=4096 N=128256 M=1"),
    "q4k_native_matmul": ("blama_tpu_torch/ops/csrc/quant_matmul.cu",
                          "blama_tpu/ops/pallas/quant_matmul.py:938",
                          "gate/up K=4096 N=14336 M=1"),
    "w4a8k4_gemv": ("blama_tpu_torch/ops/csrc/quant_matmul.cu",
                    "blama_tpu/ops/pallas/quant_matmul.py:1071",
                    "gate/up K=4096 N=14336 M=1"),
    # the MoE phase's bank kernels at Mixtral-8x7B's widths: J and K at the
    # routed decode step (one row, 2 selected experts), K on bf16 scales at the
    # W4A8 engine's 128-row masked chunk (8 experts)
    "w4a8_bank_gemv": ("blama_tpu_torch/ops/csrc/quant_matmul.cu",
                       "blama_tpu/ops/pallas/quant_matmul.py:1792",
                       "gate/up K=4096 N=14336 M=1 sel=2 scales=bf16"),
    "q4k_bank_matmul": ("blama_tpu_torch/ops/csrc/quant_matmul.cu",
                        "blama_tpu/ops/pallas/quant_matmul.py:1811",
                        "gate/up K=4096 N=14336 M=1 sel=2 scales=f32"),
    "q4k_bank_matmul_bf16": ("blama_tpu_torch/ops/csrc/quant_matmul.cu",
                             "blama_tpu/ops/pallas/quant_matmul.py:1811",
                             "gate/up K=4096 N=14336 M=128 sel=8 scales=bf16"),
    # the tp_blocks phase's kernels: L at the exact engine's decode step (the
    # down projection's 8 partials of one row), L on bf16 scales at the W4A8
    # engine's 128-row prompt chunk, M at the W4A8 decode step
    "q4k_parts_matmul": ("blama_tpu_torch/ops/csrc/quant_matmul.cu",
                         "blama_tpu/ops/pallas/quant_matmul.py:1391",
                         "down K=14336 N=4096 M=1 nb=8 scales=f32"),
    "q4k_parts_matmul_bf16": ("blama_tpu_torch/ops/csrc/quant_matmul.cu",
                              "blama_tpu/ops/pallas/quant_matmul.py:1391",
                              "down K=14336 N=4096 M=128 nb=8 scales=bf16"),
    "w4a8_parts_gemv": ("blama_tpu_torch/ops/csrc/quant_matmul.cu",
                        "blama_tpu/ops/pallas/quant_matmul.py:1419",
                        "down K=14336 N=4096 M=1 nb=8"),
    # the tools phase's kernels: Q at probe_ceiling's FFN shape (one row, the
    # reference's kb), T at ab_a8k4's default shape, R at a block of the
    # card's size, S at probe_overhead's [8, 128]
    "w4a8_slab_gemv": ("blama_tpu_torch/ops/csrc/slab_gemv.cu",
                       "blama_tpu/ops/pallas/quant_matmul.py:771",
                       "gate/up K=4096 N=14336 M=1 kb=4"),
    "w4a8k4_slab_gemv": ("blama_tpu_torch/ops/csrc/slab_gemv.cu", "tools/ab_a8k4.py:39",
                         "gate/up K=4096 N=14336 M=1 kb=8"),
    "stream_rows": ("blama_tpu_torch/ops/csrc/probes.cu", "blama_tpu/tools/probe_bw.py:21",
                    "2048x14336 bk=64 bn=2048"),
    "add_one": ("blama_tpu_torch/ops/csrc/probes.cu", "blama_tpu/tools/probe_overhead.py:105",
                "x [8, 128] f32"),
    # ubench_q4k's kernels at its default FFN shape, one row, the reference's
    # kb; the probes at a code plane of an 8B FFN weight, Y at its own shapes
    "q4k_twodot_matmul": ("blama_tpu_torch/ops/csrc/twodot.cu",
                          "blama_tpu/tools/ubench_q4k.py:44", "gate/up K=4096 N=14336 M=1 kb=8"),
    "w4a8_plane_matmul": ("blama_tpu_torch/ops/csrc/slab_gemv.cu",
                          "blama_tpu/tools/ubench_q4k.py:111", "gate/up K=4096 N=14336 M=1 kb=4"),
    "w4a8_packed_matmul": ("blama_tpu_torch/ops/csrc/slab_gemv.cu",
                           "blama_tpu/tools/ubench_q4k.py:137",
                           "gate/up K=4096 N=14336 M=1 kb=8"),
    **{name: ("blama_tpu_torch/ops/csrc/probes.cu", f"blama_tpu/tools/{tool}.py:{line}", shape)
       for name, tool, line, shape in (
           ("swar_roundtrip", "probe_swar", 12, "x 2048x14336"),
           ("swar_lo_hi", "probe_swar", 17, "x 2048x14336"),
           ("swar_dot", "probe_swar", 25, "a 32x2048 b 2048x14336"),
           ("u8_bitops", "probe_mosaic", 22, "x 2048x14336"),
           ("i16_bitops", "probe_mosaic", 29, "x 2048x14336"),
           ("i8_dot", "probe_mosaic", 36, "a 32x2048 b 2048x14336"),
           ("unpack_dot", "probe_mosaic", 42, "a 32x2048 b 1024x14336"))},
    **{f"casts_{name}": ("blama_tpu_torch/ops/csrc/probes.cu", f"tools/probe_casts.py:{line}",
                         shape) for name, (line, shape) in CAST_LINES.items()},
}


def graphs_summary(res):
    """Per engine, graphed and eager: decode tok/s, TTFT (warm, and at its
    bucket's first use) of the GRAPH_PROMPT_LENS prompts, step wall, device
    busy and idle share; the 8-row paged serving step's. Logged as a table."""
    reports = {"solo q4k_a8": res["solo"]["report"]}
    reports.update({k: v["report"] for k, v in res["engines"].items() if isinstance(v, dict)})
    reports.update({f"moe {k}": v["report"] for k, v in res["moe"].items()
                    if isinstance(v, dict) and "report" in v})
    reports.update({f"tp_blocks {k}": v["report"] for k, v in res["tp_blocks"].items()
                    if "report" in v})
    rows = []
    for name, rep in reports.items():
        for way in ("graphed", "eager"):
            r = rep[way]
            rows.append(dict(
                engine=name, way=way, decode_tok_s=r["decode_tok_s"],
                wall_ms=r["wall_ms_per_step"], busy_ms=r["device_busy_ms_per_step"],
                span_ms=r["device_span_ms_per_step"], idle=r["idle_share"],
                ttft_warm_s=[r[f"ttft_{n}_warm_s"] for n in GRAPH_PROMPT_LENS],
                ttft_first_s=[r[f"ttft_{n}_first_s"] for n in GRAPH_PROMPT_LENS],
                graphs_gib=r.get("graphs_gib")))
    sched = res["serving"]["graphs"]
    for way in ("graphed", "eager"):
        r = sched[f"step_{way}"]
        rows.append(dict(engine="serving step, 8 rows paged (q4k_a8)", way=way,
                         wall_ms=r["wall_ms_per_step"], busy_ms=r["device_busy_ms_per_step"],
                         span_ms=r["device_span_ms_per_step"], idle=r["idle_share"],
                         graphs_gib=r.get("graphs_gib")))
    for r in rows:
        busy = f"{r['busy_ms']:.2f}" if r["busy_ms"] else "-"
        ttft = ("" if "ttft_warm_s" not in r else " TTFT warm " + " / ".join(
            f"{t:.3f}" for t in r["ttft_warm_s"]) + " s (first use " + " / ".join(
            f"{t:.3f}" for t in r["ttft_first_s"]) + ")")
        tok = f" {r['decode_tok_s']:.1f} tok/s" if "decode_tok_s" in r else ""
        log(f"graphs summary: {r['engine']:36s} {r['way']:7s} wall {r['wall_ms']:7.2f} ms "
            f"busy {busy} span {r['span_ms']:.2f} idle {r['idle']:.3f}{tok}{ttft}")
    return rows


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
    res = {}
    with torch.no_grad():
        timer = Timer(torch)
        rows = kernel_phase(torch, timer, np.random.default_rng(0))
        t_sweep = time.perf_counter()
        res["tile_sweep"] = tile_sweep(torch, timer, np.random.default_rng(6))
        log(f"tile sweep took {time.perf_counter() - t_sweep:.1f} s")
        t_sweep = time.perf_counter()
        res["row_sweep"] = row_sweep(torch, timer, np.random.default_rng(7))
        log(f"row sweep took {time.perf_counter() - t_sweep:.1f} s")
        rows += engine_kernel_phase(torch, timer, np.random.default_rng(1))
        rows += attention_phase(torch, timer)
        rows += f32_query_attention_phase(torch, timer)
        t_geo = time.perf_counter()
        rows += geometry_phase(torch, timer)
        log(f"geometry phase took {time.perf_counter() - t_geo:.1f} s")
        res["prefill_split_sweep"] = prefill_split_sweep(torch, timer)
        res["decode_split_sweep"] = decode_split_sweep(torch, timer)
        rows += bank_kernel_phase(torch, timer, np.random.default_rng(2))
        rows += moe_dense_kernel_phase(torch, timer, np.random.default_rng(3))
        rows += tp_kernel_phase(torch, timer, np.random.default_rng(4))
        rows += modes_kernel_phase(torch, timer)
        rows += tools_kernel_phase(torch, timer, np.random.default_rng(5))
        t_new = time.perf_counter()
        rows += ubench_kernel_phase(torch, timer)
        rows += probes_kernel_phase(torch, timer)
        log(f"U-Y kernel phases took {time.perf_counter() - t_new:.1f} s")
        del timer
        res["rows_mm_ms"] = rows_mm_cost(torch)
        res["dense_prompt_cost"] = dense_prompt_cost(torch, Timer(torch))
        torch.cuda.empty_cache()
        log(f"kernel phases done at {time.perf_counter() - t_start:.1f} s")
        model, res["load_s"] = load_8b(torch, kind)
        a8_record = []
        res["solo"], solo_l = solo_phase(torch, model, kind, a8_record)
        log(f"solo phase done at {time.perf_counter() - t_start:.1f} s")
        res["modes"] = modes_phase(torch, model, kind)
        log(f"modes phase done at {time.perf_counter() - t_start:.1f} s")
        res["serving"], serve_l, dense_l = serving_phase(torch, model, kind)
        log(f"serving phase done at {time.perf_counter() - t_start:.1f} s")
        model.close()
        del model
        torch.cuda.empty_cache()
        res["head_dim_96"] = head_dim_96_phase(torch, kind)
        log(f"head-dim-96 phase done at {time.perf_counter() - t_start:.1f} s")
        tp0_records = {"q4k_a8": a8_record}
        res["engines"] = engines_phase(torch, kind, a8_record, tp0_records)
        del a8_record
        log(f"engines phase done at {time.perf_counter() - t_start:.1f} s")
        res["moe"] = moe_phase(torch, kind)
        log(f"moe phase done at {time.perf_counter() - t_start:.1f} s")
        res["tp_blocks"] = tp_blocks_phase(torch, kind, tp0_records)
        del tp0_records
        log(f"tp_blocks phase done at {time.perf_counter() - t_start:.1f} s")
        res["small"] = small_phase(torch)
        log(f"small phase done at {time.perf_counter() - t_start:.1f} s")
        res["tools"], tools_l = tools_phase(torch)
        log(f"tools phase done at {time.perf_counter() - t_start:.1f} s")
        res["dense"] = dense_phase(torch, kind)
        log(f"dense phase done at {time.perf_counter() - t_start:.1f} s")

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    report = dict(nvidia_smi=smi, device=kind, torch=torch.__version__,
                  cuda=torch.version.cuda, build_s=build_s, kernel_rows=rows,
                  launches=dict(solo=solo_l, serving=serve_l, dense_scheduler=dense_l,
                                tools=tools_l), **res)

    # launches of the line: each kernel's count from the run of the path it
    # belongs to, counts set to 0 just before that path and read just after.
    # A and B: the serving phase (they also ran on the solo path, `solo_launches`)
    line_launches = {
        "w4a8_gemv": serve_l["w4a8_gemv"], "q4k_dequant_matmul": serve_l["q4k_dequant_matmul"],
        "decode_attention": solo_l["decode_attention"],
        "prefill_attention": solo_l["prefill_attention"],
        "decode_attention_bf16": dense_l["decode_attention"],
        "prefill_attention_bf16": dense_l["prefill_attention"],
        "paged_decode_attention": serve_l["paged_decode_attention"],
        "paged_prefill_attention": serve_l["paged_prefill_attention"],
    }
    # the modes phase: each mode's kernel from its first run, C and D on f32
    # from the mode-off f32 run
    modes = res["modes"]
    line_launches.update({
        "decode_attention_write": modes["write int8"]["launches"]["decode_attention_write"],
        "decode_attention_fresh": modes["fresh int8"]["launches"]["decode_attention_fresh"],
        "decode_attention_hb": modes["hb bfloat16"]["launches"]["decode_attention_hb"],
        "decode_attention_f32": modes["off float32"]["launches"]["decode_attention"],
        "prefill_attention_f32": modes["off float32"]["launches"]["prefill_attention"],
    })
    # the engines phase: each kernel's count from the engine that owns it
    eng = {k: v["launches"] for k, v in res["engines"].items() if isinstance(v, dict)}
    line_launches.update({
        "q4k_dequant_matmul_f32": eng["q4k_fused"]["q4k_dequant_matmul"],
        "q8_dequant_matmul_g32": eng["q8_0_fused on Q8_0"]["q8_dequant_matmul"],
        "q8_dequant_matmul_g16": eng["q4k_a8 on Q4_K_M"]["q8_dequant_matmul"],
        "q4k_native_matmul": eng["q4k_fused_k4"]["q4k_native_matmul"],
        "w4a8k4_gemv": eng["q4k_a8_k4"]["w4a8k4_gemv"],
    })
    # the MoE phase: J from the W4A8 model's solo path, K on f32 scales from
    # the exact model's, K on bf16 scales from the W4A8 model's
    moe_l = {k: res["moe"][k]["launches"] for k in ("q4k_a8", "q4k_fused")}
    line_launches.update({
        "w4a8_bank_gemv": moe_l["q4k_a8"]["w4a8_bank_gemv"],
        "q4k_bank_matmul": moe_l["q4k_fused"]["q4k_bank_matmul"],
        "q4k_bank_matmul_bf16": moe_l["q4k_a8"]["q4k_bank_matmul"],
    })
    # the tp_blocks phase: L from the exact engine's solo path, L on bf16
    # scales and M from the W4A8 engine's
    tp_l = {k: res["tp_blocks"][k]["launches"] for k in ("q4k_fused", "q4k_a8")}
    line_launches.update({
        "q4k_parts_matmul": tp_l["q4k_fused"]["q4k_parts_matmul"],
        "q4k_parts_matmul_bf16": tp_l["q4k_a8"]["q4k_parts_matmul"],
        "w4a8_parts_gemv": tp_l["q4k_a8"]["w4a8_parts_gemv"],
    })
    line_launches.update({k: tools_l[k] for k in TOOL_KERNELS})
    # the dense phase: C and D at f32 queries from the float32 engine's solo
    # path, E and F from its scheduler
    dense = res["dense"]
    line_launches.update({
        "decode_attention_f32q": dense["float32 fused"]["launches"]["decode_attention_f32q"],
        "prefill_attention_f32q": dense["float32 fused"]["launches"]["prefill_attention_f32q"],
        "paged_decode_attention_f32q":
            dense["float32 serving launches"]["paged_decode_attention_f32q"],
        "paged_prefill_attention_f32q":
            dense["float32 serving launches"]["paged_prefill_attention_f32q"],
    })
    kernels_line = []
    for name, (source, replaces, shape, *row_kernel) in KERNELS.items():
        base = row_kernel[0] if row_kernel else name.removesuffix("_bf16")
        r = next(c for c in rows if c["kernel"] == base
                 and (c["shape"] + " ").startswith(shape.rstrip() + " "))
        entry = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=line_launches[name], max_abs_err=r["max_abs_err"], ms=r["kernel_ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], shape=r["shape"])
        # the exact tiles' f32 yardsticks; the decode kernels' single-launch times
        for key in ("library_f32_ms", "bound_f32_ms", "bound_f32_by", "event_ms",
                    "library_event_ms"):
            if key in r:
                entry[key] = r[key]
        if name == base and solo_l.get(base):
            entry["solo_launches"] = solo_l[base]
        if entry["launches"] == 0:
            raise AssertionError(f"{name}: not launched on its path")
        kernels_line.append(entry)
    report["graphs_summary"] = graphs_summary(res)
    report["seconds"] = time.perf_counter() - t_start
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(f"total {report['seconds']:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--decode-timing"]:
        sys.exit(decode_timing_main(sys.argv[2] if len(sys.argv) > 2 else str(ROOT)))
    if sys.argv[1:2] == ["--matmul-timing"]:
        sys.exit(matmul_timing_main(sys.argv[2] if len(sys.argv) > 2 else str(ROOT)))
    if sys.argv[1:2] == ["--tools-timing"]:
        sys.exit(tools_timing_main(sys.argv[2] if len(sys.argv) > 2 else str(ROOT)))
    sys.exit(main())
