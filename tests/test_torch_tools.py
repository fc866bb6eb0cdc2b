"""The tools' kernels (Q, T, R, S) against the JAX package's, and each
tool's main on the CPU.

Same numpy-seeded inputs through both. The JAX side runs un-jitted (XLA's
CPU backend divides amax / 127 through a reciprocal under jit, ROADMAP.md §3)
with its Pallas kernels in interpret mode: w4a8_swar_matmul (kernel Q's
reference), tools/ab_a8k4.py's x2_matmul (T's), blama_tpu/tools/probe_bw.py's
stream (R's) and probe_overhead's tiny kernel (S's). The port's wrappers run
their plain PyTorch versions (a CPU tensor never reaches a CUDA kernel).
Tolerances: Q and T 1e-4 x max|ref| (f32 sums of the same group terms in
another order), activation codes and scales exact; R and S exact (integer
sums; one f32 add).

Importing the reference's tool modules points jax's persistent compilation
cache at their own directory (e.g. tools/ab_a8k4.py:17-20); the config is
put back right after, so no other test on the same worker sees it.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from blama_tpu.gguf.quants import quantize_q4_k
from blama_tpu.ops.pallas import quant_matmul as jqm
from blama_tpu_torch.ops import probes
from blama_tpu_torch.ops import quant_matmul as qm

torch.set_num_threads(1)   # tiny shapes: threads only contend with the other test workers

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = 1e-4
_CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_entry_size_bytes",
               "jax_persistent_cache_min_compile_time_secs")


def _import_reference(name, path):
    """Import a reference tool module, then put back the jax config its
    import changed."""
    before = {k: jax.config.values[k] for k in _CACHE_KEYS}
    try:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for k, v in before.items():
            jax.config.update(k, v)
    return mod


@pytest.fixture(scope="module")
def ref_tools():
    return {n: _import_reference(f"_ref_{n}", p) for n, p in (
        ("ab_a8k4", ROOT / "tools" / "ab_a8k4.py"),
        ("probe_bw", ROOT / "blama_tpu" / "tools" / "probe_bw.py"),
        ("probe_overhead", ROOT / "blama_tpu" / "tools" / "probe_overhead.py"))}


def test_reference_import_leaves_the_cache_config_as_it_was(ref_tools):
    before = {k: jax.config.values[k] for k in _CACHE_KEYS}
    _import_reference("_ref_ab_a8k4_again", ROOT / "tools" / "ab_a8k4.py")
    assert {k: jax.config.values[k] for k in _CACHE_KEYS} == before
    assert not str(before["jax_compilation_cache_dir"]).endswith(".jax_cache_tpu")


def _q4k(n, k, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32)
    return np.frombuffer(quantize_q4_k(w), np.uint8)


def _x(b, k, seed):
    return np.random.default_rng(seed + 1000).standard_normal((b, k)).astype(np.float32)


def _close(out, ref):
    ref = np.asarray(ref, np.float32)
    err = np.abs(np.asarray(out, np.float32) - ref).max()
    assert err <= TOL * np.abs(ref).max(), (err, np.abs(ref).max())


# K, N, B, kb: every K, N, B and kb of the matrix, each K at more than one kb
Q_CASES = [(256, 256, 1, 1), (256, 512, 16, 4), (512, 256, 3, 2), (512, 512, 8, 1),
           (512, 256, 1, 4), (2048, 256, 8, 4), (2048, 512, 16, 2), (2048, 256, 3, 1),
           (2048, 512, 1, 4), (256, 512, 8, 2), (512, 512, 16, 4), (2048, 256, 16, 1)]


@pytest.mark.parametrize("K,N,B,kb", Q_CASES)
def test_kernel_q_plain_matches_w4a8_swar_matmul(K, N, B, kb):
    data, x = _q4k(N, K, K + N), _x(B, K, B)
    with jax.disable_jit():
        ref = np.asarray(jqm.w4a8_swar_matmul(jnp.asarray(x), jqm.repack_q4k_a8s(data, N, K),
                                              2048, kb))[:, :N]
        jxq, jxs, jxsum = jqm._quant_acts(jnp.asarray(x))
    w = qm.repack_q4k_a8s(data, N, K, "cpu")
    xt = torch.from_numpy(x)
    xq, xs, sxm = qm.quant_acts(xt)
    assert np.array_equal(xq.numpy(), np.asarray(jxq))
    assert np.array_equal(xs.numpy(), np.asarray(jxs).T)
    assert np.array_equal(sxm.numpy(), np.asarray(jxs * jxsum).T)
    _close(qm.w4a8_swar_matmul(xt, w, 16, kb).numpy(), ref)


@pytest.mark.parametrize("K,N,B,kb", [(2048, 512, 8, 4), (512, 256, 3, 1), (256, 512, 16, 2)])
def test_kernel_q_plain_ignores_block_n_and_matches_kernel_a(K, N, B, kb):
    """block_n moves no bit of the plain version; Q is kernel A's function in
    another grouping."""
    w = qm.repack_q4k_a8s(_q4k(N, K, 7), N, K, "cpu")
    x = torch.from_numpy(_x(B, K, 7))
    out = qm.w4a8_swar_matmul(x, w, 16, kb)
    for bn in (1, 8, 128, 2048):
        assert torch.equal(qm.w4a8_swar_matmul(x, w, bn, kb), out), bn
    _close(out.numpy(), qm.w4a8_matmul_plain(x, w).numpy())


def test_kernel_q_clamps_its_tiles_as_the_reference():
    """_a8s_pos's clamping: bn halves until it divides N, kb until its slab
    divides K."""
    assert qm.a8s_clamp(4096, 14336, 2048, 4) == (2048, 4)
    assert qm.a8s_clamp(768, 300, 2048, 4) == (300, 1)
    assert qm.a8s_clamp(768, 300, 128, 4) == (4, 1)
    assert qm.a8s_clamp(4352, 72, 16, 8) == (8, 1)
    assert qm.a8s_clamp(3072, 1000, 16, 3) == (8, 3)
    with pytest.raises(ValueError):
        qm.a8s_clamp(300, 256, 16, 4)


# K, N, B, kb: kb clamped to the superblock count (256, 768: the whole K as
# one slab), a multiple of 8 (2048, 4096), and 16 (two slabs of 8 at 4096)
T_CASES = [(256, 256, 1, 8), (768, 256, 3, 8), (2048, 512, 8, 8), (4096, 256, 16, 8),
           (4096, 512, 2, 16), (512, 256, 5, 8), (2048, 256, 1, 4)]


@pytest.mark.parametrize("K,N,B,kb", T_CASES)
def test_kernel_t_plain_matches_x2_matmul(ref_tools, K, N, B, kb):
    """T's plain version against the reference's X2 kernel, weights built by
    both packages' repack_q4k_a8k4 from the same Q4_K bytes; and within
    tolerance of kernel I's plain version."""
    data, x = _q4k(N, K, K + N + 1), _x(B, K, B + 1)
    jw = jqm.repack_q4k_a8k4(data, N, K)
    with jax.disable_jit():
        ref = np.asarray(ref_tools["ab_a8k4"].x2_matmul(jnp.asarray(x), jw.codes, jw.ddm,
                                                         jw.scmn, 2048, kb))[:, :N]
    w = qm.repack_q4k_a8k4(data, N, K, "cpu")
    xt = torch.from_numpy(x)
    out = qm.x2_matmul(xt, w, 16, kb)
    _close(out.numpy(), ref)
    _close(out.numpy(), qm.a8k4_matmul_plain(xt, w).numpy())
    assert torch.equal(qm.x2_matmul(xt, w, 2048, kb), out)


def test_kernel_t_clamps_kb_as_x2_matmul():
    assert qm.x2_clamp(4096, 14336, 2048, 8)[1] == 8
    assert qm.x2_clamp(768, 256, 16, 8)[1] == 3        # min(8, 3) = the whole K
    assert qm.x2_clamp(4352, 256, 16, 8)[1] == 17      # halves to 1, then the whole K
    assert qm.x2_clamp(3072, 256, 16, 8)[1] == 12
    assert qm.x2_clamp(4096, 256, 16, 16)[1] == 16


@pytest.mark.parametrize("bk,bn", [(16, 128), (4, 64), (32, 256), (64, 128), (5, 48)])
def test_kernel_r_plain_matches_stream(ref_tools, bk, bn):
    """Exact against probe_bw.stream in interpret mode (64 x 256 uint8)."""
    codes = np.random.default_rng(bk).integers(0, 256, (64, 256), dtype=np.uint8)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(ref_tools["probe_bw"].stream(jnp.asarray(codes), bk, bn))
    out = probes.stream(torch.from_numpy(codes), bk, bn).numpy()
    nn = 256 // bn * bn       # past the grid the TPU kernel leaves the output unwritten
    assert np.array_equal(out[:, :nn], ref[:, :nn]) and not out[:, nn:].any()


@pytest.mark.parametrize("shape", [(8, 128), (2, 4)])
def test_kernel_s_plain_matches_the_tiny_kernel(ref_tools, shape):
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    ref = pl.pallas_call(ref_tools["probe_overhead"]._tiny_kernel,
                         out_shape=jax.ShapeDtypeStruct(shape, jnp.float32),
                         interpret=True)(jnp.asarray(x))
    assert np.array_equal(probes.add_one(torch.from_numpy(x)).numpy(), np.asarray(ref))


# -- each tool's main on the CPU, at tiny sizes (plain versions) ---------------

TOOL_RUNS = {
    "probe_bw": (["--layers", "2", "--rows", "256", "--cols", "1024", "--reps", "1",
                  "--blocks", "card"], ["block (", "torch.sum(dtype=int32)"]),
    "probe_overhead": (["--r", "2", "--n-lo", "1", "--n-hi", "3", "--reps", "1"],
                       ["elementwise rsqrt", "kernel S (x+1, one CTA)"]),
    "probe_ceiling": (["--gb", "0.002", "--mm-layers", "2", "--q-layers", "2",
                       "--shape-layers", "2", "--reps", "1", "--width", "512", "--ffn", "1024",
                       "--vocab", "1024", "--ctx", "64"],
                      ["dispatch:", "read uint8", "matmul bf16", "kernel Q (512x1024) x2",
                       "kernel Q head", "kernel C S=64 int8"]),
    "autotune_a8s": (["--scale", "0.25", "--shapes", "wo", "--block-n", "16,2048", "--kb", "4",
                      "--r-lo", "1", "--r-hi", "2", "--reps", "1"],
                     ["== wo K=1024 N=1024", "Q bn=16 kb=4", "A (min term folded)", "BEST wo"]),
    "ab_a8k4": (["512", "256", "2", "--layers", "2", "--reps", "1"],
                ["correctness x2 vs a8k4", "a8s", "a8k4", "x2"]),
    "bench_serving": (["tiny", "q4k_a8"], ['"metric": "serving_tokens_per_sec_tiny_q4k_a8"']),
    "profile_load": (["tiny"], ["parse", "page-in", "upload", "repack", "commit", "Model()"]),
    "trace_step": (["tiny", "2", "--ctx", "64", "--top", "5"],
                   ["# traced 2 decode steps", "host (cpu) op total"]),
}


@pytest.mark.parametrize("tool", list(TOOL_RUNS))
def test_tool_main_runs_on_the_cpu(tool, capsys, monkeypatch):
    args, lines = TOOL_RUNS[tool]
    for k, v in dict(BLAMA_SERVE_STREAMS="3", BLAMA_SERVE_TOKENS="3", BLAMA_SERVE_PROMPT="5",
                     BLAMA_SERVE_BATCH="2", BLAMA_SERVE_CTX="64").items():
        monkeypatch.setenv(k, v)
    mod = importlib.import_module(f"blama_tpu_torch.tools.{tool}")
    res = mod.main(["--device", "cpu", *args])
    out = capsys.readouterr().out
    assert out.startswith("# device: cpu (host clock: no device metric)"), out
    for line in lines:
        assert line in out, (line, out)
    assert res["card"].startswith("cpu")


def test_ab_a8k4_correctness_line_is_small(capsys):
    from blama_tpu_torch.tools import ab_a8k4

    res = ab_a8k4.main(["--device", "cpu", "1024", "256", "3", "--layers", "1", "--reps", "1"])
    assert res["x2_vs_a8k4"] <= TOL
