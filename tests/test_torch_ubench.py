"""ubench_q4k's kernels (U, V, and Q as v6) and the SWAR, Mosaic and cast
probes (W, X, Y) against the JAX package's, and the six tools' mains on the
CPU.

Same numpy-seeded inputs through both. The reference kernels run in
interpret mode: ubench_q4k's v1 jitted (f32 only), v2, v3 and v6 un-jitted
(XLA's CPU backend divides amax / 127 through a reciprocal under jit,
ROADMAP.md §3), probe_swar's and probe_mosaic's kernels through
pl.pallas_call(interpret=True), and tools/probe_casts.py, a module-level
script, through runpy with pallas_call wrapped to interpret and to record
each probe's output in order. The port's wrappers run their plain PyTorch
versions (a CPU tensor never reaches a CUDA kernel). Tolerances: U, V and v6
1e-4 x max|ref| (f32 sums of the same terms in another order); activation
codes, V's int32 group dots, and W, X, Y exact (integers, copies, one rint,
a 0/1-matrix dot).

Importing a reference tool points jax's persistent compilation cache at its
own directory; the config is put back right after, so no other test on the
same worker sees it.
"""

import importlib
import pathlib
import runpy

import jax
import jax.experimental.pallas as jpl
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from blama_tpu.ops.pallas import quant_matmul as jqm
from blama_tpu_torch.ops import probes
from blama_tpu_torch.ops import quant_matmul as qm
from blama_tpu_torch.tools import probe_casts, ubench_q4k

torch.set_num_threads(1)   # tiny shapes: threads only contend with the other test workers

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = 1e-4
_CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_entry_size_bytes",
               "jax_persistent_cache_min_compile_time_secs")


def _with_cache_config_restored(fn):
    before = {k: jax.config.values[k] for k in _CACHE_KEYS}
    try:
        return fn()
    finally:
        for k, v in before.items():
            jax.config.update(k, v)


@pytest.fixture(scope="module")
def ref():
    return {n: _with_cache_config_restored(
        lambda n=n: importlib.import_module(f"blama_tpu.tools.{n}"))
        for n in ("ubench_q4k", "probe_swar", "probe_mosaic")}


def test_reference_import_leaves_the_cache_config_as_it_was(ref):
    assert not str(jax.config.values["jax_compilation_cache_dir"]).endswith(".jax_cache_tpu")


def _weights(K, N, seed):
    """make_weights' draws for one layer: the reference's [K, N] arrays and
    the port's [N, ...] tensors."""
    codes, scales, mins = ubench_q4k.make_weights(K, N, 1, np.random.default_rng(seed))
    ce = torch.from_numpy(codes[0]).t().contiguous()
    return (codes, scales, mins), (ce, torch.from_numpy(scales[0]).t().contiguous(),
                                   torch.from_numpy(mins[0]).t().contiguous())


def _x(B, K, seed):
    return np.random.default_rng(seed + 1000).standard_normal((B, K)).astype(np.float32)


def _close(out, ref_out):
    ref_out = np.asarray(ref_out, np.float32)
    err = np.abs(np.asarray(out, np.float32) - ref_out).max()
    assert err <= TOL * np.abs(ref_out).max(), (err, np.abs(ref_out).max())


def test_pack_pairs_matches_the_reference(ref):
    (codes, _, _), (ce, _, _) = _weights(512, 64, 3)
    want = ref["ubench_q4k"].pack_pairs(codes)[0]
    assert np.array_equal(ubench_q4k.pack_pairs(ce).numpy(), want.T)
    assert torch.equal(qm.unpair_tiles(ubench_q4k.pack_pairs(ce)), ce)


# -- kernel U: v1's f32 two-dot --------------------------------------------------

# K, N, B, kb: one K-block, an odd number of blocks (768 / 256 = 3, 1536 /
# 512 = 3), several, and kb up to 8
U_CASES = [(1024, 512, 1, 4), (768, 256, 3, 1), (1536, 256, 8, 2), (2048, 512, 3, 8)]


@pytest.mark.parametrize("K,N,B,kb", U_CASES)
def test_kernel_u_plain_matches_q4k_matmul_v1(ref, K, N, B, kb):
    (codes, scales, mins), (ce, sc, mn) = _weights(K, N, K + B)
    x = _x(B, K, kb)
    u = ref["ubench_q4k"]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(u.q4k_matmul_v1(jnp.asarray(x), jnp.asarray(u.pack_pairs(codes)[0]),
                                          jnp.asarray(scales[0]), jnp.asarray(mins[0]),
                                          4096, kb))
    out = qm.q4k_matmul_v1(torch.from_numpy(x), ubench_q4k.pack_pairs(ce), sc, mn, 16, kb)
    _close(out.numpy(), want)


# -- kernel V: v2 (int8 codes) and v3 (tile-paired codes) --------------------------

V_CASES = [("v2", 1024, 512, 1, 4), ("v2", 768, 256, 3, 1),
           ("v3", 2048, 256, 8, 8), ("v3", 1536, 256, 3, 2)]


@pytest.mark.parametrize("variant,K,N,B,kb", V_CASES)
def test_kernel_v_plain_matches_the_plane_matmuls(ref, variant, K, N, B, kb):
    """The port's activation codes, scales and sums equal the reference's
    quantize_activations (eager) exactly; its int32 group dots equal the
    reference's masked planes dotted with the codes tile by tile exactly;
    the product is within tolerance of w4a8_plane_matmul /
    w4a8_packed_matmul run un-jitted in interpret mode."""
    (codes, scales, mins), (ce, sc, mn) = _weights(K, N, K + B + 1)
    x = _x(B, K, kb + 1)
    u = ref["ubench_q4k"]
    sb, mb = jnp.asarray(scales[0]).astype(jnp.bfloat16), jnp.asarray(mins[0]).astype(jnp.bfloat16)
    with jax.disable_jit(), pltpu.force_tpu_interpret_mode():
        planes, xsT, xsumT = (np.asarray(a) for a in jqm.quantize_activations(jnp.asarray(x)))
        if variant == "v2":
            want = u.w4a8_plane_matmul(jnp.asarray(x), jnp.asarray(codes[0].astype(np.int8)),
                                       sb, mb, 2048, kb)
        else:
            want = u.w4a8_packed_matmul(jnp.asarray(x), jnp.asarray(u.pack_pairs(codes)[0]),
                                        sb, mb, 4096, kb)
        want = np.asarray(want)
    xt = torch.from_numpy(x)
    xq, xs, sxm = qm.quant_acts(xt)
    G = 8
    assert np.array_equal(xq.numpy(), planes.reshape(G, B, K).sum(0))
    assert np.array_equal(xs.numpy(), xsT.T)
    assert np.array_equal(sxm.numpy(), (xsT * xsumT).T)
    T = K // 256
    ip = np.einsum("gbtk,tkn->bntg", planes.reshape(G, B, T, 256).astype(np.int64),
                   codes[0].reshape(T, 256, N).astype(np.int64)).reshape(B, N, T * G)
    assert np.array_equal(qm._group_dots(xq, ce).numpy(), ip)
    sbt, mbt = sc.to(torch.bfloat16), mn.to(torch.bfloat16)
    if variant == "v2":
        out = qm.w4a8_plane_matmul(xt, ce.to(torch.int8), sbt, mbt, 16, kb)
    else:
        out = qm.w4a8_packed_matmul(xt, ubench_q4k.pack_pairs(ce), sbt, mbt, 16, kb)
    _close(out.numpy(), want)


def test_kernel_v_loaders_and_block_n_move_no_bit():
    """Both layouts of the same codes give the same bits; block_n does not
    enter the plain version; kb groups the sum (within tolerance)."""
    _, (ce, sc, mn) = _weights(2048, 256, 5)
    x = torch.from_numpy(_x(3, 2048, 5))
    sbt, mbt = sc.to(torch.bfloat16), mn.to(torch.bfloat16)
    out = qm.w4a8_plane_matmul(x, ce.to(torch.int8), sbt, mbt, 8, 4)
    for bn in (1, 16, 2048):
        assert torch.equal(qm.w4a8_packed_matmul(x, ubench_q4k.pack_pairs(ce), sbt, mbt, bn, 4),
                           out), bn
    _close(qm.w4a8_plane_matmul(x, ce.to(torch.int8), sbt, mbt, 8, 8).numpy(), out.numpy())
    _close(out.numpy(), qm.w4a8_matmul_plain(x, qm.pack_a8s(ce, sc, mn)).numpy())


def test_kernels_u_v_clamp_block_n_and_refuse_partial_blocks():
    """The references' column tile: block_n halves until it divides N; kb is
    not clamped there (a K that is not whole blocks drops the tail), so the
    port refuses it."""
    assert qm._tile_clamp("U", 4096, 14336, 4096, 8) == 2048
    assert qm._tile_clamp("V", 4096, 14336, 2048, 4) == 2048
    assert qm._tile_clamp("V", 768, 300, 16, 1) == 4
    _, (ce, sc, mn) = _weights(1024, 64, 1)
    x = torch.from_numpy(_x(1, 1024, 1))
    with pytest.raises(ValueError):
        qm.q4k_matmul_v1(x, ubench_q4k.pack_pairs(ce), sc, mn, 16, 8)
    with pytest.raises(ValueError):
        qm.w4a8_plane_matmul(x, ce.to(torch.int8), sc.bfloat16(), mn.bfloat16(), 16, 3)
    assert ubench_q4k.kb_for(1024, 8) == 4 and ubench_q4k.kb_for(4096, 8) == 8


# -- v6 is kernel Q's body -------------------------------------------------------

@pytest.mark.parametrize("K,N,B", [(2048, 256, 3), (1024, 512, 1)])
def test_kernel_q_plain_matches_ubench_v6(ref, K, N, B):
    """ubench_q4k.w4a8_swar_matmul (its own _quant_acts and _v6_planes) at
    its default kb 8 (halved to 4 at K 1024, as Q's clamp does) against the
    port's kernel Q."""
    (codes, scales, mins), (ce, sc, mn) = _weights(K, N, K + 7)
    x = _x(B, K, 7)
    u = ref["ubench_q4k"]
    with jax.disable_jit(), pltpu.force_tpu_interpret_mode():
        want = np.asarray(u.w4a8_swar_matmul(
            jnp.asarray(x), jnp.asarray(u.pack_pairs(codes)[0]),
            jnp.asarray(scales[0]).astype(jnp.bfloat16),
            jnp.asarray(mins[0]).astype(jnp.bfloat16), 2048, 8))
    out = qm.w4a8_swar_matmul(torch.from_numpy(x), qm.pack_a8s(ce, sc, mn), 16, 8)
    _close(out.numpy(), want)


# -- kernels W and X: probe_swar's and probe_mosaic's kernels --------------------

def _call(kernel, out_shape, *args):
    return jpl.pallas_call(kernel, out_shape=out_shape, interpret=True)(
        *(jnp.asarray(a) for a in args))


@pytest.mark.parametrize("R,N", [(256, 512), (64, 128)])
def test_kernel_w_plain_matches_probe_swar(ref, R, N):
    rng = np.random.default_rng(R)
    x = rng.integers(0, 255, (R, N), dtype=np.uint8)
    a = rng.integers(-127, 127, (32, R), dtype=np.int8)
    ps, xt = ref["probe_swar"], torch.from_numpy(x)
    rt = _call(ps.k_roundtrip, jax.ShapeDtypeStruct((R, N), jnp.uint8), x)
    assert np.array_equal(probes.swar_roundtrip(xt).numpy(), np.asarray(rt))
    lo, hi = _call(ps.k_swar_lo_hi, (jax.ShapeDtypeStruct((R, N), jnp.int8),) * 2, x)
    plo, phi = probes.swar_lo_hi(xt)
    assert np.array_equal(plo.numpy(), np.asarray(lo))
    assert np.array_equal(phi.numpy(), np.asarray(hi))
    dot = _call(ps.k_swar_dot, jax.ShapeDtypeStruct((32, N), jnp.int32), a, x)
    assert np.array_equal(probes.swar_dot(torch.from_numpy(a), xt).numpy(), np.asarray(dot))


def test_swar_masks_on_words_are_the_per_byte_nibbles():
    """The kernel's 32-bit word masks (unsigned shift) give each byte's
    nibbles whatever the grouping of four bytes."""
    x = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (16, 64), dtype=np.uint8))
    w = x.view(torch.int32)
    lo = (w & 0x0F0F0F0F).view(torch.int8)
    hi = ((w >> 4) & 0x0F0F0F0F).view(torch.int8)   # arithmetic shift: the mask hides it
    assert torch.equal(lo, probes.swar_lo_hi_plain(x)[0])
    assert torch.equal(hi, probes.swar_lo_hi_plain(x)[1])


@pytest.mark.parametrize("R,N", [(256, 512), (64, 128)])
def test_kernel_x_plain_matches_probe_mosaic(ref, R, N):
    rng = np.random.default_rng(R + 1)
    xu8 = rng.integers(0, 255, (R, N), dtype=np.uint8)
    a8 = rng.integers(-127, 127, (32, R), dtype=np.int8)
    b8 = rng.integers(-8, 8, (R, N), dtype=np.int8)
    c8 = rng.integers(0, 255, (R // 2, N), dtype=np.uint8)
    pm = ref["probe_mosaic"]
    for kernel, port, args, out in (
            (pm.k_u8_bitops, probes.u8_bitops, (xu8,), ((R, N), jnp.uint8)),
            (pm.k_u8_upcast_i16, probes.i16_bitops, (xu8,), ((R, N), jnp.uint8)),
            (pm.k_i8_dot, probes.i8_dot, (a8, b8), ((32, N), jnp.int32)),
            (pm.k_i8_from_unpack_dot, probes.unpack_dot, (a8, c8), ((32, N), jnp.int32))):
        want = np.asarray(_call(kernel, jax.ShapeDtypeStruct(*out), *args))
        got = port(*(torch.from_numpy(a) for a in args)).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), kernel.__name__


def test_word_kernels_refuse_what_they_cannot_read():
    ok = torch.zeros((4, 8), dtype=torch.uint8)
    probes._check_words(ok, torch.uint8, "t")
    for bad in (torch.zeros((4, 6), dtype=torch.uint8), torch.zeros((4, 8), dtype=torch.int8),
                torch.zeros((8, 4), dtype=torch.uint8).t(), torch.zeros(33, dtype=torch.uint8)[1:]
                .reshape(4, 8)):
        with pytest.raises(ValueError):
            probes._check_words(bad, torch.uint8, "t")


# -- kernel Y: tools/probe_casts.py's twelve probes ---------------------------------

@pytest.fixture(scope="module")
def casts_outputs():
    """Run tools/probe_casts.py (a module-level script) with pallas_call
    forced to interpret and recording every output in call order."""
    orig, outs = jpl.pallas_call, []

    def recording(kernel, *a, **kw):
        kw["interpret"] = True
        f = orig(kernel, *a, **kw)

        def call(*args):
            y = f(*args)
            outs.append(np.asarray(y))
            return y
        return call

    jpl.pallas_call = recording
    try:
        _with_cache_config_restored(
            lambda: runpy.run_path(str(ROOT / "tools" / "probe_casts.py"), run_name="__main__"))
    finally:
        jpl.pallas_call = orig
    return outs


def test_probe_casts_ran_all_twelve(casts_outputs):
    assert [o.shape for o in casts_outputs] == [tuple(s) for _, _, s, _ in probes.CASTS]


@pytest.mark.parametrize("i", range(12), ids=[c[0] for c in probes.CASTS])
def test_kernel_y_plain_matches_probe_casts(casts_outputs, i):
    name, shape_in, shape_out, _ = probes.CASTS[i]
    x = torch.from_numpy(probe_casts.probe_input(name, shape_in))
    out = probes.cast(name, x)
    assert tuple(out.shape) == shape_out and out.is_contiguous()
    assert np.array_equal(out.numpy(), casts_outputs[i]), name


def test_casts_names_match_the_launch_counters():
    from blama_tpu_torch.ops import kernels

    assert all(f"casts_{name}" in kernels.LAUNCHES for name, *_ in probes.CASTS)
    assert set(probe_casts.LABELS) == {name for name, *_ in probes.CASTS}


# -- each tool's main on the CPU, at tiny sizes (plain versions) ---------------------

TOOL_RUNS = {
    "ubench_q4k": (["1024", "512", "3", "--layers", "2", "--reps", "1"],
                   ["v0 kernel B", "v1 kernel U", "v2 kernel V", "v3 kernel V", "v6 kernel Q",
                    "v4 plain W4A8", "v5 bf16 dense", "correctness v3: max rel err vs v0"]),
    "probe_swar": (["--rows", "64", "--cols", "128"],
                   ["roundtrip identity: True", "lo matches x&0xF: True",
                    "hi matches x>>4: True", "swar dot correct: True"]),
    "probe_mosaic": (["--rows", "64", "--cols", "128"],
                     ["OK   u8 bitops native", "OK   i16 bitops", "OK   i8xi8->i32 dot",
                      "OK   unpack->i8 dot"]),
    "probe_casts": ([], [f"OK   {label}" for label in probe_casts.LABELS.values()]),
    "ubench_attn": (["64", "2", "--r-lo", "2", "--r-hi", "4", "--reps", "1"],
                    ["cap=", "S=64:", "us/call"]),
    "ubench_paged": (["2", "64", "32", "--r-lo", "1", "--r-hi", "2", "--reps", "1"],
                     ["B=2 S=64 page=32", "dense fused (kernel C)", "paged (kernel E)",
                      "ratio paged/dense"]),
}


@pytest.mark.parametrize("tool", list(TOOL_RUNS))
def test_tool_main_runs_on_the_cpu(tool, capsys):
    args, lines = TOOL_RUNS[tool]
    mod = importlib.import_module(f"blama_tpu_torch.tools.{tool}")
    res = mod.main(["--device", "cpu", *args])
    out = capsys.readouterr().out
    assert out.startswith("# device: cpu (host clock: no device metric)"), out
    for line in lines:
        assert line in out, (line, out)
    assert "FAIL" not in out
    assert res["card"].startswith("cpu")


def test_ubench_q4k_variants_agree_with_v0():
    res = ubench_q4k.main(["--device", "cpu", "1024", "256", "2", "--layers", "1",
                           "--reps", "1"])
    assert res["rel_err"]["v1"] <= TOL              # the exact engine's function in f32
    assert max(res["rel_err"].values()) < 2e-2      # W4A8 and bf16 rounding


def test_probe_tool_exits_non_zero_on_a_fail(monkeypatch, capsys):
    """A probe that does not match is a FAIL line and a non-zero exit, not a
    line and exit 0."""
    from blama_tpu_torch.tools import probe_mosaic

    monkeypatch.setattr(probes, "i16_bitops", lambda x: probes.u8_bitops(x) + 1)
    with pytest.raises(SystemExit) as e:
        probe_mosaic.main(["--device", "cpu", "--rows", "8", "--cols", "16"])
    assert e.value.code and "i16 bitops" in str(e.value.code)
    out = capsys.readouterr().out
    assert "FAIL i16 bitops: differs from the plain version" in out
    assert "OK   u8 bitops native" in out
