"""The CUDA kernels against their plain versions, on the card.

These need an NVIDIA card with nvcc (the kernels build at first use); on a
machine without one every test skips. On the card:

    python -m pytest tests/test_torch_cuda_kernels.py -p no:randomly

Small, ragged shapes on purpose: the 8B shapes run in chip_smoke.py; here
the edges — row counts that are not powers of two, widths that do not fill
a block, a K that ends inside a staging chunk, batch > 1, a head dim of 64 —
and replay determinism (two launches give the same bits).
"""

import numpy as np
import pytest
import torch

from blama_tpu_torch.ops import decode_attention as da
from blama_tpu_torch.ops import quant_matmul as qm

# tolerances as in chip_smoke.py: f32 sums in another order (matmuls);
# one bf16 rounding flip of the largest output (attention)
MATMUL_TOL = 1e-4
ATTN_TOL = 2.0 ** -7


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels build and run only there)")
    return torch.device("cuda")


def _weights(n, k, seed, device):
    from blama_tpu_torch.gguf import GGMLType, quants

    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32)
    return qm.repack_q4k_a8s(quants.quantize(w, GGMLType.Q4_K), n, k, device)


def _close(out, ref, tol):
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item(), err


@pytest.mark.parametrize("m,n,k,dtype", [
    (1, 320, 512, torch.bfloat16), (3, 320, 2560, torch.bfloat16),
    (16, 72, 256, torch.bfloat16), (1, 300, 768, torch.float32)])
def test_kernel_a(cuda, m, n, k, dtype):
    w = _weights(n, k, seed=m, device=cuda)
    x = torch.randn((m, k), generator=torch.Generator().manual_seed(m)).to(dtype).to(cuda)
    out, xq, xs, sxm = qm.w4a8_launch(x, w)
    pxq, pxs, psxm = qm.quant_acts(x)
    assert torch.equal(xq, pxq) and torch.equal(xs, pxs) and torch.equal(sxm, psxm)
    _close(out, qm.w4a8_matmul_plain(x, w), MATMUL_TOL)
    assert torch.equal(out, qm.w4a8_launch(x, w)[0])


@pytest.mark.parametrize("m,n,k", [(17, 320, 512), (40, 72, 768), (130, 1000, 256)])
def test_kernel_b(cuda, m, n, k):
    w = _weights(n, k, seed=m, device=cuda)
    x = torch.randn((m, k), generator=torch.Generator().manual_seed(m)) \
        .to(torch.bfloat16).to(cuda)
    out = qm.q4k_pos(x, w)
    _close(out, qm.q4k_pos_plain(x, w), MATMUL_TOL)
    assert torch.equal(out, qm.q4k_pos(x, w))


def _cache(b, s, hkv, d, seed, device):
    g = torch.Generator().manual_seed(seed)
    k = torch.randint(-127, 128, (b, s, hkv, d), generator=g, dtype=torch.int8)
    v = torch.randint(-127, 128, (b, s, hkv, d), generator=g, dtype=torch.int8)
    ks = torch.rand((b, s, hkv), generator=g) * 0.02 + 1e-3
    vs = torch.rand((b, s, hkv), generator=g) * 0.02 + 1e-3
    pos = torch.arange(s, dtype=torch.int32).repeat(b, 1)
    pos[:, 3::7] = -1
    pos[0, s // 2:] = -1                   # row 0 half empty
    pos[-1, 5] = 10 * s                    # a slot ahead of every query
    return [t.to(device) for t in (k, v, ks, vs, pos)]


@pytest.mark.parametrize("b,h,hkv,d,s", [(1, 4, 2, 64, 64), (2, 8, 2, 128, 96),
                                         (1, 32, 8, 128, 2048)])
def test_kernel_c(cuda, b, h, hkv, d, s):
    k, v, ks, vs, pos = _cache(b, s, hkv, d, seed=s, device=cuda)
    inv, _ = da.effective_inv_freq(d, d, 10000.0)
    inv = inv.to(cuda)
    q = torch.randn((b, 1, h, d), generator=torch.Generator().manual_seed(1)) \
        .to(torch.bfloat16).to(cuda)
    q_pos = torch.full((b,), s - 9, dtype=torch.int32, device=cuda)
    out = da.decode_attention(q, k, v, q_pos, pos, inv, ks, vs)
    ref = da.flash_attention_plain(q, k, v, q_pos[:, None], pos, inv, ks, vs, d ** -0.5)
    _close(out, ref, ATTN_TOL)
    assert torch.equal(out, da.decode_attention(q, k, v, q_pos, pos, inv, ks, vs))


@pytest.mark.parametrize("b,t,h,hkv,d,s", [(1, 8, 4, 2, 64, 64), (2, 16, 8, 2, 128, 96),
                                           (1, 24, 32, 8, 128, 256)])
def test_kernel_d(cuda, b, t, h, hkv, d, s):
    k, v, ks, vs, pos = _cache(b, s, hkv, d, seed=t, device=cuda)
    inv, _ = da.effective_inv_freq(d, d, 10000.0)
    inv = inv.to(cuda)
    q = torch.randn((b, t, h, d), generator=torch.Generator().manual_seed(2)) \
        .to(torch.bfloat16).to(cuda)
    qp = (torch.arange(t, dtype=torch.int32) + s // 3).repeat(b, 1).to(cuda)
    out = da.prefill_attention(q, k, v, qp, pos, inv, ks, vs)
    ref = da.flash_attention_plain(q, k, v, qp, pos, inv, ks, vs, d ** -0.5)
    _close(out, ref, ATTN_TOL)
    assert torch.equal(out, da.prefill_attention(q, k, v, qp, pos, inv, ks, vs))
