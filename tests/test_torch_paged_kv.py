"""The port's paged KV pool against the JAX package: the page allocator, the
logical view and the row-masked position edits (exact, integers), and the
plain version of the paged attention kernels against the JAX package's Pallas
kernels (run in interpret mode, as its own tests do on the CPU), bf16 and
INT8, under scrambled physical placement and an edited position map."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blama_tpu.ops import kv_cache as jkvc
from blama_tpu.ops import paged_kv as jpkv
from blama_tpu.ops.pallas import decode_attention as jda
from blama_tpu.ops.pallas import paged_attention as jpa
from blama_tpu_torch.models.llama import _to_torch, paged_cache_from_jax
from blama_tpu_torch.ops import decode_attention as da
from blama_tpu_torch.ops import paged_attention as pa
from blama_tpu_torch.ops import paged_kv as pkv

# bf16 outputs: one rounding flip is 2^-8 of an element
ATTN_TOL = 2.0 ** -7

B, H, HKV, D, G, MP, P = 2, 8, 2, 64, 128, 3, 16   # S = 384
LENS = [300, 160]


def _tables():
    tables = np.full((B, MP), -1, np.int32)
    tables[0, :3] = [7, 3, 11]
    tables[1, :2] = [2, 9]
    return tables


def _pool(seed, int8, edit=False):
    """A scrambled pool as numpy arrays: bf16-valued (or INT8) K/V with
    garbage on unowned pages, positions, and the page table."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((P, G, HKV, D)).astype(np.float32)
    v = rng.standard_normal((P, G, HKV, D)).astype(np.float32)
    tables = _tables()
    pool_pos = rng.integers(0, 300, (P, G)).astype(np.int32)   # stale positions
    for b in range(B):
        for lp in range(MP):
            if tables[b, lp] >= 0:
                s = np.arange(lp * G, (lp + 1) * G)
                pool_pos[tables[b, lp]] = np.where(s < LENS[b], s, -1)
    if edit:   # seq_rm(5, 20) + seq_add(20, ∞, -15) on row 0
        for page in tables[0][tables[0] >= 0]:
            p = pool_pos[page]
            pool_pos[page] = np.where((p >= 5) & (p < 20), -1, np.where(p >= 20, p - 15, p))
    if int8:
        kc, ks = jkvc.quantize_kv(jnp.asarray(k).reshape(1, P * G, HKV, D))
        vc, vs = jkvc.quantize_kv(jnp.asarray(v).reshape(1, P * G, HKV, D))
        return (np.asarray(kc).reshape(P, G, HKV, D), np.asarray(vc).reshape(P, G, HKV, D),
                np.asarray(ks).reshape(P, G, HKV), np.asarray(vs).reshape(P, G, HKV),
                pool_pos, tables)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))  # noqa: E731
    return bf(k), bf(v), None, None, pool_pos, tables


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else _to_torch(a, "cpu")


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("edit", [False, True], ids=["plain_map", "edited_map"])
@pytest.mark.parametrize("T", [1, 16])
def test_paged_attention_plain_matches_jax(int8, edit, T):
    k, v, ks, vs, pool_pos, tables = _pool(T + 2 * int8 + 4 * edit, int8, edit)
    rng = np.random.default_rng(99)
    q = np.asarray(jnp.asarray(rng.standard_normal((B, T, H, D)), jnp.bfloat16))
    shift = 15 if edit else 0
    qpos = np.stack([np.arange(LENS[b] - T, LENS[b]) - (shift if b == 0 else 0)
                     for b in range(B)]).astype(np.int32)
    invf, ms = jda.effective_inv_freq(D, D, 10000.0)
    pinv, pms = da.effective_inv_freq(D, D, 10000.0)
    np.testing.assert_array_equal(pinv.numpy(), np.asarray(invf))
    if T == 1:
        ref = jpa.paged_decode_attention(
            _j(q), _j(k), _j(v), _j(pool_pos), _j(tables), _j(qpos[:, 0]), invf,
            k_scale=_j(ks), v_scale=_j(vs), mscale=ms)
        out = pa.paged_decode_attention(
            _t(q), _t(k), _t(v), _t(pool_pos), _t(tables), _t(qpos[:, 0]), pinv,
            k_scale=_t(ks), v_scale=_t(vs), mscale=pms)
    else:
        ref = jpa.paged_prefill_attention(
            _j(q), _j(k), _j(v), _j(pool_pos), _j(tables), _j(qpos), invf,
            k_scale=_j(ks), v_scale=_j(vs), mscale=ms)
        out = pa.paged_prefill_attention(
            _t(q), _t(k), _t(v), _t(pool_pos), _t(tables), _t(qpos), pinv,
            k_scale=_t(ks), v_scale=_t(vs), mscale=pms)
    ref = np.asarray(ref.astype(jnp.float32))
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == ref.shape
    err = np.abs(out.float().numpy() - ref).max()
    assert err <= ATTN_TOL * np.abs(ref).max(), err

    # and EXACTLY the port's dense plain version over the gathered rows
    tt = _t(tables)
    slot_map = pkv.view_slot_map(tt, G)
    mapped = torch.repeat_interleave(tt >= 0, G, dim=1)
    pos_v = torch.where(mapped, _t(pool_pos).reshape(-1)[slot_map], -1).to(torch.int32)
    gather = lambda a, *tail: None if a is None else \
        _t(a).reshape(-1, *tail)[slot_map]   # noqa: E731
    dense = da.flash_attention_plain(
        _t(q), gather(k, HKV, D), gather(v, HKV, D), _t(qpos), pos_v, pinv,
        gather(ks, HKV), gather(vs, HKV), (D ** -0.5) * pms)
    assert torch.equal(out, dense)


def _both_caches(int8):
    """The same pool state in a JAX PagedKVCache and, carried across by
    paged_cache_from_jax, in the port's."""
    k, v, ks, vs, pool_pos, tables = _pool(7, int8)
    jc = jpkv.PagedKVCache(_j(k)[None], _j(v)[None], _j(pool_pos), _j(tables),
                           None if ks is None else _j(ks)[None],
                           None if vs is None else _j(vs)[None])
    pc = paged_cache_from_jax(
        dict(k=np.asarray(jc.k), v=np.asarray(jc.v), positions=pool_pos,
             page_table=tables,
             k_scale=None if ks is None else np.asarray(jc.k_scale),
             v_scale=None if vs is None else np.asarray(jc.v_scale)), device="cpu")
    return jc, pc


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_view_and_gather_match_jax(int8):
    jc, pc = _both_caches(int8)
    assert (pc.n_pages, pc.page_size, pc.n_slots, pc.view_slots) == \
        (jc.n_pages, jc.page_size, jc.n_slots, jc.view_slots)
    np.testing.assert_array_equal(
        pkv.view_slot_map(pc.page_table, G).numpy(),
        np.asarray(jpkv.view_slot_map(jc.page_table, G)))
    np.testing.assert_array_equal(pkv.view_positions(pc).numpy(),
                                  np.asarray(jpkv.view_positions(jc)))
    jg = jpkv.gather_view(jc, jc.k[0], jc.v[0],
                          None if not int8 else jc.k_scale[0],
                          None if not int8 else jc.v_scale[0])
    pg = pkv.gather_view(pc, pc.k[0], pc.v[0],
                         None if not int8 else pc.k_scale[0],
                         None if not int8 else pc.v_scale[0])
    for a, b in zip(pg, jg, strict=True):
        if b is None:
            assert a is None
            continue
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b.astype(jnp.float32)))


@pytest.mark.parametrize("edit,args", [
    ("seq_rm", (0, 5, 20)), ("seq_rm", (1, -1, 50)), ("seq_rm", (0, 100, -1)),
    ("seq_add", (0, 20, -1, -15)), ("seq_add", (1, 0, -1, 7)), ("seq_add", (0, 2, 8, -5)),
    ("seq_div", (0, 4, 160, 2)), ("seq_div", (1, 0, -1, 3)),
])
def test_row_masked_position_edits_match_jax(edit, args):
    """An edit touches only the pages of its row; stale positions on pages
    the row does not own stay as they are."""
    jc, pc = _both_caches(False)
    ref = getattr(jpkv, edit)(jc, args[0], *[jnp.int32(a) for a in args[1:]]).positions
    out = getattr(pkv, edit)(pc, *args).positions
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _allocators(**kw):
    return jpkv.PageAllocator(**kw), pkv.PageAllocator(**kw)


def test_page_allocator_recycles_deterministically():
    for a in _allocators(n_pages=4, page_size=128, max_pages_per_row=2, n_rows=2):
        s0 = a.allocate_slots(0, 130)   # pages 0,1
        assert list(a.tables[0][:2]) == [0, 1]
        s1 = a.allocate_slots(1, 10)    # page 2
        assert a.tables[1][0] == 2
        assert a.free_pages == 1
        assert a.allocate_slots(1, 128 * 2) is None   # row window cap
        freed = a.free_row(0)
        assert sorted(freed) == [0, 1] and a.free_pages == 3
        a.allocate_slots(0, 1)                          # lowest-physical-first reuse
        assert a.tables[0][0] == 0
        assert s0[0] == 0 and s0[129] == 1 * 128 + 1 and s1[0] == 2 * 128


def test_pool_exhaustion_returns_none():
    for a in _allocators(n_pages=2, page_size=128, max_pages_per_row=4, n_rows=1):
        assert a.allocate_slots(0, 256) is not None
        assert a.allocate_slots(0, 1) is None  # pool dry
        assert not a.can_admit(1)              # needs 1 page + 1 headroom


def test_allocator_random_walk_matches_jax():
    """The same admission order gives the same placement, budgets and
    recycling in both allocators."""
    ja, pa_ = _allocators(n_pages=9, page_size=128, max_pages_per_row=4, n_rows=3)
    rng = np.random.default_rng(5)
    for _ in range(200):
        row, n = int(rng.integers(0, 3)), int(rng.integers(1, 200))
        op = rng.integers(0, 4)
        if op == 0:
            assert ja.free_row(row) == pa_.free_row(row)
        elif op == 1:
            budget = int(rng.integers(0, 4))
            assert ja.max_extend(row, n, budget) == pa_.max_extend(row, n, budget)
            assert ja.can_admit(n) == pa_.can_admit(n)
        else:
            r, p = ja.allocate_slots(row, n), pa_.allocate_slots(row, n)
            assert (r is None) == (p is None)
            if r is not None:
                np.testing.assert_array_equal(r, p)
        np.testing.assert_array_equal(ja.tables, pa_.tables)
        assert ja.free_pages == pa_.free_pages
        assert [ja.row_len(r) for r in range(3)] == [pa_.row_len(r) for r in range(3)]


def test_gates_match_jax():
    for G_ in (16, 64, 128, 256):
        for D_ in (64, 128, 257, 512):
            for dt_j, dt_p in ((jnp.bfloat16, torch.bfloat16), (jnp.int8, torch.int8)):
                assert pa.supports(G_, D_, dt_p) == jpa.supports(G_, D_, dt_j)
                for T in (1, 2, 4, 8, 24, 256):
                    assert pa.prefill_supports(T, G_, D_, dt_p) == \
                        jpa.prefill_supports(T, G_, D_, dt_j)


def test_pad_slot_is_never_exposed():
    pc = pkv.PagedKVCache.create(1, 2, 3, 128, 2, 2, 8, "bfloat16", device="cpu")
    assert pc.k.shape == (1, 3, 128, 2, 8) and pc.positions.shape == (3, 128)
    assert pc.pad_slot == pc.n_slots == 3 * 128
    flat = pc.flat_slots(torch.tensor([[5, 3 * 128], [3 * 128, 3 * 128 + 9]]))
    assert flat.tolist() == [5, 384, 384, 384]
    pc.pos_store[flat] = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    assert (pc.positions >= 0).sum() == 1 and (pkv.view_positions(pc) == -1).all()
