// Flash attention over the position-mapped KV store, for Hopper (sm_90a),
// CUDA C++: the device code shared by the dense kernels C and D
// (decode_attention.cu) and the paged kernels E and F (paged_attention.cu).
//
// The store holds UNROTATED keys and the values per slot, [slots, Hkv, D],
// in one of three element types: int8 codes with f32 per-(slot, head)
// scales, or bf16 or f32 values with no scales (the TPU kernels' `quantized`
// static). A slot's position lives in a position map (-1 = empty).
// Semantics of the TPU kernels:
//   * rope is applied to K inside the kernel from the slot's position times
//     the interleave-expanded inverse frequency (pairs (2i, 2i+1));
//   * the K scale is folded into the scores, the V scale into the
//     probabilities (rope and the dots are linear in the codes); a bf16 or
//     f32 store uses the scale 1.0f, an exact multiply;
//   * slots with pos == -1 or pos > the query's position are masked;
//   * GQA: the H/Hkv query heads of one kv head share its K/V tiles;
//   * online softmax over the slots in a fixed order, NEG_INF = -1e30 and
//     the max(l, 1e-30) finalize.
//
// Addressing is the only difference between dense and paged: a kernel walks
// the LOGICAL slots of a row in 32-slot tiles, and an address functor maps a
// tile's first logical slot to its physical slot in the store (dense:
// b*S + s; paged: page_table[b][s / G] * G + s % G, or "unmapped"). A tile
// never straddles a page (G % 32 == 0). Everything after the address — the
// loads, the rope, the per-warp update, the split and the combine — is the
// same code, so a paged row gives the same bits as the dense row with the
// same logical content, wherever its pages lie.
//
// Bound on this card: bytes for decode (each visible slot's K and V read
// once, ~2 flops per byte), operations for long prefill chunks. Design: the
// store is streamed once per block in 32-slot tiles staged in shared memory;
// a tile that is unmapped, or whose slots no query of the block can see, is
// skipped without reading its K and V. Decode has a single query token per
// row, so the slot range is split across blocks (fixed split for a given S,
// B and Hkv) and a second pass combines the splits in a fixed order; no
// atomics, so a replay on the same card gives the same bits.
//
// Per tile: one thread block loads the slots of one kv head, rotates K in
// f32 into shared memory (one sincosf per pair, shared by the group's query
// heads), then each warp owns one query row: lane j scores slot j, the warp
// reduces max and sum with a fixed xor-butterfly, and each lane accumulates
// D/32 output dims.
//
// Two variants of the decode body share that loop (kernels N and P): the
// step's fresh K/V row rides in as an operand, the block whose split holds
// its slot quantizes it exactly as the cache write does and patches it into
// the staged tile, so nothing in the step reads the stored row; P also
// stores the row (codes and scales) to the cache. The head-batched body
// (kernel O) is a different walk: one block per (row, split) over all kv
// heads of a tile, one warp per query head.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace attn {

constexpr int TS = 32;            // store slots per tile (one per lane)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// --- element types of the store ---------------------------------------------

__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(float x) { return x; }

// four consecutive elements: as floats (K), or copied raw (V tile)
__device__ __forceinline__ void load4(const int8_t* p, float (&o)[4]) {
  const int w = *reinterpret_cast<const int*>(p);
  o[0] = (float)(int8_t)(w & 0xff);
  o[1] = (float)(int8_t)((w >> 8) & 0xff);
  o[2] = (float)(int8_t)((w >> 16) & 0xff);
  o[3] = (float)(int8_t)((w >> 24) & 0xff);
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  o[0] = __uint_as_float(w.x << 16);
  o[1] = __uint_as_float(w.x & 0xffff0000u);
  o[2] = __uint_as_float(w.y << 16);
  o[3] = __uint_as_float(w.y & 0xffff0000u);
}
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 w = *reinterpret_cast<const float4*>(p);
  o[0] = w.x;
  o[1] = w.y;
  o[2] = w.z;
  o[3] = w.w;
}
__device__ __forceinline__ void copy4(int8_t* dst, const int8_t* src) {
  *reinterpret_cast<int*>(dst) = src ? *reinterpret_cast<const int*>(src) : 0;
}
__device__ __forceinline__ void copy4(__nv_bfloat16* dst, const __nv_bfloat16* src) {
  *reinterpret_cast<uint2*>(dst) =
      src ? *reinterpret_cast<const uint2*>(src) : make_uint2(0u, 0u);
}
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  *reinterpret_cast<float4*>(dst) =
      src ? *reinterpret_cast<const float4*>(src) : make_float4(0.f, 0.f, 0.f, 0.f);
}

// --- addressing ---------------------------------------------------------------

// Dense rows: logical slot s of row b is physical slot b*S + s.
struct DenseAddr {
  int S;
  __device__ __forceinline__ long long tile_base(int b, int s) const {
    return (long long)b * S + s;
  }
};

// Paged rows: logical slot s of row b lies on page table[b][s / G] of the
// pool, or nowhere (-1) when that page is unmapped.
struct PagedAddr {
  const int* table;   // [B, MP]
  int MP, G;
  __device__ __forceinline__ long long tile_base(int b, int s) const {
    const int page = table[(size_t)b * MP + s / G];
    return page < 0 ? -1 : (long long)page * G + s % G;
  }
};

// --- the step's fresh K/V row (kernels N and P) --------------------------------

// Kernels N and P take this step's unrotated K and V rows as operands; P
// also writes them to the store. `k`/`v` alias the store the kernel reads:
// the only slot P writes is one no block reads through the input pointers
// (the patched slot comes from shared memory, the spare slot is never read).
template <class KV>
struct Fresh {
  const __nv_bfloat16* k_new;   // [B, Hkv, D]
  const __nv_bfloat16* v_new;
  const int* slot;              // [B] the row's slot (>= S: a pad row)
  KV* k;                        // write mode: the store, [slots(+1), Hkv, D]
  KV* v;
  float* ks;                    // [slots(+1), Hkv] (int8 store), else null
  float* vs;
  long long pad_slot;           // the store's spare slot (pad rows' writes)
};

// the stored form of an f32 value in a float store type
__device__ __forceinline__ void from_f(float x, __nv_bfloat16& o) { o = __float2bfloat16_rn(x); }
__device__ __forceinline__ void from_f(float x, float& o) { o = x; }

// One block stages a [D] row as the store holds it: for int8, codes and
// the scale by ops/kv_cache.quantize_kv's formula (max-abs over the row,
// amax / 127 and 1 / scale as IEEE divisions, round half to even); for a
// float store the values in its type and the scale 1. Every thread returns
// the scale; `red` holds one float per warp.
template <int D, class KV>
__device__ float stage_row(const __nv_bfloat16* __restrict__ src, KV* dst, float* red) {
  if constexpr (std::is_same<KV, int8_t>::value) {
    float amax = 0.0f;
    for (int d = threadIdx.x; d < D; d += blockDim.x)
      amax = fmaxf(amax, fabsf(__bfloat162float(src[d])));
    amax = warp_max(amax);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
    __syncthreads();
    amax = red[0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) amax = fmaxf(amax, red[w]);
    __syncthreads();
    const float sc = amax / 127.0f;
    const float inv = sc > 0.0f ? 1.0f / sc : 0.0f;
    for (int d = threadIdx.x; d < D; d += blockDim.x)
      dst[d] = (int8_t)__float2int_rn(__bfloat162float(src[d]) * inv);
    return sc;
  } else {
    for (int d = threadIdx.x; d < D; d += blockDim.x)
      from_f(__bfloat162float(src[d]), dst[d]);
    return 1.0f;
  }
}

// --- shared memory of one block -------------------------------------------------
// W query rows, one rotated K tile (padded rows: lane j reads row j without
// bank conflicts), the tile's scales and positions, one V tile as stored.
template <int D, class KV>
struct Smem {
  float* q;       // [W][D]
  float* krot;    // [TS][D + 1]
  float* ksc;     // [TS]
  float* vsc;     // [TS]
  int* pos;       // [TS]
  KV* v;          // [TS][D]
  __device__ Smem(float* base, int W) {
    q = base;
    krot = q + W * D;
    ksc = krot + TS * (D + 1);
    vsc = ksc + TS;
    pos = reinterpret_cast<int*>(vsc + TS);
    v = reinterpret_cast<KV*>(pos + TS);
  }
  static size_t bytes(int W) {
    return sizeof(float) * ((size_t)W * D + TS * (D + 1) + 3 * TS) +
           sizeof(KV) * (size_t)TS * D;
  }
};

// The fresh row staged in shared memory, patched over logical slot `s`
// (-1: no patch) of the tile that holds it.
template <class KV>
struct Patch {
  int s;
  const KV* k;     // [D] as stored
  const KV* v;
  float ks, vs;    // its scales (1 for a float store)
};

// Stage logical slots [t0, min(t0 + TS, t_end)) of kv head hk of row b into
// shared memory. An unmapped tile, and slots that no query of the block can
// see (pos < 0 or pos > qmax), are not read. With PATCH, slot patch.s takes
// the fresh row and its scales instead of what the store holds there.
// Returns (block-uniform) whether any slot is visible.
template <int D, class KV, class Addr, bool PATCH = false>
__device__ bool load_tile(const Smem<D, KV>& sm, const KV* __restrict__ k,
                          const KV* __restrict__ v,
                          const float* __restrict__ ks,
                          const float* __restrict__ vs,
                          const int* __restrict__ kv_pos,
                          const float* __restrict__ invf, const Addr& addr,
                          int b, int hk, int Hkv, int t0, int t_end, int qmax,
                          const Patch<KV>& patch = Patch<KV>{-1}) {
  const int tid = threadIdx.x;
  const long long base = addr.tile_base(b, t0);   // block-uniform
  if (base < 0) return false;
  bool vis = false;
  if (tid < TS) {
    const int p = t0 + tid < t_end ? kv_pos[base + tid] : -1;
    vis = p >= 0 && p <= qmax;
    sm.pos[tid] = p;
    const size_t si = (size_t)(base + tid) * Hkv + hk;
    const bool hit = PATCH && t0 + tid == patch.s;
    sm.ksc[tid] = vis ? (hit ? patch.ks : ks ? ks[si] : 1.0f) : 0.0f;
    sm.vsc[tid] = vis ? (hit ? patch.vs : vs ? vs[si] : 1.0f) : 0.0f;
  }
  if (!__syncthreads_or(vis)) return false;
  constexpr int C4 = D / 4;
  for (int e = tid; e < TS * C4; e += blockDim.x) {
    const int j = e / C4, c = e % C4;
    const int p = sm.pos[j];
    float* kr = sm.krot + j * (D + 1) + 4 * c;
    const KV* vsrc = nullptr;
    if (p >= 0 && p <= qmax) {
      const size_t off = ((size_t)(base + j) * Hkv + hk) * D + 4 * c;
      const bool hit = PATCH && t0 + j == patch.s;
      float kf[4];
      load4(hit ? patch.k + 4 * c : k + off, kf);
      vsrc = hit ? patch.v + 4 * c : v + off;
      float s0, c0, s1, c1;
      sincosf((float)p * invf[4 * c], &s0, &c0);
      sincosf((float)p * invf[4 * c + 2], &s1, &c1);
      kr[0] = kf[0] * c0 + kf[1] * (-s0);
      kr[1] = kf[1] * c0 + kf[0] * s0;
      kr[2] = kf[2] * c1 + kf[3] * (-s1);
      kr[3] = kf[3] * c1 + kf[2] * s1;
    } else {
      kr[0] = kr[1] = kr[2] = kr[3] = 0.0f;
    }
    copy4(sm.v + j * D + 4 * c, vsrc);
  }
  __syncthreads();
  return true;
}

// One warp folds the staged tile into its query row's online-softmax state.
template <int D, class KV>
__device__ void attend_tile(const Smem<D, KV>& sm, const float* qrow, int qpos,
                            float scale, float& m, float& l,
                            float (&acc)[D / 32]) {
  const int lane = threadIdx.x & 31;
  const int p = sm.pos[lane];
  const bool valid = p >= 0 && p <= qpos;
  if (!__any_sync(0xffffffffu, valid)) return;
  float s = NEG_INF;
  if (valid) {
    const float* kr = sm.krot + lane * (D + 1);
    float dot = 0.0f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) dot += qrow[d] * kr[d];
    s = dot * scale * sm.ksc[lane];
  }
  const float m_new = fmaxf(m, warp_max(s));
  const float alpha = expf(m - m_new);
  const float e = valid ? expf(s - m_new) : 0.0f;
  l = alpha * l + warp_sum(e);
  const float pv = e * sm.vsc[lane];
#pragma unroll
  for (int i = 0; i < D / 32; ++i) acc[i] *= alpha;
  for (int j = 0; j < TS; ++j) {
    const float pj = __shfl_sync(0xffffffffu, pv, j);
    const KV* vr = sm.v + j * D + lane;
#pragma unroll
    for (int i = 0; i < D / 32; ++i) acc[i] += pj * to_f(vr[32 * i]);
  }
  m = m_new;
}

// ---------------------------------------------------------------------------
// decode (one query token per row), logical slot range split over blocks
// ---------------------------------------------------------------------------
// MODE 0: kernel C, the store as it is. MODE 1 (kernel N) and MODE 2
// (kernel P): the row's fresh K/V row is patched over its slot in the block
// whose split holds that slot; P also stores it (codes and scales) at the
// slot, and a pad row's (slot >= S) at the spare slot, from split 0. The
// patch gives the tile the values a cache write would have left there, and
// everything after it is C's code, so N and P give C's bits after that
// write.
template <int D, class KV, class Addr, int MODE = 0>
__global__ void decode_attn_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, H, D] rotated queries
    const KV* __restrict__ k, const KV* __restrict__ v,
    const float* __restrict__ ks, const float* __restrict__ vs,
    const int* __restrict__ kv_pos,       // position map of the store
    const int* __restrict__ q_pos,        // [B]
    const float* __restrict__ invf,       // [D]
    float* __restrict__ part_m, float* __restrict__ part_l,
    float* __restrict__ part_acc,         // [B, H, nsplit(, D)]
    Addr addr, int H, int Hkv, int S, int chunk, float scale,
    Fresh<KV> fresh) {
  extern __shared__ __align__(16) float smem_raw[];
  const int g = H / Hkv;
  const Smem<D, KV> sm(smem_raw, g);
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = hk * g + warp;
  for (int e = threadIdx.x; e < g * D; e += blockDim.x)
    sm.q[e] = __bfloat162float(q[((size_t)b * H + hk * g) * D + e]);
  const int s0 = split * chunk, s1 = min(S, s0 + chunk);
  Patch<KV> patch{-1};
  if constexpr (MODE != 0) {
    __shared__ __align__(16) KV fk[D];
    __shared__ __align__(16) KV fv[D];
    __shared__ float red[32];
    const int sl = fresh.slot[b];
    const bool here = sl >= s0 && sl < s1;
    const bool writer = MODE == 2 && (here || (sl >= S && split == 0));
    if (here || writer) {                   // block-uniform
      const size_t src = ((size_t)b * Hkv + hk) * D;
      const float ksc = stage_row<D, KV>(fresh.k_new + src, fk, red);
      const float vsc = stage_row<D, KV>(fresh.v_new + src, fv, red);
      __syncthreads();
      if (here) patch = Patch<KV>{sl, fk, fv, ksc, vsc};
      if (writer) {
        const long long slot = sl < S ? (long long)b * S + sl : fresh.pad_slot;
        const size_t dst = ((size_t)slot * Hkv + hk) * D;
        for (int d = threadIdx.x; d < D; d += blockDim.x) {
          fresh.k[dst + d] = fk[d];
          fresh.v[dst + d] = fv[d];
        }
        if (fresh.ks && threadIdx.x == 0) {
          fresh.ks[(size_t)slot * Hkv + hk] = ksc;
          fresh.vs[(size_t)slot * Hkv + hk] = vsc;
        }
      }
    }
  }
  __syncthreads();
  const int qpos = q_pos[b];
  float m = NEG_INF, l = 0.0f, acc[D / 32];
#pragma unroll
  for (int i = 0; i < D / 32; ++i) acc[i] = 0.0f;
  for (int t0 = s0; t0 < s1; t0 += TS) {
    if (load_tile<D, KV, Addr, MODE != 0>(sm, k, v, ks, vs, kv_pos, invf, addr, b,
                                          hk, Hkv, t0, s1, qpos, patch))
      attend_tile<D, KV>(sm, sm.q + warp * D, qpos, scale, m, l, acc);
    __syncthreads();
  }
  const size_t row = ((size_t)b * H + h) * nsplit + split;
  if (lane == 0) {
    part_m[row] = m;
    part_l[row] = l;
  }
#pragma unroll
  for (int i = 0; i < D / 32; ++i) part_acc[row * D + lane + 32 * i] = acc[i];
}

// Combine the splits of one (row, head) in split order.
static __global__ void decode_combine_kernel(const float* __restrict__ part_m,
                                             const float* __restrict__ part_l,
                                             const float* __restrict__ part_acc,
                                             __nv_bfloat16* __restrict__ out,
                                             int nsplit, int D) {
  const size_t row = blockIdx.x;
  const int d = threadIdx.x;
  const float* pm = part_m + row * nsplit;
  const float* plv = part_l + row * nsplit;
  float mx = NEG_INF;
  for (int p = 0; p < nsplit; ++p) mx = fmaxf(mx, pm[p]);
  float lsum = 0.0f, a = 0.0f;
  for (int p = 0; p < nsplit; ++p) {
    const float w = expf(pm[p] - mx);
    lsum += plv[p] * w;
    a += part_acc[(row * nsplit + p) * D + d] * w;
  }
  out[row * D + d] = __float2bfloat16(a / fmaxf(lsum, 1e-30f));
}

// ---------------------------------------------------------------------------
// head-batched decode (kernel O): one block per (row, split) over all kv heads
// ---------------------------------------------------------------------------
// A tile is `ts` consecutive slots of the row with all Hkv heads: each
// slot's contiguous Hkv*D row of K (then of V) is read once for the whole
// block. Warp w owns query heads w, w + 32, ...: lane j scores slot j of
// the head's kv head, then the warp folds the tile into that head's
// online-softmax state, which lives in shared memory (any H). K is rotated
// into a head-major buffer that V reuses, as f32, after the scores. The
// split is the reference's head-batched one (a block cap of
// max(128, 4096 / Hkv) slots), so the numerics are this kernel's own, fixed
// for a given (B, S, Hkv): the same combine and a fixed order everywhere.
template <int D>
struct HbSmem {
  float* q;      // [H][D]
  float* acc;    // [H][D]
  float* buf;    // [Hkv][ts][D + 1]: rotated K, then V
  float* pv;     // [H][32] probabilities x V scale of the tile
  float* m;      // [H]
  float* l;      // [H]
  float* alpha;  // [H]
  float* ksc;    // [Hkv][ts]
  float* vsc;    // [Hkv][ts]
  int* pos;      // [ts]
  __device__ HbSmem(float* base, int H, int Hkv, int ts) {
    q = base;
    acc = q + H * D;
    buf = acc + H * D;
    pv = buf + (size_t)Hkv * ts * (D + 1);
    m = pv + H * 32;
    l = m + H;
    alpha = l + H;
    ksc = alpha + H;
    vsc = ksc + Hkv * ts;
    pos = reinterpret_cast<int*>(vsc + Hkv * ts);
  }
  static size_t bytes(int H, int Hkv, int ts) {
    return sizeof(float) * ((size_t)2 * H * D + (size_t)Hkv * ts * (D + 1) + H * 32 +
                            3 * H + 2 * Hkv * ts + ts);
  }
};

template <int D, class KV>
__global__ void decode_attn_hb_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, H, D] rotated queries
    const KV* __restrict__ k, const KV* __restrict__ v,   // [B*S(+1), Hkv, D]
    const float* __restrict__ ks, const float* __restrict__ vs,
    const int* __restrict__ kv_pos,       // [B, S]
    const int* __restrict__ q_pos,        // [B]
    const float* __restrict__ invf,       // [D]
    float* __restrict__ part_m, float* __restrict__ part_l,
    float* __restrict__ part_acc,         // [B, H, nsplit(, D)]
    int H, int Hkv, int S, int chunk, int ts, float scale) {
  extern __shared__ __align__(16) float smem_raw[];
  const HbSmem<D> sm(smem_raw, H, Hkv, ts);
  const int b = blockIdx.x, split = blockIdx.y, nsplit = gridDim.y;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nw = nthr >> 5;
  const int g = H / Hkv;
  for (int e = tid; e < H * D; e += nthr) {
    sm.q[e] = __bfloat162float(q[(size_t)b * H * D + e]);
    sm.acc[e] = 0.0f;
  }
  for (int h = tid; h < H; h += nthr) {
    sm.m[h] = NEG_INF;
    sm.l[h] = 0.0f;
  }
  const int qpos = q_pos[b];
  const int s0 = split * chunk, s1 = min(S, s0 + chunk);
  constexpr int C4 = D / 4;
  const int rowlen = Hkv * C4;               // float4 chunks per slot
  __syncthreads();
  for (int t0 = s0; t0 < s1; t0 += ts) {
    const long long base = (long long)b * S + t0;
    bool vis = false;
    if (tid < ts) {
      const int p = t0 + tid < s1 ? kv_pos[base + tid] : -1;
      vis = p >= 0 && p <= qpos;
      sm.pos[tid] = vis ? p : -1;
    }
    if (!__syncthreads_or(vis)) continue;
    for (int e = tid; e < ts * Hkv; e += nthr) {
      const int j = e / Hkv, hh = e % Hkv;
      const bool ok = sm.pos[j] >= 0;
      sm.ksc[hh * ts + j] = ok ? (ks ? ks[(base + j) * Hkv + hh] : 1.0f) : 0.0f;
      sm.vsc[hh * ts + j] = ok ? (vs ? vs[(base + j) * Hkv + hh] : 1.0f) : 0.0f;
    }
    // K: each slot's Hkv*D row once, rotated into [hh][j][D + 1]
    for (int e = tid; e < ts * rowlen; e += nthr) {
      const int j = e / rowlen, r = e % rowlen, hh = r / C4, c = r % C4;
      const int p = sm.pos[j];
      float* kr = sm.buf + ((size_t)hh * ts + j) * (D + 1) + 4 * c;
      if (p >= 0) {
        float kf[4];
        load4(k + ((size_t)(base + j) * Hkv + hh) * D + 4 * c, kf);
        float sn0, cs0, sn1, cs1;
        sincosf((float)p * invf[4 * c], &sn0, &cs0);
        sincosf((float)p * invf[4 * c + 2], &sn1, &cs1);
        kr[0] = kf[0] * cs0 + kf[1] * (-sn0);
        kr[1] = kf[1] * cs0 + kf[0] * sn0;
        kr[2] = kf[2] * cs1 + kf[3] * (-sn1);
        kr[3] = kf[3] * cs1 + kf[2] * sn1;
      } else {
        kr[0] = kr[1] = kr[2] = kr[3] = 0.0f;
      }
    }
    __syncthreads();
    for (int h = warp; h < H; h += nw) {
      const int hh = h / g;
      const bool valid = lane < ts && sm.pos[lane] >= 0;
      float s = NEG_INF;
      if (valid) {
        const float* kr = sm.buf + ((size_t)hh * ts + lane) * (D + 1);
        const float* qh = sm.q + h * D;
        float dot = 0.0f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot += qh[d] * kr[d];
        s = dot * scale * sm.ksc[hh * ts + lane];
      }
      const float m_old = sm.m[h];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float alpha = expf(m_old - m_new);
      const float e = valid ? expf(s - m_new) : 0.0f;
      const float lsum = warp_sum(e);
      sm.pv[h * 32 + lane] = valid ? e * sm.vsc[hh * ts + lane] : 0.0f;
      __syncwarp();
      if (lane == 0) {
        sm.l[h] = alpha * sm.l[h] + lsum;
        sm.m[h] = m_new;
        sm.alpha[h] = alpha;
      }
    }
    __syncthreads();
    // V: the same rows, as f32, into the same buffer
    for (int e = tid; e < ts * rowlen; e += nthr) {
      const int j = e / rowlen, r = e % rowlen, hh = r / C4, c = r % C4;
      float* vr = sm.buf + ((size_t)hh * ts + j) * (D + 1) + 4 * c;
      float vf[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (sm.pos[j] >= 0) load4(v + ((size_t)(base + j) * Hkv + hh) * D + 4 * c, vf);
      vr[0] = vf[0];
      vr[1] = vf[1];
      vr[2] = vf[2];
      vr[3] = vf[3];
    }
    __syncthreads();
    for (int h = warp; h < H; h += nw) {
      const int hh = h / g;
      const float alpha = sm.alpha[h];
      float* ah = sm.acc + h * D;
#pragma unroll
      for (int i = 0; i < D / 32; ++i) {
        float a = ah[lane + 32 * i] * alpha;
        for (int j = 0; j < ts; ++j)
          a += sm.pv[h * 32 + j] * sm.buf[((size_t)hh * ts + j) * (D + 1) + lane + 32 * i];
        ah[lane + 32 * i] = a;
      }
    }
    __syncthreads();
  }
  for (int h = warp; h < H; h += nw) {
    const size_t row = ((size_t)b * H + h) * nsplit + split;
    if (lane == 0) {
      part_m[row] = sm.m[h];
      part_l[row] = sm.l[h];
    }
#pragma unroll
    for (int i = 0; i < D / 32; ++i) part_acc[row * D + lane + 32 * i] = sm.acc[h * D + lane + 32 * i];
  }
}

// ---------------------------------------------------------------------------
// causal prefill of a T-token chunk over the same store
// ---------------------------------------------------------------------------
template <int D, class KV, class Addr>
__global__ void prefill_attn_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, T, H, D] rotated queries
    const KV* __restrict__ k, const KV* __restrict__ v,
    const float* __restrict__ ks, const float* __restrict__ vs,
    const int* __restrict__ kv_pos,       // position map of the store
    const int* __restrict__ q_pos,        // [B, T]
    const float* __restrict__ invf,       // [D]
    __nv_bfloat16* __restrict__ out,      // [B, T, H, D]
    Addr addr, int T, int H, int Hkv, int S, int qt, float scale) {
  extern __shared__ __align__(16) float smem_raw[];
  const int g = H / Hkv;
  const int W = qt * g;
  const Smem<D, KV> sm(smem_raw, W);
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int tq0 = blockIdx.y * qt;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tok = tq0 + warp / g, h = hk * g + warp % g;
  const bool active = tok < T;
  for (int e = threadIdx.x; e < W * D; e += blockDim.x) {
    const int w = e / D, d = e % D;
    const int t = tq0 + w / g, hh = hk * g + w % g;
    sm.q[e] = t < T ? __bfloat162float(q[(((size_t)b * T + t) * H + hh) * D + d]) : 0.0f;
  }
  int qmax = -1;
  for (int t = tq0; t < min(T, tq0 + qt); ++t) qmax = max(qmax, q_pos[(size_t)b * T + t]);
  const int qpos = active ? q_pos[(size_t)b * T + tok] : -1;
  __syncthreads();
  float m = NEG_INF, l = 0.0f, acc[D / 32];
#pragma unroll
  for (int i = 0; i < D / 32; ++i) acc[i] = 0.0f;
  for (int t0 = 0; t0 < S; t0 += TS) {
    if (load_tile<D, KV, Addr>(sm, k, v, ks, vs, kv_pos, invf, addr, b, hk, Hkv,
                               t0, S, qmax))
      attend_tile<D, KV>(sm, sm.q + warp * D, qpos, scale, m, l, acc);
    __syncthreads();
  }
  if (active) {
    const float denom = fmaxf(l, 1e-30f);
    __nv_bfloat16* o = out + (((size_t)b * T + tok) * H + h) * D;
#pragma unroll
    for (int i = 0; i < D / 32; ++i) o[lane + 32 * i] = __float2bfloat16(acc[i] / denom);
  }
}

// --- host launchers ---------------------------------------------------------------

template <int D, class KV, class Addr, int MODE = 0>
int decode_impl(const void* q, const void* k, const void* v, const void* ks,
                const void* vs, const void* kv_pos, const void* q_pos,
                const void* invf, void* part_m, void* part_l, void* part_acc,
                void* out, Addr addr, int B, int H, int Hkv, int S, int chunk,
                float scale, cudaStream_t st, Fresh<KV> fresh = Fresh<KV>{}) {
  const int g = H / Hkv;
  const size_t smem = Smem<D, KV>::bytes(g);
  cudaFuncSetAttribute(decode_attn_kernel<D, KV, Addr, MODE>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const int nsplit = (S + chunk - 1) / chunk;
  dim3 grid(B * Hkv, nsplit);
  decode_attn_kernel<D, KV, Addr, MODE><<<grid, 32 * g, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(kv_pos),
      static_cast<const int*>(q_pos), static_cast<const float*>(invf),
      static_cast<float*>(part_m), static_cast<float*>(part_l),
      static_cast<float*>(part_acc), addr, H, Hkv, S, chunk, scale, fresh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<<<B * H, D, 0, st>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<__nv_bfloat16*>(out),
      nsplit, D);
  return (int)cudaGetLastError();
}

// Kernels N (write == 0) and P (write == 1) over dense rows: C's launch
// with the fresh rows. In write mode k/v/ks/vs are the layer's whole store,
// slots [B*S + 1] with the spare slot pad_slot = B*S.
template <int D, class KV, class Addr>
int decode_fresh_impl(const void* q, const void* k, const void* v, const void* ks,
                      const void* vs, const void* kv_pos, const void* q_pos,
                      const void* invf, const void* k_new, const void* v_new,
                      const void* slot, void* part_m, void* part_l, void* part_acc,
                      void* out, Addr addr, int B, int H, int Hkv, int S, int chunk,
                      int write, float scale, cudaStream_t st) {
  Fresh<KV> fresh{static_cast<const __nv_bfloat16*>(k_new),
                  static_cast<const __nv_bfloat16*>(v_new),
                  static_cast<const int*>(slot),
                  const_cast<KV*>(static_cast<const KV*>(k)),
                  const_cast<KV*>(static_cast<const KV*>(v)),
                  const_cast<float*>(static_cast<const float*>(ks)),
                  const_cast<float*>(static_cast<const float*>(vs)),
                  (long long)B * S};
  if (write)
    return decode_impl<D, KV, Addr, 2>(q, k, v, ks, vs, kv_pos, q_pos, invf, part_m,
                                       part_l, part_acc, out, addr, B, H, Hkv, S,
                                       chunk, scale, st, fresh);
  return decode_impl<D, KV, Addr, 1>(q, k, v, ks, vs, kv_pos, q_pos, invf, part_m,
                                     part_l, part_acc, out, addr, B, H, Hkv, S, chunk,
                                     scale, st, fresh);
}

// Kernel O over dense rows: the largest tile of 32, 16, ... slots whose
// buffers fit the block's shared memory, then C's combine.
template <int D, class KV, class Addr>
int decode_hb_impl(const void* q, const void* k, const void* v, const void* ks,
                   const void* vs, const void* kv_pos, const void* q_pos,
                   const void* invf, void* part_m, void* part_l, void* part_acc,
                   void* out, Addr, int B, int H, int Hkv, int S, int chunk,
                   float scale, cudaStream_t st) {
  constexpr size_t kMaxSmem = 227 * 1024;
  int ts = TS;
  while (ts > 1 && HbSmem<D>::bytes(H, Hkv, ts) > kMaxSmem) ts /= 2;
  const size_t smem = HbSmem<D>::bytes(H, Hkv, ts);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidConfiguration;
  cudaFuncSetAttribute(decode_attn_hb_kernel<D, KV>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const int nsplit = (S + chunk - 1) / chunk;
  dim3 grid(B, nsplit);
  decode_attn_hb_kernel<D, KV><<<grid, 32 * min(H, 32), smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(kv_pos),
      static_cast<const int*>(q_pos), static_cast<const float*>(invf),
      static_cast<float*>(part_m), static_cast<float*>(part_l),
      static_cast<float*>(part_acc), H, Hkv, S, chunk, ts, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<<<B * H, D, 0, st>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<__nv_bfloat16*>(out),
      nsplit, D);
  return (int)cudaGetLastError();
}

template <int D, class KV, class Addr>
int prefill_impl(const void* q, const void* k, const void* v, const void* ks,
                 const void* vs, const void* kv_pos, const void* q_pos,
                 const void* invf, void* out, Addr addr, int B, int T, int H,
                 int Hkv, int S, int qt, float scale, cudaStream_t st) {
  const int g = H / Hkv;
  const size_t smem = Smem<D, KV>::bytes(qt * g);
  cudaFuncSetAttribute(prefill_attn_kernel<D, KV, Addr>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid(B * Hkv, (T + qt - 1) / qt);
  prefill_attn_kernel<D, KV, Addr><<<grid, 32 * qt * g, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(kv_pos),
      static_cast<const int*>(q_pos), static_cast<const float*>(invf),
      static_cast<__nv_bfloat16*>(out), addr, T, H, Hkv, S, qt, scale);
  return (int)cudaGetLastError();
}

// Pick the instantiation for head dim D and store type kv_type (0 = int8
// codes with scales, 1 = bf16, 2 = f32); -1 for a combination the kernels
// are not built for.
#define ATTN_DISPATCH(IMPL, ADDR, ...)                                          \
  do {                                                                          \
    if (kv_type == 0) {                                                         \
      switch (D) {                                                              \
        case 64: return IMPL<64, int8_t, ADDR>(__VA_ARGS__);                    \
        case 128: return IMPL<128, int8_t, ADDR>(__VA_ARGS__);                  \
        case 256: return IMPL<256, int8_t, ADDR>(__VA_ARGS__);                  \
      }                                                                         \
    } else if (kv_type == 1) {                                                  \
      switch (D) {                                                              \
        case 64: return IMPL<64, __nv_bfloat16, ADDR>(__VA_ARGS__);             \
        case 128: return IMPL<128, __nv_bfloat16, ADDR>(__VA_ARGS__);           \
        case 256: return IMPL<256, __nv_bfloat16, ADDR>(__VA_ARGS__);           \
      }                                                                         \
    } else if (kv_type == 2) {                                                  \
      switch (D) {                                                              \
        case 64: return IMPL<64, float, ADDR>(__VA_ARGS__);                     \
        case 128: return IMPL<128, float, ADDR>(__VA_ARGS__);                   \
        case 256: return IMPL<256, float, ADDR>(__VA_ARGS__);                   \
      }                                                                         \
    }                                                                           \
    return -1;                                                                  \
  } while (0)

}  // namespace attn
