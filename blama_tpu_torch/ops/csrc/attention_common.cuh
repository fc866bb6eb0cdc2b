// Flash attention over the position-mapped KV store, for Hopper (sm_90a),
// CUDA C++: the device code shared by the dense kernels C and D
// (decode_attention.cu) and the paged kernels E and F (paged_attention.cu).
//
// The store holds UNROTATED keys and the values per slot, [slots, Hkv, D],
// in one of two element types: int8 codes with f32 per-(slot, head) scales,
// or bf16 values with no scales (the TPU kernels' `quantized` static). A
// slot's position lives in a position map (-1 = empty). Semantics of the TPU
// kernels:
//   * rope is applied to K inside the kernel from the slot's position times
//     the interleave-expanded inverse frequency (pairs (2i, 2i+1));
//   * the K scale is folded into the scores, the V scale into the
//     probabilities (rope and the dots are linear in the codes); a bf16
//     store uses the scale 1.0f, an exact multiply;
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

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
__device__ __forceinline__ void copy4(int8_t* dst, const int8_t* src) {
  *reinterpret_cast<int*>(dst) = src ? *reinterpret_cast<const int*>(src) : 0;
}
__device__ __forceinline__ void copy4(__nv_bfloat16* dst, const __nv_bfloat16* src) {
  *reinterpret_cast<uint2*>(dst) =
      src ? *reinterpret_cast<const uint2*>(src) : make_uint2(0u, 0u);
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

// Stage logical slots [t0, min(t0 + TS, t_end)) of kv head hk of row b into
// shared memory. An unmapped tile, and slots that no query of the block can
// see (pos < 0 or pos > qmax), are not read. Returns (block-uniform) whether
// any slot is visible.
template <int D, class KV, class Addr>
__device__ bool load_tile(const Smem<D, KV>& sm, const KV* __restrict__ k,
                          const KV* __restrict__ v,
                          const float* __restrict__ ks,
                          const float* __restrict__ vs,
                          const int* __restrict__ kv_pos,
                          const float* __restrict__ invf, const Addr& addr,
                          int b, int hk, int Hkv, int t0, int t_end, int qmax) {
  const int tid = threadIdx.x;
  const long long base = addr.tile_base(b, t0);   // block-uniform
  if (base < 0) return false;
  bool vis = false;
  if (tid < TS) {
    const int p = t0 + tid < t_end ? kv_pos[base + tid] : -1;
    vis = p >= 0 && p <= qmax;
    sm.pos[tid] = p;
    const size_t si = (size_t)(base + tid) * Hkv + hk;
    sm.ksc[tid] = vis ? (ks ? ks[si] : 1.0f) : 0.0f;
    sm.vsc[tid] = vis ? (vs ? vs[si] : 1.0f) : 0.0f;
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
      float kf[4];
      load4(k + off, kf);
      vsrc = v + off;
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
template <int D, class KV, class Addr>
__global__ void decode_attn_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, H, D] rotated queries
    const KV* __restrict__ k, const KV* __restrict__ v,
    const float* __restrict__ ks, const float* __restrict__ vs,
    const int* __restrict__ kv_pos,       // position map of the store
    const int* __restrict__ q_pos,        // [B]
    const float* __restrict__ invf,       // [D]
    float* __restrict__ part_m, float* __restrict__ part_l,
    float* __restrict__ part_acc,         // [B, H, nsplit(, D)]
    Addr addr, int H, int Hkv, int S, int chunk, float scale) {
  extern __shared__ __align__(16) float smem_raw[];
  const int g = H / Hkv;
  const Smem<D, KV> sm(smem_raw, g);
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = hk * g + warp;
  for (int e = threadIdx.x; e < g * D; e += blockDim.x)
    sm.q[e] = __bfloat162float(q[((size_t)b * H + hk * g) * D + e]);
  __syncthreads();
  const int qpos = q_pos[b];
  float m = NEG_INF, l = 0.0f, acc[D / 32];
#pragma unroll
  for (int i = 0; i < D / 32; ++i) acc[i] = 0.0f;
  const int s0 = split * chunk, s1 = min(S, s0 + chunk);
  for (int t0 = s0; t0 < s1; t0 += TS) {
    if (load_tile<D, KV, Addr>(sm, k, v, ks, vs, kv_pos, invf, addr, b, hk, Hkv,
                               t0, s1, qpos))
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

template <int D, class KV, class Addr>
int decode_impl(const void* q, const void* k, const void* v, const void* ks,
                const void* vs, const void* kv_pos, const void* q_pos,
                const void* invf, void* part_m, void* part_l, void* part_acc,
                void* out, Addr addr, int B, int H, int Hkv, int S, int chunk,
                float scale, cudaStream_t st) {
  const int g = H / Hkv;
  const size_t smem = Smem<D, KV>::bytes(g);
  cudaFuncSetAttribute(decode_attn_kernel<D, KV, Addr>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const int nsplit = (S + chunk - 1) / chunk;
  dim3 grid(B * Hkv, nsplit);
  decode_attn_kernel<D, KV, Addr><<<grid, 32 * g, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(kv_pos),
      static_cast<const int*>(q_pos), static_cast<const float*>(invf),
      static_cast<float*>(part_m), static_cast<float*>(part_l),
      static_cast<float*>(part_acc), addr, H, Hkv, S, chunk, scale);
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
// codes with scales, 1 = bf16); -1 for a combination the kernels are not
// built for.
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
    }                                                                           \
    return -1;                                                                  \
  } while (0)

}  // namespace attn
