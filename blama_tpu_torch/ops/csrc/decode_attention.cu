// Flash attention over the position-mapped INT8 KV cache, for Hopper
// (sm_90a), CUDA C++.
//
// Kernel C (decode_attention_launch) replaces
//   blama_tpu/ops/pallas/decode_attention.py:_decode_attn_kernel
// and kernel D (prefill_attention_launch) replaces
//   blama_tpu/ops/pallas/decode_attention.py:_prefill_attn_kernel.
//
// Both read the cache as the port stores it: int8 codes [B, S, Hkv, D]
// (unrotated K), f32 per-(slot, head) scales [B, S, Hkv] and the slot
// position map [B, S] (-1 = empty). Semantics of the TPU kernels:
//   * rope is applied to K inside the kernel from the slot's position times
//     the interleave-expanded inverse frequency (pairs (2i, 2i+1));
//   * the K scale is folded into the scores, the V scale into the
//     probabilities (rope and the dots are linear in the codes);
//   * slots with pos == -1 or pos > the query's position are masked;
//   * GQA: the H/Hkv query heads of one kv head share its K/V tiles;
//   * online softmax over the slots in a fixed order, NEG_INF = -1e30 and
//     the max(l, 1e-30) finalize.
//
// Bound on this card: bytes. A decode step reads each valid slot's K and V
// codes once (2*Hkv*D bytes plus 8*Hkv bytes of scales) and does ~4*H*D
// flops per slot, about 2 flops per byte. Design: the cache is streamed
// once, in 32-slot tiles staged in shared memory; a tile whose slots are
// all masked is skipped without reading its codes, so an empty cache costs
// only its position map. Decode has a single query token per row, so the
// slot range is split across blocks (fixed split for a given S, B and Hkv)
// and a second pass combines the splits in a fixed order; no atomics, so a
// replay on the same card gives the same bits.
//
// Per tile: one thread block loads the codes of one kv head, rotates K in
// f32 into shared memory (one sincosf per pair, shared by the group's query
// heads), then each warp owns one query row: lane j scores slot j, the warp
// reduces max and sum with a fixed xor-butterfly, and each lane accumulates
// D/32 output dims.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TS = 32;            // cache slots per tile (one per lane)
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

// Shared memory of one block: W query rows, one rotated K tile (padded rows:
// lane j reads row j without bank conflicts), one V tile of codes, the
// tile's scales and positions.
template <int D>
struct Smem {
  float* q;       // [W][D]
  float* krot;    // [TS][D + 1]
  float* ksc;     // [TS]
  float* vsc;     // [TS]
  int* pos;       // [TS]
  int8_t* v;      // [TS][D]
  __device__ Smem(float* base, int W) {
    q = base;
    krot = q + W * D;
    ksc = krot + TS * (D + 1);
    vsc = ksc + TS;
    pos = reinterpret_cast<int*>(vsc + TS);
    v = reinterpret_cast<int8_t*>(pos + TS);
  }
  static size_t bytes(int W) {
    return sizeof(float) * ((size_t)W * D + TS * (D + 1) + 3 * TS) + (size_t)TS * D;
  }
};

// Stage slots [t0, min(t0 + TS, t_end)) of kv head hk of row b into shared
// memory. Slots that no query of the block can see (pos < 0 or pos > qmax)
// are not read. Returns (block-uniform) whether any slot is visible.
template <int D>
__device__ bool load_tile(const Smem<D>& sm, const int8_t* __restrict__ k,
                          const int8_t* __restrict__ v,
                          const float* __restrict__ ks,
                          const float* __restrict__ vs,
                          const int* __restrict__ kv_pos,
                          const float* __restrict__ invf, int b, int hk,
                          int Hkv, int S, int t0, int t_end, int qmax) {
  const int tid = threadIdx.x;
  bool vis = false;
  if (tid < TS) {
    const int s = t0 + tid;
    const int p = s < t_end ? kv_pos[(size_t)b * S + s] : -1;
    vis = p >= 0 && p <= qmax;
    sm.pos[tid] = p;
    const size_t si = ((size_t)b * S + s) * Hkv + hk;
    sm.ksc[tid] = vis ? ks[si] : 0.0f;
    sm.vsc[tid] = vis ? vs[si] : 0.0f;
  }
  if (!__syncthreads_or(vis)) return false;
  constexpr int C4 = D / 4;
  for (int e = tid; e < TS * C4; e += blockDim.x) {
    const int j = e / C4, c = e % C4;
    const int p = sm.pos[j];
    float* kr = sm.krot + j * (D + 1) + 4 * c;
    int vw = 0;
    if (p >= 0 && p <= qmax) {
      const size_t off = (((size_t)b * S + t0 + j) * Hkv + hk) * D + 4 * c;
      const int kw = *reinterpret_cast<const int*>(k + off);
      vw = *reinterpret_cast<const int*>(v + off);
      const float k0 = (float)(int8_t)(kw & 0xff);
      const float k1 = (float)(int8_t)((kw >> 8) & 0xff);
      const float k2 = (float)(int8_t)((kw >> 16) & 0xff);
      const float k3 = (float)(int8_t)((kw >> 24) & 0xff);
      float s0, c0, s1, c1;
      sincosf((float)p * invf[4 * c], &s0, &c0);
      sincosf((float)p * invf[4 * c + 2], &s1, &c1);
      kr[0] = k0 * c0 + k1 * (-s0);
      kr[1] = k1 * c0 + k0 * s0;
      kr[2] = k2 * c1 + k3 * (-s1);
      kr[3] = k3 * c1 + k2 * s1;
    } else {
      kr[0] = kr[1] = kr[2] = kr[3] = 0.0f;
    }
    *reinterpret_cast<int*>(sm.v + j * D + 4 * c) = vw;
  }
  __syncthreads();
  return true;
}

// One warp folds the staged tile into its query row's online-softmax state.
template <int D>
__device__ void attend_tile(const Smem<D>& sm, const float* qrow, int qpos,
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
    const int8_t* vr = sm.v + j * D + lane;
#pragma unroll
    for (int i = 0; i < D / 32; ++i) acc[i] += pj * (float)vr[32 * i];
  }
  m = m_new;
}

// ---------------------------------------------------------------------------
// kernel C: decode (one query token per row), slot range split over blocks
// ---------------------------------------------------------------------------
template <int D>
__global__ void decode_attn_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, H, D] rotated queries
    const int8_t* __restrict__ k, const int8_t* __restrict__ v,
    const float* __restrict__ ks, const float* __restrict__ vs,
    const int* __restrict__ kv_pos,       // [B, S]
    const int* __restrict__ q_pos,        // [B]
    const float* __restrict__ invf,       // [D]
    float* __restrict__ part_m, float* __restrict__ part_l,
    float* __restrict__ part_acc,         // [B, H, nsplit(, D)]
    int H, int Hkv, int S, int chunk, float scale) {
  extern __shared__ __align__(16) float smem_raw[];
  const int g = H / Hkv;
  const Smem<D> sm(smem_raw, g);
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
    if (load_tile<D>(sm, k, v, ks, vs, kv_pos, invf, b, hk, Hkv, S, t0, s1, qpos))
      attend_tile<D>(sm, sm.q + warp * D, qpos, scale, m, l, acc);
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
__global__ void decode_combine_kernel(const float* __restrict__ part_m,
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
// kernel D: causal prefill of a T-token chunk over the same cache
// ---------------------------------------------------------------------------
template <int D>
__global__ void prefill_attn_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, T, H, D] rotated queries
    const int8_t* __restrict__ k, const int8_t* __restrict__ v,
    const float* __restrict__ ks, const float* __restrict__ vs,
    const int* __restrict__ kv_pos,       // [B, S]
    const int* __restrict__ q_pos,        // [B, T]
    const float* __restrict__ invf,       // [D]
    __nv_bfloat16* __restrict__ out,      // [B, T, H, D]
    int T, int H, int Hkv, int S, int qt, float scale) {
  extern __shared__ __align__(16) float smem_raw[];
  const int g = H / Hkv;
  const int W = qt * g;
  const Smem<D> sm(smem_raw, W);
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
    if (load_tile<D>(sm, k, v, ks, vs, kv_pos, invf, b, hk, Hkv, S, t0, S, qmax))
      attend_tile<D>(sm, sm.q + warp * D, qpos, scale, m, l, acc);
    __syncthreads();
  }
  if (active) {
    const float denom = fmaxf(l, 1e-30f);
    __nv_bfloat16* o = out + (((size_t)b * T + tok) * H + h) * D;
#pragma unroll
    for (int i = 0; i < D / 32; ++i) o[lane + 32 * i] = __float2bfloat16(acc[i] / denom);
  }
}

template <int D>
int decode_impl(const void* q, const void* k, const void* v, const void* ks,
                const void* vs, const void* kv_pos, const void* q_pos,
                const void* invf, void* part_m, void* part_l, void* part_acc,
                void* out, int B, int H, int Hkv, int S, int chunk, float scale,
                cudaStream_t st) {
  const int g = H / Hkv;
  const size_t smem = Smem<D>::bytes(g);
  cudaFuncSetAttribute(decode_attn_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const int nsplit = (S + chunk - 1) / chunk;
  dim3 grid(B * Hkv, nsplit);
  decode_attn_kernel<D><<<grid, 32 * g, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(kv_pos),
      static_cast<const int*>(q_pos), static_cast<const float*>(invf),
      static_cast<float*>(part_m), static_cast<float*>(part_l),
      static_cast<float*>(part_acc), H, Hkv, S, chunk, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<<<B * H, D, 0, st>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<__nv_bfloat16*>(out),
      nsplit, D);
  return (int)cudaGetLastError();
}

template <int D>
int prefill_impl(const void* q, const void* k, const void* v, const void* ks,
                 const void* vs, const void* kv_pos, const void* q_pos,
                 const void* invf, void* out, int B, int T, int H, int Hkv,
                 int S, int qt, float scale, cudaStream_t st) {
  const int g = H / Hkv;
  const size_t smem = Smem<D>::bytes(qt * g);
  cudaFuncSetAttribute(prefill_attn_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid(B * Hkv, (T + qt - 1) / qt);
  prefill_attn_kernel<D><<<grid, 32 * qt * g, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(kv_pos),
      static_cast<const int*>(q_pos), static_cast<const float*>(invf),
      static_cast<__nv_bfloat16*>(out), T, H, Hkv, S, qt, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t; -1 for a head dim the kernels are not built for.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* ks, const void* vs, const void* kv_pos,
                            const void* q_pos, const void* invf, void* part_m,
                            void* part_l, void* part_acc, void* out, int B,
                            int H, int Hkv, int D, int S, int chunk,
                            float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return decode_impl<64>(q, k, v, ks, vs, kv_pos, q_pos, invf, part_m, part_l, part_acc, out, B, H, Hkv, S, chunk, scale, st);
    case 128: return decode_impl<128>(q, k, v, ks, vs, kv_pos, q_pos, invf, part_m, part_l, part_acc, out, B, H, Hkv, S, chunk, scale, st);
    case 256: return decode_impl<256>(q, k, v, ks, vs, kv_pos, q_pos, invf, part_m, part_l, part_acc, out, B, H, Hkv, S, chunk, scale, st);
  }
  return -1;
}

int prefill_attention_launch(const void* q, const void* k, const void* v,
                             const void* ks, const void* vs, const void* kv_pos,
                             const void* q_pos, const void* invf, void* out,
                             int B, int T, int H, int Hkv, int D, int S, int qt,
                             float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return prefill_impl<64>(q, k, v, ks, vs, kv_pos, q_pos, invf, out, B, T, H, Hkv, S, qt, scale, st);
    case 128: return prefill_impl<128>(q, k, v, ks, vs, kv_pos, q_pos, invf, out, B, T, H, Hkv, S, qt, scale, st);
    case 256: return prefill_impl<256>(q, k, v, ks, vs, kv_pos, q_pos, invf, out, B, T, H, Hkv, S, qt, scale, st);
  }
  return -1;
}

}  // extern "C"
