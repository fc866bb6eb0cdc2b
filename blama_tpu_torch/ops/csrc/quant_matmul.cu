// W4A8 and exact Q4_K matmul kernels for Hopper (sm_90a), CUDA C++.
//
// Weight layout (built by blama_tpu_torch/ops/quant_matmul.py from GGUF
// Q4_K bytes): codes uint8 [N, K/2], row-major along K. Each 32-element
// group g of row n owns 16 consecutive bytes; byte i holds code 32g+i in its
// low nibble and code 32g+16+i in its high nibble. scales / mins are bf16
// [N, K/32] (d*sc and dmin*mn of each group), so a weight decodes to
// code*scale - min.
//
// Kernel A (w4a8_matmul_launch) replaces the TPU kernels
//   blama_tpu/ops/pallas/quant_matmul.py:_a8s_xin_kernel (one row) and
//   blama_tpu/ops/pallas/quant_matmul.py:_a8s_pinned_kernel (2..16 rows),
// which compute the same function. Two launches:
//   1. quant_acts_kernel: per (row, 32-group) of x, scale = amax/127,
//      inv = 1/scale (0 when scale is 0), q = rint(x*inv) as int8
//      (round half to even, like jnp.round), xsum = sum(q); it writes the
//      codes, the scales and scale*xsum.
//   2. w4a8_gemv_kernel: per output column n and group g the int32 dot of
//      the int8 codes with the 4-bit codes (8 dp4a), then
//      acc += dot*(d*sc)*xscale - (xscale*xsum)*(dmin*mn).
// Bound on this card: bytes. At one row the weights are K*N/2 code bytes
// plus 4*(K/32)*N bytes of bf16 scales and mins, about 0.625 bytes per
// weight, against 2 int ops per weight: far below the ~600 ops/byte where
// the int8 rate would bind. Design: each warp streams one weight row with
// 16-byte loads (one load = one group per lane, the whole warp reads 512
// contiguous bytes), reads each weight byte once for all M <= 16 rows, and
// keeps the activations of a K chunk in shared memory, so device memory
// sees each weight byte once per call.
//
// Kernel B (q4k_dequant_mm_launch) replaces
//   blama_tpu/ops/pallas/quant_matmul.py:_q4k_matmul_kernel:
// out[m, n] = sum_k x[m, k] * code[n, k] * scale[n, k/32] in f32 (the min
// term is applied by the caller, as q4k_matmul does outside its kernel).
// Bound on this card: at the prompt chunks (M = 32..512) the f32 products,
// 2*M*K*N operations against the same weight bytes, bind (M=128 is ~400 f32
// ops per weight byte). Design: a tiled f32 SIMT GEMM (64x64 output tile per
// 256-thread block, 4x4 outputs per thread) that dequantizes one 32-group of
// 64 weight rows into shared memory per K step. f32 FMA keeps the products
// exact to the f32 dot the reference takes; tensor cores (wgmma) are later
// work.
//
// Determinism: every sum runs in a fixed order (per-lane K order, then a
// fixed xor-butterfly across the warp); no atomics, so a replay on the same
// card gives the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GROUP = 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// ---------------------------------------------------------------------------
// kernel A, part 1: activation quantization, one warp per (row, group)
// ---------------------------------------------------------------------------
template <typename T>
__global__ void quant_acts_kernel(const T* __restrict__ x, int M, int K,
                                  int8_t* __restrict__ xq,
                                  float* __restrict__ xs,
                                  float* __restrict__ sxm) {
  const int G = K / GROUP;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= M * G) return;  // uniform per warp
  const int m = warp / G, g = warp % G;
  const size_t idx = (size_t)m * K + (size_t)g * GROUP + lane;
  const float v = to_f32(x[idx]);
  float a = fabsf(v);
#pragma unroll
  for (int o = 16; o; o >>= 1) a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
  const float scale = a / 127.0f;
  const float inv = scale > 0.0f ? 1.0f / scale : 0.0f;
  const int q = __float2int_rn(v * inv);
  int s = q;
#pragma unroll
  for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  xq[idx] = (int8_t)q;
  if (lane == 0) {
    xs[(size_t)m * G + g] = scale;
    sxm[(size_t)m * G + g] = scale * (float)s;
  }
}

// ---------------------------------------------------------------------------
// kernel A, part 2: the W4A8 GEMV, one warp per output column
// ---------------------------------------------------------------------------
constexpr int A_WARPS = 8;     // output columns per block
constexpr int A_KC = 2048;     // K elements of x staged per chunk

template <int MT>
__global__ void __launch_bounds__(A_WARPS * 32)
w4a8_gemv_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                 const float* __restrict__ sxm,
                 const uint8_t* __restrict__ codes,
                 const __nv_bfloat16* __restrict__ scales,
                 const __nv_bfloat16* __restrict__ mins,
                 float* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) int8_t s_x[MT * A_KC];
  __shared__ float s_xs[MT * (A_KC / GROUP)];
  __shared__ float s_sxm[MT * (A_KC / GROUP)];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * A_WARPS + warp;
  const int G = K / GROUP;
  const uint4* wrow = reinterpret_cast<const uint4*>(codes + (size_t)n * (K / 2));
  float acc[MT];
#pragma unroll
  for (int r = 0; r < MT; ++r) acc[r] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += A_KC) {
    const int kc = min(A_KC, K - k0);
    const int gc = kc / GROUP;
    __syncthreads();
    for (int i = threadIdx.x; i < M * (kc / 16); i += blockDim.x) {
      const int r = i / (kc / 16), c = i % (kc / 16);
      reinterpret_cast<int4*>(s_x + r * A_KC)[c] =
          reinterpret_cast<const int4*>(xq + (size_t)r * K + k0)[c];
    }
    for (int i = threadIdx.x; i < M * gc; i += blockDim.x) {
      const int r = i / gc, c = i % gc;
      s_xs[r * (A_KC / GROUP) + c] = xs[(size_t)r * G + k0 / GROUP + c];
      s_sxm[r * (A_KC / GROUP) + c] = sxm[(size_t)r * G + k0 / GROUP + c];
    }
    __syncthreads();
    if (n < N) {
      for (int gl = lane; gl < gc; gl += 32) {
        const int g = k0 / GROUP + gl;
        const uint4 w = __ldg(wrow + g);
        const float ws = __bfloat162float(scales[(size_t)n * G + g]);
        const float wm = __bfloat162float(mins[(size_t)n * G + g]);
        const int lo0 = w.x & 0x0F0F0F0F, hi0 = (w.x >> 4) & 0x0F0F0F0F;
        const int lo1 = w.y & 0x0F0F0F0F, hi1 = (w.y >> 4) & 0x0F0F0F0F;
        const int lo2 = w.z & 0x0F0F0F0F, hi2 = (w.z >> 4) & 0x0F0F0F0F;
        const int lo3 = w.w & 0x0F0F0F0F, hi3 = (w.w >> 4) & 0x0F0F0F0F;
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          if (r < M) {
            const int4* xp = reinterpret_cast<const int4*>(s_x + r * A_KC + gl * GROUP);
            const int4 xa = xp[0];  // group elements 0..15
            const int4 xb = xp[1];  // group elements 16..31
            int dot = __dp4a(lo0, xa.x, 0);
            dot = __dp4a(lo1, xa.y, dot);
            dot = __dp4a(lo2, xa.z, dot);
            dot = __dp4a(lo3, xa.w, dot);
            dot = __dp4a(hi0, xb.x, dot);
            dot = __dp4a(hi1, xb.y, dot);
            dot = __dp4a(hi2, xb.z, dot);
            dot = __dp4a(hi3, xb.w, dot);
            const int si = r * (A_KC / GROUP) + gl;
            acc[r] += (float)dot * ws * s_xs[si] - s_sxm[si] * wm;
          }
        }
      }
    }
  }
  if (n < N) {
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      float v = acc[r];
#pragma unroll
      for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0 && r < M) out[(size_t)r * N + n] = v;
    }
  }
}

template <int MT>
void launch_gemv(const int8_t* xq, const float* xs, const float* sxm,
                 const uint8_t* codes, const __nv_bfloat16* scales,
                 const __nv_bfloat16* mins, float* out, int M, int K, int N,
                 cudaStream_t st) {
  const int blocks = (N + A_WARPS - 1) / A_WARPS;
  w4a8_gemv_kernel<MT><<<blocks, A_WARPS * 32, 0, st>>>(xq, xs, sxm, codes, scales,
                                                        mins, out, M, K, N);
}

// ---------------------------------------------------------------------------
// kernel B: exact dequant GEMM (positive part), f32 SIMT tiles
// ---------------------------------------------------------------------------
constexpr int B_BM = 64, B_BN = 64, B_BK = GROUP;

template <typename T>
__global__ void __launch_bounds__(256)
q4k_dequant_mm_kernel(const T* __restrict__ x, const uint8_t* __restrict__ codes,
                      const __nv_bfloat16* __restrict__ scales,
                      float* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) float s_x[B_BK][B_BM + 4];
  __shared__ __align__(16) float s_w[B_BK][B_BN + 4];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * B_BM, n0 = blockIdx.x * B_BN;
  const int G = K / GROUP;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int g = 0; g < G; ++g) {
    for (int i = threadIdx.x; i < B_BM * B_BK; i += blockDim.x) {
      const int r = i / B_BK, k = i % B_BK;
      const int m = m0 + r;
      s_x[k][r] = m < M ? to_f32(x[(size_t)m * K + (size_t)g * GROUP + k]) : 0.0f;
    }
    for (int i = threadIdx.x; i < B_BN * 16; i += blockDim.x) {
      const int c = i / 16, b = i % 16;
      const int n = n0 + c;
      float s = 0.0f;
      int byte = 0;
      if (n < N) {
        byte = codes[(size_t)n * (K / 2) + (size_t)g * 16 + b];
        s = __bfloat162float(scales[(size_t)n * G + g]);
      }
      s_w[b][c] = (float)(byte & 15) * s;
      s_w[b + 16][c] = (float)(byte >> 4) * s;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < B_BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&s_x[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&s_w[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) out[(size_t)m * N + n] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// x: [M, K] bf16 (x_bf16 != 0) or f32; 1 <= M <= 16, K % 32 == 0.
// xq [M, K] int8, xs / sxm [M, K/32] f32 and out [M, N] f32 are outputs.
int w4a8_matmul_launch(const void* x, int x_bf16, const void* codes,
                       const void* scales, const void* mins, void* xq, void* xs,
                       void* sxm, void* out, int M, int K, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int warps = M * (K / GROUP);
  const int qblocks = (warps * 32 + 255) / 256;
  if (x_bf16)
    quant_acts_kernel<__nv_bfloat16><<<qblocks, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), M, K, static_cast<int8_t*>(xq),
        static_cast<float*>(xs), static_cast<float*>(sxm));
  else
    quant_acts_kernel<float><<<qblocks, 256, 0, st>>>(
        static_cast<const float*>(x), M, K, static_cast<int8_t*>(xq),
        static_cast<float*>(xs), static_cast<float*>(sxm));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int8_t* q = static_cast<const int8_t*>(xq);
  const float* s = static_cast<const float*>(xs);
  const float* sm = static_cast<const float*>(sxm);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  const __nv_bfloat16* sc = static_cast<const __nv_bfloat16*>(scales);
  const __nv_bfloat16* mn = static_cast<const __nv_bfloat16*>(mins);
  float* o = static_cast<float*>(out);
  if (M <= 1) launch_gemv<1>(q, s, sm, c, sc, mn, o, M, K, N, st);
  else if (M <= 2) launch_gemv<2>(q, s, sm, c, sc, mn, o, M, K, N, st);
  else if (M <= 4) launch_gemv<4>(q, s, sm, c, sc, mn, o, M, K, N, st);
  else if (M <= 8) launch_gemv<8>(q, s, sm, c, sc, mn, o, M, K, N, st);
  else launch_gemv<16>(q, s, sm, c, sc, mn, o, M, K, N, st);
  return (int)cudaGetLastError();
}

// x: [M, K] bf16 (x_bf16 != 0) or f32, K % 32 == 0; out: [M, N] f32.
int q4k_dequant_mm_launch(const void* x, int x_bf16, const void* codes,
                          const void* scales, void* out, int M, int K, int N,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((N + B_BN - 1) / B_BN, (M + B_BM - 1) / B_BM);
  if (x_bf16)
    q4k_dequant_mm_kernel<__nv_bfloat16><<<grid, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(codes),
        static_cast<const __nv_bfloat16*>(scales), static_cast<float*>(out), M, K, N);
  else
    q4k_dequant_mm_kernel<float><<<grid, 256, 0, st>>>(
        static_cast<const float*>(x), static_cast<const uint8_t*>(codes),
        static_cast<const __nv_bfloat16*>(scales), static_cast<float*>(out), M, K, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
