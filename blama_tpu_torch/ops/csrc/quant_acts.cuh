// Kernel A's activation quantizer as a launch of its own: the prologue of
// the tools' slab GEMVs (kernel T in quant_matmul.cu, Q and V in
// slab_gemv.cu). Per (row, 32-group) of x: scale = amax / 127 (IEEE
// division), inv = 1 / scale (0 when scale is 0), q = rint(x * inv) as int8
// (round half to even), xs = scale, sxm = scale * sum(q); one warp per
// (row, group). With TRIGGER each CTA lets a programmatic dependent launch
// (Q and V's GEMV) start at once: the GEMV waits for this grid's outputs
// itself (griddepcontrol.wait), and streams its weights meanwhile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace acts {

constexpr int GROUP = 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, bool TRIGGER>
__global__ void quant_acts_kernel(const T* __restrict__ x, int M, int K,
                                  int8_t* __restrict__ xq,
                                  float* __restrict__ xs,
                                  float* __restrict__ sxm) {
  if constexpr (TRIGGER) asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
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

// x [M, K] bf16 (x_bf16) or f32 → xq int8 [M, K], xs and sxm f32 [M, K/32]
template <bool TRIGGER = false>
void launch_quant_acts(const void* x, int x_bf16, int M, int K, void* xq, void* xs, void* sxm,
                       cudaStream_t st) {
  const int warps = M * (K / GROUP);
  const int qblocks = (warps * 32 + 255) / 256;
  int8_t* q = static_cast<int8_t*>(xq);
  float* s = static_cast<float*>(xs);
  float* sm = static_cast<float*>(sxm);
  if (x_bf16)
    quant_acts_kernel<__nv_bfloat16, TRIGGER><<<qblocks, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), M, K, q, s, sm);
  else
    quant_acts_kernel<float, TRIGGER><<<qblocks, 256, 0, st>>>(static_cast<const float*>(x), M,
                                                                K, q, s, sm);
}

}  // namespace acts
}  // namespace
