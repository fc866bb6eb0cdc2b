// Card microbenchmark kernels of the tools, CUDA C++ for Hopper (sm_90a).
//
// Kernel R (stream_rows_launch) replaces
//   blama_tpu/tools/probe_bw.py:_stream_kernel:
// codes uint8 [R, N] in blocks of [bk, bn] bytes, grid (N / bn, R / bk):
// out[0, n] = sum over the blocks of column n of the block's first 8 rows
// (fewer when bk < 8), as exact f32 integers. The TPU kernel's BlockSpec DMA
// brings the whole block into VMEM and sums 8 rows of it, so it measures the
// memory pipeline alone. Here one CTA owns one block and brings every byte of
// it into shared memory with cp.async (16 bytes a thread, neighbouring threads
// on neighbouring addresses), in pieces of at most R_PIECE bytes, two pieces
// in flight, and sums the first 8 rows from there. Bound on this card: bytes
// (each block's bk * bn bytes, at most 8 adds a column). The sums are integers
// below 2^24, exact in f32 in any order, so the CTAs of a column add theirs to
// the output with atomicAdd (zeroed by the caller) and the bits do not depend
// on the order. With a `total` output the CTA also sums every byte it staged,
// per column: the proof that every byte reached the SM.
//
// Kernel S (add_one_launch) replaces
//   blama_tpu/tools/probe_overhead.py:_tiny_kernel:
// o = x + 1.0f on a small f32 array (the probe's [8, 128]), one CTA: the
// least work a launch can carry, so a chain of them measures the cost of a
// launch (eager, or replayed from a CUDA graph).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R_THREADS = 256;
constexpr int R_PIECE = 32 * 1024;   // bytes of one staged piece
constexpr int R_MAX_BN = 16384;      // widest block a CTA takes

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(R_THREADS)
stream_rows_kernel(const uint8_t* __restrict__ codes, int N, int bk, int bn,
                   float* __restrict__ out, float* __restrict__ total) {
  extern __shared__ __align__(16) uint8_t smem[];
  float* s_acc = reinterpret_cast<float*>(smem);   // [bn]: the first 8 rows
  float* s_tot = s_acc + bn;                       // [bn]: every row (total)
  uint8_t* buf = smem + (size_t)(total ? 2 : 1) * bn * sizeof(float);
  const int rpp = max(1, R_PIECE / bn);            // rows of a piece
  const int npieces = (bk + rpp - 1) / rpp;
  const int vpr = bn / 16;                         // 16-byte vectors a row
  const uint8_t* base = codes + (size_t)blockIdx.y * bk * N + (size_t)blockIdx.x * bn;

  for (int c = threadIdx.x; c < bn; c += R_THREADS) {
    s_acc[c] = 0.0f;
    if (total) s_tot[c] = 0.0f;
  }
  auto issue = [&](int p) {
    const int r0 = p * rpp, rows = min(rpp, bk - r0);
    uint8_t* dst = buf + (size_t)(p & 1) * rpp * bn;
    for (int j = threadIdx.x; j < rows * vpr; j += R_THREADS) {
      const int r = j / vpr, v = j % vpr;
      cp_async16(dst + (size_t)r * bn + v * 16, base + (size_t)(r0 + r) * N + v * 16);
    }
    cp_async_commit();
  };
  issue(0);
  for (int p = 0; p < npieces; ++p) {
    if (p + 1 < npieces) {
      issue(p + 1);
      cp_async_wait<1>();                          // piece p has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int r0 = p * rpp, rows = min(rpp, bk - r0);
    const uint8_t* src = buf + (size_t)(p & 1) * rpp * bn;
    for (int c = threadIdx.x; c < bn; c += R_THREADS) {
      for (int r = 0; r < rows && r0 + r < 8; ++r) s_acc[c] += (float)src[(size_t)r * bn + c];
      if (total)
        for (int r = 0; r < rows; ++r) s_tot[c] += (float)src[(size_t)r * bn + c];
    }
    __syncthreads();                               // before piece p+2 lands here
  }
  const size_t n0 = (size_t)blockIdx.x * bn;
  for (int c = threadIdx.x; c < bn; c += R_THREADS) {
    atomicAdd(out + n0 + c, s_acc[c]);
    if (total) atomicAdd(total + n0 + c, s_tot[c]);
  }
}

__global__ void add_one_kernel(const float* __restrict__ x, float* __restrict__ o, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) o[i] = x[i] + 1.0f;
}

}  // namespace

extern "C" {

// Kernel R: codes [R, N] uint8 (16-byte aligned rows: N % 16 == 0), blocks of
// [bk, bn] (bn % 16 == 0, bn <= 16384), grid (N / bn, R / bk); out [N] f32 and
// total [N] f32 (or null) zeroed by the caller.
int stream_rows_launch(const void* codes, int R, int N, int bk, int bn, void* out,
                       void* total, void* stream) {
  if (bk < 1 || bn < 16 || bn % 16 || bn > R_MAX_BN || N % 16 || R / bk < 1 || N / bn < 1 ||
      R / bk > 65535)
    return (int)cudaErrorInvalidValue;
  const int rpp = R_PIECE / bn;                 // as the kernel computes it
  const size_t smem = (size_t)(total ? 2 : 1) * bn * sizeof(float) + 2 * (size_t)rpp * bn;
  cudaError_t err = cudaFuncSetAttribute(stream_rows_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N / bn, R / bk);
  stream_rows_kernel<<<grid, R_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), N, bk, bn, static_cast<float*>(out),
      static_cast<float*>(total));
  return (int)cudaGetLastError();
}

// Kernel S: o[i] = x[i] + 1 for i < n, one CTA of 256 threads.
int add_one_launch(const void* x, void* o, int n, void* stream) {
  add_one_kernel<<<1, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(o), n);
  return (int)cudaGetLastError();
}

}  // extern "C"
