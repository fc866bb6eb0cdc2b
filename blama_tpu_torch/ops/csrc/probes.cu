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
//
// Kernels W and X (bytes_launch, int8_dot_launch) replace the SWAR and
// Mosaic capability probes of blama_tpu/tools/probe_swar.py (W:
// k_roundtrip :12, k_swar_lo_hi :17, k_swar_dot :25) and probe_mosaic.py
// (X: k_u8_bitops :22, k_u8_upcast_i16 :29, k_i8_dot :36,
// k_i8_from_unpack_dot :42). uint8 [R, N] arrays are read as 32-bit words
// of four neighbouring bytes along N (the TPU's pltpu.bitcast packs four
// sublanes instead; every result is per byte, so the grouping is moot):
//   roundtrip  the words written back as bytes: the identity;
//   lo / hi    w & 0x0F0F0F0F and (w >> 4) & 0x0F0F0F0F (unsigned shift) as
//              int8: x & 0xF and x >> 4 of every byte;
//   u8 bitops  (x & 0xF) + (x >> 4) in uint8 arithmetic, byte by byte;
//   i16 bitops the same through int16;
// and the int8 dots, out[m, n] int32 = sum_k a[m, k] * b(k, n) (M <= 32):
//   swar dot   a [M, K] with lo(c[k, n]) plus with hi(c[k, n]), c uint8 [K, N];
//   i8 dot     b int8 [K, N];
//   unpack dot a [M, 2K] with concat([c & 0xF, c >> 4]) for c uint8 [K, N]:
//              a's first K columns meet the low nibbles, the last K the high.
// A CTA owns 128 columns and all M rows; per K tile of 64 it stages a's
// tile and b's [64, 128] bytes (words along N, unpacked with the SWAR masks),
// transposed into [n][k] in shared memory, so each thread takes __dp4a of
// four K-consecutive int8 of a and of b: the products are the kernel's own
// (no tensor-core library). Bound on this card: bytes (the uint8 operand;
// 2*M ops a byte at M = 32, far below the int8 rate's ~600). Integer sums
// are exact in any order.
//
// Kernel Y (casts_launch) replaces the twelve layout and cast probes of
// tools/probe_casts.py:20-76, each on the probe's own f32 shapes: eight
// index maps (reshapes (1,1024)->(8,128), (8,128)->(1,1024), (8,4)->(32,1),
// (1,1024)->(1,4,2,128), (16,512)->(16,1,512); the lane slice [:, 128:256];
// the concat of four 128-lane slices; the sublane stride x[0::2]) through
// one copy kernel whose template functor maps an output index to its source
// (the reshapes and the concat are the identity on flat indices, the slice
// and the stride remap); the per-row max of |x| over 32-lane groups (k7);
// rint(x * 3.7f) through int8 (k10, round half to even as jnp.round); the
// even-row selector E[4, 8] @ x[8, 4] as an f32 dot in the kernel (k11);
// and a store into a __shared__ scratch at lane offset 128 read back (k12).
// One CTA each: the probes' arrays are at most 32 KB.

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

// ---------------------------------------------------------------------------
// kernels W and X: byte operations on 32-bit words
// ---------------------------------------------------------------------------
enum ByteOp { ROUNDTRIP = 0, LO_HI = 1, U8_BITOPS = 2, I16_BITOPS = 3 };

template <int OP>
__global__ void bytes_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ o0,
                             uint32_t* __restrict__ o1, int nwords) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < nwords;
       i += gridDim.x * blockDim.x) {
    const uint32_t w = x[i];
    if constexpr (OP == ROUNDTRIP) {
      o0[i] = w;
    } else if constexpr (OP == LO_HI) {
      o0[i] = w & 0x0F0F0F0Fu;
      o1[i] = (w >> 4) & 0x0F0F0F0Fu;
    } else if constexpr (OP == U8_BITOPS) {
      uint32_t r = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint8_t b = (uint8_t)(w >> (8 * j));
        r |= (uint32_t)(uint8_t)((b & (uint8_t)0xF) + (b >> 4)) << (8 * j);
      }
      o0[i] = r;
    } else {
      uint32_t r = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int16_t h = (int16_t)(uint8_t)(w >> (8 * j));
        const int16_t lo = h & (int16_t)0xF, hi = (h >> 4) & (int16_t)0xF;
        r |= (uint32_t)(uint8_t)(lo + hi) << (8 * j);
      }
      o0[i] = r;
    }
  }
}

// ---------------------------------------------------------------------------
// kernels W and X: the int8 dots
// ---------------------------------------------------------------------------
enum DotMode { SWAR_DOT = 0, I8_DOT = 1, UNPACK_DOT = 2 };
constexpr int D_BN = 128, D_KT = 64, D_THREADS = 256, D_MAXM = 32;
constexpr int D_RPT = D_MAXM / (D_THREADS / D_BN);  // rows a thread accumulates

template <int MODE>
__global__ void __launch_bounds__(D_THREADS)
int8_dot_kernel(const int8_t* __restrict__ a, const uint8_t* __restrict__ b,
                int32_t* __restrict__ out, int M, int K, int N) {
  constexpr int NB = MODE == I8_DOT ? 1 : 2;        // b planes: codes, or lo and hi
  constexpr int NA = MODE == UNPACK_DOT ? 2 : 1;    // a tiles: a[:, k], a[:, K + k]
  __shared__ __align__(16) int8_t s_a[NA][D_MAXM][D_KT];
  __shared__ __align__(16) int8_t s_b[NB][D_BN][D_KT + 4];   // [n][k], padded rows
  const int lda = NA * K;
  const int n0 = blockIdx.x * D_BN;
  const int col = threadIdx.x % D_BN, rg = threadIdx.x / D_BN;
  int acc[D_RPT];
#pragma unroll
  for (int r = 0; r < D_RPT; ++r) acc[r] = 0;
  for (int k0 = 0; k0 < K; k0 += D_KT) {
    __syncthreads();
    for (int i = threadIdx.x; i < NA * D_MAXM * D_KT; i += D_THREADS) {
      const int h = i / (D_MAXM * D_KT), r = (i / D_KT) % D_MAXM, k = i % D_KT;
      s_a[h][r][k] = (r < M && k0 + k < K) ? a[(size_t)r * lda + h * K + k0 + k] : (int8_t)0;
    }
    for (int i = threadIdx.x; i < D_KT * (D_BN / 4); i += D_THREADS) {
      const int k = i / (D_BN / 4), nw = (i % (D_BN / 4)) * 4;
      uint32_t w = 0;
      if (k0 + k < K && n0 + nw < N)
        w = *reinterpret_cast<const uint32_t*>(b + (size_t)(k0 + k) * N + n0 + nw);
      const uint32_t p0 = MODE == I8_DOT ? w : (w & 0x0F0F0F0Fu);
      const uint32_t p1 = (w >> 4) & 0x0F0F0F0Fu;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s_b[0][nw + j][k] = (int8_t)(p0 >> (8 * j));
        if constexpr (NB == 2) s_b[NB - 1][nw + j][k] = (int8_t)(p1 >> (8 * j));
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < D_KT; kk += 4) {
      const int b0 = *reinterpret_cast<const int*>(&s_b[0][col][kk]);
      const int b1 = *reinterpret_cast<const int*>(&s_b[NB - 1][col][kk]);
#pragma unroll
      for (int r = 0; r < D_RPT; ++r) {
        const int row = rg * D_RPT + r;
        const int a0 = *reinterpret_cast<const int*>(&s_a[0][row][kk]);
        if constexpr (MODE == I8_DOT) {
          acc[r] = __dp4a(a0, b0, acc[r]);
        } else {
          const int a1 = *reinterpret_cast<const int*>(&s_a[NA - 1][row][kk]);
          acc[r] = __dp4a(a0, b0, acc[r]);
          acc[r] = __dp4a(a1, b1, acc[r]);
        }
      }
    }
  }
  if (n0 + col < N) {
#pragma unroll
    for (int r = 0; r < D_RPT; ++r) {
      const int row = rg * D_RPT + r;
      if (row < M) out[(size_t)row * N + n0 + col] = acc[r];
    }
  }
}

// ---------------------------------------------------------------------------
// kernel Y: probe_casts' layout and cast probes
// ---------------------------------------------------------------------------
// Index maps, output flat index i -> input flat index. A row-major reshape of
// a contiguous buffer is the identity on flat indices, and so is the concat
// of the four consecutive 128-lane slices: FlatCopy<n> serves the five
// reshapes and the concat. Only the slice and the stride remap.
template <int N>
struct FlatCopy {
  static constexpr int n = N;
  __device__ static int src(int i) { return i; }
};
struct LaneSlice {      // (1,1024)[:, 128:256] -> (1,128)
  static constexpr int n = 128;
  __device__ static int src(int c) { return 128 + c; }
};
struct SublaneStride {  // (8,128)[0::2] -> (4,128): out (r, c) = in (2r, c)
  static constexpr int n = 512;
  __device__ static int src(int i) { return 2 * (i / 128) * 128 + i % 128; }
};

template <typename Map>
__global__ void map_copy_kernel(const float* __restrict__ x, float* __restrict__ o) {
  for (int i = threadIdx.x; i < Map::n; i += blockDim.x) o[i] = x[Map::src(i)];
}

// k7: (8,128) -> (8,4), out (r, g) = max over lanes 32g..32g+31 of |x[r, lane]|
// (the reference's masked max takes 0 for the other groups: the same floor)
__global__ void group_max_kernel(const float* __restrict__ x, float* __restrict__ o) {
  const int t = threadIdx.x;
  if (t >= 32) return;
  const int r = t / 4, g = t % 4;
  float m = 0.0f;
  for (int c = 0; c < 32; ++c) m = fmaxf(m, fabsf(x[r * 128 + 32 * g + c]));
  o[t] = m;
}

// k10: (8,128), rint(x * 3.7f) to int8 and back to f32
__global__ void round_int8_kernel(const float* __restrict__ x, float* __restrict__ o) {
  for (int i = threadIdx.x; i < 1024; i += blockDim.x)
    o[i] = (float)(int8_t)__float2int_rn(x[i] * 3.7f);
}

// k11: E[4,8] @ x[8,4], E[i, k] = (k == 2i), the f32 products and sums here
__global__ void row_select_dot_kernel(const float* __restrict__ x, float* __restrict__ o) {
  const int t = threadIdx.x;
  if (t >= 16) return;
  const int i = t / 4, j = t % 4;
  float acc = 0.0f;
  for (int k = 0; k < 8; ++k) acc = fmaf(k == 2 * i ? 1.0f : 0.0f, x[k * 4 + j], acc);
  o[t] = acc;
}

// k12: x (1,1024) -> scratch[:, 128:256] = x[:, 0:128]; o (1,128) = scratch[:, 128:256]
__global__ void scratch_store_kernel(const float* __restrict__ x, float* __restrict__ o) {
  __shared__ float scr[1024];
  for (int c = threadIdx.x; c < 128; c += blockDim.x) scr[128 + c] = x[c];
  __syncthreads();
  for (int c = threadIdx.x; c < 128; c += blockDim.x) o[c] = scr[128 + c];
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

// Kernels W and X, byte ops (ByteOp): x [nwords] 32-bit words of a uint8
// array; o0 (and for LO_HI o1) the same size.
int bytes_launch(int op, const void* x, void* o0, void* o1, int nwords, void* stream) {
  if (op < ROUNDTRIP || op > I16_BITOPS || nwords < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* xi = static_cast<const uint32_t*>(x);
  uint32_t* a = static_cast<uint32_t*>(o0);
  uint32_t* b = static_cast<uint32_t*>(o1);
  const int blocks = min((nwords + 255) / 256, 4096);
  if (op == ROUNDTRIP) bytes_kernel<ROUNDTRIP><<<blocks, 256, 0, st>>>(xi, a, b, nwords);
  else if (op == LO_HI) bytes_kernel<LO_HI><<<blocks, 256, 0, st>>>(xi, a, b, nwords);
  else if (op == U8_BITOPS) bytes_kernel<U8_BITOPS><<<blocks, 256, 0, st>>>(xi, a, b, nwords);
  else bytes_kernel<I16_BITOPS><<<blocks, 256, 0, st>>>(xi, a, b, nwords);
  return (int)cudaGetLastError();
}

// Kernels W and X, int8 dots (DotMode): a int8 [M, K] ([M, 2K] for
// UNPACK_DOT), b [K, N] (uint8, int8 for I8_DOT; N % 4 == 0, 4-byte aligned),
// out int32 [M, N]; 1 <= M <= 32.
int int8_dot_launch(int mode, const void* a, const void* b, void* out, int M, int K, int N,
                    void* stream) {
  if (M < 1 || M > D_MAXM || K < 1 || N < 4 || N % 4) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* ai = static_cast<const int8_t*>(a);
  const uint8_t* bi = static_cast<const uint8_t*>(b);
  int32_t* o = static_cast<int32_t*>(out);
  const dim3 grid((N + D_BN - 1) / D_BN);
  if (mode == SWAR_DOT) int8_dot_kernel<SWAR_DOT><<<grid, D_THREADS, 0, st>>>(ai, bi, o, M, K, N);
  else if (mode == I8_DOT) int8_dot_kernel<I8_DOT><<<grid, D_THREADS, 0, st>>>(ai, bi, o, M, K, N);
  else if (mode == UNPACK_DOT)
    int8_dot_kernel<UNPACK_DOT><<<grid, D_THREADS, 0, st>>>(ai, bi, o, M, K, N);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Kernel Y: probe 1..12 of tools/probe_casts.py on its own shapes (x and o
// f32, contiguous, the probe's sizes), one CTA of 256 threads.
int casts_launch(int probe, const void* x, void* o, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(o);
  switch (probe) {
    case 1: map_copy_kernel<FlatCopy<1024>> <<<1, 256, 0, st>>>(xf, of); break;
    case 2: map_copy_kernel<FlatCopy<1024>> <<<1, 256, 0, st>>>(xf, of); break;
    case 3: map_copy_kernel<FlatCopy<32>> <<<1, 256, 0, st>>>(xf, of); break;
    case 4: map_copy_kernel<LaneSlice><<<1, 256, 0, st>>>(xf, of); break;
    case 5: map_copy_kernel<FlatCopy<512>> <<<1, 256, 0, st>>>(xf, of); break;
    case 6: map_copy_kernel<SublaneStride><<<1, 256, 0, st>>>(xf, of); break;
    case 7: group_max_kernel<<<1, 256, 0, st>>>(xf, of); break;
    case 8: map_copy_kernel<FlatCopy<1024>> <<<1, 256, 0, st>>>(xf, of); break;
    case 9: map_copy_kernel<FlatCopy<8192>> <<<1, 256, 0, st>>>(xf, of); break;
    case 10: round_int8_kernel<<<1, 256, 0, st>>>(xf, of); break;
    case 11: row_select_dot_kernel<<<1, 256, 0, st>>>(xf, of); break;
    case 12: scratch_store_kernel<<<1, 256, 0, st>>>(xf, of); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
