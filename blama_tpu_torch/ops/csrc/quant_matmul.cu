// Quantized-weight matmul kernels for Hopper (sm_90a), CUDA C++.
//
// Every weight layout keeps one output column's weights contiguous along K
// (built by blama_tpu_torch/ops/quant_matmul.py from GGUF bytes; N rows):
//   Q4_K, split   codes uint8 [N, K/2]: each 32-element group g of row n owns
//                 16 consecutive bytes, byte i = code 32g+i (low nibble) and
//                 code 32g+16+i (high nibble); scales / mins [N, K/32] hold
//                 d*sc and dmin*mn of each group, bf16 (W4A8 engine) or f32
//                 (exact engine); a weight decodes to code*scale - min.
//   Q4_K, native  the GGUF tensor's own bytes, [N, K/256] superblocks of 144
//                 bytes: f16 d, f16 dmin, 12 bytes of 6-bit sc/mn (ggml's
//                 get_scale_min_k4 scheme), then 4 chunks of 32 code bytes;
//                 byte i of chunk c = element 64c+i (low) and 64c+32+i (high),
//                 so chunk c holds groups 2c (low nibbles) and 2c+1 (high).
//   int8 codes    codes int8 [N, K], scales f32 [N, K/group], group 32 (Q8_0)
//                 or 16 (Q6_K expanded: code = q - 32, scale = f32(d)*sc); a
//                 weight decodes to code*scale.
//
// Kernel A (w4a8_matmul_launch, CUDA C++) replaces the TPU kernels
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
// Kernel I (w4a8k4_matmul_launch, CUDA C++) replaces
//   blama_tpu/ops/pallas/quant_matmul.py:_a8k4_kernel:
// kernel A's function on the native superblocks, with f32 d*sc and dmin*mn
// decoded in the kernel (__half2float is exact for subnormals too), not
// bf16-rounded. The same quant_acts_kernel, then w4a8k4_gemv_kernel: one warp
// per output column, a lane per 64-element chunk (two groups: 32 code bytes in
// two 16-byte loads plus the block's 16-byte header), eight superblocks per
// warp step, the same staging of the int8 activations. Bound: bytes, 0.5625
// per weight.
//
// The tiled exact dequant GEMM (dequant_mm_kernel, CUDA C++) serves three
// kernels that differ only in how a 32-element K step of 64 weight rows is
// dequantized into shared memory (the loader):
//   B (q4k_dequant_mm_launch) replaces
//     blama_tpu/ops/pallas/quant_matmul.py:_q4k_matmul_kernel:
//     out[m, n] = sum_k x[m, k] * code[n, k] * scale[n, k/32] in f32 (the min
//     term is applied by the caller, as q4k_matmul does outside its kernel),
//     scales bf16 or f32;
//   G (q8_dequant_mm_launch) replaces
//     blama_tpu/ops/pallas/quant_matmul.py:_q8_matmul_kernel:
//     out[m, n] = sum_k x[m, k] * (float(code[n, k]) * scale[n, k/group]);
//   H (q4k_native_mm_launch) replaces
//     blama_tpu/ops/pallas/quant_matmul.py:_q4k_native_kernel:
//     per 32-group the positive dot as in B with scale = f32(d)*sc decoded in
//     the kernel, then minus (sum of the group's x) * (f32(dmin)*mn): the min
//     term is inside, as a 33rd step of the group's K loop.
// Bound on this card: at the prompt chunks (M = 32..512) the f32 products,
// 2*M*K*N operations against the weight bytes, bind (M=128 is ~400 f32 ops
// per Q4_K weight byte); at the decode rows the exact engines send here
// (M = 1..16) the weight bytes bind. Design, two rows or more: a tiled f32
// SIMT GEMM (dequant_mm_kernel: 64x64 output tile per 256-thread block, 4x4
// outputs per thread) that dequantizes one 32-group of 64 weight rows into
// shared memory per K step. One row (a solo decode step): dequant_row_kernel,
// one thread per output column, which streams the column's weights with
// 16-byte loads (a tile with one live row wastes the tile). Both take the
// same products in the same order for every output element, so a row's bits
// do not depend on which of the two ran. f32 FMA keeps the products exact to
// the f32 dot the reference takes; tensor cores (wgmma) are later work.
//
// Kernels J and K replace the MoE expert-bank kernels
//   blama_tpu/ops/pallas/quant_matmul.py:_a8s_bank_kernel (J) and
//   blama_tpu/ops/pallas/quant_matmul.py:_q4k_bank_kernel (K),
// which multiply x by selected experts of a stacked Q4_K bank (codes [Ne, N,
// K/2], scales / mins [Ne, N, K/32]; expert e owns rows e*N..e*N+N-1), the
// experts picked by a list of ids and read in place, with no gathered copy.
// The TPU kernels take the ids by scalar prefetch into their index maps; here
// a grid dimension walks the selected experts and each block offsets its
// weight pointers by eids[j]*N rows. x is one [M, K] shared by every selected
// expert (gate and up) or one [M, K] per selected expert (down: the routed
// decode step feeds each expert its own row). out [n_sel, M, N] f32.
//   J (w4a8_bank_launch): kernel A's quantizer and kernel A's GEMV body, so
//     J(x, bank, eids)[j] equals A(x, bank[eids[j]]) bit for bit; M <= 16.
//   K (q4k_bank_mm_launch): kernel B's loader with the min term inside (the
//     33rd step of each group, as H), under the same tiled GEMM and one-row
//     kernel, so a row's bits do not depend on the row count; f32 scales
//     (exact engine) or bf16 (W4A8 engine above 16 rows).
// Bound: bytes at the routed decode step (two experts' weights, 5 or 6 bits
// each); f32 operations for the masked all-expert chunks (8 experts x M rows).
// An id outside the bank gives NaN outputs, not a stray read.
//
// Kernels L and M serve the fixed-topology tp_blocks mode, in which a solo
// card must give the bits of a prover sharded over tp devices:
//   L (q4k_parts_mm_launch) replaces
//     blama_tpu/ops/pallas/quant_matmul.py:_q4k_parts_kernel and (nb = 1)
//     blama_tpu/ops/pallas/quant_matmul.py:_q4k_pinned_kernel:
//     kernel K's loader (min term inside) under the same tiles and one-row
//     kernel, with a grid dimension over nb K-blocks: out [nb, M, N] f32,
//     block i the sum over k in [i*K/nb, (i+1)*K/nb);
//   M (w4a8_parts_launch) replaces
//     blama_tpu/ops/pallas/quant_matmul.py:_a8s_parts_kernel:
//     kernel A's quantizer once over x, then A's GEMV body per K-block.
// (_a8s_pinned_kernel is kernel A itself: A sums each column alone with the
// min term inside.) Every K offset of a block (the tiles' K steps, the
// one-row kernel's group walk, A's staging chunks and a lane's groups) is
// relative to the block's start, so block i equals the kernel on the
// K-slice alone bit for bit: what a tp device holding that slice computes.
// The caller combines the partials by a fixed halving tree. Bound: bytes at
// the decode rows, f32 (L) operations at the prompt chunks, as for B and A.
//
// Kernels Q and T serve the tools (no engine reaches them):
//   Q (w4a8_slab_launch) replaces
//     blama_tpu/ops/pallas/quant_matmul.py:_a8s_kernel (w4a8_swar_matmul's
//     positive part): kernel A's quantizer, then per output column the group
//     terms dot*(d*sc)*xscale summed per slab of kb superblocks (the slab's
//     low-nibble groups 0-3 of each superblock plus its high-nibble groups
//     4-7), the slabs added in K order; the min term is an f32 product after
//     it, as in the reference;
//   T (w4a8k4_slab_launch) replaces tools/ab_a8k4.py:_x2_kernel: kernel I's
//     group terms (native superblocks, the min term in each term) in the same
//     slab grouping.
// Kernels U and V serve blama_tpu/tools/ubench_q4k.py's variants (no engine
// reaches them); both read ubench's tile-paired codes, uint8 [N, K/2] with
// the 128 bytes of 256-element tile t at 128t, byte j = element 256t+j (low
// nibble) and element 256t+128+j (high): the reference's pack_pairs, a
// column contiguous along K:
//   U (q4k_twodot_launch) replaces blama_tpu/tools/ubench_q4k.py:_v1_kernel:
//     f32 x times f32 code*scale (scales [N, K/32] f32), the low and the
//     high halves of each tile dotted apart and added per K-block of kb
//     tiles, the blocks added in K order; the min term is outside, as in
//     the reference;
//   V (w4a8_plane_launch) replaces ubench_q4k.py:_v2_kernel (int8 codes
//     [N, K]) and :_v3_kernel (tile-paired codes unpacked in the kernel):
//     kernel A's quantizer, then per 32-group the int32 dot of the codes
//     with the activation codes (the TPU's masked plane g of a tile is this
//     dot for group g; no plane is materialised), each term dot * ws *
//     xscale (bf16 ws), summed per slab of kb tiles, the slabs in K order;
//     Q's body with a loader per layout, so both loaders give the same bits.
// kb is a parameter of their numerics. The reference's column tile block_n is
// the columns one CTA owns here (its warps walk them S_WARPS at a time), so
// it sets only how much of the card is busy and moves no bit. Bound: bytes,
// as A and I. Each warp takes one column with A's (Q, V) or I's (T) lanes; a
// slab ends in a fixed xor butterfly over the lanes of each half, then lo +
// hi (V: over all lanes). U's lane takes one 4-byte word of each tile.
//
// Determinism: every sum runs in a fixed order (per-lane or per-thread K
// order, then a fixed xor-butterfly across the warp); no atomics, so a replay
// on the same card gives the same bits, and an output element's sum does not
// depend on M or on its row's index.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
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
__device__ __forceinline__ void w4a8_gemv_body(const int8_t* __restrict__ xq,
                                               const float* __restrict__ xs,
                                               const float* __restrict__ sxm,
                                               const uint8_t* __restrict__ codes,
                                               const __nv_bfloat16* __restrict__ scales,
                                               const __nv_bfloat16* __restrict__ mins,
                                               float* __restrict__ out, int M, int K, int N,
                                               int kbeg, int klen) {
  // K elements kbeg .. kbeg+klen-1 of rows of length K; every offset below
  // (the staging chunks, a lane's groups) is relative to kbeg, so the sum
  // equals this body's on that K-slice alone
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

  for (int k0 = 0; k0 < klen; k0 += A_KC) {
    const int kc = min(A_KC, klen - k0);
    const int gc = kc / GROUP;
    const int kg = kbeg + k0;  // the chunk's first element in the rows of K
    __syncthreads();
    for (int i = threadIdx.x; i < M * (kc / 16); i += blockDim.x) {
      const int r = i / (kc / 16), c = i % (kc / 16);
      reinterpret_cast<int4*>(s_x + r * A_KC)[c] =
          reinterpret_cast<const int4*>(xq + (size_t)r * K + kg)[c];
    }
    for (int i = threadIdx.x; i < M * gc; i += blockDim.x) {
      const int r = i / gc, c = i % gc;
      s_xs[r * (A_KC / GROUP) + c] = xs[(size_t)r * G + kg / GROUP + c];
      s_sxm[r * (A_KC / GROUP) + c] = sxm[(size_t)r * G + kg / GROUP + c];
    }
    __syncthreads();
    if (n < N) {
      for (int gl = lane; gl < gc; gl += 32) {
        const int g = kg / GROUP + gl;
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

// kernel A's GEMV, and kernel M's: K-block i = blockIdx.y (elements i*Kb ..
// i*Kb+Kb-1) → partials out[i] of [nb, M, N]; block i equals the kernel on
// (x[:, block i], w[:, block i]) alone bit for bit, and nb = 1 is kernel A
template <int MT>
__global__ void __launch_bounds__(A_WARPS * 32)
w4a8_gemv_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                 const float* __restrict__ sxm,
                 const uint8_t* __restrict__ codes,
                 const __nv_bfloat16* __restrict__ scales,
                 const __nv_bfloat16* __restrict__ mins,
                 float* __restrict__ out, int M, int K, int N, int Kb) {
  const int i = blockIdx.y;
  w4a8_gemv_body<MT>(xq, xs, sxm, codes, scales, mins, out + (size_t)i * M * N, M, K, N,
                     i * Kb, Kb);
}

// kernel J: kernel A's body for selected expert j = blockIdx.y of a bank
// (expert e = eids[j] owns rows e*N..e*N+N-1 of the stacked arrays); the
// activations are shared by every expert, or expert j's own M rows
__device__ __forceinline__ float quiet_nan() { return __int_as_float(0x7fc00000); }

template <int MT>
__global__ void __launch_bounds__(A_WARPS * 32)
w4a8_bank_gemv_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                      const float* __restrict__ sxm,
                      const uint8_t* __restrict__ codes,
                      const __nv_bfloat16* __restrict__ scales,
                      const __nv_bfloat16* __restrict__ mins,
                      const int* __restrict__ eids, int n_expert, int x_per_expert,
                      float* __restrict__ out, int M, int K, int N) {
  const int j = blockIdx.y, e = eids[j];
  float* o = out + (size_t)j * M * N;
  if (e < 0 || e >= n_expert) {  // an id outside the bank: NaN, loudly
    const int n = blockIdx.x * A_WARPS + (threadIdx.x >> 5);
    if ((threadIdx.x & 31) == 0 && n < N)
      for (int r = 0; r < M; ++r) o[(size_t)r * N + n] = quiet_nan();
    return;
  }
  const size_t xr = x_per_expert ? (size_t)j * M : 0;  // first activation row
  const size_t w0 = (size_t)e * N;                     // first weight row
  w4a8_gemv_body<MT>(xq + xr * K, xs + xr * (K / GROUP), sxm + xr * (K / GROUP),
                     codes + w0 * (K / 2), scales + w0 * (K / GROUP),
                     mins + w0 * (K / GROUP), o, M, K, N, 0, K);
}

template <int MT>
void launch_bank_gemv(const int8_t* xq, const float* xs, const float* sxm,
                      const uint8_t* codes, const __nv_bfloat16* scales,
                      const __nv_bfloat16* mins, const int* eids, int n_sel,
                      int n_expert, int x_per_expert, float* out, int M, int K,
                      int N, cudaStream_t st) {
  const dim3 grid((N + A_WARPS - 1) / A_WARPS, n_sel);
  w4a8_bank_gemv_kernel<MT><<<grid, A_WARPS * 32, 0, st>>>(
      xq, xs, sxm, codes, scales, mins, eids, n_expert, x_per_expert, out, M, K, N);
}

template <int MT>
void launch_gemv(const int8_t* xq, const float* xs, const float* sxm,
                 const uint8_t* codes, const __nv_bfloat16* scales,
                 const __nv_bfloat16* mins, int nb, float* out, int M, int K, int N,
                 cudaStream_t st) {
  const dim3 grid((N + A_WARPS - 1) / A_WARPS, nb);
  w4a8_gemv_kernel<MT><<<grid, A_WARPS * 32, 0, st>>>(xq, xs, sxm, codes, scales,
                                                      mins, out, M, K, N, K / nb);
}

// ---------------------------------------------------------------------------
// kernel I: the W4A8 GEMV on native Q4_K superblocks, one warp per column
// ---------------------------------------------------------------------------
constexpr int QK_K = 256;       // Q4_K superblock
constexpr int Q4K_BLOCK = 144;  // its bytes

// 6-bit scale and min of group j from the 12 scale bytes, as three
// little-endian words (ggml get_scale_min_k4)
__device__ __forceinline__ void scale_min_k4(int j, uint32_t w0, uint32_t w1,
                                             uint32_t w2, int& sc, int& mn) {
  if (j < 4) {
    sc = (w0 >> (8 * j)) & 63;
    mn = (w1 >> (8 * j)) & 63;
  } else {
    const int i = j - 4;
    sc = ((w2 >> (8 * i)) & 0xF) | (((w0 >> (8 * i + 6)) & 3) << 4);
    mn = ((w2 >> (8 * i + 4)) & 0xF) | (((w1 >> (8 * i + 6)) & 3) << 4);
  }
}

__device__ __forceinline__ float half_bits_to_f32(uint32_t bits) {
  return __half2float(__ushort_as_half((unsigned short)(bits & 0xFFFFu)));
}

template <int MT>
__global__ void __launch_bounds__(A_WARPS * 32)
w4a8k4_gemv_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                   const float* __restrict__ sxm,
                   const uint8_t* __restrict__ blocks,
                   float* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) int8_t s_x[MT * A_KC];
  __shared__ float s_xs[MT * (A_KC / GROUP)];
  __shared__ float s_sxm[MT * (A_KC / GROUP)];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * A_WARPS + warp;
  const int G = K / GROUP;
  const int nsb = K / QK_K;
  const uint8_t* wrow = blocks + (size_t)n * nsb * Q4K_BLOCK;
  const int tl = lane >> 2, c = lane & 3;  // superblock of the step, chunk
  float acc[MT];
#pragma unroll
  for (int r = 0; r < MT; ++r) acc[r] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += A_KC) {
    const int kc = min(A_KC, K - k0);
    const int gc = kc / GROUP;
    __syncthreads();
    for (int i = threadIdx.x; i < M * (kc / 16); i += blockDim.x) {
      const int r = i / (kc / 16), cc = i % (kc / 16);
      reinterpret_cast<int4*>(s_x + r * A_KC)[cc] =
          reinterpret_cast<const int4*>(xq + (size_t)r * K + k0)[cc];
    }
    for (int i = threadIdx.x; i < M * gc; i += blockDim.x) {
      const int r = i / gc, cc = i % gc;
      s_xs[r * (A_KC / GROUP) + cc] = xs[(size_t)r * G + k0 / GROUP + cc];
      s_sxm[r * (A_KC / GROUP) + cc] = sxm[(size_t)r * G + k0 / GROUP + cc];
    }
    __syncthreads();
    const int t = k0 / QK_K + tl;
    if (n < N && t < nsb) {
      const uint4* blk = reinterpret_cast<const uint4*>(wrow + (size_t)t * Q4K_BLOCK);
      const uint4 hdr = __ldg(blk);
      const uint4 a = __ldg(blk + 1 + 2 * c);  // chunk bytes 0..15
      const uint4 b = __ldg(blk + 2 + 2 * c);  // chunk bytes 16..31
      const float d = half_bits_to_f32(hdr.x), dmin = half_bits_to_f32(hdr.x >> 16);
      int sc1, mn1, sc2, mn2;
      scale_min_k4(2 * c, hdr.y, hdr.z, hdr.w, sc1, mn1);
      scale_min_k4(2 * c + 1, hdr.y, hdr.z, hdr.w, sc2, mn2);
      const float ws1 = d * (float)sc1, wm1 = dmin * (float)mn1;
      const float ws2 = d * (float)sc2, wm2 = dmin * (float)mn2;
      // group 2c: the low nibbles of the 32 bytes; group 2c+1: the high ones
      const int l0 = a.x & 0x0F0F0F0F, h0 = (a.x >> 4) & 0x0F0F0F0F;
      const int l1 = a.y & 0x0F0F0F0F, h1 = (a.y >> 4) & 0x0F0F0F0F;
      const int l2 = a.z & 0x0F0F0F0F, h2 = (a.z >> 4) & 0x0F0F0F0F;
      const int l3 = a.w & 0x0F0F0F0F, h3 = (a.w >> 4) & 0x0F0F0F0F;
      const int l4 = b.x & 0x0F0F0F0F, h4 = (b.x >> 4) & 0x0F0F0F0F;
      const int l5 = b.y & 0x0F0F0F0F, h5 = (b.y >> 4) & 0x0F0F0F0F;
      const int l6 = b.z & 0x0F0F0F0F, h6 = (b.z >> 4) & 0x0F0F0F0F;
      const int l7 = b.w & 0x0F0F0F0F, h7 = (b.w >> 4) & 0x0F0F0F0F;
#pragma unroll
      for (int r = 0; r < MT; ++r) {
        if (r < M) {
          const int4* xp =
              reinterpret_cast<const int4*>(s_x + r * A_KC + tl * QK_K + c * 64);
          const int4 x0 = xp[0], x1 = xp[1];  // group 2c
          const int4 x2 = xp[2], x3 = xp[3];  // group 2c+1
          int dot1 = __dp4a(l0, x0.x, 0);
          dot1 = __dp4a(l1, x0.y, dot1);
          dot1 = __dp4a(l2, x0.z, dot1);
          dot1 = __dp4a(l3, x0.w, dot1);
          dot1 = __dp4a(l4, x1.x, dot1);
          dot1 = __dp4a(l5, x1.y, dot1);
          dot1 = __dp4a(l6, x1.z, dot1);
          dot1 = __dp4a(l7, x1.w, dot1);
          int dot2 = __dp4a(h0, x2.x, 0);
          dot2 = __dp4a(h1, x2.y, dot2);
          dot2 = __dp4a(h2, x2.z, dot2);
          dot2 = __dp4a(h3, x2.w, dot2);
          dot2 = __dp4a(h4, x3.x, dot2);
          dot2 = __dp4a(h5, x3.y, dot2);
          dot2 = __dp4a(h6, x3.z, dot2);
          dot2 = __dp4a(h7, x3.w, dot2);
          const int si = r * (A_KC / GROUP) + tl * 8 + 2 * c;
          acc[r] += (float)dot1 * ws1 * s_xs[si] - s_sxm[si] * wm1;
          acc[r] += (float)dot2 * ws2 * s_xs[si + 1] - s_sxm[si + 1] * wm2;
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
void launch_gemv_k4(const int8_t* xq, const float* xs, const float* sxm,
                    const uint8_t* blocks, float* out, int M, int K, int N,
                    cudaStream_t st) {
  const int nblocks = (N + A_WARPS - 1) / A_WARPS;
  w4a8k4_gemv_kernel<MT><<<nblocks, A_WARPS * 32, 0, st>>>(xq, xs, sxm, blocks, out,
                                                           M, K, N);
}

template <typename T>
void launch_quant_acts(const void* x, int M, int K, void* xq, void* xs, void* sxm,
                       cudaStream_t st) {
  const int warps = M * (K / GROUP);
  const int qblocks = (warps * 32 + 255) / 256;
  quant_acts_kernel<T><<<qblocks, 256, 0, st>>>(
      static_cast<const T*>(x), M, K, static_cast<int8_t*>(xq),
      static_cast<float*>(xs), static_cast<float*>(sxm));
}

// ---------------------------------------------------------------------------
// kernels B, G, H: exact dequant GEMM, f32 SIMT tiles, one loader each
// ---------------------------------------------------------------------------
constexpr int B_BM = 64, B_BN = 64, B_BK = GROUP;

// A loader dequantizes K step g (32 elements) of weight rows n0..n0+63 into
// s_w[k][column]; rows past N give zeros. With MIN_ROW it also writes
// s_w[32][column] = -(the group's min), which the tile loop multiplies with
// the sum of the group's x.

// kernel B: split Q4_K codes with scales of type S; no min term
template <typename S>
struct Q4KLoader {
  static constexpr bool MIN_ROW = false;
  const uint8_t* codes;
  const S* scales;
  __device__ __forceinline__ void load(float (*s_w)[B_BN + 4], int g, int n0,
                                       int K, int N) const {
    const int G = K / GROUP;
    for (int i = threadIdx.x; i < B_BN * 16; i += blockDim.x) {
      const int c = i / 16, b = i % 16;
      const int n = n0 + c;
      float s = 0.0f;
      int byte = 0;
      if (n < N) {
        byte = codes[(size_t)n * (K / 2) + (size_t)g * 16 + b];
        s = to_f32(scales[(size_t)n * G + g]);
      }
      s_w[b][c] = (float)(byte & 15) * s;
      s_w[b + 16][c] = (float)(byte >> 4) * s;
    }
  }
  __device__ __forceinline__ void row(float* wv, float& negmin, int n, int g,
                                      int K) const {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(codes + (size_t)n * (K / 2)) + g);
    const float s = to_f32(scales[(size_t)n * (K / GROUP) + g]);
    const uint32_t wd[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      const uint32_t byte = (wd[b / 4] >> (8 * (b % 4))) & 0xFFu;
      wv[b] = (float)(byte & 15u) * s;
      wv[b + 16] = (float)(byte >> 4) * s;
    }
  }
};

// kernel K: kernel B's loader with the min term inside, as H folds it (a
// 33rd step per group); expert(e) points it at expert e of a stacked bank
template <typename S>
struct Q4KMinLoader : Q4KLoader<S> {
  static constexpr bool MIN_ROW = true;
  const S* mins;
  __device__ __forceinline__ Q4KMinLoader expert(int e, int K, int N) const {
    const size_t w0 = (size_t)e * N;
    return {{this->codes + w0 * (K / 2), this->scales + w0 * (K / GROUP)},
            mins + w0 * (K / GROUP)};
  }
  __device__ __forceinline__ void load(float (*s_w)[B_BN + 4], int g, int n0,
                                       int K, int N) const {
    Q4KLoader<S>::load(s_w, g, n0, K, N);
    for (int c = threadIdx.x; c < B_BN; c += blockDim.x) {
      const int n = n0 + c;
      s_w[B_BK][c] = n < N ? -to_f32(mins[(size_t)n * (K / GROUP) + g]) : 0.0f;
    }
  }
  __device__ __forceinline__ void row(float* wv, float& negmin, int n, int g,
                                      int K) const {
    Q4KLoader<S>::row(wv, negmin, n, g, K);
    negmin = -to_f32(mins[(size_t)n * (K / GROUP) + g]);
  }
};

// kernel G: int8 codes, one f32 scale per SG (32 or 16) elements
template <int SG>
struct Q8Loader {
  static constexpr bool MIN_ROW = false;
  const int8_t* codes;
  const float* scales;
  __device__ __forceinline__ void load(float (*s_w)[B_BN + 4], int g, int n0,
                                       int K, int N) const {
    for (int i = threadIdx.x; i < B_BN * 8; i += blockDim.x) {
      const int c = i / 8, p = i % 8;  // 4 codes at k = 4p..4p+3
      const int n = n0 + c;
      float s = 0.0f;
      char4 q = make_char4(0, 0, 0, 0);
      if (n < N) {
        q = *reinterpret_cast<const char4*>(codes + (size_t)n * K + (size_t)g * GROUP + 4 * p);
        s = scales[(size_t)n * (K / SG) + ((size_t)g * GROUP + 4 * p) / SG];
      }
      s_w[4 * p + 0][c] = (float)q.x * s;
      s_w[4 * p + 1][c] = (float)q.y * s;
      s_w[4 * p + 2][c] = (float)q.z * s;
      s_w[4 * p + 3][c] = (float)q.w * s;
    }
  }
  __device__ __forceinline__ void row(float* wv, float& negmin, int n, int g,
                                      int K) const {
    const uint4* cp =
        reinterpret_cast<const uint4*>(codes + (size_t)n * K + (size_t)g * GROUP);
    const uint4 a = __ldg(cp), b = __ldg(cp + 1);
    const float* sp = scales + (size_t)n * (K / SG) + (size_t)g * (GROUP / SG);
    const float s0 = sp[0], s1 = sp[GROUP / SG - 1];  // the same scale when SG == 32
    const uint32_t wd[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int k = 0; k < GROUP; ++k) {
      const int8_t q = (int8_t)((wd[k / 4] >> (8 * (k % 4))) & 0xFFu);
      wv[k] = (float)q * (k < 16 ? s0 : s1);
    }
  }
};

// kernel H: native Q4_K superblocks; scale and min decoded here
struct K4Loader {
  static constexpr bool MIN_ROW = true;
  const uint8_t* blocks;
  __device__ __forceinline__ void load(float (*s_w)[B_BN + 4], int g, int n0,
                                       int K, int N) const {
    const int nsb = K / QK_K;
    const int t = g / 8, j = g % 8;  // superblock, group within it
    for (int i = threadIdx.x; i < B_BN * 8; i += blockDim.x) {
      const int c = i / 8, p = i % 8;  // 4 code bytes: elements 4p..4p+3
      const int n = n0 + c;
      float s = 0.0f, m = 0.0f;
      uint32_t q = 0;
      if (n < N) {
        const uint32_t* blk = reinterpret_cast<const uint32_t*>(
            blocks + ((size_t)n * nsb + t) * Q4K_BLOCK);
        const uint32_t dd = blk[0];
        int sc, mn;
        scale_min_k4(j, blk[1], blk[2], blk[3], sc, mn);
        s = half_bits_to_f32(dd) * (float)sc;
        m = half_bits_to_f32(dd >> 16) * (float)mn;
        q = blk[4 + 8 * (j / 2) + p] >> (4 * (j & 1));
      }
      s_w[4 * p + 0][c] = (float)(q & 15) * s;
      s_w[4 * p + 1][c] = (float)((q >> 8) & 15) * s;
      s_w[4 * p + 2][c] = (float)((q >> 16) & 15) * s;
      s_w[4 * p + 3][c] = (float)((q >> 24) & 15) * s;
      if (p == 0) s_w[B_BK][c] = -m;
    }
  }
  __device__ __forceinline__ void row(float* wv, float& negmin, int n, int g,
                                      int K) const {
    const int t = g / 8, j = g % 8;
    const uint4* blk = reinterpret_cast<const uint4*>(
        blocks + ((size_t)n * (K / QK_K) + t) * Q4K_BLOCK);
    const uint4 hdr = __ldg(blk);
    const uint4 a = __ldg(blk + 1 + 2 * (j / 2)), b = __ldg(blk + 2 + 2 * (j / 2));
    int sc, mn;
    scale_min_k4(j, hdr.y, hdr.z, hdr.w, sc, mn);
    const float s = half_bits_to_f32(hdr.x) * (float)sc;
    negmin = -(half_bits_to_f32(hdr.x >> 16) * (float)mn);
    const uint32_t wd[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int k = 0; k < GROUP; ++k)
      wv[k] = (float)((wd[k / 4] >> (8 * (k % 4) + 4 * (j & 1))) & 15u) * s;
  }
};

template <typename T, typename Loader>
__device__ __forceinline__ void dequant_mm_body(const T* __restrict__ x, const Loader& w,
                                                float* __restrict__ out, int M, int K,
                                                int N, int g0, int g1) {
  // K steps (32-groups) g0 .. g1-1 of rows of length K, summed from zero:
  // the same products in the same order as on that K-slice alone
  constexpr int ROWS = B_BK + (Loader::MIN_ROW ? 1 : 0);
  __shared__ __align__(16) float s_x[ROWS][B_BM + 4];
  __shared__ __align__(16) float s_w[ROWS][B_BN + 4];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * B_BM, n0 = blockIdx.x * B_BN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int g = g0; g < g1; ++g) {
    // each warp loads one row's 32 elements of the step per iteration
    for (int i = threadIdx.x; i < B_BM * B_BK; i += blockDim.x) {
      const int r = i / B_BK, k = i % B_BK;
      const int m = m0 + r;
      const float v = m < M ? to_f32(x[(size_t)m * K + (size_t)g * GROUP + k]) : 0.0f;
      s_x[k][r] = v;
      if constexpr (Loader::MIN_ROW) {
        float sum = v;  // the group's sum of x, fixed butterfly order
#pragma unroll
        for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (k == 0) s_x[B_BK][r] = sum;
      }
    }
    w.load(s_w, g, n0, K, N);
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < ROWS; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&s_x[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&s_w[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
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

// the tiles of B, G, H and L: K-block i = blockIdx.z (groups i*Gb ..
// i*Gb+Gb-1) → partials out[i] of [nb, M, N]; one block is the whole product
template <typename T, typename Loader>
__global__ void __launch_bounds__(256)
dequant_mm_kernel(const T* __restrict__ x, const Loader w, float* __restrict__ out,
                  int M, int K, int N, int Gb) {
  const int i = blockIdx.z;
  dequant_mm_body<T, Loader>(x, w, out + (size_t)i * M * N, M, K, N, i * Gb, (i + 1) * Gb);
}

// kernel K's tiles: selected expert j = blockIdx.z, e = eids[j]
template <typename T, typename Loader>
__global__ void __launch_bounds__(256)
dequant_bank_mm_kernel(const T* __restrict__ x, const Loader w,
                       const int* __restrict__ eids, int n_expert, int x_per_expert,
                       float* __restrict__ out, int M, int K, int N) {
  const int j = blockIdx.z, e = eids[j];
  float* o = out + (size_t)j * M * N;
  if (e < 0 || e >= n_expert) {  // an id outside the bank: NaN, loudly
    const int m0 = blockIdx.y * B_BM, n0 = blockIdx.x * B_BN;
    for (int i = threadIdx.x; i < B_BM * B_BN; i += blockDim.x) {
      const int m = m0 + i / B_BN, n = n0 + i % B_BN;
      if (m < M && n < N) o[(size_t)m * N + n] = quiet_nan();
    }
    return;
  }
  dequant_mm_body<T, Loader>(x + (x_per_expert ? (size_t)j * M * K : 0),
                             w.expert(e, K, N), o, M, K, N, 0, K / GROUP);
}

// ---------------------------------------------------------------------------
// the same function for one row: one thread per output column
// ---------------------------------------------------------------------------
// A 64-row tile with one live row wastes the tile, and one row is every solo
// decode step of the exact engines. Here a thread owns a column and streams
// its weights group by group (Loader::row). The output keeps the tile
// kernel's sum bit for bit: the same dequantized products, fma over k
// ascending, and for MIN_ROW the group's x summed in the butterfly's order
// before its fma; so a row gives the same bits alone and among other rows.
// (With 2..16 rows an accumulator per row in this kernel measured slower
// than the tiles: its loads are not hidden with one warp per scheduler.)
// one warp per block and four groups' loads in flight measured fastest for
// the Q4_K loader at the 8B shapes on an NVIDIA H100 (blocks of 32, 64, 128
// threads x unroll 1, 2, 4, 8)
constexpr int R_THREADS = 32;
constexpr int R_UNROLL = 4;

__device__ __forceinline__ void load_x32(const float* p, float* xv) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p) + i);
    xv[4 * i] = v.x, xv[4 * i + 1] = v.y, xv[4 * i + 2] = v.z, xv[4 * i + 3] = v.w;
  }
}

__device__ __forceinline__ void load_x32(const __nv_bfloat16* p, float* xv) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i);
    const uint32_t wd[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // a bf16 is the high half of its f32
      xv[8 * i + 2 * j] = __uint_as_float(wd[j] << 16);
      xv[8 * i + 2 * j + 1] = __uint_as_float(wd[j] & 0xFFFF0000u);
    }
  }
}

template <typename T, typename Loader>
__device__ __forceinline__ void dequant_row_body(const T* __restrict__ x, const Loader& w,
                                                 float* __restrict__ out, int K, int N,
                                                 int g0, int g1) {
  const int n = blockIdx.x * R_THREADS + threadIdx.x;
  if (n >= N) return;
  float acc = 0.0f;
#pragma unroll R_UNROLL
  for (int g = g0; g < g1; ++g) {
    float wv[GROUP], xv[GROUP];
    float negmin = 0.0f;
    w.row(wv, negmin, n, g, K);
    load_x32(x + (size_t)g * GROUP, xv);
#pragma unroll
    for (int k = 0; k < GROUP; ++k) acc = fmaf(xv[k], wv[k], acc);
    if constexpr (Loader::MIN_ROW) {
      // lane 0's value of the tile kernel's xor butterfly (16, 8, .., 1),
      // each level a loop of fixed trip count so that it unrolls and the
      // sums stay in registers (a loop over the level put xv in local memory)
      float t[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) t[i] = xv[i] + xv[i + 16];
#pragma unroll
      for (int i = 0; i < 8; ++i) t[i] = t[i] + t[i + 8];
#pragma unroll
      for (int i = 0; i < 4; ++i) t[i] = t[i] + t[i + 4];
      t[0] = t[0] + t[2];
      t[1] = t[1] + t[3];
      acc = fmaf(t[0] + t[1], negmin, acc);
    }
  }
  out[n] = acc;
}

// the one row of B, G, H and L at one block (the whole of K)
template <typename T, typename Loader>
__global__ void __launch_bounds__(R_THREADS)
dequant_row_kernel(const T* __restrict__ x, const Loader w, float* __restrict__ out,
                   int K, int N) {
  dequant_row_body<T, Loader>(x, w, out, K, N, 0, K / GROUP);
}

// L's one row over nb > 1 K-blocks: block i = blockIdx.y. (A kernel of its
// own because the block's bounds as arguments made the one-block case ~1.4x
// slower on the 8B lm head's one row, f32 x, on an NVIDIA H100; the bodies
// are the same, so block i equals dequant_row_kernel on its K-slice alone.)
template <typename T, typename Loader>
__global__ void __launch_bounds__(R_THREADS)
dequant_parts_row_kernel(const T* __restrict__ x, const Loader w, float* __restrict__ out,
                         int K, int N, int Gb) {
  const int i = blockIdx.y;
  dequant_row_body<T, Loader>(x, w, out + (size_t)i * N, K, N, i * Gb, (i + 1) * Gb);
}

// kernel K's one row: selected expert j = blockIdx.y, e = eids[j]
template <typename T, typename Loader>
__global__ void __launch_bounds__(R_THREADS)
dequant_bank_row_kernel(const T* __restrict__ x, const Loader w,
                        const int* __restrict__ eids, int n_expert, int x_per_expert,
                        float* __restrict__ out, int K, int N) {
  const int j = blockIdx.y, e = eids[j];
  float* o = out + (size_t)j * N;
  if (e < 0 || e >= n_expert) {  // an id outside the bank: NaN, loudly
    const int n = blockIdx.x * R_THREADS + threadIdx.x;
    if (n < N) o[n] = quiet_nan();
    return;
  }
  dequant_row_body<T, Loader>(x + (x_per_expert ? (size_t)j * K : 0), w.expert(e, K, N),
                              o, K, N, 0, K / GROUP);
}

template <typename T, typename Loader>
void launch_dequant_t(const void* x, const Loader& w, int nb, void* out, int M, int K,
                      int N, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  float* o = static_cast<float*>(out);
  const int Gb = K / GROUP / nb;
  if (M == 1 && nb == 1) {
    const int blocks = (N + R_THREADS - 1) / R_THREADS;
    dequant_row_kernel<T, Loader><<<blocks, R_THREADS, 0, st>>>(xp, w, o, K, N);
  } else if (M == 1) {
    const dim3 grid((N + R_THREADS - 1) / R_THREADS, nb);
    dequant_parts_row_kernel<T, Loader><<<grid, R_THREADS, 0, st>>>(xp, w, o, K, N, Gb);
  } else {
    const dim3 grid((N + B_BN - 1) / B_BN, (M + B_BM - 1) / B_BM, nb);
    dequant_mm_kernel<T, Loader><<<grid, 256, 0, st>>>(xp, w, o, M, K, N, Gb);
  }
}

// one row goes to the column-per-thread kernel, more to the tiles; nb
// K-blocks of K/nb elements (nb = 1: the whole product [M, N])
template <typename Loader>
int launch_dequant_mm(const void* x, int x_bf16, const Loader& w, int nb, void* out,
                      int M, int K, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) launch_dequant_t<__nv_bfloat16>(x, w, nb, out, M, K, N, st);
  else launch_dequant_t<float>(x, w, nb, out, M, K, N, st);
  return (int)cudaGetLastError();
}

template <typename T, typename Loader>
void launch_bank_t(const void* x, const Loader& w, const int* eids, int n_sel,
                   int n_expert, int x_per_expert, void* out, int M, int K, int N,
                   cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  float* o = static_cast<float*>(out);
  if (M == 1) {
    const dim3 grid((N + R_THREADS - 1) / R_THREADS, n_sel);
    dequant_bank_row_kernel<T, Loader><<<grid, R_THREADS, 0, st>>>(
        xp, w, eids, n_expert, x_per_expert, o, K, N);
  } else {
    const dim3 grid((N + B_BN - 1) / B_BN, (M + B_BM - 1) / B_BM, n_sel);
    dequant_bank_mm_kernel<T, Loader><<<grid, 256, 0, st>>>(
        xp, w, eids, n_expert, x_per_expert, o, M, K, N);
  }
}

template <typename Loader>
int launch_bank_mm(const void* x, int x_bf16, const Loader& w, const void* eids,
                   int n_sel, int n_expert, int x_per_expert, void* out, int M, int K,
                   int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ei = static_cast<const int*>(eids);
  if (x_bf16) launch_bank_t<__nv_bfloat16>(x, w, ei, n_sel, n_expert, x_per_expert, out, M, K, N, st);
  else launch_bank_t<float>(x, w, ei, n_sel, n_expert, x_per_expert, out, M, K, N, st);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// kernels Q and T: the W4A8 GEMV summed per K-slab of kb superblocks
// ---------------------------------------------------------------------------
constexpr int S_WARPS = 8;  // warps of a CTA (fewer when it owns fewer columns)

// One slab's sum across a warp. Each lane holds a partial sum of low-nibble
// group terms (lane bit HB clear) or high-nibble ones (bit set); a fixed xor
// butterfly over the other four lane bits sums each half, then every lane
// takes lo + hi. The order is fixed, so a column's bits do not depend on the
// CTA it ran in. HB = 0: one xor butterfly over all 32 lanes (kernel V).
template <int HB>
__device__ __forceinline__ float slab_sum(float v) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1)
    if (o != HB) v += __shfl_xor_sync(0xffffffffu, v, o);
  if constexpr (HB == 0) return v;
  const float other = __shfl_xor_sync(0xffffffffu, v, HB);
  return (threadIdx.x & HB) ? other + v : v + other;  // lo + hi on every lane
}

// Code loaders of the slab GEMV: load(n, K, g, q) gives the 32 4-bit codes
// of group g of weight row n as 8 words of int8 codes in element order.
// Q's layout (QuantTensorA8S): the group's 16 bytes, byte i = element i (low
// nibble) and element 16+i (high).
struct GroupPairedCodes {
  const uint8_t* codes;
  __device__ __forceinline__ void load(int n, int K, int g, int (&q)[8]) const {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(codes + (size_t)n * (K / 2)) + g);
    q[0] = w.x & 0x0F0F0F0F, q[1] = w.y & 0x0F0F0F0F;
    q[2] = w.z & 0x0F0F0F0F, q[3] = w.w & 0x0F0F0F0F;
    q[4] = (w.x >> 4) & 0x0F0F0F0F, q[5] = (w.y >> 4) & 0x0F0F0F0F;
    q[6] = (w.z >> 4) & 0x0F0F0F0F, q[7] = (w.w >> 4) & 0x0F0F0F0F;
  }
};

// V's int8 loader (v2): int8 codes [N, K], the group's 32 bytes as they are.
struct Int8Codes {
  const int8_t* codes;
  __device__ __forceinline__ void load(int n, int K, int g, int (&q)[8]) const {
    const uint4* p = reinterpret_cast<const uint4*>(codes + (size_t)n * K + (size_t)g * GROUP);
    const uint4 a = __ldg(p), b = __ldg(p + 1);
    q[0] = a.x, q[1] = a.y, q[2] = a.z, q[3] = a.w;
    q[4] = b.x, q[5] = b.y, q[6] = b.z, q[7] = b.w;
  }
};

// V's packed loader (v3): tile-paired uint8 [N, K/2] (tile t's 128 bytes at
// 128t; byte j = element 256t+j low, 256t+128+j high), so group c < 4 of a
// tile is the low nibbles of its bytes 32c..32c+31 and group c+4 their high
// nibbles, unpacked with the SWAR masks on 32-bit words (unsigned shifts).
struct TilePairedCodes {
  const uint8_t* codes;
  __device__ __forceinline__ void load(int n, int K, int g, int (&q)[8]) const {
    const int t = g >> 3, c = g & 7, sh = c & 4;   // sh: 4 for the high groups
    const uint4* p = reinterpret_cast<const uint4*>(codes + (size_t)n * (K / 2) +
                                                    (size_t)t * (QK_K / 2) + (c & 3) * GROUP);
    const uint4 a = __ldg(p), b = __ldg(p + 1);
    q[0] = (a.x >> sh) & 0x0F0F0F0F, q[1] = (a.y >> sh) & 0x0F0F0F0F;
    q[2] = (a.z >> sh) & 0x0F0F0F0F, q[3] = (a.w >> sh) & 0x0F0F0F0F;
    q[4] = (b.x >> sh) & 0x0F0F0F0F, q[5] = (b.y >> sh) & 0x0F0F0F0F;
    q[6] = (b.z >> sh) & 0x0F0F0F0F, q[7] = (b.w >> sh) & 0x0F0F0F0F;
  }
};

// Kernels Q and V: per output column (one warp), per slab of sg = 8*kb
// groups, lane l takes groups l, l+32, .. of the slab, each term (float)dot *
// ws * xscale with dot the int32 group dot of the loader's codes with the
// activation codes (8 dp4a); a slab ends in slab_sum<HB> (Q: HB = 4, lane
// bit 2 says lo or hi, as group l % 8 of its superblock; V: HB = 0), the
// slabs are added in K order. A CTA owns bn columns (launch geometry only)
// and walks them S_WARPS at a time, staging x per K chunk of whole slabs.
template <int MT, typename L, int HB>
__global__ void __launch_bounds__(S_WARPS * 32)
w4a8_slab_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs, const L w,
                 const __nv_bfloat16* __restrict__ scales,
                 float* __restrict__ out, int M, int K, int N, int bn, int kb) {
  __shared__ __align__(16) int8_t s_x[MT * A_KC];
  __shared__ float s_xs[MT * (A_KC / GROUP)];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const int G = K / GROUP;
  const int sg = kb * 8;                          // groups per slab
  const int kc_max = (A_KC / (sg * GROUP)) * sg * GROUP;  // whole slabs per chunk
  for (int cg = 0; cg < bn; cg += nw) {
    const bool live = cg + warp < bn;             // uniform per warp
    const int n = blockIdx.x * bn + cg + warp;
    const __nv_bfloat16* srow = scales + (size_t)n * G;
    float run[MT];
#pragma unroll
    for (int r = 0; r < MT; ++r) run[r] = 0.0f;
    for (int k0 = 0; k0 < K; k0 += kc_max) {
      const int kc = min(kc_max, K - k0);
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
      }
      __syncthreads();
      if (!live) continue;
      for (int s0 = 0; s0 < gc; s0 += sg) {       // slabs of the chunk, in K order
        float part[MT];
#pragma unroll
        for (int r = 0; r < MT; ++r) part[r] = 0.0f;
        for (int gl = s0 + lane; gl < s0 + sg; gl += 32) {
          const int g = k0 / GROUP + gl;
          int q[8];
          w.load(n, K, g, q);
          const float ws = __bfloat162float(srow[g]);
#pragma unroll
          for (int r = 0; r < MT; ++r) {
            if (r < M) {
              const int4* xp = reinterpret_cast<const int4*>(s_x + r * A_KC + gl * GROUP);
              const int4 xa = xp[0], xb = xp[1];
              int dot = __dp4a(q[0], xa.x, 0);
              dot = __dp4a(q[1], xa.y, dot);
              dot = __dp4a(q[2], xa.z, dot);
              dot = __dp4a(q[3], xa.w, dot);
              dot = __dp4a(q[4], xb.x, dot);
              dot = __dp4a(q[5], xb.y, dot);
              dot = __dp4a(q[6], xb.z, dot);
              dot = __dp4a(q[7], xb.w, dot);
              part[r] += (float)dot * ws * s_xs[r * (A_KC / GROUP) + gl];
            }
          }
        }
        const bool first = k0 == 0 && s0 == 0;
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          const float acc = slab_sum<HB>(part[r]);
          run[r] = first ? acc : run[r] + acc;
        }
      }
    }
    if (live && lane == 0) {
#pragma unroll
      for (int r = 0; r < MT; ++r)
        if (r < M) out[(size_t)r * N + n] = run[r];
    }
  }
}

// Kernel T: kernel I's lanes (lane = superblock tl of an 8-superblock step,
// 64-element chunk c: groups 2c, 2c+1; lane bit 1 says lo or hi), each term
// (float)dot * (d*sc) * xscale - (xscale*xsum) * (dmin*mn), summed per slab of
// cps steps (kb = 8*cps superblocks, or the whole K as one slab).
template <int MT>
__global__ void __launch_bounds__(S_WARPS * 32)
w4a8k4_slab_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                   const float* __restrict__ sxm, const uint8_t* __restrict__ blocks,
                   float* __restrict__ out, int M, int K, int N, int bn, int cps) {
  __shared__ __align__(16) int8_t s_x[MT * A_KC];
  __shared__ float s_xs[MT * (A_KC / GROUP)];
  __shared__ float s_sxm[MT * (A_KC / GROUP)];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const int G = K / GROUP;
  const int nsb = K / QK_K;
  const int nsteps = (K + A_KC - 1) / A_KC;
  const int tl = lane >> 2, c = lane & 3;
  for (int cg = 0; cg < bn; cg += nw) {
    const bool live = cg + warp < bn;
    const int n = blockIdx.x * bn + cg + warp;
    const uint8_t* wrow = blocks + (size_t)n * nsb * Q4K_BLOCK;
    float run[MT], part[MT];
#pragma unroll
    for (int r = 0; r < MT; ++r) run[r] = part[r] = 0.0f;
    for (int step = 0; step < nsteps; ++step) {
      const int k0 = step * A_KC;
      const int kc = min(A_KC, K - k0);
      const int gc = kc / GROUP;
      __syncthreads();
      for (int i = threadIdx.x; i < M * (kc / 16); i += blockDim.x) {
        const int r = i / (kc / 16), cc = i % (kc / 16);
        reinterpret_cast<int4*>(s_x + r * A_KC)[cc] =
            reinterpret_cast<const int4*>(xq + (size_t)r * K + k0)[cc];
      }
      for (int i = threadIdx.x; i < M * gc; i += blockDim.x) {
        const int r = i / gc, cc = i % gc;
        s_xs[r * (A_KC / GROUP) + cc] = xs[(size_t)r * G + k0 / GROUP + cc];
        s_sxm[r * (A_KC / GROUP) + cc] = sxm[(size_t)r * G + k0 / GROUP + cc];
      }
      __syncthreads();
      if (!live) continue;
      const int t = k0 / QK_K + tl;
      if (t < nsb) {
        const uint4* blk = reinterpret_cast<const uint4*>(wrow + (size_t)t * Q4K_BLOCK);
        const uint4 hdr = __ldg(blk);
        const uint4 a = __ldg(blk + 1 + 2 * c);
        const uint4 b = __ldg(blk + 2 + 2 * c);
        const float d = half_bits_to_f32(hdr.x), dmin = half_bits_to_f32(hdr.x >> 16);
        int sc1, mn1, sc2, mn2;
        scale_min_k4(2 * c, hdr.y, hdr.z, hdr.w, sc1, mn1);
        scale_min_k4(2 * c + 1, hdr.y, hdr.z, hdr.w, sc2, mn2);
        const float ws1 = d * (float)sc1, wm1 = dmin * (float)mn1;
        const float ws2 = d * (float)sc2, wm2 = dmin * (float)mn2;
        const int l0 = a.x & 0x0F0F0F0F, h0 = (a.x >> 4) & 0x0F0F0F0F;
        const int l1 = a.y & 0x0F0F0F0F, h1 = (a.y >> 4) & 0x0F0F0F0F;
        const int l2 = a.z & 0x0F0F0F0F, h2 = (a.z >> 4) & 0x0F0F0F0F;
        const int l3 = a.w & 0x0F0F0F0F, h3 = (a.w >> 4) & 0x0F0F0F0F;
        const int l4 = b.x & 0x0F0F0F0F, h4 = (b.x >> 4) & 0x0F0F0F0F;
        const int l5 = b.y & 0x0F0F0F0F, h5 = (b.y >> 4) & 0x0F0F0F0F;
        const int l6 = b.z & 0x0F0F0F0F, h6 = (b.z >> 4) & 0x0F0F0F0F;
        const int l7 = b.w & 0x0F0F0F0F, h7 = (b.w >> 4) & 0x0F0F0F0F;
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          if (r < M) {
            const int4* xp =
                reinterpret_cast<const int4*>(s_x + r * A_KC + tl * QK_K + c * 64);
            const int4 x0 = xp[0], x1 = xp[1], x2 = xp[2], x3 = xp[3];
            int dot1 = __dp4a(l0, x0.x, 0);
            dot1 = __dp4a(l1, x0.y, dot1);
            dot1 = __dp4a(l2, x0.z, dot1);
            dot1 = __dp4a(l3, x0.w, dot1);
            dot1 = __dp4a(l4, x1.x, dot1);
            dot1 = __dp4a(l5, x1.y, dot1);
            dot1 = __dp4a(l6, x1.z, dot1);
            dot1 = __dp4a(l7, x1.w, dot1);
            int dot2 = __dp4a(h0, x2.x, 0);
            dot2 = __dp4a(h1, x2.y, dot2);
            dot2 = __dp4a(h2, x2.z, dot2);
            dot2 = __dp4a(h3, x2.w, dot2);
            dot2 = __dp4a(h4, x3.x, dot2);
            dot2 = __dp4a(h5, x3.y, dot2);
            dot2 = __dp4a(h6, x3.z, dot2);
            dot2 = __dp4a(h7, x3.w, dot2);
            const int si = r * (A_KC / GROUP) + tl * 8 + 2 * c;
            part[r] += (float)dot1 * ws1 * s_xs[si] - s_sxm[si] * wm1;
            part[r] += (float)dot2 * ws2 * s_xs[si + 1] - s_sxm[si + 1] * wm2;
          }
        }
      }
      if ((step + 1) % cps == 0 || step + 1 == nsteps) {  // a slab ends here
        const bool first = step + 1 <= cps;
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          const float acc = slab_sum<2>(part[r]);
          run[r] = first ? acc : run[r] + acc;
          part[r] = 0.0f;
        }
      }
    }
    if (live && lane == 0) {
#pragma unroll
      for (int r = 0; r < MT; ++r)
        if (r < M) out[(size_t)r * N + n] = run[r];
    }
  }
}

// the codes of the slab GEMVs: Q's (0), V's int8 (1) and tile-paired (2)
// layouts, and T's native superblocks (3)
enum SlabCodes { SLAB_Q = 0, SLAB_V_INT8 = 1, SLAB_V_PAIRED = 2, SLAB_T = 3 };

template <int MT>
void launch_slab(const int8_t* xq, const float* xs, const float* sxm, const uint8_t* codes,
                 const __nv_bfloat16* scales, int kind, float* out, int M, int K, int N,
                 int bn, int kb_or_cps, cudaStream_t st) {
  const int threads = min(S_WARPS, bn) * 32;
  const dim3 grid(N / bn);
  if (kind == SLAB_T)
    w4a8k4_slab_kernel<MT><<<grid, threads, 0, st>>>(xq, xs, sxm, codes, out, M, K, N,
                                                     bn, kb_or_cps);
  else if (kind == SLAB_Q)
    w4a8_slab_kernel<MT, GroupPairedCodes, 4><<<grid, threads, 0, st>>>(
        xq, xs, GroupPairedCodes{codes}, scales, out, M, K, N, bn, kb_or_cps);
  else if (kind == SLAB_V_INT8)
    w4a8_slab_kernel<MT, Int8Codes, 0><<<grid, threads, 0, st>>>(
        xq, xs, Int8Codes{reinterpret_cast<const int8_t*>(codes)}, scales, out, M, K, N, bn,
        kb_or_cps);
  else
    w4a8_slab_kernel<MT, TilePairedCodes, 0><<<grid, threads, 0, st>>>(
        xq, xs, TilePairedCodes{codes}, scales, out, M, K, N, bn, kb_or_cps);
}

// the activation prologue, then kernel Q, V or T (SlabCodes)
int launch_slab_w4a8(const void* x, int x_bf16, const void* codes, const void* scales,
                     int kind, int bn, int kb_or_cps, void* xq, void* xs, void* sxm,
                     void* out, int M, int K, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) launch_quant_acts<__nv_bfloat16>(x, M, K, xq, xs, sxm, st);
  else launch_quant_acts<float>(x, M, K, xq, xs, sxm, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int8_t* q = static_cast<const int8_t*>(xq);
  const float* s = static_cast<const float*>(xs);
  const float* sm = static_cast<const float*>(sxm);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  const __nv_bfloat16* sc = static_cast<const __nv_bfloat16*>(scales);
  float* o = static_cast<float*>(out);
  if (M <= 1) launch_slab<1>(q, s, sm, c, sc, kind, o, M, K, N, bn, kb_or_cps, st);
  else if (M <= 2) launch_slab<2>(q, s, sm, c, sc, kind, o, M, K, N, bn, kb_or_cps, st);
  else if (M <= 4) launch_slab<4>(q, s, sm, c, sc, kind, o, M, K, N, bn, kb_or_cps, st);
  else if (M <= 8) launch_slab<8>(q, s, sm, c, sc, kind, o, M, K, N, bn, kb_or_cps, st);
  else launch_slab<16>(q, s, sm, c, sc, kind, o, M, K, N, bn, kb_or_cps, st);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// kernel U: ubench_q4k's v1, the f32 two-dot over tile-paired codes
// ---------------------------------------------------------------------------
constexpr int U_KC = 2048;  // K elements of x staged per chunk (whole K-blocks)

// Per output column (one warp), per K-block of kb tiles: lane l takes byte
// word l of each tile (its bytes 4l..4l+3: elements 256t+4l.. low, groups
// 8t + l/8, and 256t+128+4l.. high, groups 8t+4 + l/8); lo += x * (code *
// scale) over the low elements, hi over the high ones; at the block's end a
// fixed xor butterfly sums each over the warp, and the block's lo + hi is
// added to the column's sum in K order. x is staged per chunk of whole
// blocks in dynamic shared memory ([M, kc] f32); a lane's float4 of x lies
// beside its neighbours', so the reads are conflict-free.
template <int MT>
__global__ void __launch_bounds__(S_WARPS * 32)
q4k_twodot_kernel(const float* __restrict__ x, const uint8_t* __restrict__ codes,
                  const float* __restrict__ scales, float* __restrict__ out, int M, int K,
                  int N, int bn, int kb) {
  extern __shared__ __align__(16) float s_xf[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const int G = K / GROUP;
  const int blk = kb * QK_K;                      // elements of a K-block
  const int kc_max = (U_KC / blk) * blk;          // whole blocks per chunk
  for (int cg = 0; cg < bn; cg += nw) {
    const bool live = cg + warp < bn;             // uniform per warp
    const int n = blockIdx.x * bn + cg + warp;
    const uint32_t* wrow = reinterpret_cast<const uint32_t*>(codes + (size_t)n * (K / 2));
    const float* srow = scales + (size_t)n * G;
    float run[MT];
#pragma unroll
    for (int r = 0; r < MT; ++r) run[r] = 0.0f;
    for (int k0 = 0; k0 < K; k0 += kc_max) {
      const int kc = min(kc_max, K - k0);
      __syncthreads();
      for (int i = threadIdx.x; i < M * (kc / 4); i += blockDim.x) {
        const int r = i / (kc / 4), c = i % (kc / 4);
        reinterpret_cast<float4*>(s_xf + (size_t)r * kc_max)[c] =
            reinterpret_cast<const float4*>(x + (size_t)r * K + k0)[c];
      }
      __syncthreads();
      if (!live) continue;
      for (int b0 = 0; b0 < kc; b0 += blk) {      // blocks of the chunk, in K order
        float lo[MT], hi[MT];
#pragma unroll
        for (int r = 0; r < MT; ++r) lo[r] = hi[r] = 0.0f;
        for (int tl = b0 / QK_K; tl < (b0 + blk) / QK_K; ++tl) {
          const int t = k0 / QK_K + tl;           // the tile's index in the row
          const uint32_t w = __ldg(wrow + t * (QK_K / 8) + lane);
          const float sl = __ldg(srow + t * 8 + (lane >> 3));
          const float sh = __ldg(srow + t * 8 + 4 + (lane >> 3));
          float wl[4], wh[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            wl[i] = (float)((w >> (8 * i)) & 0xFu) * sl;
            wh[i] = (float)((w >> (8 * i + 4)) & 0xFu) * sh;
          }
#pragma unroll
          for (int r = 0; r < MT; ++r) {
            if (r < M) {
              const float* xr = s_xf + (size_t)r * kc_max + tl * QK_K + 4 * lane;
              const float4 xl = *reinterpret_cast<const float4*>(xr);
              const float4 xh = *reinterpret_cast<const float4*>(xr + QK_K / 2);
              lo[r] = fmaf(xl.x, wl[0], lo[r]);
              lo[r] = fmaf(xl.y, wl[1], lo[r]);
              lo[r] = fmaf(xl.z, wl[2], lo[r]);
              lo[r] = fmaf(xl.w, wl[3], lo[r]);
              hi[r] = fmaf(xh.x, wh[0], hi[r]);
              hi[r] = fmaf(xh.y, wh[1], hi[r]);
              hi[r] = fmaf(xh.z, wh[2], hi[r]);
              hi[r] = fmaf(xh.w, wh[3], hi[r]);
            }
          }
        }
        const bool first = k0 == 0 && b0 == 0;
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          const float p = slab_sum<0>(lo[r]) + slab_sum<0>(hi[r]);
          run[r] = first ? p : run[r] + p;
        }
      }
    }
    if (live && lane == 0) {
#pragma unroll
      for (int r = 0; r < MT; ++r)
        if (r < M) out[(size_t)r * N + n] = run[r];
    }
  }
}

template <int MT>
int launch_twodot(const float* x, const uint8_t* codes, const float* scales, float* out,
                  int M, int K, int N, int bn, int kb, cudaStream_t st) {
  const int blk = kb * QK_K;
  const size_t smem = (size_t)M * (U_KC / blk) * blk * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(q4k_twodot_kernel<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  q4k_twodot_kernel<MT><<<N / bn, min(S_WARPS, bn) * 32, smem, st>>>(x, codes, scales, out,
                                                                    M, K, N, bn, kb);
  return (int)cudaGetLastError();
}

// kernel A's two launches, the GEMV over nb K-blocks (nb = 1: kernel A)
int launch_w4a8(const void* x, int x_bf16, const void* codes, const void* scales,
                const void* mins, int nb, void* xq, void* xs, void* sxm, void* out, int M,
                int K, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) launch_quant_acts<__nv_bfloat16>(x, M, K, xq, xs, sxm, st);
  else launch_quant_acts<float>(x, M, K, xq, xs, sxm, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int8_t* q = static_cast<const int8_t*>(xq);
  const float* s = static_cast<const float*>(xs);
  const float* sm = static_cast<const float*>(sxm);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  const __nv_bfloat16* sc = static_cast<const __nv_bfloat16*>(scales);
  const __nv_bfloat16* mn = static_cast<const __nv_bfloat16*>(mins);
  float* o = static_cast<float*>(out);
  if (M <= 1) launch_gemv<1>(q, s, sm, c, sc, mn, nb, o, M, K, N, st);
  else if (M <= 2) launch_gemv<2>(q, s, sm, c, sc, mn, nb, o, M, K, N, st);
  else if (M <= 4) launch_gemv<4>(q, s, sm, c, sc, mn, nb, o, M, K, N, st);
  else if (M <= 8) launch_gemv<8>(q, s, sm, c, sc, mn, nb, o, M, K, N, st);
  else launch_gemv<16>(q, s, sm, c, sc, mn, nb, o, M, K, N, st);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: [M, K] bf16 (x_bf16 != 0) or f32; 1 <= M <= 16, K % 32 == 0.
// xq [M, K] int8, xs / sxm [M, K/32] f32 and out [M, N] f32 are outputs.
int w4a8_matmul_launch(const void* x, int x_bf16, const void* codes,
                       const void* scales, const void* mins, void* xq, void* xs,
                       void* sxm, void* out, int M, int K, int N, void* stream) {
  return launch_w4a8(x, x_bf16, codes, scales, mins, 1, xq, xs, sxm, out, M, K, N, stream);
}

// The same on native Q4_K superblocks: blocks [N, K/256 * 144] bytes,
// 16-byte aligned; K % 256 == 0.
int w4a8k4_matmul_launch(const void* x, int x_bf16, const void* blocks, void* xq,
                         void* xs, void* sxm, void* out, int M, int K, int N,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) launch_quant_acts<__nv_bfloat16>(x, M, K, xq, xs, sxm, st);
  else launch_quant_acts<float>(x, M, K, xq, xs, sxm, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int8_t* q = static_cast<const int8_t*>(xq);
  const float* s = static_cast<const float*>(xs);
  const float* sm = static_cast<const float*>(sxm);
  const uint8_t* b = static_cast<const uint8_t*>(blocks);
  float* o = static_cast<float*>(out);
  if (M <= 1) launch_gemv_k4<1>(q, s, sm, b, o, M, K, N, st);
  else if (M <= 2) launch_gemv_k4<2>(q, s, sm, b, o, M, K, N, st);
  else if (M <= 4) launch_gemv_k4<4>(q, s, sm, b, o, M, K, N, st);
  else if (M <= 8) launch_gemv_k4<8>(q, s, sm, b, o, M, K, N, st);
  else launch_gemv_k4<16>(q, s, sm, b, o, M, K, N, st);
  return (int)cudaGetLastError();
}

// x: [M, K] bf16 (x_bf16 != 0) or f32, K % 32 == 0; out: [M, N] f32.
// scales: [N, K/32] f32 (scales_f32 != 0) or bf16.
int q4k_dequant_mm_launch(const void* x, int x_bf16, const void* codes,
                          const void* scales, int scales_f32, void* out, int M,
                          int K, int N, void* stream) {
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  if (scales_f32)
    return launch_dequant_mm(x, x_bf16, Q4KLoader<float>{c, static_cast<const float*>(scales)},
                             1, out, M, K, N, stream);
  return launch_dequant_mm(
      x, x_bf16, Q4KLoader<__nv_bfloat16>{c, static_cast<const __nv_bfloat16*>(scales)},
      1, out, M, K, N, stream);
}

// codes: [N, K] int8; scales: [N, K/group] f32, group 32 or 16; K % 32 == 0.
int q8_dequant_mm_launch(const void* x, int x_bf16, const void* codes,
                         const void* scales, int group, void* out, int M, int K,
                         int N, void* stream) {
  const int8_t* c = static_cast<const int8_t*>(codes);
  const float* s = static_cast<const float*>(scales);
  if (group == 32)
    return launch_dequant_mm(x, x_bf16, Q8Loader<32>{c, s}, 1, out, M, K, N, stream);
  if (group == 16)
    return launch_dequant_mm(x, x_bf16, Q8Loader<16>{c, s}, 1, out, M, K, N, stream);
  return (int)cudaErrorInvalidValue;
}

// blocks: [N, K/256 * 144] bytes of Q4_K superblocks; K % 256 == 0.
int q4k_native_mm_launch(const void* x, int x_bf16, const void* blocks, void* out,
                         int M, int K, int N, void* stream) {
  return launch_dequant_mm(x, x_bf16, K4Loader{static_cast<const uint8_t*>(blocks)},
                           1, out, M, K, N, stream);
}

// Kernel J: kernel A over selected experts of a bank. codes [Ne, N, K/2],
// scales / mins [Ne, N, K/32] bf16; eids [n_sel] int32 on the card; x is [M, K]
// shared by every selected expert, or [n_sel, M, K] (x_per_expert != 0),
// 1 <= M <= 16. xq / xs / sxm hold the quantized rows of x (M or n_sel*M);
// out [n_sel, M, N] f32.
int w4a8_bank_launch(const void* x, int x_bf16, int x_per_expert, const void* codes,
                     const void* scales, const void* mins, const void* eids, int n_sel,
                     int n_expert, void* xq, void* xs, void* sxm, void* out, int M,
                     int K, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = (x_per_expert ? n_sel : 1) * M;
  if (x_bf16) launch_quant_acts<__nv_bfloat16>(x, rows, K, xq, xs, sxm, st);
  else launch_quant_acts<float>(x, rows, K, xq, xs, sxm, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int8_t* q = static_cast<const int8_t*>(xq);
  const float* s = static_cast<const float*>(xs);
  const float* sm = static_cast<const float*>(sxm);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  const __nv_bfloat16* sc = static_cast<const __nv_bfloat16*>(scales);
  const __nv_bfloat16* mn = static_cast<const __nv_bfloat16*>(mins);
  const int* ei = static_cast<const int*>(eids);
  float* o = static_cast<float*>(out);
  if (M <= 1) launch_bank_gemv<1>(q, s, sm, c, sc, mn, ei, n_sel, n_expert, x_per_expert, o, M, K, N, st);
  else if (M <= 2) launch_bank_gemv<2>(q, s, sm, c, sc, mn, ei, n_sel, n_expert, x_per_expert, o, M, K, N, st);
  else if (M <= 4) launch_bank_gemv<4>(q, s, sm, c, sc, mn, ei, n_sel, n_expert, x_per_expert, o, M, K, N, st);
  else if (M <= 8) launch_bank_gemv<8>(q, s, sm, c, sc, mn, ei, n_sel, n_expert, x_per_expert, o, M, K, N, st);
  else launch_bank_gemv<16>(q, s, sm, c, sc, mn, ei, n_sel, n_expert, x_per_expert, o, M, K, N, st);
  return (int)cudaGetLastError();
}

// Kernel K: the exact dequant GEMM over selected experts of a bank, min term
// inside. codes [Ne, N, K/2], scales / mins [Ne, N, K/32] f32 (scales_f32 !=
// 0) or bf16; eids and x as for kernel J (any M >= 1); out [n_sel, M, N] f32.
int q4k_bank_mm_launch(const void* x, int x_bf16, int x_per_expert, const void* codes,
                       const void* scales, const void* mins, int scales_f32,
                       const void* eids, int n_sel, int n_expert, void* out, int M,
                       int K, int N, void* stream) {
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  if (scales_f32) {
    const Q4KMinLoader<float> w{{c, static_cast<const float*>(scales)},
                                static_cast<const float*>(mins)};
    return launch_bank_mm(x, x_bf16, w, eids, n_sel, n_expert, x_per_expert, out, M, K,
                          N, stream);
  }
  const Q4KMinLoader<__nv_bfloat16> w{{c, static_cast<const __nv_bfloat16*>(scales)},
                                      static_cast<const __nv_bfloat16*>(mins)};
  return launch_bank_mm(x, x_bf16, w, eids, n_sel, n_expert, x_per_expert, out, M, K, N,
                        stream);
}

// Kernel L: the exact dequant GEMM with the min term inside on nb K-blocks
// of K/nb elements each (K % (32*nb) == 0), one launch: out [nb, M, N] f32,
// out[i] the partial of block i, equal bit for bit to the same kernel on
// (x[:, block i], w[:, block i]) alone; nb = 1 is the pinned product.
// codes [N, K/2], scales / mins [N, K/32] f32 (scales_f32 != 0) or bf16.
int q4k_parts_mm_launch(const void* x, int x_bf16, const void* codes, const void* scales,
                        const void* mins, int scales_f32, int nb, void* out, int M, int K,
                        int N, void* stream) {
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  if (nb < 1 || nb > 65535 || K % (GROUP * nb)) return (int)cudaErrorInvalidValue;
  if (scales_f32) {
    const Q4KMinLoader<float> w{{c, static_cast<const float*>(scales)},
                                static_cast<const float*>(mins)};
    return launch_dequant_mm(x, x_bf16, w, nb, out, M, K, N, stream);
  }
  const Q4KMinLoader<__nv_bfloat16> w{{c, static_cast<const __nv_bfloat16*>(scales)},
                                      static_cast<const __nv_bfloat16*>(mins)};
  return launch_dequant_mm(x, x_bf16, w, nb, out, M, K, N, stream);
}

// Kernel M: kernel A on nb K-blocks (K % (256*nb) == 0), one launch after one
// activation quantization of all of x: out [nb, M, N] f32, out[i] equal bit
// for bit to kernel A on (x[:, block i], w[:, block i]) alone; 1 <= M <= 16.
int w4a8_parts_launch(const void* x, int x_bf16, const void* codes, const void* scales,
                      const void* mins, int nb, void* xq, void* xs, void* sxm, void* out,
                      int M, int K, int N, void* stream) {
  if (nb < 1 || nb > 65535 || K % (256 * nb)) return (int)cudaErrorInvalidValue;
  return launch_w4a8(x, x_bf16, codes, scales, mins, nb, xq, xs, sxm, out, M, K, N, stream);
}

// Kernel Q: x [M, K] bf16 or f32 (1 <= M <= 16, K % (256*kb) == 0, 1 <= kb
// <= 8); codes [N, K/2], scales [N, K/32] bf16; each CTA owns bn columns (N %
// bn == 0). out [M, N] f32 is the positive part summed per slab of kb
// superblocks; xq / xs / sxm are the prologue's outputs.
int w4a8_slab_launch(const void* x, int x_bf16, const void* codes, const void* scales,
                     int bn, int kb, void* xq, void* xs, void* sxm, void* out, int M,
                     int K, int N, void* stream) {
  if (M < 1 || M > 16 || bn < 1 || N % bn || kb < 1 || kb > 8 || K % (QK_K * kb))
    return (int)cudaErrorInvalidValue;
  return launch_slab_w4a8(x, x_bf16, codes, scales, SLAB_Q, bn, kb, xq, xs, sxm, out, M, K,
                          N, stream);
}

// Kernel T: kernel I's function on native Q4_K superblocks ([N, K/256 * 144]
// bytes) summed per slab of kb superblocks, kb a multiple of 8 or K/256 (the
// whole K as one slab); each CTA owns bn columns (N % bn == 0).
int w4a8k4_slab_launch(const void* x, int x_bf16, const void* blocks, int bn, int kb,
                       void* xq, void* xs, void* sxm, void* out, int M, int K, int N,
                       void* stream) {
  const int nsb = K / QK_K;
  if (M < 1 || M > 16 || bn < 1 || N % bn || K % QK_K || kb < 1 || nsb % kb ||
      (kb % 8 && kb != nsb))
    return (int)cudaErrorInvalidValue;
  const int cps = kb % 8 ? (nsb + 7) / 8 : kb / 8;  // 8-superblock steps per slab
  return launch_slab_w4a8(x, x_bf16, blocks, nullptr, SLAB_T, bn, cps, xq, xs, sxm, out, M,
                          K, N, stream);
}

// Kernel V: x [M, K] bf16 or f32 (1 <= M <= 16, K % (256*kb) == 0, 1 <= kb
// <= 8); codes int8 [N, K] (packed = 0) or tile-paired uint8 [N, K/2]
// (packed = 1), scales [N, K/32] bf16; each CTA owns bn columns (N % bn ==
// 0). out [M, N] f32 is the positive part summed per slab of kb tiles; xq /
// xs / sxm are the prologue's outputs (kernel A's quantizer).
int w4a8_plane_launch(const void* x, int x_bf16, const void* codes, int packed,
                      const void* scales, int bn, int kb, void* xq, void* xs, void* sxm,
                      void* out, int M, int K, int N, void* stream) {
  if (M < 1 || M > 16 || bn < 1 || N % bn || kb < 1 || kb > 8 || K % (QK_K * kb))
    return (int)cudaErrorInvalidValue;
  return launch_slab_w4a8(x, x_bf16, codes, scales, packed ? SLAB_V_PAIRED : SLAB_V_INT8, bn,
                          kb, xq, xs, sxm, out, M, K, N, stream);
}

// Kernel U: x [M, K] f32 (1 <= M <= 16, 16-byte aligned, K % (256*kb) == 0,
// 1 <= kb <= 8); tile-paired codes uint8 [N, K/2], scales f32 [N, K/32]; each
// CTA owns bn columns (N % bn == 0). out [M, N] f32 is the positive part
// summed per K-block of kb tiles (the min term is the caller's).
int q4k_twodot_launch(const void* x, const void* codes, const void* scales, int bn, int kb,
                      void* out, int M, int K, int N, void* stream) {
  if (M < 1 || M > 16 || bn < 1 || N % bn || kb < 1 || kb > 8 || K % (QK_K * kb))
    return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  const float* s = static_cast<const float*>(scales);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 1) return launch_twodot<1>(xf, c, s, o, M, K, N, bn, kb, st);
  if (M <= 2) return launch_twodot<2>(xf, c, s, o, M, K, N, bn, kb, st);
  if (M <= 4) return launch_twodot<4>(xf, c, s, o, M, K, N, bn, kb, st);
  if (M <= 8) return launch_twodot<8>(xf, c, s, o, M, K, N, bn, kb, st);
  return launch_twodot<16>(xf, c, s, o, M, K, N, bn, kb, st);
}

}  // extern "C"
