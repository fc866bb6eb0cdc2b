// Kernel U, CUDA C++ for Hopper (sm_90a): ubench_q4k's f32 two-dot.
//
// U (q4k_twodot_launch) replaces blama_tpu/tools/ubench_q4k.py:_v1_kernel
// (no engine reaches it; tools/ubench_q4k.py does): f32 x [M, K] times f32
// code*scale over ubench's tile-paired codes (uint8 [N, K/2], the 128 bytes
// of 256-element tile t at 128t, byte j = element 256t+j in the low nibble
// and element 256t+128+j in the high; scales f32 [N, K/32]), the low and the
// high half of each tile dotted apart and added per K-block of kb tiles, the
// blocks added in K order; the min term is the caller's, as in the
// reference. kb is a parameter of its numerics.
//
// Its numerics are its lane chains: lane l of a column takes byte word l of
// each tile, fmaf chains over its 4 low and its 4 high elements, the xor
// butterfly over the warp at each K-block's end, lo + hi of each block into
// the column's sum in K order, the first block assigned
// (testing.twodot_lane_order is that order).
//
// Bound on this card: bytes at one row, f32 FMA issue at 8 rows (8 FMAs an
// element against ~3 instructions of dequant), and shared-memory reads of x
// (one float4 a lane a row, 4 columns' FMAs each). One producer thread keeps
// a ring of D slots full with TMA boxes (tma_ring.cuh): each slot S tiles of
// x's rows and of the CTA's codes and scales, three requests a slot, so x is
// staged once per 8 * C columns, overlapped with compute, and up to D slots
// are in flight. Eight pairs of consumer warps run the chains, a pair C
// columns and every row at once: a float4 of x from shared memory feeds C
// columns, a dequantized code every row, and the low and the high chains
// sit in the two warps of a pair (half the registers a thread, twice the
// warps to hide latency). A wave of CTAs walks the column groups, the ring
// running on from one group into the next, so each CTA waits for its first
// slot once. C = 4 where those CTAs fill a wave, else 1
// (quant_matmul.twodot_plan); the plan moves no bit, and the reference's
// column tile block_n only passes the reference's clamp.
//
// Determinism: every sum in a fixed order, no atomics, so a replay gives the
// same bits, and a row's outputs do not depend on M or on the row's index.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tma_ring.cuh"

namespace {

constexpr int QK_K = 256;             // a tile: 256 elements, 8 scales
constexpr int U_SMEM_MAX = 232448;    // an H100's shared memory for one CTA

// byte i of v as f32, exactly: one byte permute forms the float 2^23 + byte,
// an add takes 2^23 off (I2F runs at a quarter of the FMA rate)
__device__ __forceinline__ float small_f32_byte(uint32_t v, int i) {
  return __uint_as_float(__byte_perm(v, 0x4Bu, 0x4550u + i)) - 8388608.0f;
}

constexpr int U_PAIRS = 8;       // warp pairs (lo, hi) of a CTA, beside one producer warp
constexpr int U_WARPS = 2 * U_PAIRS;
constexpr int U_BAR_BYTES = 128;  // the ring's barriers
constexpr int U_XCH_BYTES = 2 * U_PAIRS * 64 * 4;  // the pairs' block sums, two deep
constexpr int U_RING = U_BAR_BYTES + U_XCH_BYTES;  // where the slots start

// A slot of the ring: S tiles of x's MT rows ([MT][S * 256] f32), then of the
// CTA's U_PAIRS * C columns their codes ([cols][S * 128] bytes) and scales
// ([cols][S * 8] f32), each part on 128 bytes. quant_matmul.twodot_smem
// computes the same sizes.
__host__ __device__ constexpr int u_x_bytes(int MT, int S) { return MT * S * QK_K * 4; }
__host__ __device__ constexpr int u_code_bytes(int C, int S) {
  return U_PAIRS * C * S * (QK_K / 2);
}
__host__ __device__ constexpr int u_slot_bytes(int MT, int C, int S) {
  return u_x_bytes(MT, S) + u_code_bytes(C, S) + U_PAIRS * C * S * 8 * 4;
}

// The end of a K-block: the warp's V chains (v[q] of q = r*C + c) each summed
// over the 32 lanes by the parent's xor butterfly (o = 1, 2, 4, 8, 16: v + v
// of lane ^ o). While a lane holds more than one value, a step halves them:
// the lane keeps one half, takes the partner's sums of that half and adds
// them, which is the butterfly's node for each value kept (a + b == b + a),
// in n/2 shuffles instead of n. After the five steps lane l holds V/32
// chains (q = its bits reversed times V/32, plus 0 .. V/32-1), or, for V <
// 32, after log2(V) steps one chain (q = its low log2(V) bits reversed) and
// the full butterfly goes on for it.
template <int N, int O, int V>
__device__ __forceinline__ void u_fold(float (&v)[V], int lane) {
  if constexpr (O < 32) {
    if constexpr (N > 1) {
      const bool up = lane & O;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float send = up ? v[i] : v[i + N / 2];
        const float keep = up ? v[i + N / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
    }
    u_fold<(N > 1 ? N / 2 : 1), O * 2>(v, lane);
  }
}

// Per output column, per K-block of kb tiles: lane l takes byte word l of
// each tile (its bytes 4l..4l+3: elements 256t+4l.. low, groups 8t + l/8,
// and 256t+128+4l.. high, groups 8t+4 + l/8); lo = fma(x, code * scale, lo)
// over the low elements in order, hi over the high ones; at the block's end
// both are summed over the warp (u_fold, the parent's butterfly) and the
// block's lo + hi goes into the column's sum in K order, the first block
// assigned. A pair of warps runs those chains for C columns and MT rows at
// once, the low chains in one warp and the high ones in the other (half the
// registers a thread, twice the warps an SM to hide latency): each float4 of
// x read from shared memory feeds C columns, each dequantized code MT rows;
// at a block's end the high warp hands its sums to the low warp through
// shared memory (two deep, one named barrier a pair). A slot holds S tiles,
// S a divisor of kb, so K-blocks end at slot ends, a slot's tiles run
// unrolled with no branch, and the last slot is whole (T is a multiple of
// kb). Rows past M are zeros (the box's fill): computed and not written.
// The grid is a wave of CTAs; CTA b takes column groups b, b + gridDim.x, ...
template <int MT, int C, int S>
__global__ void __launch_bounds__((U_WARPS + 1) * 32, MT <= 2 ? 2 : 1)
q4k_twodot_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap cmap,
                  const __grid_constant__ CUtensorMap smap, float* __restrict__ out, int M,
                  int K, int N, int kb, int D) {
  constexpr int COLS = U_PAIRS * C, V = MT * C, VL = V > 32 ? V / 32 : 1;  // VL: a lane's chains
  constexpr int XB = u_x_bytes(MT, S), CB = u_code_bytes(C, S), SLOT = u_slot_bytes(MT, C, S);
  extern __shared__ __align__(128) uint8_t u_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(u_smem);
  uint64_t* empty = full + D;
  float* xch = reinterpret_cast<float*>(u_smem + U_BAR_BYTES);  // [2][U_PAIRS][VL * 32]
  uint8_t* ring = u_smem + U_RING;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nst = K / (QK_K * S);  // slots a column group streams
  const int groups = (N + COLS - 1) / COLS;
  if (threadIdx.x == 0) {
    for (int d = 0; d < D; ++d) {
      tma::bar_init(full + d, 1);
      tma::bar_init(empty + d, U_WARPS);
    }
    tma::fence_init();
  }
  __syncthreads();

  if (warp == U_WARPS) {  // the producer: three boxes a slot, zeros past M and N
    if (lane == 0) {
      int d = 0, u = 0;
      for (int g = blockIdx.x; g < groups; g += gridDim.x) {
        for (int q = 0; q < nst; ++q) {
          if (u) tma::wait(empty + d, (u - 1) & 1);
          uint8_t* sl = ring + d * SLOT;
          tma::arrive_expect(full + d, SLOT);
          tma::copy3d(sl, &xmap, 0, q * S, 0, full + d);
          tma::copy3d(sl + XB, &cmap, 0, q * S, g * COLS, full + d);
          tma::copy3d(sl + XB + CB, &smap, 0, q * S, g * COLS, full + d);
          if (++d == D) d = 0, ++u;
        }
      }
    }
    return;
  }

  const int pair = warp >> 1, hi = warp & 1;  // hi: the high nibbles' chains
  const int cw0 = pair * C * S * 32 + lane, sc0 = pair * C * S * 8 + 4 * hi + (lane >> 3);
  const int x0 = 4 * lane + (QK_K / 2) * hi, shift = 4 * hi;
  constexpr int LQ = V == 1 ? 0 : V == 2 ? 1 : V == 4 ? 2 : V == 8 ? 3 : V == 16 ? 4 : 5;
  int d = 0, u = 0, blk = 0;  // the ring's slot and its use; K-blocks done
  for (int g = blockIdx.x; g < groups; g += gridDim.x) {
    float v[V];
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = 0.0f;
    float run[VL];
    bool first = true;
    int tb = 0;  // tiles of the current K-block done
    for (int q = 0; q < nst; ++q) {
      tma::wait(full + d, u & 1);
      const uint8_t* sl = ring + d * SLOT;
      const float* xs = reinterpret_cast<const float*>(sl) + x0;
      const uint32_t* cw = reinterpret_cast<const uint32_t*>(sl + XB) + cw0;
      const float* sc = reinterpret_cast<const float*>(sl + XB + CB) + sc0;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        float w[C][4];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const uint32_t nib = (cw[(c * S + s) * 32] >> shift) & 0x0F0F0F0Fu;
          const float scale = sc[(c * S + s) * 8];
#pragma unroll
          for (int i = 0; i < 4; ++i) w[c][i] = small_f32_byte(nib, i) * scale;
        }
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          const float4 xv = *reinterpret_cast<const float4*>(xs + (r * S + s) * QK_K);
#pragma unroll
          for (int c = 0; c < C; ++c) {
            float& a = v[r * C + c];
            a = fmaf(xv.x, w[c][0], a);
            a = fmaf(xv.y, w[c][1], a);
            a = fmaf(xv.z, w[c][2], a);
            a = fmaf(xv.w, w[c][3], a);
          }
        }
      }
      __syncwarp();
      if (lane == 0) tma::arrive(empty + d);
      if (++d == D) d = 0, ++u;
      if ((tb += S) == kb) {  // the K-block ends with the slot
        u_fold<V, 1>(v, lane);
        float* x2 = xch + ((blk & 1) * U_PAIRS + pair) * 32 * VL + lane;
        if (hi) {
#pragma unroll
          for (int i = 0; i < VL; ++i) x2[32 * i] = v[i];
        }
        asm volatile("bar.sync %0, 64;\n" ::"r"(1 + pair) : "memory");
        if (!hi) {
#pragma unroll
          for (int i = 0; i < VL; ++i) {
            const float p = v[i] + x2[32 * i];
            run[i] = first ? p : run[i] + p;
          }
          first = false;
        }
        tb = 0, ++blk;
#pragma unroll
        for (int i = 0; i < V; ++i) v[i] = 0.0f;
      }
    }
    if (!hi && (lane >> LQ) == 0) {  // the low warp's lanes 0 .. min(V, 32)-1, once each
      int q0 = 0;
      if constexpr (LQ > 0) q0 = (int)(__brev(lane) >> (32 - LQ)) * VL;
#pragma unroll
      for (int i = 0; i < VL; ++i) {
        const int q = q0 + i, r = q / C, n = g * COLS + pair * C + q % C;
        if (r < M && n < N) out[(size_t)r * N + n] = run[i];
      }
    }
  }
}

template <int MT, int C, int S>
int launch_twodot(const float* x, const uint8_t* codes, const float* scales, float* out,
                  int M, int K, int N, int kb, int D, cudaStream_t st) {
  const size_t smem = U_RING + (size_t)D * u_slot_bytes(MT, C, S);
  if (smem > (size_t)U_SMEM_MAX) return (int)cudaErrorInvalidValue;
  // x [M][T][256] f32, codes [N][T][128] bytes, scales [N][T][8] f32; a box
  // is S tiles of MT rows or of the CTA's U_PAIRS * C columns
  const cuuint64_t T = K / QK_K;
  const cuuint32_t cols = U_PAIRS * C;
  CUtensorMap xmap, cmap, smap;
  const cuuint64_t xd[3] = {QK_K, T, (cuuint64_t)M}, xs[2] = {QK_K * 4, (cuuint64_t)K * 4};
  const cuuint64_t cd[3] = {QK_K / 2, T, (cuuint64_t)N}, cs[2] = {QK_K / 2, (cuuint64_t)K / 2};
  const cuuint64_t sd[3] = {8, T, (cuuint64_t)N}, ss[2] = {32, (cuuint64_t)K / 8};
  const cuuint32_t xbox[3] = {QK_K, S, MT}, cbox[3] = {QK_K / 2, S, cols}, sbox[3] = {8, S, cols};
  int rc = tma::encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, x, xd, xs, xbox);
  if (!rc) rc = tma::encode(&cmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, codes, cd, cs, cbox);
  if (!rc) rc = tma::encode(&smap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, scales, sd, ss, sbox);
  if (rc) return rc;
  cudaError_t err = cudaFuncSetAttribute(q4k_twodot_kernel<MT, C, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  // a wave of CTAs, each walking column groups: the ring runs on from one
  // group into the next, so a CTA waits for its first slot once
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int groups = (N + cols - 1) / cols, wave = sms * (MT <= 2 ? 2 : 1);
  q4k_twodot_kernel<MT, C, S><<<min(groups, wave), (U_WARPS + 1) * 32, smem, st>>>(
      xmap, cmap, smap, out, M, K, N, kb, D);
  return (int)cudaGetLastError();
}

// the instances: C of 1 or 4 columns a warp pair, S of 1, 2 or 4 tiles a slot
template <int MT>
int launch_twodot_cs(const float* x, const uint8_t* codes, const float* scales, float* out,
                     int M, int K, int N, int kb, int C, int S, int D, cudaStream_t st) {
  if (C == 4) {
    if (S == 4) return launch_twodot<MT, 4, 4>(x, codes, scales, out, M, K, N, kb, D, st);
    if (S == 2) return launch_twodot<MT, 4, 2>(x, codes, scales, out, M, K, N, kb, D, st);
    return launch_twodot<MT, 4, 1>(x, codes, scales, out, M, K, N, kb, D, st);
  }
  if (S == 4) return launch_twodot<MT, 1, 4>(x, codes, scales, out, M, K, N, kb, D, st);
  if (S == 2) return launch_twodot<MT, 1, 2>(x, codes, scales, out, M, K, N, kb, D, st);
  return launch_twodot<MT, 1, 1>(x, codes, scales, out, M, K, N, kb, D, st);
}

}  // namespace

extern "C" {

// Kernel U: x [M, K] f32 (1 <= M <= 16, K % (256*kb) == 0, 1 <= kb <= 8);
// tile-paired codes uint8 [N, K/2], scales f32 [N, K/32]; all three 16-byte
// aligned. The plan (quant_matmul.twodot_plan): C columns a warp pair (1 or
// 4), S tiles a slot (1, 2 or 4, dividing kb), D slots (1 to 8). out [M, N]
// f32 is the positive part summed per K-block of kb tiles (the min term is
// the caller's); the plan moves no bit.
int q4k_twodot_launch(const void* x, const void* codes, const void* scales, int C, int S,
                      int D, int kb, void* out, int M, int K, int N, void* stream) {
  if (M < 1 || M > 16 || kb < 1 || kb > 8 || K % (QK_K * kb) || N < 1 || (C != 1 && C != 4) ||
      (S != 1 && S != 2 && S != 4) || kb % S || D < 1 || D > U_BAR_BYTES / 16)
    return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  const float* s = static_cast<const float*>(scales);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 1) return launch_twodot_cs<1>(xf, c, s, o, M, K, N, kb, C, S, D, st);
  if (M <= 2) return launch_twodot_cs<2>(xf, c, s, o, M, K, N, kb, C, S, D, st);
  if (M <= 4) return launch_twodot_cs<4>(xf, c, s, o, M, K, N, kb, C, S, D, st);
  if (M <= 8) return launch_twodot_cs<8>(xf, c, s, o, M, K, N, kb, C, S, D, st);
  return launch_twodot_cs<16>(xf, c, s, o, M, K, N, kb, C, S, D, st);
}

}  // extern "C"
