// Kernels Q, V and T, CUDA C++ for Hopper (sm_90a): the tools' W4A8 GEMV
// summed per K-slab.
//
// Q (w4a8_slab_launch) replaces blama_tpu/ops/pallas/quant_matmul.py:
// _a8s_kernel (w4a8_swar_matmul's positive part, A's layout: group g of
// column n owns 16 bytes, byte i = element 32g+i low, 32g+16+i high); V
// (w4a8_plane_launch) replaces blama_tpu/tools/ubench_q4k.py:_v2_kernel
// (int8 codes [N, K]) and :_v3_kernel (ubench's tile-paired codes, uint8
// [N, K/2]: tile t's 128 bytes at 128t, byte j = element 256t+j low and
// 256t+128+j high); T (w4a8k4_slab_launch) replaces tools/ab_a8k4.py:
// _x2_kernel (native Q4_K superblocks [N, K/256 * 144] bytes, kernel I's
// group terms with the min term in each). No engine reaches them; the tools
// do. All three: kernel A's quantizer (at 2-16 rows a launch of its own,
// acts::quant_acts_kernel; at one row inside this kernel, the same
// arithmetic), then
// per output column and 32-group the int32 dot of the codes with the
// activation codes, each term (float)dot * ws * xscale (ws the group's bf16
// scale; T: d * sc, and minus (xscale * xsum) * (dmin * mn)), summed per slab
// of kb superblocks (8*kb groups), the slabs added in K order, the first
// assigned; Q's and V's min term is the caller's, as in the references. kb
// is a parameter of their numerics; the references' column tile block_n
// only passes their clamp.
//
// The sum order is the one-warp-per-column kernel's that each had before,
// bit for bit. Q and V (testing.slab_lane_order): lane l took groups l and
// l+32 of a slab, part = fmaf(dot * ws, xscale, part) from 0 (the product
// dot * ws rounded, the fma rounded once: what that kernel's compiled term
// did, PERF.md §6), then slab_sum<HB>: Q (HB = 4) an xor butterfly over lane
// bits 0, 1, 3, 4 (each half: the slab's low-nibble groups 0-3 of each
// superblock, or its high ones), then lo + hi; V (HB = 0) over all five
// bits. A warp here rebuilds that tree for each output it holds: the lane
// terms of groups 4q..4q+3 of a superblock (and of the superblock four
// later, fused in) give quad q's sum, and the quads of the slab meet as the
// butterfly's last levels meet them. T (testing.x2_lane_order): K in steps
// of 8 superblocks, lane (tl, c) took superblock tl of each step of a slab
// and groups 2c, 2c+1 of it, part = part + term; a slab ended in an xor
// butterfly over lane bits 0, 2, 3, 4, then lo + hi (bit 1: groups 4-7);
// its term was fma(dot * ws, xscale, -(sxm * wm)) (PERF.md §6). A warp here
// runs each emulated lane's chains over its superblocks (the slab's
// superblocks stream tl-major: 0, 8, .., 1, 9, ..) and folds them as the
// butterfly's levels did (x2_chunk, X2Tree).
//
// Bound on this card: bytes (the codes and scales, ~0.56 bytes a weight,
// against 2*M int8 operations a weight: far below the int8 tensor rate). So:
//   - each group dot is one mma.m16n8k32 s8 with the weights as A (16
//     columns, so x is read once per 16 columns) and x's rows as B (8 rows;
//     rows past M are zeros; 16 rows take two products): the same exact
//     int32 dots the dp4a chains gave, and a lane holds the same (column,
//     row) outputs in every group's product, so it sees every term of them;
//   - a CTA of T tiles of 16 columns, R consumer warps a tile, and one
//     producer thread that keeps a ring of D slots full with TMA boxes
//     (tma_ring.cuh): a slot is one superblock of K (8 groups) of x's codes
//     and scales (T: and x's sxm) and of the CTA's codes and scales, the
//     code boxes swizzled by 128 bytes so each ldmatrix reads 8 rows from 8
//     bank groups (T: one box of the CTA's 144-byte superblocks, header and
//     codes, unswizzled: a 144-byte row stride already spreads 8 rows over
//     8 bank groups). x is staged once per CTA and slot, overlapped with
//     compute, with no CTA barrier in the K loop;
//   - T decodes each header once per warp (a lane two groups of two
//     columns, handed to the quad's other lanes by shuffles), and takes the
//     high nibbles' dot 16-fold (unsigned A, the nibbles masked in place)
//     with the ws of those groups divided by 16: the same floats;
//   - a warp's step is two neighbouring slots: where kb > 4 a superblock and
//     the one four later, whose terms a lane fuses (the slab's superblocks
//     stream in the order 0, 4, 1, 5, 2, 6, 3, 7), else two superblocks of a
//     slab, one half of its tree; fewer steps, fewer waits and folds. T's
//     step is whole chains of emulated lanes, a slot at a time: two (tl, tl
//     + 1) of one superblock each where kb <= 8, else one of ceil(kb / 8);
//   - where the tiles are few (wk/wv's 64) or K long (down), one warp a tile
//     would leave an SM one or two warps of latency-bound chains: the R
//     warps of a tile take its steps in turn, hand each round's partial sums
//     to each other, and each folds its share of the outputs in K order;
//   - a wave of CTAs walks the column groups (the ring runs on from one into
//     the next); T, R and D come from quant_matmul.slab_plan and move no
//     bit;
//   - at 2-16 rows the quantizer before it is a launch of its own, and this
//     one its programmatic dependent: it starts while the quantizer runs,
//     and its producer waits for x's codes (griddepcontrol.wait) before its
//     first copy. At one row there is one launch: each CTA's consumer warps
//     quantize x's row into shared memory while the producer streams the
//     first slots (CTA 0 writes xq, xs, sxm out), and a slot carries only
//     the CTA's codes and scales.
//
// Determinism: every sum in a fixed order, no atomics, so a replay gives the
// same bits, and a row's outputs do not depend on M or on the row's index.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma_ring.cuh"

namespace {

// Kernel A's activation quantizer as a launch of its own: the prologue of
// the slab GEMVs at 2-16 rows. Per (row, 32-group) of x: scale = amax / 127
// (IEEE division), inv = 1 / scale (0 when scale is 0), q = rint(x * inv)
// as int8 (round half to even), xs = scale, sxm = scale * sum(q); one warp
// per (row, group). Each CTA lets a programmatic dependent launch (the
// GEMV) start at once: the GEMV waits for this grid's outputs itself
// (griddepcontrol.wait), and streams its weights meanwhile.
namespace acts {

constexpr int GROUP = 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void quant_acts_kernel(const T* __restrict__ x, int M, int K,
                                  int8_t* __restrict__ xq,
                                  float* __restrict__ xs,
                                  float* __restrict__ sxm) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
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
void launch_quant_acts(const void* x, int x_bf16, int M, int K, void* xq, void* xs, void* sxm,
                       cudaStream_t st) {
  const int warps = M * (K / GROUP);
  const int qblocks = (warps * 32 + 255) / 256;
  int8_t* q = static_cast<int8_t*>(xq);
  float* s = static_cast<float*>(xs);
  float* sm = static_cast<float*>(sxm);
  if (x_bf16)
    quant_acts_kernel<__nv_bfloat16><<<qblocks, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), M, K, q, s, sm);
  else
    quant_acts_kernel<float><<<qblocks, 256, 0, st>>>(static_cast<const float*>(x), M, K, q, s,
                                                       sm);
}

}  // namespace acts

constexpr int QK_K = 256;               // a superblock (Q, T) or tile (V): a slot's K
constexpr int Q4K_BLOCK = 144;          // T's superblock bytes: a 16-byte header, 128 of codes
constexpr int SG_MAX_WARPS = 8;         // consumer warps of a CTA, 16 columns each
constexpr int SG_MAX_SLOTS = 32;
constexpr int SG_SMEM_MAX = 232448;     // an H100's shared memory for one CTA
constexpr uint32_t SG_MAGIC = 0x4B400000u;  // the mma's C: D as a float is 1.5*2^23 + dot
constexpr uint32_t NIB = 0x0F0F0F0Fu;

enum SlabCodes { GROUP_PAIRED = 0, INT8_CODES = 1, TILE_PAIRED = 2, Q4K_NATIVE = 3 };

// A slot: x's codes ([2 halves][XR rows][128 bytes], each half swizzled),
// the CTA's codes ([cols][128 bytes] swizzled; int8 codes [2][cols][128]),
// x's scales ([XR][8] f32), the CTA's scales ([cols][8] bf16), on 1024
// bytes; T: x's codes, the CTA's superblocks ([cols][144 bytes]
// unswizzled: a column's header, then its codes), x's scales, x's sxm
// ([XR][8] f32); at one row x's parts are not in the slot (the CTA
// quantizes x's row into shared memory once). quant_matmul.slab_slot_bytes
// computes the same sizes, and slab_slot_size gives these to it.
__host__ __device__ constexpr int sg_xr(int MT) { return MT <= 8 ? 8 : 16; }
__host__ __device__ constexpr int sg_x_bytes(int MT) { return MT == 1 ? 0 : 2 * sg_xr(MT) * 128; }
__host__ __device__ constexpr int sg_xs_bytes(int MT) { return MT == 1 ? 0 : 32 * sg_xr(MT); }
__host__ __device__ constexpr int sg_code_bytes(int L, int cols) {
  return (L == INT8_CODES ? 256 : 128) * cols;
}
__host__ __device__ constexpr int sg_tx_bytes(int MT, int L, int cols) {
  return sg_x_bytes(MT) + sg_code_bytes(L, cols) + (L == Q4K_NATIVE ? 2 : 1) * sg_xs_bytes(MT) +
         16 * cols;
}
__host__ __device__ constexpr int sg_slot_bytes(int MT, int L, int cols) {
  return (sg_tx_bytes(MT, L, cols) + 1023) / 1024 * 1024;
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d = A B + SG_MAGIC: A 16 weight columns x 32 k (a0: column g, k 4t..4t+3;
// a1: column g+8; a2, a3: k 16+4t..), B 32 k x 8 x rows (b0: row g, k 4t..;
// b1: k 16+4t..); d0, d1: column g, rows 2t, 2t+1; d2, d3: column g+8
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%10,%10,%10,%10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(SG_MAGIC));
}

__device__ __forceinline__ float dot_f32(int d) {  // exact: |dot| < 2^22
  return __fsub_rn(__int_as_float(d), 12582912.0f);
}

// bf16 scale k of the 8 a uint4 holds, as f32
__device__ __forceinline__ float bf16_at(const uint4& v, int k) {
  const uint32_t w = (k >> 1) == 0 ? v.x : (k >> 1) == 1 ? v.y : (k >> 1) == 2 ? v.z : v.w;
  return __uint_as_float((k & 1) ? (w & 0xFFFF0000u) : (w << 16));
}

// What a lane holds: NO outputs, output o at column gq + 8 * col_hi(o) of
// the warp's 16 and x row 2t + row_of(o) (d register dreg(o) of product
// o / 4's); at one row only the rows-0 outputs (d0, d2) of lanes t = 0.
__host__ __device__ constexpr int sg_outs(int MT) { return MT == 1 ? 2 : MT <= 8 ? 4 : 8; }

template <int MT>
struct Outs {
  static constexpr int NO = sg_outs(MT);
  static constexpr int NP = MT <= 8 ? 1 : 2;   // products a group (8 rows each)
  __device__ static constexpr int col_hi(int o) { return NO == 2 ? o : (o >> 1) & 1; }
  __device__ static constexpr int row_of(int o) { return NO == 2 ? 0 : (o & 1) + 8 * (o >> 2); }
  __device__ static constexpr int dreg(int o) { return NO == 2 ? 2 * o : o & 3; }
};

// A CTA's dynamic shared memory (quant_matmul.slab_smem, and slab_smem_size
// gives it): 1024 bytes to align the ring, the ring, its 2·D barriers, where
// R > 1 the partial sums a tile's warps hand each other (two buffers), and
// at one row x's row quantized (K codes, K/32 f32 scales; T: and K/32 sxm).
__host__ __device__ constexpr size_t sg_smem_bytes(int MT, int L, int T, int R, int D, int K) {
  return 1024 + (size_t)D * sg_slot_bytes(MT, L, 16 * T) + 16 * (size_t)D +
         (R > 1 ? (size_t)512 * T * R * sg_outs(MT) : 0) +
         (MT == 1 ? (size_t)K + (L == Q4K_NATIVE ? 8 : 4) * (size_t)(K / 32) : 0);
}

// The A fragments of groups k and k+4 of a slot's superblock, for the 16
// columns at c0 (ldmatrix.x4: lane 8m + r gives row r of matrix m).
template <int L>
__device__ __forceinline__ void a_frags(uint32_t cbase, int cols, int c0, int k, int lane,
                                        uint32_t (&lo)[4], uint32_t (&hi)[4]) {
  const int r8 = lane & 7, m = lane >> 3;
  const uint32_t col = c0 + r8 + 8 * (m & 1);
  uint32_t r[4];
  if constexpr (L == GROUP_PAIRED) {  // group j: 16 bytes at 16j; m >> 1 picks k or k+4
    ldsm_x4(cbase + tma::swz128(col, 16 * (k + 4 * (m >> 1))), r);
    lo[0] = r[0] & NIB, lo[1] = r[1] & NIB, lo[2] = (r[0] >> 4) & NIB, lo[3] = (r[1] >> 4) & NIB;
    hi[0] = r[2] & NIB, hi[1] = r[3] & NIB, hi[2] = (r[2] >> 4) & NIB, hi[3] = (r[3] >> 4) & NIB;
  } else if constexpr (L == TILE_PAIRED) {  // bytes 32k..: group k low, k+4 high nibbles
    ldsm_x4(cbase + tma::swz128(col, 16 * (2 * k + (m >> 1))), r);
#pragma unroll
    for (int i = 0; i < 4; ++i) lo[i] = r[i] & NIB, hi[i] = (r[i] >> 4) & NIB;
  } else {  // int8: group k's 32 bytes at 32k of half 0, group k+4 of half 1
    ldsm_x4(cbase + tma::swz128(col, 16 * (2 * k + (m >> 1))), lo);
    ldsm_x4(cbase + cols * 128 + tma::swz128(col, 16 * (2 * k + (m >> 1))), hi);
  }
}

// The B fragments of groups k (b[0], b[1]) and k+4 (b[2], b[3]) for x rows
// rb .. rb+7 of a slot.
template <int MT>
__device__ __forceinline__ void b_frags(uint32_t xbase, int k, int rb, int lane,
                                        uint32_t (&b)[4]) {
  const int r8 = lane & 7, m = lane >> 3;
  ldsm_x4(xbase + (m >> 1) * sg_xr(MT) * 128 + tma::swz128(rb + r8, 16 * (2 * k + (m & 1))), b);
}

// x's row (one row only) for a superblock: its 256 codes in shared memory
// (address q) and its 8 scales (s)
struct XRow {
  uint32_t q;
  const float* s;
};

// sel4(t, v) = v[t] for a lane's t in 0..3, v indexed by constants
__device__ __forceinline__ int sel4(int t, const int (&v)[4]) {
  const int lo = (t & 1) ? v[1] : v[0], hi = (t & 1) ? v[3] : v[2];
  return (t & 2) ? hi : lo;
}

// sg_chunk at one row: every B row is x's row 0, so every lane of a quad
// holds its two columns' dots of every group; lane t takes the terms of
// groups t (the low quad) and t + 4 (the high one), and the quad's sum
// ((v0 + v1) + (v2 + v3)) is two xor shuffles over the quad's lanes, which
// add the same pairs (a + b == b + a): a quarter of the terms a lane
// computes at 2-8 rows, on the same bits.
template <int L, bool PAIR>
__device__ __forceinline__ void sg_chunk_row(const uint8_t* s1, const uint8_t* s2,
                                             const XRow (&xr)[2], int cols, int c0, int lane,
                                             float (&qa)[2], float (&qb)[2]) {
  const int gq = lane >> 2, t = lane & 3, m = lane >> 3;
  const int wso = sg_code_bytes(L, cols);
  const uint8_t* sl[2] = {s1, s2};
  float vl[2] = {0.0f, 0.0f}, vh[2] = {0.0f, 0.0f};  // columns gq, gq + 8
#pragma unroll
  for (int p = 0; p < (PAIR ? 2 : 1); ++p) {
    const uint32_t base = tma::smem_addr(sl[p]);
    int dl[2][4], dh[2][4];  // [column half][k]
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // the superblock's groups k and k + 4 of x's row, every lane the same row
      uint32_t alo[4], ahi[4], b[4];
      a_frags<L>(base, cols, c0, k, lane, alo, ahi);
      ldsm_x4(xr[p].q + (m >> 1) * 128 + 32 * k + 16 * (m & 1), b);
      int d[4];
      mma_s8(d, alo, b[0], b[1]);
      dl[0][k] = d[0], dl[1][k] = d[2];
      mma_s8(d, ahi, b[2], b[3]);
      dh[0][k] = d[0], dh[1][k] = d[2];
    }
    const float xl = xr[p].s[t], xh = xr[p].s[t + 4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const __nv_bfloat16* ws =
          reinterpret_cast<const __nv_bfloat16*>(sl[p] + wso + (c0 + gq + 8 * h) * 16);
      vl[h] = __fmaf_rn(__fmul_rn(dot_f32(sel4(t, dl[h])), __bfloat162float(ws[t])), xl, vl[h]);
      vh[h] = __fmaf_rn(__fmul_rn(dot_f32(sel4(t, dh[h])), __bfloat162float(ws[t + 4])), xh,
                        vh[h]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float a = __fadd_rn(vl[h], __shfl_xor_sync(0xffffffffu, vl[h], 1));
    float b = __fadd_rn(vh[h], __shfl_xor_sync(0xffffffffu, vh[h], 1));
    qa[h] = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, 2));
    qb[h] = __fadd_rn(b, __shfl_xor_sync(0xffffffffu, b, 2));
  }
}

// One slot's superblock (and, PAIR, the one four later from the next slot)
// for the warp's 16 columns at c0: qa[o] = quad of groups 0-3, qb[o] of
// groups 4-7, each ((v0 + v1) + (v2 + v3)) of the lane terms
// v = fmaf(dot * ws, xs, 0) [then fmaf(dot' * ws', xs', v)].
template <int MT, int L, bool PAIR>
__device__ __forceinline__ void sg_chunk(const uint8_t* s1, const uint8_t* s2,
                                         const XRow (&xr)[2], int cols, int c0, int lane,
                                         float (&qa)[Outs<MT>::NO], float (&qb)[Outs<MT>::NO]) {
  if constexpr (MT == 1) {
    sg_chunk_row<L, PAIR>(s1, s2, xr, cols, c0, lane, qa, qb);
    return;
  }
  using O = Outs<MT>;
  constexpr int NO = O::NO, NP = O::NP, XB = sg_x_bytes(MT), XR = sg_xr(MT);
  const int gq = lane >> 2, t = lane & 3;
  const int xso = XB + sg_code_bytes(L, cols), wso = xso + 32 * XR;
  const uint8_t* sl[2] = {s1, s2};
  uint4 ws[2][2];
  const float* xs[2];
#pragma unroll
  for (int p = 0; p < (PAIR ? 2 : 1); ++p) {
    ws[p][0] = *reinterpret_cast<const uint4*>(sl[p] + wso + (c0 + gq) * 16);
    ws[p][1] = *reinterpret_cast<const uint4*>(sl[p] + wso + (c0 + gq + 8) * 16);
    xs[p] = reinterpret_cast<const float*>(sl[p] + xso) + 2 * t * 8;
  }
  float pa[NO], sa[NO], pb[NO], sb[NO];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int dl[2][NP][4], dh[2][NP][4];  // [slot][product][reg]: groups k and k+4
#pragma unroll
    for (int p = 0; p < (PAIR ? 2 : 1); ++p) {
      const uint32_t base = tma::smem_addr(sl[p]);
      uint32_t alo[4], ahi[4];
      a_frags<L>(base + XB, cols, c0, k, lane, alo, ahi);
#pragma unroll
      for (int h = 0; h < NP; ++h) {
        uint32_t b[4];
        b_frags<MT>(base, k, 8 * h, lane, b);
        mma_s8(dl[p][h], alo, b[0], b[1]);
        mma_s8(dh[p][h], ahi, b[2], b[3]);
      }
    }
#pragma unroll
    for (int o = 0; o < NO; ++o) {
      const int h = o >> 2, ch = O::col_hi(o), row = O::row_of(o) * 8;  // xs row offset
      float vl = 0.0f, vh = 0.0f;
#pragma unroll
      for (int p = 0; p < (PAIR ? 2 : 1); ++p) {
        const float xl = xs[p][row + k], xh = xs[p][row + k + 4];
        vl = __fmaf_rn(__fmul_rn(dot_f32(dl[p][h][O::dreg(o)]), bf16_at(ws[p][ch], k)), xl, vl);
        vh = __fmaf_rn(__fmul_rn(dot_f32(dh[p][h][O::dreg(o)]), bf16_at(ws[p][ch], k + 4)), xh,
                       vh);
      }
      if (k == 0) pa[o] = vl, pb[o] = vh;
      else if (k == 1) pa[o] = __fadd_rn(pa[o], vl), pb[o] = __fadd_rn(pb[o], vh);
      else if (k == 2) sa[o] = vl, sb[o] = vh;
      else qa[o] = __fadd_rn(pa[o], __fadd_rn(sa[o], vl)),
           qb[o] = __fadd_rn(pb[o], __fadd_rn(sb[o], vh));
    }
  }
}

// The slab tree's state of one output. Superblock c of a slab gives quads
// Q_2c (qa) and Q_2c+1 (qb); LOHI (HB = 4): lo = (Q0 + Q2) + (Q4 + Q6), hi
// alike over the odd quads, the slab's sum lo + hi; else ((Q0 + Q1) +
// (Q2 + Q3)) + ((Q4 + Q5) + (Q6 + Q7)). Absent quads (kb < 4) are the
// parent's empty lanes, +0. The slabs go into run in K order, the first
// assigned. A step brings superblocks 2h and 2h + 1 as the tree's half h
// (x = the lo, y = the hi partial; for V x alone), or, where kb > 4,
// superblock c's quads (each lane term holding c + 4's too).
template <bool LOHI>
struct SlabTree {
  float ta, tb, tc, te, run;
  __device__ __forceinline__ void end(bool first) {
    const float acc = LOHI ? __fadd_rn(__fadd_rn(ta, tc), __fadd_rn(tb, te)) : __fadd_rn(ta, tc);
    run = first ? acc : __fadd_rn(run, acc);
  }
  // half h of nh (the slab's last half ends it; with one half the upper is +0)
  __device__ __forceinline__ void half(int h, int nh, bool first, float x, float y) {
    if (h == 0) ta = x, tb = y;
    else tc = x, te = y;
    if (h == nh - 1) {
      if (nh == 1) tc = 0.0f, te = 0.0f;
      end(first);
    }
  }
  // superblock c's quads, of four a slab
  __device__ __forceinline__ void quads(int c, bool first, float qa, float qb) {
    const float pa = LOHI ? qa : __fadd_rn(qa, qb);
    const bool odd = c & 1, upper = c & 2;  // superblocks 1, 3 add; 2, 3 the upper half
    const float x = odd ? __fadd_rn(upper ? tc : ta, pa) : pa;
    const float y = odd ? __fadd_rn(upper ? te : tb, qb) : qb;
    tc = upper ? x : tc, te = upper ? y : te;
    ta = upper ? ta : x, tb = upper ? tb : y;
    if (c == 3) end(first);
  }
};

// x's row (one row) quantized as quant_acts_kernel does it (per 32-group:
// amax / 127, codes rint(x * (1 / scale)), scale * their sum) into shared
// memory: its codes (x_row), scales (xs_row) and, where sxm_row is given,
// scale * sum; by the W consumer warps (warp 0 .. W-1) while the producer
// streams the first slots: a thread takes 8 elements, four threads a group.
// CTA 0 also writes xq, xs, sxm out.
__device__ __forceinline__ void quant_row(const void* x, int x_bf16, int K, int warp, int W,
                                          int lane, int8_t* x_row, float* xs_row, float* sxm_row,
                                          int8_t* xq_out, float* xs_out, float* sxm_out) {
  const int G = K / 32;
  constexpr int QB = 8;  // chunks a thread loads before it quantizes one: one round trip
  for (int e0 = warp * 32; e0 < 4 * G; e0 += QB * W * 32) {
    uint4 raw[QB][2];
#pragma unroll
    for (int j = 0; j < QB; ++j) {
      const int e = e0 + j * W * 32 + lane;
      raw[j][0] = raw[j][1] = make_uint4(0, 0, 0, 0);
      if (e < 4 * G) {
        if (x_bf16) {
          raw[j][0] = __ldg(reinterpret_cast<const uint4*>(x) + e);
        } else {
          raw[j][0] = __ldg(reinterpret_cast<const uint4*>(x) + 2 * e);
          raw[j][1] = __ldg(reinterpret_cast<const uint4*>(x) + 2 * e + 1);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < QB; ++j) {
      const int e = e0 + j * W * 32 + lane, g = e >> 2;
      if (e0 + j * W * 32 >= 4 * G) break;  // uniform: the warp's chunks are done
      const bool live = e < 4 * G;        // the same for the four lanes of a group
      float v[8];
      const uint32_t w[8] = {raw[j][0].x, raw[j][0].y, raw[j][0].z, raw[j][0].w,
                             raw[j][1].x, raw[j][1].y, raw[j][1].z, raw[j][1].w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[i] = x_bf16 ? __uint_as_float((i & 1) ? (w[i >> 1] & 0xFFFF0000u) : (w[i >> 1] << 16))
                      : __uint_as_float(w[i]);
      float a = 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i) a = fmaxf(a, fabsf(v[i]));
      a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, 1));
      a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, 2));
      const float scale = a / 127.0f;
      const float inv = scale > 0.0f ? 1.0f / scale : 0.0f;
      uint32_t packed[2] = {0, 0};
      int sum = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int q = __float2int_rn(v[i] * inv);
        sum += q;
        packed[i >> 2] |= (uint32_t)(q & 0xFF) << (8 * (i & 3));
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (live) {
        reinterpret_cast<uint2*>(x_row)[e] = make_uint2(packed[0], packed[1]);
        if ((e & 3) == 0) {
          xs_row[g] = scale;
          if (sxm_row) sxm_row[g] = scale * (float)sum;
        }
        if (blockIdx.x == 0) {
          reinterpret_cast<uint2*>(xq_out)[e] = make_uint2(packed[0], packed[1]);
          if ((e & 3) == 0) xs_out[g] = scale, sxm_out[g] = scale * (float)sum;
        }
      }
    }
  }
}

// Kernels Q (L = GROUP_PAIRED, HB = 4) and V (INT8_CODES, TILE_PAIRED; HB =
// 0). A CTA owns T tiles of 16 columns and runs R consumer warps on each
// (warp = tile * R + r), beside a producer warp. The producer (one thread)
// pushes, per column group and slab, the slab's superblocks in the order 0,
// 4, 1, 5, 2, 6, 3, 7 where kb > 4, else 0, 1, 2, 3 (those below kb): slot
// seq of the CTA's stream. A tile's steps go in K order, two slots each
// where there are two: per slab, superblock c with its partner c + 4 for c
// < 4 where kb > 4, else the halves (0, 1) and (2, 3). Warp r of a tile
// takes steps r, r + R, ...; each round of R steps its warps hand their
// partial sums to each other through shared memory (two buffers, one named
// barrier a tile and round), and warp r folds the round's partials of the
// outputs o with o % R == r into their slab trees in step order, and
// stores those outputs (R = 1: no exchange). A warp waits for a slot's fill
// by the parity of its use, which is sound only while the slot's previous
// use has completed: the ring holds a round's slots (D >= 2R), and a
// round's warps meet at the barrier before the next round. CTA b takes
// column groups b, b + gridDim.x, ...
template <int MT, int L>
__global__ void __launch_bounds__((SG_MAX_WARPS + 1) * 32, 1)
slab_gemv_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap cmap,
                 const __grid_constant__ CUtensorMap xsmap,
                 const __grid_constant__ CUtensorMap wsmap, float* __restrict__ out, int M,
                 int K, int N, int kb, int T, int R, int D, const void* __restrict__ x,
                 int x_bf16, int8_t* __restrict__ xq_out, float* __restrict__ xs_out,
                 float* __restrict__ sxm_out) {
  using O = Outs<MT>;
  constexpr int NO = O::NO, XR = sg_xr(MT), XB = sg_x_bytes(MT);
  const int W = T * R, cols = 16 * T, slot = sg_slot_bytes(MT, L, cols);
  const int cb = sg_code_bytes(L, cols);
  extern __shared__ __align__(1024) uint8_t sg_smem[];
  uint8_t* ring = sg_smem + ((1024 - (tma::smem_addr(sg_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + (size_t)D * slot);
  uint64_t* empty = full + D;
  float* xch = reinterpret_cast<float*>(empty + D);  // [2][W][2][NO][32] where R > 1
  // at one row: x's row quantized, its codes [K] and scales [K/32]
  int8_t* x_row = reinterpret_cast<int8_t*>(xch + (R > 1 ? 2 * W * 2 * NO * 32 : 0));
  float* xs_row = reinterpret_cast<float*>(x_row + K);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nslab = K / (QK_K * kb), nch = min(kb, 4), extra = max(kb - 4, 0);
  const int groups = (N + cols - 1) / cols;
  if (warp == 0) {
    for (int d = lane; d < D; d += 32) {
      tma::bar_init(full + d, 1);
      tma::bar_init(empty + d, T);
    }
    tma::fence_init();
  }
  __syncthreads();

  if (warp == W) {  // the producer: 5 boxes a slot (6 for int8 codes; 2 or 3 at one
                    // row), zeros past M and N
    if (lane == 0) {
      const uint32_t tx = sg_tx_bytes(MT, L, cols);
      if constexpr (MT > 1) asm volatile("griddepcontrol.wait;\n" ::: "memory");  // x's codes
      int d = 0, u = 0;
      for (int g = blockIdx.x; g < groups; g += gridDim.x)
        for (int s = 0; s < nslab; ++s)
          for (int c = 0; c < nch; ++c)
            for (int sb = s * kb + c; sb < s * kb + kb; sb += 4) {
              if (u) tma::wait(empty + d, (u - 1) & 1);
              uint8_t* sl = ring + (size_t)d * slot;
              tma::arrive_expect(full + d, tx);
              if constexpr (MT > 1) {
                tma::copy2d(sl, &xmap, sb * QK_K, 0, full + d);
                tma::copy2d(sl + XR * 128, &xmap, sb * QK_K + 128, 0, full + d);
                tma::copy2d(sl + XB + cb, &xsmap, sb * 8, 0, full + d);
              }
              if constexpr (L == INT8_CODES) {
                tma::copy2d(sl + XB, &cmap, sb * QK_K, g * cols, full + d);
                tma::copy2d(sl + XB + cols * 128, &cmap, sb * QK_K + 128, g * cols, full + d);
              } else {
                tma::copy2d(sl + XB, &cmap, sb * (QK_K / 2), g * cols, full + d);
              }
              tma::copy2d(sl + XB + cb + sg_xs_bytes(MT), &wsmap, sb * 8, g * cols, full + d);
              if (++d == D) d = 0, ++u;
            }
    }
    return;
  }

  if constexpr (MT == 1) {
    quant_row(x, x_bf16, K, warp, W, lane, x_row, xs_row, nullptr, xq_out, xs_out, sxm_out);
    asm volatile("bar.sync 15, %0;\n" ::"r"(W * 32) : "memory");  // the consumer warps
  }

  const int tile = warp / R, r = warp - tile * R;
  const int gq = lane >> 2, t = lane & 3, c0 = 16 * tile;
  const uint32_t x_row_a = tma::smem_addr(x_row);
  const bool quads = kb > 4;                 // steps of a superblock and its partner
  const int per_slab = quads ? 4 : (nch + 1) / 2, nstep = nslab * per_slab;
  const int per_group = nslab * kb;
  const int ds = R / per_slab, di = R - ds * per_slab;  // a round's step in (slab, step)
  unsigned own = 0;                           // the outputs this warp folds and stores
#pragma unroll
  for (int o = 0; o < NO; ++o) own |= (o % R == r) << o;
  auto fold = [&](SlabTree<L == GROUP_PAIRED>& tr, int i, bool first, float x, float y) {
    if (quads) tr.quads(i, first, x, y);
    else tr.half(i, per_slab, first, x, y);
  };
  int gbase = 0, buf = 0;
  int seq = 0, d = 0, u = 0;  // a slot of the CTA's stream: seq = u * D + d
  for (int g = blockIdx.x; g < groups; g += gridDim.x, gbase += per_group) {
    SlabTree<L == GROUP_PAIRED> tr[NO];
    int s = r / per_slab, i = r - (r / per_slab) * per_slab;  // this warp's step: slab s, i
    int sr = 0, ir = 0;                                          // the round's first step
    for (int p0 = 0; p0 < nstep; p0 += R) {
      float x[NO], y[NO];
      if (p0 + r < nstep) {
        // the step's first slot, and whether a second (the next) belongs to it
        const int next = gbase + s * kb + (quads ? i + min(i, extra) : 2 * i);
        const bool two = quads ? i < extra : 2 * i + 1 < nch;
        for (d += next - seq, seq = next; d >= D; d -= D) ++u;
        const int d2 = d + 1 == D ? 0 : d + 1, u2 = d + 1 == D ? u + 1 : u;
        tma::wait(full + d, u & 1);
        if (two) tma::wait(full + d2, u2 & 1);
        const uint8_t* s1 = ring + (size_t)d * slot;
        const uint8_t* s2 = ring + (size_t)d2 * slot;
        const int sb = s * kb + (quads ? i : 2 * i), sb2 = sb + (quads ? 4 : 1);
        const XRow xr[2] = {{x_row_a + sb * QK_K, xs_row + sb * 8},   // at one row
                            {x_row_a + sb2 * QK_K, xs_row + sb2 * 8}};
        if (quads && two) {
          sg_chunk<MT, L, true>(s1, s2, xr, cols, c0, lane, x, y);
        } else {
#pragma unroll 1
          for (int k2 = 0; k2 < 1 + two; ++k2) {  // a half: its one or two superblocks
            float qa[NO], qb[NO];
            const XRow xk[2] = {xr[k2], xr[k2]};
            sg_chunk<MT, L, false>(k2 ? s2 : s1, nullptr, xk, cols, c0, lane, qa, qb);
#pragma unroll
            for (int o = 0; o < NO; ++o) {
              const float pa = quads || L == GROUP_PAIRED ? qa[o] : __fadd_rn(qa[o], qb[o]);
              x[o] = k2 ? __fadd_rn(x[o], pa) : pa;
              y[o] = k2 ? __fadd_rn(y[o], qb[o]) : qb[o];
            }
          }
          if (!quads && !two) {  // a half of one superblock: the other's quads are +0
#pragma unroll
            for (int o = 0; o < NO; ++o) x[o] = __fadd_rn(x[o], 0.0f), y[o] = __fadd_rn(y[o], 0.0f);
          }
        }
        __syncwarp();
        if (lane == 0) {
          tma::arrive(empty + d);
          if (two) tma::arrive(empty + d2);
        }
        if (R == 1) {
#pragma unroll
          for (int o = 0; o < NO; ++o) fold(tr[o], i, s == 0, x[o], y[o]);
        }
      }
      if (R > 1) {  // the round's partials to every warp of the tile; each folds its outputs'
        float* mine = xch + ((size_t)(buf * W + warp) * 2 * NO) * 32 + lane;
        if (p0 + r < nstep) {
#pragma unroll
          for (int o = 0; o < NO; ++o) mine[o * 32] = x[o], mine[(NO + o) * 32] = y[o];
        }
        asm volatile("bar.sync %0, %1;\n" ::"r"(1 + tile), "r"(R * 32) : "memory");
        int sj = sr, ij = ir;  // steps p0 .. p0 + R - 1: warps tile * R + j
        for (int j = 0; j < R && p0 + j < nstep; ++j) {
          const float* th = xch + ((size_t)(buf * W + tile * R + j) * 2 * NO) * 32 + lane;
#pragma unroll
          for (int o = 0; o < NO; ++o)
            if (own >> o & 1) fold(tr[o], ij, sj == 0, th[o * 32], th[(NO + o) * 32]);
          if (++ij == per_slab) ij = 0, ++sj;
        }
        buf ^= 1;
      }
      sr += ds, ir += di;
      if (ir >= per_slab) ir -= per_slab, ++sr;
      s += ds, i += di;
      if (i >= per_slab) i -= per_slab, ++s;
    }
#pragma unroll
    for (int o = 0; o < NO; ++o) {
      const int row = 2 * t + O::row_of(o), n = g * cols + c0 + gq + 8 * O::col_hi(o);
      if ((own >> o & 1) && row < M && n < N) out[(size_t)row * N + n] = tr[o].run;
    }
  }
}

// the activation prologue (a launch of its own at 2..16 rows; at one row
// the kernel quantizes x itself), then kernel Q or V on codes of layout L
template <int MT, int L>
int launch_slab(const void* x, int x_bf16, const void* codes, const void* scales, int8_t* xq,
                float* xs, float* sxm, float* out, int M, int K, int N, int kb, int T, int R,
                int D, cudaStream_t st) {
  constexpr int XR = sg_xr(MT);
  const int cols = 16 * T;
  const size_t smem = sg_smem_bytes(MT, L, T, R, D, K);
  if (smem > (size_t)SG_SMEM_MAX) return (int)cudaErrorInvalidValue;
  // x's codes [M][K] and the codes [N][K or K/2] bytes in 128-byte boxes
  // (128-byte swizzle); x's scales [M][K/32] f32 and the scales [N][K/32]
  // bf16 in boxes of 8 groups
  const cuuint64_t G = K / 32, ck = L == INT8_CODES ? K : K / 2;
  const cuuint64_t xd[2] = {(cuuint64_t)K, (cuuint64_t)M}, xst[1] = {(cuuint64_t)K};
  const cuuint64_t cd[2] = {ck, (cuuint64_t)N}, cst[1] = {ck};
  const cuuint64_t xsd[2] = {G, (cuuint64_t)M}, xsst[1] = {G * 4};
  const cuuint64_t wsd[2] = {G, (cuuint64_t)N}, wsst[1] = {G * 2};
  const cuuint32_t xbox[2] = {128, XR}, cbox[2] = {128, (cuuint32_t)cols};
  const cuuint32_t xsbox[2] = {8, XR}, wsbox[2] = {8, (cuuint32_t)cols};
  CUtensorMap xmap{}, cmap{}, xsmap{}, wsmap{};
  int rc = tma::encode(&cmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, codes, cd, cst, cbox,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  if (!rc) rc = tma::encode(&wsmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, scales, wsd, wsst,
                            wsbox);
  if (MT > 1) {
    if (!rc) rc = tma::encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, xq, xd, xst, xbox,
                              CU_TENSOR_MAP_SWIZZLE_128B);
    if (!rc) rc = tma::encode(&xsmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, xs, xsd, xsst, xsbox);
  }
  if (rc) return rc;
  cudaError_t err = cudaFuncSetAttribute(slab_gemv_kernel<MT, L>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int groups = (N + cols - 1) / cols;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(min(groups, sms));
  cfg.blockDim = dim3((T * R + 1) * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  if (MT > 1) {
    // the quantizer, then this launch as its programmatic dependent: it may
    // start while the quantizer runs, and waits for its outputs itself
    acts::launch_quant_acts(x, x_bf16, M, K, xq, xs, sxm, st);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  err = cudaLaunchKernelEx(&cfg, slab_gemv_kernel<MT, L>, xmap, cmap, xsmap, wsmap, out, M, K,
                           N, kb, T, R, D, x, x_bf16, xq, xs, sxm);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int L>
int launch_slab_rows(const void* x, int x_bf16, const void* codes, const void* scales,
                     int8_t* xq, float* xs, float* sxm, float* out, int M, int K, int N, int kb,
                     int T, int R, int D, cudaStream_t st) {
#define SG_ROWS(MT) \
  launch_slab<MT, L>(x, x_bf16, codes, scales, xq, xs, sxm, out, M, K, N, kb, T, R, D, st)
  if (M <= 1) return SG_ROWS(1);
  if (M <= 2) return SG_ROWS(2);
  if (M <= 4) return SG_ROWS(4);
  if (M <= 8) return SG_ROWS(8);
  return SG_ROWS(16);
#undef SG_ROWS
}

// kernel Q or V on codes of layout L, after checking the launch
int launch_w4a8_slab(const void* x, int x_bf16, const void* codes, const void* scales, int L,
                     int T, int R, int D, int kb, void* xq, void* xs, void* sxm, void* out,
                     int M, int K, int N, void* stream) {
  if (M < 1 || M > 16 || N < 1 || kb < 1 || kb > 8 || K % (QK_K * kb) || T < 1 || R < 1 ||
      T * R > SG_MAX_WARPS || D < 2 || D < R * (kb > 1 ? 2 : 1) || D > SG_MAX_SLOTS ||
      ((reinterpret_cast<uintptr_t>(codes) | reinterpret_cast<uintptr_t>(scales) |
        reinterpret_cast<uintptr_t>(x)) & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(xq);
  float* s = static_cast<float*>(xs);
  float* sm = static_cast<float*>(sxm);
  float* o = static_cast<float*>(out);
  if (L == GROUP_PAIRED)
    return launch_slab_rows<GROUP_PAIRED>(x, x_bf16, codes, scales, q, s, sm, o, M, K, N, kb, T,
                                          R, D, st);
  if (L == INT8_CODES)
    return launch_slab_rows<INT8_CODES>(x, x_bf16, codes, scales, q, s, sm, o, M, K, N, kb, T,
                                        R, D, st);
  return launch_slab_rows<TILE_PAIRED>(x, x_bf16, codes, scales, q, s, sm, o, M, K, N, kb, T, R,
                                       D, st);
}

// ---------------------------------------------------------------------------
// kernel T: native Q4_K superblocks, the min term in each group term
// ---------------------------------------------------------------------------

__device__ __forceinline__ float half_bits_to_f32(uint32_t bits) {
  return __half2float(__ushort_as_half((unsigned short)(bits & 0xFFFFu)));
}

// 6-bit scale and min of group j from the 12 scale bytes, as three
// little-endian words (ggml get_scale_min_k4)
__device__ __forceinline__ void scale_min_k4(int j, uint32_t w0, uint32_t w1, uint32_t w2,
                                             int& sc, int& mn) {
  if (j < 4) {
    sc = (w0 >> (8 * j)) & 63;
    mn = (w1 >> (8 * j)) & 63;
  } else {
    const int i = j - 4;
    sc = ((w2 >> (8 * i)) & 0xF) | (((w0 >> (8 * i + 6)) & 3) << 4);
    mn = ((w2 >> (8 * i + 4)) & 0xF) | (((w1 >> (8 * i + 6)) & 3) << 4);
  }
}

// v * f for a 6-bit v, exact (an f16 by a 6-bit integer): 2^23 + v, less
// 2^23, inside one fma
__device__ __forceinline__ float times6(int v, float f) {
  return __fmaf_rn(__int_as_float(0x4B000000 | v), f, __fmul_rn(-8388608.0f, f));
}

// T's weights of groups 2c and 2c + 1 from a superblock's 16-byte header:
// (ws, wm, ws', wm') = (d * sc, dmin * mn) of each, group 2c + 1's ws
// divided by 16 (exact) for its high nibbles' 16-fold dot (mma_u8)
__device__ __forceinline__ float4 x2_decode(const uint4& h, int c) {
  const float d = half_bits_to_f32(h.x), dmin = half_bits_to_f32(h.x >> 16);
  int sc0, mn0, sc1, mn1;
  scale_min_k4(2 * c, h.y, h.z, h.w, sc0, mn0);
  scale_min_k4(2 * c + 1, h.y, h.z, h.w, sc1, mn1);
  return make_float4(times6(sc0, d), times6(mn0, dmin), times6(sc1, __fmul_rn(d, 0.0625f)),
                     times6(mn1, dmin));
}

// the same of groups t and t + 4 (lane t of a quad: one path for every
// lane), both ws divided by 16 where t is odd (odd groups: high nibbles)
__device__ __forceinline__ float4 x2_decode_t(const uint4& h, int t) {
  const float d = half_bits_to_f32(h.x), dmin = half_bits_to_f32(h.x >> 16);
  const float dd = (t & 1) ? __fmul_rn(d, 0.0625f) : d;
  const uint32_t w0 = h.y >> (8 * t), w1 = h.z >> (8 * t), w2 = h.w >> (8 * t);
  return make_float4(times6(w0 & 63, dd), times6(w1 & 63, dmin),
                     times6((w2 & 0xF) | ((w0 >> 2) & 0x30), dd),
                     times6(((w2 >> 4) & 0xF) | ((w1 >> 2) & 0x30), dmin));
}

// T's group term as the parent kernel's compiled code rounds it
// (testing.x2_lane_order, form "fma_xs"): dot * ws rounded, then one fma
// with x's scale and the rounded min product, -(sxm * wm). D is the mma's
// output (1.5 * 2^23 + k * dot, k = 1 or 16, ws already divided by k), so
// dot * ws = fma(D, ws, -(1.5 * 2^23) * ws): the product and the constant
// term exact, one rounding, the same float.
__device__ __forceinline__ float x2_term(int d, float ws, float wm, float xs, float sxm) {
  const float t = __fmaf_rn(__int_as_float(d), ws, __fmul_rn(-12582912.0f, ws));
  return __fmaf_rn(t, xs, -__fmul_rn(sxm, wm));
}

// d = A B + SG_MAGIC as mma_s8, A's codes unsigned: T's high nibbles
// masked in place (16 * code), so that group's dot comes out 16 times over
__device__ __forceinline__ void mma_u8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%10,%10,%10,%10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(SG_MAGIC));
}

// The A fragments of chunk c (32 code bytes) of a slot's superblocks for
// the 16 columns at c0 (a column's 144 bytes at 144 * column: its header,
// then its codes; 144 = 9 * 16, so ldmatrix's 8 rows fall in 8 bank
// groups): the low nibbles (group 2c) and the high ones in place (group 2c
// + 1, 16 * code)
__device__ __forceinline__ void x2_a_frags(uint32_t wbase, int c0, int c, int lane,
                                           uint32_t (&lo)[4], uint32_t (&hi)[4]) {
  const int r8 = lane & 7, m = lane >> 3;
  uint32_t r[4];
  ldsm_x4(wbase + (c0 + r8 + 8 * (m & 1)) * Q4K_BLOCK + 16 + 32 * c + 16 * (m >> 1), r);
#pragma unroll
  for (int i = 0; i < 4; ++i) lo[i] = r[i] & NIB, hi[i] = r[i] & ~NIB;
}

// One slot's superblock for the warp's 16 columns at c0, 2-16 rows: each
// output's four emulated-lane chains, P[o][c] = (P + term(2c)) + term(2c +
// 1). Each header is decoded once per warp: lane (gq, t) decodes groups t
// and t + 4 of columns gq and gq + 8, and chunk c takes groups 2c and 2c +
// 1 from the quad's lanes 2(c & 1) and 2(c & 1) + 1.
template <int MT>
__device__ __forceinline__ void x2_chunk(const uint8_t* sl, int cols, int c0, int lane,
                                         float (&P)[Outs<MT>::NO][4]) {
  using O = Outs<MT>;
  constexpr int NO = O::NO, NP = O::NP, XB = sg_x_bytes(MT), XR = sg_xr(MT);
  const int gq = lane >> 2, t = lane & 3, r8 = lane & 7, m = lane >> 3;
  const int xso = XB + Q4K_BLOCK * cols, sxo = xso + sg_xs_bytes(MT);
  const uint32_t base = tma::smem_addr(sl);
  float4 own[2];  // [column half]: (ws, wm) of groups t, t + 4
#pragma unroll
  for (int h = 0; h < 2; ++h)
    own[h] = x2_decode_t(
        *reinterpret_cast<const uint4*>(sl + XB + (c0 + gq + 8 * h) * Q4K_BLOCK), t);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int src = (lane & ~3) | (2 * (c & 1));
    float4 w[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float a0 = c < 2 ? own[h].x : own[h].z, a1 = c < 2 ? own[h].y : own[h].w;
      w[h] = make_float4(__shfl_sync(0xffffffffu, a0, src), __shfl_sync(0xffffffffu, a1, src),
                         __shfl_sync(0xffffffffu, a0, src + 1),
                         __shfl_sync(0xffffffffu, a1, src + 1));
    }
    uint32_t lo[4], hi[4];
    x2_a_frags(base + XB, c0, c, lane, lo, hi);
    int dl[NP][4], dh[NP][4];
#pragma unroll
    for (int h = 0; h < NP; ++h) {
      uint32_t b[4];  // x's elements 64c .. 64c + 63 of rows 8h ..: groups 2c (b0, b1), 2c + 1
      ldsm_x4(base + (c >> 1) * XR * 128 + tma::swz128(8 * h + r8, 64 * (c & 1) + 16 * m), b);
      mma_u8(dl[h], lo, b[0], b[1]);
      mma_u8(dh[h], hi, b[2], b[3]);
    }
#pragma unroll
    for (int o = 0; o < NO; ++o) {
      const int h = o >> 2, row = 2 * t + O::row_of(o);
      const float4 wc = w[O::col_hi(o)];
      const float2 xv = *reinterpret_cast<const float2*>(sl + xso + row * 32 + 8 * c);
      const float2 sv = *reinterpret_cast<const float2*>(sl + sxo + row * 32 + 8 * c);
      const float tl = x2_term(dl[h][O::dreg(o)], wc.x, wc.y, xv.x, sv.x);
      P[o][c] = __fadd_rn(__fadd_rn(P[o][c], tl), x2_term(dh[h][O::dreg(o)], wc.z, wc.w, xv.y,
                                                          sv.y));
    }
  }
}

// x2_chunk at one row: every B row is x's row 0, so every lane of a quad
// holds its two columns' dots of every group, and lane t runs emulated lane
// c = t's chain alone (P[o]: column gq + 8o), decoding only its own groups
__device__ __forceinline__ void x2_chunk_row(const uint8_t* sl, int c0, int lane, uint32_t xq,
                                             const float* xs, const float* sx, float (&P)[2]) {
  const int gq = lane >> 2, t = lane & 3, m = lane >> 3;
  const uint32_t base = tma::smem_addr(sl);
  int dl[2][4], dh[2][4];  // [column half][chunk]
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    uint32_t lo[4], hi[4], b[4];
    x2_a_frags(base, c0, c, lane, lo, hi);
    ldsm_x4(xq + 64 * c + 16 * m, b);
    int d[4];
    mma_u8(d, lo, b[0], b[1]);
    dl[0][c] = d[0], dl[1][c] = d[2];
    mma_u8(d, hi, b[2], b[3]);
    dh[0][c] = d[0], dh[1][c] = d[2];
  }
  const float2 xv = *reinterpret_cast<const float2*>(xs + 2 * t);
  const float2 sv = *reinterpret_cast<const float2*>(sx + 2 * t);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 w =
        x2_decode(*reinterpret_cast<const uint4*>(sl + (c0 + gq + 8 * h) * Q4K_BLOCK), t);
    P[h] = __fadd_rn(P[h], x2_term(sel4(t, dl[h]), w.x, w.y, xv.x, sv.x));
    P[h] = __fadd_rn(P[h], x2_term(sel4(t, dh[h]), w.z, w.w, xv.y, sv.y));
  }
}

// The slab tree of one output: the butterfly's levels o = 4, 8, 16 over the
// emulated lanes tl = 0..7 of each half (l: lo, the low-nibble groups 0-3;
// h: hi, 4-7), ((v0 + v1) + (v2 + v3)) + ((v4 + v5) + (v6 + v7)), then lo +
// hi; the slabs into run in K order, the first assigned. A leaf is a step's
// partials (x: lo, y: hi) over tl0 (one) or tl0, tl0 + 1 (a pair, already
// summed). Lanes without superblocks are the +0 chains they were.
struct X2Tree {
  float l0, l1, l2, h0, h1, h2, run;
  __device__ __forceinline__ void leaf(int tl0, bool pair, bool first, float x, float y) {
    if (!pair) {
      if (!(tl0 & 1)) {
        l0 = x, h0 = y;
        return;
      }
      x = __fadd_rn(l0, x), y = __fadd_rn(h0, y);
    }
    if (!(tl0 & 2)) {
      l1 = x, h1 = y;
      return;
    }
    x = __fadd_rn(l1, x), y = __fadd_rn(h1, y);
    if (!(tl0 & 4)) {
      l2 = x, h2 = y;
      return;
    }
    x = __fadd_rn(l2, x), y = __fadd_rn(h2, y);
    const float acc = __fadd_rn(x, y);
    run = first ? acc : __fadd_rn(run, acc);
  }
};

// Kernel T. A CTA owns T tiles of 16 columns and runs R consumer warps on
// each (warp = tile * R + r), beside a producer warp. The producer (one
// thread) pushes, per column group and slab, the slab's superblocks
// tl-major: for tl = 0..7 the superblocks tl, tl + 8, .. below kb (an
// emulated lane's chain): slot seq of the CTA's stream. A tile's steps go in
// K order: per slab, where kb <= 8 the pairs of lanes (0, 1), .., (6, 7),
// each a step of at most two slots, else each lane's chain of up to
// ceil(kb / 8) slots. Warp r of a tile takes steps r, r + R, ..., and each
// round of R steps the tile's warps hand their partials to each other and
// fold them as kernel Q's do (a warp waits for a slot by the parity of its
// use, sound while the ring holds a round's slots: D >= R * the slots of a
// step). CTA b takes column groups b, b + gridDim.x, ...
template <int MT>
__global__ void __launch_bounds__((SG_MAX_WARPS + 1) * 32, 1)
x2_gemv_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
               const __grid_constant__ CUtensorMap xsmap, const __grid_constant__ CUtensorMap sxmap,
               float* __restrict__ out, int M, int K, int N, int kb, int T, int R, int D,
               const void* __restrict__ x, int x_bf16, int8_t* __restrict__ xq_out,
               float* __restrict__ xs_out, float* __restrict__ sxm_out) {
  using O = Outs<MT>;
  constexpr int NO = O::NO, XR = sg_xr(MT), XB = sg_x_bytes(MT);
  const int W = T * R, cols = 16 * T, slot = sg_slot_bytes(MT, Q4K_NATIVE, cols);
  const int xso = XB + Q4K_BLOCK * cols;
  extern __shared__ __align__(1024) uint8_t sg_smem[];
  uint8_t* ring = sg_smem + ((1024 - (tma::smem_addr(sg_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + (size_t)D * slot);
  uint64_t* empty = full + D;
  float* xch = reinterpret_cast<float*>(empty + D);  // [2][W][2][NO][32] where R > 1
  // at one row: x's row quantized, its codes [K], scales and sxm [K/32]
  int8_t* x_row = reinterpret_cast<int8_t*>(xch + (R > 1 ? 2 * W * 2 * NO * 32 : 0));
  float* xs_row = reinterpret_cast<float*>(x_row + K);
  float* sxm_row = xs_row + K / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nslab = K / (QK_K * kb), kq = kb >> 3, kr = kb & 7;
  const bool pair = kb <= 8;  // a step: two lanes of one superblock each, else one lane's chain
  const int groups = (N + cols - 1) / cols;
  if (warp == 0) {
    for (int d = lane; d < D; d += 32) {
      tma::bar_init(full + d, 1);
      tma::bar_init(empty + d, T);
    }
    tma::fence_init();
  }
  __syncthreads();

  if (warp == W) {  // the producer: 5 boxes a slot (1 at one row), zeros past M and N
    if (lane == 0) {
      const uint32_t tx = sg_tx_bytes(MT, Q4K_NATIVE, cols);
      if constexpr (MT > 1) asm volatile("griddepcontrol.wait;\n" ::: "memory");  // x's codes
      int d = 0, u = 0;
      for (int g = blockIdx.x; g < groups; g += gridDim.x)
        for (int s = 0; s < nslab; ++s)
          for (int tl = 0; tl < 8; ++tl)
            for (int sb = s * kb + tl; sb < s * kb + kb; sb += 8) {
              if (u) tma::wait(empty + d, (u - 1) & 1);
              uint8_t* sl = ring + (size_t)d * slot;
              tma::arrive_expect(full + d, tx);
              if constexpr (MT > 1) {
                tma::copy2d(sl, &xmap, sb * QK_K, 0, full + d);
                tma::copy2d(sl + XR * 128, &xmap, sb * QK_K + 128, 0, full + d);
                tma::copy2d(sl + xso, &xsmap, sb * 8, 0, full + d);
                tma::copy2d(sl + xso + sg_xs_bytes(MT), &sxmap, sb * 8, 0, full + d);
              }
              tma::copy2d(sl + XB, &wmap, sb * Q4K_BLOCK, g * cols, full + d);
              if (++d == D) d = 0, ++u;
            }
    }
    return;
  }

  if constexpr (MT == 1) {
    quant_row(x, x_bf16, K, warp, W, lane, x_row, xs_row, sxm_row, xq_out, xs_out, sxm_out);
    asm volatile("bar.sync 15, %0;\n" ::"r"(W * 32) : "memory");  // the consumer warps
  }

  const int tile = warp / R, r = warp - tile * R;
  const int gq = lane >> 2, t = lane & 3, c0 = 16 * tile;
  const uint32_t x_row_a = tma::smem_addr(x_row);
  const int per_slab = pair ? 4 : 8, nstep = nslab * per_slab, per_group = nslab * kb;
  const int ds = R / per_slab, di = R - ds * per_slab;  // a round's step in (slab, step)
  unsigned own = 0;                                      // the outputs this warp folds and stores
#pragma unroll
  for (int o = 0; o < NO; ++o) own |= (o % R == r) << o;
  int gbase = 0, buf = 0;
  int seq = 0, d = 0, u = 0;  // a slot of the CTA's stream: seq = u * D + d
  for (int g = blockIdx.x; g < groups; g += gridDim.x, gbase += per_group) {
    X2Tree tr[NO];
    int s = r / per_slab, i = r - (r / per_slab) * per_slab;  // this warp's step: slab s, i
    int sr = 0, ir = 0;                                          // the round's first step
    for (int p0 = 0; p0 < nstep; p0 += R) {
      float x[NO], y[NO];
      if (p0 + r < nstep) {
        const int tl0 = pair ? 2 * i : i;
        int next = gbase + s * kb + tl0 * kq + min(tl0, kr);  // the step's first slot
#pragma unroll 1
        for (int a = 0; a < 1 + pair; ++a) {
          const int tl = tl0 + a, n = (kb - tl + 7) >> 3;  // the lane's superblocks in the slab
          float P[NO][4], P1[2] = {0.0f, 0.0f};
#pragma unroll
          for (int o = 0; o < NO; ++o)
#pragma unroll
            for (int c = 0; c < 4; ++c) P[o][c] = 0.0f;
#pragma unroll 1
          for (int j = 0; j < n; ++j, ++next) {
            for (d += next - seq, seq = next; d >= D; d -= D) ++u;
            tma::wait(full + d, u & 1);
            const uint8_t* sl = ring + (size_t)d * slot;
            if constexpr (MT == 1) {
              const int sb = s * kb + 8 * j + tl;
              x2_chunk_row(sl, c0, lane, x_row_a + sb * QK_K, xs_row + sb * 8, sxm_row + sb * 8,
                           P1);
            } else {
              x2_chunk<MT>(sl, cols, c0, lane, P);
            }
            __syncwarp();
            if (lane == 0) tma::arrive(empty + d);
          }
#pragma unroll
          for (int o = 0; o < NO; ++o) {
            float vl, vh;  // the lane's butterfly level o = 1: P(c = 0) + P(1), P(2) + P(3)
            if constexpr (MT == 1) {
              // lane t holds chain c = t: lanes 0, 1 give lo, lanes 2, 3 hi
              vl = vh = __fadd_rn(P1[o], __shfl_xor_sync(0xffffffffu, P1[o], 1));
            } else {
              vl = __fadd_rn(P[o][0], P[o][1]), vh = __fadd_rn(P[o][2], P[o][3]);
            }
            x[o] = a ? __fadd_rn(x[o], vl) : vl;
            y[o] = a ? __fadd_rn(y[o], vh) : vh;
          }
        }
        if constexpr (MT == 1) {  // each lane's half: lo into x on every lane, hi into y
#pragma unroll
          for (int o = 0; o < NO; ++o) {
            const float other = __shfl_xor_sync(0xffffffffu, x[o], 2), mine = x[o];
            x[o] = t < 2 ? mine : other;
            y[o] = t < 2 ? other : mine;
          }
        }
        if (R == 1) {
#pragma unroll
          for (int o = 0; o < NO; ++o) tr[o].leaf(tl0, pair, s == 0, x[o], y[o]);
        }
      }
      if (R > 1) {  // the round's partials to every warp of the tile; each folds its outputs'
        float* mine = xch + ((size_t)(buf * W + warp) * 2 * NO) * 32 + lane;
        if (p0 + r < nstep) {
#pragma unroll
          for (int o = 0; o < NO; ++o) mine[o * 32] = x[o], mine[(NO + o) * 32] = y[o];
        }
        asm volatile("bar.sync %0, %1;\n" ::"r"(1 + tile), "r"(R * 32) : "memory");
        int sj = sr, ij = ir;  // steps p0 .. p0 + R - 1: warps tile * R + j
        for (int j = 0; j < R && p0 + j < nstep; ++j) {
          const float* th = xch + ((size_t)(buf * W + tile * R + j) * 2 * NO) * 32 + lane;
#pragma unroll
          for (int o = 0; o < NO; ++o)
            if (own >> o & 1)
              tr[o].leaf(pair ? 2 * ij : ij, pair, sj == 0, th[o * 32], th[(NO + o) * 32]);
          if (++ij == per_slab) ij = 0, ++sj;
        }
        buf ^= 1;
      }
      sr += ds, ir += di;
      if (ir >= per_slab) ir -= per_slab, ++sr;
      s += ds, i += di;
      if (i >= per_slab) i -= per_slab, ++s;
    }
#pragma unroll
    for (int o = 0; o < NO; ++o) {
      const int row = 2 * t + O::row_of(o), n = g * cols + c0 + gq + 8 * O::col_hi(o);
      if ((own >> o & 1) && row < M && n < N) out[(size_t)row * N + n] = tr[o].run;
    }
  }
}

// the activation prologue (a launch of its own at 2..16 rows; at one row
// the kernel quantizes x itself), then kernel T
template <int MT>
int launch_x2(const void* x, int x_bf16, const void* blocks, int8_t* xq, float* xs, float* sxm,
              float* out, int M, int K, int N, int kb, int T, int R, int D, cudaStream_t st) {
  constexpr int XR = sg_xr(MT);
  const int cols = 16 * T;
  const size_t smem = sg_smem_bytes(MT, Q4K_NATIVE, T, R, D, K);
  if (smem > (size_t)SG_SMEM_MAX) return (int)cudaErrorInvalidValue;
  // the superblocks [N][K/256 * 144] bytes in boxes of one superblock of
  // the CTA's columns (unswizzled: a column's 144 bytes, header and codes);
  // x's codes [M][K] in 128-byte boxes (128-byte swizzle), its scales and
  // sxm [M][K/32] f32 in boxes of 8 groups
  const cuuint64_t G = K / 32, rb = (cuuint64_t)(K / QK_K) * Q4K_BLOCK;
  const cuuint64_t wd[2] = {rb, (cuuint64_t)N}, wst[1] = {rb};
  const cuuint64_t xd[2] = {(cuuint64_t)K, (cuuint64_t)M}, xst[1] = {(cuuint64_t)K};
  const cuuint64_t xsd[2] = {G, (cuuint64_t)M}, xsst[1] = {G * 4};
  const cuuint32_t wbox[2] = {Q4K_BLOCK, (cuuint32_t)cols};
  const cuuint32_t xbox[2] = {128, XR}, xsbox[2] = {8, XR};
  CUtensorMap xmap{}, wmap{}, xsmap{}, sxmap{};
  int rc = tma::encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, blocks, wd, wst, wbox);
  if (MT > 1) {
    if (!rc) rc = tma::encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, xq, xd, xst, xbox,
                              CU_TENSOR_MAP_SWIZZLE_128B);
    if (!rc) rc = tma::encode(&xsmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, xs, xsd, xsst, xsbox);
    if (!rc) rc = tma::encode(&sxmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, sxm, xsd, xsst, xsbox);
  }
  if (rc) return rc;
  cudaError_t err = cudaFuncSetAttribute(x2_gemv_kernel<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int groups = (N + cols - 1) / cols;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(min(groups, sms));
  cfg.blockDim = dim3((T * R + 1) * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  if (MT > 1) {  // the quantizer, then this launch as its programmatic dependent
    acts::launch_quant_acts(x, x_bf16, M, K, xq, xs, sxm, st);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  err = cudaLaunchKernelEx(&cfg, x2_gemv_kernel<MT>, xmap, wmap, xsmap, sxmap, out, M, K, N, kb,
                           T, R, D, x, x_bf16, xq, xs, sxm);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the slots of one of T's steps at most: two where kb <= 8, else ceil(kb / 8)
__host__ __device__ constexpr int x2_step_slots(int kb) { return kb <= 8 ? 2 : (kb + 7) / 8; }

// the row template of M rows (1, 2, 4, 8 or 16)
constexpr int sg_mt(int M) { return M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : M <= 8 ? 8 : 16; }

}  // namespace

extern "C" {

// Kernel Q: x [M, K] bf16 or f32 (1 <= M <= 16, K % (256*kb) == 0, 1 <= kb
// <= 8); codes [N, K/2] (A's layout), scales [N, K/32] bf16; x, codes and
// scales 16-byte aligned. The plan (quant_matmul.slab_plan): T tiles of 16 columns a CTA,
// R warps a tile (T * R <= 8), D ring slots (2 to 32, at least R, 2R where
// kb > 1: a round of the tile's warps, two slots a step). out [M, N] f32 is
// the positive part summed per slab of kb superblocks; xq / xs / sxm are
// the prologue's outputs. The plan moves no bit.
int w4a8_slab_launch(const void* x, int x_bf16, const void* codes, const void* scales, int T,
                     int R, int D, int kb, void* xq, void* xs, void* sxm, void* out, int M,
                     int K, int N, void* stream) {
  return launch_w4a8_slab(x, x_bf16, codes, scales, GROUP_PAIRED, T, R, D, kb, xq, xs, sxm,
                          out, M, K, N, stream);
}

// Kernel T: x [M, K] bf16 or f32 (1 <= M <= 16, K % 256 == 0); blocks [N,
// K/256 * 144] the native Q4_K superblocks (16-byte aligned), summed per
// slab of kb superblocks (a multiple of 8 that divides K/256, or K/256: the
// whole K as one slab); the plan (T, R, D) as kernel Q's, but a round of a
// tile's warps takes up to R * x2_step_slots(kb) slots (D at least that
// where R > 1). out [M, N] f32 holds the whole product, the min term in each
// group term; xq / xs / sxm are the prologue's outputs. The plan moves no
// bit.
int w4a8k4_slab_launch(const void* x, int x_bf16, const void* blocks, int T, int R, int D,
                       int kb, void* xq, void* xs, void* sxm, void* out, int M, int K, int N,
                       void* stream) {
  const int nsb = K / QK_K;
  if (M < 1 || M > 16 || N < 1 || K < QK_K || K % QK_K || kb < 1 || nsb % kb ||
      (kb % 8 && kb != nsb) || T < 1 || R < 1 || T * R > SG_MAX_WARPS || D < 2 ||
      (R > 1 && D < R * x2_step_slots(kb)) || D > SG_MAX_SLOTS ||
      ((reinterpret_cast<uintptr_t>(blocks) | reinterpret_cast<uintptr_t>(x)) & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(xq);
  float* s = static_cast<float*>(xs);
  float* sm = static_cast<float*>(sxm);
  float* o = static_cast<float*>(out);
#define X2_ROWS(MT) launch_x2<MT>(x, x_bf16, blocks, q, s, sm, o, M, K, N, kb, T, R, D, st)
  if (M <= 1) return X2_ROWS(1);
  if (M <= 2) return X2_ROWS(2);
  if (M <= 4) return X2_ROWS(4);
  if (M <= 8) return X2_ROWS(8);
  return X2_ROWS(16);
#undef X2_ROWS
}

// The sizes the launches use, for quant_matmul.slab_slot_bytes and
// slab_smem to be held to: the bytes of a slot of M rows, codes of layout L
// (0 Q's group-paired, 1 V's int8, 2 V's tile-paired, 3 T's superblocks)
// and cols columns; a CTA's dynamic shared memory under plan (T, R, D) for
// x's width K.
int slab_slot_size(int M, int L, int cols) { return sg_slot_bytes(sg_mt(M), L, cols); }

int slab_smem_size(int M, int L, int T, int R, int D, int K) {
  return (int)sg_smem_bytes(sg_mt(M), L, T, R, D, K);
}

// Kernel V: as kernel Q on int8 codes [N, K] (packed = 0) or tile-paired
// uint8 [N, K/2] (packed = 1), summed per slab of kb tiles; both layouts
// give the same bits.
int w4a8_plane_launch(const void* x, int x_bf16, const void* codes, int packed,
                      const void* scales, int T, int R, int D, int kb, void* xq, void* xs,
                      void* sxm, void* out, int M, int K, int N, void* stream) {
  return launch_w4a8_slab(x, x_bf16, codes, scales, packed ? TILE_PAIRED : INT8_CODES, T, R, D,
                          kb, xq, xs, sxm, out, M, K, N, stream);
}

}  // extern "C"
