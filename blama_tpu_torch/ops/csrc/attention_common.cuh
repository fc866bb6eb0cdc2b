// Flash attention over the position-mapped KV store, for Hopper (sm_90a),
// CUDA C++: the device code shared by the dense kernels C, D, N, O and P
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
// Head dims: any even D <= 256. Each body is built at a padded width DP of
// 64, 128 or 256 (the smallest that holds D) and takes the true D at run
// time: q, K, V and the frequencies read zeros past D, so the padded dims
// add exact zeros to every dot and rotate zeros, and only the first D
// outputs are written. Any number of query heads per kv head.
//
// Addressing is the only difference between dense and paged: a kernel walks
// the LOGICAL slots of a row, and an address functor maps a logical slot to
// its physical slot in the store (dense: b*S + s; paged: page_table[b][s /
// G] * G + s % G, or "unmapped"). Everything after the address is the same
// code, so a paged row gives the same bits as the dense row with the same
// logical content, wherever its pages lie.
//
// Decode (kernels C, E, N, P): its own section below. Head-batched decode
// (kernel O) is a different walk with its own split and tile, numerics of
// its own: its section below.
//
// Prefill (kernels D and F): bound by operations at the bf16 tensor rate
// for chunks of 128 tokens or more; a tensor-core body of its own, in its
// section below.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace attn {

constexpr int MAX_SMEM = 227 * 1024;   // dynamic shared memory a block can take
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// --- element types of the store ---------------------------------------------

// four consecutive elements as floats
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
// two consecutive elements (a rope pair) as floats: a head dim that is not
// a multiple of 4 leaves rows aligned to a pair only
__device__ __forceinline__ void load2(const int8_t* p, float (&o)[4], int at) {
  const int w = *reinterpret_cast<const short*>(p);
  o[at] = (float)(int8_t)(w & 0xff);
  o[at + 1] = (float)(int8_t)((w >> 8) & 0xff);
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float (&o)[4], int at) {
  const unsigned w = *reinterpret_cast<const unsigned*>(p);
  o[at] = __uint_as_float(w << 16);
  o[at + 1] = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void load2(const float* p, float (&o)[4], int at) {
  const float2 w = *reinterpret_cast<const float2*>(p);
  o[at] = w.x;
  o[at + 1] = w.y;
}

// N consecutive elements of type KV at shared address p (N * sizeof(KV)
// bytes, aligned to that size or to 16), as floats
template <int N, class KV>
__device__ __forceinline__ void load_elems(const unsigned char* p, float (&x)[N]) {
  constexpr int NB = N * (int)sizeof(KV);
  static_assert(NB == 2 || NB % 4 == 0, "whole 32-bit words or one pair of int8");
  unsigned w[NB >= 4 ? NB / 4 : 1];
  if constexpr (NB == 2) {
    w[0] = *reinterpret_cast<const unsigned short*>(p);
  } else if constexpr (NB == 4) {
    w[0] = *reinterpret_cast<const unsigned*>(p);
  } else if constexpr (NB == 8) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    w[0] = t.x;
    w[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < NB / 16; ++i) {
      const uint4 t = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = t.x;
      w[4 * i + 1] = t.y;
      w[4 * i + 2] = t.z;
      w[4 * i + 3] = t.w;
    }
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if constexpr (std::is_same<KV, int8_t>::value)
      x[k] = (float)(int8_t)((w[k >> 2] >> (8 * (k & 3))) & 0xffu);
    else if constexpr (std::is_same<KV, __nv_bfloat16>::value)
      x[k] = __uint_as_float(k & 1 ? (w[k >> 1] & 0xffff0000u) : (w[k >> 1] << 16));
    else
      x[k] = __uint_as_float(w[k]);
  }
}

// --- cp.async ------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
// N bytes from global to shared memory, or N zero bytes when !full (a
// source size of 0 reads nothing)
template <int N>
__device__ __forceinline__ void cp_zfill(void* dst, const void* src, bool full) {
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(full ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "n"(N), "r"(full ? N : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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
// (write != 0) also writes them to the store. `k`/`v` alias the store the
// kernel reads: the only slot P writes is one no block reads (the patched
// slot comes from shared memory, the spare slot is never read). slot ==
// nullptr: kernel C or E. RT is the rows' type, the model's activation type
// (the queries'): bf16, or f32 for an f32 model.
template <class KV, class RT = __nv_bfloat16>
struct Fresh {
  const RT* k_new;              // [B, Hkv, D]
  const RT* v_new;
  const int* slot;              // [B] the row's slot (>= S: a pad row)
  KV* k;                        // write mode: the store, [slots(+1), Hkv, D]
  KV* v;
  float* ks;                    // [slots(+1), Hkv] (int8 store), else null
  float* vs;
  long long pad_slot;           // the store's spare slot (pad rows' writes)
  int write;
};

// the stored form of an f32 value in a float store type (and in the query /
// output type QT of the attention bodies: bf16, or f32 for an f32 model)
__device__ __forceinline__ void from_f(float x, __nv_bfloat16& o) { o = __float2bfloat16_rn(x); }
__device__ __forceinline__ void from_f(float x, float& o) { o = x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(float x) { return x; }

// One block stages a [D] row of type RT (bf16 or f32) as the store holds
// it, zeros up to DP: for int8, codes and the scale by
// ops/kv_cache.quantize_kv's formula on the row's f32 values (max-abs over
// the row, amax / 127 and 1 / scale as IEEE divisions, round half to even);
// for a float store the values in its type (an f32 value into a bf16 store
// rounded to nearest even, anything else exact) and the scale 1. Every
// thread returns the scale; `red` holds one float per warp.
template <int DP, class KV, class RT>
__device__ float stage_row(const RT* __restrict__ src, KV* dst, float* red, int D) {
  if constexpr (std::is_same<KV, int8_t>::value) {
    float amax = 0.0f;
    for (int d = threadIdx.x; d < D; d += blockDim.x)
      amax = fmaxf(amax, fabsf(to_f(src[d])));
    amax = warp_max(amax);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
    __syncthreads();
    amax = red[0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) amax = fmaxf(amax, red[w]);
    __syncthreads();
    const float sc = amax / 127.0f;
    const float inv = sc > 0.0f ? 1.0f / sc : 0.0f;
    for (int d = threadIdx.x; d < DP; d += blockDim.x)
      dst[d] = d < D ? (int8_t)__float2int_rn(to_f(src[d]) * inv) : (int8_t)0;
    return sc;
  } else {
    for (int d = threadIdx.x; d < DP; d += blockDim.x) {
      if (d < D)
        from_f(to_f(src[d]), dst[d]);
      else
        from_f(0.0f, dst[d]);
    }
    return 1.0f;
  }
}

// ---------------------------------------------------------------------------
// decode (one query token per row): kernels C, E, N and P
// ---------------------------------------------------------------------------
// Replaces blama_tpu/ops/pallas/decode_attention.py:106 _decode_attn_kernel
// (kernel C, dense rows; with `fresh=True` kernel N), :578
// _decode_attn_write_kernel (kernel P) and paged_attention.py:155
// _paged_attn_kernel in its decode form (kernel E, the paged pool).
//
// Bound by bytes: each visible slot's K and V are read once, ~2 flops a
// byte, so the design is about bytes in flight and latency. One CTA of four
// warps per (row, kv head, chunk of GC = 4 or 8 of its query heads, split):
//   * splits are cut at fixed logical slots, every `split` slots from 0 (a
//     constant of the host's, ops/decode_attention.DECODE_SPLIT), and tiles
//     of TS slots at fixed places inside a split, so a row's output depends
//     only on its own q, position and logical store: not on B, the other
//     rows, the head chunk or empty slots past its last visible one;
//   * a prologue reads the split's positions (and scales) once, through the
//     address functor, and lists the tiles some slot of which the query
//     sees; only those are staged. A `cp.async` ring of STAGES tiles (K and
//     V rows as stored, 16-byte pieces where the row allows) brings the next
//     tiles while this one is scored; a slot the query cannot see is staged
//     as zeros without reading it;
//   * scoring spreads the dims over lanes: L = DP / 32 lanes own a slot,
//     each 32 of its dims; a lane rotates its piece of K in registers (one
//     sincosf per pair, the formula of the TPU kernels), dots it with every
//     query head of the chunk (the heads reuse each staged K), and the L
//     partial dots end in a fixed xor-butterfly. A warp scores SP = 32 / L
//     slots of a tile at once and keeps its own online-softmax state per
//     head; P.V runs with the lanes over the dims (DP / 32 each), the
//     tile's probabilities x V scale shared through shared memory;
//   * at the end the four warps' states fold in warp order, and the split's
//     (m, l, acc) is written; the last CTA of a (row, kv head, chunk) to
//     finish (an atomic ticket, which adds nothing to any sum) folds all
//     splits in split order, passing over the splits the query did not see,
//     and writes the output: one launch a call, no atomics in any sum, so a
//     replay on the same card gives the same bits. One split: the output at
//     once.
// Kernels N and P: the row's fresh K/V row (an operand) is quantized exactly
// as the cache write does into shared memory and read in place of its slot
// by the CTAs whose split holds it; P also stores it (codes and scales) at
// the slot, a pad row's (slot >= S) at the spare slot, from split 0. The
// slot then holds what a cache write would have left, and everything else is
// C's code, so N and P give C's bits after that write.

constexpr int DEC_WARPS = 4;
constexpr int DEC_THREADS = 32 * DEC_WARPS;
constexpr int DEC_GRAIN = 64;    // a split is a multiple of it (of every tile)

template <int DP, class KV, int GC_ = 4>
struct DecShape {
  static constexpr int ES = sizeof(KV);
  static constexpr int L = DP / 32;             // lanes scoring one slot
  static constexpr int SP = 32 / L;             // slots a warp scores at once
  static constexpr int TS = DEC_WARPS * SP;     // slots per tile
  static constexpr int CE = 16 / ES;            // elements per 16-byte piece
  static constexpr int LCH = DP * ES / 16 / L;  // pieces a lane scores
  static constexpr int KE = LCH * CE;           // dims a lane scores (32)
  static constexpr int VW = DP / 32;            // dims a lane owns in P.V
  static constexpr int GC = GC_;                // query heads per CTA
  static constexpr int STAGES = ES == 4 ? 2 : 3;
  // bytes per staged row; the pad puts the slots a quarter-warp reads at once
  // on distinct banks
  static constexpr int PITCH = DP * ES + (L < 8 ? 16 * L : 16);
  static constexpr int TPR = DEC_THREADS / (2 * TS);   // threads staging a row
  static_assert(KE == 32 && TS % 4 == 0 && DEC_GRAIN % TS == 0, "decode tile shape");
};

template <class KV, class QT = __nv_bfloat16>
struct DecArgs {
  const QT* q;               // [B, H, D] rotated queries (bf16, or f32)
  const KV* k;               // the store
  const KV* v;
  const float* ks;           // its scales (int8), else null
  const float* vs;
  const int* kv_pos;         // position map of the store
  const int* q_pos;          // [B]
  const float* invf;         // [D]
  float* part_m;             // [B, H, nsplit] (nsplit > 1)
  float* part_l;
  float* part_acc;           // [B, H, nsplit, D]
  int* tickets;              // [B * Hkv * chunks], 0 between calls
  QT* out;                   // [B, H, D] in the queries' type
  int H, Hkv, D, S, split, piece;   // piece: bytes a cp.async moves (16, 8, 4; 2: plain copies)
  float scale;
  Fresh<KV, QT> fresh;       // the fresh rows are in the queries' type
};

// Shared memory of one CTA; every section 16-byte aligned. After the tile
// loop the warps' states (m, l [WARPS][GC], acc [WARPS][GC][DP]) lie over
// the ring.
template <int DP, class KV, int GC>
struct DecSmem {
  using Sh = DecShape<DP, KV, GC>;
  unsigned char* ring;   // [STAGES][2][TS][PITCH]: K rows, then V rows, as stored
  float* q;              // [GC][DP] the chunk's queries, in the scoring lanes' order
  float* invf;           // [DP]
  KV* fk;                // [DP] the fresh row as stored (kernels N and P)
  KV* fv;
  int* pos;              // [split] a slot's position if the query sees it, else -1
  int* phys;             // [split] its physical slot, -1 when it is not staged
  float* ks;             // [split] its scales (0 where not seen)
  float* vs;
  int* tiles;            // [split / TS + 1] the seen tiles in slot order, then their count
  float* pv;             // [WARPS][GC][SP] a tile's probabilities x V scale
  float* red;            // [33] stage_row's reduction; red[32]: the last-CTA flag
  float* fold;           // [2][GC][nsplit] the last CTA's m then weights, l; [GC] sums
  __host__ __device__ static size_t offsets(int split, int nsplit, size_t (&o)[14]) {
    const size_t size[13] = {(size_t)Sh::STAGES * 2 * Sh::TS * Sh::PITCH,
                             sizeof(float) * Sh::GC * DP,
                             sizeof(float) * DP,
                             sizeof(KV) * DP,
                             sizeof(KV) * DP,
                             sizeof(int) * split,
                             sizeof(int) * split,
                             sizeof(float) * split,
                             sizeof(float) * split,
                             sizeof(int) * (split / Sh::TS + 1),
                             sizeof(float) * DEC_WARPS * Sh::GC * Sh::SP,
                             sizeof(float) * 33,
                             sizeof(float) * Sh::GC * (2 * (size_t)nsplit + 1)};
    size_t n = 0;
    for (int i = 0; i < 13; ++i) {
      o[i] = n;
      n += (size[i] + 15) / 16 * 16;
    }
    o[13] = n;
    return n;
  }
  static size_t bytes(int split, int nsplit) {
    size_t o[14];
    return offsets(split, nsplit, o);
  }
  __device__ DecSmem(unsigned char* base, int split, int nsplit) {
    size_t o[14];
    offsets(split, nsplit, o);
    ring = base + o[0];
    q = reinterpret_cast<float*>(base + o[1]);
    invf = reinterpret_cast<float*>(base + o[2]);
    fk = reinterpret_cast<KV*>(base + o[3]);
    fv = reinterpret_cast<KV*>(base + o[4]);
    pos = reinterpret_cast<int*>(base + o[5]);
    phys = reinterpret_cast<int*>(base + o[6]);
    ks = reinterpret_cast<float*>(base + o[7]);
    vs = reinterpret_cast<float*>(base + o[8]);
    tiles = reinterpret_cast<int*>(base + o[9]);
    pv = reinterpret_cast<float*>(base + o[10]);
    red = reinterpret_cast<float*>(base + o[11]);
    fold = reinterpret_cast<float*>(base + o[12]);
  }
  static_assert(sizeof(float) * DEC_WARPS * Sh::GC * (DP + 2) <=
                    (size_t)Sh::STAGES * 2 * Sh::TS * Sh::PITCH,
                "the warps' states fit over the ring");
};

// where dim d of query head g lies in shared memory: in the order the
// scoring lanes read it, so the L lanes of a slot read 16 consecutive bytes
// each (no bank conflict) and the slots of a warp share them
template <int DP, class KV>
__device__ __forceinline__ int dec_qidx(int g, int d) {
  using Sh = DecShape<DP, KV>;   // the lanes' order does not depend on GC
  const int c = d / Sh::CE, e = d % Sh::CE;
  return g * DP + (((c / Sh::L) * (Sh::CE / 4) + e / 4) * Sh::L + c % Sh::L) * 4 + e % 4;
}

// sincosf out of line: the calls run one after another anyway (its slow-path
// branch keeps them from overlapping), and one copy of its code instead of
// sixteen a tile leaves the kernel small enough to fetch quickly from a
// cold L2 (8% of a one-row call on an H100)
static __device__ __noinline__ float2 dec_sincos(float x) {
  float s, c;
  sincosf(x, &s, &c);
  return make_float2(s, c);
}

template <int DP, class KV, class Addr, int GCT, class QT>
__global__ void __launch_bounds__(DEC_THREADS) decode_kernel(const DecArgs<KV, QT> a,
                                                             const Addr addr) {
  using Sh = DecShape<DP, KV, GCT>;
  constexpr int L = Sh::L, SP = Sh::SP, TS = Sh::TS, CE = Sh::CE, LCH = Sh::LCH, KE = Sh::KE;
  constexpr int VW = Sh::VW, GC = Sh::GC, ST = Sh::STAGES, PITCH = Sh::PITCH, ES = Sh::ES;
  constexpr int TPR = Sh::TPR;
  extern __shared__ __align__(16) unsigned char dec_raw[];
  const DecSmem<DP, KV, GC> sm(dec_raw, a.split, gridDim.y);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = a.H / a.Hkv, nhc = (G + GC - 1) / GC;
  const int b = blockIdx.x / (a.Hkv * nhc), hk = blockIdx.x / nhc % a.Hkv;
  const int hc = blockIdx.x % nhc;
  const int h0 = hk * G + hc * GC, gn = min(GC, G - hc * GC);
  const int sp = blockIdx.y, nsplit = gridDim.y;
  const int s0 = sp * a.split, nslots = min(a.S, s0 + a.split) - s0;
  const int ntiles = (nslots + TS - 1) / TS;
  const int D = a.D, qpos = a.q_pos[b];

  // the chunk's queries and the frequencies (zeros past D and past gn),
  // loaded here and stored after the split's positions are read, so the
  // loads are in flight together
  constexpr int QPER = GC * DP / DEC_THREADS;
  float qv[QPER];
#pragma unroll
  for (int i = 0; i < QPER; ++i) {
    const int e = tid + i * DEC_THREADS, g = e / DP, d = e % DP;
    qv[i] = g < gn && d < D ? to_f(a.q[((size_t)b * a.H + h0 + g) * D + d]) : 0.0f;
  }
  constexpr int FPER = (DP + DEC_THREADS - 1) / DEC_THREADS;
  float fq[FPER];
#pragma unroll
  for (int i = 0; i < FPER; ++i) {
    const int d = tid + i * DEC_THREADS;
    fq[i] = d < D ? a.invf[d] : 0.0f;
  }
  if (D < DP) {   // the ring's dims past D stay zero: the copies write [0, D)
    constexpr int n16 = ST * 2 * TS * PITCH / 16;
    for (int e = tid; e < n16; e += DEC_THREADS)
      reinterpret_cast<uint4*>(sm.ring)[e] = make_uint4(0u, 0u, 0u, 0u);
  }

  // kernels N and P: the fresh row, staged where its slot lies (and stored)
  int sl = -1;
  float fks = 0.0f, fvs = 0.0f;
  if (a.fresh.slot) {
    sl = a.fresh.slot[b];
    const bool here = sl >= s0 && sl < s0 + nslots;
    const bool writer = a.fresh.write && hc == 0 && (here || (sl >= a.S && sp == 0));
    if (here || writer) {                   // block-uniform
      const size_t src = ((size_t)b * a.Hkv + hk) * D;
      fks = stage_row<DP, KV, QT>(a.fresh.k_new + src, sm.fk, sm.red, D);
      fvs = stage_row<DP, KV, QT>(a.fresh.v_new + src, sm.fv, sm.red, D);
      __syncthreads();
      if (writer) {
        const long long slot = sl < a.S ? (long long)b * a.S + sl : a.fresh.pad_slot;
        const size_t dst = ((size_t)slot * a.Hkv + hk) * D;
        for (int d = tid; d < D; d += DEC_THREADS) {
          a.fresh.k[dst + d] = sm.fk[d];
          a.fresh.v[dst + d] = sm.fv[d];
        }
        if (a.fresh.ks && tid == 0) {
          a.fresh.ks[(size_t)slot * a.Hkv + hk] = fks;
          a.fresh.vs[(size_t)slot * a.Hkv + hk] = fvs;
        }
      }
    }
    if (!here) sl = -1;
  }

  // the split's positions and scales; the fresh slot is seen but not staged
#pragma unroll 2
  for (int j = tid; j < ntiles * TS; j += DEC_THREADS) {
    int p = -1, ph = -1;
    float ksc = 0.0f, vsc = 0.0f;
    const long long base = j < nslots ? addr.tile_base(b, s0 + j) : -1;
    if (base >= 0) {   // the position and the scales load side by side
      const int pp = a.kv_pos[base];
      const float kq = a.ks ? a.ks[(size_t)base * a.Hkv + hk] : 1.0f;
      const float vq = a.vs ? a.vs[(size_t)base * a.Hkv + hk] : 1.0f;
      if (pp >= 0 && pp <= qpos) {
        p = pp;
        const bool fresh = s0 + j == sl;
        ph = fresh ? -1 : (int)base;
        ksc = fresh ? fks : kq;
        vsc = fresh ? fvs : vq;
      }
    }
    sm.pos[j] = p;
    sm.phys[j] = ph;
    sm.ks[j] = ksc;
    sm.vs[j] = vsc;
  }
#pragma unroll
  for (int i = 0; i < QPER; ++i) {
    const int e = tid + i * DEC_THREADS;
    sm.q[dec_qidx<DP, KV>(e / DP, e % DP)] = qv[i];
  }
#pragma unroll
  for (int i = 0; i < FPER; ++i)
    if (tid + i * DEC_THREADS < DP) sm.invf[tid + i * DEC_THREADS] = fq[i];
  __syncthreads();
  if (warp == 0) {     // the tiles the query sees, in slot order
    int n = 0;
    for (int base = 0; base < ntiles; base += 32) {
      bool f = false;
      if (base + lane < ntiles) {
        const int4* pt = reinterpret_cast<const int4*>(sm.pos + (base + lane) * TS);
#pragma unroll 4
        for (int i = 0; i < TS / 4; ++i) {
          const int4 p = pt[i];
          f |= p.x >= 0 || p.y >= 0 || p.z >= 0 || p.w >= 0;
        }
      }
      const unsigned bal = __ballot_sync(FULL, f);
      if (f) sm.tiles[n + __popc(bal & ((1u << lane) - 1u))] = base + lane;
      n += __popc(bal);
    }
    if (lane == 0) sm.tiles[ntiles] = n;
  }
  __syncthreads();
  const int nvis = sm.tiles[ntiles];

  // cp.async of seen tile n into ring stage st: K rows, then V rows, TPR
  // threads a row; slots not staged become zeros
  const int rowb = D * ES, npc = rowb / a.piece;
  auto fetch = [&](int n, int st) {
    if (n < nvis) {
      const int jb = sm.tiles[n] * TS;
      unsigned char* dst0 = sm.ring + (size_t)st * 2 * TS * PITCH;
      for (int r = tid / TPR; r < 2 * TS; r += DEC_THREADS / TPR) {
        const int j = r % TS;
        const int ph = sm.phys[jb + j];
        const unsigned char* src =
            reinterpret_cast<const unsigned char*>(r < TS ? a.k : a.v) +
            (ph >= 0 ? ((size_t)ph * a.Hkv + hk) * rowb : 0);
        unsigned char* dst = dst0 + (size_t)r * PITCH;
        const bool full = ph >= 0;
        for (int c = tid % TPR; c < npc; c += TPR) {
          const int off = c * a.piece;
          switch (a.piece) {
            case 16: cp_zfill<16>(dst + off, src + off, full); break;
            case 8: cp_zfill<8>(dst + off, src + off, full); break;
            case 4: cp_zfill<4>(dst + off, src + off, full); break;
            default:
              *reinterpret_cast<unsigned short*>(dst + off) =
                  full ? *reinterpret_cast<const unsigned short*>(src + off) : (unsigned short)0;
          }
        }
      }
    }
    cp_commit();
  };

  // this lane's slot in a warp's pass, its pieces' column, their frequencies
  const int qd = lane % L, sj = lane / L;
  float fr[KE / 2];
#pragma unroll
  for (int i = 0; i < LCH; ++i)
#pragma unroll
    for (int e = 0; e < CE / 2; ++e) fr[i * CE / 2 + e] = sm.invf[(qd + L * i) * CE + 2 * e];
  float m[GC], l[GC], acc[GC][VW];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.0f;
#pragma unroll
    for (int u = 0; u < VW; ++u) acc[g][u] = 0.0f;
  }
  float* pv = sm.pv + warp * GC * SP;

#pragma unroll
  for (int f = 0; f < ST - 1; ++f) fetch(f, f);
  for (int n = 0; n < nvis; ++n) {
    cp_wait<ST - 2>();
    __syncthreads();
    fetch(n + ST - 1, (n + ST - 1) % ST);
    const int jt = sm.tiles[n] * TS + warp * SP;    // the warp's first slot in the split
    const int p = sm.pos[jt + sj];
    if (!__any_sync(FULL, p >= 0)) continue;        // nothing of this warp's is seen
    const unsigned char* kt = sm.ring + (size_t)(n % ST) * 2 * TS * PITCH + warp * SP * PITCH;
    const unsigned char* vt = kt + TS * PITCH;
    const unsigned char* krow = s0 + jt + sj == sl
                                    ? reinterpret_cast<const unsigned char*>(sm.fk)
                                    : kt + sj * PITCH;
    // the lane's piece of K, rotated in registers
    float kr[KE];
    if (p >= 0) {
#pragma unroll
      for (int i = 0; i < LCH; ++i) {
        float x[CE];
        load_elems<CE, KV>(krow + (qd + L * i) * 16, x);
#pragma unroll
        for (int e = 0; e < CE / 2; ++e) {
          const float2 sc = dec_sincos((float)p * fr[i * CE / 2 + e]);
          const float sn = sc.x, cs = sc.y;
          kr[i * CE + 2 * e] = x[2 * e] * cs + x[2 * e + 1] * (-sn);
          kr[i * CE + 2 * e + 1] = x[2 * e + 1] * cs + x[2 * e] * sn;
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < KE; ++e) kr[e] = 0.0f;
    }
    // its dots with every head of the chunk (a head past gn has a zero
    // query), then the slot's butterfly; each step runs over all heads at
    // once, so the heads' chains overlap
    float dot[GC];
#pragma unroll
    for (int g = 0; g < GC; ++g) dot[g] = 0.0f;
#pragma unroll
    for (int i = 0; i < LCH; ++i)
#pragma unroll
      for (int mm = 0; mm < CE / 4; ++mm) {
        const float* kk = kr + i * CE + 4 * mm;
        const int qo = ((i * (CE / 4) + mm) * L + qd) * 4;
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          const float4 qv = *reinterpret_cast<const float4*>(sm.q + g * DP + qo);
          dot[g] = fmaf(kk[0], qv.x, dot[g]);
          dot[g] = fmaf(kk[1], qv.y, dot[g]);
          dot[g] = fmaf(kk[2], qv.z, dot[g]);
          dot[g] = fmaf(kk[3], qv.w, dot[g]);
        }
      }
#pragma unroll
    for (int o = 1; o < L; o <<= 1)
#pragma unroll
      for (int g = 0; g < GC; ++g) dot[g] += __shfl_xor_sync(FULL, dot[g], o);
    const float ksc = sm.ks[jt + sj], vsc = sm.vs[jt + sj];
    float mx[GC];
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      dot[g] = p >= 0 ? dot[g] * a.scale * ksc : NEG_INF;   // the score
      mx[g] = dot[g];
    }
#pragma unroll
    for (int o = L; o < 32; o <<= 1)
#pragma unroll
      for (int g = 0; g < GC; ++g) mx[g] = fmaxf(mx[g], __shfl_xor_sync(FULL, mx[g], o));
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      // the running max, and the one the exponent subtracts: 0 while the
      // warp has seen nothing, so a masked score (NEG_INF) gives exactly 0
      const float mn = fmaxf(m[g], mx[g]);
      const float alpha = expf(m[g] - mn);
      const float e = expf(dot[g] - (mn > NEG_INF ? mn : 0.0f));
      l[g] = alpha * l[g] + e;
#pragma unroll
      for (int u = 0; u < VW; ++u) acc[g][u] *= alpha;
      m[g] = mn;
      if (qd == 0) pv[g * SP + sj] = e * vsc;
    }
    __syncwarp();
    // P.V: the lanes over the dims, four slots at a time
#pragma unroll
    for (int j4 = 0; j4 < SP; j4 += 4) {
      float vv[4][VW];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = j4 + jj;
        const unsigned char* vrow = s0 + jt + j == sl
                                        ? reinterpret_cast<const unsigned char*>(sm.fv)
                                        : vt + j * PITCH;
        load_elems<VW, KV>(vrow + lane * VW * ES, vv[jj]);
      }
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        const float4 p4 = *reinterpret_cast<const float4*>(pv + g * SP + j4);
        const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int u = 0; u < VW; ++u) acc[g][u] = fmaf(pj[jj], vv[jj][u], acc[g][u]);
      }
    }
    __syncwarp();
  }
  cp_wait<0>();
  __syncthreads();

  // fold the four warps' states in warp order: the split's (m, l, acc)
  float* wm = reinterpret_cast<float*>(sm.ring);   // [WARPS][GC]
  float* wl = wm + DEC_WARPS * GC;                  // [WARPS][GC]
  float* wacc = wl + DEC_WARPS * GC;                // [WARPS][GC][DP]
#pragma unroll
  for (int g = 0; g < GC; ++g) {
#pragma unroll
    for (int o = L; o < 32; o <<= 1) l[g] += __shfl_xor_sync(FULL, l[g], o);
    if (lane == 0) {
      wm[warp * GC + g] = m[g];
      wl[warp * GC + g] = l[g];
    }
#pragma unroll
    for (int u = 0; u < VW; ++u) wacc[(warp * GC + g) * DP + lane * VW + u] = acc[g][u];
  }
  __syncthreads();
  const size_t row0 = (size_t)b * a.H + h0;
  for (int e = tid; e < gn * D; e += DEC_THREADS) {
    const int g = e / D, d = e % D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) mx = fmaxf(mx, wm[w * GC + g]);
    float ls = 0.0f, ac = 0.0f;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) {
      const float wt = expf(wm[w * GC + g] - mx);
      ls += wl[w * GC + g] * wt;
      ac += wacc[(w * GC + g) * DP + d] * wt;
    }
    const size_t row = row0 + g;
    if (nsplit == 1) {
      from_f(ac / fmaxf(ls, 1e-30f), a.out[row * D + d]);
    } else {
      const size_t pr = row * nsplit + sp;
      if (d == 0) {
        a.part_m[pr] = mx;
        a.part_l[pr] = ls;
      }
      if (ls > 0.0f) a.part_acc[pr * D + d] = ac;   // none where the split saw nothing
    }
  }
  if (nsplit == 1) return;

  // the last CTA of this (row, kv head, chunk) folds the splits in split
  // order, passing over a split the query did not see (l == 0)
  __syncthreads();
  int* last = reinterpret_cast<int*>(sm.red + 32);
  if (tid == 0) {
    __threadfence();   // the CTA's partials (ordered before it by the barrier) first
    const int t = atomicAdd(a.tickets + blockIdx.x, 1);
    *last = t == nsplit - 1;
    if (*last) a.tickets[blockIdx.x] = 0;   // ready for the next call
  }
  __syncthreads();
  if (!*last) return;
  __threadfence();
  float* fw = sm.fold;                    // [GC][nsplit] m, then the weights
  float* fl = fw + GC * nsplit;           // [GC][nsplit] l
  float* fs = fl + GC * nsplit;           // [GC] the sums
  for (int e = tid; e < gn * nsplit; e += DEC_THREADS) {
    fw[e] = __ldcg(a.part_m + row0 * nsplit + e);
    fl[e] = __ldcg(a.part_l + row0 * nsplit + e);
  }
  __syncthreads();
  if (tid < gn) {   // a head's max over the splits, its weights and sum in split order
    float* w = fw + tid * nsplit;
    const float* lq = fl + tid * nsplit;
    float mx = NEG_INF;
    for (int q = 0; q < nsplit; ++q) mx = fmaxf(mx, w[q]);
    float ls = 0.0f;
    for (int q = 0; q < nsplit; ++q) {
      w[q] = lq[q] > 0.0f ? expf(w[q] - mx) : 0.0f;
      ls += lq[q] * w[q];
    }
    fs[tid] = ls;
  }
  __syncthreads();
  // four outputs a thread at a time, their loads in flight together
  for (int e0 = tid; e0 < gn * D; e0 += 4 * DEC_THREADS) {
    float ac[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const float* src[4];
    const float* w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = min(e0 + k * DEC_THREADS, gn * D - 1), g = e / D;
      src[k] = a.part_acc + (row0 + g) * nsplit * D + e % D;
      w[k] = fw + g * nsplit;
    }
#pragma unroll 4
    for (int q = 0; q < nsplit; ++q)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (w[k][q] != 0.0f) ac[k] += __ldcg(src[k] + (size_t)q * D) * w[k][q];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = e0 + k * DEC_THREADS;
      if (e < gn * D)
        from_f(ac[k] / fmaxf(fs[e / D], 1e-30f), a.out[(row0 + e / D) * D + e % D]);
    }
  }
}

// Combine the splits of one (row, head) of the prefill in split order,
// passing over a split with l == 0 (the prefill body writes no accumulator
// for a split a query cannot see): its weight is 0 and it adds nothing.
template <class QT>
__global__ void decode_combine_kernel(const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      const float* __restrict__ part_acc,
                                      QT* __restrict__ out, int nsplit, int D) {
  const size_t row = blockIdx.x;
  const int d = threadIdx.x;
  const float* pm = part_m + row * nsplit;
  const float* plv = part_l + row * nsplit;
  float mx = NEG_INF;
  for (int p = 0; p < nsplit; ++p) mx = fmaxf(mx, pm[p]);
  float lsum = 0.0f, a = 0.0f;
  for (int p = 0; p < nsplit; ++p) {
    if (!(plv[p] > 0.0f)) continue;
    const float w = expf(pm[p] - mx);
    lsum += plv[p] * w;
    a += part_acc[(row * nsplit + p) * D + d] * w;
  }
  from_f(a / fmaxf(lsum, 1e-30f), out[row * D + d]);
}

// ---------------------------------------------------------------------------
// head-batched decode (kernel O)
// ---------------------------------------------------------------------------
// Replaces blama_tpu/ops/pallas/decode_attention.py:279 _decode_attn_kernel_hb
// (the reference's BLAMA_ATTN_HB mode, with numerics of its own). What sets
// O's bits, kept from the port's first O (one block per (row, split) over
// all kv heads):
//   * the split: `chunk` slots a block, the reference's head-batched one (a
//     cap of max(128, 4096 / Hkv) slots; ops/decode_attention.hb_split);
//   * tiles of `ts` slots from the split's first slot (the host's hb_tile:
//     32, halved while the first O's buffers outgrew a block), each seen
//     tile in slot order; a tile no slot of which the query sees is passed
//     over;
//   * per query head and tile: lane j scores slot j, q . rope(K) as one FMA
//     chain over d in order, times the scale, times the K scale; m' =
//     max(m, warp_max), alpha = exp(m - m'), e = exp(s - m'), l = alpha * l
//     + warp_sum(e) (the 32-lane butterfly, lanes past ts adding 0); acc =
//     acc * alpha, then + e_j * vscale_j * V_j for j = 0 .. ts-1 in order;
//   * rope from the slot's position: K rotated by sin and cos of
//     (float)pos * invf[2i], sincosf, per pair;
//   * the splits' (m, l, acc) folded in split order, every split (one the
//     query did not see adds a weight of 0): the first O's combine.
//
// A query head's state never meets another's, so the work spreads over many
// CTAs without moving a bit: one CTA per (row, kv head, chunk of up to
// HB_HEADS of its query heads, split). The angles come first, from a launch
// of their own over every (slot, pair) of the rows (hb_angles_kernel): a
// slot's sines and cosines serve all its kv heads. A split's tiles then
// pass a pipeline with one CTA barrier a step; in step n (`pipe`)
//   * six staging warps issue the `cp.async` of a later tile's K and V rows
//     of the kv head into a ring of `stages` tiles (rows as stored; a slot
//     the query cannot see is staged as zeros without being read), rotate
//     tile n + 1's K once for all the CTA's heads (an f32 store's in its
//     ring row, else into one of two f32 buffers) with the angles they
//     loaded a step before, and load tile n + 2's;
//   * two scoring warps score tile n, each for two of the CTA's heads (lane
//     j the heads' FMA chains of slot j side by side, so each rotated K row
//     is read once for both);
//   * a folding warp a head folds tile n - 1's scores into the head's
//     state (m, l, D / 32 dims of acc a lane, in registers) with its V rows.
// Where a ring of 4 tiles does not fit (an f32 store at D = 256 and 32-slot
// tiles: 66 KB a tile), one warp a head scores and folds each tile in the
// same step and eight warps stage, over a ring of 3 (`pipe` 0). The last
// CTA of a (row, kv head, head chunk) to finish folds its splits, as the
// decode body does: two launches a call, the angles and this one.

constexpr int HB_HEADS = 4;                   // query heads a CTA at most
constexpr int HB_WARPS = 12;
constexpr int HB_THREADS = 32 * HB_WARPS;
constexpr int HB_MAX_TS = 32;                 // slots a tile at most: one a lane

template <int D, class KV>
struct HbShape {
  static constexpr int ES = sizeof(KV);
  static constexpr int RP = D * ES + 16;      // bytes of a staged row; the pad puts
                                              // the rows a quarter-warp reads on
                                              // distinct banks
  static constexpr int KP = D + 4;            // floats of a rotated K row
  static constexpr int VW = D / 32;           // dims a lane owns in P.V
  static constexpr bool IN_PLACE = ES == 4;   // an f32 row is rotated where it is staged
  static_assert(RP == KP * 4 || !IN_PLACE, "an f32 ring row is a rotated row");
};

template <class KV, class QT = __nv_bfloat16>
struct HbArgs {
  const QT* q;               // [B, H, D] rotated queries (bf16, or f32)
  const KV* k;               // [B*S(+1), Hkv, D] the store
  const KV* v;
  const float* ks;           // [B*S(+1), Hkv] its scales (int8), else null
  const float* vs;
  const int* kv_pos;         // [B, S]
  const int* q_pos;          // [B]
  const float* ang;          // [B*S, D] (sin, cos) of each seen slot's pairs
  float* part_m;             // [B, H, nsplit]
  float* part_l;
  float* part_acc;           // [B, H, nsplit, D]
  int* tickets;              // [B * Hkv * head chunks], 0 between calls
  QT* out;                   // [B, H, D] in the queries' type
  int H, Hkv, S, chunk, ts, heads, stages, pipe;
  float scale;
};

// Shared memory of one CTA; every section 16-byte aligned. `ntl`: tiles of
// the widest split.
template <int D, class KV>
struct HbSmem {
  using Sh = HbShape<D, KV>;
  unsigned char* ring;   // [stages][2][ts][RP]: K rows, then V rows
  float* kbuf;           // [2][ts][KP] rotated K (not for an f32 store)
  float* q;              // [HB_HEADS][D]
  int* pos;              // [ntl * ts] a slot's position if the query sees it, else -1
  float* ks;             // [ntl * ts] its scales (0 where not seen)
  float* vs;
  int* tiles;            // [ntl + 1] the seen tiles in slot order, then their count
  float* pv;             // [HB_WARPS][32] a tile's probabilities x V scale
  float* sb;             // [2][HB_HEADS][32] a tile's scores, scoring to folding warps
  __host__ __device__ static size_t offsets(int ts, int stages, int ntl, size_t (&o)[10]) {
    const size_t size[9] = {(size_t)stages * 2 * ts * Sh::RP,
                            Sh::IN_PLACE ? 0 : sizeof(float) * 2 * ts * Sh::KP,
                            sizeof(float) * HB_HEADS * D,
                            sizeof(int) * ntl * ts,
                            sizeof(float) * ntl * ts,
                            sizeof(float) * ntl * ts,
                            sizeof(int) * (ntl + 1),
                            sizeof(float) * HB_WARPS * 32,
                            sizeof(float) * 2 * HB_HEADS * 32};
    size_t n = 0;
    for (int i = 0; i < 9; ++i) {
      o[i] = n;
      n += (size[i] + 15) / 16 * 16;
    }
    o[9] = n;
    return n;
  }
  static size_t bytes(int ts, int stages, int ntl) {
    size_t o[10];
    return offsets(ts, stages, ntl, o);
  }
  __device__ HbSmem(unsigned char* base, int ts, int stages, int ntl) {
    size_t o[10];
    offsets(ts, stages, ntl, o);
    ring = base + o[0];
    kbuf = reinterpret_cast<float*>(base + o[1]);
    q = reinterpret_cast<float*>(base + o[2]);
    pos = reinterpret_cast<int*>(base + o[3]);
    ks = reinterpret_cast<float*>(base + o[4]);
    vs = reinterpret_cast<float*>(base + o[5]);
    tiles = reinterpret_cast<int*>(base + o[6]);
    pv = reinterpret_cast<float*>(base + o[7]);
    sb = reinterpret_cast<float*>(base + o[8]);
  }
};

// Kernel O's rope angles: sin and cos of (float)pos * invf[2i] (sincosf,
// the first O's expression) for every pair i of every slot of row b
// (blockIdx.y) its query sees, into ang [B*S, D] (pair i at 2i, 2i + 1); a
// slot the query cannot see is left as it is. A thread a (slot, pair).
template <int D>
__global__ void hb_angles_kernel(const int* __restrict__ kv_pos, const int* __restrict__ q_pos,
                                 const float* __restrict__ invf, float* __restrict__ ang,
                                 int S) {
  constexpr int P = D / 2;
  const int b = blockIdx.y, e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= S * P) return;
  const int s = e / P, i = e % P;
  const int p = kv_pos[(size_t)b * S + s];
  if (p < 0 || p > q_pos[b]) return;
  float sn, cs;
  sincosf((float)p * invf[2 * i], &sn, &cs);
  reinterpret_cast<float2*>(ang)[((size_t)b * S + s) * P + i] = make_float2(sn, cs);
}

// wait until at most n of this thread's cp.async groups are pending (n < 4)
__device__ __forceinline__ void cp_wait_upto(int n) {
  if (n <= 0)
    cp_wait<0>();
  else if (n == 1)
    cp_wait<1>();
  else if (n == 2)
    cp_wait<2>();
  else
    cp_wait<3>();
}

template <int D, class KV, class QT>
__global__ void __launch_bounds__(HB_THREADS) decode_hb_kernel(const HbArgs<KV, QT> a) {
  using Sh = HbShape<D, KV>;
  constexpr int ES = Sh::ES, RP = Sh::RP, KP = Sh::KP, VW = Sh::VW, C4 = D / 4;
  constexpr int NPC = D * ES / 16;                 // 16-byte pieces a row
  constexpr int MIN_ST = 32 * (HB_WARPS - 2 - HB_HEADS);   // the fewest staging threads
  constexpr int FU = (2 * HB_MAX_TS * NPC + MIN_ST - 1) / MIN_ST;  // pieces a thread at most
  constexpr int RU = (HB_MAX_TS * C4 + MIN_ST - 1) / MIN_ST;       // rope steps a thread at most
  extern __shared__ __align__(16) unsigned char hb_raw[];
  const int ts = a.ts, ST = a.stages;
  const int ntl = (min(a.chunk, a.S) + ts - 1) / ts;
  const HbSmem<D, KV> sm(hb_raw, ts, ST, ntl);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = a.H / a.Hkv, nhc = (G + a.heads - 1) / a.heads;
  const int b = blockIdx.x / (a.Hkv * nhc), hk = blockIdx.x / nhc % a.Hkv;
  const int h0 = hk * G + blockIdx.x % nhc * a.heads;      // the CTA's first query head
  const int gn = min(a.heads, hk * G + G - h0);             // its query heads
  const int sp = blockIdx.y, nsplit = gridDim.y;
  const int s0 = sp * a.chunk, nslots = min(a.S, s0 + a.chunk) - s0;
  const int ntiles = (nslots + ts - 1) / ts;
  const int qpos = a.q_pos[b];
  const size_t row0 = (size_t)b * a.S + s0;                // the split's first slot

  // the warps' roles: pipelined, warps 0 and 1 score (two heads each),
  // [2, 6) fold, [6, 12) stage; else warps [0, 4) score and fold, [4, 12)
  // stage
  const int lag = a.pipe ? 1 : 0;                  // steps from a tile's score to its fold
  const int fw = a.pipe ? 2 : 0;                   // the first folding warp
  const int st0 = 32 * (a.pipe ? 2 + HB_HEADS : HB_HEADS), nst = HB_THREADS - st0;
  const bool stager = tid >= st0, scores = a.pipe ? warp < 2 : warp < gn;
  const bool folds = warp >= fw && warp < fw + gn;

  // the heads' queries, the split's positions and scales (a position and
  // its scales load side by side)
  for (int e = tid; e < gn * D; e += HB_THREADS)
    sm.q[e] = to_f(a.q[((size_t)b * a.H + h0) * D + e]);
  for (int j = tid; j < ntiles * ts; j += HB_THREADS) {
    int p = -1;
    float kq = 1.0f, vq = 1.0f;
    if (j < nslots) {
      p = a.kv_pos[row0 + j];
      if (a.ks) {
        kq = a.ks[(row0 + j) * a.Hkv + hk];
        vq = a.vs[(row0 + j) * a.Hkv + hk];
      }
    }
    const bool seen = p >= 0 && p <= qpos;
    sm.pos[j] = seen ? p : -1;
    sm.ks[j] = seen ? kq : 0.0f;
    sm.vs[j] = seen ? vq : 0.0f;
  }
  __syncthreads();
  if (warp == 0) {     // the tiles the query sees, in slot order
    int n = 0;
    for (int base = 0; base < ntiles; base += 32) {
      bool f = false;
      if (base + lane < ntiles)
        for (int j = 0; j < ts && !f; ++j) f = sm.pos[(base + lane) * ts + j] >= 0;
      const unsigned bal = __ballot_sync(FULL, f);
      if (f) sm.tiles[n + __popc(bal & ((1u << lane) - 1u))] = base + lane;
      n += __popc(bal);
    }
    if (lane == 0) sm.tiles[ntiles] = n;
  }
  __syncthreads();
  const int nvis = sm.tiles[ntiles];

  // cp.async of seen tile n into ring stage n % ST by the staging threads:
  // its K rows, then its V rows, 16-byte pieces, FU a thread (the slots'
  // positions read first, so the copies issue back to back); a slot not
  // seen becomes zeros. One group a call, empty past the last seen tile,
  // so the group count stays the tile count.
  auto fetch = [&](int n) {
    if (n < nvis) {
      const int jb = sm.tiles[n] * ts;
      unsigned char* dst0 = sm.ring + (size_t)(n % ST) * 2 * ts * RP;
      bool full[FU];
#pragma unroll
      for (int u = 0; u < FU; ++u) {
        const int e = tid - st0 + u * nst, r = e / NPC;
        full[u] = e < 2 * ts * NPC && sm.pos[jb + (r < ts ? r : r - ts)] >= 0;
      }
#pragma unroll
      for (int u = 0; u < FU; ++u) {
        const int e = tid - st0 + u * nst, r = e / NPC, c = e % NPC, j = r < ts ? r : r - ts;
        if (e >= 2 * ts * NPC) break;
        const unsigned char* src =
            reinterpret_cast<const unsigned char*>(r < ts ? a.k : a.v) +
            (full[u] ? ((row0 + jb + j) * a.Hkv + hk) * (size_t)(D * ES) : 0) + 16 * c;
        cp_zfill<16>(dst0 + (size_t)r * RP + 16 * c, src, full[u]);
      }
    }
    cp_commit();
  };

  // the rope of seen tile n: its K rows rotated into f32 [ts][KP], 4 dims
  // (two pairs) a step, RU steps a staging thread; the angles come from
  // registers the thread loaded a step before (angles(n))
  float4 sc[RU];
  auto angles = [&](int n) {
    if (n >= nvis) return;
    const int jb = sm.tiles[n] * ts, ne = min(ts, nslots - jb) * C4;   // the tile's slots
    const float4* ang = reinterpret_cast<const float4*>(a.ang + (row0 + jb) * D);
#pragma unroll
    for (int u = 0; u < RU; ++u) {
      const int e = tid - st0 + u * nst;   // slot e / C4, pairs 2 (e % C4), + 1
      if (e < ne) sc[u] = __ldcg(ang + e);
    }
  };
  auto rotated = [&](int n) {
    unsigned char* st = sm.ring + (size_t)(n % ST) * 2 * ts * RP;
    return Sh::IN_PLACE ? reinterpret_cast<float*>(st) : sm.kbuf + (size_t)(n & 1) * ts * KP;
  };
  auto rope = [&](int n) {
    if (n >= nvis) return;
    const unsigned char* kin = sm.ring + (size_t)(n % ST) * 2 * ts * RP;
    float* kout = rotated(n);
    const int jb = sm.tiles[n] * ts;
#pragma unroll
    for (int u = 0; u < RU; ++u) {
      const int e = tid - st0 + u * nst, j = e / C4, c = e % C4;
      if (e >= ts * C4 || sm.pos[jb + j] < 0) continue;
      float kf[4];
      load_elems<4, KV>(kin + (size_t)j * RP + 4 * c * ES, kf);
      const float sn0 = sc[u].x, cs0 = sc[u].y, sn1 = sc[u].z, cs1 = sc[u].w;
      float4 kr;
      kr.x = kf[0] * cs0 + kf[1] * (-sn0);
      kr.y = kf[1] * cs0 + kf[0] * sn0;
      kr.z = kf[2] * cs1 + kf[3] * (-sn1);
      kr.w = kf[3] * cs1 + kf[2] * sn1;
      *reinterpret_cast<float4*>(kout + (size_t)j * KP + 4 * c) = kr;
    }
  };

  // tile n's scores of this lane's slot for NG heads from g0: the heads'
  // FMA chains over d side by side, each times the scale, times the K
  // scale; NEG_INF where the slot is not seen
  auto score = [&](int n, int g0, auto ng, float* s) {
    constexpr int NG = decltype(ng)::value;
    const int jb = sm.tiles[n] * ts;
    const bool valid = lane < ts && sm.pos[jb + lane] >= 0;
    float dot[NG];
#pragma unroll
    for (int g = 0; g < NG; ++g) dot[g] = 0.0f;
    if (valid) {
      const float* kr = rotated(n) + (size_t)lane * KP;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        const float4 k4 = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const float4 q4 = *reinterpret_cast<const float4*>(sm.q + (g0 + g) * D + d);
          dot[g] = fmaf(q4.x, k4.x, dot[g]);
          dot[g] = fmaf(q4.y, k4.y, dot[g]);
          dot[g] = fmaf(q4.z, k4.z, dot[g]);
          dot[g] = fmaf(q4.w, k4.w, dot[g]);
        }
      }
    }
    const float ksc = valid ? sm.ks[jb + lane] : 0.0f;
#pragma unroll
    for (int g = 0; g < NG; ++g) s[g] = valid ? dot[g] * a.scale * ksc : NEG_INF;
  };

  // this warp's query head's online-softmax state, and the fold of tile
  // n's scores and V rows into it
  float m = NEG_INF, l = 0.0f, acc[VW];
#pragma unroll
  for (int u = 0; u < VW; ++u) acc[u] = 0.0f;
  float* pv = sm.pv + warp * 32;
  auto fold = [&](int n, float s) {
    const int jb = sm.tiles[n] * ts;
    const bool valid = lane < ts && sm.pos[jb + lane] >= 0;
    const float m_new = fmaxf(m, warp_max(s));
    const float alpha = expf(m - m_new);
    const float e = valid ? expf(s - m_new) : 0.0f;
    const float lsum = warp_sum(e);
    pv[lane] = valid ? e * sm.vs[jb + lane] : 0.0f;
    l = fmaf(alpha, l, lsum);
    m = m_new;
#pragma unroll
    for (int u = 0; u < VW; ++u) acc[u] = __fmul_rn(acc[u], alpha);
    __syncwarp();
    const unsigned char* vl =
        sm.ring + (size_t)(n % ST) * 2 * ts * RP + (size_t)ts * RP + lane * VW * ES;
#pragma unroll 4
    for (int j = 0; j < ts; ++j) {
      float vv[VW];
      load_elems<VW, KV>(vl + (size_t)j * RP, vv);
      const float p = pv[j];
#pragma unroll
      for (int u = 0; u < VW; ++u) acc[u] = fmaf(p, vv[u], acc[u]);
    }
    __syncwarp();
  };

  // step n: the staging threads wait for tile n + 1, issue tile n + ST - 1
  // - lag (the stage of tile n - 1 - lag, done with), rotate tile n + 1
  // and load tile n + 2's angles; tile n is scored, tile n - lag folded
  if (stager) {
    for (int f = 0; f < ST - 1 - lag; ++f) fetch(f);
    angles(0);
    cp_wait_upto(ST - 2 - lag);   // tile 0
  }
  __syncthreads();
  if (stager) {
    rope(0);
    angles(1);
  }
  for (int n = 0; n < nvis + lag; ++n) {
    if (stager) cp_wait_upto(ST - 3 - lag);   // tile n + 1
    __syncthreads();
    if (stager) {
      fetch(n + ST - 1 - lag);
      rope(n + 1);
      angles(n + 2);
    } else if (!a.pipe) {
      if (scores) {
        float s[1];
        score(n, warp, std::integral_constant<int, 1>(), s);
        fold(n, s[0]);
      }
    } else if (scores) {
      if (n < nvis) {
        float s[2];
        score(n, 2 * warp, std::integral_constant<int, 2>(), s);
        float* sbn = sm.sb + (n & 1) * HB_HEADS * 32 + lane;
#pragma unroll
        for (int g = 0; g < 2; ++g)
          if (2 * warp + g < gn) sbn[(2 * warp + g) * 32] = s[g];
      }
    } else if (folds && n > 0) {
      fold(n - 1, sm.sb[(((n - 1) & 1) * HB_HEADS + warp - fw) * 32 + lane]);
    }
  }
  if (stager) cp_wait<0>();

  if (folds) {   // the split's state of this warp's head
    const size_t row = ((size_t)b * a.H + h0 + warp - fw) * nsplit + sp;
    if (lane == 0) {
      a.part_m[row] = m;
      a.part_l[row] = l;
    }
#pragma unroll
    for (int u = 0; u < VW; ++u) a.part_acc[row * D + lane * VW + u] = acc[u];
  }

  // the last CTA of this (row, kv head, head chunk) to finish (an atomic
  // ticket, which adds nothing to any sum) folds the splits in split order,
  // the first O's combine (its expressions; a split the query did not see
  // is folded with a weight of 0, as there)
  __syncthreads();
  int* last = reinterpret_cast<int*>(sm.pv);
  if (tid == 0) {
    __threadfence();   // the CTA's partials (ordered before it by the barrier) first
    const int t = atomicAdd(a.tickets + blockIdx.x, 1);
    *last = t == nsplit - 1;
    if (*last) a.tickets[blockIdx.x] = 0;   // ready for the next call
  }
  __syncthreads();
  if (!*last) return;
  __threadfence();
  for (int e = tid; e < gn * D; e += HB_THREADS) {
    const size_t row = ((size_t)b * a.H + h0 + e / D) * nsplit;
    const int d = e % D;
    float mx = NEG_INF;
    for (int p = 0; p < nsplit; ++p) mx = fmaxf(mx, __ldcg(a.part_m + row + p));
    float lsum = 0.0f, ac = 0.0f;
    for (int p = 0; p < nsplit; ++p) {
      const float w = expf(__ldcg(a.part_m + row + p) - mx);
      lsum = fmaf(__ldcg(a.part_l + row + p), w, lsum);
      ac = fmaf(__ldcg(a.part_acc + (row + p) * D + d), w, ac);
    }
    from_f(ac / fmaxf(lsum, 1e-30f), a.out[((size_t)b * a.H + h0) * D + e]);
  }
}

// ---------------------------------------------------------------------------
// causal prefill of a T-token chunk: kernels D and F on the tensor cores
// ---------------------------------------------------------------------------
// Replaces blama_tpu/ops/pallas/decode_attention.py:976 _prefill_attn_kernel
// (kernel D, dense rows) and blama_tpu/ops/pallas/paged_attention.py:155
// _paged_attn_kernel in its prefill form (kernel F, the paged pool). Two
// passes and, when a row's slots span more than one split, the combine.
//
// Stage (prefill_stage_kernel): one CTA per (row, kv head, TS-slot tile of
// the row's logical window) reads the tile's positions through the address
// functor. For the slots some query of the row can see (0 <= pos <= the
// row's largest query position) it rotates K in f32 (two sincosf per 4
// elements, the decode kernels' formula) and writes it as a high and a low
// bf16 half (hi = bf16(k), lo = bf16(k - hi)), and V as bf16 (int8 codes and
// bf16 values exactly; f32 values as a high and a low half the same way),
// into a dense scratch [B, Hkv, Sp, ...];
// the tile's other slots are zeros. A tile no query of the row sees is not
// written; each tile's least visible position (INT_MAX: none) lets a CTA of
// the second pass pick its tiles with one load each. So rope runs once per
// slot and kv head per call, not once per query tile (T / 2 times at g = 4
// in the body this replaces), and the pool's page table ends here: the
// second pass reads the same scratch for D and F, so F equals D bit for bit.
//
// Attention (prefill_mma_kernel): a CTA owns up to PF_ROWS MMA rows, `tq`
// tokens of the chunk times the g query heads of one kv head (GQA packing:
// row r = token tq0 + r / g, head hk*g + r % g; 16 rows a warp), over one
// split of the row's slots, so each staged tile serves 64 rows. A group of
// more than PF_ROWS heads is cut into slices of PF_ROWS heads, one token a
// CTA (row r = head hk*g + slice start + r); each MMA row is its own, so
// the cut moves no bit. At a padded width (DP > D) Q, the staged K and V
// read zeros past D and only the first D outputs are written. Both take
// the PAD instances, so a D that is a width with at most PF_ROWS heads a
// group runs the body without their guards. A cp.async
// ring brings the next tile (K halves, V, positions, scales) while the
// current one is multiplied on the tensor cores, where the operations that
// bound long chunks run (mma.sync m16n8k16, bf16 in, f32 sums; ldmatrix,
// .trans for V): S = Q K_hi + Q K_lo, then the scale
// and the K scale per column in f32, online softmax per row (the row's max
// and sum over its quad of lanes in a fixed order), and O += P_hi V + P_lo V
// with P = p * vs split the same way (the f32 store adds P_hi V_lo, so its
// V keeps f32 grade too). The halves keep the products f32-grade: with one
// bf16 K and P the error comes near the tolerance (2^-7 of the largest
// output) at the 8B test shapes and passes it at sharper scores
// (tests/test_torch_prefill_plan.py's emulation).
//
// Splits: the slots of a row are cut at multiples of one width (the host's
// PREFILL_SPLIT, for every B, T and S); a split's rows write m, l and (when
// they saw a slot) their f32 accumulators, and decode_combine_kernel folds
// the splits in split order, passing over the splits a query did not see.
// (Zero accumulators for those, combined as decode's are, took 8% longer on
// an H100 at 8 rows x T >= 128: the writes and reads of the partials.) A split fills the card at short chunks (one
// row at T = 128 gives 64 CTAs unsplit, 256 split at 512 slots).
//
// The contract: a query's output depends only on its own q and position and
// its row's logical store. Tiles and splits are fixed in logical slots, the
// splits combine in split order, an output element's mma sum reads only its
// own row of Q (of P) and column of K (of V), and a tile a row cannot see
// leaves its state exactly as it was (alpha = 1, p = 0 against finite or
// zeroed V). So T, B, the place in the chunk, the rows sharing a CTA, the
// tiles the CTA skips and empty slots past the last visible one move no
// bit, and no atomics are used.
//
// Bound on this card: operations at the bf16 tensor rate for chunks of 128
// tokens or more (4*H*D flops per visible (query, slot) pair), bytes below.

template <int DP>
struct PfShape {
  static constexpr int RS = DP + 8;                // bf16 row pitch in smem (ldmatrix w/o conflicts)
  static constexpr bool QREG = DP <= 128;          // Q fragments kept in registers
};
constexpr int PF_TS = 32;        // slots per staged tile (the host's PREFILL_TILE)
constexpr int PF_ROWS = 64;      // MMA rows per CTA (at most 4 warps)
constexpr int PF_STAGES = 2;     // cp.async ring depth

__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm4_t(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
// c += a (16x16, row) * b (16x8, col), bf16 operands, f32 sums
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// two f32 rounded to bf16 (round to nearest even), `lo` in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}
// the two bf16 of a packed pair, as f32 (exact)
__device__ __forceinline__ float bf16_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

constexpr int PF_STAGE_THREADS = 128;
// bf16 halves the scratch keeps of a V element: an f32 store two, else one
// (int8 codes and bf16 values are exact in bf16)
template <class KV>
struct PfV {
  static constexpr int NV = std::is_same<KV, float>::value ? 2 : 1;
};

template <int DP, class KV, class Addr, bool PAD>
__global__ void __launch_bounds__(PF_STAGE_THREADS) prefill_stage_kernel(
    const KV* __restrict__ k, const KV* __restrict__ v,
    const float* __restrict__ ks, const float* __restrict__ vs,
    const int* __restrict__ kv_pos,       // position map of the store
    const int* __restrict__ q_pos,        // [B, T]
    const float* __restrict__ invf,       // [D]
    __nv_bfloat16* __restrict__ kr,       // [B, Hkv, Sp, 2, DP] rotated K: high, low half
    __nv_bfloat16* __restrict__ vr,       // [B, Hkv, Sp, NV, DP] V (f32 store: high, low half)
    int* __restrict__ spos,               // [B, Sp] visible position or -1
    int* __restrict__ tmin,               // [B, Sp / TS] least visible position of a tile
    float* __restrict__ sks, float* __restrict__ svs,   // [B, Hkv, Sp] (int8 store)
    Addr addr, int T, int Hkv, int S, int Sp, int D) {
  constexpr int TS = PF_TS, C4 = DP / 4, NT = PF_STAGE_THREADS, NV = PfV<KV>::NV;
  constexpr int PER = TS * C4 / NT;     // 4-element pieces a thread
  __shared__ int red[NT / 32], least[NT / 32];
  __shared__ int pos_t[TS];
  __shared__ long long ph_t[TS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv, t0 = blockIdx.y * TS;
  // the row's largest query position
  int qmax = -1;
  for (int t = tid; t < T; t += NT) qmax = max(qmax, q_pos[(size_t)b * T + t]);
#pragma unroll
  for (int o = 16; o; o >>= 1) qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, o));
  if (lane == 0) red[warp] = qmax;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) qmax = max(qmax, red[w]);
  bool vis = false;
  int mn = INT_MAX;
  if (tid < TS) {
    const int s = t0 + tid;
    const long long ph = s < S ? addr.tile_base(b, s) : -1;
    const int p = ph >= 0 ? kv_pos[ph] : -1;
    vis = p >= 0 && p <= qmax;
    mn = vis ? p : INT_MAX;
    pos_t[tid] = vis ? p : -1;
    ph_t[tid] = ph;
    if (hk == 0) spos[(size_t)b * Sp + s] = vis ? p : -1;
    if (ks) {
      const size_t dst = ((size_t)b * Hkv + hk) * Sp + s;
      sks[dst] = vis ? ks[(size_t)ph * Hkv + hk] : 0.0f;
      svs[dst] = vis ? vs[(size_t)ph * Hkv + hk] : 0.0f;
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
  if (lane == 0) least[warp] = mn;
  const bool any = __syncthreads_or(vis);
  if (hk == 0 && tid == 0) {
#pragma unroll
    for (int w = 1; w < NT / 32; ++w) mn = min(mn, least[w]);
    tmin[(size_t)b * (Sp / TS) + blockIdx.y] = mn;
  }
  if (!any) return;
  __nv_bfloat16* kd = kr + (((size_t)b * Hkv + hk) * Sp + t0) * 2 * DP;
  __nv_bfloat16* vd = vr + (((size_t)b * Hkv + hk) * Sp + t0) * NV * DP;
#pragma unroll 4
  for (int i = 0; i < PER; ++i) {
    const int e = tid + i * NT, j = e / C4, c = e % C4;
    const int p = pos_t[j];
    uint2 kw = make_uint2(0u, 0u), kl = make_uint2(0u, 0u), vw = make_uint2(0u, 0u),
          vl = make_uint2(0u, 0u);
    if (p >= 0 && (!PAD || 4 * c < D)) {   // dims past D stay zero (a padded width)
      const size_t off = ((size_t)ph_t[j] * Hkv + hk) * (PAD ? D : DP) + 4 * c;
      float kf[4], vf[4], s0, c0, s1 = 0.0f, c1 = 1.0f;
      if (!PAD || D % 4 == 0) {
        load4(k + off, kf);
        load4(v + off, vf);
        sincosf((float)p * invf[4 * c], &s0, &c0);
        sincosf((float)p * invf[4 * c + 2], &s1, &c1);
      } else {   // rows aligned to a pair only; the last piece may hold one pair
        load2(k + off, kf, 0);
        load2(v + off, vf, 0);
        sincosf((float)p * invf[4 * c], &s0, &c0);
        kf[2] = kf[3] = vf[2] = vf[3] = 0.0f;
        if (4 * c + 2 < D) {
          load2(k + off + 2, kf, 2);
          load2(v + off + 2, vf, 2);
          sincosf((float)p * invf[4 * c + 2], &s1, &c1);
        }
      }
      const float r[4] = {kf[0] * c0 + kf[1] * (-s0), kf[1] * c0 + kf[0] * s0,
                          kf[2] * c1 + kf[3] * (-s1), kf[3] * c1 + kf[2] * s1};
      kw.x = pack_bf16(r[0], r[1]);
      kw.y = pack_bf16(r[2], r[3]);
      kl.x = pack_bf16(r[0] - bf16_lo(kw.x), r[1] - bf16_hi(kw.x));
      kl.y = pack_bf16(r[2] - bf16_lo(kw.y), r[3] - bf16_hi(kw.y));
      vw.x = pack_bf16(vf[0], vf[1]);
      vw.y = pack_bf16(vf[2], vf[3]);
      if constexpr (NV == 2) {
        vl.x = pack_bf16(vf[0] - bf16_lo(vw.x), vf[1] - bf16_hi(vw.x));
        vl.y = pack_bf16(vf[2] - bf16_lo(vw.y), vf[3] - bf16_hi(vw.y));
      }
    }
    *reinterpret_cast<uint2*>(kd + (size_t)j * 2 * DP + 4 * c) = kw;
    *reinterpret_cast<uint2*>(kd + (size_t)j * 2 * DP + DP + 4 * c) = kl;
    *reinterpret_cast<uint2*>(vd + (size_t)j * NV * DP + 4 * c) = vw;
    if constexpr (NV == 2) *reinterpret_cast<uint2*>(vd + (size_t)j * 2 * DP + DP + 4 * c) = vl;
  }
}

// Shared memory of one attention CTA; every section 16-byte aligned.
template <int DP, int NV, bool QF = false>
struct PfSmem {
  static constexpr int TS = PF_TS, RS = PfShape<DP>::RS;
  __nv_bfloat16* q;    // [nw*16][RS] the CTA's query rows (an f32 query's high half)
  __nv_bfloat16* kb;   // [STAGES][TS][RS] staged rotated K, high half
  __nv_bfloat16* kl;   // [STAGES][TS][RS] its low half
  __nv_bfloat16* vb;   // [STAGES][TS][RS] staged V (its high half)
  __nv_bfloat16* vl;   // [STAGES][TS][RS] its low half (NV == 2; else empty)
  int* pos;            // [STAGES][TS] positions (-1: no query of the row sees the slot)
  float* ks;           // [STAGES][TS] K scales (int8 store)
  float* vs;           // [STAGES][TS] V scales
  int* tiles;          // [ntiles] the split's tiles the CTA sees, in slot order
  __nv_bfloat16* ql;   // [nw*16][RS] an f32 query's low half (QF; else empty)
  // byte offsets of the sections (o[10] is the total)
  __host__ __device__ static size_t offsets(int nw, int ntiles, size_t (&o)[11]) {
    const size_t size[10] = {sizeof(__nv_bfloat16) * nw * 16 * RS,
                            sizeof(__nv_bfloat16) * PF_STAGES * TS * RS,
                            sizeof(__nv_bfloat16) * PF_STAGES * TS * RS,
                            sizeof(__nv_bfloat16) * PF_STAGES * TS * RS,
                            sizeof(__nv_bfloat16) * PF_STAGES * TS * RS * (NV - 1),
                            sizeof(int) * PF_STAGES * TS,
                            sizeof(float) * PF_STAGES * TS,
                            sizeof(float) * PF_STAGES * TS,
                            sizeof(int) * (ntiles + 1),
                            sizeof(__nv_bfloat16) * nw * 16 * RS * QF};
    size_t n = 0;
    for (int i = 0; i < 10; ++i) {
      o[i] = n;
      n += (size[i] + 15) / 16 * 16;
    }
    o[10] = n;
    return n;
  }
  static size_t bytes(int nw, int ntiles) {
    size_t o[11];
    return offsets(nw, ntiles, o);
  }
  __device__ PfSmem(unsigned char* base, int nw, int ntiles) {
    size_t o[11];
    offsets(nw, ntiles, o);
    q = reinterpret_cast<__nv_bfloat16*>(base + o[0]);
    kb = reinterpret_cast<__nv_bfloat16*>(base + o[1]);
    kl = reinterpret_cast<__nv_bfloat16*>(base + o[2]);
    vb = reinterpret_cast<__nv_bfloat16*>(base + o[3]);
    vl = reinterpret_cast<__nv_bfloat16*>(base + o[4]);
    pos = reinterpret_cast<int*>(base + o[5]);
    ks = reinterpret_cast<float*>(base + o[6]);
    vs = reinterpret_cast<float*>(base + o[7]);
    tiles = reinterpret_cast<int*>(base + o[8]);
    ql = reinterpret_cast<__nv_bfloat16*>(base + o[9]);
  }
};

template <int DP, int NV, bool PAD, class QT>
__global__ void __launch_bounds__(128) prefill_mma_kernel(
    const QT* __restrict__ q,             // [B, T, H, D] rotated queries (bf16, or f32)
    const __nv_bfloat16* __restrict__ kr, const __nv_bfloat16* __restrict__ vr,
    const int* __restrict__ spos,         // [B, Sp]
    const int* __restrict__ tmin,         // [B, Sp / TS]
    const float* __restrict__ sks, const float* __restrict__ svs,   // [B, Hkv, Sp] or null
    const int* __restrict__ q_pos,        // [B, T]
    float* __restrict__ part_m, float* __restrict__ part_l,
    float* __restrict__ part_acc,         // [B, T, H, nsplit(, D)] (nsplit > 1)
    QT* __restrict__ out,                 // [B, T, H, D] in the queries' type
    int T, int H, int Hkv, int S, int Sp, int tq, int split, float scale, int D) {
  using Sh = PfShape<DP>;
  // an f32 query enters the products as a high and a low bf16 half, as the
  // f32 store's K does: S = Q_hi K_hi + Q_hi K_lo + Q_lo K_hi
  constexpr bool QF = std::is_same<QT, float>::value;
  constexpr int TS = PF_TS, RS = Sh::RS;
  extern __shared__ __align__(16) unsigned char pf_raw[];
  __shared__ int red[4];
  const int tid = threadIdx.x, nthr = blockDim.x, nw = nthr >> 5;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = H / Hkv;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  // a group of more than PF_ROWS heads is cut into slices of PF_ROWS heads
  // (one token a CTA); the slice's first head and its head count
  // (the unpadded instance takes groups of at most PF_ROWS heads: one slice)
  const int nsl = PAD ? (g + PF_ROWS - 1) / PF_ROWS : 1;
  const int tq0 = (PAD ? blockIdx.y / nsl : blockIdx.y) * tq;
  const int hs = PAD ? blockIdx.y % nsl * PF_ROWS : 0;
  const int gs = PAD ? min(g - hs, PF_ROWS) : g;
  const int hq = hk * g + hs;                        // the CTA's first query head
  const int sp = blockIdx.z, nsplit = gridDim.z;
  const int s0 = sp * split, s1 = min(S, s0 + split);
  const int ntiles = (s1 - s0 + TS - 1) / TS;
  const int nrows = min(tq, T - tq0) * gs;           // live rows of the CTA
  const PfSmem<DP, NV, QF> sm(pf_raw, nw, ((split < S ? split : S) + TS - 1) / TS);

  // the CTA's query rows, its largest query position, each warp's
  constexpr int C8 = DP / 8;
  if constexpr (QF) {   // f32 rows: high and low halves, zeros past D
    for (int e = tid; e < nw * 16 * (DP / 2); e += nthr) {
      const int r = e / (DP / 2), c = e % (DP / 2);
      float2 w = make_float2(0.0f, 0.0f);
      if (r < nrows && 2 * c < D)
        w = *reinterpret_cast<const float2*>(
            q + (((size_t)b * T + tq0 + r / gs) * H + hq + r % gs) * D + 2 * c);
      const unsigned hi = pack_bf16(w.x, w.y);
      *reinterpret_cast<unsigned*>(sm.q + r * RS + 2 * c) = hi;
      *reinterpret_cast<unsigned*>(sm.ql + r * RS + 2 * c) =
          pack_bf16(w.x - bf16_lo(hi), w.y - bf16_hi(hi));
    }
  } else if constexpr (!PAD) {
    for (int e = tid; e < nw * 16 * C8; e += nthr) {
      const int r = e / C8, c = e % C8;
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (r < nrows)
        w = *reinterpret_cast<const uint4*>(
            q + (((size_t)b * T + tq0 + r / gs) * H + hq + r % gs) * DP + 8 * c);
      *reinterpret_cast<uint4*>(sm.q + r * RS + 8 * c) = w;
    }
  } else {   // rows of D (even) elements, zeros to DP: pairs of bf16
    for (int e = tid; e < nw * 16 * (DP / 2); e += nthr) {
      const int r = e / (DP / 2), c = e % (DP / 2);
      unsigned w = 0u;
      if (r < nrows && 2 * c < D)
        w = *reinterpret_cast<const unsigned*>(
            q + (((size_t)b * T + tq0 + r / gs) * H + hq + r % gs) * D + 2 * c);
      *reinterpret_cast<unsigned*>(sm.q + r * RS + 2 * c) = w;
    }
  }
  int qmax = tid < tq && tq0 + tid < T ? q_pos[(size_t)b * T + tq0 + tid] : -1;
#pragma unroll
  for (int o = 16; o; o >>= 1) qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, o));
  if (lane == 0) red[warp] = qmax;
  // this thread's two rows of the MMA fragments (r and r + 8)
  const int ra = warp * 16 + (lane >> 2), rb = ra + 8;
  const int qpa = ra < nrows ? q_pos[(size_t)b * T + tq0 + ra / gs] : -1;
  const int qpb = rb < nrows ? q_pos[(size_t)b * T + tq0 + rb / gs] : -1;
  int wmax = max(qpa, qpb);
#pragma unroll
  for (int o = 16; o; o >>= 1) wmax = max(wmax, __shfl_xor_sync(0xffffffffu, wmax, o));
  __syncthreads();
  for (int w = 0; w < nw; ++w) qmax = max(qmax, red[w]);

  // the split's tiles that some row of the CTA sees, in slot order
  const int* rpos = spos + (size_t)b * Sp;
  if (warp == 0) {
    const int* least = tmin + (size_t)b * (Sp / TS) + s0 / TS;
    int n = 0;
    for (int base = 0; base < ntiles; base += 32) {
      const bool f = base + lane < ntiles && least[base + lane] <= qmax;
      const unsigned bal = __ballot_sync(0xffffffffu, f);
      if (f) sm.tiles[n + __popc(bal & ((1u << lane) - 1u))] = base + lane;
      n += __popc(bal);
    }
    if (lane == 0) sm.tiles[ntiles] = n;
  }
  __syncthreads();
  const int nvis = sm.tiles[ntiles];

  // cp.async of visible tile n into ring stage st: its rows of the scratch
  // (16-byte pieces), positions and scales
  const size_t head = (size_t)b * Hkv + hk;
  auto fetch = [&](int n, int st) {
    if (n < nvis) {
      const int t0 = s0 + sm.tiles[n] * TS;
      const __nv_bfloat16* ksrc = kr + (head * Sp + t0) * 2 * DP;
      const __nv_bfloat16* vsrc = vr + (head * Sp + t0) * NV * DP;
      __nv_bfloat16* kd = sm.kb + (size_t)st * TS * RS;
      __nv_bfloat16* kld = sm.kl + (size_t)st * TS * RS;
      __nv_bfloat16* vd = sm.vb + (size_t)st * TS * RS;
      __nv_bfloat16* vld = sm.vl + (size_t)st * TS * RS;
      for (int e = tid; e < TS * C8; e += nthr) {
        const int j = e / C8, c = e % C8;
        cp16(kd + j * RS + 8 * c, ksrc + (size_t)j * 2 * DP + 8 * c);
        cp16(kld + j * RS + 8 * c, ksrc + (size_t)j * 2 * DP + DP + 8 * c);
        cp16(vd + j * RS + 8 * c, vsrc + (size_t)j * NV * DP + 8 * c);
        if constexpr (NV == 2) cp16(vld + j * RS + 8 * c, vsrc + (size_t)j * 2 * DP + DP + 8 * c);
      }
      for (int e = tid; e < TS / 4; e += nthr) {
        cp16(sm.pos + st * TS + 4 * e, rpos + t0 + 4 * e);
        if (sks) {
          cp16(sm.ks + st * TS + 4 * e, sks + head * Sp + t0 + 4 * e);
          cp16(sm.vs + st * TS + 4 * e, svs + head * Sp + t0 + 4 * e);
        }
      }
    }
    cp_commit();
  };

  // Q fragments (A operand of S = Q K^T), per 16-wide k step
  constexpr int KQ = DP / 16;
  unsigned qf[Sh::QREG ? KQ : 1][4];
  if constexpr (Sh::QREG) {
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk)
      ldsm4(qf[kk], sm.q + (warp * 16 + (lane & 15)) * RS + kk * 16 + (lane >> 4) * 8);
  }

  constexpr int NB = TS / 8;     // n8 blocks of the score tile
  constexpr int ND = DP / 8;      // n8 blocks of the output
  constexpr int KP = TS / 16;    // 16-slot k steps of O += P V
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
  float o[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;

  fetch(0, 0);
  for (int n = 0; n < nvis; ++n) {
    const int st = n % PF_STAGES;
    fetch(n + 1, (n + 1) % PF_STAGES);
    cp_wait<1>();
    __syncthreads();
    const __nv_bfloat16* kb = sm.kb + (size_t)st * TS * RS;
    const __nv_bfloat16* klo = sm.kl + (size_t)st * TS * RS;
    const __nv_bfloat16* vb = sm.vb + (size_t)st * TS * RS;
    const __nv_bfloat16* vlo = sm.vl + (size_t)st * TS * RS;
    const int* cpos = sm.pos + st * TS;
    const float* cks = sm.ks + st * TS;
    const float* cvs = sm.vs + st * TS;

    // does any row of this warp see any slot of the tile?
    bool any = false;
#pragma unroll
    for (int j = lane; j < TS; j += 32) {
      const int p = cpos[j];
      any |= p >= 0 && p <= wmax;
    }
    if (__any_sync(0xffffffffu, any)) {
      // S = Q K^T: per k step, the tile's K fragments, then the products
      float s[NB][4];
#pragma unroll
      for (int i = 0; i < NB; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.0f;
      // S = Q K_hi + Q K_lo: per k step the tile's K fragments (both
      // halves, the next step's loaded ahead), then the products
      const int koff = ((lane & 7) + (lane >> 4) * 8) * RS + ((lane >> 3) & 1) * 8;
      unsigned bk[2][2][NB / 2][4];
#pragma unroll
      for (int np = 0; np < NB / 2; ++np) {
        ldsm4(bk[0][0][np], kb + koff + np * 16 * RS);
        ldsm4(bk[0][1][np], klo + koff + np * 16 * RS);
      }
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
        unsigned a[4];
        if (kk + 1 < KQ) {
#pragma unroll
          for (int np = 0; np < NB / 2; ++np) {
            ldsm4(bk[(kk + 1) & 1][0][np], kb + koff + np * 16 * RS + (kk + 1) * 16);
            ldsm4(bk[(kk + 1) & 1][1][np], klo + koff + np * 16 * RS + (kk + 1) * 16);
          }
        }
        if constexpr (Sh::QREG) {
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = qf[kk][i];
        } else {
          ldsm4(a, sm.q + (warp * 16 + (lane & 15)) * RS + kk * 16 + (lane >> 4) * 8);
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
          for (int np = 0; np < NB / 2; ++np) {
            const unsigned(&f)[4] = bk[kk & 1][half][np];
            mma16816(s[2 * np], a, f[0], f[1]);
            mma16816(s[2 * np + 1], a, f[2], f[3]);
          }
        }
        if constexpr (QF) {   // + Q_lo K_hi
          ldsm4(a, sm.ql + (warp * 16 + (lane & 15)) * RS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int np = 0; np < NB / 2; ++np) {
            const unsigned(&f)[4] = bk[kk & 1][0][np];
            mma16816(s[2 * np], a, f[0], f[1]);
            mma16816(s[2 * np + 1], a, f[2], f[3]);
          }
        }
      }
      // scale, K scale and mask per column; the row max over its quad
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int col = nb * 8 + 2 * (lane & 3);
        const int2 p = *reinterpret_cast<const int2*>(cpos + col);
        const float2 ksc =
            sks ? *reinterpret_cast<const float2*>(cks + col) : make_float2(1.0f, 1.0f);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int pi = i & 1 ? p.y : p.x;
          const bool ok = pi >= 0 && pi <= (i < 2 ? qpa : qpb);
          s[nb][i] = ok ? s[nb][i] * scale * (i & 1 ? ksc.y : ksc.x) : NEG_INF;
          mx[i >> 1] = fmaxf(mx[i >> 1], s[nb][i]);
        }
      }
      // the running max, and the one the exponents subtract: 0 while a row
      // has seen nothing, so a masked score (NEG_INF) gives exactly 0
      // without a branch
      float alpha[2], msub[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        alpha[h] = expf(m[h] - m_new);
        m[h] = m_new;
        msub[h] = m_new > NEG_INF ? m_new : 0.0f;
      }
      // probabilities (exact 0 where masked), their row sums, P x V scale
      // as a high and a low bf16 half
      unsigned pa[KP][4], pl[KP][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const float2 vsc = svs ? *reinterpret_cast<const float2*>(cvs + nb * 8 + 2 * (lane & 3))
                               : make_float2(1.0f, 1.0f);
        float pv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float e = expf(s[nb][i] - msub[i >> 1]);
          sum[i >> 1] += e;
          pv[i] = e * (i & 1 ? vsc.y : vsc.x);
        }
        unsigned& h0 = pa[nb >> 1][(nb & 1) * 2 + 0];
        unsigned& h1 = pa[nb >> 1][(nb & 1) * 2 + 1];
        h0 = pack_bf16(pv[0], pv[1]);
        h1 = pack_bf16(pv[2], pv[3]);
        pl[nb >> 1][(nb & 1) * 2 + 0] = pack_bf16(pv[0] - bf16_lo(h0), pv[1] - bf16_hi(h0));
        pl[nb >> 1][(nb & 1) * 2 + 1] = pack_bf16(pv[2] - bf16_lo(h1), pv[3] - bf16_hi(h1));
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
        l[h] = alpha[h] * l[h] + sum[h];
      }
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        o[i][0] *= alpha[0];
        o[i][1] *= alpha[0];
        o[i][2] *= alpha[1];
        o[i][3] *= alpha[1];
      }
      // O += P_hi V + P_lo V (+ P_hi V_lo on the f32 store): per k step, the
      // tile's V fragments, then the products
      const int voff = (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < KP; ++kk) {
        unsigned bv[ND / 2][4];
#pragma unroll
        for (int dp = 0; dp < ND / 2; ++dp)
          ldsm4_t(bv[dp], vb + (kk * 16 + voff) * RS + dp * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int dp = 0; dp < ND / 2; ++dp) {
          mma16816(o[2 * dp], pa[kk], bv[dp][0], bv[dp][1]);
          mma16816(o[2 * dp + 1], pa[kk], bv[dp][2], bv[dp][3]);
        }
#pragma unroll
        for (int dp = 0; dp < ND / 2; ++dp) {
          mma16816(o[2 * dp], pl[kk], bv[dp][0], bv[dp][1]);
          mma16816(o[2 * dp + 1], pl[kk], bv[dp][2], bv[dp][3]);
        }
        if constexpr (NV == 2) {
#pragma unroll
          for (int dp = 0; dp < ND / 2; ++dp)
            ldsm4_t(bv[dp], vlo + (kk * 16 + voff) * RS + dp * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int dp = 0; dp < ND / 2; ++dp) {
            mma16816(o[2 * dp], pa[kk], bv[dp][0], bv[dp][1]);
            mma16816(o[2 * dp + 1], pa[kk], bv[dp][2], bv[dp][3]);
          }
        }
      }
    }
    __syncthreads();
  }
  cp_wait<0>();

  // the rows' outputs, or their partials when the slot range is split
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = h ? rb : ra;
    if (r >= nrows) continue;
    const size_t row = ((size_t)b * T + tq0 + r / gs) * H + hq + r % gs;
    const int c0 = 2 * (lane & 3);
    if (nsplit == 1) {
      const float den = fmaxf(l[h], 1e-30f);
      QT* dst = out + row * (PAD ? D : DP) + c0;
#pragma unroll
      for (int i = 0; i < ND; ++i)
        if (!PAD || c0 + 8 * i < D) {
          if constexpr (QF)
            *reinterpret_cast<float2*>(dst + 8 * i) =
                make_float2(o[i][2 * h] / den, o[i][2 * h + 1] / den);
          else
            *reinterpret_cast<__nv_bfloat162*>(dst + 8 * i) =
                __floats2bfloat162_rn(o[i][2 * h] / den, o[i][2 * h + 1] / den);
        }
    } else {
      const size_t pr = row * nsplit + sp;
      if ((lane & 3) == 0) {
        part_m[pr] = m[h];
        part_l[pr] = l[h];
      }
      if (l[h] > 0.0f) {
        float* dst = part_acc + pr * (PAD ? D : DP) + c0;
#pragma unroll
        for (int i = 0; i < ND; ++i)
          if (!PAD || c0 + 8 * i < D)
            *reinterpret_cast<float2*>(dst + 8 * i) = make_float2(o[i][2 * h], o[i][2 * h + 1]);
      }
    }
  }
}

// --- host launchers ---------------------------------------------------------------

// one launch of the decode body with GC query heads a CTA
template <int DP, class KV, class Addr, int GC, class QT>
int decode_launch(const DecArgs<KV, QT>& a, const Addr& addr, int B, cudaStream_t st) {
  const int nsplit = (a.S + a.split - 1) / a.split;
  const size_t smem = DecSmem<DP, KV, GC>::bytes(a.split, nsplit);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidConfiguration;
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_kernel<DP, KV, Addr, GC, QT>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const int nhc = (a.H / a.Hkv + GC - 1) / GC;
  decode_kernel<DP, KV, Addr, GC, QT>
      <<<dim3(B * a.Hkv * nhc, nsplit), DEC_THREADS, smem, st>>>(a, addr);
  return (int)cudaGetLastError();
}

// Kernels C and E (k_new == nullptr), N (write == 0) and P (write == 1,
// dense rows only: k/v/ks/vs are the layer's whole store, slots [B*S + 1]
// with the spare slot pad_slot = B*S), one launch. `work` holds the
// partials when a row spans more than one split (f32: m and l [B, H,
// nsplit], acc [B, H, nsplit, D]); `tickets` [B * Hkv * chunks] are zero
// between calls (the last CTA of each group leaves its ticket at zero).
// `heads` is the host's head chunk: 4, or 8 at DP <= 128. QT is the query,
// output and fresh-row type: bf16, or f32 (C, E, N and P of an f32 model).
template <int DP, class KV, class Addr, class QT = __nv_bfloat16>
int decode_impl(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                const void* kv_pos, const void* q_pos, const void* invf, const void* k_new,
                const void* v_new, const void* slot, void* work, void* tickets, void* out,
                Addr addr, int B, int H, int Hkv, int D, int S, int split, int heads, int write,
                float scale, cudaStream_t st) {
  if (!(heads == 4 || (heads == 8 && DP <= 128)) || split < DEC_GRAIN || split % DEC_GRAIN ||
      H % Hkv || D > DP)
    return (int)cudaErrorInvalidValue;
  const int nsplit = (S + split - 1) / split;
  if (nsplit > 1 && (!work || !tickets)) return (int)cudaErrorInvalidValue;
  // the widest piece one cp.async moves: both stores and every row aligned to it
  const uintptr_t al = reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
                       (uintptr_t)(D * sizeof(KV));
  const int piece = al % 16 == 0 ? 16 : al % 8 == 0 ? 8 : al % 4 == 0 ? 4 : 2;
  float* part = static_cast<float*>(work);
  const size_t nparts = (size_t)B * H * nsplit;
  const Fresh<KV, QT> fresh{static_cast<const QT*>(k_new), static_cast<const QT*>(v_new),
                            static_cast<const int*>(slot),
                            const_cast<KV*>(static_cast<const KV*>(k)),
                            const_cast<KV*>(static_cast<const KV*>(v)),
                            const_cast<float*>(static_cast<const float*>(ks)),
                            const_cast<float*>(static_cast<const float*>(vs)),
                            (long long)B * S, write};
  const DecArgs<KV, QT> a{static_cast<const QT*>(q), static_cast<const KV*>(k),
                      static_cast<const KV*>(v), static_cast<const float*>(ks),
                      static_cast<const float*>(vs), static_cast<const int*>(kv_pos),
                      static_cast<const int*>(q_pos), static_cast<const float*>(invf),
                      part, part ? part + nparts : nullptr, part ? part + 2 * nparts : nullptr,
                      static_cast<int*>(tickets), static_cast<QT*>(out),
                      H, Hkv, D, S, split, piece, scale, fresh};
  if constexpr (DP <= 128)
    if (heads == 8) return decode_launch<DP, KV, Addr, 8, QT>(a, addr, B, st);
  return decode_launch<DP, KV, Addr, 4, QT>(a, addr, B, st);
}

// Kernel O over dense rows: the angles, then the body (its last CTAs fold
// the splits). The host's plan (ops/decode_attention.hb_plan) gives `ts`
// slots a tile (hb_tile) and `heads` query heads a CTA (up to HB_HEADS);
// the CTA takes the pipelined steps over a ring of 4 tiles where they fit a
// block, else the single steps over a ring of 4 or 3 (neither moves a bit).
// `ang` is the angles' scratch, [B*S, D] f32; `tickets` [B * Hkv * head
// chunks] are zero between calls. The stores and the scratch lie on 16-byte
// boundaries (the copies move 16-byte pieces). QT is the query and output
// type: bf16, or f32 (O of an f32 model).
template <int D, class KV, class Addr, class QT = __nv_bfloat16>
int decode_hb_impl(const void* q, const void* k, const void* v, const void* ks,
                   const void* vs, const void* kv_pos, const void* q_pos,
                   const void* invf, void* ang, void* part_m, void* part_l, void* part_acc,
                   void* tickets, void* out, Addr, int B, int H, int Hkv, int S, int chunk,
                   int ts, int heads, float scale, cudaStream_t st) {
  if (ts < 1 || ts > HB_MAX_TS || heads < 1 || heads > HB_HEADS || chunk < 1 || H % Hkv ||
      (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
       reinterpret_cast<uintptr_t>(ang)) % 16)
    return (int)cudaErrorInvalidValue;
  const int ntl = ((chunk < S ? chunk : S) + ts - 1) / ts;
  int stages = 4, pipe = 1;
  if (HbSmem<D, KV>::bytes(ts, stages, ntl) > (size_t)MAX_SMEM) pipe = 0;
  if (!pipe && HbSmem<D, KV>::bytes(ts, stages, ntl) > (size_t)MAX_SMEM) stages = 3;
  const size_t smem = HbSmem<D, KV>::bytes(ts, stages, ntl);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidConfiguration;
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_hb_kernel<D, KV, QT>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const HbArgs<KV, QT> a{static_cast<const QT*>(q), static_cast<const KV*>(k),
                         static_cast<const KV*>(v), static_cast<const float*>(ks),
                         static_cast<const float*>(vs), static_cast<const int*>(kv_pos),
                         static_cast<const int*>(q_pos), static_cast<const float*>(ang),
                         static_cast<float*>(part_m), static_cast<float*>(part_l),
                         static_cast<float*>(part_acc), static_cast<int*>(tickets),
                         static_cast<QT*>(out), H, Hkv, S, chunk, ts, heads, stages, pipe,
                         scale};
  hb_angles_kernel<D><<<dim3((S * (D / 2) + 255) / 256, B), 256, 0, st>>>(
      static_cast<const int*>(kv_pos), static_cast<const int*>(q_pos),
      static_cast<const float*>(invf), static_cast<float*>(ang), S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nhc = (H / Hkv + heads - 1) / heads, nsplit = (S + chunk - 1) / chunk;
  decode_hb_kernel<D, KV, QT><<<dim3(B * Hkv * nhc, nsplit), HB_THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// Kernels D and F: the stage pass into the scratch (kr [B, Hkv, Sp, 2, DP],
// vr [B, Hkv, Sp, NV, DP] bf16, spos [B, Sp], tmin [B, Sp / TS], sks / svs
// [B, Hkv, Sp] for an int8 store; Sp = S rounded up to whole tiles), then
// `tq` tokens a CTA (tq * min(H / Hkv, PF_ROWS) <= PF_ROWS rows; tq = 1 where
// a group has more heads) over splits of `split` slots (a multiple of the
// tile; one split: no partials, no combine). Partials are [B, T, H,
// nsplit(, D)], folded by the combine. QT is the query and output type:
// bf16, or f32 (D and F of an f32 model).
template <int DP, class KV, class Addr, class QT = __nv_bfloat16>
int prefill_impl(const void* q, const void* k, const void* v, const void* ks,
                 const void* vs, const void* kv_pos, const void* q_pos,
                 const void* invf, void* kr, void* vr, void* spos, void* tmin, void* sks,
                 void* svs, void* part_m, void* part_l, void* part_acc, void* out, Addr addr, int B,
                 int T, int H, int Hkv, int D, int S, int tq, int split, float scale,
                 cudaStream_t st) {
  constexpr int TS = PF_TS, NV = PfV<KV>::NV;
  const int g = H / Hkv, nsl = (g + PF_ROWS - 1) / PF_ROWS;
  const int rows = tq * (g < PF_ROWS ? g : PF_ROWS);
  if (tq < 1 || rows > PF_ROWS || split < 1 || ((ks != nullptr) != (sks != nullptr)) || D > DP)
    return (int)cudaErrorInvalidValue;
  const int nsplit = (S + split - 1) / split;
  if (nsplit > 1 && (split % TS || !part_m || !part_l || !part_acc))
    return (int)cudaErrorInvalidValue;
  const int Sp = (S + TS - 1) / TS * TS;
  // the bodies with the guards of a padded width and of head slices only
  // where D is not the width or a group has more than PF_ROWS heads
  const bool pad = D != DP || nsl > 1;
  auto stage = pad ? prefill_stage_kernel<DP, KV, Addr, true>
                   : prefill_stage_kernel<DP, KV, Addr, false>;
  auto mma = pad ? prefill_mma_kernel<DP, NV, true, QT> : prefill_mma_kernel<DP, NV, false, QT>;
  stage<<<dim3(B * Hkv, Sp / TS), PF_STAGE_THREADS, 0, st>>>(
      static_cast<const KV*>(k), static_cast<const KV*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(kv_pos),
      static_cast<const int*>(q_pos), static_cast<const float*>(invf),
      static_cast<__nv_bfloat16*>(kr), static_cast<__nv_bfloat16*>(vr),
      static_cast<int*>(spos), static_cast<int*>(tmin), static_cast<float*>(sks),
      static_cast<float*>(svs), addr, T, Hkv, S, Sp, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nw = (rows + 15) / 16;
  const size_t smem = PfSmem<DP, NV, std::is_same<QT, float>::value>::bytes(
      nw, ((split < S ? split : S) + TS - 1) / TS);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidConfiguration;
  cudaFuncSetAttribute(mma, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid(B * Hkv, (T + tq - 1) / tq * nsl, nsplit);
  mma<<<grid, 32 * nw, smem, st>>>(
      static_cast<const QT*>(q), static_cast<const __nv_bfloat16*>(kr),
      static_cast<const __nv_bfloat16*>(vr), static_cast<const int*>(spos),
      static_cast<const int*>(tmin), static_cast<const float*>(sks),
      static_cast<const float*>(svs),
      static_cast<const int*>(q_pos), static_cast<float*>(part_m),
      static_cast<float*>(part_l), static_cast<float*>(part_acc),
      static_cast<QT*>(out), T, H, Hkv, S, Sp, tq, split, scale, D);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return (int)err;
  decode_combine_kernel<QT><<<B * T * H, D, 0, st>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<QT*>(out), nsplit, D);
  return (int)cudaGetLastError();
}

// Pick the instantiation for head dim D and store type kv_type (0 = int8
// codes with scales, 1 = bf16, 2 = f32): kernel O's at D itself (64, 128 or
// 256), -1 for any other combination; QT is the query and output type
// (ATTN_DISPATCH: bf16).
#define ATTN_DISPATCH_Q(IMPL, ADDR, QT, ...)                                    \
  do {                                                                          \
    if (kv_type == 0) {                                                         \
      switch (D) {                                                              \
        case 64: return IMPL<64, int8_t, ADDR, QT>(__VA_ARGS__);                \
        case 128: return IMPL<128, int8_t, ADDR, QT>(__VA_ARGS__);              \
        case 256: return IMPL<256, int8_t, ADDR, QT>(__VA_ARGS__);              \
      }                                                                         \
    } else if (kv_type == 1) {                                                  \
      switch (D) {                                                              \
        case 64: return IMPL<64, __nv_bfloat16, ADDR, QT>(__VA_ARGS__);         \
        case 128: return IMPL<128, __nv_bfloat16, ADDR, QT>(__VA_ARGS__);       \
        case 256: return IMPL<256, __nv_bfloat16, ADDR, QT>(__VA_ARGS__);       \
      }                                                                         \
    } else if (kv_type == 2) {                                                  \
      switch (D) {                                                              \
        case 64: return IMPL<64, float, ADDR, QT>(__VA_ARGS__);                 \
        case 128: return IMPL<128, float, ADDR, QT>(__VA_ARGS__);               \
        case 256: return IMPL<256, float, ADDR, QT>(__VA_ARGS__);               \
      }                                                                         \
    }                                                                           \
    return -1;                                                                  \
  } while (0)
#define ATTN_DISPATCH(IMPL, ADDR, ...) ATTN_DISPATCH_Q(IMPL, ADDR, __nv_bfloat16, __VA_ARGS__)

// The bodies of C-F and N, P at the padded width for an even D <= 256 (the
// smallest of 64, 128, 256 that holds it), which take D at run time; QT is
// the query and output type (ATTN_DISPATCH_PADDED: bf16).
#define ATTN_DISPATCH_PADDED_Q(IMPL, ADDR, QT, ...)                             \
  do {                                                                          \
    if (D < 2 || D > 256 || D % 2) return -1;                                   \
    const int DPAD = D <= 64 ? 64 : D <= 128 ? 128 : 256;                       \
    if (kv_type == 0) {                                                         \
      switch (DPAD) {                                                           \
        case 64: return IMPL<64, int8_t, ADDR, QT>(__VA_ARGS__);                \
        case 128: return IMPL<128, int8_t, ADDR, QT>(__VA_ARGS__);              \
        case 256: return IMPL<256, int8_t, ADDR, QT>(__VA_ARGS__);              \
      }                                                                         \
    } else if (kv_type == 1) {                                                  \
      switch (DPAD) {                                                           \
        case 64: return IMPL<64, __nv_bfloat16, ADDR, QT>(__VA_ARGS__);         \
        case 128: return IMPL<128, __nv_bfloat16, ADDR, QT>(__VA_ARGS__);       \
        case 256: return IMPL<256, __nv_bfloat16, ADDR, QT>(__VA_ARGS__);       \
      }                                                                         \
    } else if (kv_type == 2) {                                                  \
      switch (DPAD) {                                                           \
        case 64: return IMPL<64, float, ADDR, QT>(__VA_ARGS__);                 \
        case 128: return IMPL<128, float, ADDR, QT>(__VA_ARGS__);               \
        case 256: return IMPL<256, float, ADDR, QT>(__VA_ARGS__);               \
      }                                                                         \
    }                                                                           \
    return -1;                                                                  \
  } while (0)
#define ATTN_DISPATCH_PADDED(IMPL, ADDR, ...) \
  ATTN_DISPATCH_PADDED_Q(IMPL, ADDR, __nv_bfloat16, __VA_ARGS__)

}  // namespace attn
