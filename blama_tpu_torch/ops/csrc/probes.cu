// Card microbenchmark kernels of the tools, CUDA C++ for Hopper (sm_90a).
//
// Kernel R (stream_rows_launch) replaces
//   blama_tpu/tools/probe_bw.py:_stream_kernel:
// codes uint8 [R, N] in blocks of [bk, bn] bytes, grid (N / bn, R / bk):
// out[0, n] = sum over the blocks of column n of the block's first 8 rows
// (fewer when bk < 8), as exact f32 integers. The TPU kernel's BlockSpec DMA
// brings the whole block into VMEM and sums 8 rows of it, so it measures the
// memory pipeline alone. Here one CTA owns one block and every byte of it
// lands in shared memory. Bound on this card: bytes (each block's bk * bn
// bytes, at most 8 adds a column). With at most a CTA an SM (the
// reference's blocks give 6) what bounds a block is the bytes its SM keeps
// in flight: one producer thread issues a TMA box a slot (rows of bn
// contiguous bytes) into a ring of slots of whole rows (probes.stream_plan:
// 32 KB slots, up to 8, as many as fit: six at the reference's blocks),
// each with a "full" and an "empty" mbarrier; the consumer warps wait for
// the pieces that hold the first 8 rows, sum them and release the slots,
// and the producer retires the other pieces, with no CTA barrier in the
// loop. A grid with more CTAs than SMs is bound by the card's memory, where
// every thread's 16-byte cp.async, two pieces in flight, reaches more of it
// (stream_rows_cp_kernel). The sums are integers below 2^24, exact in f32
// in any order, so the CTAs of a column add theirs to the output with
// atomicAdd (zeroed by the caller) and the bits do not depend on the order.
// With a `total` output the CTA also sums every byte it staged, per column:
// the proof that every byte reached the SM.
//
// Kernel S (add_one_launch) replaces
//   blama_tpu/tools/probe_overhead.py:_tiny_kernel:
// o = x + 1.0f on a small f32 array (the probe's [8, 128], one CTA): the
// least work a launch can carry, so a chain of them measures the cost of a
// launch (eager, or replayed from a CUDA graph). Bound on this card: one
// round trip to memory (4 KB at the probe). Each thread issues all its
// loads before its stores: one 16-byte vector where both pointers are
// aligned, and the n % 4 tail as one scalar on the first threads (else one
// scalar a thread), so the CTA waits on memory once; a grid-stride loop of
// scalar loads waited once per trip (PERF.md §6, row 16b). The grid covers n, one
// CTA up to 1024 elements.
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
// The reference's dots run on the TPU's matrix unit; here they run on the
// int8 tensor cores (mma.sync m16n8k32 s8, the unit the W4A8 GEMV's group
// dots use). Bound on this card: bytes (b is read once; 2*M ops a byte at
// M = 32, far below the int8 rate). So the design keeps the stream full:
//   - a CTA owns 64 columns of b and all of K; 224 CTAs at the 8B FFN
//     plane's 14336 columns, all resident at once (two an SM at most);
//   - b and a's rows reach shared memory through a cp.async ring of
//     D_STAGES stages of 64 K rows (4 KB of b a stage, seven stages in
//     flight), one CTA barrier a stage, the ring's own;
//   - four warps: two column halves of 32 times the stage's two k32 steps,
//     whose sums are added once at the end through shared memory;
//   - the B fragment wants four K-consecutive bytes of one column a lane,
//     and b lies [K][N]: lane (g, t) reads the word of columns 4g..4g+3 in
//     rows 4t..4t+3 (and 16+4t..) and transposes the 4x4 bytes with eight
//     prmt, so n8 tile j holds the columns 4g + j; a lane's outputs are then
//     8 consecutive columns, stored as two 16-byte words. b's rows are
//     XOR-swizzled in 16-byte chunks so these reads hit 32 banks;
//   - a's rows fill two m16 tiles (zeros past M), staged as they lie,
//     swizzled so that one ldmatrix.x4 a tile reads the A fragment without
//     a bank conflict;
//   - the SWAR masks act per byte, so they apply to the words before the
//     transpose; the swar dot adds lo + hi per byte (<= 30, no carry) and
//     runs one product, the unpack dot two.
// What is left above the stream: every CTA copies all of a from L2 (64 KB at
// the 8B plane, 14.7 MB over the grid beside b's 29.4), and the ring's fill
// and drain. Where every row of a and b is 16-byte aligned the copies are
// 16 bytes wide; else b goes in 4-byte copies and a byte by byte (another
// instance of the kernel). Integer sums are exact in any order.
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
// One CTA each, as the reference's grid-less calls: the arrays are at most
// 32 KB, so a probe's time is its launch and one memory round trip. Bound:
// that latency. The copies, the group max and the round therefore take a
// compile-time thread and trip count and issue all of a thread's loads
// (16-byte vectors where both pointers allow) before its first store, so
// the loads wait together and not one after another.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tma_ring.cuh"

namespace {

constexpr int R_WARPS = 8;         // consumer warps of a CTA, beside one producer warp
constexpr int R_THREADS = 256;     // threads of the cp.async form's CTA
constexpr int R_PIECE = 32 * 1024; // bytes of one of its pieces
constexpr int R_MAX_BN = 16384;    // widest block a CTA takes
constexpr int R_MAX_SLOTS = 8;     // slots of the ring at most
constexpr int R_BAR_BYTES = 128;   // the ring's barriers, before the sums
constexpr int R_SMEM_MAX = 232448; // an H100's shared memory for one CTA

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

__host__ __device__ constexpr size_t r_round128(size_t b) { return (b + 127) / 128 * 128; }

// One CTA a [bk, bn] block: the producer thread brings the block into a ring
// of `slots` slots of `rps` rows, one box of the map a slot (the block's
// rows past bk come as zeros and are not summed). The consumer warps take
// the pieces that hold any of the first 8 rows (all of them with `total`):
// wait for each, add its rows into their columns' sums in shared memory (a
// thread owns 4-column words, so no barrier) and release the slot. The
// producer retires every other piece itself: it waits for the piece to land
// before it reuses the slot, and for the last ones before it exits, so
// every byte of the block lands in shared memory before the CTA ends while
// no consumer waits on a piece it does not read.
__global__ void __launch_bounds__((R_WARPS + 1) * 32)
stream_rows_kernel(const __grid_constant__ CUtensorMap map, int bk, int bn, int inner, int rps,
                   int slots, float* __restrict__ out, float* __restrict__ total) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + slots;
  float* s_acc = reinterpret_cast<float*>(smem + R_BAR_BYTES);  // [bn]: the first 8 rows
  float* s_tot = s_acc + bn;                                     // [bn]: every row (total)
  uint8_t* ring = smem + R_BAR_BYTES + r_round128((size_t)(total ? 2 : 1) * bn * sizeof(float));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int npieces = (bk + rps - 1) / rps;
  const int read = total ? npieces : min(npieces, (8 + rps - 1) / rps);  // pieces consumed
  const size_t slot = r_round128((size_t)rps * bn);
  if (threadIdx.x == 0) {
    for (int d = 0; d < slots; ++d) {
      tma::bar_init(full + d, 1);
      tma::bar_init(empty + d, R_WARPS);
    }
    tma::fence_init();
  }
  __syncthreads();

  if (warp == R_WARPS) {  // the producer
    if (lane == 0) {
      for (int p = 0; p < npieces; ++p) {
        const int d = p % slots, q = p - slots;  // q: the slot's last piece
        if (q >= 0) tma::wait((q < read ? empty : full) + d, (q / slots) & 1);
        tma::arrive_expect(full + d, (uint32_t)rps * bn);
        tma::copy4d(ring + d * slot, &map, 0, blockIdx.x * (bn / inner), p * rps, blockIdx.y,
                    full + d);
      }
      for (int q = max(read, npieces - slots); q < npieces; ++q)
        tma::wait(full + q % slots, (q / slots) & 1);
    }
    return;
  }

  const int nw = bn / 4;  // 4-column words of a row
  float4* acc = reinterpret_cast<float4*>(s_acc);
  float4* tot = reinterpret_cast<float4*>(s_tot);
  for (int c = threadIdx.x; c < nw; c += R_WARPS * 32) {
    acc[c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (total) tot[c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  for (int p = 0; p < read; ++p) {
    const int d = p % slots, r0 = p * rps, rows = min(rps, bk - r0);
    const int r8 = min(rows, 8 - r0);      // rows of the first 8 in this piece
    const int nr = total ? rows : r8;      // rows read here
    tma::wait(full + d, (p / slots) & 1);
    const uint32_t* src = reinterpret_cast<const uint32_t*>(ring + d * slot);
    for (int c = threadIdx.x; c < nw; c += R_WARPS * 32) {
      float4 a = acc[c], t = total ? tot[c] : a;
      for (int r = 0; r < nr; ++r) {
        const uint32_t w = src[(size_t)r * nw + c];
        const float b0 = (float)(w & 0xFFu), b1 = (float)((w >> 8) & 0xFFu);
        const float b2 = (float)((w >> 16) & 0xFFu), b3 = (float)(w >> 24);
        if (r < r8) a.x += b0, a.y += b1, a.z += b2, a.w += b3;
        t.x += b0, t.y += b1, t.z += b2, t.w += b3;
      }
      acc[c] = a;
      if (total) tot[c] = t;
    }
    __syncwarp();
    if (lane == 0) tma::arrive(empty + d);
  }
  const size_t n0 = (size_t)blockIdx.x * bn;
  for (int c = threadIdx.x; c < nw; c += R_WARPS * 32) {  // the thread's own words
    const float4 a = acc[c];
    float* o = out + n0 + 4 * c;
    atomicAdd(o, a.x), atomicAdd(o + 1, a.y), atomicAdd(o + 2, a.z), atomicAdd(o + 3, a.w);
    if (total) {
      const float4 t = tot[c];
      float* u = total + n0 + 4 * c;
      atomicAdd(u, t.x), atomicAdd(u + 1, t.y), atomicAdd(u + 2, t.z), atomicAdd(u + 3, t.w);
    }
  }
}

// A grid with more CTAs than SMs: every thread's 16-byte cp.async, two
// pieces of at most R_PIECE bytes in flight, the CTA synchronised on each.
// There the card's memory is the bound, and this fill reaches more of it
// than the TMA ring (PERF.md, PR 17).
__global__ void __launch_bounds__(R_THREADS)
stream_rows_cp_kernel(const uint8_t* __restrict__ codes, int N, int bk, int bn,
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

constexpr int S_THREADS = 256;

// VEC: thread i takes float4 i and, below n % 4, the tail's element i;
// else element i
template <bool VEC>
__global__ void __launch_bounds__(S_THREADS)
add_one_kernel(const float* __restrict__ x, float* __restrict__ o, int n) {
  const int i = blockIdx.x * S_THREADS + threadIdx.x;
  if constexpr (VEC) {
    const int nv = n >> 2, t = (nv << 2) + i;
    const bool body = i < nv, tail = t < n;
    float4 v;
    float w;
    if (body) v = __ldg(reinterpret_cast<const float4*>(x) + i);
    if (tail) w = __ldg(x + t);
    if (body) reinterpret_cast<float4*>(o)[i] = make_float4(v.x + 1.0f, v.y + 1.0f,
                                                            v.z + 1.0f, v.w + 1.0f);
    if (tail) o[t] = w + 1.0f;
  } else if (i < n) {
    o[i] = __ldg(x + i) + 1.0f;
  }
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
constexpr int D_BN = 64;                   // columns a CTA owns
constexpr int D_KT = 64;                   // K rows a stage carries: two k32 steps
constexpr int D_THREADS = 128;             // 2 column halves x 2 k32 steps
constexpr int D_STAGES = 8;                // the ring
constexpr int D_MAXM = 32;                // two m16 tiles of a's rows
constexpr int D_BSTAGE = D_KT * D_BN;      // bytes of b a stage
constexpr uint32_t D_NIB = 0x0F0F0F0Fu;

template <int MODE>
struct DotShape {
  static constexpr int NA = MODE == UNPACK_DOT ? 2 : 1;   // a halves: a[:, k], a[:, K + k]
  static constexpr int AHALF = D_MAXM * D_KT;              // bytes of a half's rows a stage
  static constexpr int STAGE = D_BSTAGE + NA * AHALF;
  static constexpr int SMEM = D_STAGES * STAGE;
};

// byte offset of 16-byte chunk c (0..3) of b's row r in a stage: two rows a
// 128-byte line, the chunk XORed with 2 * ((r >> 2) & 3), so the rows
// 4t + r' (t = 0..3) a warp reads at once fall in four bank groups
__device__ __forceinline__ int d_boff(int r, int c) {
  return (r >> 1) * 128 + (((((r & 1) << 2) | c) ^ (((r >> 2) & 3) << 1)) << 4);
}

// byte offset of 16-byte chunk c (0..3) of a's row r in a stage: two rows a
// line, the chunk XORed with (r >> 1) & 3, so the 8 rows an ldmatrix reads
// at one chunk fall in eight bank groups
__device__ __forceinline__ int d_aoff(int r, int c) {
  return (r >> 1) * 128 + (((((r & 1) << 2) | c) ^ ((r >> 1) & 3)) << 4);
}

__device__ __forceinline__ void cp_async16z(void* smem, const void* gmem, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async4z(void* smem, const void* gmem, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}

// the A fragment of a 16 x 32 s8 tile: ldmatrix.x4 of its four 8 x 16-byte
// quarters (rows 0-7 / 8-15 at k 0-15, then at k 16-31); lane l gives the
// address of row l % 8 of quarter l / 8
__device__ __forceinline__ uint4 d_ldsm4(const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  uint4 r;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "r"(s));
  return r;
}

// d += A B: A the 16 x 32 s8 fragment of a lane (a.x..a.w), B 32 x 8 (b0, b1)
__device__ __forceinline__ void d_mma(int (&d)[4], const uint4& a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// 4 x 4 bytes: v[r] holds byte j of row r; f[j] gets byte r of column j
__device__ __forceinline__ void d_transpose(const uint32_t (&v)[4], uint32_t (&f)[4]) {
  const uint32_t lo01 = __byte_perm(v[0], v[1], 0x5140), hi01 = __byte_perm(v[0], v[1], 0x7362);
  const uint32_t lo23 = __byte_perm(v[2], v[3], 0x5140), hi23 = __byte_perm(v[2], v[3], 0x7362);
  f[0] = __byte_perm(lo01, lo23, 0x5410);
  f[1] = __byte_perm(lo01, lo23, 0x7632);
  f[2] = __byte_perm(hi01, hi23, 0x5410);
  f[3] = __byte_perm(hi01, hi23, 0x7632);
}

// One stage of the ring: b's rows k0..k0+63 of the CTA's 64 columns and a's
// rows 0..31 at k0..k0+63 (each half h at h * AHALF), both swizzled, zeros
// past M, K and N. ALIGNED (every row of a and b 16-byte aligned): 16-byte
// copies only; else b in 4-byte copies and a byte by byte.
template <int MODE, bool ALIGNED>
__device__ __forceinline__ void dot_issue(uint8_t* slot, const int8_t* __restrict__ a,
                                          const uint8_t* __restrict__ b, int M, int K, int N,
                                          int k0, int n0) {
  using S = DotShape<MODE>;
#pragma unroll
  for (int j = 0; j < D_KT * 4 / D_THREADS; ++j) {
    const int i = threadIdx.x + j * D_THREADS, r = i >> 2, c = i & 3;
    const int k = k0 + r, n = n0 + 16 * c;
    uint8_t* dst = slot + d_boff(r, c);
    const uint8_t* src = b + (size_t)k * N + n;
    if constexpr (ALIGNED) {
      const bool ok = k < K && n < N;
      cp_async16z(dst, ok ? src : b, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool ok = k < K && n + 4 * q < N;
        cp_async4z(dst + 4 * q, ok ? src + 4 * q : b, ok ? 4 : 0);
      }
    }
  }
  constexpr int ACHUNKS = S::NA * D_MAXM * 4;
#pragma unroll
  for (int j = 0; j < (ACHUNKS + D_THREADS - 1) / D_THREADS; ++j) {
    const int i = threadIdx.x + j * D_THREADS;
    if (ACHUNKS % D_THREADS && i >= ACHUNKS) break;
    const int h = i / (D_MAXM * 4), row = (i >> 2) % D_MAXM, c = i & 3;
    const int k = k0 + 16 * c;
    uint8_t* dst = slot + D_BSTAGE + h * S::AHALF + d_aoff(row, c);
    const int8_t* src = a + (size_t)row * S::NA * K + h * K + k;
    if constexpr (ALIGNED) {
      const bool ok = row < M && k < K;
      cp_async16z(dst, ok ? src : a, ok ? 16 : 0);
    } else {
      uint32_t w[4] = {0, 0, 0, 0};
      if (row < M)
        for (int e = 0; e < 16; ++e)
          if (k + e < K) w[e >> 2] |= (uint32_t)(uint8_t)src[e] << (8 * (e & 3));
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

template <int MODE, bool ALIGNED>
__global__ void __launch_bounds__(D_THREADS)
int8_dot_kernel(const int8_t* __restrict__ a, const uint8_t* __restrict__ b,
                int32_t* __restrict__ out, int M, int K, int N) {
  using S = DotShape<MODE>;
  constexpr int MT = D_MAXM / 16;            // m16 tiles of a's rows
  extern __shared__ __align__(128) uint8_t dsm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int cg = warp & 1, kh = warp >> 1;   // column half, k32 step of a stage
  const int n0 = blockIdx.x * D_BN;
  const int nst = (K + D_KT - 1) / D_KT;
  // this lane's words of b in a stage: rows 32 kh + 16 h + 4 t + r, columns
  // 32 cg + 4g .. + 3 (chunk 2 cg + g / 4, word g % 4); its ldmatrix rows of
  // a: 16 mt + 8 (q % 2) + l % 8 at chunk 2 kh + q / 2 (q = l / 8)
  int boff[2][4], aoff[MT];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      boff[h][r] = d_boff(32 * kh + 16 * h + 4 * t + r, 2 * cg + (g >> 2)) + 4 * (g & 3);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    aoff[mt] = D_BSTAGE + d_aoff(16 * mt + 8 * ((lane >> 3) & 1) + (lane & 7),
                                 2 * kh + (lane >> 4));
  int acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][j][q] = 0;

#pragma unroll
  for (int s = 0; s < D_STAGES - 1; ++s) {
    if (s < nst)
      dot_issue<MODE, ALIGNED>(dsm + s * S::STAGE, a, b, M, K, N, s * D_KT, n0);
    cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<D_STAGES - 2>();           // stage s has landed (this thread's part)
    __syncthreads();                         // everyone's part; slot s - 1 is free
    const int sn = s + D_STAGES - 1;
    if (sn < nst)
      dot_issue<MODE, ALIGNED>(dsm + (sn % D_STAGES) * S::STAGE, a, b, M, K, N, sn * D_KT,
                               n0);
    cp_async_commit();
    const uint8_t* slot = dsm + (s % D_STAGES) * S::STAGE;
    uint32_t v[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < 4; ++r) v[h][r] = *reinterpret_cast<const uint32_t*>(slot + boff[h][r]);
    uint4 af[S::NA][MT];
#pragma unroll
    for (int h = 0; h < S::NA; ++h)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) af[h][mt] = d_ldsm4(slot + h * S::AHALF + aoff[mt]);
    if constexpr (MODE == UNPACK_DOT) {
      uint32_t lo[2][4], hi[2][4], flo[2][4], fhi[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          lo[h][r] = v[h][r] & D_NIB;
          hi[h][r] = (v[h][r] >> 4) & D_NIB;
        }
        d_transpose(lo[h], flo[h]);
        d_transpose(hi[h], fhi[h]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          d_mma(acc[mt][j], af[0][mt], flo[0][j], flo[1][j]);
          d_mma(acc[mt][j], af[1][mt], fhi[0][j], fhi[1][j]);
        }
    } else {
      uint32_t f[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if constexpr (MODE == SWAR_DOT) {
#pragma unroll
          for (int r = 0; r < 4; ++r) v[h][r] = (v[h][r] & D_NIB) + ((v[h][r] >> 4) & D_NIB);
        }
        d_transpose(v[h], f[h]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) d_mma(acc[mt][j], af[0][mt], f[0][j], f[1][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                           // the ring is free: fold the k32 steps there
  int* red = reinterpret_cast<int*>(dsm) + cg * (MT * 16 * 32) + lane;
  if (kh == 1) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) red[((mt * 4 + j) * 4 + q) * 32] = acc[mt][j][q];
  }
  __syncthreads();
  if (kh == 1) return;
  // acc[mt][j][q]: row 16 mt + g + 8 (q >> 1), column 32 cg + 8 t + 4 (q & 1) + j
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int row = 16 * mt + g + 8 * rh;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int q = 2 * rh + p, col = n0 + 32 * cg + 8 * t + 4 * p;
        int o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) o[j] = acc[mt][j][q] + red[((mt * 4 + j) * 4 + q) * 32];
        if (row >= M || col >= N) continue;
        *reinterpret_cast<int4*>(out + (size_t)row * N + col) = make_int4(o[0], o[1], o[2], o[3]);
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

// Four floats at p: one 16-byte load (VEC = 4, p 16-byte aligned) or four
// single ones (VEC = 1); and the store the same way.
template <int VEC>
__device__ __forceinline__ float4 ld4(const float* p) {
  if constexpr (VEC == 4) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], p[1], p[2], p[3]);
}
template <int VEC>
__device__ __forceinline__ void st4(float* p, float4 v) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = v;
  } else {
    p[0] = v.x; p[1] = v.y; p[2] = v.z; p[3] = v.w;
  }
}

// A copy through Map on THREADS threads, four elements a unit (every Map
// maps a run of 4 aligned outputs to 4 contiguous, aligned inputs): every
// thread issues all of its loads before its first store.
template <typename Map, int VEC, int THREADS>
__global__ void __launch_bounds__(THREADS)
map_copy_kernel(const float* __restrict__ x, float* __restrict__ o) {
  constexpr int NU = Map::n / 4, PER = (NU + THREADS - 1) / THREADS;
  float4 v[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = threadIdx.x + j * THREADS;
    if (NU % THREADS == 0 || i < NU) v[j] = ld4<VEC>(x + Map::src(4 * i));
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = threadIdx.x + j * THREADS;
    if (NU % THREADS == 0 || i < NU) st4<VEC>(o + 4 * i, v[j]);
  }
}

// k7: (8,128) -> (8,4), out (r, g) = max over lanes 32g..32g+31 of |x[r, lane]|
// (the reference's masked max takes 0 for the other groups: the same floor).
// 256 threads, four elements each; a group is 8 neighbouring lanes, folded
// by shuffles (max is exact in any order).
template <int VEC>
__global__ void __launch_bounds__(256) group_max_kernel(const float* __restrict__ x,
                                                        float* __restrict__ o) {
  const int i = threadIdx.x;
  const float4 v = ld4<VEC>(x + 4 * i);
  float m = fmaxf(fmaxf(fmaxf(fmaxf(0.0f, fabsf(v.x)), fabsf(v.y)), fabsf(v.z)), fabsf(v.w));
#pragma unroll
  for (int d = 4; d; d >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, d));
  if ((i & 7) == 0) o[i >> 3] = m;           // (r, g) = (i / 32, i / 8 % 4)
}

// k10: (8,128), rint(x * 3.7f) to int8 and back to f32; 256 threads, four each
template <int VEC>
__global__ void __launch_bounds__(256) round_int8_kernel(const float* __restrict__ x,
                                                         float* __restrict__ o) {
  const float4 v = ld4<VEC>(x + 4 * threadIdx.x);
  float4 r;
  r.x = (float)(int8_t)__float2int_rn(v.x * 3.7f);
  r.y = (float)(int8_t)__float2int_rn(v.y * 3.7f);
  r.z = (float)(int8_t)__float2int_rn(v.z * 3.7f);
  r.w = (float)(int8_t)__float2int_rn(v.w * 3.7f);
  st4<VEC>(o + 4 * threadIdx.x, r);
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
// total [N] f32 (or null) zeroed by the caller. The fill (probes.stream_plan):
// slots = 0, every thread's cp.async (stream_rows_cp_kernel); else the TMA
// ring of `slots` slots of `rps` rows (at most 256).
int stream_rows_launch(const void* codes, int R, int N, int bk, int bn, int rps, int slots,
                       void* out, void* total, void* stream) {
  if (bk < 1 || bn < 16 || bn % 16 || bn > R_MAX_BN || N % 16 || R / bk < 1 || N / bn < 1 ||
      R / bk > 65535 || slots < 0 || slots > R_MAX_SLOTS ||
      (slots && (rps < 1 || rps > bk || rps > 256)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(N / bn, R / bk);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  float* o = static_cast<float*>(out);
  float* t = static_cast<float*>(total);
  if (!slots) {
    const size_t smem =
        (size_t)(total ? 2 : 1) * bn * sizeof(float) + 2 * (size_t)(R_PIECE / bn) * bn;
    cudaError_t err = cudaFuncSetAttribute(stream_rows_cp_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    stream_rows_cp_kernel<<<grid, R_THREADS, smem, st>>>(c, N, bk, bn, o, t);
    return (int)cudaGetLastError();
  }
  const size_t smem = R_BAR_BYTES + r_round128((size_t)(total ? 2 : 1) * bn * sizeof(float)) +
                      (size_t)slots * r_round128((size_t)rps * bn);
  if (smem > (size_t)R_SMEM_MAX) return (int)cudaErrorInvalidValue;
  // codes as [R / bk][bk][N / inner][inner]: a box is `rps` rows of one
  // block's bn columns, inner the widest multiple of 16 up to 256 dividing bn
  int inner = 256;
  while (bn % inner) inner -= 16;
  CUtensorMap map;
  const cuuint64_t dims[4] = {(cuuint64_t)inner, (cuuint64_t)(N / inner), (cuuint64_t)bk,
                              (cuuint64_t)(R / bk)};
  const cuuint64_t strides[3] = {(cuuint64_t)inner, (cuuint64_t)N, (cuuint64_t)bk * N};
  const cuuint32_t box[4] = {(cuuint32_t)inner, (cuuint32_t)(bn / inner), (cuuint32_t)rps, 1};
  const int rc = tma::encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, codes, dims, strides, box);
  if (rc) return rc;
  cudaError_t err = cudaFuncSetAttribute(stream_rows_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  stream_rows_kernel<<<grid, (R_WARPS + 1) * 32, smem, st>>>(map, bk, bn, inner, rps, slots, o,
                                                              t);
  return (int)cudaGetLastError();
}

// Kernel S: o[i] = x[i] + 1 for i < n (0 <= n <= 2^20), a float4 a thread
// where x and o are 16-byte aligned, else a float a thread; one CTA at least.
int add_one_launch(const void* x, void* o, int n, void* stream) {
  if (n < 0 || n > (1 << 20)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(o);
  if (((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(o)) & 15) == 0) {
    const int items = max(max(n >> 2, n & 3), 1);
    add_one_kernel<true><<<(items + S_THREADS - 1) / S_THREADS, S_THREADS, 0, st>>>(xf, of, n);
  } else {
    add_one_kernel<false><<<(max(n, 1) + S_THREADS - 1) / S_THREADS, S_THREADS, 0, st>>>(xf, of,
                                                                                      n);
  }
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
// out int32 [M, N] (16-byte aligned); 1 <= M <= 32. One CTA a 64-column
// tile, over all of K.
int int8_dot_launch(int mode, const void* a, const void* b, void* out, int M, int K, int N,
                    void* stream) {
  if (M < 1 || M > D_MAXM || K < 1 || N < 4 || N % 4 ||
      reinterpret_cast<uintptr_t>(out) % 16 || reinterpret_cast<uintptr_t>(b) % 4)
    return (int)cudaErrorInvalidValue;
  const int grid = (N + D_BN - 1) / D_BN;
  const bool aligned = K % 16 == 0 && N % 16 == 0 &&
                       (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16 == 0;
  const int8_t* ai = static_cast<const int8_t*>(a);
  const uint8_t* bi = static_cast<const uint8_t*>(b);
  int32_t* o = static_cast<int32_t*>(out);
  auto run = [&](auto kernel, int smem) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, D_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(ai, bi, o, M, K, N);
    return (int)cudaGetLastError();
  };
  // the copies' width
  auto by_width = [&](auto mode_c) {
    constexpr int MODE = decltype(mode_c)::value;
    return aligned ? run(int8_dot_kernel<MODE, true>, DotShape<MODE>::SMEM)
                   : run(int8_dot_kernel<MODE, false>, DotShape<MODE>::SMEM);
  };
  switch (mode) {
    case SWAR_DOT: return by_width(std::integral_constant<int, SWAR_DOT>{});
    case I8_DOT: return by_width(std::integral_constant<int, I8_DOT>{});
    case UNPACK_DOT: return by_width(std::integral_constant<int, UNPACK_DOT>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"

namespace {

// one CTA for the copy through Map: a thread a unit of four up to 256 units
template <typename Map, int VEC>
void copy_launch(const float* x, float* o, cudaStream_t st) {
  constexpr int NU = Map::n / 4, T = NU >= 256 ? 256 : (NU + 31) / 32 * 32;
  map_copy_kernel<Map, VEC, T><<<1, T, 0, st>>>(x, o);
}

template <int VEC>
int casts_run(int probe, const float* x, float* o, cudaStream_t st) {
  switch (probe) {
    case 1: copy_launch<FlatCopy<1024>, VEC>(x, o, st); break;
    case 2: copy_launch<FlatCopy<1024>, VEC>(x, o, st); break;
    case 3: copy_launch<FlatCopy<32>, VEC>(x, o, st); break;
    case 4: copy_launch<LaneSlice, VEC>(x, o, st); break;
    case 5: copy_launch<FlatCopy<512>, VEC>(x, o, st); break;
    case 6: copy_launch<SublaneStride, VEC>(x, o, st); break;
    case 7: group_max_kernel<VEC><<<1, 256, 0, st>>>(x, o); break;
    case 8: copy_launch<FlatCopy<1024>, VEC>(x, o, st); break;
    case 9: copy_launch<FlatCopy<8192>, VEC>(x, o, st); break;
    case 10: round_int8_kernel<VEC><<<1, 256, 0, st>>>(x, o); break;
    case 11: row_select_dot_kernel<<<1, 256, 0, st>>>(x, o); break;
    case 12: scratch_store_kernel<<<1, 256, 0, st>>>(x, o); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernel Y: probe 1..12 of tools/probe_casts.py on its own shapes (x and o
// f32, contiguous, the probe's sizes), one CTA; 16-byte vectors where both
// pointers are 16-byte aligned.
int casts_launch(int probe, const void* x, void* o, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(o);
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(o)) % 16 == 0)
    return casts_run<4>(probe, xf, of, st);
  return casts_run<1>(probe, xf, of, st);
}

}  // extern "C"
