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
// which compute the same function: per (row, 32-group) of x, scale =
// amax/127 (IEEE division), inv = 1/scale (0 when scale is 0), q = rint(x*inv)
// as int8 (round half to even, like jnp.round), xsum = sum(q); then per
// output column n and group g the int32 dot of the activation codes with the
// 4-bit codes and acc += dot*(d*sc)*xscale - (xscale*xsum)*(dmin*mn).
// Bound on this card: bytes. The weights are K*N/2 code bytes plus
// 4*(K/32)*N bytes of bf16 scales and mins, about 0.625 bytes per weight,
// against 2*M int8 operations per weight: far below the ~600 operations a
// byte where the int8 tensor rate would bind, at every M <= 16.
// Design (w4a8_gemv_kernel, below; kernels I, J and M run the same body):
//   - one launch per call: each CTA quantizes the x it needs in the kernel,
//     with quant_acts_kernel's arithmetic, so every CTA holds the same codes
//     (the tiles of column block 0 also write them out when the caller asks;
//     the engines do not), and a call allocates only its output;
//   - wide CTAs, x staged once: a CTA owns tiles of 64/rw columns (the plan,
//     ops/quant_matmul.py gemv_plan, picks rw so that the grid is one wave of
//     the 132 SMs: 224 tiles of 64 at gate/up, 128 of 8 at wk/wv), walks
//     them in turn and keeps x's codes (up to 4096 K elements) while the next
//     tile needs the same rows; at gate/up and 8 rows, x leaves L2 132 times
//     (8 x 4096 bf16, 64 KB, ~8.4 MB in all) where the one-warp-per-column
//     kernel restaged it in each of 1792 CTAs (73 MB);
//   - the weight stream: each warp loads its 8 columns' next stage (1024 K
//     elements: codes, scales, mins) with 16-byte loads into registers while
//     it computes the current one from its own shared memory, where ldmatrix
//     hands out the mma fragments; no CTA-wide barrier per stage (only when
//     x's phase changes, and at a tile's end to add the residue splits). A
//     CTA-wide cp.async ring of 3-8 stages streamed at ~1.9-2.1 TB/s on the
//     card with its compute switched off and cost ~0.9 us a stage, so it went;
//   - int8 tensor cores: each group dot is one mma.m16n8k32 s8 (A: the
//     rows' codes, rows past M zero; B: 8 weight columns as the split layout
//     lies, low nibbles the first 16 k, high the last), the f32 term chain
//     on the CUDA cores; at one row x's row fills all 8 A rows, so a lane
//     holds its columns' dots of every group and takes one term per 4
//     groups (of the 8 a lane computes at 2-8 rows, only one row's are real
//     at one): the solo decode step's calls;
//   - the sum order of the one-warp-per-column kernel this replaced, kept
//     bit for bit: the terms of residue l = g mod 32 summed in group order,
//     the 32 partials added as the xor butterfly 16, 8, 4, 2, 1 adds them.
// The plan's rw (residue splits over warps) and grid move no bit.
//
// Kernel I (w4a8k4_matmul_launch, CUDA C++) replaces
//   blama_tpu/ops/pallas/quant_matmul.py:_a8k4_kernel:
// kernel A's function on the native superblocks, with f32 d*sc and dmin*mn
// decoded in the kernel (__half2float is exact for subnormals too), not
// bf16-rounded. The same body: a stage carries four whole 144-byte blocks of
// each column, the headers decode in the warp's shared memory, and ldmatrix of a
// 32-byte chunk's halves gives the B fragments of group 2c (low nibbles) and
// 2c+1 (high nibbles). Its order: residue l = (g mod 64) / 2, group 2l
// before 2l+1. Bound: bytes, 0.5625 per weight.
//
// The exact dequant GEMM (CUDA C++) serves kernels B, G, H, K and L, which
// differ only in the loader that stages and dequantizes a column's weights:
//   B (q4k_dequant_mm_launch) replaces
//     blama_tpu/ops/pallas/quant_matmul.py:221 _q4k_matmul_kernel:
//     out[m, n] = sum_k x[m, k] * code[n, k] * scale[n, k/32] in f32 (the min
//     term is applied by the caller, as q4k_matmul does outside its kernel),
//     scales bf16 or f32;
//   G (q8_dequant_mm_launch) replaces
//     blama_tpu/ops/pallas/quant_matmul.py:2056 _q8_matmul_kernel:
//     out[m, n] = sum_k x[m, k] * (float(code[n, k]) * scale[n, k/group]);
//   H (q4k_native_mm_launch) replaces
//     blama_tpu/ops/pallas/quant_matmul.py:938 _q4k_native_kernel:
//     per 32-group the positive dot as in B with scale = f32(d)*sc decoded in
//     the kernel, then minus (sum of the group's x) * (f32(dmin)*mn): the min
//     term is inside, as a 33rd step of the group's K loop;
//   K and L (below) replace :1811 _q4k_bank_kernel, :1391 _q4k_parts_kernel
//     and :1378 _q4k_pinned_kernel with B's loader and H's min term.
// The chain contract: every output element is one f32 chain, acc =
// fmaf(x[m,k], f32(code)*scale, acc) with k ascending from the first group of
// its K-block, and with a min row after each group's 32 steps acc =
// fmaf(xsum_g, -min_g, acc), xsum_g lane 0's value of the xor butterfly (16,
// 8, 4, 2, 1) over the group's 32 x, as an explicit tree. One body takes
// that chain at every row count: the tiles below, with one-row shapes for a
// single row (every solo decode step), so a row's bits depend neither on the
// rows beside it nor on the shape; parallelism is over (m, n) only, never
// over K (no split-K, no atomics). No tensor core: an mma sums its products
// in its own order.
// Bound on this card, for a design that keeps the chain, the largest of
// three terms: the bytes (weights, x, out) at 3.35 TB/s; 2*M*K*N f32
// operations at 67 TFLOP/s (above ~400 operations a Q4_K weight byte: every
// prompt chunk); and the chain's latency, K (+ K/32) dependent FMAs of ~4
// cycles each (8.3 us at K = 4096, 29 us at K = 14336, which bind the
// exact engines' 8-row decode). Design of the tiles:
//   - the ring: STAGES slots in shared memory filled by 16-byte cp.async
//     (4-byte ones for runs of scales and mins at any 2-byte alignment), so
//     stages s+1 .. s+STAGES-1 are in flight while s is converted; cp.async
//     rather than TMA because a stage is a gather of BN column pieces of a
//     few dozen bytes each (plus BM rows of x), which cp.async issues from
//     any thread, and the 4-byte copies place bf16 scales at odd offsets;
//   - warp specialization: PW producer warps stage the ring and convert a
//     landed stage once per CTA into one of two buffers (x widened to f32,
//     the group sums of x, the weights dequantized from shared memory: a
//     byte permute and an add make each code an f32 exactly); the consumer
//     threads only run their chains on the other buffer; named barriers
//     (full / empty per buffer) hand the buffers over, one handshake a stage;
//   - the register tile: a consumer owns TM x TN outputs; the tall tiles read
//     a k-major stage (an outer product per k: TM/4 + TN/4 float4 reads for
//     TM*TN FMAs, a warp 4 x 8 consumers so its reads of a k are 384
//     distinct bytes, not the 576 of 2 x 16); the 8- and 16-row tiles read [row][k] float4s along
//     k (their weights are used by few rows, so a column's four k in one
//     read beat a k's columns);
//   - the tile plan (ops/quant_matmul.py tile_plan): the tile shape per
//     (M, N, products), so that the grid fills the 132 SMs at every row
//     count the system sends (a wave of CTAs wherever the output allows
//     one) with the tile that leaves the busiest SM the fewest outputs,
//     weighted by each tile's measured rate; no tile is taller than the
//     rows need (8 or 16 rows at 2..16). The shape moves no bit;
//   - one row (the one-row shapes, RowTile0 / RowTile1, picked by
//     ops/quant_matmul.py row_plan per (K, N, loader)): one consumer warp of
//     32 chains a CTA, so a warp's instruction stream is only its chains'
//     FMAs and shared-memory reads (2 float4 reads per 4 FMAs; the x read a
//     broadcast; a group's loop unrolled twice), while producer warps on
//     the other schedulers stage, widen and dequantize (a thread's items
//     unrolled); 32-column CTAs, the most the columns allow (128 at wq/wo
//     and down, 32 at wk/wv), three 8-group stages in flight where the
//     CTAs are few. The consumer still waits ~2x its chain a stage (PERF.md
//     §7). A thread per
//     column that also dequantized its own weights (a warp's ring each, no
//     producers) measured 3.7-9x the chain floor at wq/wo, wk/wv and down
//     on an H100: one warp a scheduler, issuing in order, cannot fill the
//     FMA latency with its own dequant.
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
//   J (w4a8_bank_launch): kernel A's body with a matrix per selected expert
//     (tiles of every selected expert in one grid), so J(x, bank, eids)[j]
//     equals A(x, bank[eids[j]]) bit for bit; M <= 16.
//   K (q4k_bank_mm_launch): kernel B's loader with the min term inside (the
//     33rd step of each group, as H), under the same tiles and one-row
//     kernel, so a row's bits do not depend on the row count; f32 scales
//     (exact engine) or bf16 (W4A8 engine above 16 rows); the plan counts
//     the selected experts' CTAs together.
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
//   M (w4a8_matmul_launch with nb > 1) replaces
//     blama_tpu/ops/pallas/quant_matmul.py:_a8s_parts_kernel:
//     kernel A's body with a matrix per K-block, x quantized per block.
// (_a8s_pinned_kernel is kernel A itself: A sums each column alone with the
// min term inside.) Every K offset of a block (the tiles' K steps, the
// one-row shapes' stages, A's staging chunks and a lane's groups) is
// relative to the block's start, so block i equals the kernel on the
// K-slice alone bit for bit: what a tp device holding that slice computes.
// The caller combines the partials by a fixed halving tree. Bound: bytes at
// the decode rows, f32 (L) operations at the prompt chunks, as for B and A.
//
// The tools' slab GEMVs are in slab_gemv.cu: kernel A's group terms in the
// reference's slab grouping on A's layout (kernel Q), ubench_q4k's two
// layouts (kernel V) and kernel I's on the native superblocks (kernel T,
// tools/ab_a8k4.py's X2); ubench's f32 two-dot (kernel U) is in twodot.cu.
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

__device__ __forceinline__ float quiet_nan() { return __int_as_float(0x7fc00000); }

// ---------------------------------------------------------------------------
// Q4_K superblocks: the 6-bit scales and f16 d / dmin
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


// ---------------------------------------------------------------------------
// cp.async helpers (the exact tiles' ring)
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// kernels A, I, J, M: the W4A8 GEMV, one launch per call
// ---------------------------------------------------------------------------
//
// One CTA of GV_THREADS threads owns tiles of BN = 64 / RW output columns of
// one matrix (kernel A: the weight; M: a K-block of it; J: a selected
// expert) and walks them in turn (tile blockIdx.x, + gridDim.x, ...). Warp w
// owns 8 columns (cw = w % CW) and the residues rw = w / CW (mod RW) of the
// sum order below; it streams its columns' weights in stages of GV_SG groups
// (1024 K elements: a 32-group round of A, four superblocks of I), the next
// stage in its registers while the current one, in its own shared memory,
// is computed. x is quantized in the kernel, GV_XK elements at a time, into
// shared memory as the mma's A fragments, and kept while the next tile
// needs the same rows and K range.
//
// The group dot runs on mma.m16n8k32 s8: A = 16 rows of activation codes
// (rows past M zero), B = 8 weight columns of one group. The split layout is
// B's fragment as it lies: lane (g, t) takes word t of column g's 16 bytes,
// whose low nibbles are the elements 4t..4t+3 (b0) and high nibbles
// 16+4t..16+4t+3 (b1); one ldmatrix.x4 gives a lane its word of four
// groups. I's chunk of 32 bytes holds group 2c in its low and 2c+1 in its
// high nibbles: ldmatrix.x2 of the chunk's two halves gives b0 / b1 of both.
// The accumulator starts at GV_MAGIC, so D read as a float is 1.5 * 2^23 +
// dot, exact (|dot| <= 32 * 127 * 15), and one subtraction gives (float)dot.
//
// The sum order is the one-warp-per-column kernel's that A had before: an
// output's terms dot*ws*xs - sxm*wm go to residue partial l in ascending
// group order (A: l = g mod 32; I: l = (g mod 64) / 2, group 2l before
// 2l+1; g relative to the K-block's start), and the 32 partials are added
// as the xor butterfly 16, 8, 4, 2, 1 adds them (partial l + partial l + o).
// A lane holds residues rw + RW*j of its outputs (rows g, g+8; columns 2t,
// 2t+1): the butterfly's levels over j in registers, the last log2(RW)
// across the warps through shared memory. Every output's bits are those of
// the old kernel, at every M, RW, tile and grid.

constexpr int GV_THREADS = 256;
constexpr int GV_WARPS = GV_THREADS / 32;
constexpr int GV_SG = 32;          // groups a stage carries
constexpr int GV_XK = 4096;        // K elements of quantized x held at once
constexpr int GV_XG = GV_XK / GROUP;
constexpr int GV_SMEM_MAX = 232448;
constexpr uint32_t GV_MAGIC = 0x4B400000u;
constexpr uint32_t NIB = 0x0F0F0F0Fu;
constexpr int GV_KIND_A = 0, GV_KIND_I = 1;

// bytes a column of kernel I's stage takes in a warp's shared memory: four
// superblocks of 144 bytes and 16 bytes of pad (so the 8 rows an ldmatrix
// reads fall in 8 bank quads)
constexpr int GV_I_COL = 4 * Q4K_BLOCK + 16;

struct GvArgs {
  const void* x;          // [rows, K] bf16 (x_bf16) or f32
  const uint8_t* codes;   // A: [rows, K/2] split codes; I: [rows, K/256*144] superblocks
  const __nv_bfloat16* scales;  // A: [rows, K/32]
  const __nv_bfloat16* mins;
  const int* eids;        // J: the selected experts (weight rows e*N ..), else null
  float* out;             // [n_mat, M, N]
  int8_t* xq;             // optional [x rows, K] codes, [x rows, K/32] scales and
  float* xs;              // scale*sum: written by the tiles of column block 0
  float* sxm;
  int x_bf16, M, K, N;
  int n_mat;              // matrices: K-blocks (A: 1; M: nb) or selected experts (J)
  int klen;               // K elements a matrix sums over: K / nb, or K
  int n_expert, x_per_mat;  // J: the bank's experts; x rows j*M .. for matrix j
  int tiles_per_mat, n_tiles;
};

template <int R>
__device__ __forceinline__ float gv_term(float acc, float dot, float ws, float wm, float xs,
                                         float sxm) {
  // acc += dot*ws*xs - sxm*wm, with the roundings the old kernel's compiled
  // expression took: one product dot*ws, an fma with the min product
  return __fadd_rn(acc, __fmaf_rn(__fmul_rn(dot, ws), xs, -__fmul_rn(sxm, wm)));
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// d = A B + GV_MAGIC in every element (one register as the whole C operand)
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%10,%10,%10,%10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "r"(GV_MAGIC));
}

__host__ __device__ constexpr int ilog2(int v) { return v > 1 ? 1 + ilog2(v / 2) : 0; }

// f(Idx<i>{}) for i = 0 .. N-1, expanded at compile time: every index into
// the partials is a constant, so they stay in registers (a loop the
// compiler does not unroll early enough leaves an array in local memory,
// which misses to L2 when shared memory takes the L1)
template <int V>
struct Idx {
  static constexpr int value = V;
  __host__ __device__ constexpr operator int() const { return V; }
};
template <int I, int N>
struct StaticFor {
  template <class F>
  __device__ __forceinline__ static void run(F& f) {
    f(Idx<I>{});
    StaticFor<I + 1, N>::run(f);
  }
};
template <int N>
struct StaticFor<N, N> {
  template <class F>
  __device__ __forceinline__ static void run(F&) {}
};
template <int N, class F>
__device__ __forceinline__ void static_for(F&& f) {
  StaticFor<0, N>::run(f);
}

__device__ __forceinline__ float gv_dot(int d) { return __int_as_float(d) - 12582912.0f; }

// where tile t's matrix lies: weight rows from wrow, x rows from xrow, its
// K-range from kbeg; ok is false for an expert id outside the bank
struct GvTile {
  int mat, col0, wrow, xrow, kbeg;
  bool ok;
};

template <int BN>
__device__ __forceinline__ GvTile gv_tile(const GvArgs& a, int t) {
  GvTile r;
  r.mat = t / a.tiles_per_mat;
  r.col0 = (t % a.tiles_per_mat) * BN;
  if (a.eids) {
    const int e = a.eids[r.mat];
    r.ok = e >= 0 && e < a.n_expert;
    r.wrow = r.ok ? e * a.N : 0;
    r.xrow = a.x_per_mat ? r.mat * a.M : 0;
    r.kbeg = 0;
  } else {
    r.ok = true;
    r.wrow = 0;
    r.xrow = 0;
    r.kbeg = r.mat * a.klen;
  }
  return r;
}

// quantize x rows xrow .. xrow+M-1, elements ka .. ka+len-1, into the A
// fragments xa ([group][lane][2R words]) and (scale, scale*sum) xsm
// ([group][8R rows]) with quant_acts_kernel's arithmetic (the amax and the
// int sum are exact in any order): 4 threads a (row, group), 8 elements
// each, GV_QROWS rows' loads in flight together; the codes also to a.xq /
// a.xs / a.sxm when asked
constexpr int GV_QROWS = 4;

template <int R>
__device__ void gv_quantize(const GvArgs& a, int xrow, int ka, int len, uint32_t* xa,
                            float2* xsm, bool to_global) {
  const int F = len / 8;  // (group, quarter) items a row; a multiple of 32
  const int KG = a.K / GROUP;
  for (int f0 = 0; f0 < F; f0 += GV_THREADS) {  // whole warps in every pass
    const int f = f0 + threadIdx.x;
    const bool ok = f < F;
    const int gl = f >> 2, h = f & 3;
    for (int r0 = 0; r0 < a.M; r0 += GV_QROWS) {
      float v[GV_QROWS][8];
      static_for<GV_QROWS>([&](auto rc) {
        const int r = r0 + rc;
        const size_t e = (size_t)(xrow + r) * a.K + ka + gl * GROUP + 8 * h;
#pragma unroll
        for (int i = 0; i < 8; ++i) v[rc][i] = 0.0f;
        if (ok && r < a.M) {
          if (a.x_bf16) {
            const uint4 u = __ldg(reinterpret_cast<const uint4*>(
                static_cast<const __nv_bfloat16*>(a.x) + e));
            const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              v[rc][2 * i] = __uint_as_float(w[i] << 16);
              v[rc][2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
            }
          } else {
            const float4* src = reinterpret_cast<const float4*>(static_cast<const float*>(a.x) + e);
            const float4 f0v = __ldg(src), f1v = __ldg(src + 1);
            v[rc][0] = f0v.x; v[rc][1] = f0v.y; v[rc][2] = f0v.z; v[rc][3] = f0v.w;
            v[rc][4] = f1v.x; v[rc][5] = f1v.y; v[rc][6] = f1v.z; v[rc][7] = f1v.w;
          }
        }
      });
      static_for<GV_QROWS>([&](auto rc) {
        const int r = r0 + rc;
        if (r < a.M) {  // uniform
          float am = 0.0f;
#pragma unroll
          for (int i = 0; i < 8; ++i) am = fmaxf(am, fabsf(v[rc][i]));
          am = fmaxf(am, __shfl_xor_sync(0xffffffffu, am, 2));
          am = fmaxf(am, __shfl_xor_sync(0xffffffffu, am, 1));
          const float scale = am / 127.0f;
          const float inv = scale > 0.0f ? 1.0f / scale : 0.0f;
          uint32_t word[2] = {0u, 0u};
          int sum = 0;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int q = __float2int_rn(v[rc][i] * inv);
            sum += q;
            word[i >> 2] |= (uint32_t)(q & 255) << (8 * (i & 3));
          }
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          if (ok) {
            const float sm = scale * (float)sum;
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              // word wd (elements 4wd..4wd+3) of row r: lane (r % 8, wd % 4) of
              // the fragment, low (wd < 4) or high half, row half r / 8
              const int wd = 2 * h + k;
              const int lane = (r & 7) * 4 + (wd & 3);
              const int reg = R == 2 ? (r >> 3) + 2 * (wd >> 2) : (wd >> 2);
              xa[(gl * 32 + lane) * 2 * R + reg] = word[k];
            }
            if (h == 0) xsm[gl * 8 * R + r] = make_float2(scale, sm);
            if (to_global) {
              const size_t e = (size_t)(xrow + r) * a.K + ka + gl * GROUP + 8 * h;
              *reinterpret_cast<uint2*>(a.xq + e) = make_uint2(word[0], word[1]);
              if (h == 0) {
                a.xs[(size_t)(xrow + r) * KG + ka / GROUP + gl] = scale;
                a.sxm[(size_t)(xrow + r) * KG + ka / GROUP + gl] = sm;
              }
            }
          }
        }
      });
    }
  }
}

// the mma and the terms of one group: stage group gi, x phase group pg,
// B fragment b0 / b1, into partials p (2R outputs)
template <int R>
__device__ __forceinline__ void gv_group(float* p, const uint32_t* xa, const float2* xsm,
                                         const float2* wsm, int pg, int gi, uint32_t b0,
                                         uint32_t b1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t a0, a1 = 0, a2, a3 = 0;
  if (R == 2) {
    const uint4 u = reinterpret_cast<const uint4*>(xa)[pg * 32 + lane];
    a0 = u.x; a1 = u.y; a2 = u.z; a3 = u.w;
  } else {
    const uint2 u = reinterpret_cast<const uint2*>(xa)[pg * 32 + lane];
    a0 = u.x; a2 = u.y;
  }
  int d[4];
  mma_s8(d, a0, a1, a2, a3, b0, b1);
  const float4 sc = reinterpret_cast<const float4*>(wsm + gi * 8)[t];
  const float2 x0 = xsm[pg * 8 * R + g];
  p[0] = gv_term<R>(p[0], gv_dot(d[0]), sc.x, sc.y, x0.x, x0.y);
  p[1] = gv_term<R>(p[1], gv_dot(d[1]), sc.z, sc.w, x0.x, x0.y);
  if (R == 2) {
    const float2 x1 = xsm[pg * 8 * R + g + 8];
    p[2] = gv_term<R>(p[2], gv_dot(d[2]), sc.x, sc.y, x1.x, x1.y);
    p[3] = gv_term<R>(p[3], gv_dot(d[3]), sc.z, sc.w, x1.x, x1.y);
  }
}

// one stage of kernel A for warp (cw, rw): groups rw + RW*j (j < 32/RW) of
// the round, each into partial j
template <int R, int RW, bool FULL>
__device__ __forceinline__ void gv_stage_a_body(float* p, const uint8_t* st, const uint32_t* xa,
                                                const float2* xsm, const float2* wsm, int rw,
                                                int pg0, int ng) {
  constexpr int NJ = 32 / RW;
  const int lane = threadIdx.x & 31;
  // lane L addresses row L % 8 (the warp's column L % 8) of matrix L / 8
  // (the warp's group j + L/8)
  const unsigned base = smem_addr(st + (lane & 7) * (NJ + 1) * 16);
  static_for<NJ / 4>([&](auto jc) {
    constexpr int j = 4 * decltype(jc)::value;
    if (FULL || rw + RW * j < ng) {
      uint32_t r[4];
      ldsm_x4(base + (j + (lane >> 3)) * 16, r[0], r[1], r[2], r[3]);
      static_for<4>([&](auto qc) {
        constexpr int q = decltype(qc)::value;
        const int gi = rw + RW * (j + q);
        if (FULL || gi < ng)
          gv_group<R>(p + (j + q) * 2 * R, xa, xsm, wsm, pg0 + gi, gi, r[q] & NIB,
                      (r[q] >> 4) & NIB);
      });
    }
  });
}

// one row (M = 1): x's row goes into all 8 A rows, so lane (g, t) holds the
// row's dots of columns 2t, 2t+1 for every group of a block of 4, and takes
// the one term of column 2t + (g & 1), group g >> 1 of the block: a term a
// lane per 4 groups instead of 8 (only one row's of them real), its
// residues rw + RW*(4j' + (g >> 1)) in partial j'
template <int RW, bool FULL>
__device__ __forceinline__ void gv_stage_a1_body(float* p, const uint8_t* st, const uint32_t* xa,
                                                 const float2* xsm, const float2* wsm, int rw,
                                                 int pg0, int ng) {
  constexpr int NJ = 32 / RW;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int c = 2 * t + (g & 1), q = g >> 1;
  const unsigned base = smem_addr(st + (lane & 7) * (NJ + 1) * 16);
  static_for<NJ / 4>([&](auto jc) {
    constexpr int j = 4 * decltype(jc)::value;
    if (FULL || rw + RW * j < ng) {
      uint32_t r[4];
      ldsm_x4(base + (j + (lane >> 3)) * 16, r[0], r[1], r[2], r[3]);
      int dot = 0;
      static_for<4>([&](auto qc) {
        constexpr int qq = decltype(qc)::value;
        const uint2 u = reinterpret_cast<const uint2*>(xa)[(pg0 + rw + RW * (j + qq)) * 32 + t];
        int d[4];
        mma_s8(d, u.x, 0u, u.y, 0u, r[qq] & NIB, (r[qq] >> 4) & NIB);
        if (qq == q) dot = (g & 1) ? d[1] : d[0];
      });
      const int gi = rw + RW * (j + q);
      if (FULL || gi < ng) {
        const float2 sc = wsm[gi * 8 + c];
        const float2 x0 = xsm[(pg0 + gi) * 8];
        p[j / 4] = gv_term<1>(p[j / 4], gv_dot(dot), sc.x, sc.y, x0.x, x0.y);
      }
    }
  });
}

// a full stage (the common case) takes no guard, so its groups' loads, mmas
// and terms interleave in one basic block
template <int R, int RW>
__device__ __forceinline__ void gv_stage_a(float* p, const uint8_t* st, const uint32_t* xa,
                                           const float2* xsm, const float2* wsm, int rw,
                                           int pg0, int ng) {
  if constexpr (R == 0) {
    if (ng == GV_SG)
      gv_stage_a1_body<RW, true>(p, st, xa, xsm, wsm, rw, pg0, ng);
    else
      gv_stage_a1_body<RW, false>(p, st, xa, xsm, wsm, rw, pg0, ng);
  } else {
    if (ng == GV_SG)
      gv_stage_a_body<R, RW, true>(p, st, xa, xsm, wsm, rw, pg0, ng);
    else
      gv_stage_a_body<R, RW, false>(p, st, xa, xsm, wsm, rw, pg0, ng);
  }
}

// one stage of kernel I (four superblocks: residues 16h .. 16h+15 of the
// 64-group round) for warp (cw, rw): chunk pairs u = rw + RW*i (superblock
// u / 4, chunk u % 4), groups 2u then 2u+1 into partial 16h/RW + i
template <int R, int RW, int H, bool FULL>
__device__ __forceinline__ void gv_stage_i_body(float* p, const uint8_t* st, const uint32_t* xa,
                                                const float2* xsm, const float2* wsm, int rw,
                                                int pg0, int ng) {
  constexpr int NU = 16 / RW, CB = GV_I_COL;
  const int lane = threadIdx.x & 31;
  const unsigned base = smem_addr(st + (lane & 7) * CB + 16);
  static_for<NU / 2>([&](auto ic) {
    constexpr int i = 2 * decltype(ic)::value;
    if (FULL || 2 * (rw + RW * i) < ng) {
      // matrices: chunk pair i (bytes 0-15, 16-31), chunk pair i + 1 (the same)
      const int u = rw + RW * (i + (lane >> 4));
      uint32_t r[4];
      ldsm_x4(base + (u >> 2) * Q4K_BLOCK + (u & 3) * 32 + ((lane >> 3) & 1) * 16, r[0], r[1],
              r[2], r[3]);
      static_for<2>([&](auto hc) {
        constexpr int h = decltype(hc)::value;
        const int uu = rw + RW * (i + h);
        if (FULL || 2 * uu < ng) {
          float* pp = p + (H * NU + i + h) * 2 * R;
          gv_group<R>(pp, xa, xsm, wsm, pg0 + 2 * uu, 2 * uu, r[2 * h] & NIB,
                      r[2 * h + 1] & NIB);
          gv_group<R>(pp, xa, xsm, wsm, pg0 + 2 * uu + 1, 2 * uu + 1, (r[2 * h] >> 4) & NIB,
                      (r[2 * h + 1] >> 4) & NIB);
        }
      });
    }
  });
}

template <int R, int RW, int H>
__device__ __forceinline__ void gv_stage_i(float* p, const uint8_t* st, const uint32_t* xa,
                                           const float2* xsm, const float2* wsm, int rw,
                                           int pg0, int ng) {
  if (ng == GV_SG)
    gv_stage_i_body<R, RW, H, true>(p, st, xa, xsm, wsm, rw, pg0, ng);
  else
    gv_stage_i_body<R, RW, H, false>(p, st, xa, xsm, wsm, rw, pg0, ng);
}

// bytes of a warp's shared memory: its codes (A: 8 columns of NJ 16-byte
// groups and a pad unit, so the 8 rows an ldmatrix reads fall in 8 bank
// quads; I: 8 columns of four 144-byte superblocks and 16 bytes of pad) and
// its f32 scale / min pairs [32 groups][8 columns]
template <int KIND, int RW>
__host__ __device__ constexpr int gv_warp_bytes() {
  return (KIND == GV_KIND_A ? 8 * (32 / RW + 1) * 16 : 8 * GV_I_COL) +
         GV_SG * 8 * 8;
}

// one stage of a warp's weights in flight in its registers: A's codes of its
// groups (NJ / 4 pieces of 16 bytes a lane) and a 16-byte run of scales and
// of mins; I's four superblocks of its 8 columns (9 pieces a lane)
struct GvRegs {
  uint4 w[10];
};

__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// load stage ks of tile tl for warp (cw, rw) into registers: plain 16-byte
// loads, each warp's own, none waited for until gv_store
template <int KIND, int RW>
__device__ __forceinline__ void gv_load(GvRegs& r, const GvArgs& a, const GvTile& tl, int ks,
                                        int cw, int rw) {
  constexpr int NJ = 32 / RW;
  const int lane = threadIdx.x & 31;
  const int k0 = tl.kbeg + ks * GV_SG * GROUP;
  const int ng = min(GV_SG, (a.klen - ks * GV_SG * GROUP) / GROUP);
  const int c0 = tl.col0 + cw * 8;  // the warp's first column
  if (KIND == GV_KIND_A) {
    // codes: lane (g, t) takes column g's groups rw + RW*(4k + t); scales /
    // mins: lane L the 8 groups 8(L&3) .. of column L >> 2
    const int g = lane >> 2, t = lane & 3;
    const bool col_ok = tl.ok && c0 + g < a.N;
    const size_t row = (size_t)tl.wrow + c0 + g;
    const uint8_t* cb = a.codes + row * (a.K / 2) + k0 / 2;
#pragma unroll
    for (int k = 0; k < NJ / 4; ++k) {
      const int gi = rw + RW * (4 * k + t);
      r.w[k] = col_ok && gi < ng ? ldg16(cb + gi * 16) : make_uint4(0, 0, 0, 0);
    }
    const size_t so = row * (a.K / GROUP) + k0 / GROUP + 8 * t;
    const bool s_ok = col_ok && 8 * t < ng;
    r.w[8] = s_ok ? ldg16(a.scales + so) : make_uint4(0, 0, 0, 0);
    r.w[9] = s_ok ? ldg16(a.mins + so) : make_uint4(0, 0, 0, 0);
  } else {
    // the 8 columns' 576-byte runs (four superblocks) as 288 pieces, lane
    // L piece L + 32k
    const int nsb = ng / 8;
    const size_t rb = (size_t)(a.K / QK_K) * Q4K_BLOCK;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const int u = lane + 32 * k, c = u / 36, off = u % 36;
      const bool ok = tl.ok && c0 + c < a.N && off < 9 * nsb;
      r.w[k] = ok ? ldg16(a.codes + ((size_t)tl.wrow + c0 + c) * rb +
                          (size_t)(k0 / QK_K) * Q4K_BLOCK + off * 16)
                  : make_uint4(0, 0, 0, 0);
    }
  }
}

// the registers of a stage into the warp's shared memory: codes (A: [8
// columns][NJ groups + a pad unit]; I: [8 columns][592 bytes]) and the f32
// scale / min pairs [32 groups][8 columns]
template <int KIND, int RW>
__device__ __forceinline__ void gv_store(const GvRegs& r, uint8_t* sw, float2* wsm, int ng) {
  constexpr int NJ = 32 / RW;
  const int lane = threadIdx.x & 31;
  if (KIND == GV_KIND_A) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int k = 0; k < NJ / 4; ++k)
      *reinterpret_cast<uint4*>(sw + (g * (NJ + 1) + 4 * k + t) * 16) = r.w[k];
    const uint32_t s4[4] = {r.w[8].x, r.w[8].y, r.w[8].z, r.w[8].w};
    const uint32_t m4[4] = {r.w[9].x, r.w[9].y, r.w[9].z, r.w[9].w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      wsm[(8 * t + 2 * i) * 8 + g] =
          make_float2(__uint_as_float(s4[i] << 16), __uint_as_float(m4[i] << 16));
      wsm[(8 * t + 2 * i + 1) * 8 + g] = make_float2(__uint_as_float(s4[i] & 0xFFFF0000u),
                                                     __uint_as_float(m4[i] & 0xFFFF0000u));
    }
  } else {
    constexpr int CB = GV_I_COL;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const int u = lane + 32 * k;
      *reinterpret_cast<uint4*>(sw + (u / 36) * CB + (u % 36) * 16) = r.w[k];
    }
    __syncwarp();
    // the headers: lane (superblock lane / 8, column lane % 8)
    const int c = lane & 7, sb = lane >> 3;
    if (sb * 8 < ng) {
      const uint4 hdr = *reinterpret_cast<const uint4*>(sw + c * CB + sb * Q4K_BLOCK);
      const float d = half_bits_to_f32(hdr.x), dmin = half_bits_to_f32(hdr.x >> 16);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        int sc, mn;
        scale_min_k4(jj, hdr.y, hdr.z, hdr.w, sc, mn);
        wsm[(sb * 8 + jj) * 8 + c] = make_float2(d * (float)sc, dmin * (float)mn);
      }
    }
  }
}

template <int KIND, int R0, int RW>
__global__ void __launch_bounds__(GV_THREADS, 1) w4a8_gemv_kernel(const GvArgs a) {
  // R0 = 0: kernel A at one row (gv_stage_a1_body), in R = 1's layouts
  constexpr int R = R0 ? R0 : 1;
  constexpr int BN = 64 / RW, CW = GV_WARPS / RW, NJ = 32 / RW;
  constexpr int NP = R0 ? NJ * 2 * R : NJ / 4;  // partials a lane
  constexpr int WB = gv_warp_bytes<KIND, RW>();
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cw = warp % CW, rw = warp / CW;
  const int g = lane >> 2, t = lane & 3;
  uint8_t* sw = smem + warp * WB;                                        // the warp's codes
  float2* wsm = reinterpret_cast<float2*>(sw + WB - GV_SG * 8 * 8);      // [32][8]
  uint32_t* xa = reinterpret_cast<uint32_t*>(smem + GV_WARPS * WB);      // [GV_XG][32][2R]
  float2* xsm = reinterpret_cast<float2*>(xa + GV_XG * 32 * 2 * R);      // [GV_XG][8R]
  float* red = reinterpret_cast<float*>(xsm + GV_XG * 8 * R);            // [RW][8R][BN]

  // rows past M hold zero codes and zero scales for good
  for (int i = threadIdx.x; i < GV_XG * 32 * 2 * R; i += GV_THREADS) xa[i] = 0u;
  for (int i = threadIdx.x; i < GV_XG * 8 * R; i += GV_THREADS) xsm[i] = make_float2(0.f, 0.f);

  const int spt = (a.klen + GV_SG * GROUP - 1) / (GV_SG * GROUP);  // stages a tile
  const int my_tiles = (a.n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int total = my_tiles * spt;
  // every warp walks the same stages: tile blockIdx.x + i*gridDim.x, stage ks
  // of it, the next stage in flight in its registers (two in flight measured
  // slower at one row: gate/up 0.030 ms against 0.026)
  GvTile tl = gv_tile<BN>(a, blockIdx.x);
  GvTile nx = tl;  // the tile of the stage in flight
  int ks = 0, nks = 0, nti = 0;
  GvRegs regs;
  gv_load<KIND, RW>(regs, a, nx, 0, cw, rw);
  int cur_xrow = -1, cur_ka = -1;
  float p[NP];  // partial j of output k at p[j * 2R + k] (one row: partial j)
  for (int s = 0; s < total; ++s) {
    if (ks == 0) {
      tl = nx;
      static_for<NP>([&](auto i) { p[i] = 0.0f; });
    }
    const int k0 = ks * GV_SG * GROUP;  // relative to the matrix's K-range
    const int ng = min(GV_SG, (a.klen - k0) / GROUP);
    // a new x phase (uniform) is quantized while this stage's loads are
    // still in flight (3-5% off a one-row call against after them)
    const int kp = k0 / GV_XK * GV_XK;
    if (tl.xrow != cur_xrow || tl.kbeg + kp != cur_ka) {
      cur_xrow = tl.xrow;
      cur_ka = tl.kbeg + kp;
      const bool to_global =
          a.xq != nullptr && tl.col0 == 0 && (a.eids == nullptr || a.x_per_mat || tl.mat == 0);
      __syncthreads();  // every warp is done with the previous phase's codes
      gv_quantize<R>(a, tl.xrow, cur_ka, min(GV_XK, a.klen - kp), xa, xsm, to_global);
      __syncthreads();
    }
    __syncwarp();  // the warp is done with the previous stage's shared memory
    gv_store<KIND, RW>(regs, sw, wsm, ng);
    // the next stage's loads go out before this one is computed
    if (++nks == spt) {
      nks = 0;
      ++nti;
      if (s + 1 < total) nx = gv_tile<BN>(a, blockIdx.x + nti * gridDim.x);
    }
    if (s + 1 < total) gv_load<KIND, RW>(regs, a, nx, nks, cw, rw);
    __syncwarp();
    if (tl.ok) {
      const int pg0 = (k0 % GV_XK) / GROUP;
      if (KIND == GV_KIND_A) {
        gv_stage_a<R0, RW>(p, sw, xa, xsm, wsm, rw, pg0, ng);
      } else if (ks & 1) {
        gv_stage_i<R, RW, 1>(p, sw, xa, xsm, wsm, rw, pg0, ng);
      } else {
        gv_stage_i<R, RW, 0>(p, sw, xa, xsm, wsm, rw, pg0, ng);
      }
    }
    if (++ks != spt) continue;
    ks = 0;
    // the tile's last stage: the butterfly's levels over j, (one row: over
    // the lanes' block groups, xor 16 and 8), then over warps
    float* out = a.out + (size_t)tl.mat * a.M * a.N;
    if constexpr (R0 == 0) {
      static_for<ilog2(NJ / 4)>([&](auto lc) {
        constexpr int o = (NJ / 4) >> (decltype(lc)::value + 1);
        static_for<o>([&](auto i) { p[i] = p[i] + p[i + o]; });
      });
      float v = p[0];
      v = v + __shfl_xor_sync(0xffffffffu, v, 16);
      v = v + __shfl_xor_sync(0xffffffffu, v, 8);
      const int n = tl.col0 + cw * 8 + 2 * t + (g & 1);
      if (lane < 8) {
        if (RW > 1) red[rw * 8 * R * BN + cw * 8 + 2 * t + g] = v;
        else if (tl.ok && n < a.N) out[n] = v;
      }
    } else {
      static_for<ilog2(NJ)>([&](auto lc) {
        constexpr int o = NJ >> (decltype(lc)::value + 1);
        static_for<o * 2 * R>([&](auto i) { p[i] = p[i] + p[i + o * 2 * R]; });
      });
    }
    if (R0 == 0) {
    } else if (RW == 1) {
      if (tl.ok) {
#pragma unroll
        for (int k = 0; k < 2 * R; ++k) {
          const int row = g + 8 * (k >> 1), n = tl.col0 + cw * 8 + 2 * t + (k & 1);
          if (row < a.M && n < a.N) out[(size_t)row * a.N + n] = p[k];
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < 2 * R; ++k)
        red[(rw * 8 * R + g + 8 * (k >> 1)) * BN + cw * 8 + 2 * t + (k & 1)] = p[k];
    }
    if (RW > 1 || !tl.ok) {
      __syncthreads();
      for (int it = threadIdx.x; it < a.M * BN; it += GV_THREADS) {
        const int row = it / BN, c = it % BN, n = tl.col0 + c;
        if (n >= a.N) continue;
        float v[RW];
        v[0] = quiet_nan();  // an expert id outside the bank: NaN, loudly
        if (RW > 1 && tl.ok) {
          static_for<RW>([&](auto r) { v[r] = red[(r * 8 * R + row) * BN + c]; });
          static_for<ilog2(RW)>([&](auto lc) {
            constexpr int o = RW >> (decltype(lc)::value + 1);
            static_for<o>([&](auto r) { v[r] = v[r] + v[r + o]; });
          });
        }
        out[(size_t)row * a.N + n] = v[0];
      }
      __syncthreads();  // red is free for the next tile
    }
  }
}

template <int KIND, int R0, int RW>
int launch_gv_t(GvArgs a, int grid, cudaStream_t st) {
  constexpr int R = R0 ? R0 : 1;
  constexpr int BN = 64 / RW;
  constexpr int SMEM = GV_WARPS * gv_warp_bytes<KIND, RW>() + GV_XG * 32 * 2 * R * 4 +
                       GV_XG * 8 * R * 8 + (RW > 1 ? RW * 8 * R * BN * 4 : 0);
  static_assert(SMEM <= GV_SMEM_MAX, "the GEMV's shared memory");
  static bool attr = false;
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(w4a8_gemv_kernel<KIND, R0, RW>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  a.tiles_per_mat = (a.N + BN - 1) / BN;
  a.n_tiles = a.tiles_per_mat * a.n_mat;
  w4a8_gemv_kernel<KIND, R0, RW><<<min(grid, a.n_tiles), GV_THREADS, SMEM, st>>>(a);
  return (int)cudaGetLastError();
}

template <int KIND, int R>
int launch_gv_r(const GvArgs& a, int rw, int grid, cudaStream_t st) {
  switch (rw) {
    case 1:
      if constexpr (R != 2) return launch_gv_t<KIND, R, 1>(a, grid, st);
      return (int)cudaErrorInvalidValue;
    case 2: return launch_gv_t<KIND, R, 2>(a, grid, st);
    case 4: return launch_gv_t<KIND, R, 4>(a, grid, st);
    case 8: return launch_gv_t<KIND, R, 8>(a, grid, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the checks every entry point shares; rw and grid from ops/quant_matmul.py
// gemv_plan (rw: residue splits, 64 / rw columns a tile)
template <int KIND>
int launch_gv(GvArgs a, int rw, int grid, void* stream) {
  if (a.M < 1 || a.M > 16 || a.N < 1 || a.K % QK_K || a.klen % QK_K || a.klen < QK_K ||
      grid < 1 || a.n_mat < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 9-16 rows hold twice the partials a lane: at least two residue splits
  // keep them (and the quantizer's loads) in registers; rw moves no bit
  if (KIND == GV_KIND_A && a.M == 1) return launch_gv_r<KIND, 0>(a, rw, grid, st);
  return a.M <= 8 ? launch_gv_r<KIND, 1>(a, rw, grid, st)
                  : launch_gv_r<KIND, 2>(a, rw < 2 ? 2 : rw, grid, st);
}

// ---------------------------------------------------------------------------
// kernels B, G, H, K, L: exact dequant GEMM, pipelined f32 SIMT tiles
// ---------------------------------------------------------------------------

// cp.async of the 4-byte words that hold bytes [p, p + nbytes) of device
// memory (a run of scales or mins, any 2-byte alignment) to dst; byte p
// lands at dst + (p & 3)
__device__ __forceinline__ void stage_words(uint8_t* dst, const void* p, int nbytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uintptr_t w0 = a & ~uintptr_t(3), w1 = (a + nbytes - 1) & ~uintptr_t(3);
  for (uintptr_t w = w0; w <= w1; w += 4)
    cp_async4(dst + (w - w0), reinterpret_cast<const void*>(w));
}

template <typename S>
__device__ __forceinline__ float staged(const uint8_t* words, const S* p, int i) {
  return to_f32(*reinterpret_cast<const S*>(words + (reinterpret_cast<uintptr_t>(p) & 3) +
                                            i * sizeof(S)));
}

// byte i of v as f32, exactly: one byte permute forms the float 2^23 + byte,
// an add takes 2^23 off (where I2F runs at a quarter of the FMA rate)
__device__ __forceinline__ float small_f32_byte(uint32_t v, int i) {
  return __uint_as_float(__byte_perm(v, 0x4Bu, 0x4550u + i)) - 8388608.0f;
}
// the same for byte i of v holding q + 128 (an int8 q with its top bit
// flipped): 2^23 + q + 128 less 2^23 + 128 in one exact add gives q
__device__ __forceinline__ float small_f32_sbyte(uint32_t v, int i) {
  return __uint_as_float(__byte_perm(v, 0x4Bu, 0x4550u + i)) - 8388736.0f;
}

__host__ __device__ constexpr int round16(int b) { return (b + 15) / 16 * 16; }

// A loader stages and dequantizes the weights of one output column for a
// K stage of SG 32-groups (gs .. gs+SG-1; fewer, ng, at a ragged end of K):
//   chunks<SG>(), raw_bytes<SG>()  16-byte code chunks a column stages, and
//                                  the bytes they and the column's scale /
//                                  min words take in the ring (16-multiple);
//   live_chunks<SG>(ng), chunk()   the chunks that exist, and where chunk i
//                                  lies in device memory;
//   stage_small<SG>()              cp.async of the column's scales (mins);
//   dequant<SG>()                  group gl of the stage from the ring to 32
//                                  f32 weights and -min (MIN_ROW): code*scale
//                                  with the code made an f32 by a byte
//                                  permute and an add (exact), one rounding.

// kernel B: split Q4_K codes with scales of type S; no min term
template <typename S>
struct Q4KLoader {
  static constexpr bool MIN_ROW = false;
  const uint8_t* codes;
  const S* scales;
  template <int SG>
  static __host__ __device__ constexpr int words() { return sizeof(S) == 4 ? SG : SG / 2 + 1; }
  template <int SG>
  static __host__ __device__ constexpr int chunks() { return SG; }
  template <int SG>
  static __host__ __device__ constexpr int raw_bytes() { return round16(16 * SG + 4 * words<SG>()); }
  template <int SG>
  __device__ __forceinline__ int live_chunks(int ng) const { return ng; }
  __device__ __forceinline__ const void* chunk(int n, int gs, int i, int K) const {
    return codes + (size_t)n * (K / 2) + (size_t)(gs + i) * 16;
  }
  __device__ __forceinline__ const S* scale_at(int n, int gs, int K) const {
    return scales + (size_t)n * (K / GROUP) + gs;
  }
  template <int SG>
  __device__ __forceinline__ void stage_small(uint8_t* raw, int n, int gs, int ng, int K) const {
    stage_words(raw + 16 * SG, scale_at(n, gs, K), ng * (int)sizeof(S));
  }
  template <int SG>
  __device__ __forceinline__ void dequant(const uint8_t* raw, float (&wv)[GROUP], float& negmin,
                                          int n, int gs, int gl, int K) const {
    const uint4 q = *reinterpret_cast<const uint4*>(raw + 16 * gl);
    const float s = staged(raw + 16 * SG, scale_at(n, gs, K), gl);
    const uint32_t wd[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {  // byte b = 4t+i: element b (low nibble), 16+b (high)
      const uint32_t lo = wd[t] & 0x0F0F0F0Fu, hi = (wd[t] >> 4) & 0x0F0F0F0Fu;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wv[4 * t + i] = small_f32_byte(lo, i) * s;
        wv[16 + 4 * t + i] = small_f32_byte(hi, i) * s;
      }
    }
  }
};

// kernel K: kernel B's loader with the min term inside, as H folds it (a
// 33rd step per group); expert(e) points it at expert e of a stacked bank
template <typename S>
struct Q4KMinLoader : Q4KLoader<S> {
  static constexpr bool MIN_ROW = true;
  const S* mins;
  template <int SG>
  static __host__ __device__ constexpr int raw_bytes() {
    return round16(16 * SG + 8 * Q4KLoader<S>::template words<SG>());
  }
  __device__ __forceinline__ Q4KMinLoader expert(int e, int K, int N) const {
    const size_t w0 = (size_t)e * N;
    return {{this->codes + w0 * (K / 2), this->scales + w0 * (K / GROUP)},
            mins + w0 * (K / GROUP)};
  }
  __device__ __forceinline__ const S* min_at(int n, int gs, int K) const {
    return mins + (size_t)n * (K / GROUP) + gs;
  }
  template <int SG>
  __device__ __forceinline__ void stage_small(uint8_t* raw, int n, int gs, int ng, int K) const {
    Q4KLoader<S>::template stage_small<SG>(raw, n, gs, ng, K);
    stage_words(raw + 16 * SG + 4 * Q4KLoader<S>::template words<SG>(), min_at(n, gs, K),
                ng * (int)sizeof(S));
  }
  template <int SG>
  __device__ __forceinline__ void dequant(const uint8_t* raw, float (&wv)[GROUP], float& negmin,
                                          int n, int gs, int gl, int K) const {
    Q4KLoader<S>::template dequant<SG>(raw, wv, negmin, n, gs, gl, K);
    negmin = -staged(raw + 16 * SG + 4 * Q4KLoader<S>::template words<SG>(),
                     min_at(n, gs, K), gl);
  }
};

// kernel G: int8 codes, one f32 scale per SG (32 or 16) elements (NG: the
// groups of a stage)
template <int SG>
struct Q8Loader {
  static constexpr bool MIN_ROW = false;
  static constexpr int SPG = GROUP / SG;  // scales per 32-group
  const int8_t* codes;
  const float* scales;
  template <int NG>
  static __host__ __device__ constexpr int chunks() { return 2 * NG; }
  template <int NG>
  static __host__ __device__ constexpr int raw_bytes() { return round16(32 * NG + 4 * SPG * NG); }
  template <int NG>
  __device__ __forceinline__ int live_chunks(int ng) const { return 2 * ng; }
  __device__ __forceinline__ const void* chunk(int n, int gs, int i, int K) const {
    return codes + (size_t)n * K + (size_t)gs * GROUP + 16 * i;
  }
  __device__ __forceinline__ const float* scale_at(int n, int gs, int K) const {
    return scales + (size_t)n * (K / SG) + (size_t)gs * SPG;
  }
  template <int NG>
  __device__ __forceinline__ void stage_small(uint8_t* raw, int n, int gs, int ng, int K) const {
    stage_words(raw + 32 * NG, scale_at(n, gs, K), ng * SPG * 4);
  }
  template <int NG>
  __device__ __forceinline__ void dequant(const uint8_t* raw, float (&wv)[GROUP], float& negmin,
                                          int n, int gs, int gl, int K) const {
    const uint4* cp = reinterpret_cast<const uint4*>(raw + 32 * gl);
    const uint4 a = cp[0], b = cp[1];
    const float* sp = reinterpret_cast<const float*>(raw + 32 * NG) + gl * SPG;
    const float s0 = sp[0], s1 = sp[SPG - 1];  // the same scale when SG == 32
    const uint32_t wd[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int t = 0; t < 8; ++t) {  // int8 q: the byte q + 128 as f32, minus 128 (exact)
      const uint32_t u = wd[t] ^ 0x80808080u;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wv[4 * t + i] = small_f32_sbyte(u, i) * (t < 4 ? s0 : s1);
    }
  }
};

// kernel H: native Q4_K superblocks; scale and min decoded here. A stage
// (SG of 1, 2, 4 or 8 groups, starting at a multiple of SG) stages its
// superblock's 16-byte header and the 32-byte chunks that hold its groups
// (chunk c: group 2c in the low nibbles, 2c+1 in the high ones).
struct K4Loader {
  static constexpr bool MIN_ROW = true;
  const uint8_t* blocks;
  template <int SG>
  static __host__ __device__ constexpr int chunks() { return 1 + 2 * ((SG + 1) / 2); }
  template <int SG>
  static __host__ __device__ constexpr int raw_bytes() { return 16 * chunks<SG>(); }
  template <int SG>
  __device__ __forceinline__ int live_chunks(int ng) const { return chunks<SG>(); }
  __device__ __forceinline__ const void* chunk(int n, int gs, int i, int K) const {
    const uint8_t* blk = blocks + ((size_t)n * (K / QK_K) + gs / 8) * Q4K_BLOCK;
    return i == 0 ? blk : blk + 16 + 32 * ((gs % 8) / 2) + 16 * (i - 1);
  }
  template <int SG>
  __device__ __forceinline__ void stage_small(uint8_t*, int, int, int, int) const {}
  template <int SG>
  __device__ __forceinline__ void dequant(const uint8_t* raw, float (&wv)[GROUP], float& negmin,
                                          int n, int gs, int gl, int K) const {
    const int j = gs % 8 + gl;  // group within the superblock
    const uint4 hdr = *reinterpret_cast<const uint4*>(raw);
    const uint4* cp = reinterpret_cast<const uint4*>(raw + 16 + 32 * (j / 2 - (gs % 8) / 2));
    const uint4 a = cp[0], b = cp[1];
    int sc, mn;
    scale_min_k4(j, hdr.y, hdr.z, hdr.w, sc, mn);
    const float s = half_bits_to_f32(hdr.x) * (float)sc;
    negmin = -(half_bits_to_f32(hdr.x >> 16) * (float)mn);
    const uint32_t wd[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int t = 0; t < 8; ++t) {  // element 4t+i: byte i of word t, nibble j & 1
      const uint32_t q = (wd[t] >> (4 * (j & 1))) & 0x0F0F0F0Fu;
#pragma unroll
      for (int i = 0; i < 4; ++i) wv[4 * t + i] = small_f32_byte(q, i) * s;
    }
  }
};

// A tile shape of the plan: BM x BN outputs per CTA, TM x TN per consumer
// thread, SG groups per K stage, STAGES slots in the ring, PW producer warps,
// and the layout of the converted stage the consumers read: k-major ([k][m],
// [k][n]: an outer product per k, for the tall tiles) or row-major ([m][k],
// [n][k]: float4 reads along k, for the 8- and 16-row tiles, whose weights
// are read by few rows). ops/quant_matmul.py TILES lists the same shapes in
// the same order (tile_plan picks one per call); the shape moves no bit.
template <int BM_, int BN_, int TM_, int TN_, int SG_, int STAGES_, int PW_, bool KMAJOR_,
          int MINB_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_, SG = SG_, STAGES = STAGES_;
  static constexpr int PW = PW_, MINB = MINB_;  // MINB: CTAs an SM should hold (registers)
  static constexpr bool KMAJOR = KMAJOR_;
  static constexpr int CONSUMERS = (BM / TM) * (BN / TN);
  static constexpr int THREADS = CONSUMERS + 32 * PW;
  static constexpr int KS = SG * GROUP;  // K elements of a stage
  static constexpr int XS = KS + 4;      // row stride of the row-major buffers
};
using Tile0 = Tile<128, 128, 8, 8, 1, 3, 4, true, 1>;
using Tile1 = Tile<128, 64, 8, 8, 1, 3, 4, true, 2>;
using Tile2 = Tile<64, 112, 4, 8, 1, 3, 4, true, 2>;
using Tile3 = Tile<64, 64, 8, 4, 1, 3, 2, true, 2>;
using Tile4 = Tile<64, 32, 4, 4, 1, 3, 2, true, 2>;
using Tile5 = Tile<32, 32, 4, 2, 1, 3, 2, true, 2>;
using Tile6 = Tile<16, 32, 4, 1, 4, 3, 4, false, 1>;
using Tile7 = Tile<8, 32, 2, 1, 4, 3, 4, false, 1>;
// The one-row shapes (M = 1: every solo decode step of the exact engines):
// one consumer warp runs 32 columns' chains, a thread each, from the
// converted buffers, while PW producer warps stage and dequantize; the ring
// holds three stages in flight. RowTile0 (8-group stages, four producer
// warps) where the CTAs are few and each one's pace is its chain's (wq/wo,
// wk/wv, down: at most two CTAs an SM); RowTile1 (4-group stages, two
// producer warps, half the shared memory, four CTAs an SM) where the
// columns are many (gate/up, the lm head, the banks, L's partials). Swept on
// an H100 against 8-group stages with two or six producer warps, a ring of
// six, and 64- and 128-column CTAs of two and four chains a thread
// (chip_smoke.py row_sweep; PERF.md). ops/quant_matmul.py ROW_TILES lists
// the same shapes in the same order (row_plan picks one).
using RowTile0 = Tile<1, 32, 1, 1, 8, 4, 4, false, 2>;
using RowTile1 = Tile<1, 32, 1, 1, 4, 4, 2, false, 4>;
constexpr int CONVERTED = 2;  // converted stages: one filled while one is multiplied

// dynamic shared memory: the ring (per slot the x rows as in device memory,
// KS elements of xsz bytes and 16 of padding a row and 16 more every four
// rows, so the four-row quads the k-major transpose reads fall in distinct
// banks; then BN columns of raw weights), then CONVERTED buffers of a converted stage: x as f32 and the
// dequantized weights (in the tile's layout), with the min term the group
// sums of x [SG][BM] and the -mins [SG][BN]
template <class Tl, typename Loader>
__host__ __device__ constexpr int tile_slot_bytes(int xsz) {
  return Tl::BM * (Tl::KS * xsz + 16) + Tl::BM / 4 * 16 +
         Tl::BN * Loader::template raw_bytes<Tl::SG>();
}
template <class Tl, typename Loader>
__host__ __device__ constexpr int tile_buf_floats() {
  return (Tl::BM + Tl::BN) * (Tl::KMAJOR ? Tl::KS : Tl::XS) +
         (Loader::MIN_ROW ? (Tl::BM + Tl::BN) * Tl::SG : 0);
}
template <class Tl, typename Loader>
__host__ __device__ constexpr int tile_smem_bytes(int xsz) {
  return Tl::STAGES * tile_slot_bytes<Tl, Loader>(xsz) +
         CONVERTED * 4 * tile_buf_floats<Tl, Loader>();
}

// named barriers of the tiles (0 is __syncthreads'): the producers among
// themselves, and per converted buffer b "full" (producers arrive,
// consumers wait) and "empty" (consumers arrive, producers wait)
constexpr int BAR_PRODUCERS = 1, BAR_FULL = 2, BAR_EMPTY = 2 + CONVERTED;
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// value q (of T) of consumer t (of R along an axis of R*T): in the k-major
// layout blocks of four at t*4 and, for T = 8, the same in the second half
// of the axis (a warp's float4 reads are then contiguous); T <= 2 values
// at t*T; in the row-major layout value q at t + q*R
template <int T, int R, bool KMAJOR>
__device__ __forceinline__ int val_idx(int t, int q) {
  if constexpr (!KMAJOR) return t + q * R;
  return T >= 4 ? (q / 4) * (R * 4) + t * 4 + (q % 4) : t * T + q;
}
template <int T, int R>
__device__ __forceinline__ void load_kmajor(const float* p, int t, float (&v)[T]) {
  if constexpr (T >= 4) {
#pragma unroll
    for (int h = 0; h < T / 4; ++h) {
      const float4 u = *reinterpret_cast<const float4*>(p + h * R * 4 + t * 4);
      v[4 * h] = u.x, v[4 * h + 1] = u.y, v[4 * h + 2] = u.z, v[4 * h + 3] = u.w;
    }
  } else if constexpr (T == 2) {
    const float2 u = *reinterpret_cast<const float2*>(p + t * 2);
    v[0] = u.x, v[1] = u.y;
  } else {
    v[0] = p[t];
  }
}

// K groups g0 .. g1-1 of rows of length K, each output summed from zero in
// the chain of the contract (file note); every K offset is absolute, so a
// K-block's sum equals the same tiles on that K-slice alone.
//
// Warp-specialized: the PW producer warps stage the ring with cp.async
// (stages s+1 .. s+STAGES-1 in flight while s is converted) and convert a
// stage into a free buffer (x to f32, the group sums of x, the weights
// dequantized once per CTA); the consumer threads only multiply, each its
// TM x TN chains, one converted stage while the next is filled. Named
// barriers hand a buffer over: "full" once converted, "empty" once used.
template <class Tl, typename Loader>
__device__ __forceinline__ void dequant_tile_body(const void* __restrict__ x, int xb,
                                                  const Loader& w, float* __restrict__ out,
                                                  int M, int K, int N, int g0, int g1,
                                                  uint8_t* smem) {
  constexpr int BM = Tl::BM, BN = Tl::BN, TM = Tl::TM, TN = Tl::TN, SG = Tl::SG;
  constexpr int ST = Tl::STAGES, NC = Tl::CONSUMERS, NP = 32 * Tl::PW, NT = Tl::THREADS;
  constexpr int XS = Tl::XS, KS = Tl::KS;
  constexpr bool KM = Tl::KMAJOR;
  constexpr int LD = KM ? KS : XS;  // the x buffer holds BM * LD floats, the weights BN * LD
  constexpr int RX = BN / TN, RY = BM / TM;  // consumers along n and along m
  constexpr int RAW = Loader::template raw_bytes<SG>();
  constexpr int CH = Loader::template chunks<SG>();
  constexpr int BUF = tile_buf_floats<Tl, Loader>();
  const int xsz = xb ? 2 : 4;
  const int XR = KS * xsz + 16, XB = BM * XR + BM / 4 * 16;  // a ring row of x, a slot's x
  auto xrow = [&](int r) { return r * XR + (r >> 2) * 16; };  // byte offset of row r
  const int SLOT = tile_slot_bytes<Tl, Loader>(xsz);
  float* bufs = reinterpret_cast<float*>(smem + ST * SLOT);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int mv = min(BM, M - m0), nv = min(BN, N - n0);  // live rows and columns
  const int nst = (g1 - g0 + SG - 1) / SG;

  if (threadIdx.x >= NC) {  // ---------------- producers
    const int tid = threadIdx.x - NC;
    const uint8_t* xg = static_cast<const uint8_t*>(x) + (size_t)m0 * K * xsz;
    // cp.async of stage s into its slot: the live rows' x, the live
    // columns' code chunks, scales and mins
    auto stage = [&](int s) {
      uint8_t* slot = smem + (s % ST) * SLOT;
      const int gs = g0 + s * SG, ng = min(SG, g1 - gs);
      const int xc = ng * GROUP * xsz / 16;  // 16-byte chunks of a row
      for (int i = tid; i < mv * xc; i += NP) {
        const int r = i / xc, c = i - r * xc;
        cp_async16(slot + xrow(r) + c * 16,
                   xg + ((size_t)r * K + (size_t)gs * GROUP) * xsz + c * 16);
      }
      const int lc = w.template live_chunks<SG>(ng);
      for (int i = tid; i < nv * CH; i += NP) {
        const int c = i / CH, q = i - c * CH;
        if (q < lc) cp_async16(slot + XB + c * RAW + q * 16, w.chunk(n0 + c, gs, q, K));
      }
      for (int c = tid; c < nv; c += NP)
        w.template stage_small<SG>(slot + XB + c * RAW, n0 + c, gs, ng, K);
    };
#pragma unroll 1
    for (int s = 0; s < ST - 1; ++s) {
      if (s < nst) stage(s);
      cp_async_commit();
    }
#pragma unroll 1
    for (int s = 0; s < nst; ++s) {
      cp_async_wait<ST - 2>();      // this thread's copies of stage s have landed
      bar_sync(BAR_PRODUCERS, NP);  // everyone's have; stage s-1 is converted
      if (s + ST - 1 < nst) stage(s + ST - 1);  // into the slot stage s-1 held
      cp_async_commit();
      const int b = s % CONVERTED;
      if (s >= CONVERTED) bar_sync(BAR_EMPTY + b, NT);  // stage s-2 multiplied
      const uint8_t* slot = smem + (s % ST) * SLOT;
      float* s_x = bufs + b * BUF;
      float* s_w = s_x + BM * LD;
      float* s_xs = s_w + BN * LD;  // MIN_ROW only
      float* s_nm = s_xs + BM * SG;
      const int gs = g0 + s * SG, ng = min(SG, g1 - gs);
      // x as f32 (a bf16 widens exactly: it is the high half of its f32)
      constexpr int XU = KM ? 4 : 1;  // rows a unit takes: a 4 x 4 transpose (k-major)
      for (int i = tid; i < (BM / XU) * (KS / 4); i += NP) {
        const int rq = KM ? i % (BM / XU) : i / (KS / 4), c = KM ? i / (BM / XU) : i % (KS / 4);
        if (rq * XU >= mv) continue;
        float v[XU][4];
#pragma unroll
        for (int e = 0; e < XU; ++e) {
          const int r = rq * XU + e;
          if (xb) {
            const uint2 u = *reinterpret_cast<const uint2*>(slot + xrow(r) + c * 8);
            v[e][0] = __uint_as_float(u.x << 16), v[e][1] = __uint_as_float(u.x & 0xFFFF0000u);
            v[e][2] = __uint_as_float(u.y << 16), v[e][3] = __uint_as_float(u.y & 0xFFFF0000u);
          } else {
            const float4 u = *reinterpret_cast<const float4*>(slot + xrow(r) + c * 16);
            v[e][0] = u.x, v[e][1] = u.y, v[e][2] = u.z, v[e][3] = u.w;
          }
        }
        if constexpr (KM) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            *reinterpret_cast<float4*>(s_x + (4 * c + q) * BM + 4 * rq) =
                make_float4(v[0][q], v[1][q], v[2][q], v[3][q]);
        } else {
          *reinterpret_cast<float4*>(s_x + rq * XS + 4 * c) =
              make_float4(v[0][0], v[0][1], v[0][2], v[0][3]);
        }
      }
      if constexpr (Loader::MIN_ROW) {
        // the group's sum of x: lane 0's value of the xor butterfly (16, 8,
        // .., 1) over its 32 elements, as an explicit tree (the one-row
        // kernel's), once per (row, group)
        for (int i = tid; i < BM * SG; i += NP) {
          const int r = i % BM, gl = i / BM;
          if (r >= mv || gl >= ng) continue;
          const uint8_t* p = slot + xrow(r) + gl * GROUP * xsz;
          float v[GROUP];
          if (xb) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const uint4 u = reinterpret_cast<const uint4*>(p)[q];
              const uint32_t wd[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
              for (int h = 0; h < 4; ++h) {
                v[8 * q + 2 * h] = __uint_as_float(wd[h] << 16);
                v[8 * q + 2 * h + 1] = __uint_as_float(wd[h] & 0xFFFF0000u);
              }
            }
          } else {
#pragma unroll
            for (int q = 0; q < 8; ++q) {
              const float4 u = reinterpret_cast<const float4*>(p)[q];
              v[4 * q] = u.x, v[4 * q + 1] = u.y, v[4 * q + 2] = u.z, v[4 * q + 3] = u.w;
            }
          }
          float t[16];
#pragma unroll
          for (int h = 0; h < 16; ++h) t[h] = v[h] + v[h + 16];
#pragma unroll
          for (int h = 0; h < 8; ++h) t[h] = t[h] + t[h + 8];
#pragma unroll
          for (int h = 0; h < 4; ++h) t[h] = t[h] + t[h + 4];
          t[0] = t[0] + t[2];
          t[1] = t[1] + t[3];
          s_xs[gl * BM + r] = t[0] + t[1];
        }
      }
      // the weights, dequantized once per CTA from the ring (neighbouring
      // threads take neighbouring columns: their stores fall in distinct
      // banks; a thread's items unrolled, so their dequants overlap)
#pragma unroll
      for (int it = 0; it < (BN * SG + NP - 1) / NP; ++it) {
        const int i = tid + it * NP, c = i % BN, gl = i / BN;
        if (i >= BN * SG || c >= nv || gl >= ng) continue;
        float wv[GROUP];
        float negmin = 0.0f;
        w.template dequant<SG>(slot + XB + c * RAW, wv, negmin, n0 + c, gs, gl, K);
        if constexpr (KM) {
#pragma unroll
          for (int q = 0; q < GROUP; ++q) s_w[(gl * GROUP + q) * BN + c] = wv[q];
        } else {
          float4* d = reinterpret_cast<float4*>(s_w + c * XS + gl * GROUP);
#pragma unroll
          for (int q = 0; q < GROUP / 4; ++q)
            d[q] = make_float4(wv[4 * q], wv[4 * q + 1], wv[4 * q + 2], wv[4 * q + 3]);
        }
        if constexpr (Loader::MIN_ROW) s_nm[gl * BN + c] = negmin;
      }
      bar_arrive(BAR_FULL + b, NT);  // stage s is converted into buffer b
    }
    cp_async_wait<0>();  // no copy outlives the CTA (the tail groups are empty)
    return;
  }

  // ---------------- consumers
  // k-major: a warp takes 4 x 8 consumers (rows x columns) where the tile
  // allows, so each float4 read of a k touches 64 distinct bytes of x or 128
  // of the weights; else consumers in row order
  constexpr bool WARP48 = KM && RY % 4 == 0 && RX % 8 == 0;
  const int lane = threadIdx.x % 32, wid = threadIdx.x / 32;
  const int tx = WARP48 ? (wid % (RX / 8)) * 8 + lane % 8 : threadIdx.x % RX;
  const int ty = WARP48 ? (wid / (RX / 8)) * 4 + lane / 8 : threadIdx.x / RX;
  const bool live = val_idx<TM, RY, KM>(ty, 0) < mv;  // a consumer wholly past M only waits
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
#pragma unroll 1
  for (int s = 0; s < nst; ++s) {
    const int b = s % CONVERTED;
    bar_sync(BAR_FULL + b, NT);
    const float* s_x = bufs + b * BUF;
    const float* s_w = s_x + BM * LD;
    const float* s_xs = s_w + BN * LD;
    const float* s_nm = s_xs + BM * SG;
    const int ng = min(SG, g1 - (g0 + s * SG));
    if (live) {
#pragma unroll(BM == 1 ? 2 : 1)  // one row: the next group's reads overlap this one's chain
      for (int gl = 0; gl < ng; ++gl) {
        if constexpr (KM) {  // an outer product per k
#pragma unroll 8
          for (int kk = 0; kk < GROUP; ++kk) {
            const int k = gl * GROUP + kk;
            float a[TM], bv[TN];
            load_kmajor<TM, RY>(s_x + k * BM, ty, a);
            load_kmajor<TN, RX>(s_w + k * BN, tx, bv);
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
              for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
          }
        } else {  // four k a step, float4 reads along k
#pragma unroll
          for (int k4 = 0; k4 < GROUP / 4; ++k4) {
            const int k = gl * GROUP + 4 * k4;
            float4 a[TM], bv[TN];
#pragma unroll
            for (int i = 0; i < TM; ++i)
              a[i] = *reinterpret_cast<const float4*>(s_x + (ty + i * RY) * XS + k);
#pragma unroll
            for (int j = 0; j < TN; ++j)
              bv[j] = *reinterpret_cast<const float4*>(s_w + (tx + j * RX) * XS + k);
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
              for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i].x, bv[j].x, acc[i][j]);
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
              for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i].y, bv[j].y, acc[i][j]);
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
              for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i].z, bv[j].z, acc[i][j]);
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
              for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i].w, bv[j].w, acc[i][j]);
          }
        }
        if constexpr (Loader::MIN_ROW) {
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float sx = s_xs[gl * BM + val_idx<TM, RY, KM>(ty, i)];
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[i][j] = fmaf(sx, s_nm[gl * BN + val_idx<TN, RX, KM>(tx, j)], acc[i][j]);
          }
        }
      }
    }
    bar_arrive(BAR_EMPTY + b, NT);  // buffer b may be refilled
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + val_idx<TM, RY, KM>(ty, i);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + val_idx<TN, RX, KM>(tx, j);
      if (n < N) out[(size_t)m * N + n] = acc[i][j];
    }
  }
}

// the tiles of B, G, H and L: K-block i = blockIdx.z (groups i*Gb ..
// i*Gb+Gb-1) → partials out[i] of [nb, M, N]; one block is the whole product
template <class Tl, typename Loader>
__global__ void __launch_bounds__(Tl::THREADS, Tl::MINB)
dequant_tile_kernel(const void* __restrict__ x, int xb, const Loader w,
                    float* __restrict__ out, int M, int K, int N, int Gb) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int i = blockIdx.z;
  dequant_tile_body<Tl, Loader>(x, xb, w, out + (size_t)i * M * N, M, K, N, i * Gb,
                                (i + 1) * Gb, smem);
}

// kernel K's tiles: selected expert j = blockIdx.z, e = eids[j]
template <class Tl, typename Loader>
__global__ void __launch_bounds__(Tl::THREADS, Tl::MINB)
dequant_bank_tile_kernel(const void* __restrict__ x, int xb, const Loader w,
                         const int* __restrict__ eids, int n_expert, int x_per_expert,
                         float* __restrict__ out, int M, int K, int N) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int j = blockIdx.z, e = eids[j];
  float* o = out + (size_t)j * M * N;
  if (e < 0 || e >= n_expert) {  // an id outside the bank: NaN, loudly
    const int m0 = blockIdx.y * Tl::BM, n0 = blockIdx.x * Tl::BN;
    for (int i = threadIdx.x; i < Tl::BM * Tl::BN; i += blockDim.x) {
      const int m = m0 + i / Tl::BN, n = n0 + i % Tl::BN;
      if (m < M && n < N) o[(size_t)m * N + n] = quiet_nan();
    }
    return;
  }
  const size_t x0 = x_per_expert ? (size_t)j * M * K * (xb ? 2 : 4) : 0;
  dequant_tile_body<Tl, Loader>(static_cast<const uint8_t*>(x) + x0, xb, w.expert(e, K, N), o,
                                M, K, N, 0, K / GROUP, smem);
}

template <class Tl, typename Loader>
cudaError_t launch_tile(const void* x, int xb, const Loader& w, int nb, void* out, int M, int K,
                        int N, cudaStream_t st) {
  const int smem = tile_smem_bytes<Tl, Loader>(xb ? 2 : 4);
  // above 48 KB only once allowed; the call is cheap and a CUDA graph captures it
  const cudaError_t err = cudaFuncSetAttribute(
      dequant_tile_kernel<Tl, Loader>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + Tl::BN - 1) / Tl::BN, (M + Tl::BM - 1) / Tl::BM, nb);
  dequant_tile_kernel<Tl, Loader><<<grid, Tl::THREADS, smem, st>>>(
      x, xb, w, static_cast<float*>(out), M, K, N, K / GROUP / nb);
  return cudaGetLastError();
}

template <class Tl, typename Loader>
cudaError_t launch_bank_tile(const void* x, int xb, const Loader& w, const int* eids, int n_sel,
                             int n_expert, int x_per_expert, void* out, int M, int K, int N,
                             cudaStream_t st) {
  const int smem = tile_smem_bytes<Tl, Loader>(xb ? 2 : 4);
  const cudaError_t err = cudaFuncSetAttribute(
      dequant_bank_tile_kernel<Tl, Loader>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + Tl::BN - 1) / Tl::BN, (M + Tl::BM - 1) / Tl::BM, n_sel);
  dequant_bank_tile_kernel<Tl, Loader><<<grid, Tl::THREADS, smem, st>>>(
      x, xb, w, eids, n_expert, x_per_expert, static_cast<float*>(out), M, K, N);
  return cudaGetLastError();
}

// tile index t of the plan (ops/quant_matmul.py tile_plan) → f<Tile t>()
template <typename F>
cudaError_t with_tile(int t, F f) {
  switch (t) {
    case 0: return f(Tile0{});
    case 1: return f(Tile1{});
    case 2: return f(Tile2{});
    case 3: return f(Tile3{});
    case 4: return f(Tile4{});
    case 5: return f(Tile5{});
    case 6: return f(Tile6{});
    case 7: return f(Tile7{});
    default: return cudaErrorInvalidValue;
  }
}

// one-row tile t of the plan (ops/quant_matmul.py row_plan) → f<RowTile t>()
template <typename F>
cudaError_t with_row_tile(int t, F f) {
  switch (t) {
    case 0: return f(RowTile0{});
    case 1: return f(RowTile1{});
    default: return cudaErrorInvalidValue;
  }
}

// bm_bn[0..1] = tile t's rows and columns (ops/quant_matmul.py TILES must
// list the same)
int tile_shape(int t, int* bm_bn) {
  return (int)with_tile(t, [&](auto tl) {
    bm_bn[0] = decltype(tl)::BM;
    bm_bn[1] = decltype(tl)::BN;
    return cudaSuccess;
  });
}

// one row goes to the one-row tile `plan` (row_plan), more rows to the tile
// `plan` (tile_plan); nb K-blocks of K/nb elements (nb = 1: the whole
// product [M, N])
template <typename Loader>
int launch_dequant_mm(const void* x, int x_bf16, const Loader& w, int nb, int plan, void* out,
                      int M, int K, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto tl) {
    return launch_tile<decltype(tl)>(x, x_bf16, w, nb, out, M, K, N, st);
  };
  return (int)(M == 1 ? with_row_tile(plan, launch) : with_tile(plan, launch));
}

template <typename Loader>
int launch_bank_mm(const void* x, int x_bf16, const Loader& w, const void* eids,
                   int n_sel, int n_expert, int x_per_expert, int plan, void* out, int M,
                   int K, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ei = static_cast<const int*>(eids);
  auto launch = [&](auto tl) {
    return launch_bank_tile<decltype(tl)>(x, x_bf16, w, ei, n_sel, n_expert, x_per_expert, out,
                                          M, K, N, st);
  };
  return (int)(M == 1 ? with_row_tile(plan, launch) : with_tile(plan, launch));
}

}  // namespace

extern "C" {

// The tile shapes of the exact dequant GEMM: bm_bn (host memory) receives
// tile t's rows and columns; an unknown t gives cudaErrorInvalidValue.
int dequant_tile_shape(int t, void* bm_bn) { return tile_shape(t, static_cast<int*>(bm_bn)); }

// The one-row tiles of the exact dequant GEMM: for one-row tile t and
// loader l of ops/quant_matmul.py ROW_LOADERS (0 B f32 scales, 1 B bf16, 2
// K / L f32, 3 K / L bf16, 4 G group 32, 5 G group 16, 6 H) with bf16
// (x_bf16) or f32 x, out5 (host memory) receives the columns a CTA owns,
// the groups a stage carries, the ring's stages, the producer warps and the
// dynamic shared memory bytes; an unknown t or l gives cudaErrorInvalidValue.
int dequant_row_shape(int t, int loader, int x_bf16, void* out5) {
  int* o = static_cast<int*>(out5);
  const int xsz = x_bf16 ? 2 : 4;
  return (int)with_row_tile(t, [&](auto tl) {
    using Tl = decltype(tl);
    int smem;
    switch (loader) {
      case 0: smem = tile_smem_bytes<Tl, Q4KLoader<float>>(xsz); break;
      case 1: smem = tile_smem_bytes<Tl, Q4KLoader<__nv_bfloat16>>(xsz); break;
      case 2: smem = tile_smem_bytes<Tl, Q4KMinLoader<float>>(xsz); break;
      case 3: smem = tile_smem_bytes<Tl, Q4KMinLoader<__nv_bfloat16>>(xsz); break;
      case 4: smem = tile_smem_bytes<Tl, Q8Loader<32>>(xsz); break;
      case 5: smem = tile_smem_bytes<Tl, Q8Loader<16>>(xsz); break;
      case 6: smem = tile_smem_bytes<Tl, K4Loader>(xsz); break;
      default: return cudaErrorInvalidValue;
    }
    o[0] = Tl::BN, o[1] = Tl::SG, o[2] = Tl::STAGES, o[3] = Tl::PW, o[4] = smem;
    return cudaSuccess;
  });
}

// Kernel A (nb = 1) and kernel M (nb K-blocks of K/nb elements), one
// launch: x [M, K] bf16 (x_bf16 != 0) or f32, 1 <= M <= 16, 16-byte
// aligned, K % (256*nb) == 0; codes [N, K/2], scales / mins [N, K/32] bf16;
// out [nb, M, N] f32, out[i] equal bit for bit to kernel A on (x[:, block
// i], w[:, block i]) alone. When xq is not null, xq [M, K] int8 and xs / sxm
// [M, K/32] f32 receive x's codes, scales and scale*sum. rw (1, 2, 4, 8)
// and grid: ops/quant_matmul.py gemv_plan; they move no bit.
int w4a8_matmul_launch(const void* x, int x_bf16, const void* codes, const void* scales,
                       const void* mins, int nb, void* xq, void* xs, void* sxm, void* out,
                       int M, int K, int N, int rw, int grid, void* stream) {
  if (nb < 1 || nb > 65535 || K % (QK_K * nb)) return (int)cudaErrorInvalidValue;
  GvArgs a{};
  a.x = x; a.x_bf16 = x_bf16;
  a.codes = static_cast<const uint8_t*>(codes);
  a.scales = static_cast<const __nv_bfloat16*>(scales);
  a.mins = static_cast<const __nv_bfloat16*>(mins);
  a.out = static_cast<float*>(out);
  a.xq = static_cast<int8_t*>(xq); a.xs = static_cast<float*>(xs);
  a.sxm = static_cast<float*>(sxm);
  a.M = M; a.K = K; a.N = N; a.n_mat = nb; a.klen = K / nb;
  return launch_gv<GV_KIND_A>(a, rw, grid, stream);
}

// Kernel I: the same on native Q4_K superblocks, blocks [N, K/256 * 144]
// bytes, 16-byte aligned; K % 256 == 0; out [M, N] f32.
int w4a8k4_matmul_launch(const void* x, int x_bf16, const void* blocks, void* xq, void* xs,
                         void* sxm, void* out, int M, int K, int N, int rw, int grid,
                         void* stream) {
  GvArgs a{};
  a.x = x; a.x_bf16 = x_bf16;
  a.codes = static_cast<const uint8_t*>(blocks);
  a.out = static_cast<float*>(out);
  a.xq = static_cast<int8_t*>(xq); a.xs = static_cast<float*>(xs);
  a.sxm = static_cast<float*>(sxm);
  a.M = M; a.K = K; a.N = N; a.n_mat = 1; a.klen = K;
  return launch_gv<GV_KIND_I>(a, rw, grid, stream);
}

// x: [M, K] bf16 (x_bf16 != 0) or f32, K % 32 == 0, 16-byte aligned; out:
// [M, N] f32. scales: [N, K/32] f32 (scales_f32 != 0) or bf16. plan: for M
// > 1 the tile shape (0 .. N_TILES-1; ops/quant_matmul.py tile_plan), for M
// = 1 the one-row shape (0 .. N_ROW_TILES-1; row_plan); codes 16-byte
// aligned.
int q4k_dequant_mm_launch(const void* x, int x_bf16, const void* codes,
                          const void* scales, int scales_f32, int plan, void* out, int M,
                          int K, int N, void* stream) {
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  if (scales_f32)
    return launch_dequant_mm(x, x_bf16, Q4KLoader<float>{c, static_cast<const float*>(scales)},
                             1, plan, out, M, K, N, stream);
  return launch_dequant_mm(
      x, x_bf16, Q4KLoader<__nv_bfloat16>{c, static_cast<const __nv_bfloat16*>(scales)},
      1, plan, out, M, K, N, stream);
}

// codes: [N, K] int8; scales: [N, K/group] f32, group 32 or 16; K % 32 == 0;
// plan as for kernel B.
int q8_dequant_mm_launch(const void* x, int x_bf16, const void* codes,
                         const void* scales, int group, int plan, void* out, int M, int K,
                         int N, void* stream) {
  const int8_t* c = static_cast<const int8_t*>(codes);
  const float* s = static_cast<const float*>(scales);
  if (group == 32)
    return launch_dequant_mm(x, x_bf16, Q8Loader<32>{c, s}, 1, plan, out, M, K, N, stream);
  if (group == 16)
    return launch_dequant_mm(x, x_bf16, Q8Loader<16>{c, s}, 1, plan, out, M, K, N, stream);
  return (int)cudaErrorInvalidValue;
}

// blocks: [N, K/256 * 144] bytes of Q4_K superblocks; K % 256 == 0; plan as
// for kernel B.
int q4k_native_mm_launch(const void* x, int x_bf16, const void* blocks, int plan, void* out,
                         int M, int K, int N, void* stream) {
  return launch_dequant_mm(x, x_bf16, K4Loader{static_cast<const uint8_t*>(blocks)},
                           1, plan, out, M, K, N, stream);
}

// Kernel J: kernel A over selected experts of a bank, one launch. codes
// [Ne, N, K/2], scales / mins [Ne, N, K/32] bf16; eids [n_sel] int32 on the
// card; x is [M, K] shared by every selected expert, or [n_sel, M, K]
// (x_per_expert != 0), 1 <= M <= 16, K % 256 == 0. xq / xs / sxm (M or
// n_sel*M rows), when not null, receive x's quantization; out [n_sel, M, N]
// f32, out[j] equal bit for bit to kernel A on expert eids[j] alone, NaN for
// an id outside the bank. rw and grid as for kernel A.
int w4a8_bank_launch(const void* x, int x_bf16, int x_per_expert, const void* codes,
                     const void* scales, const void* mins, const void* eids, int n_sel,
                     int n_expert, void* xq, void* xs, void* sxm, void* out, int M,
                     int K, int N, int rw, int grid, void* stream) {
  if (n_sel < 1) return (int)cudaErrorInvalidValue;
  GvArgs a{};
  a.x = x; a.x_bf16 = x_bf16;
  a.codes = static_cast<const uint8_t*>(codes);
  a.scales = static_cast<const __nv_bfloat16*>(scales);
  a.mins = static_cast<const __nv_bfloat16*>(mins);
  a.eids = static_cast<const int*>(eids);
  a.n_expert = n_expert; a.x_per_mat = x_per_expert;
  a.out = static_cast<float*>(out);
  a.xq = static_cast<int8_t*>(xq); a.xs = static_cast<float*>(xs);
  a.sxm = static_cast<float*>(sxm);
  a.M = M; a.K = K; a.N = N; a.n_mat = n_sel; a.klen = K;
  return launch_gv<GV_KIND_A>(a, rw, grid, stream);
}

// Kernel K: the exact dequant GEMM over selected experts of a bank, min term
// inside. codes [Ne, N, K/2], scales / mins [Ne, N, K/32] f32 (scales_f32 !=
// 0) or bf16; eids and x as for kernel J (any M >= 1); out [n_sel, M, N] f32;
// plan as for kernel B.
int q4k_bank_mm_launch(const void* x, int x_bf16, int x_per_expert, const void* codes,
                       const void* scales, const void* mins, int scales_f32,
                       const void* eids, int n_sel, int n_expert, int plan, void* out, int M,
                       int K, int N, void* stream) {
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  if (scales_f32) {
    const Q4KMinLoader<float> w{{c, static_cast<const float*>(scales)},
                                static_cast<const float*>(mins)};
    return launch_bank_mm(x, x_bf16, w, eids, n_sel, n_expert, x_per_expert, plan, out, M,
                          K, N, stream);
  }
  const Q4KMinLoader<__nv_bfloat16> w{{c, static_cast<const __nv_bfloat16*>(scales)},
                                      static_cast<const __nv_bfloat16*>(mins)};
  return launch_bank_mm(x, x_bf16, w, eids, n_sel, n_expert, x_per_expert, plan, out, M, K,
                        N, stream);
}

// Kernel L: the exact dequant GEMM with the min term inside on nb K-blocks
// of K/nb elements each (K % (32*nb) == 0), one launch: out [nb, M, N] f32,
// out[i] the partial of block i, equal bit for bit to the same kernel on
// (x[:, block i], w[:, block i]) alone; nb = 1 is the pinned product.
// codes [N, K/2], scales / mins [N, K/32] f32 (scales_f32 != 0) or bf16;
// plan as for kernel B (row_plan over a K-block's K/nb elements).
int q4k_parts_mm_launch(const void* x, int x_bf16, const void* codes, const void* scales,
                        const void* mins, int scales_f32, int nb, int plan, void* out, int M,
                        int K, int N, void* stream) {
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  if (nb < 1 || nb > 65535 || K % (GROUP * nb)) return (int)cudaErrorInvalidValue;
  if (scales_f32) {
    const Q4KMinLoader<float> w{{c, static_cast<const float*>(scales)},
                                static_cast<const float*>(mins)};
    return launch_dequant_mm(x, x_bf16, w, nb, plan, out, M, K, N, stream);
  }
  const Q4KMinLoader<__nv_bfloat16> w{{c, static_cast<const __nv_bfloat16*>(scales)},
                                      static_cast<const __nv_bfloat16*>(mins)};
  return launch_dequant_mm(x, x_bf16, w, nb, plan, out, M, K, N, stream);
}

}  // extern "C"
