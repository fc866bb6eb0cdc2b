// Kernels C, D, N, O and P: flash attention over DENSE cache rows
// [B, S, Hkv, D].
//
// Kernel C (decode_attention_launch) replaces
//   blama_tpu/ops/pallas/decode_attention.py:_decode_attn_kernel,
// kernel N (the same entry with the fresh row, write == 0) the same kernel
// with its fresh-operand patch (`fresh=True`), kernel P (write == 1)
// _decode_attn_write_kernel, kernel O (decode_attention_hb_launch)
// _decode_attn_kernel_hb, and kernel D (prefill_attention_launch)
// _prefill_attn_kernel.
//
// The cache is int8 codes with f32 scales [B, S, Hkv] (kv_type 0), or bf16
// (kv_type 1) or f32 (kv_type 2) values with null scale pointers; the slot
// position map is [B, S] (-1 = empty). The device code, its bound and its
// design are in attention_common.cuh; here a row's logical slot s is
// physical slot b*S + s. C, N and P are one launch of the decode body over
// fixed splits of the row's slots; kernel D is two passes there (the stage
// pass that rotates K once per slot into a bf16 scratch, then GQA-packed
// query tiles on the tensor cores) and a combine when a row's slots span
// more than one split; kernel O is its rope angles' launch, then one launch
// over (row, kv head, chunk of query heads, split) that stages with the
// bulk copy and whose last CTAs fold the splits. C, D, N and P take any even D <=
// 256; O the D its gate admits (128, 256; built at 64 too).

#include "attention_common.cuh"

extern "C" {

// Each returns a cudaError_t; -1 for a head dim or store type the kernels
// are not built for.

// C (k_new == nullptr), N (write == 0) and P (write == 1): k_new / v_new
// [B, Hkv, D] bf16, slot [B] int32 (>= S: a pad row). With write == 1 the
// cache pointers address the layer's whole store, B*S slots and the spare
// slot after them, which P writes. `split` slots a split and `heads` query
// heads a CTA (ops/decode_attention.decode_plan); `work` the f32 partials
// (m, l [B, H, nsplit], acc [B, H, nsplit, D]; null for one split) and
// `tickets` [B * Hkv * chunks] int32, zero between calls.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* ks, const void* vs, const void* kv_pos,
                            const void* q_pos, const void* invf, const void* k_new,
                            const void* v_new, const void* slot, void* work,
                            void* tickets, void* out, int B, int H, int Hkv, int D,
                            int S, int split, int heads, int kv_type, int write,
                            float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const attn::DenseAddr addr{S};
  ATTN_DISPATCH_PADDED(attn::decode_impl, attn::DenseAddr, q, k, v, ks, vs, kv_pos, q_pos,
                       invf, k_new, v_new, slot, work, tickets, out, addr, B, H, Hkv, D, S,
                       split, heads, write, scale, st);
}

// O: `chunk` is the head-batched split (slots per block), `ts` the slots
// of a tile and `heads` the query heads of a CTA (ops/decode_attention.
// hb_plan); `ang` the angles' scratch [B*S, D] f32; part_* the f32
// partials, m and l [B, H, nsplit], acc [B, H, nsplit, D]; `tickets` [B *
// Hkv * head chunks] int32, zero between calls.
int decode_attention_hb_launch(const void* q, const void* k, const void* v,
                               const void* ks, const void* vs, const void* kv_pos,
                               const void* q_pos, const void* invf, void* ang, void* part_m,
                               void* part_l, void* part_acc, void* tickets, void* out,
                               int B, int H, int Hkv, int D, int S, int chunk, int ts,
                               int heads, int kv_type, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const attn::DenseAddr addr{S};
  ATTN_DISPATCH(attn::decode_hb_impl, attn::DenseAddr, q, k, v, ks, vs, kv_pos,
                q_pos, invf, ang, part_m, part_l, part_acc, tickets, out, addr, B, H, Hkv,
                S, chunk, ts, heads, scale, st);
}

// D: the scratch kr [B, Hkv, Sp, 2, DP] and vr [B, Hkv, Sp, 1 or 2 (f32 store),
// DP] bf16 (DP: D padded to 64, 128 or 256), spos [B, Sp] and tmin [B, Sp / tile] int32, sks / svs [B, Hkv, Sp]
// f32 (int8 store; else null), Sp = S in whole tiles; `tq`
// query tokens a CTA and `split` slots a split (ops/decode_attention
// .prefill_plan); part_* [B, T, H, nsplit(, D)] f32 when S > split, else null.
int prefill_attention_launch(const void* q, const void* k, const void* v,
                             const void* ks, const void* vs, const void* kv_pos,
                             const void* q_pos, const void* invf, void* kr, void* vr,
                             void* spos, void* tmin, void* sks, void* svs, void* part_m,
                             void* part_l, void* part_acc, void* out, int B, int T,
                             int H, int Hkv, int D, int S, int tq, int split,
                             int kv_type, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const attn::DenseAddr addr{S};
  ATTN_DISPATCH_PADDED(attn::prefill_impl, attn::DenseAddr, q, k, v, ks, vs, kv_pos,
                       q_pos, invf, kr, vr, spos, tmin, sks, svs, part_m, part_l, part_acc,
                       out, addr, B, T, H, Hkv, D, S, tq, split, scale, st);
}

}  // extern "C"
