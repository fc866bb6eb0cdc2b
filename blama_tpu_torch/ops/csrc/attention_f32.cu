// Kernels C, D, E and F at f32 queries: the float32 engine's attention.
//
// The same functions as the bf16 instances (decode_attention.cu,
// paged_attention.cu), replacing the same TPU kernels
//   blama_tpu/ops/pallas/decode_attention.py:106 _decode_attn_kernel (C),
//   :976 _prefill_attn_kernel (D), and
//   blama_tpu/ops/pallas/paged_attention.py:155 _paged_attn_kernel (E, F),
// which take queries in the model's dtype and return that dtype: here q is
// f32 [B, T, H, D] and so is the output. The device code is
// attention_common.cuh's, instantiated at QT = float: C and E stage q in
// f32 as the bf16 instances already do (the same shared memory); D and F
// split q into a high and a low bf16 half for the tensor cores (S = Q_hi
// K_hi + Q_hi K_lo + Q_lo K_hi), so the scores keep f32 grade. Plans,
// splits, tiles and folds are the bf16 instances', so a row's bits depend
// only on its own query, position and store, and paged E / F equal dense C
// / D bit for bit. The fresh-row modes (N, P) and kernel O have no f32
// instance: their entries are bf16 only. A library of its own, so it builds
// beside the bf16 ones.

#include "attention_common.cuh"

extern "C" {

// C at f32 queries: decode_attention_launch's arguments, no fresh row.
int decode_attention_f32_launch(const void* q, const void* k, const void* v, const void* ks,
                                const void* vs, const void* kv_pos, const void* q_pos,
                                const void* invf, void* work, void* tickets, void* out, int B,
                                int H, int Hkv, int D, int S, int split, int heads,
                                int kv_type, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const attn::DenseAddr addr{S};
  ATTN_DISPATCH_PADDED_Q(attn::decode_impl, attn::DenseAddr, float, q, k, v, ks, vs, kv_pos,
                         q_pos, invf, nullptr, nullptr, nullptr, work, tickets, out, addr, B,
                         H, Hkv, D, S, split, heads, 0, scale, st);
}

// D at f32 queries: prefill_attention_launch's arguments.
int prefill_attention_f32_launch(const void* q, const void* k, const void* v, const void* ks,
                                 const void* vs, const void* kv_pos, const void* q_pos,
                                 const void* invf, void* kr, void* vr, void* spos, void* tmin,
                                 void* sks, void* svs, void* part_m, void* part_l,
                                 void* part_acc, void* out, int B, int T, int H, int Hkv,
                                 int D, int S, int tq, int split, int kv_type, float scale,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const attn::DenseAddr addr{S};
  ATTN_DISPATCH_PADDED_Q(attn::prefill_impl, attn::DenseAddr, float, q, k, v, ks, vs, kv_pos,
                         q_pos, invf, kr, vr, spos, tmin, sks, svs, part_m, part_l, part_acc,
                         out, addr, B, T, H, Hkv, D, S, tq, split, scale, st);
}

// E at f32 queries: paged_decode_attention_launch's arguments.
int paged_decode_attention_f32_launch(
    const void* q, const void* k, const void* v, const void* ks, const void* vs,
    const void* pool_pos, const void* page_table, const void* q_pos, const void* invf,
    void* work, void* tickets, void* out, int B, int H, int Hkv, int D, int MP, int G,
    int split, int heads, int kv_type, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const attn::PagedAddr addr{static_cast<const int*>(page_table), MP, G};
  const int S = MP * G;
  ATTN_DISPATCH_PADDED_Q(attn::decode_impl, attn::PagedAddr, float, q, k, v, ks, vs, pool_pos,
                         q_pos, invf, nullptr, nullptr, nullptr, work, tickets, out, addr, B,
                         H, Hkv, D, S, split, heads, 0, scale, st);
}

// F at f32 queries: paged_prefill_attention_launch's arguments.
int paged_prefill_attention_f32_launch(
    const void* q, const void* k, const void* v, const void* ks, const void* vs,
    const void* pool_pos, const void* page_table, const void* q_pos, const void* invf,
    void* kr, void* vr, void* spos, void* tmin, void* sks, void* svs, void* part_m,
    void* part_l, void* part_acc, void* out, int B, int T, int H, int Hkv, int D, int MP,
    int G, int tq, int split, int kv_type, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const attn::PagedAddr addr{static_cast<const int*>(page_table), MP, G};
  const int S = MP * G;
  ATTN_DISPATCH_PADDED_Q(attn::prefill_impl, attn::PagedAddr, float, q, k, v, ks, vs,
                         pool_pos, q_pos, invf, kr, vr, spos, tmin, sks, svs, part_m, part_l,
                         part_acc, out, addr, B, T, H, Hkv, D, S, tq, split, scale, st);
}

}  // extern "C"
