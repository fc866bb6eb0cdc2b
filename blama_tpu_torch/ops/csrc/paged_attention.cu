// Kernels E and F: flash attention over the PAGED KV pool.
//
// Kernel E (paged_decode_attention_launch) and kernel F
// (paged_prefill_attention_launch) replace
//   blama_tpu/ops/pallas/paged_attention.py:_paged_attn_kernel
// in its decode (block_t == 0) and prefill forms.
//
// The pool is [P*G (+ spare), Hkv, D] slots in pages of G, int8 codes with
// f32 scales (kv_type 0) or bf16 (kv_type 1) or f32 (kv_type 2) values with
// null scale pointers; pool_pos [P*G] holds each slot's position (-1 = empty) and
// page_table [B, MP] each row's physical page per logical page (-1 =
// unmapped). A row's logical window is S = MP*G slots. The device code is
// the dense kernels' (attention_common.cuh): E is C's decode body with the
// paged address (the same fixed splits, tiles, slot order and fold); F's
// stage pass reads the pool through the page table into the same dense
// scratch D's reads, and the rest is D's code. So the output is
// bit-identical to kernels C and D over the same logical row, whatever the
// physical placement. An unmapped page is not read: only live pages cost
// bytes.

#include "attention_common.cuh"

extern "C" {

// Each returns a cudaError_t; -1 for a head dim or store type the kernels
// are not built for.
int paged_decode_attention_launch(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* pool_pos, const void* page_table,
    const void* q_pos, const void* invf, void* work, void* tickets, void* out, int B,
    int H, int Hkv, int D, int MP, int G, int split, int heads, int kv_type, float scale,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const attn::PagedAddr addr{static_cast<const int*>(page_table), MP, G};
  const int S = MP * G;
  ATTN_DISPATCH_PADDED(attn::decode_impl, attn::PagedAddr, q, k, v, ks, vs, pool_pos, q_pos,
                       invf, nullptr, nullptr, nullptr, work, tickets, out, addr, B, H, Hkv,
                       D, S, split, heads, 0, scale, st);
}

// F: D's scratch, plan and partials over the row's logical window S = MP*G.
int paged_prefill_attention_launch(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* pool_pos, const void* page_table,
    const void* q_pos, const void* invf, void* kr, void* vr, void* spos, void* tmin,
    void* sks, void* svs, void* part_m, void* part_l, void* part_acc, void* out, int B, int T,
    int H, int Hkv, int D, int MP, int G, int tq, int split, int kv_type, float scale,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const attn::PagedAddr addr{static_cast<const int*>(page_table), MP, G};
  const int S = MP * G;
  ATTN_DISPATCH_PADDED(attn::prefill_impl, attn::PagedAddr, q, k, v, ks, vs, pool_pos,
                       q_pos, invf, kr, vr, spos, tmin, sks, svs, part_m, part_l, part_acc,
                       out, addr, B, T, H, Hkv, D, S, tq, split, scale, st);
}

}  // extern "C"
