// Table-driven block-sparse flash attention for Hopper (sm_90a), bf16.
//
// Replaces two Pallas kernels that share one design:
//   wan2gp_tpu/ops/sparse_attention.py::_sparse_flash_kernel (launched by
//     _sparse_flash): one kv-block table kv_idx [nQb, maxA] + counts [nQb]
//     for every head (the radial and sliding-window masks);
//   wan2gp_tpu/ops/sol_attention.py::_sol_flash_kernel (launched by
//     _sol_flash): one table per (batch, head), kv_idx [G, nQb, W] +
//     counts [G, nQb], G = B*N, and the per-row logsumexp as a second
//     output (-1e30 where a row attends nothing).
// Same numerics as the dense kernel and as the Pallas kernels: q is scaled
// in bf16 before QK^T, scores and the online-softmax state stay fp32, P is
// rounded to bf16 before P.V, keys at or past min(kv0 + block_kv, S) are
// masked, and a zero denominator becomes 1 (a q block whose count is 0
// outputs zeros).
//
// What bounds it: the work is 4*D operations per (query, attended key) on
// the bf16 tensor cores; at the 14B 720p shapes (L = S = 75,600, D = 128,
// a sixth to a half of the kv blocks attended) that is tens of TFLOP per
// call against a few hundred MB of q/k/v/o, so the bound is the tensor-core
// rate.  The table itself is a few hundred KB read through the cache.
//
// Design: the flash CTA of flash_cta.cuh (TMA, a 2-stage K/V mbarrier
// ring, one producer thread, two consumer warpgroups on wgmma) in its
// kTable mode: the producer walks the CTA's table row and loads the
// 128-key tiles of each listed kv block that start before the block's end
// (min(kv0 + block_kv, S)), and hands each tile's first key and block end
// to the consumers beside it in the ring; the consumers are the dense
// kernel's, with the score mask at the block end.  block_q a multiple of
// 128 takes the two-consumer CTA (128 q rows, so a CTA never straddles
// two route blocks), any other multiple of 64 the one-consumer CTA with 64
// rows; block_kv is any multiple of 64.  The table's head stride is 0 for
// the shared-table form; the logsumexp is written only when asked for.
// ptxas (nvcc 12.9, sm_90a, `-Xptxas -v`; chip_smoke.py's env phase
// prints it on every run), registers a thread, and the dynamic shared
// memory of Layout (ptxas reports none, since it is all dynamic); no
// instantiation spills or has a stack frame:
//   <D, consumers>  registers  shared memory
//   <128, 2>        168        164,920
//   <128, 1>        184        148,536
//   <64, 2>         168         83,000
//   <64, 1>         149         74,808
// With two consumers setmaxnreg gives the producer 24 registers, in which
// it walks the table.
#include "flash_cta.cuh"   // the CTA template and its launch

namespace {

int run(const void* q, const void* k, const void* v, void* o, void* lse,
        const void* kv_idx, const void* counts, int B, int L, int S, int N,
        int D, int nqb, int w, int block_q, int block_kv, int per_head,
        const long long* st, float scale, void* stream) {
  if (block_q <= 0 || block_q % 64 != 0 || block_kv <= 0 ||
      block_kv % 64 != 0 || (long long)nqb * block_q < L)
    return cudaErrorInvalidValue;
  TableArgs tb;
  tb.kv_idx = static_cast<const int*>(kv_idx);
  tb.counts = static_cast<const int*>(counts);
  tb.lse = static_cast<float*>(lse);
  tb.tbl_g = per_head ? (long long)nqb * w : 0;
  tb.cnt_g = per_head ? nqb : 0;
  tb.w = w;
  tb.block_q = block_q;
  tb.block_kv = block_kv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = block_q % 128 == 0;   // two consumers, 128-row q tile
  if (D == 128)
    return wide ? launch<128, kTable, 2>(q, k, v, nullptr, 0, tb, o, B, L,
                                         S, N, st, scale, s)
                : launch<128, kTable, 1>(q, k, v, nullptr, 0, tb, o, B, L,
                                         S, N, st, scale, s);
  if (D == 64)
    return wide ? launch<64, kTable, 2>(q, k, v, nullptr, 0, tb, o, B, L, S,
                                        N, st, scale, s)
                : launch<64, kTable, 1>(q, k, v, nullptr, 0, tb, o, B, L, S,
                                        N, st, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q: [B, L, N, D], k/v: [B, S, N, D], o: [B, L, N, D]; bf16, unit stride on
// D, 16-byte aligned base pointers and element strides that are multiples
// of 8 (what a TMA map takes).  strides: 12 element strides (b, l, n) of
// q, k, v and o in that order.  kv_idx [nQb, maxA] and counts [nQb],
// int32, shared by every head; block_q and block_kv multiples of 64.
extern "C" int wg_sparse_flash_bf16(const void* q, const void* k,
                                    const void* v, void* o,
                                    const void* kv_idx, const void* counts,
                                    int B, int L, int S, int N, int D,
                                    int nqb, int max_a, int block_q,
                                    int block_kv, const long long* strides,
                                    float scale, void* stream) {
  return run(q, k, v, o, nullptr, kv_idx, counts, B, L, S, N, D, nqb, max_a,
             block_q, block_kv, 0, strides, scale, stream);
}

// As above with one table per (batch, head): kv_idx [B*N, nQb, W] and
// counts [B*N, nQb], int32; also writes lse [B, N, L] fp32.
extern "C" int wg_sol_flash_bf16(const void* q, const void* k, const void* v,
                                 void* o, void* lse, const void* kv_idx,
                                 const void* counts, int B, int L, int S,
                                 int N, int D, int nqb, int w, int block_q,
                                 int block_kv, const long long* strides,
                                 float scale, void* stream) {
  return run(q, k, v, o, lse, kv_idx, counts, B, L, S, N, D, nqb, w,
             block_q, block_kv, 1, strides, scale, stream);
}
