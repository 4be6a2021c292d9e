// Flash attention forward for Hopper (sm_90a), bf16 in / bf16 out, dense
// or with a per-key validity mask.
//
// Replaces two Pallas kernels of wan2gp_tpu/ops/attention.py (launched by
// _flash_attention):
//   _flash_kernel: dense.  Same numerics: q is scaled in bf16 before QK^T
//     (the wrapper passes the scale already rounded to bf16), scores and
//     the online-softmax state (running max m, denominator l, accumulator)
//     stay fp32, P is rounded to bf16 before P.V, keys past S are masked,
//     and a zero denominator becomes 1.
//   _flash_kernel_kvmask: the same with a [B, S] key-validity mask (uint8
//     here, one row per batch item; the TPU kernel's 8-row fp32 broadcast
//     is dropped).  Masked scores become the finite -1e30, P is forced to
//     0 while the running max is still <= -1e30/2 (so a key of a fully
//     masked tile never counts as exp(0) = 1), and a fully masked row
//     keeps l = 0, so it writes exact zeros.  No -inf is ever formed.
//   Both are modes of one CTA template (kDense, kMasked of flash_cta.cuh);
//   the dense instantiation compiles none of the mask code, and with every
//   key valid the masked one returns the dense one's bits (same operations
//   in the same order).
//
// What bounds it: the work is 4*B*N*L*S*D operations on the tensor cores
// and the traffic is q, k, v read once and o written once.  At the
// self-attention shapes of the Wan DiT (L = S in the tens of thousands,
// D = 128) the operations bound it by far (bf16 tensor-core rate, 989
// TFLOP/s on an H100 SXM).  At cross-attention (S = 512) they still do,
// but only just: at the 1.3B shape 0.21 ms of operations against 0.12 ms
// of bytes (3.35 TB/s), and each CTA walks only 4 kv tiles, so its fixed
// costs (barrier set-up, the q load and scaling, the epilogue) weigh.
//
// Design: the CTA of flash_cta.cuh (TMA loads over the native strided
// layout, a 2-stage K/V mbarrier ring fed by one producer thread, two
// consumer warpgroups running wgmma, setmaxnreg 24/240), in its kDense and
// kMasked modes; a one-consumer, 64-row instantiation serves L <= 64.
// ptxas (nvcc 12.9, sm_90a, `-Xptxas -v`; chip_smoke.py's env phase prints
// it on every run), registers a thread, no spills, and the dynamic shared
// memory of Layout (dense / masked bytes; ptxas reports none, since it is
// all dynamic):
//   <D, mode, consumers>    registers          shared memory
//   <128, *, 2>             168                164,904 / 165,160
//   <128, *, 1>             180 / 181          148,520 / 148,776
//   <64, *, 2>              168                 82,984 /  83,240
//   <64, *, 1>              147 / 152           74,792 /  75,048
// 168 is what __launch_bounds__ leaves 384 threads (65,536 / 384, rounded
// down to 8); setmaxnreg then gives the consumers 240 and the producer 24.
// Occupancy: one CTA per SM at every instantiation of two consumers (by
// registers), so 8 consumer warps and 4 producer warps per SM at L > 64.
#include "flash_cta.cuh"   // the CTA template and its launch

namespace {

template <int Mode>
int dispatch(const void* q, const void* k, const void* v, const void* kvm,
             long long msb, void* o, int B, int L, int S, int N, int D,
             const long long* st, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool small = L <= 64;          // one consumer warpgroup, 64-row tile
  if (D == 128)
    return small ? launch<128, Mode, 1>(q, k, v, kvm, msb, {}, o, B, L, S,
                                        N, st, scale, s)
                 : launch<128, Mode, 2>(q, k, v, kvm, msb, {}, o, B, L, S,
                                        N, st, scale, s);
  if (D == 64)
    return small ? launch<64, Mode, 1>(q, k, v, kvm, msb, {}, o, B, L, S,
                                       N, st, scale, s)
                 : launch<64, Mode, 2>(q, k, v, kvm, msb, {}, o, B, L, S,
                                       N, st, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q: [B, L, N, D], k/v: [B, S, N, D], o: [B, L, N, D]; bf16, unit stride on
// D, 16-byte aligned base pointers and element strides that are multiples
// of 8 (what a TMA map takes).  strides: 12 element strides (b, l, n) of
// q, k, v and o in that order.
extern "C" int wg_flash_attention_bf16(const void* q, const void* k,
                                       const void* v, void* o, int B, int L,
                                       int S, int N, int D,
                                       const long long* strides, float scale,
                                       void* stream) {
  return dispatch<kDense>(q, k, v, nullptr, 0, o, B, L, S, N, D, strides,
                          scale, stream);
}

// As above, with kv_mask: [B, S] bytes (non-zero = valid key), unit stride
// on S and `mask_bstride` bytes between batch rows; each row holds at least
// S rounded up to a multiple of 16 bytes, and the base and mask_bstride are
// multiples of 16 (what a bulk copy takes).
extern "C" int wg_flash_attention_kvmask_bf16(
    const void* q, const void* k, const void* v, const void* kv_mask,
    void* o, int B, int L, int S, int N, int D, const long long* strides,
    long long mask_bstride, float scale, void* stream) {
  if (mask_bstride % 16 || reinterpret_cast<uintptr_t>(kv_mask) % 16)
    return cudaErrorInvalidValue;
  return dispatch<kMasked>(q, k, v, kv_mask, mask_bstride, o, B, L, S, N,
                           D, strides, scale, stream);
}
