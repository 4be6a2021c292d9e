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
//   Both are one CTA, instantiated twice (template flag Masked); the dense
//   instantiation compiles none of the mask code.
//
// What bounds it: at the self-attention shapes of the Wan DiT (L = S in
// the tens of thousands, D = 128) the work is 4*B*N*L*S*D operations on
// the tensor cores, so the bound is the bf16 tensor-core rate (989 TFLOP/s
// on an H100 SXM).  Cross-attention (S = 512) reads q and writes o once,
// so there the bound is memory bandwidth.
//
// Design: one CTA of 4 warps per (q tile of 64 rows, head, batch).  The
// CTA reads the native strided [B, L, N, D] layout directly (no transposes
// and no padding on the host), keeps its Q tile in registers as mma.sync
// A fragments, and loops over 64-row K/V tiles staged row-major in shared
// memory with 16-byte stores.  Each warp owns 16 query rows: S = Q K^T and
// O += P V both run as m16n8k16 bf16 mma.sync with fp32 accumulation; the
// S accumulators are re-packed in registers as the A operand of P V, and
// the V operand is read with ldmatrix.trans.  Rows are padded by 8
// elements in shared memory so the fragment loads are free of bank
// conflicts.  Ragged L and S are masked inside the kernel; the masked
// variant stages each tile's 64 mask bytes in shared memory beside K and V
// (the tail past S reads as masked).  This is the simple first version:
// no TMA, no wgmma, no warp specialisation and no double buffering yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockKV = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four 8x8 b16 matrices, transposed: lanes 8i..8i+7 give the row addresses
// of matrix i, and register i receives that matrix as an mma B fragment.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D, bool Masked>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const uint8_t* __restrict__ kvm, long long msb,
                 __nv_bfloat16* __restrict__ o, int L, int S,
                 long long qsb, long long qsl, long long qsn,
                 long long ksb, long long ksl, long long ksn,
                 long long vsb, long long vsl, long long vsn,
                 long long osb, long long osl, long long osn, float scale) {
  constexpr int kStride = D + 8;      // padded row of Q_s / K_s
  constexpr int kChunks = D / 8;      // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + kBlockQ * kStride;
  __nv_bfloat16* v_s = k_s + kBlockKV * kStride;
  uint8_t* mk_s = reinterpret_cast<uint8_t*>(v_s + kBlockKV * kStride);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;            // mma group id (row)
  const int t4 = lane & 3;            // thread in group (column pair)
  const int q0 = blockIdx.x * kBlockQ;
  const int n = blockIdx.y;
  const int b = blockIdx.z;

  const __nv_bfloat16* qb = q + b * qsb + n * qsn;
  const __nv_bfloat16* kb = k + b * ksb + n * ksn;
  const __nv_bfloat16* vb = v + b * vsb + n * vsn;

  // ---- Q tile -> shared, scaled in bf16 (JAX: q * scale in q.dtype) ----
  for (int i = tid; i < kBlockQ * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < L) {
      val = *reinterpret_cast<const uint4*>(qb + (long long)(q0 + r) * qsl + c);
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = __float2bfloat16(__bfloat162float(e[j]) * scale);
    }
    *reinterpret_cast<uint4*>(q_s + r * kStride + c) = val;
  }
  __syncthreads();

  // ---- Q fragments stay in registers for the whole kv loop ----
  uint32_t qf[D / 16][4];
  const int row0 = warp * 16 + g;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t4;
    qf[kk][0] = ld32(q_s + row0 * kStride + c);
    qf[kk][1] = ld32(q_s + (row0 + 8) * kStride + c);
    qf[kk][2] = ld32(q_s + row0 * kStride + c + 8);
    qf[kk][3] = ld32(q_s + (row0 + 8) * kStride + c + 8);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};

  for (int j0 = 0; j0 < S; j0 += kBlockKV) {
    __syncthreads();                  // previous tile fully consumed
    for (int i = tid; i < kBlockKV * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (j0 + r < S) {
        kv = *reinterpret_cast<const uint4*>(kb + (long long)(j0 + r) * ksl + c);
        vv = *reinterpret_cast<const uint4*>(vb + (long long)(j0 + r) * vsl + c);
      }
      *reinterpret_cast<uint4*>(k_s + r * kStride + c) = kv;
      *reinterpret_cast<uint4*>(v_s + r * kStride + c) = vv;
    }
    if constexpr (Masked) {
      if (tid < kBlockKV)
        mk_s[tid] = j0 + tid < S ? kvm[b * msb + j0 + tid] : 0;
    }
    __syncthreads();

    // ---- S = (q*scale) K^T for this warp's 16 rows x 64 keys ----
    float s[kBlockKV / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockKV / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* krow = k_s + (nt * 8 + g) * kStride + 2 * t4;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_bf16(s[nt], qf[kk], ld32(krow + kk * 16), ld32(krow + kk * 16 + 8));
    }
    if constexpr (Masked) {           // invalid keys (and the tail) -> -1e30
#pragma unroll
      for (int nt = 0; nt < kBlockKV / 8; ++nt) {
        const int col = nt * 8 + 2 * t4;
        if (!mk_s[col]) { s[nt][0] = kNegInf; s[nt][2] = kNegInf; }
        if (!mk_s[col + 1]) { s[nt][1] = kNegInf; s[nt][3] = kNegInf; }
      }
    } else if (j0 + kBlockKV > S) {   // ragged tail: mask keys >= S
#pragma unroll
      for (int nt = 0; nt < kBlockKV / 8; ++nt) {
        const int col = j0 + nt * 8 + 2 * t4;
        if (col >= S) { s[nt][0] = kNegInf; s[nt][2] = kNegInf; }
        if (col + 1 >= S) { s[nt][1] = kNegInf; s[nt][3] = kNegInf; }
      }
    }

    // ---- online softmax (rows g and g+8 of the warp tile) ----
    float m_cur[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kBlockKV / 8; ++nt) {
      m_cur[0] = fmaxf(m_cur[0], fmaxf(s[nt][0], s[nt][1]));
      m_cur[1] = fmaxf(m_cur[1], fmaxf(s[nt][2], s[nt][3]));
    }
    float alpha[2], l_cur[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_cur[h] = fmaxf(m_cur[h], __shfl_xor_sync(0xffffffff, m_cur[h], 1));
      m_cur[h] = fmaxf(m_cur[h], __shfl_xor_sync(0xffffffff, m_cur[h], 2));
      const float m_new = fmaxf(m_run[h], m_cur[h]);
      alpha[h] = expf(m_run[h] - m_new);
      m_run[h] = m_new;
    }
    uint32_t pf[kBlockKV / 16][4];
#pragma unroll
    for (int nt = 0; nt < kBlockKV / 8; ++nt) {
      float p0 = expf(s[nt][0] - m_run[0]);
      float p1 = expf(s[nt][1] - m_run[0]);
      float p2 = expf(s[nt][2] - m_run[1]);
      float p3 = expf(s[nt][3] - m_run[1]);
      if constexpr (Masked) {         // no valid key yet in this row
        if (m_run[0] <= 0.5f * kNegInf) p0 = p1 = 0.f;
        if (m_run[1] <= 0.5f * kNegInf) p2 = p3 = 0.f;
      }
      l_cur[0] += p0 + p1;
      l_cur[1] += p2 + p3;
      // C fragment of n-tile nt -> half of the A fragment of k-step nt/2
      pf[nt / 2][(nt & 1) * 2 + 0] = pack_bf16(p0, p1);
      pf[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l_cur[h] += __shfl_xor_sync(0xffffffff, l_cur[h], 1);
      l_cur[h] += __shfl_xor_sync(0xffffffff, l_cur[h], 2);
      l_run[h] = l_run[h] * alpha[h] + l_cur[h];
    }

    // ---- O = O*alpha + P V ----
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= alpha[0]; acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1]; acc[dt][3] *= alpha[1];
    }
    // lane -> row address: keys kk*16 + (lane & 15), columns of d-tile
    // dt + (lane >> 4); registers {0,1} feed d-tile dt, {2,3} d-tile dt+1
    const __nv_bfloat16* vrow =
        v_s + (lane & 15) * kStride + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < kBlockKV / 16; ++kk) {
#pragma unroll
      for (int dt = 0; dt < D / 8; dt += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vrow + kk * 16 * kStride + dt * 8);
        mma_bf16(acc[dt], pf[kk], vb[0], vb[1]);
        mma_bf16(acc[dt + 1], pf[kk], vb[2], vb[3]);
      }
    }
  }

  // ---- normalise and write bf16 ----
  const float inv0 = 1.f / (l_run[0] == 0.f ? 1.f : l_run[0]);
  const float inv1 = 1.f / (l_run[1] == 0.f ? 1.f : l_run[1]);
  const int r0 = q0 + row0, r1 = r0 + 8;
  __nv_bfloat16* ob = o + b * osb + n * osn;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + 2 * t4;
    if (r0 < L)
      *reinterpret_cast<uint32_t*>(ob + (long long)r0 * osl + c) =
          pack_bf16(acc[dt][0] * inv0, acc[dt][1] * inv0);
    if (r1 < L)
      *reinterpret_cast<uint32_t*>(ob + (long long)r1 * osl + c) =
          pack_bf16(acc[dt][2] * inv1, acc[dt][3] * inv1);
  }
}

template <int D, bool Masked>
int launch(const void* q, const void* k, const void* v, const void* kvm,
           long long msb, void* o, int B, int L, int S, int N,
           const long long* st, float scale, cudaStream_t stream) {
  constexpr int smem =
      (kBlockQ + 2 * kBlockKV) * (D + 8) * 2 + (Masked ? kBlockKV : 0);
  // above 48 KB of dynamic shared memory needs the opt-in (per device)
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, Masked>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid((L + kBlockQ - 1) / kBlockQ, N, B);
  flash_fwd_kernel<D, Masked><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(kvm),
      msb, static_cast<__nv_bfloat16*>(o), L, S,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], scale);
  return cudaGetLastError();
}

}  // namespace

// q: [B, L, N, D], k/v: [B, S, N, D], o: [B, L, N, D]; bf16, unit stride on
// D.  strides: 12 element strides (b, l, n) of q, k, v and o in that order.
extern "C" int wg_flash_attention_bf16(const void* q, const void* k,
                                       const void* v, void* o, int B, int L,
                                       int S, int N, int D,
                                       const long long* strides, float scale,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch<128, false>(q, k, v, nullptr, 0, o, B, L, S, N, strides,
                              scale, s);
  if (D == 64)
    return launch<64, false>(q, k, v, nullptr, 0, o, B, L, S, N, strides,
                             scale, s);
  return cudaErrorInvalidValue;
}

// As above, with kv_mask: [B, S] uint8 (non-zero = valid key), unit stride
// on S and `mask_bstride` elements between batch rows.
extern "C" int wg_flash_attention_kvmask_bf16(
    const void* q, const void* k, const void* v, const void* kv_mask,
    void* o, int B, int L, int S, int N, int D, const long long* strides,
    long long mask_bstride, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch<128, true>(q, k, v, kv_mask, mask_bstride, o, B, L, S, N,
                             strides, scale, s);
  if (D == 64)
    return launch<64, true>(q, k, v, kv_mask, mask_bstride, o, B, L, S, N,
                            strides, scale, s);
  return cudaErrorInvalidValue;
}
