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
// Same numerics as the dense kernel of flash_attention.cu and as the Pallas
// kernels: q is scaled in bf16 before QK^T, scores and the online-softmax
// state stay fp32, P is rounded to bf16 before P.V, keys at column >= S are
// masked, and a zero denominator becomes 1 (a q block whose count is 0
// outputs zeros).
//
// What bounds it: the work is 4*D operations per (query, attended key) on
// the bf16 tensor cores; at the 14B 720p shapes (L = S = 75,600, D = 128,
// a third to a half of the kv blocks attended) that is tens of TFLOP per
// call against a few hundred MB of q/k/v/o, so the bound is the tensor-core
// rate.  The table itself is a few hundred KB read through the cache.
//
// Design: the dense kernel's CTA (4 warps, 64 query rows, Q fragments in
// registers, 64-key K/V tiles in shared memory, m16n8k16 mma.sync, V read
// with ldmatrix.trans), with the kv loop driven by the table: for entry
// e < counts[g, qb] of the CTA's route block qb = q0 / block_q it walks the
// 64-key tiles of kv block kv_idx[g, qb, e] (block_kv must be a multiple of
// 64, block_q a multiple of 64).  The table's head stride is 0 for the
// shared-table form.  Ragged L and S are masked in the kernel, so the host
// pads nothing.  No TMA, wgmma or double buffering yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kTileKV = 64;
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

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;                 // [B, N, L] fp32, or null
  const int* kv_idx;          // [G or 1, nQb, W]
  const int* counts;          // [G or 1, nQb]
  int L, S, N, nqb, w, block_q, block_kv;
  long long tbl_g;            // head stride of the table: nQb*W, or 0
  long long cnt_g;            // head stride of counts: nQb, or 0
  long long qs[3], ks[3], vs[3], os[3];   // (b, l, n) element strides
  float scale;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
sparse_flash_kernel(const Args a) {
  constexpr int kStride = D + 8;      // padded row of Q_s / K_s / V_s
  constexpr int kChunks = D / 8;      // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + kBlockQ * kStride;
  __nv_bfloat16* v_s = k_s + kTileKV * kStride;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;            // mma group id (row)
  const int t4 = lane & 3;            // thread in group (column pair)
  const int q0 = blockIdx.x * kBlockQ;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int L = a.L, S = a.S;

  const __nv_bfloat16* qb = a.q + b * a.qs[0] + n * a.qs[2];
  const __nv_bfloat16* kb = a.k + b * a.ks[0] + n * a.ks[2];
  const __nv_bfloat16* vb = a.v + b * a.vs[0] + n * a.vs[2];

  // this CTA's row of the table
  const long long gi = (long long)b * a.N + n;
  const int rb = q0 / a.block_q;
  const int count = a.counts[gi * a.cnt_g + rb];
  const int* idx = a.kv_idx + gi * a.tbl_g + (long long)rb * a.w;

  // ---- Q tile -> shared, scaled in bf16 (JAX: q * scale in q.dtype) ----
  for (int i = tid; i < kBlockQ * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < L) {
      val = *reinterpret_cast<const uint4*>(qb + (long long)(q0 + r) * a.qs[1] + c);
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = __float2bfloat16(__bfloat162float(e[j]) * a.scale);
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

  for (int e = 0; e < count; ++e) {
    const int kv0 = idx[e] * a.block_kv;
    const int kv_end = min(kv0 + a.block_kv, S);
    for (int j0 = kv0; j0 < kv_end; j0 += kTileKV) {
      __syncthreads();                // previous tile fully consumed
      for (int i = tid; i < kTileKV * kChunks; i += kThreads) {
        const int r = i / kChunks, c = (i % kChunks) * 8;
        uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
        if (j0 + r < kv_end) {
          kv = *reinterpret_cast<const uint4*>(kb + (long long)(j0 + r) * a.ks[1] + c);
          vv = *reinterpret_cast<const uint4*>(vb + (long long)(j0 + r) * a.vs[1] + c);
        }
        *reinterpret_cast<uint4*>(k_s + r * kStride + c) = kv;
        *reinterpret_cast<uint4*>(v_s + r * kStride + c) = vv;
      }
      __syncthreads();

      // ---- S = (q*scale) K^T for this warp's 16 rows x 64 keys ----
      float s[kTileKV / 8][4];
#pragma unroll
      for (int nt = 0; nt < kTileKV / 8; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        const __nv_bfloat16* krow = k_s + (nt * 8 + g) * kStride + 2 * t4;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          mma_bf16(s[nt], qf[kk], ld32(krow + kk * 16), ld32(krow + kk * 16 + 8));
      }
      if (j0 + kTileKV > kv_end) {    // ragged tail: mask keys >= S
#pragma unroll
        for (int nt = 0; nt < kTileKV / 8; ++nt) {
          const int col = j0 + nt * 8 + 2 * t4;
          if (col >= kv_end) { s[nt][0] = kNegInf; s[nt][2] = kNegInf; }
          if (col + 1 >= kv_end) { s[nt][1] = kNegInf; s[nt][3] = kNegInf; }
        }
      }

      // ---- online softmax (rows g and g+8 of the warp tile) ----
      float m_cur[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < kTileKV / 8; ++nt) {
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
      uint32_t pf[kTileKV / 16][4];
#pragma unroll
      for (int nt = 0; nt < kTileKV / 8; ++nt) {
        const float p0 = expf(s[nt][0] - m_run[0]);
        const float p1 = expf(s[nt][1] - m_run[0]);
        const float p2 = expf(s[nt][2] - m_run[1]);
        const float p3 = expf(s[nt][3] - m_run[1]);
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
      for (int kk = 0; kk < kTileKV / 16; ++kk) {
#pragma unroll
        for (int dt = 0; dt < D / 8; dt += 2) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, vrow + kk * 16 * kStride + dt * 8);
          mma_bf16(acc[dt], pf[kk], vf[0], vf[1]);
          mma_bf16(acc[dt + 1], pf[kk], vf[2], vf[3]);
        }
      }
    }
  }

  // ---- normalise and write bf16 (and the logsumexp) ----
  const float inv0 = 1.f / (l_run[0] == 0.f ? 1.f : l_run[0]);
  const float inv1 = 1.f / (l_run[1] == 0.f ? 1.f : l_run[1]);
  const int r0 = q0 + row0, r1 = r0 + 8;
  __nv_bfloat16* ob = a.o + b * a.os[0] + n * a.os[2];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + 2 * t4;
    if (r0 < L)
      *reinterpret_cast<uint32_t*>(ob + (long long)r0 * a.os[1] + c) =
          pack_bf16(acc[dt][0] * inv0, acc[dt][1] * inv0);
    if (r1 < L)
      *reinterpret_cast<uint32_t*>(ob + (long long)r1 * a.os[1] + c) =
          pack_bf16(acc[dt][2] * inv1, acc[dt][3] * inv1);
  }
  if (a.lse != nullptr && t4 == 0) {
    float* lb = a.lse + gi * L;
    if (r0 < L)
      lb[r0] = l_run[0] > 0.f ? m_run[0] + logf(l_run[0]) : kNegInf;
    if (r1 < L)
      lb[r1] = l_run[1] > 0.f ? m_run[1] + logf(l_run[1]) : kNegInf;
  }
}

template <int D>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int smem = (kBlockQ + 2 * kTileKV) * (D + 8) * 2;
  // above 48 KB of dynamic shared memory needs the opt-in (per device)
  cudaError_t err = cudaFuncSetAttribute(
      sparse_flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.L + kBlockQ - 1) / kBlockQ, a.N, B);
  sparse_flash_kernel<D><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

int run(const void* q, const void* k, const void* v, void* o, void* lse,
        const void* kv_idx, const void* counts, int B, int L, int S, int N,
        int D, int nqb, int w, int block_q, int block_kv, int per_head,
        const long long* st, float scale, void* stream) {
  if (block_q % kBlockQ != 0 || block_kv % kTileKV != 0 ||
      (long long)nqb * block_q < L)
    return cudaErrorInvalidValue;
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.lse = static_cast<float*>(lse);
  a.kv_idx = static_cast<const int*>(kv_idx);
  a.counts = static_cast<const int*>(counts);
  a.L = L; a.S = S; a.N = N; a.nqb = nqb; a.w = w;
  a.block_q = block_q; a.block_kv = block_kv;
  a.tbl_g = per_head ? (long long)nqb * w : 0;
  a.cnt_g = per_head ? nqb : 0;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = st[i]; a.ks[i] = st[3 + i]; a.vs[i] = st[6 + i];
    a.os[i] = st[9 + i];
  }
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128) return launch<128>(a, B, s);
  if (D == 64) return launch<64>(a, B, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q: [B, L, N, D], k/v: [B, S, N, D], o: [B, L, N, D]; bf16, unit stride on
// D.  strides: 12 element strides (b, l, n) of q, k, v and o in that order.
// kv_idx [nQb, maxA] and counts [nQb], int32, shared by every head.
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
