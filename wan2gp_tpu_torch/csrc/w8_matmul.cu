// int8-weight matmuls for Hopper (sm_90a).
//
// W8: y = (x @ dequant(w_q)) * scale.  Replaces the Pallas kernel
// wan2gp_tpu/ops/quant.py::_w8_kernel (launched by matmul_w8).  Same
// numerics: x is bf16, the int8 weight is converted
// to bf16 (exact for |w| <= 127) after it reaches shared memory, the
// product accumulates in fp32, the per-output-column fp32 scale is applied
// at writeback and the result is stored as bf16.
//
// What bounds it: at the Wan DiT token counts (M = B*L in the tens of
// thousands, K and N in the thousands) the 2*M*K*N operations on the bf16
// tensor cores bound it; the weight is read once at 1 byte per element,
// half of what a bf16 weight would cost, which matters when M is small.
//
// Design: one CTA of 8 warps per 128x128 output tile, k-loop in steps of
// 64.  Each step stages the x tile (bf16) and the int8 weight tile in
// shared memory; the weight is dequantized to bf16 on the way in and
// stored row-major ([k][n], 16-byte stores), and its mma.sync B fragments
// are read with ldmatrix.trans.  Each warp computes a 32x64 sub-tile with
// m16n8k16 bf16 mma.sync into fp32 registers.  Rows are padded by 8
// elements in shared memory so the fragment loads are free of bank
// conflicts.  Ragged M, N and K are masked inside the kernel (zero fill
// on load, guarded stores); 16-byte vector loads are used where the row
// alignment allows them.  Simple first version: no cp.async/TMA pipeline
// and no wgmma yet.
//
// W8A8: y = (acc * sw) * sx with acc = x_q @ w_q in int32.  Replaces the
// Pallas kernel wan2gp_tpu/ops/quant.py::_w8a8_kernel (launched by
// matmul_w8a8): x_q are the per-row int8 activations of quantize_act_int8
// and sx their fp32 row scales, sw the per-column weight scales; both are
// applied in fp32, in that order, before the bf16 store.  Bound at the DiT
// shapes by the 2*M*K*N operations on the int8 tensor cores (1,979 TOP/s).
// Design: w4_matmul.cu's W4A8 kernel without the nibble unpack.  The same
// 128x128 output tile per CTA of 8 warps (each a 32x64 sub-tile), k-stages
// of 128; x stays int8 [m][k] and the weight tile is transposed in
// registers (4 k-rows x 4 columns per thread item) into int8 [n][k], the
// k-contiguous B operand of m16n8k32 s8 mma.sync with int32 accumulation.
// The int32 product is exact; only the fp32 scaling and the bf16 rounding
// of the output remain.  Ragged M, N and K are masked (zero fill on load,
// guarded stores).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kThreads = 256;
constexpr int kXStride = kBK + 8;    // padded [m][k] rows of the x tile
constexpr int kWStride = kBN + 8;    // padded [k][n] rows of the w tile

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

__global__ void __launch_bounds__(kThreads)
w8_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                 const int8_t* __restrict__ w,
                 const float* __restrict__ scale,
                 __nv_bfloat16* __restrict__ y, int M, int N, int K,
                 int x_vec, int w_vec) {
  __shared__ __align__(16) __nv_bfloat16 x_s[kBM * kXStride];
  __shared__ __align__(16) __nv_bfloat16 w_s[kBK * kWStride];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 1;          // 0..3: 32-row slab
  const int wn = warp & 1;           // 0..1: 64-col slab
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();
    // x tile: 128 rows x 64 k = 1024 chunks of 8 bf16
    for (int i = tid; i < kBM * (kBK / 8); i += kThreads) {
      const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
      const int gm = m0 + r, gk = k0 + c;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (gm < M) {
        const __nv_bfloat16* src = x + (long long)gm * K + gk;
        if (x_vec && gk + 8 <= K) {
          val = *reinterpret_cast<const uint4*>(src);
        } else {
          __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
          for (int j = 0; j < 8; ++j)
            if (gk + j < K) e[j] = src[j];
        }
      }
      *reinterpret_cast<uint4*>(x_s + r * kXStride + c) = val;
    }
    // w tile: 64 k-rows x 128 n = 512 chunks of 16 int8 -> 16 bf16
    for (int i = tid; i < kBK * (kBN / 16); i += kThreads) {
      const int r = i / (kBN / 16), c = (i % (kBN / 16)) * 16;
      const int gk = k0 + r, gn = n0 + c;
      __align__(16) int8_t e[16];
      if (gk < K && w_vec && gn + 16 <= N) {
        *reinterpret_cast<int4*>(e) =
            *reinterpret_cast<const int4*>(w + (long long)gk * N + gn);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          e[j] = (gk < K && gn + j < N) ? w[(long long)gk * N + gn + j] : 0;
      }
      __align__(16) __nv_bfloat16 d[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) d[j] = __int2bfloat16_rn((int)e[j]);
      uint4* dst = reinterpret_cast<uint4*>(w_s + r * kWStride + c);
      dst[0] = reinterpret_cast<const uint4*>(d)[0];
      dst[1] = reinterpret_cast<const uint4*>(d)[1];
    }
    __syncthreads();

    // lane -> row address of the B fragments: k rows kk*16 + (lane & 15),
    // n columns of n-tile nt + (lane >> 4); registers {0,1} feed n-tile
    // nt, {2,3} n-tile nt+1
    const __nv_bfloat16* wrow =
        w_s + (lane & 15) * kWStride + wn * 64 + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const __nv_bfloat16* xr =
            x_s + (wm * 32 + mt * 16 + g) * kXStride + kk * 16 + 2 * t4;
        af[mt][0] = ld32(xr);
        af[mt][1] = ld32(xr + 8 * kXStride);
        af[mt][2] = ld32(xr + 8);
        af[mt][3] = ld32(xr + 8 * kXStride + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 8; nt += 2) {
        uint32_t wb[4];
        ldmatrix_x4_trans(wb, wrow + kk * 16 * kWStride + nt * 8);
        mma_bf16(acc[0][nt], af[0], wb[0], wb[1]);
        mma_bf16(acc[1][nt], af[1], wb[0], wb[1]);
        mma_bf16(acc[0][nt + 1], af[0], wb[2], wb[3]);
        mma_bf16(acc[1][nt + 1], af[1], wb[2], wb[3]);
      }
    }
  }

  // epilogue: per-column scale, bf16 store, guarded on M and N
  const bool pairs = (N % 2) == 0;   // two columns in one 4-byte store
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = n0 + wn * 64 + nt * 8 + 2 * t4;
    const float s0 = col < N ? scale[col] : 0.f;
    const float s1 = col + 1 < N ? scale[col + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int row = m0 + wm * 32 + mt * 16 + g;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 8 * h;
        if (r >= M || col >= N) continue;
        __nv_bfloat16* dst = y + (long long)r * N + col;
        const float v0 = acc[mt][nt][2 * h] * s0;
        const float v1 = acc[mt][nt][2 * h + 1] * s1;
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
        } else {
          dst[0] = __float2bfloat16(v0);
          if (col + 1 < N) dst[1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

// ----------------------------------------------------------------- W8A8

constexpr int kBK8 = 128;             // int8 k per stage
constexpr int kStride8 = kBK8 + 16;   // padded rows (bytes) of both tiles

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32s8(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(kThreads)
w8a8_matmul_kernel(const int8_t* __restrict__ x,
                   const int8_t* __restrict__ w,
                   const float* __restrict__ sw,
                   const float* __restrict__ sx,
                   __nv_bfloat16* __restrict__ y, int M, int N, int K,
                   int x_vec, int w_vec) {
  // x_s [m][k] and w_s [n][k], k contiguous in both
  __shared__ __align__(16) int8_t x_s[kBM * kStride8];
  __shared__ __align__(16) int8_t w_s[kBN * kStride8];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 1;          // 0..3: 32-row slab
  const int wn = warp & 1;           // 0..1: 64-col slab
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  int acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK8) {
    __syncthreads();
    // x tile: 128 rows x 128 k = 1024 chunks of 16 bytes
    for (int i = tid; i < kBM * (kBK8 / 16); i += kThreads) {
      const int r = i / (kBK8 / 16), c = (i % (kBK8 / 16)) * 16;
      const int gm = m0 + r, gk = k0 + c;
      __align__(16) int8_t e[16];
      if (gm < M && x_vec && gk + 16 <= K) {
        *reinterpret_cast<int4*>(e) =
            *reinterpret_cast<const int4*>(x + (long long)gm * K + gk);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          e[j] = (gm < M && gk + j < K) ? x[(long long)gm * K + gk + j] : 0;
      }
      *reinterpret_cast<int4*>(x_s + r * kStride8 + c) =
          *reinterpret_cast<const int4*>(e);
    }
    // w tile: a 4 k-rows x 4 columns block per item (4 x 4-byte loads),
    // transposed in registers into 4 words (k = r..r+3 of column n+j)
    for (int i = tid; i < (kBK8 / 4) * (kBN / 4); i += kThreads) {
      const int r = (i / (kBN / 4)) * 4, c = (i % (kBN / 4)) * 4;
      const int gn = n0 + c;
      uint32_t rowb[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int gk = k0 + r + t;
        if (gk < K && w_vec && gn + 4 <= N) {
          rowb[t] = ld32s8(w + (long long)gk * N + gn);
        } else {
          uint32_t u = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (gk < K && gn + j < N)
              u |= (uint32_t)(uint8_t)w[(long long)gk * N + gn + j] << (8 * j);
          rowb[t] = u;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t col = 0;
#pragma unroll
        for (int t = 0; t < 4; ++t)
          col |= ((rowb[t] >> (8 * j)) & 0xffu) << (8 * t);
        *reinterpret_cast<uint32_t*>(w_s + (c + j) * kStride8 + r) = col;
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK8 / 32; ++kk) {
      // A fragment (16x32 row-major): rows g / g+8, bytes t4*4 (+16)
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int8_t* xr =
            x_s + (wm * 32 + mt * 16 + g) * kStride8 + kk * 32 + 4 * t4;
        af[mt][0] = ld32s8(xr);
        af[mt][1] = ld32s8(xr + 8 * kStride8);
        af[mt][2] = ld32s8(xr + 16);
        af[mt][3] = ld32s8(xr + 8 * kStride8 + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        // B fragment (32x8 col-major): column g, bytes t4*4 (+16)
        const int8_t* wc =
            w_s + (wn * 64 + nt * 8 + g) * kStride8 + kk * 32 + 4 * t4;
        const uint32_t b0 = ld32s8(wc), b1 = ld32s8(wc + 16);
        mma_s8(acc[0][nt], af[0], b0, b1);
        mma_s8(acc[1][nt], af[1], b0, b1);
      }
    }
  }

  // epilogue: (acc * sw[n]) * sx[m] in fp32, bf16 store, guarded
  const bool pairs = (N % 2) == 0;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = n0 + wn * 64 + nt * 8 + 2 * t4;
    const float s0 = col < N ? sw[col] : 0.f;
    const float s1 = col + 1 < N ? sw[col + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int row = m0 + wm * 32 + mt * 16 + g;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 8 * h;
        if (r >= M || col >= N) continue;
        const float rs = sx[r];
        __nv_bfloat16* dst = y + (long long)r * N + col;
        const float v0 = (float)acc[mt][nt][2 * h] * s0 * rs;
        const float v1 = (float)acc[mt][nt][2 * h + 1] * s1 * rs;
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
        } else {
          dst[0] = __float2bfloat16(v0);
          if (col + 1 < N) dst[1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

}  // namespace

// x: [M, K] bf16 row-major; w_q: [K, N] int8 row-major; scale: [N] fp32;
// y: [M, N] bf16 row-major.  All contiguous.
extern "C" int wg_w8_matmul_bf16(const void* x, const void* w_q,
                                 const void* scale, void* y, int M, int N,
                                 int K, void* stream) {
  const int x_vec = (K % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const int w_vec =
      (N % 16 == 0) && (reinterpret_cast<uintptr_t>(w_q) % 16 == 0);
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  w8_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w_q),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y), M, N,
      K, x_vec, w_vec);
  return cudaGetLastError();
}

// x_q: [M, K] int8; sx: [M] fp32; w_q: [K, N] int8; sw: [N] fp32; y: [M, N]
// bf16.  All contiguous, row-major.
extern "C" int wg_w8a8_matmul(const void* x_q, const void* sx, const void* w_q,
                              const void* sw, void* y, int M, int N, int K,
                              void* stream) {
  const int x_vec =
      (K % 16 == 0) && (reinterpret_cast<uintptr_t>(x_q) % 16 == 0);
  const int w_vec = (N % 4 == 0) && (reinterpret_cast<uintptr_t>(w_q) % 4 == 0);
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  w8a8_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x_q), static_cast<const int8_t*>(w_q),
      static_cast<const float*>(sw), static_cast<const float*>(sx),
      static_cast<__nv_bfloat16*>(y), M, N, K, x_vec, w_vec);
  return cudaGetLastError();
}
