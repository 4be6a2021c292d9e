// Split-K packed int4 weight matmuls for Hopper (sm_90a).
//
// Replaces two Pallas kernels that read the same packed weight:
//   wan2gp_tpu/ops/quant.py::_w4_kernel (launched by matmul_w4):
//     y = (x @ w) * scale, x bf16, fp32 accumulation, bf16 out;
//   wan2gp_tpu/ops/quant.py::_w4a8_kernel (launched by matmul_w4a8):
//     y = (acc * sw) * sx with acc = x_q @ w in int32, x_q the per-row int8
//     activations of quantize_act_int8 and sx their fp32 row scales.
// The weight layout is quantize_int4's: packed int8 [KP/2, N], KP = K
// padded up to a multiple of 1024; packed row r holds original row r in its
// low nibble and row KP/2 + r in its high nibble, both sign-extended
// (lo = (p << 28) >> 28, hi = p >> 4 on the int32 value, as in the Pallas
// kernels).  x keeps its K columns: columns at K and beyond, where the
// weight holds zero padding, are masked to zero in the kernel, so the host
// pads nothing.
//
// What bounds them: at the 14B shapes (M = 151,200 tokens, K and N 5,120 or
// 13,824) the 2*M*K*N operations on the tensor cores bound both (989
// TFLOP/s bf16 for W4, 1,979 TOP/s int8 for W4A8); the weight is read at
// half a byte per element.  At the cross-attention's M = 1,024 the weight
// read matters more, which is what int4 saves.
//
// Design: the w8 kernel's 128x128 output tile per CTA of 8 warps, each warp
// a 32x64 sub-tile.  Each k-stage takes a block of packed rows and unpacks
// both nibbles into shared memory, so one stage covers x columns [p0, p0+P)
// (low) and [KP/2 + p0, KP/2 + p0 + P) (high).
//   W4: P = 32; the weight tile becomes bf16 [k][n] rows and feeds
//     m16n8k16 bf16 mma.sync through ldmatrix.trans, as in w8_matmul.cu.
//   W4A8: P = 64; x stays int8 and the weight tile becomes int8 [n][k]
//     (k contiguous, the col-major B operand) for the s8 tensor-core path,
//     m16n8k32 mma.sync with int32 accumulation; both scales are applied in
//     fp32 before the bf16 store.
// Ragged M, N and K are masked (zero fill on load, guarded stores).  Simple
// first version: no cp.async/TMA pipeline and no wgmma yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 128;
constexpr int kThreads = 256;

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
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

template <typename T>
__device__ __forceinline__ uint32_t ld32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// sign-extended nibbles of a packed byte
__device__ __forceinline__ int lo4(int8_t p) { return ((int)p << 28) >> 28; }
__device__ __forceinline__ int hi4(int8_t p) { return (int)p >> 4; }

// ------------------------------------------------------------------- W4

constexpr int kP4 = 32;               // packed rows per stage
constexpr int kBK4 = 2 * kP4;         // x columns per stage
constexpr int kXStride4 = kBK4 + 8;   // padded [m][k] rows of the x tile
constexpr int kWStride4 = kBN + 8;    // padded [k][n] rows of the w tile

__global__ void __launch_bounds__(kThreads)
w4_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                 const int8_t* __restrict__ w,
                 const float* __restrict__ scale,
                 __nv_bfloat16* __restrict__ y, int M, int N, int K, int KH,
                 int x_vec, int w_vec) {
  __shared__ __align__(16) __nv_bfloat16 x_s[kBM * kXStride4];
  __shared__ __align__(16) __nv_bfloat16 w_s[kBK4 * kWStride4];

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

  for (int p0 = 0; p0 < KH; p0 += kP4) {
    __syncthreads();
    // x tile: 128 rows x (32 low + 32 high columns) = 1024 chunks of 8
    for (int i = tid; i < kBM * (kBK4 / 8); i += kThreads) {
      const int r = i / (kBK4 / 8), c = (i % (kBK4 / 8)) * 8;
      const int gm = m0 + r;
      const int gk = c < kP4 ? p0 + c : KH + p0 + (c - kP4);
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
      *reinterpret_cast<uint4*>(x_s + r * kXStride4 + c) = val;
    }
    // w tile: 32 packed rows x 128 n = 256 chunks of 16 bytes, each
    // unpacked to 16 low values (row r) and 16 high values (row 32 + r)
    for (int i = tid; i < kP4 * (kBN / 16); i += kThreads) {
      const int r = i / (kBN / 16), c = (i % (kBN / 16)) * 16;
      const int gp = p0 + r, gn = n0 + c;
      __align__(16) int8_t e[16];
      if (gp < KH && w_vec && gn + 16 <= N) {
        *reinterpret_cast<int4*>(e) =
            *reinterpret_cast<const int4*>(w + (long long)gp * N + gn);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          e[j] = (gp < KH && gn + j < N) ? w[(long long)gp * N + gn + j] : 0;
      }
      __align__(16) __nv_bfloat16 lo[16], hi[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        lo[j] = __int2bfloat16_rn(lo4(e[j]));
        hi[j] = __int2bfloat16_rn(hi4(e[j]));
      }
      uint4* dlo = reinterpret_cast<uint4*>(w_s + r * kWStride4 + c);
      uint4* dhi = reinterpret_cast<uint4*>(w_s + (kP4 + r) * kWStride4 + c);
      dlo[0] = reinterpret_cast<const uint4*>(lo)[0];
      dlo[1] = reinterpret_cast<const uint4*>(lo)[1];
      dhi[0] = reinterpret_cast<const uint4*>(hi)[0];
      dhi[1] = reinterpret_cast<const uint4*>(hi)[1];
    }
    __syncthreads();

    // lane -> row address of the B fragments: k rows kk*16 + (lane & 15),
    // n columns of n-tile nt + (lane >> 4); registers {0,1} feed n-tile
    // nt, {2,3} n-tile nt+1
    const __nv_bfloat16* wrow =
        w_s + (lane & 15) * kWStride4 + wn * 64 + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < kBK4 / 16; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const __nv_bfloat16* xr =
            x_s + (wm * 32 + mt * 16 + g) * kXStride4 + kk * 16 + 2 * t4;
        af[mt][0] = ld32(xr);
        af[mt][1] = ld32(xr + 8 * kXStride4);
        af[mt][2] = ld32(xr + 8);
        af[mt][3] = ld32(xr + 8 * kXStride4 + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 8; nt += 2) {
        uint32_t wb[4];
        ldmatrix_x4_trans(wb, wrow + kk * 16 * kWStride4 + nt * 8);
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

// ----------------------------------------------------------------- W4A8

constexpr int kP8 = 64;               // packed rows per stage
constexpr int kBK8 = 2 * kP8;         // int8 x columns per stage
constexpr int kStride8 = kBK8 + 16;   // padded rows (bytes) of both tiles

__global__ void __launch_bounds__(kThreads)
w4a8_matmul_kernel(const int8_t* __restrict__ x,
                   const int8_t* __restrict__ w,
                   const float* __restrict__ sw,
                   const float* __restrict__ sx,
                   __nv_bfloat16* __restrict__ y, int M, int N, int K, int KH,
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

  for (int p0 = 0; p0 < KH; p0 += kP8) {
    __syncthreads();
    // x tile: 128 rows x (64 low + 64 high columns) = 1024 chunks of 16
    for (int i = tid; i < kBM * (kBK8 / 16); i += kThreads) {
      const int r = i / (kBK8 / 16), c = (i % (kBK8 / 16)) * 16;
      const int gm = m0 + r;
      const int gk = c < kP8 ? p0 + c : KH + p0 + (c - kP8);
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
    // w tile: a 4 packed rows x 4 columns block per item (4 x 4-byte
    // loads), transposed in registers into 4 low words (k = r..r+3 of
    // column n+j) and 4 high words (k = 64 + r..)
    for (int i = tid; i < (kP8 / 4) * (kBN / 4); i += kThreads) {
      const int r = (i / (kBN / 4)) * 4, c = (i % (kBN / 4)) * 4;
      const int gn = n0 + c;
      uint32_t rowb[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int gp = p0 + r + t;
        if (gp < KH && w_vec && gn + 4 <= N) {
          rowb[t] = ld32(w + (long long)gp * N + gn);
        } else {
          uint32_t u = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (gp < KH && gn + j < N)
              u |= (uint32_t)(uint8_t)w[(long long)gp * N + gn + j] << (8 * j);
          rowb[t] = u;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t lo = 0, hi = 0;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int8_t p = (int8_t)((rowb[t] >> (8 * j)) & 0xff);
          lo |= (uint32_t)(uint8_t)lo4(p) << (8 * t);
          hi |= (uint32_t)(uint8_t)hi4(p) << (8 * t);
        }
        int8_t* dst = w_s + (c + j) * kStride8 + r;
        *reinterpret_cast<uint32_t*>(dst) = lo;
        *reinterpret_cast<uint32_t*>(dst + kP8) = hi;
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
        af[mt][0] = ld32(xr);
        af[mt][1] = ld32(xr + 8 * kStride8);
        af[mt][2] = ld32(xr + 16);
        af[mt][3] = ld32(xr + 8 * kStride8 + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        // B fragment (32x8 col-major): column g, bytes t4*4 (+16)
        const int8_t* wc =
            w_s + (wn * 64 + nt * 8 + g) * kStride8 + kk * 32 + 4 * t4;
        const uint32_t b0 = ld32(wc), b1 = ld32(wc + 16);
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

// x: [M, K] bf16; w_p: [KP/2, N] packed int8 (KP >= K, KP/2 = KH); scale:
// [N] fp32; y: [M, N] bf16.  All contiguous, row-major.
extern "C" int wg_w4_matmul_bf16(const void* x, const void* w_p,
                                 const void* scale, void* y, int M, int N,
                                 int K, int KH, void* stream) {
  if (2 * KH < K || KH % kP4 != 0) return cudaErrorInvalidValue;
  const int x_vec = (K % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const int w_vec =
      (N % 16 == 0) && (reinterpret_cast<uintptr_t>(w_p) % 16 == 0);
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  w4_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w_p),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y), M, N,
      K, KH, x_vec, w_vec);
  return cudaGetLastError();
}

// x_q: [M, K] int8; sx: [M] fp32; w_p, sw: as above; y: [M, N] bf16.
extern "C" int wg_w4a8_matmul(const void* x_q, const void* sx,
                              const void* w_p, const void* sw, void* y, int M,
                              int N, int K, int KH, void* stream) {
  if (2 * KH < K || KH % kP8 != 0) return cudaErrorInvalidValue;
  const int x_vec =
      (K % 16 == 0) && (reinterpret_cast<uintptr_t>(x_q) % 16 == 0);
  const int w_vec = (N % 4 == 0) && (reinterpret_cast<uintptr_t>(w_p) % 4 == 0);
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  w4a8_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x_q), static_cast<const int8_t*>(w_p),
      static_cast<const float*>(sw), static_cast<const float*>(sx),
      static_cast<__nv_bfloat16*>(y), M, N, K, KH, x_vec, w_vec);
  return cudaGetLastError();
}
