// Weight-only products for fp32 activations at small M, for Hopper (sm_90a).
//
// y[m, n] = scale[n] * sum_k x[m, k] * w[k, n], all in fp32, for M <= 16:
// W8 reads an int8 w [K, N]; W4 the packed int4 layout of quantize_int4
// (packed row r holds row r in its low nibble and row KH + r in its high
// one, KH = KP/2 >= K/2; rows past K are zero).  The Flux blocks run their
// modulation linears this way (silu(vec) [B, 3072] against [3072, 18,432]
// or [3072, 9,216]) under quantize "int8" / "int4".  For fp32 x this
// replaces the Pallas kernels wan2gp_tpu/ops/quant.py `_w8_kernel`
// (pallas_call :77) and `_w4_kernel` (:179), which compute in x's dtype: f32
// x times the weight cast to f32, fp32 sums, the scale at the end.  The
// bf16 kernels (w8_matmul.cu, w4_matmul.cu) take bf16 x only.
//
// What bounds it: bytes.  At M = 1 it is a GEMV: 2 operations a weight
// byte, far below the card's 295 operations a byte, so the weight's read
// is the whole cost: 56.6 MB (K 3072, N 18,432, int8) is 17 us at 3.35
// TB/s.
//
// Design: consecutive threads own consecutive 4-column groups of the
// row-major weight, so a warp reads 128 contiguous bytes of a row (int4:
// 4 packed bytes, 8 weights).  A grid over N alone would give 9-18 CTAs of
// 1,024 columns on 132 SMs, so K is split too: each CTA takes up to 256
// rows of one column tile, stages its rows' x values (both halves for W4;
// zeros past M and K) in shared memory, keeps MT x 4 fp32 sums in
// registers and writes them to a [splits, M, N] fp32 buffer.  A second
// kernel adds the splits in order and applies the scale, so a run repeats
// bit for bit (no atomics).  A simple kernel: no TMA, no tensor cores.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;                      // columns a thread
constexpr int kTileN = kThreads * kCols;      // columns a CTA
constexpr int kMaxRows = 256;                 // weight rows a CTA

// Partial sums of split blockIdx.y over weight (W4: packed) rows
// [r0, r0 + R) for the columns of tile blockIdx.x.  MT: M rounded up to a
// power of two; rows of x past M are staged as zeros and not written.
template <int MT, bool kInt4>
__global__ void __launch_bounds__(kThreads)
gemv_partial(const float* __restrict__ x, const int8_t* __restrict__ w,
             float* __restrict__ part, int M, int N, int K, int rows, int R,
             int vec) {
  __shared__ float xs[MT][2 * kMaxRows];
  const int r0 = blockIdx.y * R;
  const int nr = min(R, rows - r0);
  for (int i = threadIdx.x; i < MT * R; i += kThreads) {
    const int m = i / R, j = i % R;
    const int r = r0 + j;
    const bool in = m < M && j < nr;
    xs[m][j] = in && r < K ? x[static_cast<size_t>(m) * K + r] : 0.f;
    if (kInt4)
      xs[m][R + j] = in && rows + r < K
                         ? x[static_cast<size_t>(m) * K + rows + r] : 0.f;
  }
  __syncthreads();
  const int c0 = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  if (c0 >= N) return;
  float acc[MT][kCols];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[m][c] = 0.f;
  const int8_t* wp = w + static_cast<size_t>(r0) * N + c0;
#pragma unroll 4
  for (int j = 0; j < nr; ++j, wp += N) {
    int8_t b[kCols];
    if (vec) {
      const char4 v = *reinterpret_cast<const char4*>(wp);
      b[0] = v.x; b[1] = v.y; b[2] = v.z; b[3] = v.w;
    } else {
#pragma unroll
      for (int c = 0; c < kCols; ++c) b[c] = c0 + c < N ? wp[c] : 0;
    }
    if (kInt4) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        // sign-extended nibbles: low = rows r, high = rows KH + r
        const float lo = static_cast<float>(
            static_cast<int8_t>(static_cast<int8_t>(b[c] << 4) >> 4));
        const float hi = static_cast<float>(static_cast<int8_t>(b[c] >> 4));
#pragma unroll
        for (int m = 0; m < MT; ++m)
          acc[m][c] = fmaf(xs[m][R + j], hi, fmaf(xs[m][j], lo, acc[m][c]));
      }
    } else {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float wv = static_cast<float>(b[c]);
#pragma unroll
        for (int m = 0; m < MT; ++m) acc[m][c] = fmaf(xs[m][j], wv, acc[m][c]);
      }
    }
  }
  float* out = part + static_cast<size_t>(blockIdx.y) * M * N + c0;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= M) break;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (c0 + c < N) out[static_cast<size_t>(m) * N + c] = acc[m][c];
  }
}

// y = scale * (sum of the splits, in split order).
__global__ void __launch_bounds__(kThreads)
gemv_reduce(const float* __restrict__ part, const float* __restrict__ scale,
            float* __restrict__ y, int M, int N, int splits) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const size_t mn = static_cast<size_t>(M) * N;
  if (i >= mn) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[k * mn + i];
  y[i] = s * scale[i % N];
}

template <bool kInt4>
int gemv_launch(const void* x, const void* w, const void* scale, void* y,
                void* part, int M, int N, int K, int rows, int splits,
                cudaStream_t s) {
  if (M < 1 || M > 16 || N < 1 || K < 1 || rows < 1 || splits < 1)
    return cudaErrorInvalidValue;
  if (kInt4 ? K > 2 * rows : K != rows) return cudaErrorInvalidValue;
  const int R = (rows + splits - 1) / splits;
  if (R > kMaxRows || (splits - 1) * R >= rows) return cudaErrorInvalidValue;
  const int vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0;
  const dim3 grid((N + kTileN - 1) / kTileN, splits);
  const float* xf = static_cast<const float*>(x);
  const int8_t* wq = static_cast<const int8_t*>(w);
  float* pf = static_cast<float*>(part);
  if (M == 1)
    gemv_partial<1, kInt4><<<grid, kThreads, 0, s>>>(xf, wq, pf, M, N, K,
                                                    rows, R, vec);
  else if (M == 2)
    gemv_partial<2, kInt4><<<grid, kThreads, 0, s>>>(xf, wq, pf, M, N, K,
                                                    rows, R, vec);
  else if (M <= 4)
    gemv_partial<4, kInt4><<<grid, kThreads, 0, s>>>(xf, wq, pf, M, N, K,
                                                    rows, R, vec);
  else if (M <= 8)
    gemv_partial<8, kInt4><<<grid, kThreads, 0, s>>>(xf, wq, pf, M, N, K,
                                                    rows, R, vec);
  else
    gemv_partial<16, kInt4><<<grid, kThreads, 0, s>>>(xf, wq, pf, M, N, K,
                                                     rows, R, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t mn = static_cast<size_t>(M) * N;
  gemv_reduce<<<static_cast<unsigned>((mn + kThreads - 1) / kThreads),
                kThreads, 0, s>>>(pf, static_cast<const float*>(scale),
                                  static_cast<float*>(y), M, N, splits);
  return cudaGetLastError();
}

}  // namespace

// x: [M, K] fp32; w_q: [K, N] int8; scale: [N] fp32; y: [M, N] fp32; part:
// [splits, M, N] fp32 scratch.  All contiguous, row-major; 1 <= M <= 16;
// ceil(K / splits) <= 256 and every split non-empty (cudaErrorInvalidValue
// else).
extern "C" int wg_w8_gemv_f32(const void* x, const void* w_q,
                              const void* scale, void* y, void* part, int M,
                              int N, int K, int splits, void* stream) {
  return gemv_launch<false>(x, w_q, scale, y, part, M, N, K, K, splits,
                            static_cast<cudaStream_t>(stream));
}

// As wg_w8_gemv_f32 with w_p: [KH, N] packed int4 (K <= 2 KH); the splits
// run over the KH packed rows.
extern "C" int wg_w4_gemv_f32(const void* x, const void* w_p,
                              const void* scale, void* y, void* part, int M,
                              int N, int K, int KH, int splits, void* stream) {
  return gemv_launch<true>(x, w_p, scale, y, part, M, N, K, KH, splits,
                           static_cast<cudaStream_t>(stream));
}
