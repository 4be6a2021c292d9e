// Weight-only products for fp32 activations above 16 rows, for Hopper
// (sm_90a).
//
// y[m, n] = scale[n] * sum_k x[m, k] * w[k, n], all in fp32, for any M: W8
// reads an int8 w [K, N]; W4 the packed int4 layout of quantize_int4
// (packed row r holds row r in its low nibble and row KH + r in its high
// one, KH = KP/2 >= K/2; rows past K are zero).  The LTX-2 DiT runs its
// adaLN tables this way (the per-frame timestep tokens: M = 31 video and 251
// audio rows at 241 frames, K 256 / 4096 / 2048, N up to 9 x 4096) and its
// patchify and proj_out linears (M = the video or audio tokens), and
// HunyuanVideo its final_layer.linear, once a quanto file holds them in
// int8.  For fp32 x at M > 16 this replaces the Pallas kernels
// wan2gp_tpu/ops/quant.py `_w8_kernel` (pallas_call :77) and `_w4_kernel`
// (:179), which compute in x's dtype: f32 x times the weight cast to f32,
// fp32 sums, the scale at the end.  wo_gemv.cu takes M <= 16; the bf16
// kernels (w8_matmul.cu, w4_matmul.cu) take bf16 x only.
//
// What bounds it: fp32 operations (67 TFLOP/s outside the tensor cores, 20
// operations a byte of HBM), from M = 31 on (2 x 31 operations a weight
// byte).  At M = 31 half of each 64-row tile is padding.
//
// Design: a simple SIMT tile.  A CTA of 256 threads owns a 64 x 64 tile of
// y; it walks K in steps of 32 (W4: 32 packed rows, so 64 values of K),
// stages the x tile transposed (one padding column, so the transposing
// stores do not share banks) and the dequantized weight tile as fp32 in
// shared memory, and each thread keeps a 4 x 4 block of fp32 sums in
// registers.  Ragged M, N and K are masked (zeros staged).  Only the order
// of the sums differs from the plain version; a run repeats bit for bit.
// TF32 wgmma, or x split into two bf16 halves through the bf16 CTA, would
// be faster.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;          // rows of y a CTA
constexpr int kBN = 64;          // columns of y a CTA
constexpr int kBK = 32;          // weight (W4: packed) rows a step
constexpr int kTM = 4;           // rows a thread
constexpr int kTN = 4;           // columns a thread

template <bool kInt4>
__global__ void __launch_bounds__(kThreads)
f32_matmul(const float* __restrict__ x, const int8_t* __restrict__ w,
           const float* __restrict__ scale, float* __restrict__ y, int M,
           int N, int K, int rows) {
  constexpr int kHalves = kInt4 ? 2 : 1;
  __shared__ float xs[kHalves][kBK][kBM + 1];
  __shared__ float ws[kHalves][kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);
  const int ty = tid / (kBN / kTN);
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  // W4: packed rows at or past K hold zeros in both nibbles (K <= 2 KH),
  // so the walk stops at min(KH, K)
  const int r_end = kInt4 ? min(rows, K) : rows;
  for (int r0 = 0; r0 < r_end; r0 += kBK) {
    // x: consecutive threads read consecutive columns of one row
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int m = i / kBK, k = i % kBK;
      const int gm = m0 + m, r = r0 + k;
      const float* xr = x + static_cast<size_t>(gm) * K;
      xs[0][k][m] = gm < M && r < rows && r < K ? xr[r] : 0.f;
      if (kInt4)
        xs[kHalves - 1][k][m] =
            gm < M && r < rows && rows + r < K ? xr[rows + r] : 0.f;
    }
    // w: consecutive threads read consecutive bytes of one row
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int k = i / kBN, n = i % kBN;
      const int r = r0 + k, gn = n0 + n;
      const int8_t b = r < rows && gn < N ? w[static_cast<size_t>(r) * N + gn]
                                          : static_cast<int8_t>(0);
      if (kInt4) {
        // sign-extended nibbles: low = row r, high = row KH + r
        ws[0][k][n] = static_cast<float>(
            static_cast<int8_t>(static_cast<int8_t>(b << 4) >> 4));
        ws[kHalves - 1][k][n] = static_cast<float>(
            static_cast<int8_t>(b >> 4));
      } else {
        ws[0][k][n] = static_cast<float>(b);
      }
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
#pragma unroll 8
      for (int k = 0; k < kBK; ++k) {
        float a[kTM], bw[kTN];
#pragma unroll
        for (int i = 0; i < kTM; ++i) a[i] = xs[h][k][ty * kTM + i];
#pragma unroll
        for (int j = 0; j < kTN; ++j) bw[j] = ws[h][k][tx * kTN + j];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], bw[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = m0 + ty * kTM + i;
    if (gm >= M) break;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = n0 + tx * kTN + j;
      if (gn < N) y[static_cast<size_t>(gm) * N + gn] = acc[i][j] * scale[gn];
    }
  }
}

template <bool kInt4>
int f32_launch(const void* x, const void* w, const void* scale, void* y,
               int M, int N, int K, int rows, cudaStream_t s) {
  if (M < 1 || N < 1 || K < 1 || rows < 1) return cudaErrorInvalidValue;
  if (kInt4 ? K > 2 * rows : K != rows) return cudaErrorInvalidValue;
  const unsigned gy = (static_cast<unsigned>(M) + kBM - 1) / kBM;
  if (gy > 65535u) return cudaErrorInvalidValue;
  const dim3 grid((N + kBN - 1) / kBN, gy);
  f32_matmul<kInt4><<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<float*>(y), M, N, K,
      rows);
  return cudaGetLastError();
}

}  // namespace

// x: [M, K] fp32; w_q: [K, N] int8; scale: [N] fp32; y: [M, N] fp32.  All
// contiguous, row-major; ceil(M / 64) <= 65535 (cudaErrorInvalidValue
// else).
extern "C" int wg_w8_matmul_f32(const void* x, const void* w_q,
                                const void* scale, void* y, int M, int N,
                                int K, void* stream) {
  return f32_launch<false>(x, w_q, scale, y, M, N, K, K,
                           static_cast<cudaStream_t>(stream));
}

// As wg_w8_matmul_f32 with w_p: [KH, N] packed int4 (K <= 2 KH).
extern "C" int wg_w4_matmul_f32(const void* x, const void* w_p,
                                const void* scale, void* y, int M, int N,
                                int K, int KH, void* stream) {
  return f32_launch<true>(x, w_p, scale, y, M, N, K, KH,
                          static_cast<cudaStream_t>(stream));
}
