// Per-row int8 activation quantization for Hopper (sm_90a), in one pass.
//
// x bf16 [M, K] -> x_q int8 [M, K], sx fp32 [M]: per row,
//   absmax = max |x| (exact on the bf16 values),
//   sx     = max(absmax, 1e-8f) * fp32(1/127),
//   x_q    = clamp(round-half-even(x / sx), -127, 127),
// with IEEE division (__fdiv_rn, rintf; no fast math), so the result is the
// plain version's (ops/quant.py quantize_act_int8_ref) bit for bit, which
// in turn is that of the JAX package's quantize_act_int8 once XLA compiles
// it (wan2gp_tpu/ops/quant.py:222).  That function has no Pallas kernel:
// the JAX package runs it in XLA ahead of the W8A8 and W4A8 pallas_calls.
//
// What bounds it: bytes.  2 bytes read and 1 written an element at 3.35
// TB/s: 1.87 ms for the 14B fc2 input (151,200 x 13,824).
//
// Design: each row is read once from device memory.  A group of G warps
// (G = 1, 2, 4 or 8, the least for which a thread's share of the row is at
// most kMaxChunks 16-byte chunks) owns a row and holds it in registers
// (8 rows a 256-thread CTA at G = 1, one at G = 8): one pass of 16-byte
// loads, the absmax reduced by warp shuffles and, across the group's
// warps, through shared memory, then the divisions and one 8-byte store a
// chunk, and sx from the group's first thread.  Rows whose K is not a
// multiple of 8 (or longer than the registers hold, K > 16,384) take a
// plain two-pass CTA per row instead (scalar loads; the second pass reads
// the row again, mostly from L1 or L2).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunks = 8;          // 16-byte chunks a thread holds
constexpr float kInv127 = 1.0f / 127.0f;

__device__ __forceinline__ int quant1(float v, float s) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
  return static_cast<int>(q);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Rows of K % 8 == 0 (16-byte chunks of 8 bf16), each held by `g` warps, at
// most kChunks chunks a thread.
template <int kChunks>
__global__ void __launch_bounds__(kThreads)
act_quant_kernel(const uint4* __restrict__ x, uint2* __restrict__ xq,
                 float* __restrict__ sx, int M, int K, int g) {
  __shared__ float red[kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * (kThreads / 32 / g) + warp / g;
  const int tid = (warp % g) * 32 + lane;         // within the row's group
  const int step = 32 * g;
  const int chunks = K / 8;
  const bool live = row < M;
  const long long base = static_cast<long long>(row) * chunks;

  uint4 v[kChunks];
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int c = tid + j * step;
    v[j] = make_uint4(0, 0, 0, 0);
    if (live && c < chunks) v[j] = x[base + c];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v[j]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      amax = fmaxf(amax, fmaxf(fabsf(f.x), fabsf(f.y)));
    }
  }
  amax = warp_max(amax);
  if (g > 1) {
    if (lane == 0) red[warp] = amax;
    __syncthreads();
    const int w0 = warp - warp % g;
    for (int i = 0; i < g; ++i) amax = fmaxf(amax, red[w0 + i]);
  }
  const float s = fmaxf(amax, 1e-8f) * kInv127;
  if (!live) return;
  if (tid == 0) sx[row] = s;
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int c = tid + j * step;
    if (c >= chunks) break;
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v[j]);
    uint32_t w[2];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const float2 f0 = __bfloat1622float2(h[2 * p]);
      const float2 f1 = __bfloat1622float2(h[2 * p + 1]);
      w[p] = (quant1(f0.x, s) & 0xFF) | (quant1(f0.y, s) & 0xFF) << 8
             | (quant1(f1.x, s) & 0xFF) << 16
             | static_cast<uint32_t>(quant1(f1.y, s) & 0xFF) << 24;
    }
    xq[base + c] = make_uint2(w[0], w[1]);
  }
}

// Any K: one CTA a row, two passes of scalar loads.
__global__ void __launch_bounds__(kThreads)
act_quant_rows_kernel(const __nv_bfloat16* __restrict__ x,
                      int8_t* __restrict__ xq, float* __restrict__ sx, int K) {
  __shared__ float red[kThreads / 32];
  const long long base = static_cast<long long>(blockIdx.x) * K;
  float amax = 0.f;
  for (int i = threadIdx.x; i < K; i += kThreads)
    amax = fmaxf(amax, fabsf(__bfloat162float(x[base + i])));
  amax = warp_max(amax);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = amax;
  __syncthreads();
  for (int i = 0; i < kThreads / 32; ++i) amax = fmaxf(amax, red[i]);
  const float s = fmaxf(amax, 1e-8f) * kInv127;
  if (threadIdx.x == 0) sx[blockIdx.x] = s;
  for (int i = threadIdx.x; i < K; i += kThreads)
    xq[base + i] =
        static_cast<int8_t>(quant1(__bfloat162float(x[base + i]), s));
}

template <int kChunks>
int launch_chunks(const void* x, void* xq, float* sx, int M, int K, int g,
                  cudaStream_t stream) {
  const int rows = kThreads / 32 / g;
  act_quant_kernel<kChunks><<<(M + rows - 1) / rows, kThreads, 0, stream>>>(
      static_cast<const uint4*>(x), static_cast<uint2*>(xq), sx, M, K, g);
  return cudaGetLastError();
}

}  // namespace

// x: [M, K] bf16, contiguous; x_q: [M, K] int8; sx: [M] fp32.  M, K > 0.
extern "C" int wg_act_quant_int8(const void* x, void* x_q, void* sx, int M,
                                 int K, void* stream) {
  if (M <= 0 || K <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sxf = static_cast<float*>(sx);
  const bool vec = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0
                   && reinterpret_cast<uintptr_t>(x_q) % 8 == 0;
  const int chunks = K / 8;
  for (int g = 1; vec && g <= kThreads / 32; g *= 2) {
    const int per = (chunks + 32 * g - 1) / (32 * g);
    if (per > kMaxChunks) continue;
    switch (per) {
      case 1: return launch_chunks<1>(x, x_q, sxf, M, K, g, s);
      case 2: return launch_chunks<2>(x, x_q, sxf, M, K, g, s);
      case 3: return launch_chunks<3>(x, x_q, sxf, M, K, g, s);
      case 4: return launch_chunks<4>(x, x_q, sxf, M, K, g, s);
      case 5: return launch_chunks<5>(x, x_q, sxf, M, K, g, s);
      case 6: return launch_chunks<6>(x, x_q, sxf, M, K, g, s);
      case 7: return launch_chunks<7>(x, x_q, sxf, M, K, g, s);
      default: return launch_chunks<8>(x, x_q, sxf, M, K, g, s);
    }
  }
  act_quant_rows_kernel<<<M, kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(x_q), sxf,
      K);
  return cudaGetLastError();
}
