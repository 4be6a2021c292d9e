// Weight-only products for fp32 activations at small M, for Hopper (sm_90a).
//
// y[m, n] = scale[n] * sum_k x[m, k] * w[k, n], all in fp32, for M <= 16:
// W8 reads an int8 w [K, N]; W4 the packed int4 layout of quantize_int4
// (packed row r holds row r in its low nibble and row KH + r in its high
// one, KH = KP/2 >= K/2; rows past K are zero).  The Flux blocks run their
// modulation linears this way (silu(vec) [B, 3072] against [3072, 18,432]
// or [3072, 9,216]) under quantize "int8" / "int4", HunyuanVideo 1.5 its
// modulations at CFG batch 2 and LTX-2 its prompt adaLN tables.  For fp32
// x this replaces the Pallas kernels wan2gp_tpu/ops/quant.py `_w8_kernel`
// (pallas_call :77) and `_w4_kernel` (:179), which compute in x's dtype:
// f32 x times the weight cast to f32, fp32 sums, the scale at the end.
// wo_f32_matmul.cu takes more rows; the bf16 kernels (w8_matmul.cu,
// w4_matmul.cu) take bf16 x only.
//
// What bounds it: bytes.  At M = 1 it is a GEMV: 2 operations a weight
// byte, far below the card's 295 operations a byte, so the weight's read
// is the whole cost: 56.6 MB (K 3072, N 18,432, int8) is 17 us at 3.35
// TB/s, which needs some 25-30 KB in flight on every SM.
//
// Design: one launch.  A thread owns CP consecutive columns (CP = 16, 8 or
// 4 bytes of a weight row, one vector load), a warp 32 * CP columns of a
// row, and the 8 warps of a CTA take every eighth row of its share of K,
// 64 bytes of weight a thread a turn, the next turn's loads issued before
// this turn's sums (up to 128 bytes in flight a thread, 32 KB a CTA).  The
// CTAs of a thread-block cluster (up to 8) split K: each stages its rows' x
// values (both halves for W4; zeros past M and K) in shared memory, sums
// its rows in fp32 (the int8 or int4 values made exact floats by placing
// them in a float's mantissa), adds its 8 warps' sums in warp order, and
// leaves its [M, 32 * CP] partial sums in its shared memory.  After a
// cluster barrier each CTA reads its share of the columns from every rank's
// shared memory (distributed shared memory) in rank order, applies the
// scale and writes y.  So there is no second kernel and no scratch tensor,
// and the order of every sum is fixed: a run repeats bit for bit.  The
// host plan (quant.gemv_plan) picks CP and the cluster size from M, K and N
// so that the grid has two CTAs an SM where N allows it.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
constexpr int kLoadBytes = 64;           // weight bytes a thread loads a turn
constexpr int kStageFloats = 8192;       // staged x values (32 KB) a pass

template <int CP> struct Vec;
template <> struct Vec<16> { using T = uint4; };
template <> struct Vec<8> { using T = uint2; };
template <> struct Vec<4> { using T = uint32_t; };

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ uint32_t word(const uint2& v, int i) {
  return i == 0 ? v.x : v.y;
}
__device__ __forceinline__ uint32_t word(uint32_t v, int) { return v; }

// byte i of u as the float 2^23 + u_i (u_i in the mantissa)
__device__ __forceinline__ float mant_byte(uint32_t u, int i) {
  return __uint_as_float(__byte_perm(u, 0x4B00u, 0x5440u | i));
}

// CP bytes of a weight row at w + c (c < N), zeros past N
template <int CP>
__device__ __forceinline__ typename Vec<CP>::T load_w(const int8_t* w, int c,
                                                      int N, bool vec) {
  using T = typename Vec<CP>::T;
  if (vec) return __ldg(reinterpret_cast<const T*>(w + c));
  uint32_t b[CP / 4] = {};
#pragma unroll
  for (int i = 0; i < CP; ++i)
    if (c + i < N)
      b[i / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(w[c + i]))
                  << (8 * (i % 4));
  T t;
  memcpy(&t, b, sizeof(T));
  return t;
}

// Rows j0, j0 + 8, ... (kU of them, those below np) of the pass at weight
// row p0, this thread's CP columns; zeros for the rest
template <int CP, int kU>
__device__ __forceinline__ void load_rows(typename Vec<CP>::T* v,
                                          const int8_t* w, int p0, int j0,
                                          int np, int N, int c0, bool vec) {
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int jj = j0 + kWarps * u;
    if (jj < np)
      v[u] = load_w<CP>(w + static_cast<size_t>(p0 + jj) * N, c0, N, vec);
    else
      v[u] = typename Vec<CP>::T{};
  }
}

// Partial sums of the rows [r0, r1) (W4: packed rows) of this CTA's rank
// for the CP columns of this thread.  MT: M rounded up to a power of two;
// rows of x past M are staged as zeros and not written.  rows: the
// weight's rows (W4: KH, the column of x's high half); walk: the rows that
// hold weights (W4: min(KH, K)).
template <int MT, int CP, bool kInt4>
__global__ void __launch_bounds__(kThreads, 2)
gemv_cluster(const float* __restrict__ x, const int8_t* __restrict__ w,
             const float* __restrict__ scale, float* __restrict__ y, int M,
             int N, int K, int rows, int walk) {
  constexpr int kTN = 32 * CP;                // columns a CTA
  constexpr int kHalves = kInt4 ? 2 : 1;
  constexpr int kPass = kStageFloats / (MT * kHalves);   // rows a pass
  constexpr int kU = kLoadBytes / CP;         // rows in flight a thread
  using T = typename Vec<CP>::T;
  extern __shared__ float smem[];             // x stage, then warp sums
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / C;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int c0 = tile * kTN + lane * CP;
  const bool vec = N % CP == 0
                   && reinterpret_cast<uintptr_t>(w) % CP == 0;
  const int R = (walk + C - 1) / C;
  const int r0 = rank * R;
  const int r1 = min(walk, r0 + R);

  float acc[MT][CP];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < CP; ++c) acc[m][c] = 0.f;

  for (int p0 = r0; p0 < r1; p0 += kPass) {
    const int np = min(kPass, r1 - p0);
    __syncthreads();                          // the last pass is read
    // xs[(j * kHalves + h) * MT + m]: row p0 + j, half h
    for (int i = threadIdx.x; i < np * kHalves * MT; i += kThreads) {
      const int m = i % MT, h = (i / MT) % kHalves, j = i / (MT * kHalves);
      const int col = (h ? rows : 0) + p0 + j;
      smem[i] = m < M && col < K ? x[static_cast<size_t>(m) * K + col] : 0.f;
    }
    __syncthreads();
    if (c0 >= N) continue;
    // kU rows a warp in flight, the next kU loaded while these are summed
    T v[kU];
    load_rows<CP, kU>(v, w, p0, warp, np, N, c0, vec);
    for (int j = warp; j < np; j += kWarps * kU) {
      T nv[kU];
      load_rows<CP, kU>(nv, w, p0, j + kWarps * kU, np, N, c0, vec);
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int jj = j + kWarps * u;
        if (jj >= np) break;
        const float* xj = smem + jj * kHalves * MT;
#pragma unroll
        for (int q = 0; q < CP / 4; ++q) {
          if constexpr (kInt4) {
            // nibbles v + 8 in [1, 15]: 2^23 + v + 8 in a float
            const uint32_t t = word(v[u], q) ^ 0x88888888u;
            const uint32_t lo = t & 0x0F0F0F0Fu, hi = (t >> 4) & 0x0F0F0F0Fu;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float wl = mant_byte(lo, i) - 8388616.f;
              const float wh = mant_byte(hi, i) - 8388616.f;
#pragma unroll
              for (int m = 0; m < MT; ++m)
                acc[m][4 * q + i] = fmaf(xj[MT + m], wh,
                                         fmaf(xj[m], wl, acc[m][4 * q + i]));
            }
          } else {
            // bytes b + 128 in [0, 255]: 2^23 + b + 128 in a float
            const uint32_t t = word(v[u], q) ^ 0x80808080u;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float wv = mant_byte(t, i) - 8388736.f;
#pragma unroll
              for (int m = 0; m < MT; ++m)
                acc[m][4 * q + i] = fmaf(xj[m], wv, acc[m][4 * q + i]);
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) v[u] = nv[u];
    }
  }

  // this CTA's sums: red[(warp * MT + m) * kTN + col], added in warp order
  // into warp 0's rows
  __syncthreads();
  float* red = smem;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < CP; ++c)
      red[(warp * MT + m) * kTN + lane * CP + c] = acc[m][c];
  __syncthreads();
  for (int i = threadIdx.x; i < MT * kTN; i += kThreads) {
    float s = red[i];
    for (int k = 1; k < kWarps; ++k) s += red[k * MT * kTN + i];
    red[i] = s;
  }
  cluster.sync();
  // y: this rank's share of the [M, kTN] tile, the ranks added in order
  for (int i = rank * kThreads + threadIdx.x; i < M * kTN; i += C * kThreads) {
    const int col = tile * kTN + i % kTN;
    if (col >= N) continue;
    float s = 0.f;
    for (int q = 0; q < C; ++q) s += cluster.map_shared_rank(red, q)[i];
    y[static_cast<size_t>(i / kTN) * N + col] = s * scale[col];
  }
  cluster.sync();                             // no rank leaves while read
}

template <int MT, int CP, bool kInt4>
int gemv_launch(const void* x, const void* w, const void* scale, void* y,
                int M, int N, int K, int rows, int walk, int cluster,
                cudaStream_t s) {
  constexpr int kTN = 32 * CP;
  auto kernel = gemv_cluster<MT, CP, kInt4>;
  const int bytes = 4 * max(kStageFloats, kWarps * MT * kTN);
  static bool opted_in[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64 || !opted_in[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return e;
    if (dev < 64) opted_in[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((N + kTN - 1) / kTN * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const float*>(x),
                         static_cast<const int8_t*>(w),
                         static_cast<const float*>(scale),
                         static_cast<float*>(y), M, N, K, rows, walk);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// MT from M; the column width cp must suit it (MT <= 2: 16, 8 or 4; MT 4:
// 8 or 4; above: 4), so a thread holds at most 64 sums
template <bool kInt4>
int gemv_dispatch(const void* x, const void* w, const void* scale, void* y,
                  int M, int N, int K, int rows, int cp, int cluster,
                  cudaStream_t s) {
  if (M < 1 || M > 16 || N < 1 || K < 1 || rows < 1 || cluster < 1
      || cluster > kMaxCluster)
    return cudaErrorInvalidValue;
  if (kInt4 ? K > 2 * rows : K != rows) return cudaErrorInvalidValue;
  const int walk = kInt4 ? min(rows, K) : rows;
  const int R = (walk + cluster - 1) / cluster;
  if ((cluster - 1) * R >= walk) return cudaErrorInvalidValue;  // empty rank
  const long long ctas = static_cast<long long>((N + 32 * cp - 1) / (32 * cp))
                         * cluster;
  if (ctas > 0x7FFFFFFF) return cudaErrorInvalidValue;
#define WG_GEMV(mt, c)                                                  \
  if (M <= mt && cp == c)                                               \
    return gemv_launch<mt, c, kInt4>(x, w, scale, y, M, N, K, rows, walk, \
                                     cluster, s);
  WG_GEMV(1, 16) WG_GEMV(1, 8) WG_GEMV(1, 4)
  WG_GEMV(2, 16) WG_GEMV(2, 8) WG_GEMV(2, 4)
  WG_GEMV(4, 8) WG_GEMV(4, 4)
  WG_GEMV(8, 4)
  WG_GEMV(16, 4)
#undef WG_GEMV
  return cudaErrorInvalidValue;
}

}  // namespace

// x: [M, K] fp32; w_q: [K, N] int8; scale: [N] fp32; y: [M, N] fp32.  All
// contiguous, row-major; 1 <= M <= 16; cp: the columns a thread (16, 8 or
// 4, as M allows); cluster: the CTAs that split K (1..8, none empty)
// (cudaErrorInvalidValue else).
extern "C" int wg_w8_gemv_f32(const void* x, const void* w_q,
                              const void* scale, void* y, int M, int N,
                              int K, int cp, int cluster, void* stream) {
  return gemv_dispatch<false>(x, w_q, scale, y, M, N, K, K, cp, cluster,
                              static_cast<cudaStream_t>(stream));
}

// As wg_w8_gemv_f32 with w_p: [KH, N] packed int4 (K <= 2 KH); the K split
// runs over the min(KH, K) packed rows that hold weights.
extern "C" int wg_w4_gemv_f32(const void* x, const void* w_p,
                              const void* scale, void* y, int M, int N,
                              int K, int KH, int cp, int cluster,
                              void* stream) {
  return gemv_dispatch<true>(x, w_p, scale, y, M, N, K, KH, cp, cluster,
                             static_cast<cudaStream_t>(stream));
}
