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
// Numerics: each fp32 x is split into three bf16 parts, x0 = bf16(x),
// x1 = bf16(x - x0), x2 = bf16(x - x0 - x1) (round to nearest; each
// difference is exact in fp32), and x0 + x1 + x2 == x exactly for every
// |x| above about 2^-110 (below, the low parts underflow in bf16 and the
// error stays under 2^-126).  The integer weights are exact in bf16, so
// every product w * x_i is exact.  The tensor cores add them into fp32
// accumulators, but not with round-to-nearest: each wgmma's sum loses up to
// an ulp of the running sum toward zero, and 3 x 256 such sums over K =
// 4096 drift by more than 1e-5 of the result.  So a stage's 12 wgmmas (64
// columns of K: 4 k16 steps x 3 parts) start a fresh partial sum, and the
// consumers add each stage's partial to the running sum in fp32, rounded to
// nearest.  Only the order of the sums differs from the plain version, and
// a run repeats bit for bit (a fixed order, no atomics).
//
// What bounds it: an fp32-exact product costs three bf16 ones, so the least
// time is max(bytes / 3.35 TB/s, 3 * 2MKN / 989 TFLOP/s): bytes at the
// adaLN tables (the weight), at patchify (y) and at proj_out (x), the
// tensor cores at M = 251.
//
// Design: the W8/W4 CTA of wo_matmul.cuh with x in fp32.  The product is
// computed transposed, y^T = w^T x^T: each of two consumer warpgroups owns
// 64 weight columns and makes its bf16 A fragment from the raw integer tile
// in registers (load_raw, convert_a).  The three parts of x lie one after
// another along wgmma's N, so one wgmma of N = 3 * kBM per k16 step reads
// all three with one A fragment (three wgmmas of N = kBM, one a part, ran
// slower: the stage's wgmmas are latency-bound, not operation-bound).  The
// token tile kBM is 32 (M = 31 pads to 32) or 64; a 128-row tile would
// leave no registers for the partial sums under the 168 a thread of 9
// warps may hold.  A producer warp keeps a TMA ring whose stage holds two
// fp32 boxes of x (32 columns x kBM rows, 128-byte swizzle: W8 columns k0
// and k0 + 32, W4 p0 and KH + p0) and the raw weight box (64 rows, W4 32
// packed rows, x 128 columns).  The consumers split the stage's x into the
// bf16 tiles wgmma reads (64-byte swizzle, as the bf16 CTA's x boxes) in
// one of three work slots, so x is read from device memory once and no
// [3, M, K] copy exists; a named barrier hands the slot to both
// warpgroups, which then wait for the last stage's wgmmas (the split ran
// beside them), add its partial sums and issue this stage's.  Three slots
// need that one barrier a stage: a slot is written again three stages
// after it was read, and both warpgroups have waited for those wgmmas
// before the barrier of the stage between.  Shared memory: three slots of
// 2 x 3 x kBM x 64 bytes and as many stages of 2 x kBM x 128 + 8 KB (W4:
// 4 KB) as fit in 227 KB, at most eight.  W4 with K <= KH walks the low
// half only: no high box, no wgmma on the all-zero high nibbles.
//
// Where the row and column tiles give fewer CTAs than the card has SMs (the
// adaLN tables' t2 at 32 column tiles, proj_out of the 251 audio tokens),
// the CTAs of a cluster of 2, 4 or 8 (quant.f32_plan) take equal shares of
// the K steps: each stages its unscaled sums, and after a cluster barrier
// rank r adds its slab of kBM / split rows over the ranks in rank order
// (distributed shared memory), scales it and stores it.  Otherwise the
// epilogue scales in fp32 and stores fp32 through two TMA boxes a
// warpgroup (32 columns, 128-byte swizzle) staged in the work slots.  TMA
// zero-fills the ragged M, N and K edges; the wrappers pad x's rows to a
// multiple of 4 columns and N to one of 16 where a shape needs it.
#include <cooperative_groups.h>

#include "wo_matmul.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kF32Threads = 288;    // two consumer warpgroups, one producer
constexpr int kF32BN = 128;         // y columns (weight columns) a CTA
constexpr int kF32MaxStages = 8;
constexpr int kF32Smem = 232448;     // shared memory a CTA may use

// bytes of one ring stage: two fp32 x boxes and the raw weight box
__host__ __device__ constexpr int f32_stage_bytes(bool int4, int bm) {
  return 2 * bm * 128 + (int4 ? 32 : 64) * 128;
}

// bytes of a stage's x in bf16: two boxes (the stage's columns 0-31 and
// 32-63) of 3 x kBM rows of 64 bytes, the parts x0, x1, x2 one after the
// other, so that one wgmma of N = 3 * kBM reads all three
__host__ __device__ constexpr int f32_slot_bytes(int bm) {
  return 2 * 3 * bm * 64;
}

#define WO_F8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                 "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
// d[48] = (add ? d : 0) + A(registers) * B(smem, K-major), bf16
// m64n96k16
__device__ __forceinline__ void wgmma_rs_f32x3(
    float* d, const uint32_t* a, uint64_t db, int add,
    std::integral_constant<int, 96>) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      : WO_F8(0), WO_F8(8), WO_F8(16), WO_F8(24), WO_F8(32), WO_F8(40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(add));
}

// d[96] = (add ? d : 0) + A(registers) * B(smem, K-major), bf16
// m64n192k16
__device__ __forceinline__ void wgmma_rs_f32x3(
    float* d, const uint32_t* a, uint64_t db, int add,
    std::integral_constant<int, 192>) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}\n"
      : WO_F8(0), WO_F8(8), WO_F8(16), WO_F8(24), WO_F8(32), WO_F8(40),
        WO_F8(48), WO_F8(56), WO_F8(64), WO_F8(72), WO_F8(80), WO_F8(88)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(add));
}
#undef WO_F8

// the split of two fp32 values into three bf16x2 words: p0 + p1 + p2 holds
// (a, b) exactly (see the head note)
__device__ __forceinline__ void split3(float a, float b, uint32_t* p) {
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    p[q] = pack_bf16(a, b);
    a -= __uint_as_float(p[q] << 16);
    b -= __uint_as_float(p[q] & 0xFFFF0000u);
  }
}

// The epilogue of a CTA whose cluster split K (all 288 threads of each of
// its `split` CTAs call it; consumer: the consumers, which have staged
// their unscaled sums): rank r adds rows [r R, r R + R) (R = kBM / split,
// a multiple of 8) of the four staged boxes over the ranks in rank order
// (distributed shared memory), scales them, and stores that slab of y
// through `ty`, whose box is 32 columns x R rows.
template <int kBM>
__device__ __forceinline__ void f32_split_sum(
    unsigned char* smem, uint32_t sbase, int work0,
    const float* __restrict__ scale, int N, int n0, int m0, int rank,
    int split, const CUtensorMap* ty, bool consumer) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                       // every rank's sums are staged
  const int R = kBM / split;
  if (consumer) {
    // thread i: 16 bytes (4 columns) of one slab row of one box
    for (int i = threadIdx.x; i < 4 * R * 8; i += 256) {
      const int b = i / (R * 8), r = rank * R + (i / 8) % R, c = i % 8;
      const int off = work0 + b * kBM * 128 + r * 128 + (c << 4);
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int q = 0; q < split; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(smem + off, q));
        s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
      }
      // the 4 columns this chunk holds (128-byte swizzle: chunk c of row r
      // holds logical chunk c ^ (r & 7))
      const int gc = n0 + 32 * b + 4 * (c ^ (r & 7));
      const float4 sc = gc < N ? *reinterpret_cast<const float4*>(scale + gc)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(smem + off) =
          make_float4(s.x * sc.x, s.y * sc.y, s.z * sc.z, s.w * sc.w);
    }
    fence_proxy_async();
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    if (threadIdx.x == 0) {
      for (int b = 0; b < 4; ++b)
        if (n0 + 32 * b < N)
          tma_store_2d(ty, sbase + work0 + b * kBM * 128 + rank * R * 128,
                       n0 + 32 * b, m0 + rank * R);
      tma_store_wait_read();
    }
  }
  cluster.sync();                       // no rank leaves while read
}

// n_steps ring stages; kh: W4's packed rows (x column of the high half);
// hi: the stage has a second x box (W8 always; W4 when K > KH); work:
// bytes of the three work slots (or the epilogue's staging, if larger).
template <bool kInt4, int kBM>
__global__ void __launch_bounds__(kF32Threads, 1)
f32_matmul(const __grid_constant__ CUtensorMap tx,
           const __grid_constant__ CUtensorMap tw,
           const __grid_constant__ CUtensorMap ty,
           const float* __restrict__ scale, int N, int n_steps, int kh,
           int hi, int stages, int work, int split) {
  constexpr int kXBox = kBM * 128;
  constexpr int kSlot = f32_slot_bytes(kBM);
  constexpr int kWRows = kInt4 ? 32 : 64;
  constexpr int kStage = f32_stage_bytes(kInt4, kBM);
  constexpr int kAcc = kBM / 2;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw0 = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw0 + 1023) & ~1023u) - raw0);
  const uint32_t sbase = smem_u32(smem);
  const int work0 = stages * kStage;            // byte offset of the slots
  const uint32_t full = sbase + work0 + work;   // + 8 * stage
  const uint32_t empty = full + 8 * stages;

  // token rows: the fast grid axis, so that the CTAs of one weight tile
  // meet; the `split` CTAs of a cluster take equal shares of the K steps
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int m0 = blockIdx.x / split * kBM;
  const int n0 = blockIdx.y * kF32BN;
  const int per = (n_steps + split - 1) / split;
  const int t0 = rank * per;
  const int t1 = min(n_steps, t0 + per);
  const int wg = threadIdx.x / 128;
  const int tw_ = threadIdx.x % 128;
  const int n_box = hi ? 2 : 1;

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ================= producer: one thread issues every load =============
    if (tw_ == 0) {
      int s = 0;
      uint32_t ph = 0;
      for (int t = t0; t < t1; ++t) {
        mbar_wait(empty + 8 * s, ph ^ 1);
        const uint32_t st = sbase + s * kStage;
        const uint32_t bar = full + 8 * s;
        const int c0 = t * (kInt4 ? 32 : 64);
        mbar_expect_tx(bar, n_box * kXBox + kWRows * 128);
        tma_load_2d(st, &tx, bar, c0, m0);
        if (hi)
          tma_load_2d(st + kXBox, &tx, bar, kInt4 ? kh + c0 : c0 + 32, m0);
        tma_load_2d(st + 2 * kXBox, &tw, bar, n0, t * kWRows);
        if (++s == stages) { s = 0; ph ^= 1; }
      }
    }
    if (split > 1) f32_split_sum<kBM>(smem, sbase, work0, scale, N, n0, m0,
                                      rank, split, &ty, false);
    return;
  }

  // =================== consumers: 64 weight columns each ==================
  const int ct = threadIdx.x;          // 0..255
  const int warp = tw_ / 32;
  const int lane = tw_ % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int unit = wg * 4 + warp;      // raw columns 16*unit .. + 15

  // acc: the sums of the finished stages, added in fp32 (round to
  // nearest); c: this stage's, from its wgmmas, the three parts' sums side
  // by side (c[q * kAcc + i] is part q's acc[i])
  float acc[kAcc], c[3 * kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 3 * kAcc; ++i) c[i] = 0.f;
  uint32_t a[4][4];

  for (int t = t0; t < t1; ++t) {
    const int u = t - t0;                              // this CTA's step
    const int s = u % stages;
    const int xs = s * kStage;                         // byte offsets
    const int slot = work0 + (u % 3) * kSlot;
    mbar_wait(full + 8 * s, (u / stages) & 1);
    uint32_t raw[8];
    load_raw<kInt4>(raw, sbase + xs + 2 * kXBox, unit, lane);
    // split x: thread i takes 16 bytes (4 columns) of one row of one box
    for (int i = ct; i < n_box * kBM * 8; i += 256) {
      const int j = i / (kBM * 8), r = (i / 8) % kBM, cc = i % 8;
      const float4 v = *reinterpret_cast<const float4*>(
          smem + xs + j * kXBox + r * 128 + ((cc ^ (r & 7)) << 4));
      uint32_t p[2][3];
      split3(v.x, v.y, p[0]);
      split3(v.z, v.w, p[1]);
      const int off = slot + j * kSlot / 2 + r * 64
                      + ((((cc >> 1) ^ (r >> 1)) & 3) << 4) + (cc & 1) * 8;
#pragma unroll
      for (int q = 0; q < 3; ++q)
        *reinterpret_cast<uint2*>(smem + off + q * kBM * 64) =
            make_uint2(p[0][q], p[1][q]);
    }
    fence_proxy_async();
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    if (ct == 0) mbar_arrive(empty + 8 * s);   // x and w are read
    // the last stage's wgmmas are done (the split above ran beside them):
    // add its sums, then this stage's first wgmma starts c afresh
    wgmma_wait<0>();
    fence_regs<3 * kAcc>(c);
#pragma unroll
    for (int i = 0; i < kAcc; ++i)
      acc[i] += c[i] + (c[kAcc + i] + c[2 * kAcc + i]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk == 2 && !hi) break;
      fence_regs_u32<2>(raw + (kInt4 ? 2 * (kk & 1) : 2 * kk));
      convert_a<kInt4>(a[kk], raw, kk);
      wgmma_fence();
      // box kk / 2 (all three parts), 32 bytes of each row in at
      // (kk % 2) * 32
      const uint64_t db = make_desc(
          sbase + slot + (kk >> 1) * kSlot / 2 + (kk & 1) * 32, 16, 512,
          kSwizzle64);
      wgmma_rs_f32x3(c, a[kk], db, kk > 0,
                     std::integral_constant<int, 3 * kBM>());
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs<3 * kAcc>(c);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) fence_regs_u32<4>(a[kk]);
#pragma unroll
  for (int i = 0; i < kAcc; ++i)
    acc[i] += c[i] + (c[kAcc + i] + c[2 * kAcc + i]);

  // ---- epilogue: y = acc * scale in fp32 (split > 1: the ranks' sums
  // first).  Accumulator rows g, g + 8 of this warp are the columns nl,
  // nl + 1 of this warpgroup's 64; accumulator columns 8j + 2*t4 + {0, 1}
  // are token rows.  Once both warpgroups' wgmmas are done, the work slots
  // hold each warpgroup's [kBM x 64] fp32 sub-tile as two 128-byte
  // swizzled boxes of 32 columns.
  const int nl = 16 * warp + 2 * g;
  const int col = n0 + 64 * wg + nl;
  const float2 sc = split > 1 ? make_float2(1.f, 1.f)
                    : col < N ? *reinterpret_cast<const float2*>(scale + col)
                              : make_float2(0.f, 0.f);
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  const int stg = work0 + wg * 2 * kXBox;
  const int box = stg + (nl >> 5) * kXBox;
#pragma unroll
  for (int j = 0; j < kBM / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 8 * j + 2 * t4 + h;
      *reinterpret_cast<float2*>(
          smem + box + m * 128 + ((((nl & 31) >> 2) ^ (m & 7)) << 4)
          + (nl & 3) * 4) =
          make_float2(acc[4 * j + h] * sc.x, acc[4 * j + 2 + h] * sc.y);
    }
  }
  if (split > 1) {
    f32_split_sum<kBM>(smem, sbase, work0, scale, N, n0, m0, rank, split,
                       &ty, true);
    return;
  }
  fence_proxy_async();
  asm volatile("bar.sync %0, 128;\n" :: "r"(wg + 2) : "memory");
  if (tw_ == 0) {
#pragma unroll
    for (int b = 0; b < 2; ++b)
      if (n0 + 64 * wg + 32 * b < N)
        tma_store_2d(&ty, sbase + stg + b * kXBox, n0 + 64 * wg + 32 * b, m0);
    tma_store_wait_read();
  }
}

// ---------------------------------------------------------------- host side

// rows: the weight's rows (K, or KH packed); ldx: x's row stride in
// elements (K rounded up to a multiple of 4 by the wrapper).
template <bool kInt4, int kBM>
int f32_launch(const void* x, const void* w, const void* scale, void* y,
               int M, int N, int K, int ldx, int rows, int split,
               cudaStream_t s) {
  constexpr int kStage = f32_stage_bytes(kInt4, kBM);
  CUtensorMap tx, tw, ty;
  int err = make_map_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x, M, K,
                        4LL * ldx, 32, kBM, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err)
    err = make_map_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, rows, N, N,
                      kF32BN, kInt4 ? 32 : 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err)
    err = make_map_2d(&ty, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, y, M, N, 4LL * N,
                      32, kBM / split, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  // W4 packed rows at or past K hold zeros in both nibbles (K <= 2 KH): the
  // walk stops at min(KH, K), and at K <= KH it has no high half
  const int hi = !kInt4 || K > rows;
  const int n_steps = kInt4 ? (min(rows, K) + 31) / 32 : (K + 63) / 64;
  // a split of K into `split` non-empty shares, each a slab of >= 8 rows
  const int per = (n_steps + split - 1) / split;
  if (split < 1 || split > 8 || kBM % (8 * split)
      || (split - 1) * per >= n_steps)
    return cudaErrorInvalidValue;
  const int slots = min(3, n_steps);
  const int work = max(slots * f32_slot_bytes(kBM), 4 * kBM * 128);
  // a stage: its bytes and two mbarriers
  const int stages = min(min(kF32MaxStages, n_steps),
                         (kF32Smem - 1024 - work) / (kStage + 16));
  const int bytes = 1024 + stages * (kStage + 16) + work;
  static bool opted_in[64] = {};
  err = opt_in_smem(f32_matmul<kInt4, kBM>, kF32Smem, opted_in);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((M + kBM - 1) / kBM * split, (N + kF32BN - 1) / kF32BN);
  cfg.blockDim = dim3(kF32Threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, f32_matmul<kInt4, kBM>, tx, tw, ty,
                           static_cast<const float*>(scale), N, n_steps,
                           rows, hi, stages, work, split);
  if (err) return err;
  return cudaGetLastError();
}

template <bool kInt4>
int f32_dispatch(const void* x, const void* w, const void* scale, void* y,
                 int M, int N, int K, int ldx, int rows, int bm, int split,
                 cudaStream_t s) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(x)
                        | reinterpret_cast<uintptr_t>(w)
                        | reinterpret_cast<uintptr_t>(scale)
                        | reinterpret_cast<uintptr_t>(y);
  if (M < 1 || N < 1 || K < 1 || rows < 1 || K > ldx || ldx % 4
      || N % 16 || any % 16)
    return cudaErrorInvalidValue;
  if (kInt4 ? K > 2 * rows : K != rows) return cudaErrorInvalidValue;
  if ((N + kF32BN - 1) / kF32BN > 65535) return cudaErrorInvalidValue;
  switch (bm) {
    case 32:
      return f32_launch<kInt4, 32>(x, w, scale, y, M, N, K, ldx, rows, split,
                                   s);
    case 64:
      return f32_launch<kInt4, 64>(x, w, scale, y, M, N, K, ldx, rows, split,
                                   s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: [M, ldx] fp32 (K columns used, ldx % 4 == 0); w_q: [K, N] int8; scale:
// [N] fp32; y: [M, N] fp32.  All contiguous, row-major, 16-byte aligned,
// N % 16 == 0; bm: the token tile, 32 or 64; split: the CTAs (a cluster)
// that share the K steps of a tile, 1..8, each at least one step and a
// slab of bm / split >= 8 rows (cudaErrorInvalidValue else).
extern "C" int wg_w8_matmul_f32(const void* x, const void* w_q,
                                const void* scale, void* y, int M, int N,
                                int K, int ldx, int bm, int split,
                                void* stream) {
  return f32_dispatch<false>(x, w_q, scale, y, M, N, K, ldx, K, bm, split,
                             static_cast<cudaStream_t>(stream));
}

// As wg_w8_matmul_f32 with w_p: [KH, N] packed int4 (K <= 2 KH).
extern "C" int wg_w4_matmul_f32(const void* x, const void* w_p,
                                const void* scale, void* y, int M, int N,
                                int K, int ldx, int KH, int bm, int split,
                                void* stream) {
  return f32_dispatch<true>(x, w_p, scale, y, M, N, K, ldx, KH, bm, split,
                            static_cast<cudaStream_t>(stream));
}
