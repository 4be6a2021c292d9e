// Quantized matmul CTA for Hopper (sm_90a), in four modes:
//   W8    y = (x @ w) * scale,          x bf16 [M, K], w int8 [K, N]
//   W4    the same with w split-K packed int4 [KH, N]
//   W8A8  y = (acc * scale) * sx,       acc = x_q @ w in int32, x_q int8
//         [M, K] (per-row activations), sx fp32 [M] their row scales
//   W4A8  the same with w split-K packed int4 [KH, N]
// scale fp32 [N], y bf16 [M, N].  w8_matmul.cu and w4_matmul.cu instantiate
// it (their head notes say which TPU kernel each mode replaces).
// Numerics: W8/W4 convert the integer weight exactly to bf16 inside the CTA
// (|w| <= 127) and accumulate in fp32; W8A8/W4A8 multiply int8 by int8 and
// accumulate exactly in int32 (|acc| <= 127 * 128 * K < 2^31 for K below
// 132,000).  The epilogue applies the per-column fp32 scale (A8: then the
// row scale sx, in that order, each product rounded once in fp32), then one
// bf16 rounding.
//
// The product is computed transposed, y^T = w^T x^T, so that the weight is
// wgmma's A operand, which may come from registers: each consumer thread
// loads its raw integer fragment from shared memory and turns it into an A
// fragment in registers; no converted tile makes a round trip through
// shared memory (a conversion that wrote one bounded the kernel, not the
// tensor cores; PERF.md, PR 5).  x (bf16 or int8) is the K-major B operand,
// as 8-bit wgmma requires of both of its shared-memory operands.
//
// Layout of the work.  A CTA computes 128 columns of y (n) for kBM token
// rows (kBM = 256, or 128 for the narrow variant the entry points pick when
// 256-row tiles would not fill two waves of the card).  A stage holds
//   * x: two TMA boxes of 64 bytes x kBM rows (64-byte swizzle): 32 bf16 or
//     64 int8 columns each.  W8: columns k0 and k0 + 32; W8A8: k0 and
//     k0 + 64; W4 / W4A8: p0 and KH + p0, the halves that packed rows p0..
//     pair with (low nibble: column p, high nibble: column KH + p).
//   * w: one TMA box of the raw integer weight, 128 columns x kWRows rows
//     (128-byte swizzle): 64 rows (W8), 32 packed rows (W4), 128 rows
//     (W8A8), 64 packed rows (W4A8).
// Every mode runs four wgmmas a stage, each reading 32 bytes of every x row
// (step kk: box kk / 2 at byte (kk % 2) * 32): bf16 m64n{kBM}k16 or s8
// m64n{kBM}k32.  TMA zero-fills what lies outside x and w, so ragged M, N
// and K cost nothing; the TMA store of y writes nothing outside [M, N).
//
// Warp roles (288 threads):
//   * Consumer warpgroups 0 and 1 own 64 columns (n) each: A = this
//     warpgroup's 64 weight columns from registers, B = the x box, the
//     accumulators in registers (128 a thread at kBM = 256).  A rows are
//     permuted so that a thread's rows g and g + 8 of its warp's 16 are the
//     adjacent columns nl = 16*warp + 2g and nl + 1, and its accumulator
//     rows are again nl and nl + 1.  Each step's 4 A registers are made
//     just before its wgmma: at kBM = 128 while the last three wgmmas run
//     (four register sets, kept live by register fences until the wgmma
//     that read them is done; wgmma.wait_group 3); at kBM = 256 once the
//     last one is done (wait_group 0; see kWait).
//   * Producer warp 8: one thread issues the TMA loads into a kStages ring
//     (full / empty mbarriers; each consumer warp releases a stage once).
//     Nine warps put three on one of the SM's four register files (16,384
//     registers each), so a thread may hold 168 registers: room for the
//     consumers' 128 accumulators, A and raw registers at kBM = 256, but
//     not for the four A sets of a pipelined wgmma chain (see kWait).
// The A fragments:
//   * W8, W4 (bf16, k16): ldmatrix.x4.trans over the raw tile hands each
//     thread the bytes of (k, k+1) x (nl, nl+1); per 32-bit register:
//     int8: the bytes of one column spread into the 16-bit halves by prmt,
//       then (0x4300 | (b & 0x7F)) - (0x4300 | (b & 0x80)) in bf16x2: exact,
//       two lop3 and one fma.rn.bf16x2 a pair;
//     int4: nibbles ^ 8 (= v + 8 in [0, 15]) placed by prmt and lop3 into
//       the mantissa of bf16 128.0 (0x4300), then one fma.rn.bf16x2 with
//       -136: exact.
//   * W8A8, W4A8 (s8, k32): an s8 A register holds 4 consecutive k of one
//     column, and the stored weight is [k][n]; PTX has no transpose for
//     8-bit wgmma operands, so the transpose happens in registers.  One
//     ldmatrix.x4.trans over 32 raw rows, with the lanes' row addresses
//     chosen so that thread (g, t4) receives rows 4*t4 .. 4*t4 + 3 and
//     16 + 4*t4 .. 16 + 4*t4 + 3 (two rows a matrix, the pairs ordered so
//     that the 8 rows of each matrix fall in 8 distinct banks of the
//     128-byte swizzle), gives 4 registers of (2 k) x (nl, nl+1) bytes; a
//     prmt of two of them is one A register: 4 prmt a k32 step.
//     W8A8: 1 ldmatrix.x4 and 4 prmt a wgmma, issued after the wait.
//     W4A8: each ldmatrix.x4 serves two wgmmas (packed rows j*32.. give the
//       low nibbles' step j against box 0 and the high nibbles' step j
//       against box 1): 2 ldmatrix.x4 at the stage's start, then per wgmma
//       4 prmt and 4 lop3 (low: (t << 4) & 0xF0F0F0F0, high: t & 0xF0F0F0F0)
//       which give 16 * v as an exact s8 byte for each nibble v in [-8, 7];
//       the accumulator then holds 16 * acc (< 2^31), and the epilogue's
//       exact * 1/16 restores acc before the scales.
// Epilogue: W8/W4: acc * scale; A8: float(acc) * scale * sx (left to
// right); two columns a thread in fp32, round to bf16, stage the
// warpgroup's [kBM x 64] sub-tile in the x ring (after both warpgroups'
// last wgmma), 128-byte swizzled, and write it with one TMA store.
#pragma once

#include <type_traits>

#include "hopper.cuh"

namespace {

template <bool kInt4, bool kA8, int kBM>
struct WoLayout {
  static constexpr int kConsumers = 2;
  static constexpr int kBN = 128;                 // y columns a CTA
  static constexpr int kXCols = kA8 ? 64 : 32;    // x columns of one box
  static constexpr int kXHalf = kBM * 64;         // bytes of one x box
  // raw weight rows a stage (packed rows for int4)
  static constexpr int kWRows = kInt4 ? kXCols : 2 * kXCols;
  static constexpr int kStageBytes = 2 * kXHalf + kWRows * kBN;
  // TMA ring: five stages where they fit in 227 KB, else four (W8A8)
  static constexpr int kStages =
      5 * kStageBytes + 2 * 5 * 8 + 1024 <= 232448 ? 5 : 4;
  static constexpr int kBarOff = kStages * kStageBytes;
  // + 1024 so the base can be rounded up to the swizzle atom
  static constexpr int kBytes = kBarOff + 2 * kStages * 8 + 1024;
  static constexpr int kThreads = 128 * kConsumers + 32;
  static constexpr int kAcc = kBM / 2;            // accumulators a thread
  // wgmma groups left in flight before the next step's A registers are
  // made.  At kBM = 256 ptxas has too few registers under the 168 cap to
  // keep four A sets apart and serializes the wgmmas itself (C7512, all
  // four modes); waiting for each explicitly ran 4-10 % faster at most
  // main-path shapes on the card (PERF.md, PR 7).  Under a 255 cap it
  // pipelines them, but a 256-thread CTA without the producer warp (thread
  // 0 refilling the ring) drew C7518 and ran 15-25 % slower, and 192-row
  // tiles, which do pipeline, were no faster.
  static constexpr int kWait = kBM == 256 ? 0 : 3;
  static_assert(kStageBytes % 1024 == 0 && kXHalf % 1024 == 0, "alignment");
  static_assert(2 * kXHalf == kBM * 128, "a staged y sub-tile fits a stage");
  static_assert(kBytes <= 232448, "shared memory");
};

#define WO_F8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                 "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WO_I8(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), \
                 "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define WO_D64 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define WO_D128 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, " \
  "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, " \
  "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, " \
  "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, " \
  "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, " \
  "%127"

// d[64] += A(registers) * B(smem, K-major), bf16 m64n128k16
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db,
                                         std::integral_constant<int, 128>) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WO_D64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : WO_F8(0), WO_F8(8), WO_F8(16), WO_F8(24), WO_F8(32), WO_F8(40),
        WO_F8(48), WO_F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[128] += A(registers) * B(smem, K-major), bf16 m64n256k16
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db,
                                         std::integral_constant<int, 256>) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" WO_D128
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : WO_F8(0), WO_F8(8), WO_F8(16), WO_F8(24), WO_F8(32), WO_F8(40),
        WO_F8(48), WO_F8(56), WO_F8(64), WO_F8(72), WO_F8(80), WO_F8(88),
        WO_F8(96), WO_F8(104), WO_F8(112), WO_F8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64] += A(registers) * B(smem, K-major), s8 m64n128k32, int32 sums
__device__ __forceinline__ void wgmma_rs(int* d, const uint32_t* a,
                                         uint64_t db,
                                         std::integral_constant<int, 128>) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" WO_D64
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : WO_I8(0), WO_I8(8), WO_I8(16), WO_I8(24), WO_I8(32), WO_I8(40),
        WO_I8(48), WO_I8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[128] += A(registers) * B(smem, K-major), s8 m64n256k32, int32 sums
__device__ __forceinline__ void wgmma_rs(int* d, const uint32_t* a,
                                         uint64_t db,
                                         std::integral_constant<int, 256>) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {" WO_D128
      "}, {%128, %129, %130, %131}, %132, p;\n}\n"
      : WO_I8(0), WO_I8(8), WO_I8(16), WO_I8(24), WO_I8(32), WO_I8(40),
        WO_I8(48), WO_I8(56), WO_I8(64), WO_I8(72), WO_I8(80), WO_I8(88),
        WO_I8(96), WO_I8(104), WO_I8(112), WO_I8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef WO_F8
#undef WO_I8
#undef WO_D64
#undef WO_D128

// keeps the registers of an A fragment live and unmoved until here
template <int N>
__device__ __forceinline__ void fence_regs_u32(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// the same for int32 accumulators (fence_regs in hopper.cuh: fp32 ones)
template <int N>
__device__ __forceinline__ void fence_regs_s32(int* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// Four 8x8 b16 matrices, transposed: lanes 8i..8i+7 give the row addresses
// of matrix i, and register i receives that matrix.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// r - c in bf16x2, exact for the small integers here
__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t r, uint32_t c) {
  uint32_t out;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(out) : "r"(c), "r"(0xBF80BF80u), "r"(r));
  return out;
}

// int8 values in the low bytes of the two 16-bit halves of t -> bf16x2
__device__ __forceinline__ uint32_t s8x2_to_bf16x2(uint32_t t) {
  return bf16x2_sub((t & 0x007F007Fu) | 0x43004300u,
                    (t & 0x00800080u) | 0x43004300u);
}

// v + 8 in bits 0-3 of the two 16-bit halves of t -> bf16x2 v
__device__ __forceinline__ uint32_t u4x2_to_bf16x2(uint32_t t) {
  return bf16x2_sub((t & 0x000F000Fu) | 0x43004300u, 0x43084308u);
}

// W8/W4: the raw A fragments of one stage from its weight tile at `w` (rows
// of 128 bytes, 128-byte swizzled); unit: this warp's 16 weight columns (16
// bytes of a raw row).  Lane l gives the address of raw row l (and 32 + l),
// so register i holds matrix i: rows 8i..8i+7, and for this thread the
// bytes (k, nl), (k, nl+1), (k+1, nl), (k+1, nl+1) with k = 8i + 2*t4.
template <bool kInt4>
__device__ __forceinline__ void load_raw(uint32_t* raw, uint32_t w, int unit,
                                         int lane) {
#pragma unroll
  for (int h = 0; h < (kInt4 ? 1 : 2); ++h) {
    const int r = 32 * h + lane;
    ldmatrix_x4_trans(raw + 4 * h, w + r * 128 + ((unit ^ (r & 7)) << 4));
  }
}

// W8/W4: the 4 A registers of k16 step kk from the raw fragments: a0, a2
// are row nl, a1, a3 row nl + 1; k = 2*t4 (a0, a1) and 2*t4 + 8 (a2, a3).
// int8: raw matrices 2kk and 2kk + 1.  int4 (32 packed rows a stage): steps
// 0-1 are the low nibbles of matrices 2(kk % 2) and 2(kk % 2) + 1, steps
// 2-3 their high nibbles.
template <bool kInt4>
__device__ __forceinline__ void convert_a(uint32_t* a, const uint32_t* raw,
                                          int kk) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if constexpr (!kInt4) {
      const uint32_t r = raw[2 * kk + j];
      a[2 * j] = s8x2_to_bf16x2(__byte_perm(r, 0, 0x4240));
      a[2 * j + 1] = s8x2_to_bf16x2(__byte_perm(r, 0, 0x4341));
    } else {
      const uint32_t u = raw[2 * (kk & 1) + j] ^ 0x88888888u;
      const int shift = 4 * (kk >> 1);
      a[2 * j] = u4x2_to_bf16x2(__byte_perm(u, 0, 0x4240) >> shift);
      a[2 * j + 1] = u4x2_to_bf16x2(__byte_perm(u, 0, 0x4341) >> shift);
    }
  }
}

// A8: this lane's byte offset, within a 32-row slab of the weight tile, of
// the raw row it gives ldmatrix.  Matrix i = lane / 8 hands thread t4 the
// rows of lanes 2*t4 and 2*t4 + 1: rows 4*t4 + 2h + {0, 1} of k-quad t4,
// h = ((t4 >> 1) ^ i) & 1, in the first 16 rows (i < 2) or the last 16, so
// that matrices 2q and 2q + 1 together give every thread its whole quad and
// each matrix's 8 rows differ mod 8 (distinct banks under the swizzle).
__device__ __forceinline__ int a8_lane_offset(int unit, int lane) {
  const int i = lane >> 3, t = (lane >> 1) & 3, e = lane & 1;
  const int h = ((t >> 1) ^ i) & 1;
  const int row = 16 * (i >> 1) + 4 * t + 2 * h + e;
  return row * 128 + ((unit ^ (row & 7)) << 4);
}

// A8: the 4 s8 A registers from one ldmatrix.x4 of 32 raw rows (r): a0 / a2
// column nl at k 4*t4.. / 16 + 4*t4.., a1 / a3 column nl + 1.  Register 2q
// holds k 4*t4 + 2h.. (2 k x 2 columns) and 2q + 1 the other pair, so the
// selectors (sel: low column, high column) put the pairs in k order.
__device__ __forceinline__ void a8_from_raw(uint32_t* a, const uint32_t* r,
                                            uint32_t sel_lo, uint32_t sel_hi) {
  a[0] = __byte_perm(r[0], r[1], sel_lo);
  a[1] = __byte_perm(r[0], r[1], sel_hi);
  a[2] = __byte_perm(r[2], r[3], sel_lo);
  a[3] = __byte_perm(r[2], r[3], sel_hi);
}

// The CTA.  n_steps k-stages; kh: W4/W4A8's packed rows (the x column of
// the high nibbles' half), unused by W8/W8A8; sx: A8's row scales.
template <bool kInt4, bool kA8, int kBM>
__device__ __forceinline__ void wo_matmul_body(
    const CUtensorMap& tx, const CUtensorMap& tw, const CUtensorMap& ty,
    const float* __restrict__ scale, const float* __restrict__ sx, int M,
    int N, int n_steps, int kh) {
  using Lay = WoLayout<kInt4, kA8, kBM>;
  using Acc = typename std::conditional<kA8, int, float>::type;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t full = sbase + Lay::kBarOff;           // + 8 * stage
  const uint32_t empty = full + 8 * Lay::kStages;

  const int n0 = blockIdx.x * Lay::kBN;
  const int m0 = blockIdx.y * kBM;
  const int wg = threadIdx.x / 128;
  const int tw_ = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < Lay::kStages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, Lay::kConsumers * 4);   // consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == Lay::kConsumers) {
    // ================= producer: one thread issues every load ===========
    if (tw_ == 0) {
      int s = 0;
      uint32_t ph = 0;
      for (int t = 0; t < n_steps; ++t) {
        mbar_wait(empty + 8 * s, ph ^ 1);
        const uint32_t st = sbase + s * Lay::kStageBytes;
        const uint32_t bar = full + 8 * s;
        const int c0 = t * (kInt4 ? 1 : 2) * Lay::kXCols;
        mbar_expect_tx(bar, Lay::kStageBytes);
        tma_load_2d(st, &tx, bar, c0, m0);
        tma_load_2d(st + Lay::kXHalf, &tx, bar,
                    kInt4 ? kh + c0 : c0 + Lay::kXCols, m0);
        tma_load_2d(st + 2 * Lay::kXHalf, &tw, bar, n0, t * Lay::kWRows);
        if (++s == Lay::kStages) { s = 0; ph ^= 1; }
      }
    }
  } else {
    // ================= consumers: 64 columns each =======================
    const int warp = tw_ / 32;
    const int lane = tw_ % 32;
    const int g = lane / 4;
    const int t4 = lane % 4;
    const int unit = wg * 4 + warp;     // raw columns 16*unit .. + 15
    // A8: this lane's ldmatrix row, and the prmt selectors of its quad
    const int a8_off = a8_lane_offset(unit, lane);
    const uint32_t sel_lo = (t4 & 2) ? 0x2064u : 0x6420u;
    const uint32_t sel_hi = (t4 & 2) ? 0x3175u : 0x7531u;

    Acc acc[Lay::kAcc];
#pragma unroll
    for (int i = 0; i < Lay::kAcc; ++i) acc[i] = 0;
    // A registers of the last four steps: step kk of every stage uses
    // a[kk], once the wgmma that read it four steps ago is done
    uint32_t a[4][4] = {};

    for (int t = 0; t < n_steps; ++t) {
      const int s = t % Lay::kStages;
      const uint32_t xs = sbase + s * Lay::kStageBytes;
      const uint32_t ws = xs + 2 * Lay::kXHalf;
      mbar_wait(full + 8 * s, (t / Lay::kStages) & 1);
      uint32_t raw[8];
      if constexpr (!kA8) {
        load_raw<kInt4>(raw, ws, unit, lane);
      } else if constexpr (kInt4) {
        ldmatrix_x4_trans(raw, ws + a8_off);
        ldmatrix_x4_trans(raw + 4, ws + 32 * 128 + a8_off);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_wait<Lay::kWait>();       // a[kk]'s last reader is done
        fence_regs_u32<4>(a[kk]);
        // the A fragment is made below, not above the wait (ptxas otherwise
        // serializes the wgmmas around the early definitions)
        if constexpr (!kA8)
          fence_regs_u32<2>(raw + (kInt4 ? 2 * (kk & 1) : 2 * kk));
        else if constexpr (kInt4)
          fence_regs_u32<4>(raw + 4 * (kk & 1));
        // at kk = 3 that is the last one of stage t-1: release the stage
        if (kk == 3 && t > 0 && lane == 0)
          mbar_arrive(empty + 8 * ((t - 1) % Lay::kStages));
        if constexpr (!kA8) {
          convert_a<kInt4>(a[kk], raw, kk);
        } else if constexpr (!kInt4) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, ws + kk * 32 * 128 + a8_off);
          a8_from_raw(a[kk], r, sel_lo, sel_hi);
        } else {
          // packed rows (kk % 2) * 32..: low nibbles at kk < 2, high after
          uint32_t w4[4];
          a8_from_raw(w4, raw + 4 * (kk & 1), sel_lo, sel_hi);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            a[kk][i] = (kk < 2 ? w4[i] << 4 : w4[i]) & 0xF0F0F0F0u;
        }
        wgmma_fence();
        // x box kk / 2, 32 bytes of each row in at (kk % 2) * 32
        const uint64_t db = make_desc(
            xs + (kk >> 1) * Lay::kXHalf + (kk & 1) * 32, 16, 512,
            kSwizzle64);
        wgmma_rs(acc, a[kk], db, std::integral_constant<int, kBM>());
        wgmma_commit();
      }
    }
    wgmma_wait<0>();
    if constexpr (kA8)
      fence_regs_s32<Lay::kAcc>(acc);
    else
      fence_regs<Lay::kAcc>(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs_u32<4>(a[kk]);

    // ---- epilogue: y = acc * scale (A8: * sx) in fp32, one bf16 rounding
    // accumulator rows g, g + 8 of this warp are the columns nl, nl + 1 of
    // this warpgroup's 64; accumulator columns 8j + 2*t4 + {0, 1} are
    // token rows.  Once both warpgroups' wgmmas are done, stage 0 of the
    // ring holds warpgroup 0's [kBM x 64] sub-tile, stage 1 warpgroup 1's.
    const int nl = 16 * warp + 2 * g;
    const int col = n0 + 64 * wg + nl;
    const float2 sc = col < N ? *reinterpret_cast<const float2*>(scale + col)
                              : make_float2(0.f, 0.f);
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    unsigned char* stage = smem + wg * Lay::kStageBytes;
#pragma unroll
    for (int j = 0; j < kBM / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 8 * j + 2 * t4 + h;
        float v0, v1;
        if constexpr (kA8) {
          const float rs = m0 + m < M ? sx[m0 + m] : 0.f;
          // W4A8's accumulators hold 16 * acc: * 1/16 is exact
          const float unit_ = kInt4 ? 0.0625f : 1.f;
          v0 = (float)acc[4 * j + h] * unit_ * sc.x * rs;
          v1 = (float)acc[4 * j + 2 + h] * unit_ * sc.y * rs;
        } else {
          v0 = acc[4 * j + h] * sc.x;
          v1 = acc[4 * j + 2 + h] * sc.y;
        }
        *reinterpret_cast<uint32_t*>(
            stage + m * 128 + (((nl >> 3) ^ (m & 7)) << 4) + 2 * (nl & 7)) =
            pack_bf16(v0, v1);
      }
    }
    fence_proxy_async();
    asm volatile("bar.sync %0, 128;\n" :: "r"(wg + 2) : "memory");
    if (tw_ == 0 && n0 + 64 * wg < N) {
      tma_store_2d(&ty, sbase + wg * Lay::kStageBytes, n0 + 64 * wg, m0);
      tma_store_wait_read();
    }
  }
}

// ---------------------------------------------------------------- host side

// What the TMA maps take: 16-byte aligned bases; x rows (K bf16, or K int8
// for A8) a multiple of 16 bytes, so K % k_mult with k_mult 8 or 16; weight
// rows (N bytes) too, which covers y rows (N bf16).  The wrappers in
// ops/quant.py pad to this (wo_layout, a8_layout); the entry points refuse
// anything else.
inline int wo_layout_ok(const void* x, const void* w, const void* scale,
                        const void* y, int M, int N, int K, int k_mult) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(x)
                        | reinterpret_cast<uintptr_t>(w)
                        | reinterpret_cast<uintptr_t>(scale)
                        | reinterpret_cast<uintptr_t>(y);
  return M > 0 && N > 0 && K > 0 && K % k_mult == 0 && N % 16 == 0
         && any % 16 == 0;
}

// The narrow variant (128-row tiles) when 256-row tiles would fill fewer
// than two waves of the card: there the last, partial wave dominates.
inline bool wo_narrow(int M, int N) {
  static int sms[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return false;
  int n_sm = dev < 64 ? sms[dev] : 0;
  if (n_sm == 0) {
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (dev < 64) sms[dev] = n_sm;
  }
  const long long tiles = (long long)((M + 255) / 256) * ((N + 127) / 128);
  return tiles < 2LL * n_sm;
}

// w_rows: the weight's rows (K, or KH packed); kh: the packed rows (0 for
// W8/W8A8); sx: A8's row scales (nullptr for W8/W4).
template <bool kInt4, bool kA8, int kBM, typename Kernel>
int wo_launch(Kernel kernel, const void* x, const void* w, const void* scale,
              const void* sx, void* y, int M, int N, int K, int w_rows,
              int kh, cudaStream_t stream) {
  using Lay = WoLayout<kInt4, kA8, kBM>;
  CUtensorMap tx, tw, ty;
  int err = make_map_2d(&tx, kA8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        x, M, K, (kA8 ? 1LL : 2LL) * K, Lay::kXCols, kBM,
                        CU_TENSOR_MAP_SWIZZLE_64B);
  if (!err)
    err = make_map_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, w_rows, N, N,
                      Lay::kBN, Lay::kWRows, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err)
    err = make_map_2d(&ty, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, y, M, N, 2LL * N,
                      64, kBM, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  static bool opted_in[64] = {};
  err = opt_in_smem(kernel, Lay::kBytes, opted_in);
  if (err) return err;
  const int n_steps = kInt4 ? kh / Lay::kWRows
                            : (K + Lay::kWRows - 1) / Lay::kWRows;
  dim3 grid((N + Lay::kBN - 1) / Lay::kBN, (M + kBM - 1) / kBM);
  kernel<<<grid, Lay::kThreads, Lay::kBytes, stream>>>(
      tx, tw, ty, static_cast<const float*>(scale),
      static_cast<const float*>(sx), M, N, n_steps, kh);
  return cudaGetLastError();
}

}  // namespace
