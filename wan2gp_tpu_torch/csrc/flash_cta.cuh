// The flash attention CTA for Hopper (sm_90a), bf16 in / bf16 out, shared
// by flash_attention.cu (dense and kv-masked) and sparse_flash.cu (the
// table-driven block-sparse forms).  One template, three kv modes:
//   kDense   every kv tile of the sequence;
//   kMasked  the same with a [B, S] key-validity mask;
//   kTable   the kv blocks that a table lists for the CTA's q block.
// The consumers are one code for all three; `if constexpr` keeps each
// mode's extra work out of the others.
//
// Numerics (those of the Pallas kernels): q is scaled in bf16 before Q K^T
// (the wrapper passes the scale already rounded to bf16), scores and the
// online-softmax state (running max m, denominator l, accumulator) stay
// fp32, P is rounded to bf16 before P V, keys past the end of the tile's
// range are masked with the finite -1e30, and a zero denominator becomes 1.
//
// Design (one CTA per (q tile, head, batch item); 128 keys per kv tile):
//   * Warp roles.  One producer warpgroup, of which one thread issues
//     every load, and two consumer warpgroups that own 64 q rows each
//     (q tile of 128 rows).  setmaxnreg moves registers from the producer
//     (24 a thread) to the consumers (240).  A one-consumer instantiation
//     with a 64-row q tile serves L <= 64 (dense, masked) and q blocks
//     that are not a multiple of 128 rows (table); no register move
//     there: 256 threads fit at 255 registers.
//   * TMA loads.  4-D tensor maps over the native strided [B, L, N, D]
//     layout (dims D, N, L, B; no host transposes, no padding), built per
//     call and passed as __grid_constant__.  With the 128-byte swizzle a
//     box row holds at most 64 bf16 values, so a D = 128 row is two boxes
//     (two 64-column chunks of the tile).  Rows past L or S are zero-filled
//     by the TMA unit; keys past the tile's range still get the score
//     mask, since a zero key scores 0, not -inf.
//   * K/V ring.  Two stages of K and V (masked: and the tile's mask bytes,
//     one bulk copy of up to 128 bytes from a row that holds S rounded up
//     to 16 bytes; table: the tile's first key and the end of its kv
//     block, 8 bytes written by the producer), each with a full mbarrier
//     (producer's expect_tx + the bytes) and an empty one (every consumer
//     thread arrives).  D = 128 takes Q 32 KB + 2 x (K 32 KB + V 32 KB) =
//     160 KB of shared memory.
//   * Table mode.  The producer walks the CTA's table row (route block
//     q0 / block_q, of group b*N + n or of the one shared table): for each
//     entry e < count it loads the 128-key tiles of kv block kv_idx[e]
//     that start before min(kv0 + block_kv, S), so every tile it loads
//     holds at least one key that counts, and a tile wholly past S is
//     never loaded (its exp(0) = 1 cannot reach l).  It reads the next
//     entry's index one entry ahead.  Each tile's (first key, block end)
//     goes into the stage beside K and V, and after the last tile a stage
//     whose first key is -1 (a plain arrive, no bytes) tells the
//     consumers to stop, so they never read the table.  Keys at or past
//     the block end (block_kv = 64 or 192 leave part of a tile outside
//     the block) get the score mask.  A row whose count is 0 loads no
//     tile and writes zeros (and lse -1e30).  The grid runs the q tiles of
//     one head first, so the CTAs of one route block (block_q / 128 of
//     them) run side by side and read the same kv tiles through L2.
//   * The two products.  S = Q K^T is wgmma m64n128k16 with both operands
//     in shared memory (K-major, 128-byte swizzle).  O += P V is wgmma
//     m64nDk16 with P from registers: the fp32 score accumulator, rounded
//     to bf16, is already the A fragment of the next product (the layouts
//     coincide for 16-bit A), and V is read from shared memory through the
//     descriptor's transpose bit (MN-major), so V needs no transposing
//     copy.  q is scaled in bf16 once per CTA in shared memory by the
//     consumers, then fence.proxy.async makes the generic-proxy writes
//     visible to wgmma.
//   * Softmax in registers, exp2 of log2(e)-scaled differences with
//     ex2.approx (relative error about 2^-22, against the 2^-9 of the bf16
//     rounding of P); the running max stays in natural units, so the
//     logsumexp is m + log(l); each thread keeps its partial row sums and
//     the four threads of a row add them once, at the end.
//   * Masked: a kv tile whose 128 mask bytes are all zero is skipped by
//     the consumers (exact: such a tile adds P = 0 and leaves the running
//     max alone), and P is forced to 0 while a row's running max is still
//     <= -1e30/2, so a fully masked row keeps l = 0 and writes zeros.
//   * Every mbarrier wait traps after ~2^28 failed polls instead of
//     spinning forever, so a fault surfaces as a launch error.
//   * No pipeline within a consumer warpgroup: each waits for its Q K^T
//     before the softmax and for its P V before the next tile; the two
//     warpgroups and the producer overlap each other (PERF.md, Findings,
//     for the overlapping, ping-pong and persistent variants tried).
#pragma once

#include "hopper.cuh"   // mbarrier, TMA, descriptor and tensor-map helpers

namespace {

constexpr int kBlockN = 128;      // keys per kv tile
constexpr int kStages = 2;        // depth of the K/V ring
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

enum KvMode { kDense = 0, kMasked = 1, kTable = 2 };

template <int D, int Mode, int kConsumers>
struct Layout {
  static constexpr int kBlockM = 64 * kConsumers;      // q rows per CTA
  static constexpr int kChunks = D / 64;               // 128-byte columns
  static constexpr int kQBytes = kBlockM * D * 2;
  static constexpr int kKVBytes = kBlockN * D * 2;     // K or V, one stage
  // beside each stage: the masked mode's mask bytes, the table mode's
  // (first key, block end)
  static constexpr int kSideOff = kQBytes + kStages * 2 * kKVBytes;
  static constexpr int kBarOff =
      kSideOff + (Mode == kMasked ? kStages * kBlockN
                                  : Mode == kTable ? kStages * 8 : 0);
  // + 1024 so the base can be rounded up to the swizzle atom
  static constexpr int kBytes = kBarOff + (1 + 2 * kStages) * 8 + 1024;
  static constexpr int kThreads = 128 * (kConsumers + 1);
};

// What the table mode reads besides q, k and v (unused by the others).
struct TableArgs {
  const int* kv_idx;        // [G, nQb, W] int32, G = B*N or 1
  const int* counts;        // [G, nQb] int32
  float* lse;               // [B, N, L] fp32, or null
  long long tbl_g;          // kv_idx elements per group: nQb*W, or 0
  long long cnt_g;          // counts elements per group: nQb, or 0
  int w, block_q, block_kv;
};

#define F8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
              "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define REGS32 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31"
#define REGS64 REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, " \
  "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "   \
  "%56, %57, %58, %59, %60, %61, %62, %63"

// d[64] (+)= A(smem, K-major) * B(smem, K-major), m64n128k16
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" REGS64 "}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64] += A(registers) * B(smem, MN-major), m64n128k16
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" REGS64 "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[32] += A(registers) * B(smem, MN-major), m64n64k16
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" REGS32 "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef F8
#undef REGS32
#undef REGS64

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D, int Mode, int kConsumers>
__global__ void __launch_bounds__(Layout<D, Mode, kConsumers>::kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const uint8_t* __restrict__ kvm, long long msb,
                 const TableArgs tb,
                 __nv_bfloat16* __restrict__ o, long long osb, long long osl,
                 long long osn, int L, int S, float scale) {
  using Lay = Layout<D, Mode, kConsumers>;
  constexpr int kBlockM = Lay::kBlockM;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t sbase = smem_u32(smem);
  const uint32_t q_full = sbase + Lay::kBarOff;
  const uint32_t kv_full = q_full + 8;                  // + 8 * stage
  const uint32_t kv_empty = kv_full + 8 * kStages;      // + 8 * stage
  // table mode: (first key, end of its kv block) of the tile in each stage
  int2* tile_info = reinterpret_cast<int2*>(smem + Lay::kSideOff);

  const int q0 = blockIdx.x * kBlockM;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (S + kBlockN - 1) / kBlockN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(kv_full + 8 * i, 1);
      mbar_init(kv_empty + 8 * i, kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ================= producer: one thread issues every load =========
    if constexpr (kConsumers == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x % 128 == 0) {
      mbar_expect_tx(q_full, Lay::kQBytes);
      for (int c = 0; c < Lay::kChunks; ++c)
        tma_load_4d(sbase + c * kBlockM * 128, &tq, q_full, c * 64, n, q0, b);
      int st = 0;
      uint32_t ph = 0;
      // the tile of keys j0 .. j0+127 into the next stage; `lim` is the
      // end of the keys that count (table mode only: the kv block's end)
      auto load_tile = [&](int j0, int lim) {
        mbar_wait(kv_empty + 8 * st, ph ^ 1);
        const uint32_t full = kv_full + 8 * st;
        if constexpr (Mode == kTable) tile_info[st] = make_int2(j0, lim);
        // mask bytes of this tile: up to S, rounded up to the 16 bytes a
        // bulk copy moves (the wrapper's rows hold that many)
        const uint32_t mask_bytes =
            Mode == kMasked ? min(kBlockN, (S - j0 + 15) & ~15) : 0;
        mbar_expect_tx(full, 2 * Lay::kKVBytes + mask_bytes);
        const uint32_t ks = sbase + Lay::kQBytes + st * 2 * Lay::kKVBytes;
        for (int c = 0; c < Lay::kChunks; ++c) {
          tma_load_4d(ks + c * kBlockN * 128, &tk, full, c * 64, n, j0, b);
          tma_load_4d(ks + Lay::kKVBytes + c * kBlockN * 128, &tv, full,
                      c * 64, n, j0, b);
        }
        if constexpr (Mode == kMasked)
          bulk_load(sbase + Lay::kSideOff + st * kBlockN, kvm + b * msb + j0,
                    mask_bytes, full);
        if (++st == kStages) { st = 0; ph ^= 1; }
      };
      if constexpr (Mode == kTable) {
        const long long gi = (long long)b * gridDim.y + n;
        const int rb = q0 / tb.block_q;
        const int count = tb.counts[gi * tb.cnt_g + rb];
        const int* idx = tb.kv_idx + gi * tb.tbl_g + (long long)rb * tb.w;
        int next = count > 0 ? idx[0] : 0;
        for (int e = 0; e < count; ++e) {
          const int kv0 = next * tb.block_kv;
          if (e + 1 < count) next = idx[e + 1];      // one entry ahead
          const int kv_end = min(kv0 + tb.block_kv, S);
          for (int j0 = kv0; j0 < kv_end; j0 += kBlockN) load_tile(j0, kv_end);
        }
        // end of the row: a stage with no bytes and first key -1
        mbar_wait(kv_empty + 8 * st, ph ^ 1);
        tile_info[st] = make_int2(-1, 0);
        mbar_arrive(kv_full + 8 * st);
      } else {
        for (int t = 0; t < n_tiles; ++t) load_tile(t * kBlockN, S);
      }
    }
  } else {
    // ================= consumers: 64 q rows per warpgroup =============
    if constexpr (kConsumers == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tw = threadIdx.x % 128;
    const int warp = tw / 32;
    const int lane = tw % 32;
    const int g = lane / 4;             // accumulator row within 8
    const int t4 = lane % 4;            // accumulator column pair

    // q * scale in bf16, in place, on this warpgroup's 64 rows (the same
    // bytes in every 8-row swizzle atom, so the swizzle does not matter)
    mbar_wait(q_full, 0);
#pragma unroll
    for (int c = 0; c < Lay::kChunks; ++c) {
      uint4* rows = reinterpret_cast<uint4*>(smem + c * kBlockM * 128
                                             + wg * 64 * 128);
#pragma unroll
      for (int i = tw; i < 64 * 8; i += 128) {
        uint4 val = rows[i];
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          e[j] = __float2bfloat16(__bfloat162float(e[j]) * scale);
        rows[i] = val;
      }
    }
    fence_proxy_async();
    asm volatile("bar.sync %0, 128;\n" :: "r"(wg + 1) : "memory");

    const uint32_t q_addr = sbase + wg * 64 * 128;
    float acc[D / 2];                   // O: 64 rows x D, fp32
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m_run[2] = {kNegInf, kNegInf};
    float l_part[2] = {0.f, 0.f};       // this thread's share of each row sum

    int st = 0;
    uint32_t ph = 0;
    // (the dense and masked modes keep the counted loop: a loop that
    // tests for its end after the wait compiled to a slower schedule)
    for (int t = 0; Mode == kTable || t < n_tiles; ++t) {
      int j0 = t * kBlockN;             // the tile's first key
      int lim = S;                      // keys from here on are masked
      mbar_wait(kv_full + 8 * st, ph);
      if constexpr (Mode == kTable) {
        const int2 tile = tile_info[st];
        if (tile.x < 0) break;          // the producer's end of the row
        j0 = tile.x;
        lim = tile.y;
      }
      const uint32_t ks = sbase + Lay::kQBytes + st * 2 * Lay::kKVBytes;
      const uint32_t vs = ks + Lay::kKVBytes;
      const uint8_t* mk = smem + Lay::kSideOff + st * kBlockN;
      bool skip = false;
      if constexpr (Mode == kMasked)  // all 128 keys masked: adds nothing
        skip = !__any_sync(           // (bytes past S are stale and may
            0xffffffffu,              // only unskip)
            reinterpret_cast<const uint32_t*>(mk)[lane] != 0);
      if (!skip) {
        // ---- S = (q*scale) K^T: 64 rows x 128 keys per warpgroup ----
        float s[64];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t col = (kk % 4) * 32;   // 16 values = 32 B
          wgmma_ss_n128(
              s, make_desc(q_addr + (kk / 4) * kBlockM * 128 + col, 16, 1024),
              make_desc(ks + (kk / 4) * kBlockN * 128 + col, 16, 1024),
              kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<64>(s);

        // ---- mask: thread holds rows g, g+8 of its warp's 16, columns
        // 8j + 2*t4 + {0, 1} (s[4j..4j+1] row g, s[4j+2..4j+3] row g+8)
        if constexpr (Mode == kMasked) {
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const uint32_t two =
                *reinterpret_cast<const uint16_t*>(mk + 8 * j + 2 * t4);
            if (!(two & 0xff)) { s[4 * j] = kNegInf; s[4 * j + 2] = kNegInf; }
            if (!(two >> 8)) { s[4 * j + 1] = kNegInf; s[4 * j + 3] = kNegInf; }
          }
        }
        if (j0 + kBlockN > lim) {       // ragged tail: keys >= lim
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int col = j0 + 8 * j + 2 * t4;
            if (col >= lim) { s[4 * j] = kNegInf; s[4 * j + 2] = kNegInf; }
            if (col + 1 >= lim) { s[4 * j + 1] = kNegInf; s[4 * j + 3] = kNegInf; }
          }
        }

        // ---- online softmax ----
        float m_new[2] = {m_run[0], m_run[1]};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          m_new[0] = fmaxf(m_new[0], fmaxf(s[4 * j], s[4 * j + 1]));
          m_new[1] = fmaxf(m_new[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
        float alpha[2], m_l2[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          m_new[h] = fmaxf(m_new[h], __shfl_xor_sync(0xffffffffu, m_new[h], 1));
          m_new[h] = fmaxf(m_new[h], __shfl_xor_sync(0xffffffffu, m_new[h], 2));
          alpha[h] = ex2((m_run[h] - m_new[h]) * kLog2e);
          m_run[h] = m_new[h];
          m_l2[h] = m_new[h] * kLog2e;
        }
        bool dead[2] = {false, false};
        if constexpr (Mode == kMasked) {  // no valid key yet in this row
          dead[0] = m_run[0] <= 0.5f * kNegInf;
          dead[1] = m_run[1] <= 0.5f * kNegInf;
        }
        uint32_t pf[8][4];              // P as the A fragments of P V
        float l_cur[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          float p0 = ex2(fmaf(s[4 * j], kLog2e, -m_l2[0]));
          float p1 = ex2(fmaf(s[4 * j + 1], kLog2e, -m_l2[0]));
          float p2 = ex2(fmaf(s[4 * j + 2], kLog2e, -m_l2[1]));
          float p3 = ex2(fmaf(s[4 * j + 3], kLog2e, -m_l2[1]));
          if constexpr (Mode == kMasked) {
            if (dead[0]) p0 = p1 = 0.f;
            if (dead[1]) p2 = p3 = 0.f;
          }
          l_cur[0] += p0 + p1;
          l_cur[1] += p2 + p3;
          // C fragment of 8-column chunk j -> half of the A fragment of
          // k-step j/2 (a0, a2: row g; a1, a3: row g+8)
          pf[j / 2][(j & 1) * 2 + 0] = pack_bf16(p0, p1);
          pf[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
        }
        l_part[0] = l_part[0] * alpha[0] + l_cur[0];
        l_part[1] = l_part[1] * alpha[1] + l_cur[1];

        // ---- O = O * alpha + P V ----
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[4 * j] *= alpha[0];
          acc[4 * j + 1] *= alpha[0];
          acc[4 * j + 2] *= alpha[1];
          acc[4 * j + 3] *= alpha[1];
        }
        fence_regs<D / 2>(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBlockN / 16; ++kk) {
          // keys 16kk..16kk+15; V chunks of 64 columns are kBlockN*128 B apart
          const uint64_t dv = make_desc(vs + kk * 16 * 128, kBlockN * 128, 1024);
          if constexpr (D == 128)
            wgmma_rs_n128(acc, pf[kk], dv);
          else
            wgmma_rs_n64(acc, pf[kk], dv);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<D / 2>(acc);
      }
      mbar_arrive(kv_empty + 8 * st);
      if (++st == kStages) { st = 0; ph ^= 1; }
    }

    // ---- normalise and write bf16 (table mode: and the logsumexp) ----
    float l_row[2], inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = l_part[h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      l_row[h] = l;
      inv[h] = 1.f / (l == 0.f ? 1.f : l);
    }
    const int r0 = q0 + wg * 64 + warp * 16 + g;
    const int r1 = r0 + 8;
    __nv_bfloat16* ob = o + b * osb + n * osn;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + 2 * t4;
      if (r0 < L)
        *reinterpret_cast<uint32_t*>(ob + (long long)r0 * osl + c) =
            pack_bf16(acc[4 * j] * inv[0], acc[4 * j + 1] * inv[0]);
      if (r1 < L)
        *reinterpret_cast<uint32_t*>(ob + (long long)r1 * osl + c) =
            pack_bf16(acc[4 * j + 2] * inv[1], acc[4 * j + 3] * inv[1]);
    }
    if constexpr (Mode == kTable) {
      if (tb.lse != nullptr && t4 == 0) {
        float* lb = tb.lse + ((long long)b * gridDim.y + n) * L;
        if (r0 < L)
          lb[r0] = l_row[0] > 0.f ? m_run[0] + logf(l_row[0]) : kNegInf;
        if (r1 < L)
          lb[r1] = l_row[1] > 0.f ? m_run[1] + logf(l_row[1]) : kNegInf;
      }
    }
  }
}

// ---------------------------------------------------------------- host side

// 4-D map over a [B, rows, N, D] bf16 tensor with element strides
// (sb, sl, sn) and unit stride on D; box: 64 columns x box_rows rows of
// one (n, b).  Returns 0 or a cudaError.
int make_map(CUtensorMap* map, const void* ptr, int B, int rows, int N,
             int D, long long sb, long long sl, long long sn, int box_rows) {
  EncodeTiledFn encode = encode_fn();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)N, (cuuint64_t)rows,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sn * 2, (cuuint64_t)sl * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                      const_cast<void*>(ptr), dims, strides, box, elem,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : cudaErrorInvalidValue;
}

// q: [B, L, N, D], k/v: [B, S, N, D], o: [B, L, N, D]; st: 12 element
// strides (b, l, n) of q, k, v and o.  Returns 0 or a cudaError.
template <int D, int Mode, int kConsumers>
int launch(const void* q, const void* k, const void* v, const void* kvm,
           long long msb, const TableArgs& tb, void* o, int B, int L, int S,
           int N, const long long* st, float scale, cudaStream_t stream) {
  using Lay = Layout<D, Mode, kConsumers>;
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, B, L, N, D, st[0], st[1], st[2], Lay::kBlockM);
  if (!err) err = make_map(&tk, k, B, S, N, D, st[3], st[4], st[5], kBlockN);
  if (!err) err = make_map(&tv, v, B, S, N, D, st[6], st[7], st[8], kBlockN);
  if (err) return err;
  auto kernel = flash_fwd_kernel<D, Mode, kConsumers>;
  static bool opted_in[64] = {};
  err = opt_in_smem(kernel, Lay::kBytes, opted_in);
  if (err) return err;
  dim3 grid((L + Lay::kBlockM - 1) / Lay::kBlockM, N, B);
  kernel<<<grid, Lay::kThreads, Lay::kBytes, stream>>>(
      tq, tk, tv, static_cast<const uint8_t*>(kvm), msb, tb,
      static_cast<__nv_bfloat16*>(o), st[9], st[10], st[11], L, S, scale);
  return cudaGetLastError();
}

}  // namespace
