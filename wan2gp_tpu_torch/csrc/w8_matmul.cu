// int8-weight matmuls for Hopper (sm_90a).
//
// W8: y = (x @ dequant(w_q)) * scale.  Replaces the Pallas kernel
// wan2gp_tpu/ops/quant.py::_w8_kernel (launched by matmul_w8).  Same
// numerics: x is bf16, the int8 weight is converted exactly to bf16 inside
// the CTA (|w| <= 127), the product accumulates in fp32, the
// per-output-column fp32 scale is applied at writeback and the result is
// rounded once to bf16.
//
// W8A8: y = (acc * sw) * sx with acc = x_q @ w_q in int32.  Replaces the
// Pallas kernel wan2gp_tpu/ops/quant.py::_w8a8_kernel (launched by
// matmul_w8a8): x_q are the per-row int8 activations of quantize_act_int8
// (csrc/act_quant.cu) and sx their fp32 row scales, sw the per-column
// weight scales; both are applied in fp32, in that order, before the bf16
// store.  The int32 product is exact (|acc| <= 127 * 127 * K < 2^31), so
// with the same x_q and sx the output is the plain version's bit for bit.
//
// What bounds them: at the Wan DiT token counts (M = B*L in the tens of
// thousands, K and N in the thousands) the 2*M*K*N operations on the
// tensor cores (989 TFLOP/s bf16 for W8, 1,979 TOP/s int8 for W8A8); the
// weight is read at 1 byte per element, which matters when M is small.
//
// Design: the CTA of wo_matmul.cuh (kInt4 = false; kA8 false for W8, true
// for W8A8): it computes y^T = w^T x^T so that the weight is wgmma's A
// operand from registers.  A producer warp keeps a TMA ring of x (two
// 64-byte boxes a stage: 32 bf16 or 64 int8 columns each) and raw int8
// weight tiles (64 or 128 rows x 128 columns); each of two consumer
// warpgroups reads its 64 columns' raw fragment with ldmatrix.trans and
// makes the A fragment in registers while the previous wgmmas run: W8
// converts it to bf16 for wgmma m64n256k16, W8A8 transposes its bytes with
// prmt for the s8 wgmma m64n256k32 (m64n128 in the narrow variant for
// small M).  y goes out through a TMA store.  The wrappers pad K to a
// multiple of 8 (W8) or 16 (W8A8) and N to one of 16 where a caller's
// shape needs it; ragged M, N and K tiles are the TMA unit's zero fill.
#include "wo_matmul.cuh"

namespace {

template <bool kA8, int kBM>
__global__ void __launch_bounds__(WoLayout<false, kA8, kBM>::kThreads, 1)
w8_matmul_kernel(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tw,
                 const __grid_constant__ CUtensorMap ty,
                 const float* __restrict__ scale, const float* __restrict__ sx,
                 int M, int N, int n_steps, int kh) {
  wo_matmul_body<false, kA8, kBM>(tx, tw, ty, scale, sx, M, N, n_steps, kh);
}

template <bool kA8>
int w8_dispatch(const void* x, const void* sx, const void* w_q,
                const void* scale, void* y, int M, int N, int K,
                cudaStream_t s) {
  if (wo_narrow(M, N))
    return wo_launch<false, kA8, 128>(w8_matmul_kernel<kA8, 128>, x, w_q,
                                      scale, sx, y, M, N, K, K, 0, s);
  return wo_launch<false, kA8, 256>(w8_matmul_kernel<kA8, 256>, x, w_q, scale,
                                    sx, y, M, N, K, K, 0, s);
}

}  // namespace

// x: [M, K] bf16 row-major; w_q: [K, N] int8 row-major; scale: [N] fp32;
// y: [M, N] bf16 row-major.  All contiguous, 16-byte aligned, K % 8 == 0
// and N % 16 == 0 (what the TMA maps take; cudaErrorInvalidValue else).
extern "C" int wg_w8_matmul_bf16(const void* x, const void* w_q,
                                 const void* scale, void* y, int M, int N,
                                 int K, void* stream) {
  if (!wo_layout_ok(x, w_q, scale, y, M, N, K, 8))
    return cudaErrorInvalidValue;
  return w8_dispatch<false>(x, nullptr, w_q, scale, y, M, N, K,
                            static_cast<cudaStream_t>(stream));
}

// x_q: [M, K] int8; sx: [M] fp32; w_q: [K, N] int8; sw: [N] fp32; y: [M, N]
// bf16.  All contiguous, row-major, 16-byte aligned (sx: 4-byte), K % 16 ==
// 0 and N % 16 == 0 (cudaErrorInvalidValue else).
extern "C" int wg_w8a8_matmul(const void* x_q, const void* sx, const void* w_q,
                              const void* sw, void* y, int M, int N, int K,
                              void* stream) {
  if (!wo_layout_ok(x_q, w_q, sw, y, M, N, K, 16)
      || reinterpret_cast<uintptr_t>(sx) % 4 != 0)
    return cudaErrorInvalidValue;
  return w8_dispatch<true>(x_q, sx, w_q, sw, y, M, N, K,
                           static_cast<cudaStream_t>(stream));
}
