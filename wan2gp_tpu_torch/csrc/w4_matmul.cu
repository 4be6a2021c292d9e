// Split-K packed int4 weight matmuls for Hopper (sm_90a).
//
// Replaces two Pallas kernels that read the same packed weight:
//   wan2gp_tpu/ops/quant.py::_w4_kernel (launched by matmul_w4):
//     y = (x @ w) * scale, x bf16, fp32 accumulation, bf16 out;
//   wan2gp_tpu/ops/quant.py::_w4a8_kernel (launched by matmul_w4a8):
//     y = (acc * sw) * sx with acc = x_q @ w in int32, x_q the per-row int8
//     activations of quantize_act_int8 (csrc/act_quant.cu) and sx their
//     fp32 row scales; the integer product is exact, so with the same x_q
//     and sx the output is the plain version's bit for bit.
// The weight layout is quantize_int4's: packed int8 [KP/2, N], KP = K
// padded up to a multiple of 1024; packed row r holds original row r in its
// low nibble and row KP/2 + r in its high nibble, both sign-extended
// (lo = (p << 28) >> 28, hi = p >> 4 on the int32 value, as in the Pallas
// kernels).  x keeps its K columns: columns at K and beyond, where the
// weight holds zero padding, read as zeros (the TMA unit's zero fill).
//
// What bounds them: at the 14B shapes (M = 151,200 tokens, K and N 5,120 or
// 13,824) the 2*M*K*N operations on the tensor cores bound both (989
// TFLOP/s bf16 for W4, 1,979 TOP/s int8 for W4A8); the weight is read at
// half a byte per element.  At the cross-attention's M = 1,024 the weight
// read matters more, which is what int4 saves.
//
// Design: the CTA of wo_matmul.cuh (kInt4 = true; kA8 false for W4, true
// for W4A8): it computes y^T = w^T x^T so that the weight is wgmma's A
// operand from registers.  A producer warp keeps a TMA ring of x (the
// 64-byte boxes at columns p0 and KP/2 + p0: 32 bf16 or 64 int8 columns
// each) and raw packed tiles (32 or 64 packed rows x 128 columns); each of
// two consumer warpgroups reads its 64 columns' fragment with
// ldmatrix.trans and makes the A fragments of the low nibbles (steps
// against the p0 box) and the high nibbles (against the KP/2 + p0 box) in
// registers while the previous wgmmas run: W4 converts them to bf16 for
// wgmma m64n256k16, W4A8 transposes the bytes with prmt and keeps each
// nibble as an s8 byte of 16 * v for the s8 wgmma m64n256k32 (m64n128 in
// the narrow variant for small M); y goes out through a TMA store.  The
// wrapper pads K to a multiple of 8 (W4) or 16 (W4A8), N to one of 16 and
// KP/2 to one of 32 (W4) or 64 (W4A8) where a caller's shape needs it.
#include "wo_matmul.cuh"

namespace {

template <bool kA8, int kBM>
__global__ void __launch_bounds__(WoLayout<true, kA8, kBM>::kThreads, 1)
w4_matmul_kernel(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tw,
                 const __grid_constant__ CUtensorMap ty,
                 const float* __restrict__ scale, const float* __restrict__ sx,
                 int M, int N, int n_steps, int kh) {
  wo_matmul_body<true, kA8, kBM>(tx, tw, ty, scale, sx, M, N, n_steps, kh);
}

template <bool kA8>
int w4_dispatch(const void* x, const void* sx, const void* w_p,
                const void* scale, void* y, int M, int N, int K, int KH,
                cudaStream_t s) {
  if (wo_narrow(M, N))
    return wo_launch<true, kA8, 128>(w4_matmul_kernel<kA8, 128>, x, w_p,
                                     scale, sx, y, M, N, K, KH, KH, s);
  return wo_launch<true, kA8, 256>(w4_matmul_kernel<kA8, 256>, x, w_p, scale,
                                   sx, y, M, N, K, KH, KH, s);
}

}  // namespace

// x: [M, K] bf16; w_p: [KP/2, N] packed int8 (KP >= K, KP/2 = KH); scale:
// [N] fp32; y: [M, N] bf16.  All contiguous, row-major, 16-byte aligned,
// K % 8 == 0, N % 16 == 0 and KH % 32 == 0 (what the TMA maps take;
// cudaErrorInvalidValue else).
extern "C" int wg_w4_matmul_bf16(const void* x, const void* w_p,
                                 const void* scale, void* y, int M, int N,
                                 int K, int KH, void* stream) {
  if (2 * KH < K || KH % 32 != 0
      || !wo_layout_ok(x, w_p, scale, y, M, N, K, 8))
    return cudaErrorInvalidValue;
  return w4_dispatch<false>(x, nullptr, w_p, scale, y, M, N, K, KH,
                            static_cast<cudaStream_t>(stream));
}

// x_q: [M, K] int8; sx: [M] fp32 (4-byte aligned); w_p, sw: as above; y:
// [M, N] bf16.  K % 16 == 0, N % 16 == 0 and KH % 64 == 0
// (cudaErrorInvalidValue else).
extern "C" int wg_w4a8_matmul(const void* x_q, const void* sx,
                              const void* w_p, const void* sw, void* y, int M,
                              int N, int K, int KH, void* stream) {
  if (2 * KH < K || KH % 64 != 0
      || !wo_layout_ok(x_q, w_p, sw, y, M, N, K, 16)
      || reinterpret_cast<uintptr_t>(sx) % 4 != 0)
    return cudaErrorInvalidValue;
  return w4_dispatch<true>(x_q, sx, w_p, sw, y, M, N, K, KH,
                           static_cast<cudaStream_t>(stream));
}
