// ExMy device functions shared by the quantize, fused-quant GEMM and
// dequant GEMM kernels (fused_matmul.cu, dequant_matmul.cu).
//
// Ports of fp8_quantization_tpu/ops/pallas/fused_matmul.py::quantize_block
// and fp8_quantization_tpu/numerics/codec.py::unpack_exmy_bits. Plain
// versions: fp8_quantization_tpu_torch/ops/cuda/fused_matmul.py::
// quantize_block_plain and numerics/codec.py::unpack_exmy_bits.
//
// Numerics: powers of two come from the exponent field only, rounding is
// rintf (half-to-even), and integer arithmetic on biases is done unsigned so
// that it wraps in two's complement as XLA's and PyTorch's int32 does (the
// +inf bias of a site that saw only zeros saturates to 2^31-1 and must wrap
// the same way). Build with -fmad=false and without --use_fast_math.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fp8q {

// Per-tensor FP quantizer scalars (fastpath.ScalarQuantParams).
struct QParams {
  float maxval;
  int bias;
  int mant;
  int sign;
};

// f: [maxval]; i: [bias, mant, sign] (device memory).
__device__ __forceinline__ QParams load_qparams(const float* f, const int* i) {
  return QParams{f[0], i[0], i[1], i[2]};
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

// Elementwise ExMy fake-quantize by exponent bit-ops (K1's body):
//   xc    = clip(x, sign ? -maxval : 0, maxval)
//   ls    = max(ieee_exp(xc) + bias, 1)
//   sexp  = clip(ls - mant - bias + 127, 1, 254)      (f32 exponent field)
//   q     = rint(xc * 2^(127 - sexp)) * 2^(sexp - 127)
// The clip is written with comparisons so that NaN passes through, as in
// torch.maximum/minimum and jnp.clip.
__device__ __forceinline__ float quantize_block(float x, const QParams& p) {
  const float minval = p.sign == 1 ? -p.maxval : 0.0f;
  float xc = x < minval ? minval : x;
  xc = xc > p.maxval ? p.maxval : xc;
  const int e = (__float_as_int(xc) >> 23) & 0xFF;
  const int ls = max(wrap_add(e - 127, p.bias), 1);
  const int sexp = min(max(wrap_add(wrap_sub(wrap_sub(ls, p.mant), p.bias), 127), 1), 254);
  const float scale = __int_as_float(sexp << 23);
  const float inv_scale = __int_as_float((254 - sexp) << 23);
  return rintf(xc * inv_scale) * scale;
}

// Decode one ExMy byte code (s:1|e:ew|m:mw) by assembling the f32 bits:
// normal codes are (em << (23 - mw)) + ebase_bits, subnormal codes
// em * sub_scale, with the constants of unpack_consts below.
__device__ __forceinline__ float unpack_exmy_bits(int c, int ew, int mw, int ebase_bits,
                                                  float sub_scale) {
  const int em = c & ((1 << (ew + mw)) - 1);
  const float fnorm = __int_as_float(wrap_add((int)((unsigned)em << (23 - mw)), ebase_bits));
  const float fsub = (float)em * sub_scale;
  const float v = em >= (1 << mw) ? fnorm : fsub;
  return (c >> (ew + mw)) > 0 ? -v : v;
}

// The decode constants of a packing bias (codec.unpack_consts):
// ebase_bits = (127 - bias) << 23 and sub_scale = 2^(1 - bias - mw), both
// built from the exponent field with int32 wrap-around.
__device__ __forceinline__ void unpack_consts(int bias, int mw, int& ebase_bits,
                                              float& sub_scale) {
  ebase_bits = (int)((unsigned)wrap_sub(127, bias) << 23);
  sub_scale = __int_as_float((int)((unsigned)wrap_sub(wrap_sub(128, bias), mw) << 23));
}

// Round an f32 to the nearest bf16 (half-to-even) and widen it back.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

}  // namespace fp8q
