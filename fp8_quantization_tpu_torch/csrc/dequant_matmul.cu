// The packed-FP8 dequant GEMM (K4) for Hopper.
//
// Replaces fp8_quantization_tpu/ops/pallas/dequant_matmul.py::dequant_matmul:
// requant(quantize(x) @ decode(w_codes)) with w_codes (K,N) uint8 ExMy codes
// and a per-column packing bias. x is bf16, f32 (optionally quantized by
// exmy.cuh::quantize_block on the load) or uint8 codes with a per-tensor
// packing bias (chained serving). The weights stream at 1 byte each and are
// decoded on chip: route A (small M, decode) reads each code's bf16 value
// from a per-CTA table of its 32 columns, route B (larger M) decodes a staged
// K-slice into the swizzled bf16 tile with the per-column (ebase_bits,
// sub_scale) constants in registers. The routes are tile_gemm.cuh's, shared
// with K2 (see there for what bounds each, its design and its numerics
// contract). Out-of-range rows, columns and K entries are masked or
// zero-filled in the kernel instead of padded.
//
// Plain version: fp8_quantization_tpu_torch/ops/cuda/dequant_matmul.py::
// dequant_matmul_plain.

#include "tile_gemm.cuh"

// route_a_max_m: the largest M that takes route A (at most 16);
// x_mode: 0 f32, 1 bf16, 2 uint8 codes (x_expo, x_mant, x_bias: (1,) int32);
// w: (K,N) uint8 codes with (N,) int32 w_bias; out f32 or bf16 (out_bf16);
// act_*/res_* [maxval] f32 and [bias, mant, sign] int32, read only when
// quantize_x / requantize_out. Returns cudaGetLastError().
extern "C" int fp8q_dequant_matmul(const void* x, const unsigned char* w, void* out, int M,
                                   int N, int K, int route_a_max_m, int x_mode,
                                   int out_bf16, int quantize_x, int requantize_out,
                                   const float* act_f, const int* act_i, const float* res_f,
                                   const int* res_i, int w_expo, int w_mant,
                                   const int* w_bias, int x_expo, int x_mant,
                                   const int* x_bias, void* stream) {
  if (w_mant < 0 || w_mant > 23 || (x_mode == fp8q::X_CODES && (x_mant < 0 || x_mant > 23)))
    return (int)cudaErrorInvalidValue;
  fp8q::GemmArgs g{};
  g.x = x;
  g.w = w;
  g.out = out;
  g.M = M;
  g.N = N;
  g.K = K;
  g.route_a_max_m = route_a_max_m;
  g.quantize_x = quantize_x;
  g.requantize_out = requantize_out;
  g.act_f = act_f;
  g.act_i = act_i;
  g.res_f = res_f;
  g.res_i = res_i;
  g.x_expo = x_expo;
  g.x_mant = x_mant;
  g.x_bias = x_bias;
  g.w_expo = w_expo;
  g.w_mant = w_mant;
  g.w_bias = w_bias;
  return fp8q::dispatch_gemm<fp8q::W_CODES>(g, x_mode, out_bf16,
                                            static_cast<cudaStream_t>(stream));
}
