// The bit-ops ExMy quantizer (K1) and the fused quantize -> GEMM ->
// requantize kernel (K2) for Hopper.
//
// K1 replaces fp8_quantization_tpu/ops/pallas/fused_matmul.py::quantize_block
// as a standalone elementwise kernel over a contiguous f32 tensor with
// per-tensor scalars (its body, exmy.cuh::quantize_block, also runs inside
// K2 and K4). What bounds it: bytes, 4 read and 4 written per element; each
// thread handles four neighbouring elements with 16-byte loads and stores
// where the tensor's start allows, so the kernel streams at the HBM rate.
//
// K2 replaces fp8_quantization_tpu/ops/pallas/fused_matmul.py::
// fused_quant_matmul: requant(quantize(x) @ w_q) with w_q bf16 grid values,
// through tile_gemm.cuh: one launch, bit-exact streaming for small M (route
// A, decode) and tensor-core tiles above (route B, ViT and prefill); see
// there for what bounds each route, its design and its numerics contract.
//
// Plain versions: fp8_quantization_tpu_torch/ops/cuda/fused_matmul.py.

#include "tile_gemm.cuh"

namespace {

__global__ void quantize_block_kernel(const float* __restrict__ x, float* __restrict__ out,
                                      long long n, const float* qf, const int* qi) {
  const fp8q::QParams p = fp8q::load_qparams(qf, qi);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const bool vec = ((reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(out)) & 15) == 0;
  const long long n4 = vec ? n / 4 : 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += stride) {
    float4 v = reinterpret_cast<const float4*>(x)[i];
    v.x = fp8q::quantize_block(v.x, p);
    v.y = fp8q::quantize_block(v.y, p);
    v.z = fp8q::quantize_block(v.z, p);
    v.w = fp8q::quantize_block(v.w, p);
    reinterpret_cast<float4*>(out)[i] = v;
  }
  for (long long i = 4 * n4 + (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = fp8q::quantize_block(x[i], p);
  }
}

}  // namespace

// K1. x, out: n contiguous f32 (out may alias x); qf: [maxval] f32,
// qi: [bias, mant, sign] int32, on the device. Returns cudaGetLastError().
extern "C" int fp8q_quantize_block(const float* x, float* out, long long n,
                                   const float* qf, const int* qi, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int threads = 256;
  const long long want = (n / 4 + threads) / threads;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  quantize_block_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, n, qf, qi);
  return (int)cudaGetLastError();
}

// K2. route_a_max_m: the largest M that takes route A (at most 16);
// x: (M,K) f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); w: (K,N) bf16;
// out: (M,N) f32 or bf16 (out_bf16). act_*/res_* as for K1, read only when
// quantize_x / requantize_out. Returns cudaGetLastError().
extern "C" int fp8q_fused_quant_matmul(const void* x, const void* w, void* out, int M,
                                       int N, int K, int route_a_max_m, int x_bf16,
                                       int out_bf16, int quantize_x, int requantize_out,
                                       const float* act_f, const int* act_i,
                                       const float* res_f, const int* res_i,
                                       void* stream) {
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
  return fp8q::dispatch_gemm<fp8q::W_BF16>(g, x_bf16 ? fp8q::X_BF16 : fp8q::X_F32, out_bf16,
                                           static_cast<cudaStream_t>(stream));
}
