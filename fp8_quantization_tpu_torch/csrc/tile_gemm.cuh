// The tiled GEMM shared by the fused-quant GEMM (K2, fused_matmul.cu) and
// the packed-FP8 dequant GEMM (K4, dequant_matmul.cu):
//
//   out = requant(load_x(x) @ load_w(w))
//
// The two kernels differ only in how a tile is loaded: x arrives as f32
// (quantized on the load by quantize_block when asked, then rounded to bf16),
// as bf16, or as 1-byte ExMy codes with per-tensor decode constants; w
// arrives as bf16 grid values (K2) or as 1-byte ExMy codes with per-column
// decode constants (K4). Every operand is rounded to bf16 on the load, as the
// TPU kernels feed the MXU bf16, and widened to f32 in shared memory.
//
// Accumulation: one f32 accumulator per output element, k ascending, by
// fmaf. A product of two bf16 values has at most 16 significant bits, so it
// is exact in f32 and the fused multiply-add rounds exactly as a separate
// multiply and add would: the kernel equals, bit for bit, the plain version's
// sequential f32 sum (ops/cuda/fused_matmul.py::sequential_matmul).
//
// What bounds it on an H100: at the ViT-B/16 shapes (K = 768 or 3072) the
// CUDA-core FMA rate, not the bytes (each operand tile is read once per
// 64-wide output tile). Tensor cores would sum in another order and lose the
// bit-exact contract with the plain version; wgmma/TMA tiles are later work.
// The design: 64x64 output tiles of 256 threads, each thread a 4x4 block of
// accumulators in registers fed by two 16-byte shared loads per k; operands
// are converted (quantized, decoded) once, when their K-slice is staged.

#pragma once

#include "exmy.cuh"

namespace fp8q {

constexpr int GEMM_BM = 64;
constexpr int GEMM_BN = 64;
constexpr int GEMM_BK = 16;
constexpr int GEMM_TX = 16;
constexpr int GEMM_TY = 16;
constexpr int GEMM_THREADS = GEMM_TX * GEMM_TY;
constexpr int GEMM_PAD = 4;  // keeps rows 16-byte aligned for float4 loads

enum XMode { X_F32 = 0, X_BF16 = 1, X_CODES = 2 };
enum WMode { W_BF16 = 0, W_CODES = 1 };

struct GemmArgs {
  const void* x;  // (M, K) row-major: f32, bf16 or uint8 codes
  const void* w;  // (K, N) row-major: bf16 or uint8 codes
  void* out;      // (M, N) row-major: f32 or bf16
  int M, N, K;
  int quantize_x, requantize_out;
  const float* act_f;
  const int* act_i;
  const float* res_f;
  const int* res_i;
  int x_expo, x_mant;        // coded x: field widths
  const int* x_bias;         // coded x: (1,) int32 packing bias
  int w_expo, w_mant;        // coded w: field widths
  const int* w_bias;         // coded w: (N,) int32 packing biases
};

template <int XM, int WM, bool OUT_BF16>
__global__ void __launch_bounds__(GEMM_THREADS) tile_gemm_kernel(GemmArgs g) {
  __shared__ __align__(16) float a_s[GEMM_BK][GEMM_BM + GEMM_PAD];
  __shared__ __align__(16) float b_s[GEMM_BK][GEMM_BN + GEMM_PAD];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * GEMM_TX + tx;
  const int m0 = blockIdx.y * GEMM_BM;
  const int n0 = blockIdx.x * GEMM_BN;
  const int M = g.M, N = g.N, K = g.K;

  QParams act{0.f, 0, 0, 0};
  if (XM == X_F32 && g.quantize_x) act = load_qparams(g.act_f, g.act_i);
  // decode constants in registers: per tensor for x, per column for w
  int x_eb = 0;
  float x_ss = 0.f;
  if (XM == X_CODES) unpack_consts(*g.x_bias, g.x_mant, x_eb, x_ss);
  // the B column this thread stages is the same for every K-slice
  const int b_col = tid % GEMM_BN;
  const int b_n = n0 + b_col;
  int w_eb = 0;
  float w_ss = 0.f;
  if (WM == W_CODES && b_n < N) unpack_consts(g.w_bias[b_n], g.w_mant, w_eb, w_ss);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += GEMM_BK) {
    // stage the x slice (BM x BK), transposed to K-major; out-of-range
    // entries stage as 0 and are never summed (the k loop stops at K)
#pragma unroll
    for (int s = 0; s < GEMM_BM * GEMM_BK / GEMM_THREADS; ++s) {
      const int i = tid + s * GEMM_THREADS;
      const int r = i / GEMM_BK, c = i % GEMM_BK;
      const int gm = m0 + r, gk = k0 + c;
      float v = 0.f;
      if (gm < M && gk < K) {
        const size_t off = (size_t)gm * K + gk;
        if (XM == X_F32) {
          v = static_cast<const float*>(g.x)[off];
          if (g.quantize_x) v = quantize_block(v, act);
          v = round_bf16(v);
        } else if (XM == X_BF16) {
          v = __bfloat162float(static_cast<const __nv_bfloat16*>(g.x)[off]);
        } else {
          const int code = static_cast<const unsigned char*>(g.x)[off];
          v = round_bf16(unpack_exmy_bits(code, g.x_expo, g.x_mant, x_eb, x_ss));
        }
      }
      a_s[c][r] = v;
    }
    // stage the w slice (BK x BN)
#pragma unroll
    for (int s = 0; s < GEMM_BK * GEMM_BN / GEMM_THREADS; ++s) {
      const int r = (tid + s * GEMM_THREADS) / GEMM_BN;
      const int gk = k0 + r;
      float v = 0.f;
      if (gk < K && b_n < N) {
        const size_t off = (size_t)gk * N + b_n;
        if (WM == W_BF16) {
          v = __bfloat162float(static_cast<const __nv_bfloat16*>(g.w)[off]);
        } else {
          const int code = static_cast<const unsigned char*>(g.w)[off];
          v = round_bf16(unpack_exmy_bits(code, g.w_expo, g.w_mant, w_eb, w_ss));
        }
      }
      b_s[r][b_col] = v;
    }
    __syncthreads();

    const int kmax = min(GEMM_BK, K - k0);
    if (kmax == GEMM_BK) {
#pragma unroll
      for (int kk = 0; kk < GEMM_BK; ++kk) {
        const float4 a4 = *reinterpret_cast<const float4*>(&a_s[kk][ty * 4]);
        const float4 b4 = *reinterpret_cast<const float4*>(&b_s[kk][tx * 4]);
        const float av[4] = {a4.x, a4.y, a4.z, a4.w};
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
      }
    } else {
      for (int kk = 0; kk < kmax; ++kk) {
        const float4 a4 = *reinterpret_cast<const float4*>(&a_s[kk][ty * 4]);
        const float4 b4 = *reinterpret_cast<const float4*>(&b_s[kk][tx * 4]);
        const float av[4] = {a4.x, a4.y, a4.z, a4.w};
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  QParams res{0.f, 0, 0, 0};
  if (g.requantize_out) res = load_qparams(g.res_f, g.res_i);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn >= N) continue;
      float v = acc[i][j];
      if (g.requantize_out) v = quantize_block(v, res);
      const size_t off = (size_t)gm * N + gn;
      if (OUT_BF16) {
        static_cast<__nv_bfloat16*>(g.out)[off] = __float2bfloat16_rn(v);
      } else {
        static_cast<float*>(g.out)[off] = v;
      }
    }
  }
}

template <int XM, int WM, bool OUT_BF16>
inline void launch_tile_gemm(const GemmArgs& g, cudaStream_t stream) {
  const dim3 grid((g.N + GEMM_BN - 1) / GEMM_BN, (g.M + GEMM_BM - 1) / GEMM_BM);
  tile_gemm_kernel<XM, WM, OUT_BF16><<<grid, dim3(GEMM_TX, GEMM_TY), 0, stream>>>(g);
}

template <int XM, int WM>
inline void launch_for_out(const GemmArgs& g, int out_bf16, cudaStream_t stream) {
  if (out_bf16) launch_tile_gemm<XM, WM, true>(g, stream);
  else launch_tile_gemm<XM, WM, false>(g, stream);
}

// Launch for runtime (x mode, out dtype); the w mode is the caller's. Coded
// x exists only beside coded w (K4), so K2 builds four instances, K4 six.
template <int WM>
inline int dispatch_tile_gemm(const GemmArgs& g, int x_mode, int out_bf16,
                              cudaStream_t stream) {
  if (g.M <= 0 || g.N <= 0) return (int)cudaSuccess;
  if ((g.M + GEMM_BM - 1) / GEMM_BM > 65535) return (int)cudaErrorInvalidValue;
  if (x_mode == X_F32) {
    launch_for_out<X_F32, WM>(g, out_bf16, stream);
  } else if (x_mode == X_BF16) {
    launch_for_out<X_BF16, WM>(g, out_bf16, stream);
  } else if constexpr (WM == W_CODES) {
    if (x_mode != X_CODES) return (int)cudaErrorInvalidValue;
    launch_for_out<X_CODES, WM>(g, out_bf16, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace fp8q
