// Approximate-multiplier GEMM (v9 float-domain semantics) for Hopper.
//
// Replaces fp8_quantization_tpu/ops/pallas/approx_matmul.py::approx_matmul_pallas
// (its _approx_kernel). Plain version and oracle:
// fp8_quantization_tpu_torch/numerics/approx_matmul.py::approx_matmul_golden.
//
// Per partial product a[m,k] * b[k,n]:
//   golden   = a*b, requantized onto ExMy(bias_r)               [quant_btw]
//   approx   = 2^(ea+eb-(bA+bB[n]-bR)-bR) * [(1+ma*s)(1+mb*s) - s*LUT[ma,mb]] * sign
//   out      = both operands and golden normal ? approx : golden
//              (with_s2nn2s_opt: subnormal operands are scaled up by 2^M
//               before decomposition, the product scaled back down, and a
//               zero raw product stays zero)
//   acc     += out, requantized onto ExMy(bias_r)                 [quant_btw]
//
// What bounds it: CUDA-core instruction issue. Every product is some tens
// of integer and float instructions (two codec requantizations, a LUT
// gather, exponent bit-ops) and no tensor-core instruction can do them, so
// the bytes moved (each operand read once per 64-wide output tile) are far
// below the memory roofline. The design spends instructions only per
// product: each operand is decomposed into (expo, mant, frac) ONCE when its
// K-slice is staged in shared memory, not once per product; the LUT
// (pre-multiplied by s, at most 32x32) lives in shared memory; each thread
// keeps a 4x4 block of f32 accumulators in registers so every staged
// operand read from shared memory feeds four products.
//
// Numerics: powers of two come from the exponent field only (pow2i), never
// exp2f/ldexpf/powf; rounding is rintf (half-to-even); the codec clamps at
// binade tops without carrying into the exponent. Build with -fmad=false
// and without --use_fast_math (which would flush the subnormals the
// subnormal branches depend on), so only the summation order over K
// separates this kernel from its plain version.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;            // output rows per block
constexpr int BN = 64;            // output columns per block
constexpr int BK = 16;            // K-slice staged in shared memory
constexpr int TX = 16;            // threads along N
constexpr int TY = 16;            // threads along M
constexpr int RM = BM / TY;       // rows per thread
constexpr int RN = BN / TX;       // columns per thread
constexpr int MAX_NM = 32;        // 2^M for M <= 5
constexpr int S2_FLAG = 1 << 8;   // packed beside the mantissa field

__device__ __forceinline__ float pow2i(int e) {
  return __int_as_float(min(max(e + 127, 1), 254) << 23);
}

__device__ __forceinline__ int ieee_exp(float x) {
  return ((__float_as_int(x) >> 23) & 0xFF) - 127;
}

// Round v onto the ExMy(bias) grid: codec semantics (no carry at binade
// tops; the exponent extends past the field unless clip_of).
template <bool CLIP_OF>
__device__ __forceinline__ float requant(float v, int bias, int mw, float max_norm) {
  if (CLIP_OF) v = fminf(fmaxf(v, -max_norm), max_norm);
  const int eb = ieee_exp(v) + bias;
  const int ls = max(eb, 1);
  float units = rintf(fabsf(v) * pow2i(mw + bias - ls));
  units = fminf(units, (float)(eb < 1 ? (1 << mw) - 1 : (2 << mw) - 1));
  return (v < 0.f ? -units : units) * pow2i(ls - mw - bias);
}

// (expo field, mantissa field | S2_FLAG, significand) of ExMy(bias).
template <bool S2NN2S>
__device__ __forceinline__ void decompose(float x, int bias, int mw,
                                          int& expo, int& mant, float& frac) {
  int flag = 0;
  if (S2NN2S && fabsf(x) < pow2i(1 - bias)) {
    x = x * (float)(1 << mw);
    flag = S2_FLAG;
  }
  const int e = ieee_exp(x);
  const bool sub = e + bias < 1;
  const float ax = fabsf(x);
  const float m_norm = rintf((ax * pow2i(-e) - 1.0f) * (float)(1 << mw));
  const float m_sub = rintf(ax * pow2i(bias - 1 + mw));
  // The lower clamp keeps the LUT index in bounds. m_norm is negative only
  // for a zero that a degenerate bias counts as normal (a site that saw only
  // zeros has maxval 0 and bias +inf); its product is zero, so the output
  // takes the golden value (or 0 under s2nn2s) and this mantissa is unused.
  const float m = fminf(fmaxf(sub ? m_sub : m_norm, 0.f), (float)((1 << mw) - 1));
  expo = sub ? 0 : e + bias;
  mant = (int)m | flag;
  frac = m * (1.0f / (float)(1 << mw)) + (sub ? 0.f : 1.f);
}

template <bool WITH_APPROX, bool QUANT_BTW, bool CLIP_OF, bool S2NN2S>
__global__ void __launch_bounds__(TX * TY)
approx_matmul_kernel(const float* __restrict__ A, const float* __restrict__ B,
                     const int* __restrict__ bias_a_p, const int* __restrict__ bias_b,
                     const int* __restrict__ bias_r_p, const int* __restrict__ lut,
                     float* __restrict__ C, int M, int N, int K, int expo_width,
                     int mw) {
  // A-side arrays padded by one column so the staging stores (consecutive
  // threads walk K) fall in distinct banks
  __shared__ float a_val[BK][BM + 1];
  __shared__ float a_frac[BK][BM + 1];
  __shared__ int a_expo[BK][BM + 1];
  __shared__ int a_mant[BK][BM + 1];
  __shared__ float b_val[BK][BN];
  __shared__ float b_frac[BK][BN];
  __shared__ int b_expo[BK][BN];
  __shared__ int b_mant[BK][BN];
  __shared__ float lut_s[MAX_NM * MAX_NM];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int nm = 1 << mw;
  const float s = 1.0f / (float)nm;
  for (int i = tid; i < nm * nm; i += TX * TY) lut_s[i] = s * (float)lut[i];

  const int bias_a = *bias_a_p;
  const int bias_r = *bias_r_p;
  const float min_norm_r = pow2i(1 - bias_r);
  const float max_norm_r = pow2i((1 << expo_width) - 1 - bias_r) * (2.0f - s);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  int cneg[RN];  // -(bias_a + bias_b[n]): the product's exponent offset
#pragma unroll
  for (int j = 0; j < RN; ++j) {
    const int n = n0 + tx + j * TX;
    cneg[j] = -(bias_a + (n < N ? bias_b[n] : 0));
  }

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // Stage and decompose the A slice (BM x BK) and the B slice (BK x BN).
    // Out-of-range entries stage as 0, whose products contribute exactly 0.
    for (int i = tid; i < BM * BK; i += TX * TY) {
      const int r = i / BK, c = i % BK;
      const int gm = m0 + r, gk = k0 + c;
      const float x = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : 0.f;
      int e, m;
      float f;
      decompose<S2NN2S>(x, bias_a, mw, e, m, f);
      a_val[c][r] = x;
      a_frac[c][r] = f;
      a_expo[c][r] = e;
      a_mant[c][r] = m;
    }
    for (int i = tid; i < BK * BN; i += TX * TY) {
      const int r = i / BN, c = i % BN;
      const int gk = k0 + r, gn = n0 + c;
      const bool ok = gk < K && gn < N;
      const float x = ok ? B[(size_t)gk * N + gn] : 0.f;
      int e, m;
      float f;
      decompose<S2NN2S>(x, gn < N ? bias_b[gn] : 0, mw, e, m, f);
      b_val[r][c] = x;
      b_frac[r][c] = f;
      b_expo[r][c] = e;
      b_mant[r][c] = m;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      // per-operand terms hoisted out of the 4x4 product block
      float av[RM], af[RM], bv[RN], bf[RN];
      int ae[RM], arow[RM], be[RN], bexp[RN], bcol[RN];
      bool asub[RM], bsub[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int r = ty + i * TY;
        const int m = a_mant[kk][r];
        av[i] = a_val[kk][r];
        af[i] = a_frac[kk][r];
        ae[i] = a_expo[kk][r];
        arow[i] = (m & (S2_FLAG - 1)) * nm;
        asub[i] = (m & S2_FLAG) != 0;
      }
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int c = tx + j * TX;
        const int m = b_mant[kk][c];
        bv[j] = b_val[kk][c];
        bf[j] = b_frac[kk][c];
        be[j] = b_expo[kk][c];
        bexp[j] = be[j] + cneg[j];
        bcol[j] = m & (S2_FLAG - 1);
        bsub[j] = (m & S2_FLAG) != 0;
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          const float raw = av[i] * bv[j];
          const float golden =
              QUANT_BTW ? requant<CLIP_OF>(raw, bias_r, mw, max_norm_r) : raw;
          const float sign = golden < 0.f ? -1.f : 1.f;
          float mp = af[i] * bf[j];
          if (WITH_APPROX) mp = mp - lut_s[arow[i] + bcol[j]];
          float approx = mp * sign * pow2i(ae[i] + bexp[j]);
          float out;
          if (S2NN2S) {
            // the plain version masks zero RAW products (before requant)
            if (asub[i]) approx = approx * s;
            if (bsub[j]) approx = approx * s;
            out = raw == 0.f ? 0.f : approx;
          } else {
            const bool normal = ae[i] > 0 && be[j] > 0 && fabsf(golden) >= min_norm_r;
            out = normal ? approx : golden;
          }
          if (QUANT_BTW) out = requant<CLIP_OF>(out, bias_r, mw, max_norm_r);
          acc[i][j] += out;
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int gm = m0 + ty + i * TY;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int gn = n0 + tx + j * TX;
      if (gn < N) C[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

template <bool W, bool Q, bool CL, bool S>
void launch(dim3 grid, cudaStream_t stream, const float* A, const float* B,
            const int* bias_a, const int* bias_b, const int* bias_r, const int* lut,
            float* C, int M, int N, int K, int expo_width, int mant_width) {
  approx_matmul_kernel<W, Q, CL, S><<<grid, dim3(TX, TY), 0, stream>>>(
      A, B, bias_a, bias_b, bias_r, lut, C, M, N, K, expo_width, mant_width);
}

}  // namespace

// C interface (bound with ctypes). A (M,K), B (K,N), C (M,N) row-major f32;
// bias_a, bias_r: one int32 each on the device; bias_b: (N,) int32; lut:
// (2^mant_width)^2 int32. Launches on `stream` and returns cudaGetLastError().
extern "C" int fp8q_approx_matmul(const float* A, const float* B, const int* bias_a,
                                  const int* bias_b, const int* bias_r, const int* lut,
                                  float* C, int M, int N, int K, int expo_width,
                                  int mant_width, int with_approx, int quant_btw,
                                  int clip_of, int s2nn2s, void* stream) {
  if (mant_width < 1 || (1 << mant_width) > MAX_NM) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int flags = (with_approx ? 1 : 0) | (quant_btw ? 2 : 0) | (clip_of ? 4 : 0) |
                    (s2nn2s ? 8 : 0);
#define FP8Q_CASE(f)                                                            \
  case f:                                                                      \
    launch<((f)&1) != 0, ((f)&2) != 0, ((f)&4) != 0, ((f)&8) != 0>(            \
        grid, st, A, B, bias_a, bias_b, bias_r, lut, C, M, N, K, expo_width,   \
        mant_width);                                                           \
    break;
  switch (flags) {
    FP8Q_CASE(0) FP8Q_CASE(1) FP8Q_CASE(2) FP8Q_CASE(3)
    FP8Q_CASE(4) FP8Q_CASE(5) FP8Q_CASE(6) FP8Q_CASE(7)
    FP8Q_CASE(8) FP8Q_CASE(9) FP8Q_CASE(10) FP8Q_CASE(11)
    FP8Q_CASE(12) FP8Q_CASE(13) FP8Q_CASE(14) FP8Q_CASE(15)
  }
#undef FP8Q_CASE
  return (int)cudaGetLastError();
}
