// Approximate-multiplier GEMM (v9 float-domain semantics) for Hopper (K3).
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
//               product whose golden is zero stays zero, as in the Pallas
//               kernel: a nonzero product that rounds to zero on the
//               result grid stays zero too)
//   acc     += out, requantized onto ExMy(bias_r)                 [quant_btw]
//
// What bounds it: shared-memory reads. No tensor-core instruction can do the
// per-product codec work, and the bytes moved (each operand read once per
// output tile) are far below the memory roofline, so the floor is one table
// read a product (32 words a clock an SM) beside one f32 add.
//
// Design. Every value a product's output can take depends only on the two
// operands' (subnormal flag, normalized mantissa), the product's sign and
// u = ea + eb + bias_r - 1, its exponent sum against the result grid's
// smallest normal: codec requantization rounds |v| in v's own binade and
// clamps at the binade top, so it commutes with a power of two within the
// normal binades, and below them (subnormal binades, rounding to zero) each
// u gives its own value. The wrapper builds that table from the plain
// version's own products (ops/cuda/approx_matmul.py::significand_table;
// tests/test_torch_approx_table.py rebuilds every single product of the
// value spaces from it): table[ia][ib][slot], slot = clamp(u - u_lo, 0,
// slots - 1). So a product is
//   one table read at ia + ib + slot, one int add that builds +-2^(ea+eb)
//   in f32 bits (exponent field and sign bit), one f32 multiply, the add;
// golden_clip_of adds a clamp at +-max_norm. Each operand's (index, binade
// term, exponent-and-sign bits) is staged once per K-slice. The table lives
// in shared memory, its slot axis padded to an odd stride, so the 32 lanes
// of a warp (one row, 32 columns) reading one slot hit 32 banks.
//
// Operands off their grid, a binade or bias outside the bounds that keep
// 2^(ea+eb) a normal f32 and the exponent sums in range, take the first
// port's per-product arithmetic (decompose, requant, LUT) for their whole
// K-slice, chosen per CTA, so a warp never diverges between the two.
//
// Numerics: each output is one f32 sum in ascending k; powers of two come
// from the exponent field only, never exp2f/ldexpf/powf; rounding is rintf
// (half-to-even); the codec clamps at binade tops without carrying into the
// exponent. Build with -fmad=false and without --use_fast_math (which would
// flush the subnormals the subnormal branches depend on), so only the
// summation order over K separates this kernel from its plain version.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int BM = 32;            // output rows per CTA: 4 per warp
constexpr int BN = 128;           // output columns per CTA: 4 per lane, 32 apart
constexpr int BK = 8;             // K-slice staged in shared memory
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RM = BM / WARPS;    // rows per thread
constexpr int RN = BN / 32;       // columns per thread
constexpr int MAX_MW = 5;         // 2^M <= 32
constexpr int S2_FLAG = 1 << 8;   // packed beside the mantissa field
// the table path's bounds: |ea + eb| <= 120 keeps 2^(ea+eb) a normal f32,
// and the exponent sums stay far from int overflow
constexpr int EXP_LIMIT = 60;
constexpr int BIAS_LIMIT = 64;

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

// One product by the first port's arithmetic, for operands the table does
// not cover. lut_s: the LUT times 2^-M, in global memory.
template <bool WITH_APPROX, bool QUANT_BTW, bool CLIP_OF, bool S2NN2S>
__device__ __noinline__ float product_slow(float av, float bv, int bias_a, int bias_b,
                                           int bias_r, int mw, float max_norm_r,
                                           const float* lut_s) {
  const int nm = 1 << mw;
  const float s = 1.0f / (float)nm;
  const float min_norm_r = pow2i(1 - bias_r);
  int ea, ma, eb, mb;
  float fa, fb;
  decompose<S2NN2S>(av, bias_a, mw, ea, ma, fa);
  decompose<S2NN2S>(bv, bias_b, mw, eb, mb, fb);
  const float raw = av * bv;
  const float golden = QUANT_BTW ? requant<CLIP_OF>(raw, bias_r, mw, max_norm_r) : raw;
  const float sign = golden < 0.f ? -1.f : 1.f;
  float mp = fa * fb;
  if (WITH_APPROX) mp = mp - __ldg(lut_s + (ma & (S2_FLAG - 1)) * nm + (mb & (S2_FLAG - 1)));
  float approx = mp * sign * pow2i(ea + eb - (bias_a + bias_b));
  float out;
  if (S2NN2S) {
    // the zero mask tests the golden after its requantization
    if (ma & S2_FLAG) approx = approx * s;
    if (mb & S2_FLAG) approx = approx * s;
    out = golden == 0.f ? 0.f : approx;
  } else {
    const bool normal = ea > 0 && eb > 0 && fabsf(golden) >= min_norm_r;
    out = normal ? approx : golden;
  }
  if (QUANT_BTW) out = requant<CLIP_OF>(out, bias_r, mw, max_norm_r);
  return out;
}

// An operand as the table path reads it: x the table offset of its index
// (bytes), y its term of the slot (bytes), z its exponent-and-sign bits
// (the A side carries the f32 exponent bias, so the two sides' z add to
// +-2^(ea+eb)), w the value's bits (for the per-product path).
struct Side {
  int index_bytes;  // bytes per index step: the A side a whole row of B indices
  int u_fold;       // A side: bias_r - 1 - u_lo; B side: 0
  int p_bias;       // A side: 127; B side: 0
};

__device__ __forceinline__ int4 stage_operand(float x, int bias, const Side& side, int mw,
                                              bool& slow) {
  const unsigned bits = __float_as_uint(x);
  const unsigned mag = bits & 0x7FFFFFFFu;
  const unsigned sign = bits & 0x80000000u;
  if (mag == 0u) {
    // the zero index's entries are 0 at every slot; the exponent bits stay
    // a finite power of two
    const int zero = (1 << mw) + 1;
    return make_int4(zero * side.index_bytes, 0, side.p_bias << 23, (int)bits);
  }
  const int e = (int)(mag >> 23) - 127;
  const unsigned frac = mag & 0x7FFFFFu;
  // a bias past the bounds (the saturated +inf of a site that saw only
  // zeros) sends the value to the per-product path; clamped, it cannot
  // overflow the arithmetic below
  const int b = min(max(bias, -BIAS_LIMIT - 1), BIAS_LIMIT + 1);
  const bool sub = e < 1 - b;
  // the fractional mantissa bits the grid allows at this binade
  const int allowed = sub ? e - (1 - b - mw) : mw;
  const bool fits = mag < 0x7F800000u && e >= -EXP_LIMIT && e <= EXP_LIMIT && b == bias &&
                    allowed >= 0 && (frac & ((1u << (23 - allowed)) - 1u)) == 0u;
  if (!fits) slow = true;
  const int index = (sub ? (1 << mw) : 0) + (int)(frac >> (23 - mw));
  return make_int4(index * side.index_bytes, (e + side.u_fold) * 4,
                   (int)(((unsigned)(e + side.p_bias) << 23) + sign), (int)bits);
}

template <bool WITH_APPROX, bool QUANT_BTW, bool CLIP_OF, bool S2NN2S>
__global__ void __launch_bounds__(THREADS)
approx_matmul_kernel(const float* __restrict__ A, const float* __restrict__ B,
                     const int* __restrict__ bias_a_p, const int* __restrict__ bias_b,
                     const int* __restrict__ bias_r_p, const float* __restrict__ table,
                     float* __restrict__ C, int M, int N, int K, int expo_width, int mw,
                     int slots, int u_lo) {
  // [table: np x np x stride f32][a records: BK x BM][b records: BK x BN]
  extern __shared__ __align__(16) unsigned char smem[];
  const int np = 2 << mw;
  const int stride = slots | 1;
  const int table_floats = np * np * stride;
  int4* a_rec = reinterpret_cast<int4*>(smem + table_floats * 4);
  int4* b_rec = a_rec + BK * BM;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  {
    const float4* src = reinterpret_cast<const float4*>(table);
    float4* dst = reinterpret_cast<float4*>(smem);
    for (int i = tid; i < table_floats / 4; i += THREADS) dst[i] = __ldg(src + i);
  }
  const float* lut_s = table + table_floats;

  const int bias_a = *bias_a_p;
  const int bias_r = *bias_r_p;
  const float s = 1.0f / (float)(1 << mw);
  const float max_norm_r = pow2i((1 << expo_width) - 1 - bias_r) * (2.0f - s);
  const bool bias_r_fits = bias_r >= -BIAS_LIMIT && bias_r <= BIAS_LIMIT;
  const Side a_side{np * stride * 4, bias_r_fits ? bias_r - 1 - u_lo : 0, 127};
  const Side b_side{stride * 4, 0, 0};
  const int slot_top = (slots - 1) * 4;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  int bias_bn[RN];
#pragma unroll
  for (int j = 0; j < RN; ++j) {
    const int n = n0 + lane + 32 * j;
    bias_bn[j] = n < N ? bias_b[n] : 0;
  }

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  // the operands this thread stages: one of the A slice (row tid / BK,
  // k tid % BK) and four of the B slice (k (tid + i * THREADS) / BN)
  const int ar = tid / BK, ac = tid % BK;
  auto load_a = [&](int k0) {
    const int gm = m0 + ar, gk = k0 + ac;
    return (gm < M && gk < K) ? __ldg(A + (size_t)gm * K + gk) : 0.f;
  };
  auto load_b = [&](int k0, int i) {
    const int e = tid + i * THREADS;
    const int gk = k0 + e / BN, gn = n0 + e % BN;
    return (gk < K && gn < N) ? __ldg(B + (size_t)gk * N + gn) : 0.f;
  };
  float next_a = load_a(0);
  float next_b[BK * BN / THREADS];
#pragma unroll
  for (int i = 0; i < BK * BN / THREADS; ++i) next_b[i] = load_b(0, i);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // Stage the slice: out-of-range entries stage as 0, whose products
    // contribute exactly 0.
    bool slow = false;
    a_rec[ac * BM + ar] = stage_operand(next_a, bias_a, a_side, mw, slow);
    if (next_a != 0.f && !bias_r_fits) slow = true;
#pragma unroll
    for (int i = 0; i < BK * BN / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int gn = n0 + e % BN;
      b_rec[e] = stage_operand(next_b[i], gn < N ? bias_b[gn] : 0, b_side, mw, slow);
    }
    const bool slice_slow = __syncthreads_or(slow) != 0;
    // the next slice's operands are in flight while this one is summed
    if (k0 + BK < K) {
      next_a = load_a(k0 + BK);
#pragma unroll
      for (int i = 0; i < BK * BN / THREADS; ++i) next_b[i] = load_b(k0 + BK, i);
    }

    if (!slice_slow) {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        int4 ra[RM], rb[RN];
#pragma unroll
        for (int i = 0; i < RM; ++i) ra[i] = a_rec[kk * BM + warp * RM + i];
#pragma unroll
        for (int j = 0; j < RN; ++j) rb[j] = b_rec[kk * BN + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
#pragma unroll
          for (int j = 0; j < RN; ++j) {
            const int slot = min(max(ra[i].y + rb[j].y, 0), slot_top);
            const float t = *reinterpret_cast<const float*>(smem + ra[i].x + rb[j].x + slot);
            float out = t * __int_as_float(ra[i].z + rb[j].z);
            if (CLIP_OF && QUANT_BTW) out = fminf(fmaxf(out, -max_norm_r), max_norm_r);
            acc[i][j] += out;
          }
        }
      }
    } else {
      for (int kk = 0; kk < BK; ++kk) {
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float av = __int_as_float(a_rec[kk * BM + warp * RM + i].w);
#pragma unroll
          for (int j = 0; j < RN; ++j) {
            const float bv = __int_as_float(b_rec[kk * BN + lane + 32 * j].w);
            acc[i][j] += product_slow<WITH_APPROX, QUANT_BTW, CLIP_OF, S2NN2S>(
                av, bv, bias_a, bias_bn[j], bias_r, mw, max_norm_r, lut_s);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int gm = m0 + warp * RM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int gn = n0 + lane + 32 * j;
      if (gn < N) C[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

size_t smem_bytes(int mw, int slots) {
  const size_t np = (size_t)2 << mw;
  return np * np * (size_t)(slots | 1) * 4 + (size_t)BK * (BM + BN) * sizeof(int4);
}

template <bool W, bool Q, bool CL, bool S>
int launch(dim3 grid, size_t smem, cudaStream_t stream, const float* A, const float* B,
           const int* bias_a, const int* bias_b, const int* bias_r, const float* table,
           float* C, int M, int N, int K, int expo_width, int mant_width, int slots,
           int u_lo) {
  static size_t attr_set = 0;
  if (smem > attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        approx_matmul_kernel<W, Q, CL, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = smem;
  }
  approx_matmul_kernel<W, Q, CL, S><<<grid, THREADS, smem, stream>>>(
      A, B, bias_a, bias_b, bias_r, table, C, M, N, K, expo_width, mant_width, slots, u_lo);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (bound with ctypes). A (M,K), B (K,N), C (M,N) row-major f32;
// bias_a, bias_r: one int32 each on the device; bias_b: (N,) int32; table:
// the significand table (2^(M+1) x 2^(M+1) x (slots | 1) f32, slot u_lo + j
// at j) followed by the LUT times 2^-M ((2^M)^2 f32), from the wrapper.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int fp8q_approx_matmul(const float* A, const float* B, const int* bias_a,
                                  const int* bias_b, const int* bias_r, const float* table,
                                  float* C, int M, int N, int K, int expo_width,
                                  int mant_width, int slots, int u_lo, int with_approx,
                                  int quant_btw, int clip_of, int s2nn2s, void* stream) {
  if (mant_width < 1 || mant_width > MAX_MW || slots < 1 || M <= 0 || N <= 0 || K <= 0 ||
      (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(mant_width, slots);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int flags = (with_approx ? 1 : 0) | (quant_btw ? 2 : 0) | (clip_of ? 4 : 0) |
                    (s2nn2s ? 8 : 0);
#define FP8Q_CASE(f)                                                                   \
  case f:                                                                             \
    return launch<((f)&1) != 0, ((f)&2) != 0, ((f)&4) != 0, ((f)&8) != 0>(            \
        grid, smem, st, A, B, bias_a, bias_b, bias_r, table, C, M, N, K, expo_width, \
        mant_width, slots, u_lo);
  switch (flags) {
    FP8Q_CASE(0) FP8Q_CASE(1) FP8Q_CASE(2) FP8Q_CASE(3)
    FP8Q_CASE(4) FP8Q_CASE(5) FP8Q_CASE(6) FP8Q_CASE(7)
    FP8Q_CASE(8) FP8Q_CASE(9) FP8Q_CASE(10) FP8Q_CASE(11)
    FP8Q_CASE(12) FP8Q_CASE(13) FP8Q_CASE(14) FP8Q_CASE(15)
  }
#undef FP8Q_CASE
  return (int)cudaErrorInvalidValue;
}
