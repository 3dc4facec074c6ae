// Fused scaled-dot-product attention with an optional FP8 requant epilogue
// (K7) for Hopper.
//
// Replaces fp8_quantization_tpu/ops/pallas/attention.py::fused_sdpa:
// token-major q (B,T,H,D) over k, v (B,S,HK,D), all bf16, GQA by head index
// (q head h reads kv head h / (H/HK)); masks key < s_valid and, when causal,
// key <= row + offsets[b]; masked scores are -1e30; the context is
// (p / l) rounded to bf16, times v, with f32 sums; the epilogue optionally
// requantizes it with exmy.cuh::quantize_block (K1's body).
//
// What bounds it on an H100: at Llama-3-8B's prefill chunks and ViT-B/16's
// attention the bytes (q, k, v read once as bf16, the f32 context written
// once) and the function's operations (q k^T and p v on the 989 TFLOP/s
// bf16 tensor cores) are both a few microseconds a launch. What keeps it
// above that is the work beside the products: two passes mean q k^T twice,
// and each (row, key) pair takes two exp and a divide on the CUDA cores,
// with few warps an SM to hide their latency.
//
// Design:
// - Two passes over the key axis, so that the probabilities round where the
//   TPU kernel rounds them: the *normalized* p / l, against the row's final
//   max, goes to bf16 (a one-pass online softmax would round the unnormalized
//   exp(s - m_running), a different function in every probability). Pass 1
//   takes each row's max m and sum l, online over 64-key tiles; pass 2
//   recomputes the scores, forms bf16(exp(s - m) / l) and accumulates p v.
// - q k^T and p v run on the tensor cores: mma.sync m16n8k16 bf16 with f32
//   accumulators, fed by ldmatrix (transposed for v) from XOR-swizzled bf16
//   tiles (mma.cuh, shared with route B of K2/K4). Pass 2 turns the score
//   accumulators into the A fragments of p v in registers (the m16n8k16 C
//   layout is the A layout of the next product), so p never goes through
//   shared memory.
// - GQA in the CTA's rows: a CTA takes 64 consecutive rows of the (token,
//   query head of the group) order of one (batch, kv head), 16 a warp, so
//   every k and v tile it stages serves all G query heads that share it.
//   Rows are split, never keys. A warp is one scheduler's whole work in
//   either case, so smaller CTAs would not spread a short chunk any further:
//   they would only stage each tile more often and issue its copies from
//   fewer threads.
// - K and v tiles stream through a three-slot cp.async ring: the next two
//   tiles (pass 1's k, or pass 2's k and v) load while this one computes,
//   one barrier a step. q's fragments stay in registers (D <= 128).
// - Key tiles past the CTA's last causal key or past s_valid are skipped:
//   when every row has key 0 unmasked, they would add exactly zero. A tile
//   that every row of a warp sees whole skips the mask. The divide by l is
//   one IEEE reciprocal a row and a corrected product a pair (prob()).
// - D pads to the tile width (64, 128 or 256) with zeros in shared memory,
//   which is exact; D = 40 and D = 64 take the same code.
// - The requant epilogue (K1's body) runs on the accumulators in registers.
//
// Numerics contract: the tensor cores sum in their own order, so the kernel
// equals the plain version only up to f32 summation order: each score within
// (D + 2) * 2^-24 * sum_d |q_d k_d| * scale of the plain one, each
// probability the plain bf16(p / l) or a bf16 neighbour where the scores'
// error can move it across a rounding point, the context within those flips
// plus the f32 order term of p v, and with the requant epilogue equal or one
// grid step away at a rounding midpoint, at least 99% equal
// (ops/cuda/attention.py::within_sdpa_contract).
//
// Plain version: fp8_quantization_tpu_torch/ops/cuda/attention.py::
// fused_sdpa_plain.

#include <cmath>
#include <cstdint>

#include "exmy.cuh"
#include "mma.cuh"
#include "stamps.cuh"

namespace {

using fp8q::cp_async16;
using fp8q::cp_async_commit;
using fp8q::cp_async_wait;
using fp8q::ldmatrix_x4;
using fp8q::ldmatrix_x4_trans;
using fp8q::mma_bf16;
using fp8q::pack_bf16x2;

constexpr int BK = 64;           // keys per tile
constexpr int STAGES = 3;        // k (and v) tiles in the cp.async ring
constexpr int WARPS = 4;         // 16 rows each
constexpr int BM = 16 * WARPS;   // rows per CTA
constexpr int MAX_D = 256;
constexpr float MASKED = -1e30f;

struct SdpaArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  void* out;
  int B, T, H, S, HK, D, G;
  int s_valid, causal, with_offsets;
  const int* offsets;
  int requant;
  const float* res_f;
  const int* res_i;
  int vec;          // D a multiple of 8 and 16-byte aligned operands
  float scale;
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// exp(s - m) / l, the normalized probability in f32 before its bf16
// rounding, from inv = RN(1 / l) (one IEEE divide a row): the product is
// within an ulp of the quotient, e - q l is exact in a fused multiply-add,
// and one corrected product gives RN(e / l) wherever the quotient is a
// normal number (Markstein's theorem), as the divide would; a subnormal
// quotient is within 2^-149 of it. A zero numerator gives +0.
__device__ __forceinline__ float prob(float s, float m, float l, float inv) {
  const float e = expf(s - m);
  const float q = e * inv;
  return __fmaf_rn(__fmaf_rn(-q, l, e), inv, q);
}

// Element offset of (row r, column d) in a [rows][DM] bf16 tile whose
// 16-byte chunks are XOR-swizzled by the row (chunk ^ r % 8): ldmatrix's
// eight rows of one chunk column fall in eight different bank groups.
template <int DM>
__device__ __forceinline__ int sw(int r, int d) {
  return r * DM + ((((d >> 3) ^ r) & 7) | ((d >> 3) & ~7)) * 8 + (d & 7);
}

// Copy rows [0, n) of a [rows][DM] tile, D columns, row r from src + r *
// stride for r < lim and zeros past it; columns past D are never written
// (zeroed once). The 16-byte chunks of a row are a power of two at D = 64,
// 128 and 256, so a chunk's row and column are a shift and a mask.
template <int DM>
__device__ __forceinline__ void load_tile(const SdpaArgs& a, __nv_bfloat16* tile, int n,
                                          const __nv_bfloat16* src, int stride, int lim) {
  if (a.vec) {
    const int chunks = a.D >> 3;
    const bool pow2 = (chunks & (chunks - 1)) == 0;
    const int shift = __ffs(chunks) - 1;
    for (int i = threadIdx.x; i < n * chunks; i += blockDim.x) {
      const int r = pow2 ? i >> shift : i / chunks;
      const int c = i - r * chunks;
      const bool in = r < lim;
      cp_async16(tile + sw<DM>(r, c * 8), in ? src + (size_t)r * stride + c * 8 : src,
                 in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < n * a.D; i += blockDim.x) {
      const int r = i / a.D, d = i - r * a.D;
      tile[sw<DM>(r, d)] = r < lim ? src[(size_t)r * stride + d] : __float2bfloat16_rn(0.f);
    }
  }
}

// q's A fragments stay in registers across the tiles where they fit (64
// registers at D = 256 do not, and are read from shared memory each tile).
template <int DM>
struct QFrags {
  static constexpr bool IN_REGS = DM <= 128;
  unsigned f[IN_REGS ? DM / 16 : 1][4];
};

// This warp's 16 x 64 scores of the staged k tile, raw (unscaled f32 sums):
// s[nt][e] is row (lane / 4 + 8 * (e / 2)) of the warp and key (nt * 8 +
// 2 * (lane % 4) + e % 2) of the tile.
template <int DM>
__device__ __forceinline__ void tile_scores(const QFrags<DM>& qf, const __nv_bfloat16* qs,
                                            const __nv_bfloat16* ks, int warp, int lane,
                                            float (&s)[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
  const int mi = lane >> 3;
#pragma unroll
  for (int kd = 0; kd < DM / 16; ++kd) {
    unsigned af[4];
    if constexpr (QFrags<DM>::IN_REGS) {
#pragma unroll
      for (int e = 0; e < 4; ++e) af[e] = qf.f[kd][e];
    } else {
      ldmatrix_x4(af, qs + sw<DM>(warp * 16 + (lane & 15), kd * 16 + (lane >> 4) * 8));
    }
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      // keys np*16 .. +15 of the tile, d kd*16 .. +15: b fragments of two
      // 8-key n-tiles (k is stored [key][d], the col-major B of q k^T)
      unsigned b4[4];
      ldmatrix_x4(b4, ks + sw<DM>(np * 16 + (mi >> 1) * 8 + (lane & 7), kd * 16 + (mi & 1) * 8));
      mma_bf16(s[2 * np], af, b4[0], b4[1]);
      mma_bf16(s[2 * np + 1], af, b4[2], b4[3]);
    }
  }
}

template <int DM, bool OUT_BF16>
__global__ void __launch_bounds__(WARPS * 32) sdpa_kernel(SdpaArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [BM][DM]
  __nv_bfloat16* kring = qs + BM * DM;                                // [STAGES][BK][DM]
  __nv_bfloat16* vring = kring + STAGES * BK * DM;                    // [STAGES][BK][DM]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int G = a.G, T = a.T, D = a.D;
  const int rows = T * G;                       // (token, head of the group) rows
  const int row0 = blockIdx.x * BM;
  const int off = a.with_offsets ? a.offsets[b] : 0;
  STAMP_DECL

  // columns past D (and everything, on the element-wise path) start at zero
  if (D != DM || !a.vec) {
    const int words = (BM * DM + 2 * STAGES * BK * DM) / 8;
    uint4* z = reinterpret_cast<uint4*>(smem_raw);
    for (int i = tid; i < words; i += blockDim.x) z[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }

  // keys this block needs: all S, or, when every row has key 0 unmasked,
  // only up to s_valid and the last row's causal limit
  int kend = a.S;
  if (a.s_valid >= 1 && (!a.causal || off >= 0)) {
    kend = min(kend, a.s_valid);
    if (a.causal) kend = min(kend, (min(row0 + BM, rows) - 1) / G + off + 1);
  }
  const int ntiles = (kend + BK - 1) / BK;

  // k and v rows of (b, hk): key c at kv + c * HK * D
  const size_t kv0 = ((size_t)b * a.S * a.HK + hk) * D;
  const int kv_stride = a.HK * D;
  // step j < ntiles: pass 1 on tile j (k only); then pass 2 on tile j - ntiles
  auto issue = [&](int j) {
    const int c0 = (j < ntiles ? j : j - ntiles) * BK;
    const int slot = j % STAGES;
    const size_t off = kv0 + (size_t)c0 * kv_stride;
    load_tile<DM>(a, kring + slot * BK * DM, BK, a.k + off, kv_stride, a.S - c0);
    if (j >= ntiles) load_tile<DM>(a, vring + slot * BK * DM, BK, a.v + off, kv_stride, a.S - c0);
  };

  // q rows: (token t, head g of the group) at q + ((b T + t) H + hk G + g) D;
  // a token's G heads are contiguous, so each token is one row of G * D
  if (a.vec) {
    const int chunks = D >> 3;
    for (int i = tid; i < BM * chunks; i += blockDim.x) {
      const int r = i / chunks, c = i - r * chunks;
      const int R = row0 + r;
      const int t = R / G;
      const bool in = R < rows;
      const __nv_bfloat16* src = a.q + (((size_t)b * T + t) * a.H + (size_t)hk * G + (R - t * G)) * D;
      cp_async16(qs + sw<DM>(r, c * 8), in ? src + c * 8 : a.q, in ? 16 : 0);
    }
  } else {
    for (int i = tid; i < BM * D; i += blockDim.x) {
      const int r = i / D, d = i - r * D;
      const int R = row0 + r, t = R / G;
      qs[sw<DM>(r, d)] = R < rows ? a.q[(((size_t)b * T + t) * a.H + (size_t)hk * G +
                                           (R - t * G)) * D + d]
                                  : __float2bfloat16_rn(0.f);
    }
  }
  // groups: q with step 0's tile, then one per step (empty past the last)
  if (ntiles > 0) issue(0);
  cp_async_commit();
  if (2 * ntiles > 1) issue(1);
  cp_async_commit();

  // this thread's two rows (lane / 4 and lane / 4 + 8 of its warp): token and
  // causal limit
  int tok[2], lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int R = row0 + warp * 16 + (lane >> 2) + 8 * h;
    tok[h] = R / G;
    lim[h] = a.causal ? tok[h] + off : 0x7fffffff;
  }

  STAMP(0);
  float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};
  float o[DM / 8][4];
#pragma unroll
  for (int nt = 0; nt < DM / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;

  // the warp's first row bounds its causal keys from below: tiles that
  // every row of the warp sees whole need no mask
  const int warp_lim = a.causal ? (row0 + warp * 16) / G + off : 0x7fffffff;
  const int clean_end = min(min(a.S, a.s_valid), warp_lim + 1);
  QFrags<DM> qf;
  float inv[2] = {0.f, 0.f};
  for (int j = 0; j < 2 * ntiles; ++j) {
    cp_async_wait<STAGES - 2>();       // this step's tile (the next may be in flight)
    __syncthreads();
    // every warp is past step j - 1, whose slot step j + 2 takes
    if (j + 2 < 2 * ntiles) issue(j + 2);
    cp_async_commit();
    if (QFrags<DM>::IN_REGS && j == 0) {
#pragma unroll
      for (int kd = 0; kd < DM / 16; ++kd)
        ldmatrix_x4(qf.f[kd], qs + sw<DM>(warp * 16 + (lane & 15), kd * 16 + (lane >> 4) * 8));
    }
    STAMP(1);
    const int slot = j % STAGES;
    const int c0 = (j < ntiles ? j : j - ntiles) * BK;
    float s[8][4];
    tile_scores<DM>(qf, qs, kring + slot * BK * DM, warp, lane, s);
    // scaled and masked: -1e30 where the mask is off, -inf for keys past S
    // (they do not exist and must not count in l)
    if (c0 + BK <= clean_end) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = s[nt][e] * a.scale;
    } else {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = c0 + nt * 8 + 2 * (lane & 3) + (e & 1);
          const bool on = key < a.s_valid && key <= lim[e >> 1];
          s[nt][e] = key >= a.S ? neg_inf() : (on ? s[nt][e] * a.scale : MASKED);
        }
    }
    STAMP(2);
    if (j < ntiles) {
      // pass 1: the rows' max and sum, online over the tiles; a row's four
      // lanes (lane % 4) reduce by shuffles
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = neg_inf();
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mn = fmaxf(m[h], mx);
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          sum = sum + expf(s[nt][2 * h] - mn) + expf(s[nt][2 * h + 1] - mn);
        sum = sum + __shfl_xor_sync(0xffffffffu, sum, 1);
        sum = sum + __shfl_xor_sync(0xffffffffu, sum, 2);
        l[h] = l[h] * expf(m[h] - mn) + sum;
        m[h] = mn;
      }
      STAMP(3);
    } else {
      // pass 2: bf16(exp(s - m) / l) as the A fragments of p v, in registers
      if (j == ntiles) {
        inv[0] = 1.f / l[0];
        inv[1] = 1.f / l[1];
      }
      const __nv_bfloat16* vs = vring + slot * BK * DM;
      const int mi = lane >> 3;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        unsigned pf[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int nt = 2 * kk + half;
          pf[2 * half] = pack_bf16x2(prob(s[nt][0], m[0], l[0], inv[0]),
                                     prob(s[nt][1], m[0], l[0], inv[0]));
          pf[2 * half + 1] = pack_bf16x2(prob(s[nt][2], m[1], l[1], inv[1]),
                                         prob(s[nt][3], m[1], l[1], inv[1]));
        }
#pragma unroll
        for (int np = 0; np < DM / 16; ++np) {
          // keys kk*16 .. +15, d np*16 .. +15: b fragments of two 8-wide
          // d tiles from v stored [key][d] (transposed load)
          unsigned b4[4];
          ldmatrix_x4_trans(b4, vs + sw<DM>(kk * 16 + (mi & 1) * 8 + (lane & 7),
                                            np * 16 + (mi >> 1) * 8));
          mma_bf16(o[2 * np], pf, b4[0], b4[1]);
          mma_bf16(o[2 * np + 1], pf, b4[2], b4[3]);
        }
      }
      STAMP(4);
    }
  }

  fp8q::QParams rq{0.f, 0, 0, 0};
  if (a.requant) rq = fp8q::load_qparams(a.res_f, a.res_i);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int R = row0 + warp * 16 + (lane >> 2) + 8 * h;
    if (R >= rows) continue;
    const int t = tok[h], g = R - t * G;
    const size_t base = (((size_t)b * T + t) * a.H + (size_t)hk * G + g) * D;
#pragma unroll
    for (int nt = 0; nt < DM / 8; ++nt) {
      // outputs d and d + 1: one 8-byte (4-byte bf16) store where D is even
      const int d = nt * 8 + 2 * (lane & 3);
      if (d >= D) continue;
      float v0 = o[nt][2 * h], v1 = o[nt][2 * h + 1];
      if (a.requant) {
        v0 = fp8q::quantize_block(v0, rq);
        v1 = fp8q::quantize_block(v1, rq);
      }
      if (D % 2 == 0) {
        if (OUT_BF16) {
          *reinterpret_cast<unsigned*>(static_cast<__nv_bfloat16*>(a.out) + base + d) =
              pack_bf16x2(v0, v1);
        } else {
          *reinterpret_cast<float2*>(static_cast<float*>(a.out) + base + d) = make_float2(v0, v1);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (d + e >= D) continue;
          const float val = e ? v1 : v0;
          if (OUT_BF16) {
            static_cast<__nv_bfloat16*>(a.out)[base + d + e] = __float2bfloat16_rn(val);
          } else {
            static_cast<float*>(a.out)[base + d + e] = val;
          }
        }
      }
    }
  }
  STAMP(5);
  STAMP_STORE((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x);
}

template <int DM, bool OUT_BF16>
int launch(const SdpaArgs& a, cudaStream_t stream) {
  const long long blocks = ((long long)a.T * a.G + BM - 1) / BM;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(__nv_bfloat16) * ((size_t)BM * DM + 2 * STAGES * (size_t)BK * DM);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        sdpa_kernel<DM, OUT_BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const dim3 grid((unsigned)blocks, a.HK, a.B);
  sdpa_kernel<DM, OUT_BF16><<<grid, 32 * WARPS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool OUT_BF16>
int launch_d(const SdpaArgs& a, cudaStream_t stream) {
  if (a.D <= 64) return launch<64, OUT_BF16>(a, stream);
  if (a.D <= 128) return launch<128, OUT_BF16>(a, stream);
  return launch<256, OUT_BF16>(a, stream);
}

}  // namespace

// K7. q: (B,T,H,D), k, v: (B,S,HK,D), bf16 and contiguous; out: (B,T,H,D)
// f32 or bf16 (out_bf16). offsets: (B,) int32, read when with_offsets;
// res_f: [maxval] f32 and res_i: [bias, mant, sign] int32, read when
// requant. Returns cudaGetLastError() (or the reason the launch was refused).
extern "C" int fp8q_fused_sdpa(const void* q, const void* k, const void* v, void* out, int B,
                               int T, int H, int S, int HK, int D, int s_valid, int causal,
                               int with_offsets, const int* offsets, int requant, int out_bf16,
                               const float* res_f, const int* res_i, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || S <= 0 || HK <= 0 || D <= 0 || D > MAX_D || H % HK != 0 ||
      HK > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  SdpaArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.out = out;
  a.B = B;
  a.T = T;
  a.H = H;
  a.S = S;
  a.HK = HK;
  a.D = D;
  a.G = H / HK;
  a.s_valid = s_valid;
  a.causal = causal;
  a.with_offsets = with_offsets;
  a.offsets = offsets;
  a.requant = requant;
  a.res_f = res_f;
  a.res_i = res_i;
  a.vec = D % 8 == 0 && ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  // the TPU kernel's f32 constant: 1 / sqrt(D) taken in double, then rounded
  a.scale = (float)(1.0 / std::sqrt((double)D));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_bf16 ? launch_d<true>(a, st) : launch_d<false>(a, st);
}
