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
// The rounding point of the probabilities is the TPU kernel's: the
// *normalized* p / l, against the row's final max, goes to bf16. A one-pass
// flash kernel would round the unnormalized p against a running max, a
// different function in the last bits. So this kernel makes two passes over
// the key axis: pass 1 takes the row max and the sum l (online, over key
// tiles); pass 2 recomputes the scores, forms bf16(exp(s - m) / l) and
// accumulates p @ v. One CTA per (query block of 32 rows, head, batch);
// key tiles of 64 stream through shared memory with 16-byte loads, several
// in flight per thread (K transposed so that lanes read neighbouring keys),
// each warp owns four query rows, and every sum is an f32 sum on the CUDA
// cores, in the order the plain version takes. The TPU kernel holds the whole key axis in
// VMEM; this one streams it, so any S fits. Key tiles past the block's last
// causal key or past s_valid are skipped: every row already has a real max
// from key 0 there, so they would add exactly zero.
//
// What bounds it: at the Llama prefill shapes, the CUDA cores' f32 rate
// (three dot products of length D per (row, key) pair: two QK, one PV) and
// the shared-memory loads that feed them. wgmma, TMA and a one-pass design
// with a stated tolerance are later work.
//
// Plain version: fp8_quantization_tpu_torch/ops/cuda/attention.py::
// fused_sdpa_plain.

#include <cmath>
#include <cstdint>

#include "exmy.cuh"

namespace {

constexpr int BQ = 32;                   // query rows per CTA
constexpr int BK = 64;                   // keys per tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = BQ / WARPS;         // query rows per warp
constexpr int MAX_D = 256;
constexpr int MAX_ACC = BQ * MAX_D / THREADS;
constexpr int STAGE_BATCH = 4;           // 16-byte loads in flight per thread
constexpr float MASKED = -1e30f;

struct SdpaArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  void* out;
  int B, T, H, S, HK, D;
  int s_valid, causal, with_offsets;
  const int* offsets;
  int requant;
  const float* res_f;
  const int* res_i;
  int vec;          // D a multiple of 8 and 16-byte aligned operands
  float scale;
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Eight bf16 values (one 16-byte load) widened to f32: a bf16 is the top
// half of the f32 with the same bits.
__device__ __forceinline__ void widen8(const uint4 r, float f[8]) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[2 * j] = __uint_as_float(w[j] << 16);
    f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

// Stage keys [c0, c0 + BK) of kv head hk: kt[d][c] (transposed, rows padded
// to BK + 1 so neighbouring d land in other banks) and, when vs is given,
// vs[c][d]. Keys past S stage as 0. With a.vec (D a multiple of 8, 16-byte
// aligned rows) each thread issues STAGE_BATCH 16-byte loads of each operand
// before it stores any, so the loads are in flight together.
__device__ __forceinline__ void stage_kv(const SdpaArgs& a, int b, int hk, int c0, float* kt,
                                         float* vs) {
  const int D = a.D;
  const size_t kv_row = (size_t)a.HK * D;
  if (a.vec) {
    const int vpr = D / 8;
    const int total = BK * vpr;
    for (int i0 = threadIdx.x; i0 < total; i0 += THREADS * STAGE_BATCH) {
      uint4 kr[STAGE_BATCH], vr[STAGE_BATCH];
#pragma unroll
      for (int u = 0; u < STAGE_BATCH; ++u) {
        const int i = i0 + u * THREADS;
        const int c = i / vpr, w = i - c * vpr;
        const int key = c0 + c;
        kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
        if (i < total && key < a.S) {
          const size_t off = ((size_t)b * a.S + key) * kv_row + (size_t)hk * D + (size_t)w * 8;
          kr[u] = *reinterpret_cast<const uint4*>(a.k + off);
          if (vs != nullptr) vr[u] = *reinterpret_cast<const uint4*>(a.v + off);
        }
      }
#pragma unroll
      for (int u = 0; u < STAGE_BATCH; ++u) {
        const int i = i0 + u * THREADS;
        if (i < total) {
          const int c = i / vpr, w = i - c * vpr;
          float kf[8], vf[8];
          widen8(kr[u], kf);
          widen8(vr[u], vf);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            kt[(w * 8 + e) * (BK + 1) + c] = kf[e];
            if (vs != nullptr) vs[c * D + w * 8 + e] = vf[e];
          }
        }
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < BK * D; i += THREADS) {
    const int c = i / D, d = i - c * D;
    const int key = c0 + c;
    float kv = 0.f, vv = 0.f;
    if (key < a.S) {
      const size_t off = ((size_t)b * a.S + key) * kv_row + (size_t)hk * D + d;
      kv = __bfloat162float(a.k[off]);
      if (vs != nullptr) vv = __bfloat162float(a.v[off]);
    }
    kt[d * (BK + 1) + c] = kv;
    if (vs != nullptr) vs[i] = vv;
  }
}

// This warp's ROWS x 2 scores of the staged tile (keys c0 + lane and
// c0 + lane + 32), scaled and masked: -1e30 where the mask is off, -inf
// for keys past S (they do not exist and must not count in l).
__device__ __forceinline__ void tile_scores(const SdpaArgs& a, const float* qs, const float* kt,
                                            int q0, int c0, int off, float s[ROWS][2]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int D = a.D;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) s[i][0] = s[i][1] = 0.f;
  for (int d = 0; d < D; ++d) {
    const float k0 = kt[d * (BK + 1) + lane];
    const float k1 = kt[d * (BK + 1) + lane + 32];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const float qv = qs[(warp * ROWS + i) * D + d];
      s[i][0] = s[i][0] + qv * k0;
      s[i][1] = s[i][1] + qv * k1;
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int key = c0 + lane + 32 * j;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int qpos = q0 + warp * ROWS + i + off;
      const bool on = key < a.s_valid && (!a.causal || key <= qpos);
      s[i][j] = key >= a.S ? neg_inf() : (on ? s[i][j] * a.scale : MASKED);
    }
  }
}

template <bool OUT_BF16>
__global__ void __launch_bounds__(THREADS) sdpa_kernel(SdpaArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int D = a.D;
  float* qs = smem;                  // [BQ][D]
  float* kt = qs + BQ * D;           // [D][BK + 1]
  float* vs = kt + D * (BK + 1);     // [BK][D]
  float* ps = vs + BK * D;           // [BQ][BK]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.H / a.HK);
  const int off = a.with_offsets ? a.offsets[b] : 0;

  if (a.vec) {
    const int vpr = D / 8;
    for (int i = tid; i < BQ * vpr; i += THREADS) {
      const int r = i / vpr, w = i - r * vpr;
      const int t = q0 + r;
      float f[8];
      widen8(t < a.T ? *reinterpret_cast<const uint4*>(
                           a.q + (((size_t)b * a.T + t) * a.H + h) * D + (size_t)w * 8)
                     : make_uint4(0u, 0u, 0u, 0u),
             f);
#pragma unroll
      for (int e = 0; e < 8; ++e) qs[r * D + w * 8 + e] = f[e];
    }
  } else {
    for (int i = tid; i < BQ * D; i += THREADS) {
      const int r = i / D, d = i - r * D;
      const int t = q0 + r;
      qs[i] = t < a.T ? __bfloat162float(a.q[(((size_t)b * a.T + t) * a.H + h) * D + d]) : 0.f;
    }
  }

  // keys this block needs: all S, or, when every row has key 0 unmasked,
  // only up to s_valid and the last row's causal limit
  int kend = a.S;
  if (a.s_valid >= 1 && (!a.causal || off >= 0)) {
    kend = min(kend, a.s_valid);
    if (a.causal) kend = min(kend, min(q0 + BQ, a.T) - 1 + off + 1);
  }

  float m[ROWS], l[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = neg_inf();
    l[i] = 0.f;
  }

  // pass 1: row max and sum, online over the key tiles
  for (int c0 = 0; c0 < kend; c0 += BK) {
    __syncthreads();
    stage_kv(a, b, hk, c0, kt, nullptr);
    __syncthreads();
    float s[ROWS][2];
    tile_scores(a, qs, kt, q0, c0, off, s);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const float mn = fmaxf(m[i], warp_max(fmaxf(s[i][0], s[i][1])));
      const float psum = warp_sum(expf(s[i][0] - mn) + expf(s[i][1] - mn));
      l[i] = l[i] * expf(m[i] - mn) + psum;
      m[i] = mn;
    }
  }

  // pass 2: bf16(exp(s - m) / l) @ v
  const int n_out = BQ * D;
  float acc[MAX_ACC];
#pragma unroll
  for (int j = 0; j < MAX_ACC; ++j) acc[j] = 0.f;
  for (int c0 = 0; c0 < kend; c0 += BK) {
    __syncthreads();
    stage_kv(a, b, hk, c0, kt, vs);
    __syncthreads();
    float s[ROWS][2];
    tile_scores(a, qs, kt, q0, c0, off, s);
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ps[(warp * ROWS + i) * BK + lane + 32 * j] = fp8q::round_bf16(expf(s[i][j] - m[i]) / l[i]);
    __syncthreads();
    const int ncols = min(BK, a.S - c0);
#pragma unroll
    for (int j = 0; j < MAX_ACC; ++j) {
      const int o = tid + j * THREADS;
      if (o < n_out) {
        const int r = o / D, d = o - r * D;
        float sum = acc[j];
        for (int c = 0; c < ncols; ++c) sum = sum + ps[r * BK + c] * vs[c * D + d];
        acc[j] = sum;
      }
    }
  }

  fp8q::QParams rq{0.f, 0, 0, 0};
  if (a.requant) rq = fp8q::load_qparams(a.res_f, a.res_i);
#pragma unroll
  for (int j = 0; j < MAX_ACC; ++j) {
    const int o = tid + j * THREADS;
    if (o >= n_out) continue;
    const int r = o / D, d = o - r * D;
    const int t = q0 + r;
    if (t >= a.T) continue;
    float val = acc[j];
    if (a.requant) val = fp8q::quantize_block(val, rq);
    const size_t idx = (((size_t)b * a.T + t) * a.H + h) * D + d;
    if (OUT_BF16) {
      static_cast<__nv_bfloat16*>(a.out)[idx] = __float2bfloat16_rn(val);
    } else {
      static_cast<float*>(a.out)[idx] = val;
    }
  }
}

template <bool OUT_BF16>
int launch(const SdpaArgs& a, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)BQ * a.D + (size_t)a.D * (BK + 1) + (size_t)BK * a.D + BQ * BK);
  cudaError_t err = cudaFuncSetAttribute(sdpa_kernel<OUT_BF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.T + BQ - 1) / BQ, a.H, a.B);
  sdpa_kernel<OUT_BF16><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
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
      H > 65535 || B > 65535)
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
  return out_bf16 ? launch<true>(a, st) : launch<false>(a, st);
}
