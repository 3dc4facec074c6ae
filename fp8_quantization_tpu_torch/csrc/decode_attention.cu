// Decode attention over a KV-cache slab (K6) for Hopper.
//
// Replaces fp8_quantization_tpu/ops/pallas/decode_attention.py::
// decode_attention: one query token per slot, q (B,H,D), over k, v
// (B,S,HK,D) held as bf16 grid values or as 1-byte ExMy codes with a
// per-tensor packing bias (decoded on the load by exmy.cuh::
// unpack_exmy_bits, as K4 decodes its weights), with per-slot lengths and
// GQA (q head h reads kv head h / (H/HK)).
//
// The softmax is the TPU kernel's online one, over key blocks of
// bs = min(512, round_up(S, 128)) walked in order from key 0:
//   m_new = max(m_old, block max), corr = exp(m_old - m_new),
//   p = exp(s - m_new), l = l * corr + sum(p), acc = acc * corr + bf16(p) @ v
// and the output is acc / l. The bf16 rounding of p depends on the running
// max, so the kernel walks the same blocks in the same order as the TPU
// kernel and the plain version (a split-K flash-decode would round
// elsewhere; it is later work, with a stated tolerance). Keys at or past
// the slot's length would add exactly zero once block 0 has set a real max,
// so they are not read at all: the work follows the lengths, not S.
//
// The design: one CTA per (kv head, slot), the group's query heads
// together, so each K and V element is read from device memory once. A
// block's rows are staged raw (2 or 1 bytes an element) through 64 KB of
// shared memory with 16-byte loads, eight in flight per thread, then each
// warp takes a key and its lanes split D (scores); one warp per query head
// takes the block's max, p and sum; and each thread accumulates p @ v for
// its (head, d) outputs, f32 sums on the CUDA cores throughout, in the order
// the plain version takes. What bounds it: the bytes of the
// slab, but B x HK CTAs (32 at Llama-3-8B's 8 kv heads and 4 slots) leave
// most SMs idle, so one SM's load rate bounds it in practice.
//
// Plain version: fp8_quantization_tpu_torch/ops/cuda/decode_attention.py::
// decode_attention_plain.

#include <cmath>
#include <cstdint>

#include "exmy.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_G = 8;                  // query heads per kv head
constexpr int MAX_ACC = 4;                // outputs per thread: G * D <= 1024
constexpr int STAGE_BYTES = 64 * 1024;    // raw K or V rows staged at once
constexpr int STAGE_BATCH = 8;            // 16-byte loads in flight per thread
constexpr float MASKED = -1e30f;

struct DecodeArgs {
  const float* q;
  const void* k;
  const void* v;
  float* out;
  const int* lengths;
  int B, H, S, HK, D, bs, G;
  int kv_expo, kv_mant;
  const int* k_bias;
  const int* v_bias;
  int vec;          // rows are 16-byte multiples on 16-byte boundaries
  float scale;
};

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

// Copy the raw rows of keys [key0, key0 + n) of kv head hk into stage;
// keys past S stage as zeros (a zero code decodes to 0).
template <bool CODED>
__device__ __forceinline__ void stage_rows(const DecodeArgs& a, const void* slab, int b, int hk,
                                           int key0, int n, unsigned char* stage) {
  const int eb = CODED ? 1 : 2;
  const size_t row_bytes = (size_t)a.D * eb;
  const unsigned char* base = static_cast<const unsigned char*>(slab);
  if (a.vec) {
    // STAGE_BATCH 16-byte loads per thread in flight before any store
    const int w = (int)(row_bytes / 16);
    const int total = n * w;
    uint4* dst = reinterpret_cast<uint4*>(stage);
    for (int i0 = threadIdx.x; i0 < total; i0 += THREADS * STAGE_BATCH) {
      uint4 val[STAGE_BATCH];
#pragma unroll
      for (int u = 0; u < STAGE_BATCH; ++u) {
        const int i = i0 + u * THREADS;
        const int r = i / w, c = i - r * w;
        const int key = key0 + r;
        val[u] = make_uint4(0u, 0u, 0u, 0u);
        if (i < total && key < a.S) {
          const size_t off = (((size_t)b * a.S + key) * a.HK + hk) * row_bytes;
          val[u] = reinterpret_cast<const uint4*>(base + off)[c];
        }
      }
#pragma unroll
      for (int u = 0; u < STAGE_BATCH; ++u) {
        const int i = i0 + u * THREADS;
        if (i < total) dst[i] = val[u];
      }
    }
  } else {
    const int w = (int)row_bytes;
    for (int i = threadIdx.x; i < n * w; i += THREADS) {
      const int r = i / w, c = i - r * w;
      const int key = key0 + r;
      unsigned char val = 0;
      if (key < a.S) val = base[(((size_t)b * a.S + key) * a.HK + hk) * row_bytes + c];
      stage[i] = val;
    }
  }
}

// Element d of staged row r, as the bf16 value the TPU kernel feeds its dot.
template <bool CODED>
__device__ __forceinline__ float staged(const unsigned char* stage, int r, int d, int D, int ew,
                                        int mw, int ebits, float sub) {
  if (CODED) {
    return fp8q::round_bf16(fp8q::unpack_exmy_bits(stage[r * D + d], ew, mw, ebits, sub));
  }
  return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(stage)[r * D + d]);
}

template <bool CODED>
__global__ void __launch_bounds__(THREADS) decode_kernel(DecodeArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = a.D, G = a.G, bs = a.bs;
  unsigned char* stage = smem_raw;                                   // STAGE_BYTES
  float* qs = reinterpret_cast<float*>(smem_raw + STAGE_BYTES);       // [G][D]
  float* sc = qs + G * D;                                             // [G][bs]
  float* m = sc + G * bs;                                             // [G]
  float* l = m + G;                                                   // [G]
  float* corr = l + G;                                                // [G]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int h0 = hk * G;

  for (int i = tid; i < G * D; i += THREADS)
    qs[i] = fp8q::round_bf16(a.q[((size_t)b * a.H + h0) * D + i]);
  if (tid < G) {
    m[tid] = MASKED;
    l[tid] = 0.f;
  }
  int keb = 0, veb = 0;
  float kss = 0.f, vss = 0.f;
  if (CODED) {
    fp8q::unpack_consts(*a.k_bias, a.kv_mant, keb, kss);
    fp8q::unpack_consts(*a.v_bias, a.kv_mant, veb, vss);
  }

  const int valid = a.lengths[b];
  const int sp = (a.S + bs - 1) / bs * bs;
  // with a valid key 0, keys at or past the length add exactly zero
  const int kend = valid >= 1 ? min(valid, sp) : sp;
  const int chunk = STAGE_BYTES / (D * (CODED ? 1 : 2));
  const int n_out = G * D;

  float acc[MAX_ACC];
#pragma unroll
  for (int j = 0; j < MAX_ACC; ++j) acc[j] = 0.f;

  for (int base = 0; base < kend; base += bs) {
    const int n = min(bs, kend - base);
    // scores of the block's keys, a chunk of rows at a time
    for (int cb = 0; cb < n; cb += chunk) {
      const int nc = min(chunk, n - cb);
      __syncthreads();
      stage_rows<CODED>(a, a.k, b, hk, base + cb, nc, stage);
      __syncthreads();
      for (int r = warp; r < nc; r += WARPS) {
        float part[MAX_G];
#pragma unroll
        for (int g = 0; g < MAX_G; ++g) part[g] = 0.f;
        for (int d = lane; d < D; d += 32) {
          const float kv = staged<CODED>(stage, r, d, D, a.kv_expo, a.kv_mant, keb, kss);
#pragma unroll
          for (int g = 0; g < MAX_G; ++g)
            if (g < G) part[g] = part[g] + qs[g * D + d] * kv;
        }
        const int key = base + cb + r;
#pragma unroll
        for (int g = 0; g < MAX_G; ++g) {
          if (g < G) {
            const float s = warp_sum(part[g]);
            if (lane == 0) sc[g * bs + cb + r] = key < valid ? s * a.scale : MASKED;
          }
        }
      }
    }
    __syncthreads();
    // the block's max, p = exp(s - m_new) as bf16, and the sums
    for (int g = warp; g < G; g += WARPS) {
      float bm = MASKED;
      for (int c = lane; c < n; c += 32) bm = fmaxf(bm, sc[g * bs + c]);
      bm = warp_max(bm);
      const float mo = m[g];
      const float mn = fmaxf(mo, bm);
      float psum = 0.f;
      for (int c = lane; c < n; c += 32) {
        const float p = expf(sc[g * bs + c] - mn);
        psum += p;
        sc[g * bs + c] = fp8q::round_bf16(p);
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float cr = expf(mo - mn);
        l[g] = l[g] * cr + psum;
        m[g] = mn;
        corr[g] = cr;
      }
    }
    // pv = bf16(p) @ v over the same keys, then acc = acc * corr + pv
    float pv[MAX_ACC];
#pragma unroll
    for (int j = 0; j < MAX_ACC; ++j) pv[j] = 0.f;
    for (int cb = 0; cb < n; cb += chunk) {
      const int nc = min(chunk, n - cb);
      __syncthreads();
      stage_rows<CODED>(a, a.v, b, hk, base + cb, nc, stage);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < MAX_ACC; ++j) {
        const int o = tid + j * THREADS;
        if (o < n_out) {
          const int g = o / D, d = o - g * D;
          float sum = pv[j];
          for (int c = 0; c < nc; ++c)
            sum = sum + sc[g * bs + cb + c] *
                            staged<CODED>(stage, c, d, D, a.kv_expo, a.kv_mant, veb, vss);
          pv[j] = sum;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < MAX_ACC; ++j) {
      const int o = tid + j * THREADS;
      if (o < n_out) acc[j] = acc[j] * corr[o / D] + pv[j];
    }
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < MAX_ACC; ++j) {
    const int o = tid + j * THREADS;
    if (o >= n_out) continue;
    const float val = acc[j] / l[o / D];
    a.out[((size_t)b * a.H + h0) * D + o] = val;
  }
}

template <bool CODED>
int launch(const DecodeArgs& a, cudaStream_t stream) {
  const size_t smem =
      STAGE_BYTES + sizeof(float) * ((size_t)a.G * a.D + (size_t)a.G * a.bs + 3 * (size_t)a.G);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(decode_kernel<CODED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_kernel<CODED><<<dim3(a.HK, a.B), THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// K6. q: (B,H,D) f32; k, v: (B,S,HK,D) bf16 (coded = 0) or uint8 ExMy codes
// (coded = 1, fields kv_expo/kv_mant, per-tensor int32 packing biases
// k_bias/v_bias on the device); lengths: (B,) int32 valid keys per slot;
// out: (B,H,D) f32; bs: the key block. All contiguous.
// Returns cudaGetLastError() (or the reason the launch was refused).
extern "C" int fp8q_decode_attention(const float* q, const void* k, const void* v, float* out,
                                     const int* lengths, int B, int H, int S, int HK, int D,
                                     int bs, int coded, int kv_expo, int kv_mant,
                                     const int* k_bias, const int* v_bias, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || HK <= 0 || D <= 0 || bs <= 0 || H % HK != 0 ||
      B > 65535 || HK > 65535)
    return (int)cudaErrorInvalidValue;
  const int G = H / HK;
  if (G > MAX_G || G * D > THREADS * MAX_ACC) return (int)cudaErrorInvalidValue;
  if (coded && (kv_mant < 0 || kv_mant > 23 || kv_expo < 1 || 1 + kv_expo + kv_mant > 8))
    return (int)cudaErrorInvalidValue;
  DecodeArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.lengths = lengths;
  a.B = B;
  a.H = H;
  a.S = S;
  a.HK = HK;
  a.D = D;
  a.bs = bs;
  a.G = G;
  a.kv_expo = kv_expo;
  a.kv_mant = kv_mant;
  a.k_bias = k_bias;
  a.v_bias = v_bias;
  const int row_bytes = D * (coded ? 1 : 2);
  a.vec = row_bytes % 16 == 0 &&
          ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  // the TPU kernel's f32 constant: 1 / sqrt(D) taken in double, then rounded
  a.scale = (float)(1.0 / std::sqrt((double)D));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return coded ? launch<true>(a, st) : launch<false>(a, st);
}
