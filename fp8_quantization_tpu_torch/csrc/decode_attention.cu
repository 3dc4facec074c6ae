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
// max, so the kernel walks the TPU kernel's blocks in order.
//
// What bounds it on an H100: the bytes of the keys below each slot's length
// (2 or 1 byte an element, K and V); at ~1 flop a byte it sits far below the
// card's ridge point, so tensor cores do not help. What held the first port
// back was latency on idle SMs: one CTA per (kv head, slot), 32 of 132 SMs at
// Llama-3-8B's decode, and per key a chain of warp shuffles (70% of a
// launch's cycles in clock64 stamps, eval/stamps.py).
//
// Design: each key block is split into sub-chunks of 64 keys, and one
// thread-block cluster of ceil(bs / 64) CTAs (8 at bs = 512: 256 CTAs at
// Llama-3-8B's 8 kv heads and 4 slots, three to an SM, all resident at once)
// takes one (slot, kv head), CTA c the c-th sub-chunk of every block. The
// order of every sum is fixed, and the plain version
// (ops/cuda/decode_attention.py::decode_attention_plain) takes the same one,
// so the two are equal bit for bit:
// - each score: one thread per (query head, key) sums the products over d in
//   order, one f32 chain (16-byte loads of 8 keys' dims from rows padded to
//   an odd number of 16-byte units, so a warp's rows miss each other's banks);
// - the block max is order-free: the CTAs exchange their sub-chunk maxima
//   through distributed shared memory, so m_new, corr and p are the TPU
//   kernel's exactly;
// - a sub-chunk's sum(p): lane l adds p[l] and p[l + 32], then the warp's
//   xor tree; its bf16(p) @ v: one f32 chain per output over its keys in
//   order, two outputs a thread from one 4-byte v load;
// - the block's sums: every CTA writes its partial sums into CTA 0's shared
//   memory, and CTA 0, which keeps l and acc, adds them in ascending
//   sub-chunk order.
// Two cluster barriers a block (maxima, then partials), all in one launch;
// the maxima alternate between two buffers by block, so no third barrier is
// needed. Keys at or past a slot's length are not read (they would add exact
// zeros once block 0 has a real max): the work follows the lengths, not S.
// K and V have one cp.async stage each, refilled with the next block's rows
// as soon as this block has read them. Coded K and V are decoded once per
// element into bf16 tiles.
//
// Plain version: fp8_quantization_tpu_torch/ops/cuda/decode_attention.py::
// decode_attention_plain.

#include <cooperative_groups.h>

#include <cmath>
#include <cstdint>

#include "exmy.cuh"
#include "mma.cuh"
#include "stamps.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int SUB = 64;                   // keys a CTA takes of each block
constexpr int MAX_CLUSTER = 8;            // sub-chunks per block: bs <= 512
constexpr int MAX_G = 8;                  // query heads per kv head
constexpr int MAX_D = 256;
constexpr float MASKED = -1e30f;

struct DecodeArgs {
  const float* q;
  const void* k;
  const void* v;
  float* out;
  const int* lengths;
  int B, H, S, HK, D, bs, G, nsub;
  int kv_expo, kv_mant;
  const int* k_bias;
  const int* v_bias;
  int vec;          // rows are 16-byte multiples on 16-byte boundaries
  float scale;
};

// A row stride of an odd number of 16-byte units: a quarter-warp's eight
// 16-byte reads of eight consecutive rows then fall in eight bank groups.
__host__ __device__ inline int odd16(int bytes) {
  const int units = (bytes + 15) / 16;
  return 16 * (units | 1);
}

// Shared-memory layout of one CTA, in bytes from the start. K is read by
// score threads one row each (rows padded to odd16), as bf16: staged raw
// (bf16 slab) or decoded from the raw codes (kdec). V is read row by row by
// all threads (no padding), as bf16: raw or decoded (vdec).
struct Layout {
  int krow, kraw_row, kraw, vraw, kdec, vdec, qs, sc, m, xmax, pps, ppv, total;
  __host__ __device__ Layout(int G, int D, int nsub, bool coded) {
    krow = odd16(2 * D);
    kraw_row = coded ? (D + 15) / 16 * 16 : krow;
    kraw = 0;                                   // [SUB][kraw_row] raw K
    vraw = kraw + SUB * kraw_row;               // [SUB][D] raw V
    kdec = vraw + (SUB * D * (coded ? 1 : 2) + 15) / 16 * 16;
    vdec = kdec + (coded ? SUB * krow : 0);     // coded: [SUB][krow] bf16 K
    qs = vdec + (coded ? SUB * D * 2 : 0);      // coded: [SUB][D] bf16 V
    sc = qs + G * D * 4;                        // [G][D] f32 q; [G][SUB] f32 s, bf16(p)
    m = sc + G * SUB * 4;                       // [3][G] f32: running max, corr, l
    xmax = m + 3 * G * 4;                       // [2][G] f32, read by the cluster
    pps = xmax + 2 * G * 4;                     // [nsub][G] f32, written by the cluster
    ppv = (pps + nsub * G * 4 + 15) / 16 * 16;  // [nsub][G][D] f32, written by the cluster
    total = ppv + nsub * G * D * 4;
  }
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

// Start copying the raw rows of keys [key0, key0 + n) of kv head hk into
// stage (row stride row_stride bytes); keys past S stage as zeros (a zero
// code decodes to 0). The vector path issues cp.async copies (the caller
// commits and waits); the other copies at once.
template <bool CODED>
__device__ __forceinline__ void stage_rows(const DecodeArgs& a, const void* slab, int b, int hk,
                                           int key0, int n, unsigned char* stage,
                                           int row_stride) {
  const int eb = CODED ? 1 : 2;
  const int row_bytes = a.D * eb;
  const size_t stride = (size_t)a.HK * row_bytes;
  const unsigned char* slab0 = static_cast<const unsigned char*>(slab);
  const unsigned char* base = slab0 + ((size_t)b * a.S + key0) * stride + (size_t)hk * row_bytes;
  const int lim = a.S - key0;
  if (a.vec) {
    // 16-byte chunks a row: a power of two at D = 64, 128 and 256
    const int w = row_bytes >> 4;
    const bool pow2 = (w & (w - 1)) == 0;
    const int shift = __ffs(w) - 1;
    for (int i = threadIdx.x; i < n * w; i += THREADS) {
      const int r = pow2 ? i >> shift : i / w;
      const int c = i - r * w;
      const bool in = r < lim;
      fp8q::cp_async16(stage + r * row_stride + c * 16, in ? base + r * stride + c * 16 : slab0,
                       in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < n * row_bytes; i += THREADS) {
      const int r = i / row_bytes, c = i - r * row_bytes;
      stage[r * row_stride + c] = r < lim ? base[r * stride + c] : 0;
    }
  }
}

// Decode n staged rows of codes (stride src_row bytes) into bf16 rows
// (stride dst_row bytes), each element once, four a thread at a time.
__device__ __forceinline__ void decode_rows(const DecodeArgs& a, const unsigned char* src,
                                            int src_row, unsigned char* dst, int dst_row, int n,
                                            int ebits, float sub) {
  const auto dec = [&](unsigned c) {
    return fp8q::unpack_exmy_bits((int)(c & 0xffu), a.kv_expo, a.kv_mant, ebits, sub);
  };
  if (a.D % 4 == 0) {
    const int q4 = a.D >> 2;
    for (int e = threadIdx.x; e < n * q4; e += THREADS) {
      const int r = e / q4, c = 4 * (e - r * q4);
      const unsigned w = *reinterpret_cast<const unsigned*>(src + r * src_row + c);
      *reinterpret_cast<uint2*>(dst + r * dst_row + 2 * c) =
          make_uint2(fp8q::pack_bf16x2(dec(w), dec(w >> 8)),
                     fp8q::pack_bf16x2(dec(w >> 16), dec(w >> 24)));
    }
  } else {
    for (int e = threadIdx.x; e < n * a.D; e += THREADS) {
      const int r = e / a.D, d = e - r * a.D;
      reinterpret_cast<__nv_bfloat16*>(dst + r * dst_row)[d] =
          __float2bfloat16_rn(dec(src[r * src_row + d]));
    }
  }
}

// Eight bf16 values (one 16-byte load) widened to f32.
__device__ __forceinline__ void widen8(const uint4 r, float f[8]) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[2 * j] = __uint_as_float(w[j] << 16);
    f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

template <bool CODED>
__global__ void __launch_bounds__(THREADS, 3) decode_kernel(DecodeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int D = a.D, G = a.G, bs = a.bs, nsub = a.nsub;
  const Layout L(G, D, nsub, CODED);
  unsigned char* kraw = smem + L.kraw;
  unsigned char* vraw = smem + L.vraw;
  const unsigned char* kbf = CODED ? smem + L.kdec : kraw;      // bf16 K rows, stride krow
  const __nv_bfloat16* vbf =
      reinterpret_cast<const __nv_bfloat16*>(CODED ? smem + L.vdec : vraw);  // [SUB][D]
  float* qs = reinterpret_cast<float*>(smem + L.qs);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  float* m = reinterpret_cast<float*>(smem + L.m);  // m[g], corr[G + g], l[2G + g]
  float* xmax = reinterpret_cast<float*>(smem + L.xmax);
  // every CTA's partial sums land in CTA 0's buffers
  float* pps = reinterpret_cast<float*>(smem + L.pps);
  float* ppv = reinterpret_cast<float*>(smem + L.ppv);
  float* pps0 = cluster.map_shared_rank(pps, 0);
  float* ppv0 = cluster.map_shared_rank(ppv, 0);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = (int)cluster.block_rank();              // the sub-chunk
  const int hk = blockIdx.y, b = blockIdx.z;
  const int h0 = hk * G;
  const int n_out = G * D;
  STAMP_DECL

  const int valid = a.lengths[b];
  const int sp = (a.S + bs - 1) / bs * bs;
  // with a valid key 0, keys at or past the length add exactly zero
  const int kend = valid >= 1 ? min(valid, sp) : sp;
  const int nblocks = (kend + bs - 1) / bs;
  // this CTA's keys of block i: [first(i), first(i) + count(i))
  auto first = [&](int i) { return i * bs + rank * SUB; };
  auto count = [&](int i) {
    return max(0, min(min(SUB, bs - rank * SUB), kend - first(i)));
  };
  if (nblocks > 0) {
    stage_rows<CODED>(a, a.k, b, hk, first(0), count(0), kraw, L.kraw_row);
    fp8q::cp_async_commit();
    stage_rows<CODED>(a, a.v, b, hk, first(0), count(0), vraw, D * (CODED ? 1 : 2));
    fp8q::cp_async_commit();
  }

  for (int i = tid; i < n_out; i += THREADS)
    qs[i] = fp8q::round_bf16(a.q[((size_t)b * a.H + h0) * D + i]);
  if (tid < G) {
    m[tid] = MASKED;
    m[2 * G + tid] = 0.f;
  }
  int keb = 0, veb = 0;
  float kss = 0.f, vss = 0.f;
  if (CODED) {
    fp8q::unpack_consts(*a.k_bias, a.kv_mant, keb, kss);
    fp8q::unpack_consts(*a.v_bias, a.kv_mant, veb, vss);
  }
  // the cluster leader's running acc, two outputs (g, d), (g, d + 1) a pair
  constexpr int MAX_PAIRS = MAX_G * MAX_D / 2 / THREADS;
  float acc[MAX_PAIRS][2];
#pragma unroll
  for (int j = 0; j < MAX_PAIRS; ++j) acc[j][0] = acc[j][1] = 0.f;
  STAMP(0);

  for (int i = 0; i < nblocks; ++i) {
    const int par = i & 1;
    const int n = count(i);
    const bool more = i + 1 < nblocks;
    fp8q::cp_async_wait<1>();          // K of block i (V may still be in flight)
    __syncthreads();
    if (CODED) {
      decode_rows(a, kraw, L.kraw_row, smem + L.kdec, L.krow, n, keb, kss);
      __syncthreads();
    }
    STAMP(1);

    // scores: thread (g, r) sums q_g . k_r over d in order, one f32 chain
    // (a product of two bf16 values is exact in f32, so a fused
    // multiply-add rounds as the product and the sum do apart)
    for (int pr = tid; pr < G * SUB; pr += THREADS) {
      const int g = pr / SUB, r = pr - g * SUB;
      if (r >= n) continue;
      const unsigned char* krow = kbf + r * L.krow;
      const float* qg = qs + g * D;
      float s = 0.f;
      if (D % 8 == 0) {
        for (int d0 = 0; d0 < D; d0 += 8) {
          float kv[8];
          widen8(*reinterpret_cast<const uint4*>(krow + 2 * d0), kv);
          const float4 q0 = *reinterpret_cast<const float4*>(qg + d0);
          const float4 q1 = *reinterpret_cast<const float4*>(qg + d0 + 4);
          s = __fmaf_rn(q0.x, kv[0], s);
          s = __fmaf_rn(q0.y, kv[1], s);
          s = __fmaf_rn(q0.z, kv[2], s);
          s = __fmaf_rn(q0.w, kv[3], s);
          s = __fmaf_rn(q1.x, kv[4], s);
          s = __fmaf_rn(q1.y, kv[5], s);
          s = __fmaf_rn(q1.z, kv[6], s);
          s = __fmaf_rn(q1.w, kv[7], s);
        }
      } else {
        const __nv_bfloat16* kr = reinterpret_cast<const __nv_bfloat16*>(krow);
        for (int d = 0; d < D; ++d) s = __fmaf_rn(qg[d], __bfloat162float(kr[d]), s);
      }
      sc[g * SUB + r] = first(i) + r < valid ? s * a.scale : MASKED;
    }
    __syncthreads();
    STAMP(2);
    // K's stage is free: the next block's K lands there while this one ends
    if (more) stage_rows<CODED>(a, a.k, b, hk, first(i + 1), count(i + 1), kraw, L.kraw_row);
    fp8q::cp_async_commit();

    // this sub-chunk's max per head, then the block's, from every CTA's
    if (warp < G) {
      float mx = MASKED;
      for (int r = lane; r < n; r += 32) mx = fmaxf(mx, sc[warp * SUB + r]);
      mx = warp_max(mx);
      if (lane == 0) xmax[par * G + warp] = mx;
    }
    cluster.sync();
    STAMP(3);
    if (tid < G) {
      float v[MAX_CLUSTER];
#pragma unroll
      for (int c = 0; c < MAX_CLUSTER; ++c)
        v[c] = c < nsub ? cluster.map_shared_rank(xmax, c)[par * G + tid] : MASKED;
      float bm = MASKED;
#pragma unroll
      for (int c = 0; c < MAX_CLUSTER; ++c) bm = fmaxf(bm, v[c]);
      const float mo = m[tid];
      const float mn = fmaxf(mo, bm);
      m[G + tid] = expf(mo - mn);
      m[tid] = mn;
    }
    __syncthreads();
    // p = exp(s - m_new); this sub-chunk's sum(p) (lane l: p[l] + p[l + 32],
    // then the xor tree) to CTA 0; bf16(p) in place of the score
    if (warp < G) {
      const float mn = m[warp];
      float lsum = 0.f;
#pragma unroll
      for (int j = 0; j < SUB / 32; ++j) {
        const int r = lane + 32 * j;
        const float p = r < n ? expf(sc[warp * SUB + r] - mn) : 0.f;
        lsum = lsum + p;
        if (r < n) sc[warp * SUB + r] = fp8q::round_bf16(p);
      }
      lsum = warp_sum(lsum);
      if (lane == 0) pps0[rank * G + warp] = lsum;
    }
    if (more) {
      fp8q::cp_async_wait<1>();        // V of block i (the next K may be in flight)
    } else {
      fp8q::cp_async_wait<0>();
    }
    __syncthreads();
    if (CODED) {
      decode_rows(a, vraw, D, smem + L.vdec, 2 * D, n, veb, vss);
      __syncthreads();
    }
    STAMP(4);
    // bf16(p) @ v over this sub-chunk: one chain per output, keys in order;
    // a thread takes outputs (g, d) and (g, d + 1) of one 4-byte v load
    for (int pp = tid; 2 * pp < n_out; pp += THREADS) {
      const int o = 2 * pp, g = o / D, d = o - g * D;
      const float* pg = sc + g * SUB;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll 4
      for (int r = 0; r < n; ++r) {
        const __nv_bfloat162 v2 = *reinterpret_cast<const __nv_bfloat162*>(vbf + r * D + d);
        const float p = pg[r];
        s0 = __fmaf_rn(p, __low2float(v2), s0);
        s1 = __fmaf_rn(p, __high2float(v2), s1);
      }
      *reinterpret_cast<float2*>(ppv0 + rank * n_out + o) = make_float2(s0, s1);
    }
    STAMP(5);
    cluster.sync();
    STAMP(6);
    // V's stage is free: the next block's V lands there
    if (more) stage_rows<CODED>(a, a.v, b, hk, first(i + 1), count(i + 1), vraw,
                                D * (CODED ? 1 : 2));
    fp8q::cp_async_commit();
    // CTA 0 adds the partial sums in ascending sub-chunk order
    if (rank == 0) {
      if (tid < G) {
        float ps = pps[tid];
        for (int c = 1; c < nsub; ++c) ps = ps + pps[c * G + tid];
        m[2 * G + tid] = m[2 * G + tid] * m[G + tid] + ps;
      }
#pragma unroll
      for (int j = 0; j < MAX_PAIRS; ++j) {
        const int o = 2 * (tid + j * THREADS);
        if (o < n_out) {
          const float corr = m[G + o / D];
          float2 pv = *reinterpret_cast<const float2*>(ppv + o);
          for (int c = 1; c < nsub; ++c) {
            const float2 x = *reinterpret_cast<const float2*>(ppv + c * n_out + o);
            pv.x = pv.x + x.x;
            pv.y = pv.y + x.y;
          }
          acc[j][0] = acc[j][0] * corr + pv.x;
          acc[j][1] = acc[j][1] * corr + pv.y;
        }
      }
    }
    STAMP(7);
  }

  if (rank == 0) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < MAX_PAIRS; ++j) {
      const int o = 2 * (tid + j * THREADS);
      if (o < n_out) {
        const float l = m[2 * G + o / D];
        *reinterpret_cast<float2*>(a.out + ((size_t)b * a.H + h0) * D + o) =
            make_float2(acc[j][0] / l, acc[j][1] / l);
      }
    }
  }
  STAMP(8);
  STAMP_STORE((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x);
}

template <bool CODED>
int launch(const DecodeArgs& a, cudaStream_t stream) {
  static bool attr_set = false;
  const size_t smem = Layout(a.G, a.D, a.nsub, CODED).total;
  const size_t most = Layout(MAX_G, MAX_D, MAX_CLUSTER, CODED).total;
  if (smem > most) return (int)cudaErrorInvalidValue;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<CODED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.nsub, a.HK, a.B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.nsub;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, decode_kernel<CODED>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// K6. q: (B,H,D) f32; k, v: (B,S,HK,D) bf16 (coded = 0) or uint8 ExMy codes
// (coded = 1, fields kv_expo/kv_mant, per-tensor int32 packing biases
// k_bias/v_bias on the device); lengths: (B,) int32 valid keys per slot;
// out: (B,H,D) f32; bs: the key block (at most MAX_CLUSTER sub-chunks of
// SUB keys); D even. All contiguous. One launch of ceil(bs / SUB)-CTA
// clusters. Returns cudaGetLastError() (or the reason the launch was
// refused).
extern "C" int fp8q_decode_attention(const float* q, const void* k, const void* v, float* out,
                                     const int* lengths, int B, int H, int S, int HK, int D,
                                     int bs, int coded, int kv_expo, int kv_mant,
                                     const int* k_bias, const int* v_bias, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || HK <= 0 || D <= 0 || bs <= 0 || H % HK != 0 ||
      B > 65535 || HK > 65535)
    return (int)cudaErrorInvalidValue;
  const int G = H / HK;
  const int nsub = (bs + SUB - 1) / SUB;
  if (G > MAX_G || D > MAX_D || D % 2 != 0 || nsub > MAX_CLUSTER)
    return (int)cudaErrorInvalidValue;
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
  a.nsub = nsub;
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
