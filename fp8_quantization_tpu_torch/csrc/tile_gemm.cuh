// The GEMM shared by the fused-quant GEMM (K2, fused_matmul.cu) and the
// packed-FP8 dequant GEMM (K4, dequant_matmul.cu):
//
//   out = requant(load_x(x) @ load_w(w))
//
// The two kernels differ only in how operands are loaded: x arrives as f32
// (quantized on the load by quantize_block when asked, then rounded to bf16),
// as bf16, or as 1-byte ExMy codes with per-tensor decode constants; w
// arrives as bf16 grid values (K2) or as 1-byte ExMy codes with per-column
// decode constants (K4). Every operand is rounded to bf16 on the load, as the
// TPU kernels feed the MXU bf16. Each call is one launch; the route depends
// on M alone: route A for M <= route_a_max_m, which the caller passes
// (ops/cuda/fused_matmul.py::ROUTE_A_MAX_M, at most A_MAX_ROWS).
//
// Route A, M <= route_a_max_m (16; decode): bit-exact streaming.
//   Bound on an H100: bytes in principle (K x N x 2 bytes for K2, 1 byte for
//   K4, at 3.35 TB/s), but below that the latency of one dependent f32 chain
//   of K fused multiply-adds (4.1 cycles each at 1.98 GHz: ~8.6 us at
//   K = 4096), and in practice the shared-memory traffic that feeds the
//   chains (every x value is a broadcast load, every weight is transposed
//   once through shared memory).
//   Design: one f32 accumulator chain per output (m, n), k ascending, by
//   __fmaf_rn, as the plain version sums (ops/cuda/fused_matmul.py::
//   sequential_matmul); each product of two bf16 values is exact in f32, so
//   the kernel equals the plain version bit for bit. The card is filled by
//   the M x N chains: a CTA takes a strip of 32 columns (one per lane) and 1,
//   2 or 4 compute warps of up to 4 rows each (2 x 2 at M = 4, the rows'
//   chains interleaved so their latencies overlap); k/v at M = 4 is 32 CTAs,
//   a 4096-wide projection 128, lm_head 4008. Eight converter warps keep a
//   cp.async ring of raw 256-deep K-slices in flight (4 x 9 KB of codes or
//   3 x 18 KB of bf16, sized so two CTAs share an SM) and convert the next
//   slice while the compute warps sum this one: the weights become a
//   [column][k] bf16 tile (K2's bits copied, K4's codes looked up in a
//   per-CTA 256-code x 32-column table built once from the per-column
//   biases; 4-byte reads, bank-padded rows, a lane-rotated column order), x
//   an f32 [row][k] slice (quantized, widened or decoded). A compute lane
//   then reads 8 weights per 16-byte load, three loads ahead of its
//   products. The codes cross HBM at 1 byte each.
//
// Route B, larger M (ViT, prefill): a tensor-core tile GEMM.
//   Bound on an H100: operations at these shapes (989 TFLOP/s bf16 dense).
//   Design: 128x128 output tiles of 8 warps, each warp 64x32 of mma.sync
//   m16n8k16 bf16 products with f32 accumulators in registers; operand tiles
//   32 deep, fed from ldmatrix on XOR-swizzled bf16 tiles (conflict-free
//   reads and writes). The raw next K-slice is loaded into registers while the
//   tensor cores work on the current one, then converted (x quantized, x or w
//   codes decoded, per-column constants in registers) and stored into the
//   other of two shared buffers, so the codes still cross HBM at 1 byte each.
//   Rows, columns and K off the tile load as zeros (a zero K tail adds exact
//   zeros). The requant epilogue (quantize_block) runs in registers.
//   wgmma with TMA would reach more of the tensor-core rate; mma.sync is the
//   first tensor-core step.
//
// Numerics contract (tests/test_torch_cuda.py, chip_smoke.py):
//   route A: equal to the plain version, bit for bit;
//   route B: the tensor cores sum in their own order, so before any requant
//     |kernel - plain| <= K * 2^-24 * sum_k |x_k w_k| per element, and with
//     the requant epilogue each output equals the plain one or is exactly one
//     step of the result grid away, where the plain sum lies within that
//     tolerance of a rounding midpoint, and at least 99% are equal
//     (ops/cuda/fused_matmul.py::within_requant_step).

#pragma once

#include <cstdint>

#include "exmy.cuh"
#include "mma.cuh"

namespace fp8q {

enum XMode { X_F32 = 0, X_BF16 = 1, X_CODES = 2 };
enum WMode { W_BF16 = 0, W_CODES = 1 };

struct GemmArgs {
  const void* x;  // (M, K) row-major: f32, bf16 or uint8 codes
  const void* w;  // (K, N) row-major: bf16 or uint8 codes
  void* out;      // (M, N) row-major: f32 or bf16
  int M, N, K;
  int route_a_max_m;  // the largest M that takes route A
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

// One x element as both routes feed it: quantized (f32 x with quantize_x) and
// rounded to bf16, widened from bf16, or decoded from a code.
__device__ __forceinline__ float convert_x(int x_mode, const void* base, size_t off,
                                           const GemmArgs& g, const QParams& act, int x_eb,
                                           float x_ss) {
  if (x_mode == X_F32) {
    float v = static_cast<const float*>(base)[off];
    if (g.quantize_x) v = quantize_block(v, act);
    return round_bf16(v);
  }
  if (x_mode == X_BF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(base)[off]);
  const int code = static_cast<const unsigned char*>(base)[off];
  return round_bf16(unpack_exmy_bits(code, g.x_expo, g.x_mant, x_eb, x_ss));
}

__device__ __forceinline__ void store_out(const GemmArgs& g, int out_bf16, const QParams& res,
                                          int m, int n, float v) {
  if (g.requantize_out) v = quantize_block(v, res);
  const size_t off = (size_t)m * g.N + n;
  if (out_bf16) {
    static_cast<__nv_bfloat16*>(g.out)[off] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(g.out)[off] = v;
  }
}

// ---------------------------------------------------------------------------
// Route A: bit-exact streaming for M <= route_a_max_m

constexpr int A_BN = 32;              // columns per CTA, one per lane
constexpr int A_BK = 256;             // k rows per stage
constexpr int A_CONVERT_WARPS = 8;
constexpr int A_MAX_SMEM = 200 * 1024;
constexpr int A_MAX_ROWS = 16;  // the most rows a CTA holds: 4 compute warps of 4

template <int WM>
struct StreamTile {
  static constexpr int WELT = WM == W_CODES ? 1 : 2;  // weight bytes
  static constexpr int ROW = A_BN * WELT;             // bytes of one k row of the strip
  // a raw stage is A_BK / 8 blocks of 8 rows, each padded so that 32 lanes
  // reading a 4-byte word of one row from each of 4 (codes) or 2 (bf16)
  // neighbouring blocks hit 32 different banks
  static constexpr int OCT = 8 * ROW + (WM == W_CODES ? 32 : 64);
  static constexpr int STAGE = A_BK / 8 * OCT;
  // ring depth: 4 stages of 9 KB (codes) or 3 of 18 KB (bf16), 27 or 36 KB
  // in flight, so that at a few rows two CTAs share an SM (~100 KB each)
  static constexpr int STAGES = WM == W_CODES ? 4 : 3;
};

__host__ __device__ inline int x_elt_bytes(int x_mode) {
  return x_mode == X_F32 ? 4 : (x_mode == X_BF16 ? 2 : 1);
}

// rows per compute warp (each lane keeps that many chains) and compute warps
// of route A at M rows: one warp per row would repeat each weight's load
// and widening per row, four rows a warp would serialize on one scheduler
__host__ __device__ inline int stream_rows_per_warp(int M) {
  return M == 1 ? 1 : (M <= 8 ? 2 : 4);
}
__host__ __device__ inline int stream_warps(int M) {
  return (M + stream_rows_per_warp(M) - 1) / stream_rows_per_warp(M);
}
// rows of the converted x slice: every compute warp's rows, those past M zero
__host__ __device__ inline int stream_x_rows(int M) {
  return stream_warps(M) * stream_rows_per_warp(M);
}

template <int WM>
inline size_t stream_smem_bytes(int M, int x_mode, int stages) {
  using T = StreamTile<WM>;
  return (size_t)stages * T::STAGE                            // raw weight ring
         + (size_t)stages * M * A_BK * x_elt_bytes(x_mode)     // raw x ring
         + (size_t)2 * A_BN * A_BK * 2                         // converted w, [col][k] bf16
         + (size_t)2 * stream_x_rows(M) * A_BK * 4             // converted x, [row][k] f32
         + (WM == W_CODES ? 256 * A_BN * 2 : 0);               // K4 decode table
}

// The converted weight slice is [column][k] bf16, 16-byte chunks of 8 k
// XOR-swizzled by the column (key c ^ c / 4), so that 8 lanes reading one
// chunk each of 8 consecutive columns, or writing one of columns 4b + i
// (b = 0..7), spread over all banks.
__device__ __forceinline__ int wt_off(int c, int j8) {
  return c * A_BK + ((j8 ^ ((c ^ (c >> 2)) & 7)) << 3);
}

// Warps [0, stream_warps(M)) sum: each lane one column, each warp its rows,
// one f32 chain per output in ascending k. The A_CONVERT_WARPS converter
// warps keep the raw ring filled by cp.async and convert stage it + 1 (w
// widened or decoded and transposed, x quantized, widened or decoded) while
// stage it is summed, so the chains' latency and the conversion overlap.
template <int WM, int RPT, int S>
__global__ void __launch_bounds__(32 * (4 + A_CONVERT_WARPS))
    stream_gemm_kernel(GemmArgs g, int x_mode, int out_bf16, int vec) {
  using T = StreamTile<WM>;
  constexpr int BK = A_BK, WELT = T::WELT;
  extern __shared__ __align__(16) unsigned char smem[];

  const int M = g.M, N = g.N, K = g.K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int RG = stream_warps(M);
  const bool converter = warp >= RG;
  const int ct = threadIdx.x - 32 * RG;  // converter thread index
  constexpr int CT = A_CONVERT_WARPS * 32;
  const int xelt = x_elt_bytes(x_mode);
  const int XR = stream_x_rows(M);
  const int n0 = blockIdx.x * A_BN;

  unsigned char* w_ring = smem;
  unsigned char* x_ring = w_ring + S * T::STAGE;
  __nv_bfloat16* wt = reinterpret_cast<__nv_bfloat16*>(x_ring + (size_t)S * M * BK * xelt);
  float* xc = reinterpret_cast<float*>(wt + 2 * A_BN * BK);
  unsigned short* table = reinterpret_cast<unsigned short*>(xc + 2 * XR * BK);

  const int num_k = (K + BK - 1) / BK;

  // converter state: the quantizer and the x decode constants
  QParams act{0.f, 0, 0, 0};
  int x_eb = 0;
  float x_ss = 0.f;
  if (converter) {
    if (x_mode == X_F32 && g.quantize_x) act = load_qparams(g.act_f, g.act_i);
    if (x_mode == X_CODES) unpack_consts(*g.x_bias, g.x_mant, x_eb, x_ss);
  }
  if (WM == W_CODES) {
    // the bf16 bits of every code of this strip's columns, laid out
    // [code][column]: a warp's 32 lanes (columns) read 32 banks
    for (int i = threadIdx.x; i < 256 * A_BN; i += blockDim.x) {
      const int col = n0 + (i & (A_BN - 1));
      unsigned short v = 0;
      if (col < N) {
        int eb;
        float ss;
        unpack_consts(g.w_bias[col], g.w_mant, eb, ss);
        v = __bfloat16_as_ushort(
            __float2bfloat16_rn(unpack_exmy_bits(i >> 5, g.w_expo, g.w_mant, eb, ss)));
      }
      table[i] = v;
    }
  }

  // issue stage s: its BK x 32 weight strip and its M x BK slice of x
  auto fill = [&](int s) {
    const int slot = s % S, k0 = s * BK;
    unsigned char* wdst = w_ring + slot * T::STAGE;
    constexpr int WCH = A_BN * WELT / 16;  // 16-byte chunks per weight row
#pragma unroll
    for (int t = 0; t < BK * WCH / CT; ++t) {
      const int i = ct + t * CT;
      const int r = i / WCH, c = i % WCH;
      const int k = k0 + r, nn = n0 + c * (16 / WELT);
      unsigned char* dst = wdst + (r >> 3) * T::OCT + (r & 7) * T::ROW + c * 16;
      if (vec) {
        const bool in = k < K && nn < N;
        const unsigned char* src = static_cast<const unsigned char*>(g.w) +
                                   (in ? ((size_t)k * N + nn) * WELT : 0);
        cp_async16(dst, src, in ? 16 : 0);
      } else {
        for (int e = 0; e < 16 / WELT; ++e) {
          const bool in = k < K && nn + e < N;
          const size_t off = (size_t)k * N + nn + e;
          if (WELT == 2) {
            reinterpret_cast<unsigned short*>(dst)[e] =
                in ? static_cast<const unsigned short*>(g.w)[off] : 0;
          } else {
            dst[e] = in ? static_cast<const unsigned char*>(g.w)[off] : 0;
          }
        }
      }
    }
    unsigned char* xdst = x_ring + (size_t)slot * M * BK * xelt;
    const int XCH = BK * xelt / 16;  // 16-byte chunks per x row
    const int per = 16 / xelt;
    for (int i = ct; i < M * XCH; i += CT) {
      const int r = i / XCH, c = i % XCH;
      const int k = k0 + c * per;
      unsigned char* dst = xdst + (size_t)r * BK * xelt + c * 16;
      if (vec) {
        const bool in = k < K;
        const unsigned char* src = static_cast<const unsigned char*>(g.x) +
                                   (in ? ((size_t)r * K + k) * xelt : 0);
        cp_async16(dst, src, in ? 16 : 0);
      } else {
        for (int e = 0; e < per; ++e) {
          const bool in = k + e < K;
          const size_t off = (size_t)r * K + k + e;
          if (xelt == 4) {
            reinterpret_cast<unsigned*>(dst)[e] = in ? static_cast<const unsigned*>(g.x)[off] : 0u;
          } else if (xelt == 2) {
            reinterpret_cast<unsigned short*>(dst)[e] =
                in ? static_cast<const unsigned short*>(g.x)[off] : 0;
          } else {
            dst[e] = in ? static_cast<const unsigned char*>(g.x)[off] : 0;
          }
        }
      }
    }
  };

  // convert stage s into wt/xc[s % 2]; entries past K are zeros
  auto convert = [&](int s) {
    const int slot = s % S;
    const int kmax = min(BK, K - s * BK);
    const unsigned char* ws = w_ring + slot * T::STAGE;
    __nv_bfloat16* wdst = wt + (s & 1) * A_BN * BK;
    // one octet of k of 4 (codes) or 2 (bf16) neighbouring columns: 8 words
    // of 4 bytes, one a row; each column's 8 bf16 (looked up for K4, bits
    // copied for K2) go out as one 16-byte store. The lanes of a warp take
    // their columns in a rotated order, so that the table reads and the
    // stores of one instruction fall in different banks.
    auto octet = [&](int j8, int grp, bool tail) {
      const unsigned char* blk = ws + j8 * T::OCT;
      unsigned wd[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        wd[e] = *reinterpret_cast<const unsigned*>(blk + e * T::ROW + 4 * grp);
        if (tail && j8 * 8 + e >= kmax) wd[e] = 0;
      }
      constexpr int COLS = 4 / WELT;
#pragma unroll
      for (int i = 0; i < COLS; ++i) {
        const int ci = (i + j8) & (COLS - 1);
        const int col = COLS * grp + ci;
        unsigned p[4];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          if (WM == W_BF16) {
            p[h] = __byte_perm(wd[2 * h], wd[2 * h + 1], ci ? 0x7632 : 0x5410);
          } else {
            const unsigned lo = table[((wd[2 * h] >> (8 * ci)) & 0xFF) * A_BN + col];
            const unsigned hi = table[((wd[2 * h + 1] >> (8 * ci)) & 0xFF) * A_BN + col];
            p[h] = lo | (hi << 16);
          }
        }
        *reinterpret_cast<uint4*>(wdst + wt_off(col, j8)) = make_uint4(p[0], p[1], p[2], p[3]);
      }
    };
    // tasks: (octet, column group); 32 x 8 for codes, 32 x 16 for bf16
    constexpr int GROUPS = A_BN * WELT / 4;
    constexpr int TASKS = BK / 8 * GROUPS;
    if (kmax == BK) {
#pragma unroll
      for (int t = 0; t < TASKS / CT; ++t) octet((ct + t * CT) / GROUPS, (ct + t * CT) % GROUPS, false);
    } else {
      for (int t = ct; t < TASKS; t += CT) octet(t / GROUPS, t % GROUPS, true);
    }
    const unsigned char* xs = x_ring + (size_t)slot * M * BK * xelt;
    float* xdst = xc + (s & 1) * XR * BK;
    for (int i = ct; i < XR * BK / 4; i += CT) {
      const int m = i / (BK / 4), k4 = (i % (BK / 4)) * 4;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = m < M && k4 + e < kmax
                   ? convert_x(x_mode, xs, (size_t)m * BK + k4 + e, g, act, x_eb, x_ss)
                   : 0.f;
      }
      *reinterpret_cast<float4*>(xdst + m * BK + k4) = make_float4(v[0], v[1], v[2], v[3]);
    }
  };

  float acc[RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) acc[j] = 0.f;
  const int row0 = warp * RPT;

  if (converter) {
    for (int s = 0; s < S - 1; ++s) {
      if (s < num_k) fill(s);
      cp_async_commit();
    }
    cp_async_wait<S - 2>();
  }
  __syncthreads();  // the table and stage 0 are in shared memory
  if (converter && num_k > 0) convert(0);

  for (int it = 0; it < num_k; ++it) {
    if (converter) cp_async_wait<S - 3>();  // stage it + 1 has landed (own copies)
    __syncthreads();  // ... everyone's; stage it is converted; buffers of it - 1 are free
    if (converter) {
      if (it + S - 1 < num_k) fill(it + S - 1);
      cp_async_commit();
      if (it + 1 < num_k) convert(it + 1);
    } else {
      const __nv_bfloat16* wcol = wt + (it & 1) * A_BN * BK;
      const float* xrow = xc + (it & 1) * XR * BK + row0 * BK;
      // one octet of k: 8 weights of this lane's column and 8 x of each row,
      // loaded one octet ahead of its products
      struct Octet {
        uint4 w;
        float4 x[RPT][2];
      };
      auto load = [&](int j8, Octet& o) {
        o.w = *reinterpret_cast<const uint4*>(wcol + wt_off(lane, j8));
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          o.x[j][0] = *reinterpret_cast<const float4*>(xrow + j * BK + j8 * 8);
          o.x[j][1] = *reinterpret_cast<const float4*>(xrow + j * BK + j8 * 8 + 4);
        }
      };
      auto widen = [](const uint4& q, float (&v)[8]) {
        const unsigned u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          v[2 * h] = __uint_as_float(u[h] << 16);
          v[2 * h + 1] = __uint_as_float(u[h] & 0xFFFF0000u);
        }
      };
      auto sum = [&](const Octet& o) {
        float w8[8];
        widen(o.w, w8);
        float xv[RPT][8];
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          xv[j][0] = o.x[j][0].x, xv[j][1] = o.x[j][0].y, xv[j][2] = o.x[j][0].z;
          xv[j][3] = o.x[j][0].w, xv[j][4] = o.x[j][1].x, xv[j][5] = o.x[j][1].y;
          xv[j][6] = o.x[j][1].z, xv[j][7] = o.x[j][1].w;
        }
        // k outer, rows inner: the rows' chains are independent, so their
        // fused multiply-adds issue back to back and share each k's latency
#pragma unroll
        for (int e = 0; e < 8; ++e)
#pragma unroll
          for (int j = 0; j < RPT; ++j) acc[j] = __fmaf_rn(xv[j][e], w8[e], acc[j]);
      };
      const int n8 = (min(BK, K - it * BK) + 7) / 8;
      // a ring of 4 octets in registers, loaded 3 octets ahead of their
      // products: the converter warps' traffic makes shared loads slow
      Octet o[4];
      if (n8 == BK / 8) {
#pragma unroll
        for (int j8 = 0; j8 < 3; ++j8) load(j8, o[j8]);
#pragma unroll
        for (int j8 = 0; j8 < BK / 8; ++j8) {
          if (j8 + 3 < BK / 8) load(j8 + 3, o[(j8 + 3) & 3]);
          sum(o[j8 & 3]);
        }
      } else {
        for (int j8 = 0; j8 < n8; ++j8) {
          load(j8, o[0]);
          sum(o[0]);
        }
      }
    }
  }
  if (converter) {
    cp_async_wait<0>();
    return;
  }

  QParams res{0.f, 0, 0, 0};
  if (g.requantize_out) res = load_qparams(g.res_f, g.res_i);
  const int n = n0 + lane;
  if (n < N) {
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      if (row0 + j < M) store_out(g, out_bf16, res, row0 + j, n, acc[j]);
    }
  }
}

template <int WM, int RPT>
inline int launch_stream(const GemmArgs& g, int x_mode, int out_bf16, int vec,
                         cudaStream_t stream) {
  constexpr int S = StreamTile<WM>::STAGES;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(stream_gemm_kernel<WM, RPT, S>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               A_MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((g.N + A_BN - 1) / A_BN);
  const size_t bytes = stream_smem_bytes<WM>(g.M, x_mode, S);
  const int threads = 32 * (stream_warps(g.M) + A_CONVERT_WARPS);
  stream_gemm_kernel<WM, RPT, S><<<grid, threads, bytes, stream>>>(g, x_mode, out_bf16, vec);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// Route B: tensor-core tiles (mma.sync m16n8k16 bf16, f32 accumulators)

constexpr int B_BM = 128, B_BN = 128, B_BK = 32, B_THREADS = 256;

// element offsets in the swizzled bf16 tiles: A is [BM][BK] (k contiguous,
// four 16-byte chunks a row, chunk ^= (m / 2) % 4); B is [BK][BN] (n
// contiguous, sixteen chunks a row, chunk ^= k % 8)
__device__ __forceinline__ int a_off(int m, int k) {
  return m * B_BK + ((((k >> 3) ^ (m >> 1)) & 3) << 3) + (k & 7);
}
__device__ __forceinline__ int b_off(int k, int n) {
  return k * B_BN + (((n >> 3) ^ (k & 7)) << 3) + (n & 7);
}

// Raw operand pieces a thread holds between the global load and the
// shared-memory store: 16 bytes of x (f32: four such per thread; bf16: two;
// codes: one) and of w (bf16: two; codes: four of 4 bytes).
template <int XM>
struct XPieces {
  static constexpr int COUNT = XM == X_F32 ? 4 : (XM == X_BF16 ? 2 : 1);
  static constexpr int ELEMS = XM == X_F32 ? 4 : (XM == X_BF16 ? 8 : 16);
  // the piece's row and first k within the tile
  __device__ static int row(int tid, int j) {
    return XM == X_F32 ? (tid >> 3) + 32 * j : (XM == X_BF16 ? (tid >> 2) + 64 * j : tid >> 1);
  }
  __device__ static int col(int tid) {
    return XM == X_F32 ? (tid & 7) * 4 : (XM == X_BF16 ? (tid & 3) * 8 : (tid & 1) * 16);
  }
};

template <int WM>
struct WPieces {
  static constexpr int COUNT = WM == W_BF16 ? 2 : 4;
  static constexpr int ELEMS = WM == W_BF16 ? 8 : 4;
  __device__ static int row(int tid, int j) {
    return WM == W_BF16 ? (tid >> 4) + 16 * j : (tid >> 5) + 8 * j;
  }
  __device__ static int col(int tid) { return WM == W_BF16 ? (tid & 15) * 8 : (tid & 31) * 4; }
};

template <int XM, int WM>
__global__ void __launch_bounds__(B_THREADS) mma_gemm_kernel(GemmArgs g, int out_bf16, int vec) {
  __shared__ __align__(128) __nv_bfloat16 a_s[2][B_BM * B_BK];
  __shared__ __align__(128) __nv_bfloat16 b_s[2][B_BK * B_BN];
  using XP = XPieces<XM>;
  using WP = WPieces<WM>;
  constexpr int XELT = XM == X_F32 ? 4 : (XM == X_BF16 ? 2 : 1);

  const int M = g.M, N = g.N, K = g.K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp >> 2, warp_n = warp & 3;
  const int m0 = blockIdx.y * B_BM, n0 = blockIdx.x * B_BN;

  QParams act{0.f, 0, 0, 0};
  if (XM == X_F32 && g.quantize_x) act = load_qparams(g.act_f, g.act_i);
  int x_eb = 0;
  float x_ss = 0.f;
  if (XM == X_CODES) unpack_consts(*g.x_bias, g.x_mant, x_eb, x_ss);
  // a thread's weight columns are the same in every K-slice: their decode
  // constants stay in registers
  int w_eb[WP::ELEMS];
  float w_ss[WP::ELEMS];
#pragma unroll
  for (int e = 0; e < WP::ELEMS; ++e) {
    w_eb[e] = 0;
    w_ss[e] = 0.f;
    const int col = n0 + WP::col(tid) + e;
    if (WM == W_CODES && col < N) unpack_consts(g.w_bias[col], g.w_mant, w_eb[e], w_ss[e]);
  }

  uint4 xr[XP::COUNT];
  uint4 wr[WM == W_BF16 ? WP::COUNT : 1];
  unsigned wc[WM == W_CODES ? WP::COUNT : 1];

  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < XP::COUNT; ++j) {
      const int r = m0 + XP::row(tid, j), k = k0 + XP::col(tid);
      if (vec) {
        xr[j] = (r < M && k < K)
                    ? *reinterpret_cast<const uint4*>(static_cast<const unsigned char*>(g.x) +
                                                      ((size_t)r * K + k) * XELT)
                    : make_uint4(0, 0, 0, 0);
      } else {
        unsigned char bytes[16];
#pragma unroll
        for (int e = 0; e < XP::ELEMS; ++e) {
          const bool in = r < M && k + e < K;
          const unsigned char* src =
              static_cast<const unsigned char*>(g.x) + ((size_t)r * K + k + e) * XELT;
#pragma unroll
          for (int b = 0; b < XELT; ++b) bytes[e * XELT + b] = in ? src[b] : 0;
        }
        memcpy(&xr[j], bytes, 16);
      }
    }
#pragma unroll
    for (int j = 0; j < WP::COUNT; ++j) {
      const int k = k0 + WP::row(tid, j), c = n0 + WP::col(tid);
      const unsigned char* base = static_cast<const unsigned char*>(g.w);
      if (WM == W_BF16) {
        if (vec) {
          wr[j] = (k < K && c < N)
                      ? *reinterpret_cast<const uint4*>(base + ((size_t)k * N + c) * 2)
                      : make_uint4(0, 0, 0, 0);
        } else {
          unsigned short h[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            h[e] = (k < K && c + e < N)
                       ? reinterpret_cast<const unsigned short*>(base)[(size_t)k * N + c + e]
                       : 0;
          }
          memcpy(&wr[j], h, 16);
        }
      } else {
        if (vec) {
          wc[j] = (k < K && c < N)
                      ? *reinterpret_cast<const unsigned*>(base + (size_t)k * N + c)
                      : 0u;
        } else {
          unsigned v = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (k < K && c + e < N) v |= (unsigned)base[(size_t)k * N + c + e] << (8 * e);
          }
          wc[j] = v;
        }
      }
    }
  };

  auto store = [&](int buf) {
    __nv_bfloat16* as = a_s[buf];
    __nv_bfloat16* bs = b_s[buf];
#pragma unroll
    for (int j = 0; j < XP::COUNT; ++j) {
      const int r = XP::row(tid, j), k = XP::col(tid);
      if (XM == X_F32) {
        float v[4];
        memcpy(v, &xr[j], 16);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (g.quantize_x) v[e] = quantize_block(v[e], act);
        *reinterpret_cast<uint2*>(as + a_off(r, k)) =
            make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
      } else if (XM == X_BF16) {
        *reinterpret_cast<uint4*>(as + a_off(r, k)) = xr[j];
      } else {
        unsigned char c[16];
        memcpy(c, &xr[j], 16);
        unsigned p[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          p[e] = pack_bf16x2(unpack_exmy_bits(c[2 * e], g.x_expo, g.x_mant, x_eb, x_ss),
                             unpack_exmy_bits(c[2 * e + 1], g.x_expo, g.x_mant, x_eb, x_ss));
        }
        *reinterpret_cast<uint4*>(as + a_off(r, k)) = make_uint4(p[0], p[1], p[2], p[3]);
        *reinterpret_cast<uint4*>(as + a_off(r, k + 8)) = make_uint4(p[4], p[5], p[6], p[7]);
      }
    }
#pragma unroll
    for (int j = 0; j < WP::COUNT; ++j) {
      const int k = WP::row(tid, j), c = WP::col(tid);
      if (WM == W_BF16) {
        *reinterpret_cast<uint4*>(bs + b_off(k, c)) = wr[j];
      } else {
        const unsigned q = wc[j];
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = unpack_exmy_bits((q >> (8 * e)) & 0xFF, g.w_expo, g.w_mant, w_eb[e], w_ss[e]);
        *reinterpret_cast<uint2*>(bs + b_off(k, c)) =
            make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
      }
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  auto compute = [&](int buf) {
    const __nv_bfloat16* as = a_s[buf];
    const __nv_bfloat16* bs = b_s[buf];
#pragma unroll
    for (int ks = 0; ks < B_BK / 16; ++ks) {
      unsigned af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int r = warp_m * 64 + mt * 16 + (lane & 15);
        ldmatrix_x4(af[mt], as + a_off(r, ks * 16 + (lane >> 4) * 8));
      }
      unsigned bf[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int mi = lane >> 3;
        const int k = ks * 16 + (mi & 1) * 8 + (lane & 7);
        const int c = warp_n * 32 + np * 16 + (mi >> 1) * 8;
        unsigned r4[4];
        ldmatrix_x4_trans(r4, bs + b_off(k, c));
        bf[2 * np][0] = r4[0];
        bf[2 * np][1] = r4[1];
        bf[2 * np + 1][0] = r4[2];
        bf[2 * np + 1][1] = r4[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    }
  };

  const int num_k = (K + B_BK - 1) / B_BK;
  if (num_k > 0) {
    load(0);
    store(0);
  }
  __syncthreads();
  for (int t = 0; t < num_k; ++t) {
    if (t + 1 < num_k) load((t + 1) * B_BK);
    compute(t & 1);
    if (t + 1 < num_k) store((t + 1) & 1);
    __syncthreads();
  }

  QParams res{0.f, 0, 0, 0};
  if (g.requantize_out) res = load_qparams(g.res_f, g.res_i);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int r = m0 + warp_m * 64 + mt * 16 + (lane >> 2);
      const int c = n0 + warp_n * 32 + nt * 8 + (lane & 3) * 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = r + (e >> 1) * 8, cc = c + (e & 1);
        if (rr < M && cc < N) store_out(g, out_bf16, res, rr, cc, acc[mt][nt][e]);
      }
    }
  }
}

template <int XM, int WM>
inline int launch_mma(const GemmArgs& g, int out_bf16, int vec, cudaStream_t stream) {
  const dim3 grid((g.N + B_BN - 1) / B_BN, (g.M + B_BM - 1) / B_BM);
  mma_gemm_kernel<XM, WM><<<grid, B_THREADS, 0, stream>>>(g, out_bf16, vec);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------

// Whether every row of x and w starts on a 16-byte boundary (the vector
// loads and cp.async copies need it; other shapes load element by element).
inline int rows_aligned(const GemmArgs& g, int x_mode, int welt) {
  const auto addr = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
  return ((size_t)g.K * x_elt_bytes(x_mode)) % 16 == 0 && ((size_t)g.N * welt) % 16 == 0 &&
         addr(g.x) % 16 == 0 && addr(g.w) % 16 == 0;
}

template <int XM, int WM>
inline int launch_route(const GemmArgs& g, int out_bf16, cudaStream_t stream) {
  const int vec = rows_aligned(g, XM, WM == W_CODES ? 1 : 2);
  if (g.M > g.route_a_max_m) return launch_mma<XM, WM>(g, out_bf16, vec, stream);
  switch (stream_rows_per_warp(g.M)) {
    case 1: return launch_stream<WM, 1>(g, XM, out_bf16, vec, stream);
    case 2: return launch_stream<WM, 2>(g, XM, out_bf16, vec, stream);
    default: return launch_stream<WM, 4>(g, XM, out_bf16, vec, stream);
  }
}

// One launch for runtime (x mode, out dtype), the route chosen by M; the w
// mode is the caller's. Coded x exists only beside coded w (K4).
template <int WM>
inline int dispatch_gemm(const GemmArgs& g, int x_mode, int out_bf16, cudaStream_t stream) {
  if (g.route_a_max_m < 0 || g.route_a_max_m > A_MAX_ROWS) return (int)cudaErrorInvalidValue;
  if (g.M <= 0 || g.N <= 0) return (int)cudaSuccess;
  if ((g.M + B_BM - 1) / B_BM > 65535) return (int)cudaErrorInvalidValue;
  if (x_mode == X_F32) return launch_route<X_F32, WM>(g, out_bf16, stream);
  if (x_mode == X_BF16) return launch_route<X_BF16, WM>(g, out_bf16, stream);
  if constexpr (WM == W_CODES) {
    if (x_mode == X_CODES) return launch_route<X_CODES, WM>(g, out_bf16, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace fp8q
