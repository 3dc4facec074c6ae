// The int4 nibble GEMM (K5) for Hopper.
//
// Replaces fp8_quantization_tpu/ops/pallas/dequant_matmul.py::int4_matmul:
// (M,K) int8 activation codes times nibble-packed int4 weight codes, the
// exact (M,N) int32 product. w4 is (ceil(K/2),N) uint8 in the split-K-halves
// layout of fastpath.pack_int4: byte row r holds code row r in its low nibble
// and code row r + ceil(K/2) in its high nibble, so
//   out = x[:, :K2] @ lo(w4) + x[:, K2:] @ hi(w4).
//
// Integer sums are exact in any order (|x| <= 128, |w| <= 8, K <= 65536 keep
// 16 x every sum below 2^31), so the kernel may tile and split K freely and
// still give the plain version's answer bit for bit. Both routes run on the
// tensor cores (mma.sync m16n8k32 s8 x s8 -> s32). A nibble becomes an s8
// operand without a sign-extend: (b << 4) & 0xF0 is 16 x the low code and
// b & 0xF0 16 x the high code; the sums are divided by 16 at the end (exact:
// each is a multiple of 16). The .col operand wants 4 consecutive k of one
// column in a word while w4 holds 4 neighbouring columns of one k, so 4x4
// byte blocks are transposed with __byte_perm on the way. One launch a call;
// the route depends on M alone (the wrapper passes the threshold).
//
// Route A (decode, M <= 16): bound by the weight bytes (0.5 a weight),
// which need many 16-byte loads in flight on every SM. One CTA of 4 warps
// owns 128 columns and a range of K; the warps take its 32-row steps in
// turn, each loading a step's weights (16-byte loads straight into
// registers: cp.async rings of the same pattern stream at about 60% of
// their rate on an H100, eval/stream_read.py) and the x words it needs
// while it multiplies the step before, with no barrier in the loop. It transposes the weights in
// registers into the A operand (16 columns by 32 k) to multiply x^T as the
// B operand (8 rows of x an mma). The warps' sums meet in shared memory,
// and K is split across a thread-block cluster of up to 8 CTAs so that the
// grid fills the card in one wave; the CTAs of a cluster add their sums
// into CTA 0's through distributed shared memory (one cluster barrier) and
// CTA 0 stores the tile: no memset and no global atomics.
//
// Route B (prefill, M > 16): a CTA of 4 warps owns a 32- or 64-row by
// 128-column tile and walks K in stages of 64 packed rows through a 3-stage
// cp.async ring (x rows and raw weight bytes); each stage's bytes are
// expanded once into an s8 [column][k] tile (the transpose) that all its
// row tiles read with ldmatrix. When the tiles leave the SMs idle (small M,
// small N) K is split across a cluster as in route A.
//
// Plain version: fp8_quantization_tpu_torch/ops/cuda/dequant_matmul.py::
// int4_matmul_plain.

#include <cooperative_groups.h>

#include <cstdint>

#include <cuda_runtime.h>

#include "mma.cuh"
#include "stamps.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_K = 65536;     // 16 x the largest sum stays below 2^31
constexpr int A_MAX_ROWS = 16;   // route A holds 16 rows of x (two n8 tiles)
constexpr int MAX_CLUSTER = 8;   // portable cluster size
constexpr int COLS = 128;        // columns per CTA (both routes)
constexpr int THREADS = 128;     // 4 warps (both routes)
constexpr int WARPS = THREADS / 32;
constexpr int STEP = 32;         // packed rows of one route A step (one k32 mma pair)
constexpr int A_CHUNKS = 8;      // 16-byte weight loads a lane makes per step
constexpr int A_MIN_CTAS_PER_SM = 3;
constexpr int B_ROWS = 64;       // packed rows of one route B stage
constexpr int B_STAGES = 3;

struct Int4Args {
  const signed char* x;     // (M, K)
  const unsigned char* w;   // (K2, N)
  int* out;                 // (M, N)
  int M, N, K, K2;
  int rows_per_split;       // packed rows per CTA along K, a multiple of 64 (route B)
                            // or 32 (route A)
  int splits;               // CTAs of a cluster along K (grid z)
};

using fp8q::cp_async16;
using fp8q::cp_async_commit;
using fp8q::cp_async_wait;

// 4 words, rows 0..3 of 4 columns (byte j = column j) -> 4 words, column j
// with byte i = row i
__device__ __forceinline__ void transpose4x4(unsigned r0, unsigned r1, unsigned r2,
                                             unsigned r3, unsigned (&c)[4]) {
  const unsigned t01 = __byte_perm(r0, r1, 0x5140);
  const unsigned t23 = __byte_perm(r2, r3, 0x5140);
  const unsigned s01 = __byte_perm(r0, r1, 0x7362);
  const unsigned s23 = __byte_perm(r2, r3, 0x7362);
  c[0] = __byte_perm(t01, t23, 0x5410);
  c[1] = __byte_perm(t01, t23, 0x7632);
  c[2] = __byte_perm(s01, s23, 0x5410);
  c[3] = __byte_perm(s01, s23, 0x7632);
}

// 16 x the low and the high codes of four packed bytes, as s8 lanes
__device__ __forceinline__ unsigned lo16(unsigned v) { return (v << 4) & 0xF0F0F0F0u; }
__device__ __forceinline__ unsigned hi16(unsigned v) { return v & 0xF0F0F0F0u; }

// 16 bytes of a row at column n0 (zero past the matrix), by byte loads: the
// path of shapes whose rows are not 16-byte aligned
__device__ __forceinline__ uint4 load16_bytes(const unsigned char* row, int n0, int n_end) {
  unsigned v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (n0 + j < n_end) v[j >> 2] |= (unsigned)__ldg(row + n0 + j) << (8 * (j & 3));
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// ---------------------------------------------------------------- route A

// Route A's split K (grid z, a cluster): CTA 0's sums (rows x COLS int32)
// start at zero, released to the cluster at the kernel's start (the
// barrier's first phase, long complete when the adds come); every CTA adds
// its partial sums into them through distributed shared memory, and after
// the barrier's second phase CTA 0 stores the tile. One barrier, at most
// 16 x 128 adds a CTA; route B's tiles (up to 64 x 128) pull instead
// (combine_and_store): adding them into one CTA took up to 2.8x as long
// (17 x 4096 x 4096 on an H100).
__device__ __forceinline__ void cluster_begin(int* sums, int n) {
  for (int i = threadIdx.x; i < n; i += THREADS) sums[i] = 0;
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

// CTA 0's sums, once every CTA has zeroed its own
__device__ __forceinline__ int* cluster_sums0(int* sums) {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  return cg::this_cluster().map_shared_rank(sums, 0);
}

__device__ __forceinline__ void cluster_end(const Int4Args& a, const int* sums, int m0,
                                            int rows, int c0) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (cluster.block_rank() != 0) return;
  for (int i = threadIdx.x; i < rows * COLS; i += THREADS) {
    const int m = i / COLS, c = i % COLS;
    if (m0 + m < a.M && c0 + c < a.N) a.out[(size_t)(m0 + m) * a.N + c0 + c] = sums[i];
  }
}


// Route A's dynamic shared memory: each warp's sums (WARPS x M x COLS
// int32), then the cluster's (M x COLS)
__host__ __device__ inline size_t a_smem(int M) { return (size_t)(WARPS + 1) * M * COLS * 4; }



// One step of a lane's operands: the weight bytes of rows 4t..4t+3 and
// 16+4t..16+4t+3 at its 16 columns, and per 8 rows of x (row 8h + g) the
// words at k 4t and 16 + 4t of the low half, then of the high half.
template <int H>
struct StepData {
  uint4 w[A_CHUNKS];
  uint4 x[H];
};

template <bool VEC, int H>
__device__ __forceinline__ void load_step(const Int4Args& a, int r0, int r_end, int col, int g,
                                          int t, StepData<H>& d) {
#pragma unroll
  for (int c = 0; c < A_CHUNKS; ++c) {
    const int r = r0 + (c < 4 ? 4 * t + c : 16 + 4 * t + c - 4);
    const bool ok = r < r_end && col < a.N;
    if (VEC) {
      d.w[c] = ok ? __ldg(reinterpret_cast<const uint4*>(a.w + (size_t)r * a.N + col))
                  : make_uint4(0, 0, 0, 0);
    } else {
      d.w[c] = ok ? load16_bytes(a.w + (size_t)r * a.N, col, a.N) : make_uint4(0, 0, 0, 0);
    }
  }
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int m = 8 * h + g;
    unsigned v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = r0 + 4 * t + 16 * (q & 1);        // packed row of the word
      const int k = (q >= 2 ? a.K2 : 0) + r;
      v[q] = 0u;
      if (VEC) {
        if (m < a.M && r < r_end)
          v[q] = __ldg(reinterpret_cast<const unsigned*>(a.x + (size_t)m * a.K + k));
      } else if (m < a.M) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (r + j < r_end && k + j < a.K)
            v[q] |= (unsigned)(unsigned char)a.x[(size_t)m * a.K + k + j] << (8 * j);
      }
    }
    d.x[h] = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// acc += the step: tile j's row g is column 16g + j, its row g + 8 column
// 16g + 8 + j
template <int H>
__device__ __forceinline__ void mma_step(const StepData<H>& d, int (&acc)[H][8][4]) {
  unsigned t0[16], t1[16];   // column 16g + j of k-quad t and of 16 + 4t.. as words
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    unsigned c4[4];
    transpose4x4((&d.w[0].x)[q], (&d.w[1].x)[q], (&d.w[2].x)[q], (&d.w[3].x)[q], c4);
#pragma unroll
    for (int j = 0; j < 4; ++j) t0[4 * q + j] = c4[j];
    transpose4x4((&d.w[4].x)[q], (&d.w[5].x)[q], (&d.w[6].x)[q], (&d.w[7].x)[q], c4);
#pragma unroll
    for (int j = 0; j < 4; ++j) t1[4 * q + j] = c4[j];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const unsigned alo[4] = {lo16(t0[j]), lo16(t0[j + 8]), lo16(t1[j]), lo16(t1[j + 8])};
    const unsigned ahi[4] = {hi16(t0[j]), hi16(t0[j + 8]), hi16(t1[j]), hi16(t1[j + 8])};
#pragma unroll
    for (int h = 0; h < H; ++h) {
      fp8q::mma_s8(acc[h][j], alo, d.x[h].x, d.x[h].y);
      fp8q::mma_s8(acc[h][j], ahi, d.x[h].z, d.x[h].w);
    }
  }
}

template <bool VEC, bool TWO>   // TWO: M > 8, two n8 tiles of x rows
__global__ void __launch_bounds__(THREADS, A_MIN_CTAS_PER_SM) int4_stream_kernel(Int4Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int H = TWO ? 2 : 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = blockIdx.x * COLS;
  const int R = a.rows_per_split;
  const int r_begin = blockIdx.z * R;
  const int r_end = min(a.K2, r_begin + R);
  const int tile = a.M * COLS;
  int* part = reinterpret_cast<int*>(smem);   // [warp][m][column]
  int* sums = part + WARPS * tile;            // the cluster's, in CTA 0
  STAMP_DECL

  if (a.splits > 1) cluster_begin(sums, tile);

  // this warp's steps: w, w + WARPS, ... of the CTA's range; lane (g, t)
  // reads columns c0 + 16g .. + 15
  const int steps = (r_end - r_begin + STEP - 1) / STEP;
  const int mine = steps > warp ? (steps - warp + WARPS - 1) / WARPS : 0;
  const int col = c0 + 16 * g;
  auto row0 = [&](int i) { return r_begin + (warp + i * WARPS) * STEP; };

  int acc[H][8][4];
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h][j][e] = 0;

  // two steps in registers: the next one loads while this one multiplies
  StepData<H> d0, d1;
  if (mine > 0) load_step<VEC, H>(a, row0(0), r_end, col, g, t, d0);
  STAMP(0);
  for (int i = 0; i < mine; i += 2) {
    if (i + 1 < mine) load_step<VEC, H>(a, row0(i + 1), r_end, col, g, t, d1);
    mma_step<H>(d0, acc);
    if (i + 1 >= mine) break;
    if (i + 2 < mine) load_step<VEC, H>(a, row0(i + 2), r_end, col, g, t, d0);
    mma_step<H>(d1, acc);
  }
  STAMP(1);

  // the warps' sums meet in shared memory: acc[h][j] e = 0, 1 at column
  // 16g + j, e = 2, 3 at 16g + 8 + j; rows 8h + 2t + (e & 1)
  int* mine_part = part + warp * tile;
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 8 * h + 2 * t + (e & 1);
        if (m < a.M) mine_part[m * COLS + 16 * g + j + (e >> 1) * 8] = acc[h][j][e] >> 4;
      }
  __syncthreads();
  STAMP(4);
  auto cta_sum = [&](int i) {
    int v = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) v += part[w * tile + i];
    return v;
  };
  if (a.splits == 1) {
    for (int i = tid; i < tile; i += THREADS) {
      const int m = i / COLS, c = i % COLS;
      if (c0 + c < a.N) a.out[(size_t)m * a.N + c0 + c] = cta_sum(i);
    }
  } else {
    int* sums0 = cluster_sums0(sums);
    for (int i = tid; i < tile; i += THREADS) atomicAdd(sums0 + i, cta_sum(i));
    cluster_end(a, sums, 0, a.M, c0);
  }
  STAMP(5);
  STAMP_STORE((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x);
}

// ---------------------------------------------------------------- route B

// Route B's split K: every CTA has its partial sums of the tile in red
// (rows x COLS int32); after a cluster barrier each CTA adds a share of
// the tile's elements over the cluster's CTAs in rank order and stores it,
// and a second barrier keeps every CTA's shared memory until the others
// have read it.
__device__ void combine_and_store(const Int4Args& a, int* red, int m0, int rows, int c0) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int n = rows * COLS;
  const int rank = (int)cluster.block_rank();
  const int share = (n + a.splits - 1) / a.splits;
  const int end = min(n, (rank + 1) * share);
  for (int i = rank * share + threadIdx.x; i < end; i += THREADS) {
    const int m = i / COLS, c = i % COLS;
    if (m0 + m >= a.M || c0 + c >= a.N) continue;
    int sum = 0;
    for (int r = 0; r < a.splits; ++r) sum += cluster.map_shared_rank(red, r)[i];
    a.out[(size_t)(m0 + m) * a.N + c0 + c] = sum;
  }
  cluster.sync();
}

// Route B's dynamic shared memory: [x ring: B_STAGES x BM x 128]
// [w ring: B_STAGES x 64 x 128][s8 tile: COLS x 128]; the split-K partials
// (BM x COLS int32) reuse the rings after the loop.
__host__ __device__ inline size_t b_smem(int BM) {
  return (size_t)B_STAGES * BM * 128 + (size_t)B_STAGES * B_ROWS * 128 + (size_t)COLS * 128;
}

// 16-byte unit u of row n of the s8 tile, swizzled so that ldmatrix's 8
// consecutive rows and the expansion's rows 4 apart both hit 8 distinct
// units of the banks
__device__ __forceinline__ int bswz(int n, int u) { return n * 128 + ((u ^ ((n + (n >> 3)) & 7)) << 4); }
__device__ __forceinline__ int xswz(int m, int u) { return m * 128 + ((u ^ (m & 7)) << 4); }

template <int BM, bool VEC>
__global__ void __launch_bounds__(THREADS) int4_mma_kernel(Int4Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int MT = BM / 32;      // m16 tiles per warp (warps 2 x 2: BM/2 rows, 64 columns)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.y * BM, c0 = blockIdx.x * COLS;
  const int R = a.rows_per_split;
  const int r_begin = blockIdx.z * R;
  const int r_end = min(a.K2, r_begin + R);
  const int nstages = (r_end - r_begin + B_ROWS - 1) / B_ROWS;
  unsigned char* xring = smem;
  unsigned char* wring = smem + B_STAGES * BM * 128;
  unsigned char* tile = wring + B_STAGES * B_ROWS * 128;
  STAMP_DECL

  auto load = [&](int s) {
    const int slot = s % B_STAGES;
    const int rs = r_begin + s * B_ROWS;
    // x: per row 4 units of the low half, then 4 of the high half
    for (int q = tid; q < BM * 8; q += THREADS) {
      const int m = q >> 3, u = q & 7;
      const int r = rs + 16 * (u & 3);
      const bool ok = m0 + m < a.M && r < r_end;
      unsigned char* dst = xring + slot * BM * 128 + xswz(m, u);
      const size_t off = ok ? (size_t)(m0 + m) * a.K + (u >= 4 ? a.K2 : 0) + r : 0;
      if (VEC) {
        cp_async16(dst, a.x + off, ok ? 16 : 0);
      } else {
        unsigned v[4] = {0u, 0u, 0u, 0u};
        if (m0 + m < a.M) {
          for (int j = 0; j < 16; ++j) {
            const int rr = r + j, k = (u >= 4 ? a.K2 : 0) + rr;
            if (rr < r_end && k < a.K)
              v[j >> 2] |= (unsigned)(unsigned char)a.x[(size_t)(m0 + m) * a.K + k]
                           << (8 * (j & 3));
          }
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    // raw weight bytes: 64 rows of 8 units
    for (int q = tid; q < B_ROWS * 8; q += THREADS) {
      const int rr = q >> 3, u = q & 7;
      const int r = rs + rr, col = c0 + 16 * u;
      const bool ok = r < r_end && col < a.N;
      unsigned char* dst = wring + slot * B_ROWS * 128 + rr * 128 + 16 * u;
      if (VEC) {
        cp_async16(dst, a.w + (ok ? (size_t)r * a.N + col : 0), ok ? 16 : 0);
      } else {
        *reinterpret_cast<uint4*>(dst) =
            ok ? load16_bytes(a.w + (size_t)r * a.N, col, a.N) : make_uint4(0, 0, 0, 0);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < B_STAGES - 1; ++s) {
    if (s < nstages) load(s);
    cp_async_commit();
  }

  int acc[MT][8][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  STAMP(0);

  for (int s = 0; s < nstages; ++s) {
    cp_async_wait<B_STAGES - 2>();
    __syncthreads();   // stage s landed everywhere; stage s - 1 is read
    STAMP(1);
    const int slot = s % B_STAGES;
    {
      // expansion: warp w takes packed rows 16w .. 16w + 15, lane the
      // columns 4 lane .. 4 lane + 3
      const unsigned char* wr = wring + slot * B_ROWS * 128 + 4 * lane;
      unsigned raw[16];
#pragma unroll
      for (int i = 0; i < 16; ++i)
        raw[i] = *reinterpret_cast<const unsigned*>(wr + (16 * warp + i) * 128);
      unsigned col[4][4];   // [row quad][column]
#pragma unroll
      for (int q = 0; q < 4; ++q)
        transpose4x4(raw[4 * q], raw[4 * q + 1], raw[4 * q + 2], raw[4 * q + 3], col[q]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = 4 * lane + j;
        *reinterpret_cast<uint4*>(tile + bswz(n, warp)) =
            make_uint4(lo16(col[0][j]), lo16(col[1][j]), lo16(col[2][j]), lo16(col[3][j]));
        *reinterpret_cast<uint4*>(tile + bswz(n, 4 + warp)) =
            make_uint4(hi16(col[0][j]), hi16(col[1][j]), hi16(col[2][j]), hi16(col[3][j]));
      }
    }
    if (s + B_STAGES - 1 < nstages) load(s + B_STAGES - 1);
    cp_async_commit();
    __syncthreads();   // the s8 tile is complete
    STAMP(2);

    const unsigned char* xt = xring + slot * BM * 128;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {   // k32 steps: units 2ks, 2ks + 1
      unsigned af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int m = wm * (BM / 2) + 16 * i + (lane & 7) + 8 * ((lane >> 3) & 1);
        fp8q::ldmatrix_x4(af[i], xt + xswz(m, 2 * ks + (lane >> 4)));
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int mi = lane >> 3;
        const int n = wn * 64 + 8 * (2 * np + (mi >> 1)) + (lane & 7);
        unsigned bf[4];
        fp8q::ldmatrix_x4(bf, tile + bswz(n, 2 * ks + (mi & 1)));
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          fp8q::mma_s8(acc[i][2 * np], af[i], bf[0], bf[1]);
          fp8q::mma_s8(acc[i][2 * np + 1], af[i], bf[2], bf[3]);
        }
      }
    }
    STAMP(3);
  }

  // acc[i][j]: rows wm * BM/2 + 16i + g (e < 2) or + 8 (e >= 2), columns
  // wn * 64 + 8j + 2t + (e & 1)
  if (a.splits == 1) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + wm * (BM / 2) + 16 * i + g + (e >> 1) * 8;
          const int n = c0 + wn * 64 + 8 * j + 2 * t + (e & 1);
          if (m < a.M && n < a.N) a.out[(size_t)m * a.N + n] = acc[i][j][e] >> 4;
        }
    STAMP(5);
  } else {
    cp_async_wait<0>();
    __syncthreads();   // the rings are free
    int* red = reinterpret_cast<int*>(smem);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = wm * (BM / 2) + 16 * i + g + (e >> 1) * 8;
          const int n = wn * 64 + 8 * j + 2 * t + (e & 1);
          red[m * COLS + n] = acc[i][j][e] >> 4;
        }
    STAMP(4);
    combine_and_store(a, red, m0, BM, c0);
    STAMP(5);
  }
  STAMP_STORE((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x);
}

// ---------------------------------------------------------------- launch

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, size_t smem, const Int4Args& a, cudaStream_t stream,
           size_t* attr_set) {
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > *attr_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    *attr_set = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = a.splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int sm_count(int* sms) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  *sms = cached;
  return 0;
}

// Split K until the grid has about `target` CTAs (at most, with
// `at_most`): at most MAX_CLUSTER splits, each a multiple of `unit` packed
// rows and at least `least` of them. Sets rows_per_split and splits.
void split_k(Int4Args& a, long long tiles, int target, int unit, int least, bool at_most) {
  const int units = (a.K2 + unit - 1) / unit;
  int splits = (int)(at_most ? target / tiles : (target + tiles - 1) / tiles);
  splits = max(1, min(splits, min(MAX_CLUSTER, units / max(least, 1))));
  const int per = (units + splits - 1) / splits;
  a.rows_per_split = per * unit;
  a.splits = (a.K2 + a.rows_per_split - 1) / a.rows_per_split;
}

template <bool VEC>
int launch_routes(Int4Args a, int route_a_max_m, cudaStream_t stream) {
  int sms = 0;
  const int err = sm_count(&sms);
  if (err != 0) return err;
  const int tiles_n = (a.N + COLS - 1) / COLS;
  if (a.M <= route_a_max_m) {
    // one wave of at most three CTAs an SM, each at least a step for every
    // warp; whole steps, so that the CTAs of a cluster end close together
    split_k(a, tiles_n, 3 * sms, STEP, WARPS, true);
    const dim3 grid(tiles_n, 1, a.splits);
    const size_t smem = a_smem(a.M);
    if (a.M > 8) {
      static size_t attr = 0;
      return launch(int4_stream_kernel<VEC, true>, grid, smem, a, stream, &attr);
    }
    static size_t attr = 0;
    return launch(int4_stream_kernel<VEC, false>, grid, smem, a, stream, &attr);
  }
  const int bm = a.M <= 32 ? 32 : 64;
  const long long tiles_m = (a.M + bm - 1) / bm;
  if (tiles_m > 65535) return (int)cudaErrorInvalidValue;
  // split K only when the tiles leave most SMs idle
  split_k(a, tiles_n * tiles_m, 2 * sms, B_ROWS, 2, false);
  const dim3 grid(tiles_n, (unsigned)tiles_m, a.splits);
  if (bm == 32) {
    static size_t attr = 0;
    return launch(int4_mma_kernel<32, VEC>, grid, b_smem(32), a, stream, &attr);
  }
  static size_t attr = 0;
  return launch(int4_mma_kernel<64, VEC>, grid, b_smem(64), a, stream, &attr);
}

}  // namespace

// K5. x: (M,K) int8; w4: (ceil(K/2),N) uint8 nibble pairs; out: (M,N) int32.
// All contiguous; 1 <= K <= 65536. Route A for M <= route_a_max_m (at most
// A_MAX_ROWS), route B above. Returns cudaGetLastError() (or the reason the
// launch was refused).
extern "C" int fp8q_int4_matmul(const signed char* x, const unsigned char* w4, int* out, int M,
                                int N, int K, int route_a_max_m, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K > MAX_K || route_a_max_m < 0 ||
      route_a_max_m > A_MAX_ROWS)
    return (int)cudaErrorInvalidValue;
  Int4Args a{};
  a.x = x;
  a.w = w4;
  a.out = out;
  a.M = M;
  a.N = N;
  a.K = K;
  a.K2 = (K + 1) / 2;
  // 16-byte copies: rows of x, both halves and rows of w4 16-byte aligned
  const bool vec = K % 32 == 0 && N % 16 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(w4) & 15) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return vec ? launch_routes<true>(a, route_a_max_m, st) : launch_routes<false>(a, route_a_max_m, st);
}
