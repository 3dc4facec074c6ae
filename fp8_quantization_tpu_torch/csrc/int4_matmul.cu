// The int4 nibble GEMM (K5) for Hopper.
//
// Replaces fp8_quantization_tpu/ops/pallas/dequant_matmul.py::int4_matmul:
// (M,K) int8 activation codes times nibble-packed int4 weight codes, the
// exact (M,N) int32 product. w4 is (ceil(K/2),N) uint8 in the split-K-halves
// layout of fastpath.pack_int4: byte row r holds code row r in its low nibble
// and code row r + ceil(K/2) in its high nibble.
//
// Integer sums are exact in any order, so the kernel may tile and split K
// freely and still give the plain version's answer bit for bit. The design:
//   - a CTA of 8 warps owns a tile of BM rows by 128 columns; each lane owns
//     4 neighbouring columns and reads them with one 4-byte load per packed
//     row (a warp reads 128 contiguous bytes), four packed rows at a time,
//     16 loads in flight per thread;
//   - the 4x4 byte block is transposed in registers (__byte_perm) so that a
//     column's 4 packed rows share one word; its nibbles become int8 lanes
//     without a sign-extend: (word << 4) & 0xF0F0F0F0 holds 16 x the low
//     codes and word & 0xF0F0F0F0 16 x the high codes, and __dp4a sums four
//     products at once; the sum is divided by 16 at the end (exact: it is a
//     multiple of 16, and |sum| < 2^31 for K <= 65536);
//   - the x rows of the tile are staged in shared memory as (low, high)
//     word pairs of the two K halves (zeros past K and past M), so one 8-byte
//     shared load feeds eight __dp4a;
//   - the 8 warps take interleaved packed rows of the CTA's K range; their
//     partial sums meet in shared memory, and K is split across CTAs until
//     the card has about two CTAs per SM, the splits adding into the
//     zeroed output with int32 atomics. That fills the 132 SMs at decode
//     (M = 4), where one CTA per column tile would not.
// What bounds it: at decode the weight bytes (0.5 a weight); at prefill the
// __dp4a rate of the CUDA cores (tensor-core mma on s8 is later work).
//
// Plain version: fp8_quantization_tpu_torch/ops/cuda/dequant_matmul.py::
// int4_matmul_plain.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BN = 128;          // columns of a tile: 4 per lane
constexpr int KC = 256;          // packed rows of x staged at once
constexpr int UNROLL = 4;        // groups of 4 packed rows in flight per warp
constexpr int MAX_K = 65536;     // 16 x the largest sum stays below 2^31

struct Int4Args {
  const signed char* x;     // (M, K)
  const unsigned char* w;   // (K2, N)
  int* out;                 // (M, N)
  int M, N, K, K2;
  int rows_per_split;       // packed rows per CTA along K, a multiple of 32
  int vec;                  // N % 4 == 0 and w 4-byte aligned
};

// Columns [n0, n0 + 4) of packed row r as one little-endian word; zero past
// the matrix.
__device__ __forceinline__ unsigned int load_w(const Int4Args& a, int r, int n0) {
  const unsigned char* row = a.w + (size_t)r * a.N;
  if (a.vec) {
    return n0 < a.N ? __ldg(reinterpret_cast<const unsigned int*>(row + n0)) : 0u;
  }
  unsigned int v = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (n0 + j < a.N) v |= (unsigned int)__ldg(row + n0 + j) << (8 * j);
  return v;
}

template <int BM>
__global__ void __launch_bounds__(THREADS) int4_kernel(Int4Args a) {
  // x of the tile: per row and group of 4 packed rows, the (low, high) words
  __shared__ __align__(16) int2 xs[BM][KC / 4];
  __shared__ int red[BM][BN];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * BN + lane * 4;
  const int m0 = blockIdx.y * BM;
  const int r_begin = blockIdx.z * a.rows_per_split;
  const int r_end = min(a.K2, r_begin + a.rows_per_split);

  int acc[BM][4];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0;

  signed char* xb = reinterpret_cast<signed char*>(&xs[0][0]);
  for (int c0 = r_begin; c0 < r_end; c0 += KC) {
    const int nc = min(KC, r_end - c0);
    __syncthreads();
    // neighbouring threads read neighbouring k of one row of x
    for (int idx = tid; idx < BM * 2 * KC; idx += THREADS) {
      const int m = idx / (2 * KC);
      const int rem = idx - m * 2 * KC;
      const int half = rem / KC;
      const int i = rem - half * KC;
      const int row = m0 + m;
      const int k = half ? a.K2 + c0 + i : c0 + i;
      signed char v = 0;
      if (row < a.M && i < nc && k < a.K) v = a.x[(size_t)row * a.K + k];
      xb[((m * (KC / 4) + (i >> 2)) * 2 + half) * 4 + (i & 3)] = v;
    }
    __syncthreads();

    const int ngroups = (nc + 3) / 4;
    for (int g0 = warp; g0 < ngroups; g0 += WARPS * UNROLL) {
      unsigned int wr[UNROLL][4];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int g = g0 + u * WARPS;
#pragma unroll
        for (int r = 0; r < 4; ++r)
          wr[u][r] = (g < ngroups && 4 * g + r < nc) ? load_w(a, c0 + 4 * g + r, n0) : 0u;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int g = g0 + u * WARPS;
        if (g >= ngroups) break;
        // column j's word: byte r from packed row 4g + r
        const unsigned int t01 = __byte_perm(wr[u][0], wr[u][1], 0x5140);
        const unsigned int t23 = __byte_perm(wr[u][2], wr[u][3], 0x5140);
        const unsigned int s01 = __byte_perm(wr[u][0], wr[u][1], 0x7362);
        const unsigned int s23 = __byte_perm(wr[u][2], wr[u][3], 0x7362);
        const unsigned int col[4] = {__byte_perm(t01, t23, 0x5410), __byte_perm(t01, t23, 0x7632),
                                     __byte_perm(s01, s23, 0x5410), __byte_perm(s01, s23, 0x7632)};
        int lo[4], hi[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          lo[j] = (int)((col[j] << 4) & 0xF0F0F0F0u);   // 16 x the low-half codes
          hi[j] = (int)(col[j] & 0xF0F0F0F0u);          // 16 x the high-half codes
        }
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          const int2 xv = xs[m][g];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[m][j] = __dp4a(xv.x, lo[j], acc[m][j]);
            acc[m][j] = __dp4a(xv.y, hi[j], acc[m][j]);
          }
        }
      }
    }
  }

  // the warps' partial sums meet in shared memory, then one store (or one
  // atomic add, when K is split across CTAs) per output
  for (int i = tid; i < BM * BN; i += THREADS) red[i / BN][i % BN] = 0;
  __syncthreads();
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (acc[m][j] != 0) atomicAdd(&red[m][lane * 4 + j], acc[m][j] >> 4);
  __syncthreads();
  for (int i = tid; i < BM * BN; i += THREADS) {
    const int m = i / BN, c = i % BN;
    const int row = m0 + m, col = blockIdx.x * BN + c;
    if (row >= a.M || col >= a.N) continue;
    int* dst = a.out + (size_t)row * a.N + col;
    if (gridDim.z == 1) {
      *dst = red[m][c];
    } else if (red[m][c] != 0) {
      atomicAdd(dst, red[m][c]);
    }
  }
}

template <int BM>
int launch(Int4Args a, cudaStream_t stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int tiles_n = (a.N + BN - 1) / BN;
  const int tiles_m = (a.M + BM - 1) / BM;
  if (tiles_m > 65535) return (int)cudaErrorInvalidValue;
  // split K until there are about two CTAs per SM, keeping at least 128
  // packed rows (one round of UNROLL groups for each warp) per CTA
  const long long tiles = (long long)tiles_n * tiles_m;
  const int max_splits = (a.K2 + 127) / 128;
  int splits = (int)((2LL * sms + tiles - 1) / tiles);
  splits = max(1, min(splits, max_splits));
  int rps = (a.K2 + splits - 1) / splits;
  rps = (rps + 31) / 32 * 32;
  splits = (a.K2 + rps - 1) / rps;
  a.rows_per_split = rps;
  if (splits > 1) {
    cudaError_t err = cudaMemsetAsync(a.out, 0, (size_t)a.M * a.N * sizeof(int), stream);
    if (err != cudaSuccess) return (int)err;
  }
  int4_kernel<BM><<<dim3(tiles_n, tiles_m, splits), THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// K5. x: (M,K) int8; w4: (ceil(K/2),N) uint8 nibble pairs; out: (M,N) int32.
// All contiguous; 1 <= K <= 65536. Returns cudaGetLastError() (or the
// reason the launch was refused).
extern "C" int fp8q_int4_matmul(const signed char* x, const unsigned char* w4, int* out, int M,
                                int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K > MAX_K) return (int)cudaErrorInvalidValue;
  Int4Args a{};
  a.x = x;
  a.w = w4;
  a.out = out;
  a.M = M;
  a.N = N;
  a.K = K;
  a.K2 = (K + 1) / 2;
  a.vec = N % 4 == 0 && (reinterpret_cast<uintptr_t>(w4) & 3) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 4) return launch<4>(a, st);
  if (M <= 8) return launch<8>(a, st);
  if (M <= 16) return launch<16>(a, st);
  return launch<32>(a, st);
}
