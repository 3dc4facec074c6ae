// A read-only microbenchmark of K5 route A's weight access
// (csrc/int4_matmul.cu):
// 128-column tiles of a (rows, N) byte matrix, four warps a CTA taking
// 32-row steps in turn, lane (g, t) reading 16 bytes at column 16g of rows
// 4t..4t+3 and 16+4t..16+4t+3 of each step. The bytes are read either
// straight into registers (__ldg, 16 bytes a lane) or through a per-warp
// cp.async ring of depth 2 or 3, and folded into one word so that nothing
// is optimized away. Built and run by eval/stream_read.py only; no port
// library includes it.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ void cp_async16(void* smem, const void* g, int n) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(g), "r"(n)
               : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// D = 0: __ldg into registers; D >= 2: a cp.async ring of D stages
template <int D>
__global__ void __launch_bounds__(THREADS) stream_read(const unsigned char* w, int rows, int n,
                                                       int rows_per_split, unsigned* sink) {
  constexpr int SLOTS = D > 0 ? D : 1;
  __shared__ __align__(16) unsigned char ring[THREADS / 32][SLOTS][8 * 32 * 16];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int col = blockIdx.x * 128 + 16 * g;
  const int r0 = blockIdx.y * rows_per_split;
  const int r1 = min(rows, r0 + rows_per_split);
  const int steps = (r1 - r0 + 31) / 32;
  const int mine = steps > warp ? (steps - warp + 3) / 4 : 0;
  auto row = [&](int i, int c) {
    return r0 + (warp + 4 * i) * 32 + (c < 4 ? 4 * t + c : 16 + 4 * t + c - 4);
  };
  unsigned acc = 0;
  if (D == 0) {
    for (int i = 0; i < mine; ++i) {
      uint4 v[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int r = row(i, c);
        v[c] = r < r1 ? __ldg(reinterpret_cast<const uint4*>(w + (size_t)r * n + col))
                      : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) acc ^= v[c].x ^ v[c].y ^ v[c].z ^ v[c].w;
    }
  } else {
    auto issue = [&](int i) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int r = row(i, c);
        const bool ok = r < r1;
        cp_async16(&ring[warp][i % SLOTS][(c * 32 + lane) * 16],
                   w + (ok ? (size_t)r * n + col : 0), ok ? 16 : 0);
      }
    };
    for (int i = 0; i < SLOTS - 1; ++i) {
      if (i < mine) issue(i);
      cp_async_commit();
    }
    for (int i = 0; i < mine; ++i) {
      cp_async_wait<(D > 1 ? D - 2 : 0)>();
      uint4 v[8];
#pragma unroll
      for (int c = 0; c < 8; ++c)
        v[c] = *reinterpret_cast<const uint4*>(&ring[warp][i % SLOTS][(c * 32 + lane) * 16]);
      if (i + SLOTS - 1 < mine) issue(i + SLOTS - 1);
      cp_async_commit();
#pragma unroll
      for (int c = 0; c < 8; ++c) acc ^= v[c].x ^ v[c].y ^ v[c].z ^ v[c].w;
    }
  }
  if (acc == 0x12345678u) sink[0] = acc;
}

}  // namespace

// depth 0 (registers), 2 or 3 (cp.async ring); N a multiple of 128.
extern "C" int fp8q_stream_read(int depth, const unsigned char* w, int rows, int n, int splits,
                                unsigned* sink, void* stream) {
  if (n % 128 != 0 || splits < 1) return (int)cudaErrorInvalidValue;
  const int rps = (rows + splits - 1) / splits;
  const dim3 grid(n / 128, splits);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (depth) {
    case 0: stream_read<0><<<grid, THREADS, 0, st>>>(w, rows, n, rps, sink); break;
    case 2: stream_read<2><<<grid, THREADS, 0, st>>>(w, rows, n, rps, sink); break;
    case 3: stream_read<3><<<grid, THREADS, 0, st>>>(w, rows, n, rps, sink); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
