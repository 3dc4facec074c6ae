// Per-CTA phase stamps for a breakdown of one launch, read by
// fp8_quantization_tpu_torch/eval/stamps.py. Compiled in only with
// -DFP8Q_STAMPS (that script's own build); in the port's libraries every
// macro below is empty and the kernels carry no trace of it.
//
// Thread 0 of each CTA keeps STAMP_SLOTS cycle counters: STAMP(i) adds the
// clock64() cycles since the previous stamp to slot i, so the slots split the
// CTA's time by phase (barriers align the other threads to thread 0).
// STAMP_STORE(cta) writes them, the CTA's total cycles and its start and end
// on the card's global nanosecond timer (which shows when each CTA ran
// within the launch) to fp8q_stamps.

#pragma once

#ifdef FP8Q_STAMPS

constexpr int STAMP_SLOTS = 15;
constexpr int STAMP_STRIDE = STAMP_SLOTS + 3;  // the slots, the total, start and end ns
constexpr int STAMP_MAX_CTAS = 8192;

__device__ long long fp8q_stamps[STAMP_MAX_CTAS * STAMP_STRIDE];

__device__ __forceinline__ long long stamp_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

#define STAMP_DECL                              \
  const long long stamp_ns0_ = stamp_ns();      \
  long long stamp_acc_[STAMP_SLOTS];            \
  for (int i_ = 0; i_ < STAMP_SLOTS; ++i_) stamp_acc_[i_] = 0; \
  const long long stamp_t0_ = clock64();        \
  long long stamp_last_ = stamp_t0_;

#define STAMP(slot)                                    \
  do {                                                 \
    if (threadIdx.x == 0) {                            \
      const long long now_ = clock64();                \
      stamp_acc_[slot] += now_ - stamp_last_;          \
      stamp_last_ = now_;                              \
    }                                                  \
  } while (0)

#define STAMP_STORE(cta)                                                       \
  do {                                                                         \
    if (threadIdx.x == 0 && (cta) < STAMP_MAX_CTAS) {                          \
      for (int i_ = 0; i_ < STAMP_SLOTS; ++i_)                                 \
        fp8q_stamps[(size_t)(cta) * STAMP_STRIDE + i_] = stamp_acc_[i_];       \
      fp8q_stamps[(size_t)(cta) * STAMP_STRIDE + STAMP_SLOTS] = clock64() - stamp_t0_; \
      fp8q_stamps[(size_t)(cta) * STAMP_STRIDE + STAMP_SLOTS + 1] = stamp_ns0_;          \
      fp8q_stamps[(size_t)(cta) * STAMP_STRIDE + STAMP_SLOTS + 2] = stamp_ns();          \
    }                                                                          \
  } while (0)

// Copies the stamps of the first n CTAs (n * STAMP_STRIDE values) to host.
extern "C" int fp8q_read_stamps(long long* host, int n_ctas) {
  if (n_ctas < 0 || n_ctas > STAMP_MAX_CTAS) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(host, fp8q_stamps,
                                   sizeof(long long) * (size_t)n_ctas * STAMP_STRIDE);
}

extern "C" int fp8q_stamp_slots() { return STAMP_SLOTS; }

// Zeroes every CTA's stamps (before a launch of fewer CTAs than the last).
extern "C" int fp8q_clear_stamps() {
  void* p = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&p, fp8q_stamps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemset(p, 0, sizeof(fp8q_stamps));
}

#else

#define STAMP_DECL
#define STAMP(slot) \
  do {              \
  } while (0)
#define STAMP_STORE(cta) \
  do {                   \
  } while (0)

#endif
