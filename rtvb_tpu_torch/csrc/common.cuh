// Shared helpers of the rtvb_tpu_torch kernels (plain C interface, bound
// with ctypes by rtvb_tpu_torch/kernels.py).
//
// The library is built with --fmad=false: every product is rounded before
// the add that follows, exactly like the separate elementwise ops of each
// kernel's plain PyTorch version, so a kernel and its plain version agree
// to the bit wherever both call the same math functions.
//
// PyTorch on CUDA divides a float32 tensor by a Python float c as a product
// with the reciprocal 1 / c taken in double and rounded to float32, not
// 1.0f / float(c): the two differ for c = 0.008 (125.0f against 124.99999f;
// measured on an H100 with torch 2.11) and agree for 1.5, 3 and pi.  A
// twin multiplies by static_cast<float>(1.0 / c).  `c / tensor` is
// reciprocal(tensor) * c: (1.0f / t) * c.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define RTVB_EXPORT extern "C" __attribute__((visibility("default")))

namespace rtvb {

constexpr float BIG = 1e30f;

// floor → int32 with the out-of-range values saturated at ±2^30 (the plain
// versions' floor_i32; every caller clips far inside that range)
__device__ __forceinline__ int floor_i32(float x) {
  float f = floorf(x);
  f = fminf(fmaxf(f, -1073741824.0f), 1073741824.0f);
  return static_cast<int>(f);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// torch.clamp with scalar bounds: NaN propagates
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}
__device__ __forceinline__ float clamp2(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// Python-style (non-negative) modulo for s > 0
__device__ __forceinline__ int pymod(int a, int s) {
  int r = a % s;
  return r < 0 ? r + s : r;
}

// bf16 pair carried in one 32-bit word: low half → a, high half → b
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

__device__ __forceinline__ float luminance(float r, float g, float b) {
  return 0.2126f * r + 0.7152f * g + 0.0722f * b;
}

// the RNG's hash of ops/rng.py in uint32 (the plain version's int64 wrap-
// around arithmetic, low 32 bits)
__device__ __forceinline__ uint32_t pcg_hash(uint32_t x) {
  x = x * 747796405u + 2891336453u;
  const uint32_t word = ((x >> ((x >> 28) + 4u)) ^ x) * 277803737u;
  return (word >> 22) ^ word;
}
// uint32 → [0, 1) by mantissa injection
__device__ __forceinline__ float to_unit_float(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

inline int blocks_for(long long n, int threads) {
  return static_cast<int>((n + threads - 1) / threads);
}

// a launch that was refused never runs; report it to the wrapper
inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

// the grid of a persistent kernel: as many blocks of `threads` as the card
// holds at once with `smem` bytes of dynamic shared memory, no more than
// `want`.  `cache` (a static of the caller's, one per kernel) keeps the
// answer for the current device and shared-memory size.
struct GridCache {
  int device = -1;
  size_t smem = 0;
  int blocks = 0;
};

template <class Kernel>
cudaError_t persistent_grid(GridCache& cache, Kernel kern, int threads,
                            size_t smem, long long want, int* grid) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (cache.device != dev || cache.smem != smem) {
    // past the default 48 KB only by opting in
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      smem);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    if (per_sm == 0) return cudaErrorInvalidConfiguration;
    cache.device = dev;
    cache.smem = smem;
    cache.blocks = per_sm * sms;
  }
  *grid = static_cast<int>(cache.blocks < want ? cache.blocks : want);
  return cudaSuccess;
}

}  // namespace rtvb
