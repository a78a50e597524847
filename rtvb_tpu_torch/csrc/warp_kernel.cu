// K5 — warped history gather (reprojection): out[c, p] = hist[c, warp(p)].
// Nearest mode moves 32-bit words untouched (ReSTIR reservoir planes carry
// bitcast ints and bf16 pairs, NaN patterns included); bilinear mode blends
// the 2×2 neighbourhood, unpacking the first `pairs` planes as two bf16
// values each (the denoiser's history: 7 planes in, 13 channels out).
//
// Replaces: rtvb_tpu/ops/warp_kernel.py `_warp_call` / `_make_kernel`
// (entries `warp_nearest`, `warp_bilinear`).  Plain versions:
// rtvb_tpu_torch/ops/warp_kernel.py `warp_nearest_ref`,
// `warp_bilinear_ref`.
//
// What bounds it on Hopper: memory traffic — per pixel 8 B of coordinates,
// C (nearest) or 4·C (bilinear) 4-byte taps, C(+pairs) 4-byte stores and a
// valid byte; arithmetic is a few flops per channel.  Design: a direct
// per-pixel gather, one thread per pixel, no window: motion vectors are
// coherent, so neighbouring threads read neighbouring history texels
// through L1/L2 and every pixel is served — the TPU kernel's DMA window
// (and the pixels it had to invalidate outside it) has no job here.
#include "common.cuh"

namespace {

__global__ void warp_nearest_kernel(const uint32_t* __restrict__ hist,
                                    const float* __restrict__ sy,
                                    const float* __restrict__ sx, int C,
                                    int H, int W, uint32_t* __restrict__ out,
                                    bool* __restrict__ valid) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int HW = H * W;
  if (p >= HW) return;
  const int y = rtvb::floor_i32(sy[p] + 0.5f);
  const int x = rtvb::floor_i32(sx[p] + 0.5f);
  valid[p] = y >= 0 && y < H && x >= 0 && x < W;
  const int src = rtvb::clampi(y, 0, H - 1) * W + rtvb::clampi(x, 0, W - 1);
  for (int c = 0; c < C; ++c)
    out[static_cast<size_t>(c) * HW + p] =
        __ldg(hist + static_cast<size_t>(c) * HW + src);
}

__global__ void warp_bilinear_kernel(const uint32_t* __restrict__ hist,
                                     const float* __restrict__ sy,
                                     const float* __restrict__ sx, int C,
                                     int H, int W, int pairs,
                                     float* __restrict__ out,
                                     bool* __restrict__ valid) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int HW = H * W;
  if (p >= HW) return;
  const float fsy = sy[p], fsx = sx[p];
  const float y0f = floorf(fsy), x0f = floorf(fsx);
  const float fy = fsy - y0f, fx = fsx - x0f;
  const int y0 = rtvb::floor_i32(y0f), x0 = rtvb::floor_i32(x0f);
  valid[p] = y0 >= 0 && y0 < H - 1 && x0 >= 0 && x0 < W - 1;
  const int i00 = rtvb::clampi(y0, 0, H - 2) * W + rtvb::clampi(x0, 0, W - 2);
  const float gx = 1.0f - fx, gy = 1.0f - fy;
  auto blend = [&](float v00, float v01, float v10, float v11) {
    return (v00 * gx + v01 * fx) * gy + (v10 * gx + v11 * fx) * fy;
  };
  int oc = 0;
  for (int c = 0; c < C; ++c) {
    const uint32_t* h = hist + static_cast<size_t>(c) * HW;
    const uint32_t w00 = __ldg(h + i00), w01 = __ldg(h + i00 + 1);
    const uint32_t w10 = __ldg(h + i00 + W), w11 = __ldg(h + i00 + W + 1);
    if (c < pairs) {
      out[static_cast<size_t>(oc++) * HW + p] =
          blend(rtvb::bf16_lo(w00), rtvb::bf16_lo(w01), rtvb::bf16_lo(w10),
                rtvb::bf16_lo(w11));
      out[static_cast<size_t>(oc++) * HW + p] =
          blend(rtvb::bf16_hi(w00), rtvb::bf16_hi(w01), rtvb::bf16_hi(w10),
                rtvb::bf16_hi(w11));
    } else {
      out[static_cast<size_t>(oc++) * HW + p] =
          blend(__uint_as_float(w00), __uint_as_float(w01),
                __uint_as_float(w10), __uint_as_float(w11));
    }
  }
}

}  // namespace

RTVB_EXPORT int rtvb_warp(const float* hist, const float* sy, const float* sx,
                          int C, int H, int W, int bilinear, int pairs,
                          float* out, bool* valid, void* stream) {
  const int n = H * W;
  if (n == 0) return 0;
  const int threads = 256;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* h = reinterpret_cast<const uint32_t*>(hist);
  if (bilinear) {
    warp_bilinear_kernel<<<rtvb::blocks_for(n, threads), threads, 0, s>>>(
        h, sy, sx, C, H, W, pairs, out, valid);
  } else {
    warp_nearest_kernel<<<rtvb::blocks_for(n, threads), threads, 0, s>>>(
        h, sy, sx, C, H, W, reinterpret_cast<uint32_t*>(out), valid);
  }
  return rtvb::launch_status();
}
