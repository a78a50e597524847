// K6 — one edge-stopping 5×5 à-trous wavelet pass at tap spacing `step`
// over (H, W, 3) illumination plus (H, W) variance, weighted by luminance
// (variance-scaled), normal (pow by repeated squaring) and depth.
//
// Replaces: rtvb_tpu/ops/denoise/atrous_kernel.py `_atrous_call` /
// `_make_kernel` (entry `atrous_pass_tpu`) and, because any step is taken,
// the XLA fallback the TPU path used above MAX_STEP = 8.  Plain version:
// rtvb_tpu_torch/ops/denoise/passes.py `atrous_pass_plain`.
//
// What bounds it on Hopper: memory traffic — 25 taps × 32 bytes of
// guides and signal per pixel, mostly served by L1/L2 because neighbouring
// threads share taps — plus 24 expf per pixel.  Design: one thread per
// pixel, taps read with edge-clamped coordinates (the plain version's
// `shift` semantics) in the same order, and the weights computed op for op
// like the plain version so the two agree to the bit.
#include "common.cuh"

namespace {

__constant__ float W1D[3] = {0.375f, 0.25f, 0.0625f};

__global__ void atrous_kernel(const float* __restrict__ illum,
                              const float* __restrict__ var,
                              const float* __restrict__ depth,
                              const float* __restrict__ normal, int H, int W,
                              int step, float phi_lum, float phi_depth,
                              int n_squarings, float* __restrict__ out,
                              float* __restrict__ out_var) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= H * W) return;
  const int y = p / W, x = p % W;
  const float r = illum[3 * p], g = illum[3 * p + 1], b = illum[3 * p + 2];
  const float v = var[p];
  const float d = depth[p];
  const float nx = normal[3 * p], ny = normal[3 * p + 1],
              nz = normal[3 * p + 2];
  const float lum_c = rtvb::luminance(r, g, b);
  const float sigma_l = phi_lum * sqrtf(fmaxf(v, 1e-8f)) + 1e-3f;
  const float w0 = 0.140625f;                 // 0.375²
  float acc_r = r * w0, acc_g = g * w0, acc_b = b * w0;
  float acc_v = v * 0.019775390625f;          // w0²
  float wsum = w0;
  const float d_ref = phi_depth * fmaxf(d, 1.0f);
  for (int dy = -2; dy <= 2; ++dy) {
    for (int dx = -2; dx <= 2; ++dx) {
      if (dy == 0 && dx == 0) continue;
      const float wk = W1D[abs(dy)] * W1D[abs(dx)];
      // shift(img, oy, ox)[y, x] = img[clamp(y - oy), clamp(x - ox)]
      const int q = rtvb::clampi(y - dy * step, 0, H - 1) * W +
                    rtvb::clampi(x - dx * step, 0, W - 1);
      const float qr = illum[3 * q], qg = illum[3 * q + 1],
                  qb = illum[3 * q + 2];
      const float qd = depth[q];
      const float n_lum = rtvb::luminance(qr, qg, qb);
      const float e_z = fabsf(qd - d) /
                        (d_ref * static_cast<float>(max(abs(dy) + abs(dx), 1)));
      float w_n = fmaxf(normal[3 * q] * nx + normal[3 * q + 1] * ny +
                            normal[3 * q + 2] * nz,
                        0.0f);
      for (int k = 0; k < n_squarings; ++k) w_n = w_n * w_n;
      const float e_l = fabsf(n_lum - lum_c) / sigma_l;
      float w = wk * expf(-(e_z + e_l)) * w_n;
      if (qd >= rtvb::BIG || d >= rtvb::BIG) w = 0.0f;
      acc_r = acc_r + qr * w;
      acc_g = acc_g + qg * w;
      acc_b = acc_b + qb * w;
      acc_v = acc_v + var[q] * (w * w);
      wsum = wsum + w;
    }
  }
  const float inv = 1.0f / fmaxf(wsum, 1e-6f);
  out[3 * p] = acc_r * inv;
  out[3 * p + 1] = acc_g * inv;
  out[3 * p + 2] = acc_b * inv;
  out_var[p] = acc_v * inv * inv;
}

}  // namespace

RTVB_EXPORT int rtvb_atrous(const float* illum, const float* var,
                            const float* depth, const float* normal, int H,
                            int W, int step, float phi_lum, float phi_depth,
                            int n_pow, float* out, float* out_var,
                            void* stream) {
  const int n = H * W;
  if (n == 0) return 0;
  int n_squarings = 0;             // phi_normal = 2^n_squarings
  while ((1 << n_squarings) < n_pow) ++n_squarings;
  const int threads = 256;
  atrous_kernel<<<rtvb::blocks_for(n, threads), threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      illum, var, depth, normal, H, W, step, phi_lum, phi_depth, n_squarings,
      out, out_var);
  return rtvb::launch_status();
}
