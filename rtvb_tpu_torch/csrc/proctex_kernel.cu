// Procedural surface textures per pixel: `sample_scale` (the albedo
// multiplier) or `sample_normal_delta` (its central differences in u and v)
// of rtvb_tpu_torch/assets/textures.py, in registers.
//
// Replaces no TPU kernel: the JAX package leaves the stack to XLA, which
// fuses it.  The plain PyTorch version runs it as some 5,000 elementwise
// kernels a frame over int64 planes (every pattern for every pixel, the
// lattice hash in int64 with `& 0xFFFFFFFF` after each multiply).  Plain
// versions: textures.py `_sample_scale_plain`, `_sample_normal_delta_plain`.
//
// What bounds it on Hopper: instruction throughput.  Per pixel 16 B in (tex_id,
// u, v, lod) and 4 B (scale) or 8 B (du, dv) out; at most 4 evaluations x
// 2 value noises x 4 hashes = 32 uint32 PCG hashes and ~1,000 integer and
// float operations.  Design: one thread a pixel, no shared memory; only the
// pattern the pixel's tex_id selects is evaluated (the plain version's
// torch.where over the five keeps exactly that one), the hash in uint32
// (the low 32 bits of the plain version's int64 wrap-around arithmetic).
// Bit-exact with the plain version: each expression in its order
// (--fmad=false), float -> int64 conversions as `.to(torch.int64)` does
// (saturating, then wrapped to 32 bits), the bricks' row through int32,
// each division by a Python float as common.cuh states torch's rule, and
// the precise sinf.
#include "common.cuh"

namespace {

using rtvb::pcg_hash;
using rtvb::to_unit_float;

// floor(x) as .to(torch.int64) converts it on the card (round toward zero,
// saturating), wrapped to its low 32 bits
__device__ __forceinline__ uint32_t lattice_coord(float xi) {
  return static_cast<uint32_t>(__float2ll_rz(xi));
}

__device__ float value_noise(float u, float v, float freq, uint32_t seed) {
  const float x = u * freq;
  const float y = v * freq;
  const float xi = floorf(x);
  const float yi = floorf(y);
  float xf = x - xi;
  float yf = y - yi;
  xf = xf * xf * (3.0f - 2.0f * xf);
  yf = yf * yf * (3.0f - 2.0f * yf);
  const uint32_t ix = lattice_coord(xi);
  const uint32_t iy = lattice_coord(yi);
  auto lattice = [seed](uint32_t a, uint32_t b) {
    return to_unit_float(pcg_hash(a * 374761393u + b * 668265263u + seed));
  };
  const float n00 = lattice(ix, iy);
  const float n10 = lattice(ix + 1u, iy);
  const float n01 = lattice(ix, iy + 1u);
  const float n11 = lattice(ix + 1u, iy + 1u);
  const float nx0 = n00 + xf * (n10 - n00);
  const float nx1 = n01 + xf * (n11 - n01);
  return nx0 + yf * (nx1 - nx0);
}

// two octaves; `total / 1.5` is a product with the reciprocal of 1.5
__device__ float fbm(float u, float v, float freq, uint32_t seed) {
  float total = 0.0f + 1.0f * value_noise(u, v, freq, seed);
  total = total + 0.5f * value_noise(u, v, freq * 2.0f, seed + 131u);
  return total * static_cast<float>(1.0 / 1.5);
}

__device__ float bricks(float u, float v) {
  float bu = u * 3.0f;
  const float bv = v * 6.0f;
  const float row = floorf(bv);
  bu = bu + ((__float2int_rz(row) & 1) == 1 ? 0.5f : 0.0f);
  const float col = floorf(bu);
  const float fu = bu - col;
  const float fv = bv - row;
  if (fu < 0.06f || fu > 0.94f || fv < 0.1f || fv > 0.9f) return 0.35f;
  return 0.9f + 0.2f * value_noise(col, row, 1.0f, 77u);
}

// sample_scale of one pixel; `contrast` is the pixel's lod roll-off
__device__ float scale_at(int tid, float u, float v, float contrast) {
  if (tid < 0) return 1.0f;
  float pattern = 0.5f;
  if (tid <= 2) {               // noise_fine, noise_mid, noise_coarse
    const float freq = tid == 0 ? 9.0f : (tid == 1 ? 5.0f : 3.0f);
    const uint32_t seed = tid == 0 ? 11u : (tid == 1 ? 23u : 47u);
    pattern = fbm(u, v, freq, seed);
  } else if (tid == 3) {        // stripes
    const float band = sinf((v + 0.35f * value_noise(u, v, 2.0f, 61u)) * 18.0f);
    pattern = 0.5f + 0.5f * band * band;
  } else if (tid == 4) {
    pattern = bricks(u, v);
  }
  return 1.0f + contrast * (pattern - 0.5f);
}

template <bool kDelta>
__global__ void proctex_kernel(const int* __restrict__ tex_id,
                               const float* __restrict__ u,
                               const float* __restrict__ v,
                               const float* __restrict__ lod, int n,
                               float eps, float inv_two_eps,
                               float* __restrict__ out0,
                               float* __restrict__ out1) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int tid = tex_id[i];
  const float pu = u[i];
  const float pv = v[i];
  const float contrast =
      lod == nullptr ? 0.6f : (1.0f / (1.0f + 2.0f * lod[i])) * 0.6f;
  if (!kDelta) {
    out0[i] = scale_at(tid, pu, pv, contrast);
    return;
  }
  const float s_up = scale_at(tid, pu + eps, pv, contrast);
  const float s_un = scale_at(tid, pu - eps, pv, contrast);
  const float s_vp = scale_at(tid, pu, pv + eps, contrast);
  const float s_vn = scale_at(tid, pu, pv - eps, contrast);
  out0[i] = (s_up - s_un) * inv_two_eps;
  out1[i] = (s_vp - s_vn) * inv_two_eps;
}

}  // namespace

// delta 0: out0 = sample_scale; delta 1: (out0, out1) = sample_normal_delta
// at `eps`, `inv_two_eps` being the float32 of 1 / (2 eps) in double, by
// which the plain version's division by the Python float 2.0 * eps
// multiplies.  lod may be null (the plain version's lod=None: contrast
// 0.6).
RTVB_EXPORT int rtvb_proctex(const int* tex_id, const float* u, const float* v,
                             const float* lod, int n, int delta, float eps,
                             float inv_two_eps, float* out0, float* out1,
                             void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (delta) {
    proctex_kernel<true><<<rtvb::blocks_for(n, threads), threads, 0, s>>>(
        tex_id, u, v, lod, n, eps, inv_two_eps, out0, out1);
  } else {
    proctex_kernel<false><<<rtvb::blocks_for(n, threads), threads, 0, s>>>(
        tex_id, u, v, lod, n, eps, inv_two_eps, out0, out1);
  }
  return rtvb::launch_status();
}
