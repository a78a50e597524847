// K7 — EASU upscale (FSR-1 class) of an (H, W, 3) f32 image to
// (out_h, out_w, 3) f32 at any per-axis ratio: a direction field from luma
// gradients at input resolution, bilinearly blended at each output sample,
// stretches a 12-tap negative-lobe kernel along the edge; the result is
// clamped to the inner 2×2 quad's range.
//
// Replaces: rtvb_tpu/ops/easu_kernel.py:249 `_easu_call` (`_make_kernel`,
// entry `easu_tpu`) and, at the 2:1 rung, the XLA specialisation
// `_easu_2x`.  Plain version: rtvb_tpu_torch/ops/easu_kernel.py
// `easu_plain`, whose rules this kernel follows to the bit: exact rational
// source positions per axis, the field computed with edge-clamped
// neighbours and tapped at clamped texels, the weight maths in the same
// order (the library builds with --fmad=false).
//
// What bounds it on Hopper: its bytes and its arithmetic about equally —
// 12 B read per input texel and 12 B written per output pixel (31–39 MB at
// the rungs, ≈ 0.009–0.012 ms at 3.35 TB/s), ≈ 390 flops per output pixel
// (≈ 0.012 ms at 67 TFLOP/s).  Design: one
// thread per output pixel in 32×8 tiles.  A block stages in shared memory
// the input window its tile reaches (base − 1 … base + 2 on each axis,
// texels clamped to the image) and the window's direction field, computed
// once per texel at its clamped index from a luma ring one texel wider, so
// each input texel's field costs one evaluation per block instead of four
// per output pixel.  The TPU kernel's one-hot selection matmuls, its DMA
// window and its ratio table (2:1, 3:2, 4:3 only) have no job here: a
// thread computes its own source base and fraction in integers.
#include "common.cuh"

namespace {

constexpr int TILE_X = 32, TILE_Y = 8;

// the plain version's 12 taps, in its order; (0,0) (0,1) (1,0) (1,1) are
// the inner quad
__constant__ int TAP_DY[12] = {-1, -1, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2};
__constant__ int TAP_DX[12] = {0, 1, -1, 0, 1, 2, -1, 0, 1, 2, 0, 1};

// source base of output index o: floor(((2o+1)·in − out) / (2·out))
__host__ __device__ inline int axis_base(long long o, long long in,
                                         long long out) {
  const long long num = (2 * o + 1) * in - out, den = 2 * out;
  return static_cast<int>(num >= 0 ? num / den : -((-num + den - 1) / den));
}

// frac = (num − base·den)·(1/den), 1/den rounded to f32 by the caller
__device__ inline float axis_frac(long long o, long long in, long long out,
                                  int base, float inv_den) {
  const long long rem = (2 * o + 1) * in - out - base * (2 * out);
  return static_cast<float>(rem) * inv_den;
}

// torch.minimum / torch.maximum: NaN propagates
__device__ __forceinline__ float tmin(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
__device__ __forceinline__ float tmax(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

__global__ void easu_kernel(const float* __restrict__ img, int H, int W,
                            int out_h, int out_w, float inv_den_y,
                            float inv_den_x, int wrows, int wcols,
                            float* __restrict__ out) {
  extern __shared__ float smem[];
  const int rw = wcols + 2;                      // luma ring width
  const int n_win = wrows * wcols;
  float* lum = smem;                             // (wrows + 2) × rw
  float* col = lum + (wrows + 2) * rw;           // 3 × n_win
  float* fld = col + 3 * n_win;                  // 3 × n_win: dx, dy, len
  const int oy0 = blockIdx.y * TILE_Y, ox0 = blockIdx.x * TILE_X;
  // global texel of window index 0 on each axis; the ring starts one
  // texel before it
  const int row0 = axis_base(oy0, H, out_h) - 1;
  const int col0 = axis_base(ox0, W, out_w) - 1;
  const int tid = threadIdx.y * TILE_X + threadIdx.x;
  constexpr int NT = TILE_X * TILE_Y;

  for (int i = tid; i < (wrows + 2) * rw; i += NT) {
    const int ry = i / rw, rx = i % rw;
    const int gy = rtvb::clampi(row0 - 1 + ry, 0, H - 1);
    const int gx = rtvb::clampi(col0 - 1 + rx, 0, W - 1);
    const float* p = img + 3 * (static_cast<size_t>(gy) * W + gx);
    const float r = __ldg(p), g = __ldg(p + 1), b = __ldg(p + 2);
    lum[i] = 0.5f * g + 0.25f * (r + b);
    const int wy = ry - 1, wx = rx - 1;
    if (wy >= 0 && wy < wrows && wx >= 0 && wx < wcols) {
      const int k = wy * wcols + wx;
      col[k] = r;
      col[n_win + k] = g;
      col[2 * n_win + k] = b;
    }
  }
  __syncthreads();

  // the field of window texel k at its clamped global texel (gy, gx), from
  // the luma of the clamped neighbours; every one lies in the ring
  for (int k = tid; k < n_win; k += NT) {
    const int gy = rtvb::clampi(row0 + k / wcols, 0, H - 1);
    const int gx = rtvb::clampi(col0 + k % wcols, 0, W - 1);
    auto L = [&](int y, int x) {
      return lum[(y - row0 + 1) * rw + (x - col0 + 1)];
    };
    const float c = L(gy, gx);
    const float lA = L(gy, rtvb::clampi(gx - 1, 0, W - 1));
    const float lB = L(gy, rtvb::clampi(gx + 1, 0, W - 1));
    const float lD = L(rtvb::clampi(gy - 1, 0, H - 1), gx);
    const float lE = L(rtvb::clampi(gy + 1, 0, H - 1), gx);
    const float dx = lB - lA;
    const float dy = lE - lD;
    const float rng_x = fabsf(lA - c) + fabsf(lB - c);
    const float rng_y = fabsf(lD - c) + fabsf(lE - c);
    const float qx = rtvb::clamp2(fabsf(dx) / rtvb::clamp_min(rng_x, 1e-4f),
                                  0.0f, 1.0f);
    const float qy = rtvb::clamp2(fabsf(dy) / rtvb::clamp_min(rng_y, 1e-4f),
                                  0.0f, 1.0f);
    fld[k] = dx;
    fld[n_win + k] = dy;
    fld[2 * n_win + k] = qx * qx + qy * qy;
  }
  __syncthreads();

  const int oy = oy0 + threadIdx.y, ox = ox0 + threadIdx.x;
  if (oy >= out_h || ox >= out_w) return;
  const int by = axis_base(oy, H, out_h), bx = axis_base(ox, W, out_w);
  const float fy = axis_frac(oy, H, out_h, by, inv_den_y);
  const float fx = axis_frac(ox, W, out_w, bx, inv_den_x);
  // window index of texel (base + dy, base + dx): (ly + dy, lx + dx)
  const int ly = by - row0, lx = bx - col0;
  const int q00 = ly * wcols + lx;

  const float wf = (1.0f - fx) * (1.0f - fy);
  const float wg = fx * (1.0f - fy);
  const float wj = (1.0f - fx) * fy;
  const float wk = fx * fy;
  float bl[3];
  for (int c = 0; c < 3; ++c) {
    const float* f = fld + c * n_win + q00;
    bl[c] = f[0] * wf + f[1] * wg + f[wcols] * wj + f[wcols + 1] * wk;
  }
  const float dirx = bl[0], diry = bl[1], length = bl[2];
  const float dr2 = dirx * dirx + diry * diry;
  const bool has_dir = dr2 > 1e-8f;
  const float inv =
      has_dir ? 1.0f / sqrtf(rtvb::clamp_min(dr2, 1e-8f)) : 0.0f;
  const float dirx_n = has_dir ? dirx * inv : 1.0f;
  const float diry_n = diry * inv;
  const float inv_along = 1.0f / (1.0f + length);

  float acc[3] = {0.0f, 0.0f, 0.0f};
  float wsum = 0.0f;
#pragma unroll
  for (int t = 0; t < 12; ++t) {
    const int dy = TAP_DY[t], dx = TAP_DX[t];
    const float vx = static_cast<float>(dx) - fx;
    const float vy = static_cast<float>(dy) - fy;
    const float along = vx * dirx_n + vy * diry_n;
    const float across = -vx * diry_n + vy * dirx_n;
    const float a = along * inv_along;
    const float d2 = rtvb::clamp_max(a * a + across * across, 4.0f);
    const float b = 0.4f * d2 - 1.0f;
    const float w = rtvb::clamp_min(b * b * 1.5625f - 0.5625f, 0.0f);
    const int q = q00 + dy * wcols + dx;
    for (int c = 0; c < 3; ++c) {
      const float tv = col[c * n_win + q] * w;
      acc[c] = t == 0 ? tv : acc[c] + tv;
    }
    wsum = t == 0 ? w : wsum + w;
  }
  const float den = rtvb::clamp_min(wsum, 1e-5f);
  float* o = out + 3 * (static_cast<size_t>(oy) * out_w + ox);
  for (int c = 0; c < 3; ++c) {
    const float* p = col + c * n_win + q00;
    const float qmin = tmin(tmin(p[0], p[1]), tmin(p[wcols], p[wcols + 1]));
    const float qmax = tmax(tmax(p[0], p[1]), tmax(p[wcols], p[wcols + 1]));
    const float v = acc[c] / den;
    o[c] = rtvb::clamp2(v, qmin, qmax);   // torch.clamp(v, qmin, qmax)
  }
}

// rows (or columns) of input one tile of `tile` outputs reaches, taps
// included: the largest base span over the tiles + 4 (base − 1 … base + 2)
int window_extent(int out, int in, int tile) {
  int span = 0;
  for (int t0 = 0; t0 < out; t0 += tile) {
    const int t1 = (t0 + tile < out ? t0 + tile : out) - 1;
    const int s = axis_base(t1, in, out) - axis_base(t0, in, out);
    span = s > span ? s : span;
  }
  return span + 4;
}

}  // namespace

RTVB_EXPORT int rtvb_easu(const float* img, int H, int W, int out_h,
                          int out_w, float inv_den_y, float inv_den_x,
                          float* out, void* stream) {
  if (out_h <= 0 || out_w <= 0) return 0;
  const int wrows = window_extent(out_h, H, TILE_Y);
  const int wcols = window_extent(out_w, W, TILE_X);
  const size_t smem =
      (static_cast<size_t>(wrows + 2) * (wcols + 2) +
       6 * static_cast<size_t>(wrows) * wcols) * sizeof(float);
  // a downscale's window may pass the 48 KB default; past the card's
  // 227 KB the launch is refused and the wrapper raises
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(easu_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  const dim3 grid(rtvb::blocks_for(out_w, TILE_X),
                  rtvb::blocks_for(out_h, TILE_Y));
  easu_kernel<<<grid, dim3(TILE_X, TILE_Y), smem,
                static_cast<cudaStream_t>(stream)>>>(
      img, H, W, out_h, out_w, inv_den_y, inv_den_x, wrows, wcols, out);
  return rtvb::launch_status();
}
