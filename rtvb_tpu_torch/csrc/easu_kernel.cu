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
// What bounds it on Hopper: the issue of its instructions.  12 B read per
// input texel and 12 B written per output pixel (31–39 MB at the rungs,
// ≈ 0.009–0.012 ms at 3.35 TB/s) against ≈ 390 flops per output pixel
// (≈ 0.012 ms at 67 TFLOP/s, ≈ 0.024 ms as the separate products and sums
// of --fmad=false issue); with the IEEE divisions, the NaN-propagating
// clamps and the shared-memory taps an output pixel is ≈ 640 SASS
// instructions, ≈ 0.040 ms at the 1/2 rung at one warp instruction a
// clock on each of the 528 schedulers at 1,980 MHz (counted); this kernel
// runs 0.0625 ms there (NVIDIA H100 80GB HBM3 at 700 W, kernel_ab.py).
// The first kernel (one thread an output in 32×8
// tiles, 0.0854 ms at the 1/2 rung, NVIDIA H100 80GB HBM3 at 700 W) did
// more than the filter: every thread recomputed its block's window origin
// and its own source position with 64-bit divisions, the staging loops
// divided by the window's width, and its loads and stores were 4 bytes at
// a 12-byte stride.  Design:
// - a block of 32×8 threads takes a 128×8 tile of outputs, 4 a thread
//   along its row (columns tx + 32k, so a warp's reads stay on distinct
//   banks);
// - the tile's source positions, (base, frac) of its 128 columns and 8
//   rows, are computed once in the block's prologue, in int32 where the
//   numerator (2o + 1)·in fits (any size the engine uses), into shared
//   memory;
// - the block stages the input window its tile reaches (base − 1 …
//   base + 2 on each axis, texels clamped to the image) as three colour
//   planes with coalesced loads (a warp reads consecutive floats of a
//   row), then its luma, then the direction field of the texels the
//   bilinear field taps reach (base … base + 1), each computed once per
//   texel at its clamped index from the luma of the clamped neighbours,
//   all of which lie in the window; 2-D loops, no division by a run-time
//   width;
// - each output row of the tile goes out through shared memory as
//   contiguous 16-byte stores (the row's misaligned ends, where the
//   output is not a multiple of 4 floats, one float a thread).
// The TPU kernel's one-hot selection matmuls, its DMA window and its
// ratio table (2:1, 3:2, 4:3 only) have no job here.
#include "common.cuh"

namespace {

constexpr int TX = 32, TY = 8;             // threads of a block
constexpr int PER = 4;                     // outputs a thread, along a row
constexpr int TILE_W = TX * PER, TILE_H = TY;
constexpr int OUT_ROW = 3 * TILE_W + 4;    // a staged output row, floats

// the plain version's 12 taps, in its order; (0,0) (0,1) (1,0) (1,1) are
// the inner quad.  Compile-time, so an unrolled tap's offsets and its
// dx - fx, dy - fy fold (and repeat across taps only once)
__host__ __device__ constexpr int tap_dy(int t) {
  return t < 2 ? -1 : (t < 6 ? 0 : (t < 10 ? 1 : 2));
}
__host__ __device__ constexpr int tap_dx(int t) {
  constexpr int dx[12] = {0, 1, -1, 0, 1, 2, -1, 0, 1, 2, 0, 1};
  return dx[t];
}

// source base of output index o: floor(((2o+1)·in − out) / (2·out))
__host__ __device__ inline long long axis_base64(long long o, long long in,
                                                 long long out) {
  const long long num = (2 * o + 1) * in - out, den = 2 * out;
  return num >= 0 ? num / den : -((-num + den - 1) / den);
}

// (base, frac) of output index o; frac = (num − base·den)·(1/den), 1/den
// rounded to f32 by the caller.  narrow: (2o + 1)·in fits an int32
__device__ inline void axis_pos(int o, int in, int out, float inv_den,
                                bool narrow, int* base, float* frac) {
  if (narrow) {
    const int num = (2 * o + 1) * in - out, den = 2 * out;
    const int b = num >= 0 ? num / den : -((-num + den - 1) / den);
    *base = b;
    *frac = static_cast<float>(num - b * den) * inv_den;
  } else {
    const long long b = axis_base64(o, in, out);
    *base = static_cast<int>(b);
    *frac = static_cast<float>((2LL * o + 1) * in - out - b * 2LL * out) *
            inv_den;
  }
}

// torch.clamp(v, max=hi) / torch.clamp(v, min=lo) for a v that is the
// result of arithmetic, whose NaN is the card's canonical one: min.NaN /
// max.NaN return that same NaN, in one instruction for the three of
// rtvb::clamp_max / clamp_min (a NaN test, a select, a min)
__device__ __forceinline__ float clamp_max_nan(float v, float hi) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(v), "f"(hi));
  return r;
}
__device__ __forceinline__ float clamp_min_nan(float v, float lo) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(v), "f"(lo));
  return r;
}

// torch.minimum / torch.maximum: NaN propagates
__device__ __forceinline__ float tmin(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
__device__ __forceinline__ float tmax(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

// the staged output rows' offset in the block's shared memory: after the
// window, its luma and its field, 16-byte aligned
__host__ __device__ inline int stage_offset(int wrows, int wcols) {
  const int win = 4 * wrows * wcols + 3 * (wrows - 2) * (wcols - 2);
  return (win + 3) & ~3;
}

// the window of a tile: wrows × wcols texels from (b0y − 1, b0x − 1), the
// field over its (wrows − 2) × (wcols − 2) inner texels from (b0y, b0x);
// then the tile's staged output rows (OUT_ROW floats each, 16-byte
// aligned)
__global__ void __launch_bounds__(TX * TY, 5)
    easu_kernel(const float* __restrict__ img, int H, int W, int out_h,
                int out_w, float inv_den_y, float inv_den_x, bool narrow,
                int wrows, int wcols, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_bx[TILE_W], s_by[TILE_H];
  __shared__ float s_fx[TILE_W], s_fy[TILE_H];
  const int n_win = wrows * wcols;
  const int frows = wrows - 2, fcols = wcols - 2, n_fld = frows * fcols;
  float* col = smem;                       // 3 × n_win: r, g, b
  float* lum = col + 3 * n_win;            // n_win
  float* fld = lum + n_win;                // 3 × n_fld: dx, dy, len
  float* stage = smem + stage_offset(wrows, wcols);
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int oy0 = blockIdx.y * TILE_H, ox0 = blockIdx.x * TILE_W;

  if (tid < TILE_W)
    axis_pos(ox0 + tid, W, out_w, inv_den_x, narrow, &s_bx[tid], &s_fx[tid]);
  else if (tid < TILE_W + TILE_H)
    axis_pos(oy0 + tid - TILE_W, H, out_h, inv_den_y, narrow,
             &s_by[tid - TILE_W], &s_fy[tid - TILE_W]);
  __syncthreads();
  const int b0y = s_by[0], b0x = s_bx[0];

  // the window's colours: a warp reads consecutive floats of an image row
  for (int wy = ty; wy < wrows; wy += TY) {
    const int gy = rtvb::clampi(b0y - 1 + wy, 0, H - 1);
    const float* row = img + 3 * static_cast<size_t>(gy) * W;
    for (int j = tx; j < 3 * wcols; j += TX) {
      const int wx = j / 3, c = j - 3 * wx;
      const int gx = rtvb::clampi(b0x - 1 + wx, 0, W - 1);
      col[c * n_win + wy * wcols + wx] = __ldg(row + 3 * gx + c);
    }
  }
  __syncthreads();
  for (int wy = ty; wy < wrows; wy += TY)
    for (int wx = tx; wx < wcols; wx += TX) {
      const int i = wy * wcols + wx;
      lum[i] = 0.5f * col[n_win + i] + 0.25f * (col[i] + col[2 * n_win + i]);
    }
  __syncthreads();

  // the field of inner texel (fy, fx) at its clamped global texel (gy, gx),
  // from the luma of the clamped neighbours; every one lies in the window
  auto L = [&](int y, int x) {
    return lum[(y - b0y + 1) * wcols + (x - b0x + 1)];
  };
  for (int fy = ty; fy < frows; fy += TY) {
    const int gy = rtvb::clampi(b0y + fy, 0, H - 1);
    const int gu = rtvb::clampi(gy - 1, 0, H - 1);
    const int gd = rtvb::clampi(gy + 1, 0, H - 1);
    for (int fx = tx; fx < fcols; fx += TX) {
      const int gx = rtvb::clampi(b0x + fx, 0, W - 1);
      const float c = L(gy, gx);
      const float lA = L(gy, rtvb::clampi(gx - 1, 0, W - 1));
      const float lB = L(gy, rtvb::clampi(gx + 1, 0, W - 1));
      const float lD = L(gu, gx);
      const float lE = L(gd, gx);
      const float dx = lB - lA;
      const float dy = lE - lD;
      const float rng_x = fabsf(lA - c) + fabsf(lB - c);
      const float rng_y = fabsf(lD - c) + fabsf(lE - c);
      const float qx = rtvb::clamp2(
          fabsf(dx) / rtvb::clamp_min(rng_x, 1e-4f), 0.0f, 1.0f);
      const float qy = rtvb::clamp2(
          fabsf(dy) / rtvb::clamp_min(rng_y, 1e-4f), 0.0f, 1.0f);
      const int k = fy * fcols + fx;
      fld[k] = dx;
      fld[n_fld + k] = dy;
      fld[2 * n_fld + k] = qx * qx + qy * qy;
    }
  }
  __syncthreads();

  // the tile's rows out: row r is staged at a float offset with the same
  // residue mod 4 as its place in `out`, so both sides of a 16-byte copy
  // are aligned
  const int oy = oy0 + ty;
  const int shift = static_cast<int>(
      (reinterpret_cast<uintptr_t>(
           out + (static_cast<size_t>(oy) * out_w + ox0) * 3) >> 2) & 3);
  float* srow = stage + ty * OUT_ROW + shift;
  const int ly = s_by[ty] - b0y;           // the row's base in the field
  const float fy = s_fy[ty];
#pragma unroll 1
  for (int k = 0; k < PER; ++k) {
    const int x = tx + TX * k;
    if (oy >= out_h || ox0 + x >= out_w) continue;
    const int lx = s_bx[x] - b0x;
    const float fx = s_fx[x];
    const int qf = ly * fcols + lx;                   // field at (b, b)
    const int qc = (ly + 1) * wcols + lx + 1;         // colour at (b, b)

    const float wf = (1.0f - fx) * (1.0f - fy);
    const float wg = fx * (1.0f - fy);
    const float wj = (1.0f - fx) * fy;
    const float wk = fx * fy;
    float bl[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float* f = fld + c * n_fld + qf;
      bl[c] = f[0] * wf + f[1] * wg + f[fcols] * wj + f[fcols + 1] * wk;
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
      const int dy = tap_dy(t), dx = tap_dx(t);
      const float vx = static_cast<float>(dx) - fx;
      const float vy = static_cast<float>(dy) - fy;
      const float along = vx * dirx_n + vy * diry_n;
      const float across = -vx * diry_n + vy * dirx_n;
      const float a = along * inv_along;
      const float d2 = clamp_max_nan(a * a + across * across, 4.0f);
      const float b = 0.4f * d2 - 1.0f;
      const float w = clamp_min_nan(b * b * 1.5625f - 0.5625f, 0.0f);
      const int q = qc + dy * wcols + dx;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float tv = col[c * n_win + q] * w;
        acc[c] = t == 0 ? tv : acc[c] + tv;
      }
      wsum = t == 0 ? w : wsum + w;
    }
    const float den = rtvb::clamp_min(wsum, 1e-5f);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float* p = col + c * n_win + qc;
      const float qmin = tmin(tmin(p[0], p[1]), tmin(p[wcols], p[wcols + 1]));
      const float qmax = tmax(tmax(p[0], p[1]), tmax(p[wcols], p[wcols + 1]));
      const float v = acc[c] / den;
      srow[3 * x + c] = rtvb::clamp2(v, qmin, qmax);   // torch.clamp
    }
  }
  __syncthreads();
  if (oy >= out_h) return;
  // warp ty writes row ty
  const int row_n = 3 * min(TILE_W, out_w - ox0);
  const float* src = srow;
  float* dst = out + (static_cast<size_t>(oy) * out_w + ox0) * 3;
  const int head = min(row_n, (4 - shift) & 3);
  const int n4 = (row_n - head) / 4;
  if (tx < head) dst[tx] = src[tx];
  for (int i = tx; i < n4; i += TX)
    *reinterpret_cast<float4*>(dst + head + 4 * i) =
        *reinterpret_cast<const float4*>(src + head + 4 * i);
  for (int i = head + 4 * n4 + tx; i < row_n; i += TX) dst[i] = src[i];
}

// the window one tile of `tile` outputs reaches, on one axis: the largest
// base span over the tiles + 4 (base − 1 … base + 2)
int window_extent(int out, int in, int tile) {
  long long span = 0;
  for (int t0 = 0; t0 < out; t0 += tile) {
    const int t1 = (t0 + tile < out ? t0 + tile : out) - 1;
    const long long s = axis_base64(t1, in, out) - axis_base64(t0, in, out);
    span = s > span ? s : span;
  }
  return static_cast<int>(span) + 4;
}

}  // namespace

RTVB_EXPORT int rtvb_easu(const float* img, int H, int W, int out_h,
                          int out_w, float inv_den_y, float inv_den_x,
                          float* out, void* stream) {
  if (out_h <= 0 || out_w <= 0) return 0;
  const int wrows = window_extent(out_h, H, TILE_H);
  const int wcols = window_extent(out_w, W, TILE_W);
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(stage_offset(wrows, wcols)) +
                       static_cast<size_t>(TILE_H) * OUT_ROW);
  const dim3 grid(rtvb::blocks_for(out_w, TILE_W),
                  rtvb::blocks_for(out_h, TILE_H));
  // (2o + 1)·in in int32 on both axes, for every o of the tiles
  const bool narrow =
      (2LL * grid.y * TILE_H + 1) * H < 2147483647LL &&
      (2LL * grid.x * TILE_W + 1) * W < 2147483647LL;
  // a downscale's window may pass the 48 KB default; past the card's
  // 227 KB the launch is refused and the wrapper raises
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(easu_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  easu_kernel<<<grid, dim3(TX, TY), smem,
                static_cast<cudaStream_t>(stream)>>>(
      img, H, W, out_h, out_w, inv_den_y, inv_den_x, narrow, wrows, wcols,
      out);
  return rtvb::launch_status();
}
