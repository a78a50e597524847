// K6 — one edge-stopping 5×5 à-trous wavelet pass at tap spacing `step`
// over (H, W, 3) illumination plus (H, W) variance, weighted by luminance
// (variance-scaled), normal (ndot^phi_normal) and depth.
//
// Replaces: rtvb_tpu/ops/denoise/atrous_kernel.py `_atrous_call` /
// `_make_kernel` (entry `atrous_pass_tpu`) and, because it takes any step,
// the XLA fallback the TPU path used above MAX_STEP = 8.  Plain version:
// rtvb_tpu_torch/ops/denoise/passes.py `atrous_pass_plain`.
//
// What bounds it on Hopper: arithmetic.  A pixel reads 25 taps of 9 values
// (colour, variance, depth, normal and the tap's luminance), 32 bytes of
// it from memory, and each of its 24 weights costs two IEEE divisions (a
// reciprocal, its refinement and a range check each), an accurate expf and
// six squarings.  The taps themselves are not what costs: fetched straight
// from global memory at 256 pixels of one row a block, they were served by
// L1 and L2, and the loads were never the limit.  Design:
// - a 32×8 block stages its stencil window once, with coalesced loads, in
//   shared memory as nine planes (r, g, b, var, depth, nx, ny, nz and
//   luminance, computed once per texel with the same rtvb::luminance), and
//   runs all 25 taps from there, conflict-free;
// - a block's 8 rows are 8 rows of one residue class mod the step, so the
//   taps fall 1 row apart on that sub-lattice and the window is 12 rows at
//   any step; its 32 columns are consecutive with a halo of 2·step (36 to
//   96 columns at steps 1 to 16, ≤ 41.5 KB).  A window past the default
//   48 KB (step ≥ 21) opts into more.  Past the card's opt-in limit (227
//   KB on an H100: step ≥ 127) the 32 columns are one residue class mod
//   the step as well, so the window is 12 × 36 texels at any step; its
//   rows are no longer coalesced, which only the settings' iterations ≥ 8
//   reach;
// - window texels past the border hold edge-clamped copies, which is the
//   plain version's `shift` (clamp to [0, H-1] × [0, W-1]);
// - the normal weight is the plain version's `pow_weight`: repeated
//   squaring for a power-of-two phi_normal; otherwise torch.pow's own
//   CUDA rule for a float exponent (its cases 0, 0.5, -0.5, -1, 3 and -2,
//   else powf), so the two agree to the bit for any phi_normal;
// - the frame's steps with the shipped phi_normal have instances whose
//   window shape, tap offsets and squarings are compile-time constants,
//   so a tap costs no address arithmetic;
// - each weight is computed op for op like the plain version's, in the
//   same tap order, so the two agree to the bit (--fmad=false).
#include "common.cuh"

namespace {

constexpr int TX = 32, TY = 8;            // a block's tile
constexpr int PLANES = 9;
constexpr size_t DEFAULT_SHARED = 48 * 1024;
// the shipped phi_normal (64 = 2^6) gets instances with the squarings
// unrolled, and at the frame's steps (1, 2, 4, 8) with the window's shape,
// hence every tap's shared-memory offset, fixed at compile time too; the
// generic instance takes any phi_normal and any step
constexpr int SHIPPED_SQUARINGS = 6;

// how the generic instance raises ndot to phi_normal: torch.pow(x, e) on
// CUDA for a float e (squarings for a power of two, as pow_weight)
enum PowMode { POW_SQUARE = 0, POW_ZERO, POW_SQRT, POW_RSQRT, POW_RECIP,
               POW_CUBE, POW_INV_SQUARE, POW_POWF };

__host__ __device__ constexpr int iabs(int v) { return v < 0 ? -v : v; }

// the 1-D B3 spline weights 3/8, 1/4, 1/16 at |offset| 0, 1, 2
__device__ constexpr float w1d(int a) {
  return a == 0 ? 0.375f : (a == 1 ? 0.25f : 0.0625f);
}

// Where a pass at `step` puts its blocks.  Rows: a block's 8 rows are the
// rows of one residue class mod |step|, `lat` apart, and its row taps are
// g = sign(step) lattice rows apart (the halo is 2·|g| rows, and every
// window row is a coalesced segment).  Columns: 32 consecutive ones, taps
// `step` apart, with a halo of 2·|step|; or, `wide`, 32 columns of one
// residue class mod |step|, `latx` apart, taps gx = sign(step) lattice
// columns apart with a halo of 2.
struct Layout {
  int lat, g, hy, latx, gx, hx;
};

__host__ __device__ constexpr Layout layout(int step, bool wide = false) {
  return wide ? Layout{iabs(step), (step > 0) - (step < 0), 2, iabs(step),
                       (step > 0) - (step < 0), 2}
              : Layout{step == 0 ? 1 : iabs(step), (step > 0) - (step < 0),
                       step == 0 ? 0 : 2, 1, step, 2 * iabs(step)};
}

__host__ __device__ constexpr size_t window_bytes(int step,
                                                  bool wide = false) {
  return sizeof(float) * PLANES * (TY + 2 * layout(step, wide).hy) *
         (TX + 2 * static_cast<size_t>(layout(step, wide).hx));
}

struct Pass {
  const float *illum, *var, *depth, *normal;
  float *out, *out_var;
  int H, W, step;
  float phi_lum, phi_depth;
  int n_squarings;           // POW_SQUARE: phi_normal = 2^n_squarings
  PowMode pow_mode;
  float phi_normal;
};

// ndot^phi_normal as the plain version's pow_weight computes it on CUDA
__device__ __forceinline__ float pow_weight(float x, const Pass& a) {
  switch (a.pow_mode) {
    case POW_SQUARE:
      for (int k = 0; k < a.n_squarings; ++k) x = x * x;
      return x;
    case POW_ZERO: return 1.0f;
    case POW_SQRT: return sqrtf(x);
    case POW_RSQRT: return rsqrtf(x);
    case POW_RECIP: return 1.0f / x;
    case POW_CUBE: return x * x * x;
    case POW_INV_SQUARE: return 1.0f / (x * x);
    default: return powf(x, a.phi_normal);
  }
}

// The block's pixels are (ry + lat·ly, rx + latx·lx) over a tile of 8
// lattice rows ly of the residue class ry and 32 lattice columns lx of the
// class rx.  NSQ ≥ 0 and STEP > 0 fix the squarings and the layout at
// compile time; NSQ = -1 squares a run-time number of times, NSQ = -2
// raises to any phi_normal (pow_weight).  WIDE: the columns on the step's
// lattice too (Layout).
template <int NSQ, int STEP, bool WIDE = false>
__global__ void __launch_bounds__(TX * TY)
atrous_kernel(Pass a, int tiles_x, int tiles_y) {
  extern __shared__ float win[];
  const int step = STEP > 0 ? STEP : a.step;
  const Layout l = layout(step, WIDE);
  const int H = a.H, W = a.W;
  const int WW = TX + 2 * l.hx, WH = TY + 2 * l.hy, WN = WW * WH;
  float* s_r = win;
  float* s_g = s_r + WN;
  float* s_b = s_g + WN;
  float* s_v = s_b + WN;
  float* s_d = s_v + WN;
  float* s_nx = s_d + WN;
  float* s_ny = s_nx + WN;
  float* s_nz = s_ny + WN;
  float* s_l = s_nz + WN;

  const int ry = blockIdx.y / tiles_y;
  const int ly0 = (blockIdx.y % tiles_y) * TY - l.hy;   // window origin
  // one column class unless the columns lie on the lattice
  const int rx = WIDE ? blockIdx.x / tiles_x : 0;
  const int lx0 = (WIDE ? blockIdx.x % tiles_x : blockIdx.x) * TX - l.hx;
  for (int wy = threadIdx.y; wy < WH; wy += TY) {
    const int py = rtvb::clampi(ry + l.lat * (ly0 + wy), 0, H - 1);
    for (int wx = threadIdx.x; wx < WW; wx += TX) {
      const int px = rtvb::clampi(rx + l.latx * (lx0 + wx), 0, W - 1);
      const int p = py * W + px;
      const int i = wy * WW + wx;
      const float r = a.illum[3 * p], gg = a.illum[3 * p + 1],
                  b = a.illum[3 * p + 2];
      s_r[i] = r;
      s_g[i] = gg;
      s_b[i] = b;
      s_l[i] = rtvb::luminance(r, gg, b);
      s_v[i] = a.var[p];
      s_d[i] = a.depth[p];
      s_nx[i] = a.normal[3 * p];
      s_ny[i] = a.normal[3 * p + 1];
      s_nz[i] = a.normal[3 * p + 2];
    }
  }
  __syncthreads();

  const int ty = threadIdx.y, tx = threadIdx.x;
  const int y = ry + l.lat * (ly0 + l.hy + ty);
  const int x = rx + l.latx * (lx0 + l.hx + tx);
  if (y >= H || x >= W) return;
  const int c = (ty + l.hy) * WW + tx + l.hx;
  const float r = s_r[c], gg = s_g[c], b = s_b[c];
  const float v = s_v[c];
  const float d = s_d[c];
  const float nx = s_nx[c], ny = s_ny[c], nz = s_nz[c];
  const float lum_c = s_l[c];
  const float sigma_l = a.phi_lum * sqrtf(fmaxf(v, 1e-8f)) + 1e-3f;
  const float w0 = 0.140625f;                 // 0.375²
  float acc_r = r * w0, acc_g = gg * w0, acc_b = b * w0;
  float acc_v = v * 0.019775390625f;          // w0²
  float wsum = w0;
  const float d_ref = a.phi_depth * fmaxf(d, 1.0f);
#pragma unroll
  for (int dy = -2; dy <= 2; ++dy) {
#pragma unroll
    for (int dx = -2; dx <= 2; ++dx) {
      if (dy == 0 && dx == 0) continue;
      const float wk = w1d(iabs(dy)) * w1d(iabs(dx));
      // shift(img, oy, ox)[y, x] = img[clamp(y - oy), clamp(x - ox)]:
      // the window texel dy·g lattice rows and dx·gx columns back
      const int q = c - dy * l.g * WW - dx * l.gx;
      const float qr = s_r[q], qg = s_g[q], qb = s_b[q];
      const float qd = s_d[q];
      const float n_lum = s_l[q];
      const float e_z =
          fabsf(qd - d) /
          (d_ref * static_cast<float>(max(iabs(dy) + iabs(dx), 1)));
      float w_n = fmaxf(s_nx[q] * nx + s_ny[q] * ny + s_nz[q] * nz, 0.0f);
      if (NSQ >= 0) {
#pragma unroll
        for (int k = 0; k < NSQ; ++k) w_n = w_n * w_n;
      } else if (NSQ == -1) {
        for (int k = 0; k < a.n_squarings; ++k) w_n = w_n * w_n;
      } else {
        w_n = pow_weight(w_n, a);
      }
      const float e_l = fabsf(n_lum - lum_c) / sigma_l;
      float w = wk * expf(-(e_z + e_l)) * w_n;
      if (qd >= rtvb::BIG || d >= rtvb::BIG) w = 0.0f;
      acc_r = acc_r + qr * w;
      acc_g = acc_g + qg * w;
      acc_b = acc_b + qb * w;
      acc_v = acc_v + s_v[q] * (w * w);
      wsum = wsum + w;
    }
  }
  const float inv = 1.0f / fmaxf(wsum, 1e-6f);
  const int p = y * W + x;
  a.out[3 * p] = acc_r * inv;
  a.out[3 * p + 1] = acc_g * inv;
  a.out[3 * p + 2] = acc_b * inv;
  a.out_var[p] = acc_v * inv * inv;
}

// the grid of a pass: (32-column tiles × residue classes of the columns,
// 8-row tiles × residue classes of the rows); the classes past the image
// (a lattice coarser than the image) hold no pixel and get no block
template <int NSQ, int STEP, bool WIDE>
int launch_layout(const Pass& a, cudaStream_t stream) {
  auto kern = atrous_kernel<NSQ, STEP, WIDE>;
  const Layout l = layout(a.step, WIDE);
  const size_t smem = window_bytes(a.step, WIDE);
  if (smem > DEFAULT_SHARED) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int tiles_x = rtvb::blocks_for(rtvb::blocks_for(a.W, l.latx), TX);
  const int tiles_y = rtvb::blocks_for(rtvb::blocks_for(a.H, l.lat), TY);
  const long long gx =
      static_cast<long long>(tiles_x) * (l.latx < a.W ? l.latx : a.W);
  const long long gy =
      static_cast<long long>(tiles_y) * (l.lat < a.H ? l.lat : a.H);
  if (gy > 65535 || gx > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  kern<<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy)),
         dim3(TX, TY), smem, stream>>>(a, tiles_x, tiles_y);
  return rtvb::launch_status();
}

// the grid of a pass: (32-column tiles × residue classes of the columns,
// 8-row tiles × residue classes of the rows); the classes past the image
// (a lattice coarser than the image) hold no pixel and get no block.  A
// window of consecutive columns past what a block may hold takes the
// instance with its columns on the step's lattice too (12 × 36 texels at
// any step)
template <int NSQ, int STEP>
int launch(const Pass& a, cudaStream_t stream) {
  if constexpr (STEP == 0) {
    if (window_bytes(a.step) > DEFAULT_SHARED) {
      int dev = 0, optin = 0;
      cudaError_t e = cudaGetDevice(&dev);
      if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (e != cudaSuccess) return static_cast<int>(e);
      if (window_bytes(a.step) > static_cast<size_t>(optin))
        return launch_layout<NSQ, STEP, true>(a, stream);
    }
  }
  return launch_layout<NSQ, STEP, false>(a, stream);
}

}  // namespace

// pow_mode (a PowMode) and n_squarings: how the plain version raises to
// phi_normal, decided by the wrapper from phi_normal as a Python float
// (ops/denoise/atrous_kernel.py `pow_mode`).  Returns a cudaError_t code.
RTVB_EXPORT int rtvb_atrous_pow(const float* illum, const float* var,
                                const float* depth, const float* normal,
                                int H, int W, int step, float phi_lum,
                                float phi_depth, float phi_normal,
                                int pow_mode, int n_squarings, float* out,
                                float* out_var, void* stream) {
  if (H == 0 || W == 0) return 0;
  if (pow_mode < POW_SQUARE || pow_mode > POW_POWF || n_squarings < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const PowMode mode = static_cast<PowMode>(pow_mode);
  const Pass a{illum, var,   depth,       normal, out,       out_var,
               H,     W,     step,        phi_lum, phi_depth, n_squarings,
               mode,  phi_normal};
  auto s = static_cast<cudaStream_t>(stream);
  if (mode != POW_SQUARE) return launch<-2, 0>(a, s);
  if (n_squarings != SHIPPED_SQUARINGS) return launch<-1, 0>(a, s);
  constexpr int N = SHIPPED_SQUARINGS;
  switch (step) {
    case 1: return launch<N, 1>(a, s);
    case 2: return launch<N, 2>(a, s);
    case 4: return launch<N, 4>(a, s);
    case 8: return launch<N, 8>(a, s);
    default: return launch<N, 0>(a, s);
  }
}
