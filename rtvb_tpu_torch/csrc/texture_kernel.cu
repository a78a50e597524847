// K3 — adaptive trilinear sample of the authored PBR atlas: 6 channels
// (albedo rgb, roughness multiplier, normal du/dv) from bf16 pairs packed
// in f32 words.  The level pair is chosen per (32, 128) tile of the padded
// image: the finest level any pixel of the tile wants; only the tile's
// demand texture (the lowest textured id at that level) samples that pair,
// every other textured pixel clamps the pair to ≥ 3.
//
// Replaces: rtvb_tpu/assets/image_textures.py `_sample_tiles` /
// `_make_kernel` / `_sample_tile` / `_tile_scalars` (entry `sample_atlas`).
// Plain version: rtvb_tpu_torch/assets/image_textures.py `_sample_ref`.
//
// What bounds it on Hopper: latency.  A pixel moves 40 bytes of its own
// (tid, u, v, level in; 6 channels out: ≈ 0.025 ms for a 1080p frame at
// 3.35 TB/s) and reads 2 levels × 4 taps of the atlas, which neighbouring
// pixels share through L1 (the frame's 648 texels: a few KB).  At 64
// registers a 1024-thread block fills an SM, so the 510 tiles run in 4
// waves, each waiting on its loads and its two barriers: 0.0508 ms
// (NVIDIA H100 80GB HBM3 at 700 W, kernel_ab.py).  The first kernel
// (one 256-thread block a tile, 16 pixels a thread in turn, 24 scalar
// gathers a pixel from three planes, shared atomics for the two tile
// reductions) ran 0.0763 ms (NVIDIA H100 80GB HBM3 at 700 W): 510 blocks,
// ≈ 4 an SM, few loads in flight.  Design:
// - a 1024-thread block a tile, 4 pixels a thread, all of a pixel's
//   inputs (id, level, u, v) loaded before the tile's two reductions
//   (the finest level, then the demand texture: __reduce_min_sync in each
//   warp, one shared step), so they arrive while the tile reduces, and
//   every pixel's inputs are read once, into the registers that sample
//   it.  Measured against the alternatives (kernel_ab.py in turns,
//   NVIDIA H100 80GB HBM3 at 700 W): four 256-thread blocks a tile as one
//   thread-block cluster, exchanging their quarters' minima through
//   distributed shared memory, ran 0.0603 ms (its cluster barriers compile
//   to a GPU-wide fence), and four blocks each re-reading the whole tile
//   0.0592, against this one's 0.0510;
// - each tap's index in int32 (the atlas's largest index is < 2^24), and
//   Python's modulo by the level's size, a power of two, as a mask: the
//   first kernel's 64-bit index arithmetic and run-time divisions, still
//   in this kernel's first version, were most of its ~720 SASS
//   instructions a textured pixel;
// - a kernel-side copy of the atlas with the three words of a texel
//   interleaved into one 16-byte texel (r|g, b|rough, du|dv, 0), built at
//   load from the same words: a tap is one 16-byte load, 8 a pixel rather
//   than 24 (the same kernel on the planar atlas, the JAX package's
//   layout, which the plain version reads, ran 0.0551 ms against 0.0508:
//   kernel_ab.py in turns, same card).
// The whole pyramid stays resident (no demand paging, no DMA window).
// Untextured pixels (id < 0) write 0; the wrapper masks them to neutral.
#include "common.cuh"

namespace {

constexpr int S0 = 512;
constexpr int LEVELS = 7;
constexpr int HI_LEVELS = 3;
constexpr int HI_ROWS = 896;
constexpr int LO_ROWS = 128;
constexpr int LO_COLS = 128;
constexpr int MAX_TEXTURES = 32;
constexpr int TILE_R = 32;
constexpr int TILE_C = 128;
constexpr int THREADS = 1024;                     // a tile a block
constexpr int WARPS = THREADS / 32;
constexpr int ROW_STEP = THREADS / TILE_C;        // rows a pass covers
constexpr int PER = TILE_R / ROW_STEP;            // pixels a thread

// the interleaved atlas: one 16-byte texel of 3 words and a 0
struct Atlas {
  const uint4* lo4;          // levels 3-6, 128 columns
  const uint4* hi4;          // levels 0-2, 512 columns
  int lo_rows, hi_rows;      // rows of each tier
};

// where level li of texture tid lies: its tier's texels (hi: levels 0-2,
// 512 columns; lo: levels 3-6, 128), their rows, its first row.  All in
// int32: the largest index, 32 textures' hi tier, is < 2^24
struct Level {
  const uint4* p;
  int row0, rows, stride;
};

__device__ __forceinline__ Level level_of(const Atlas& a, int li, int tid) {
  Level l;
  if (li < HI_LEVELS) {
    l.p = a.hi4;
    l.row0 = tid * HI_ROWS + (li == 0 ? 0 : (li == 1 ? 512 : 768));
    l.rows = a.hi_rows;
    l.stride = S0;
  } else {
    l.p = a.lo4;
    l.row0 = tid * LO_ROWS + (LO_ROWS - 8) - 2 * (64 >> (li - HI_LEVELS));
    l.rows = a.lo_rows;
    l.stride = LO_COLS;
  }
  return l;
}

// the 3 packed words of texel (py, px) of a level.  The row is clamped to
// the tier as the plain version clamps it; px < the level's size ≤ the
// tier's width, so the plain version's clamp of the index to the plane
// never moves it
__device__ __forceinline__ void fetch(const Level& l, int py, int px,
                                      uint32_t out[3]) {
  const int row = rtvb::clampi(l.row0 + py, 0, l.rows - 1);
  const uint4 w = __ldg(l.p + row * l.stride + px);
  out[0] = w.x;
  out[1] = w.y;
  out[2] = w.z;
}

// bilinear 6-channel sample at integer level li (the plain version's
// _sample_level_ref, op for op; Python's modulo by the level's size, a
// power of two, is a mask)
__device__ __forceinline__ void sample_level(const Atlas& a, int li, int tid,
                                             float u, float v, float out[6]) {
  const int s = S0 >> li;
  const float sf = static_cast<float>(s);
  const float x = u * sf - 0.5f;
  const float y = v * sf - 0.5f;
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float wx = x - x0f;
  const float wy = y - y0f;
  const int m = s - 1;
  const int x0 = rtvb::floor_i32(x0f) & m;
  const int y0 = rtvb::floor_i32(y0f) & m;
  const int x1 = (x0 + 1) & m;
  const int y1 = (y0 + 1) & m;
  const Level l = level_of(a, li, tid);
  uint32_t f00[3], f01[3], f10[3], f11[3];
  fetch(l, y0, x0, f00);
  fetch(l, y0, x1, f01);
  fetch(l, y1, x0, f10);
  fetch(l, y1, x1, f11);
#pragma unroll
  for (int p = 0; p < 3; ++p) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float a00, a01, a10, a11;
      if (h == 0) {
        a00 = rtvb::bf16_lo(f00[p]); a01 = rtvb::bf16_lo(f01[p]);
        a10 = rtvb::bf16_lo(f10[p]); a11 = rtvb::bf16_lo(f11[p]);
      } else {
        a00 = rtvb::bf16_hi(f00[p]); a01 = rtvb::bf16_hi(f01[p]);
        a10 = rtvb::bf16_hi(f10[p]); a11 = rtvb::bf16_hi(f11[p]);
      }
      const float top = a00 * (1.0f - wx) + a01 * wx;
      const float bot = a10 * (1.0f - wx) + a11 * wx;
      out[2 * p + h] = top * (1.0f - wy) + bot * wy;
    }
  }
}

// one pixel's sample (tid ≥ 0) or 0 (tid < 0), into its 6 planes
__device__ __forceinline__ void sample_pixel(const Atlas& atlas, int tid,
                                             float lvl, float u, float v,
                                             int l0t, int t_hi, bool hi_valid,
                                             float* out, size_t plane) {
  float res[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (tid >= 0) {
    const bool main_hi = hi_valid && tid == t_hi;
    const int la = main_hi ? l0t : max(l0t, HI_LEVELS);
    const float w1 = rtvb::clampf(lvl - static_cast<float>(la), 0.0f, 1.0f);
    float c0[6], c1[6];
    sample_level(atlas, la, tid, u, v, c0);
    sample_level(atlas, min(la + 1, LEVELS - 1), tid, u, v, c1);
#pragma unroll
    for (int c = 0; c < 6; ++c) res[c] = c0[c] * (1.0f - w1) + c1[c] * w1;
  }
#pragma unroll
  for (int c = 0; c < 6; ++c) out[c * plane] = res[c];
}

// the minimum of v over the block (every thread gets it)
__device__ __forceinline__ int block_min(int v, int* s_warp) {
  v = __reduce_min_sync(0xFFFFFFFFu, v);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  int m = s_warp[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) m = min(m, s_warp[w]);
  return m;
}

__global__ void __launch_bounds__(THREADS)
    texture_kernel(const int* __restrict__ tid_g,
                   const float* __restrict__ u_g,
                   const float* __restrict__ v_g,
                   const float* __restrict__ lvl_g, Atlas atlas, int H,
                   int W, int t_count, float* __restrict__ out) {
  __shared__ int s_min[WARPS], s_cand[WARPS];
  const int y0 = blockIdx.y * TILE_R;
  const int x = blockIdx.x * TILE_C + threadIdx.x % TILE_C;
  const int ry = threadIdx.x / TILE_C;
  // this thread's pixels, all their inputs loaded at once (u and v while
  // the tile reduces): the id, the level and its floor (≥ 0: trunc)
  int idx[PER], tids[PER], lvl_i[PER];
  float lvls[PER], us[PER], vs[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int y = y0 + ry + ROW_STEP * k;
    const bool in = x < W && y < H;
    idx[k] = in ? y * W + x : -1;
    const int i = in ? idx[k] : 0;
    tids[k] = in ? tid_g[i] : -1;
    lvls[k] = in ? lvl_g[i] : static_cast<float>(LEVELS - 1);
    us[k] = in ? u_g[i] : 0.0f;
    vs[k] = in ? v_g[i] : 0.0f;
    lvl_i[k] = in ? static_cast<int>(lvls[k]) : LEVELS - 1;
  }
  // reduction 1: the tile's finest level (padding counts as LEVELS - 1)
  int my_min = LEVELS - 1;
#pragma unroll
  for (int k = 0; k < PER; ++k) my_min = min(my_min, lvl_i[k]);
  const int l0t = rtvb::clampi(block_min(my_min, s_min), 0, LEVELS - 2);
  // reduction 2: the demand texture (lowest textured id at the tile level)
  int my_cand = MAX_TEXTURES;
#pragma unroll
  for (int k = 0; k < PER; ++k)
    if (lvl_i[k] == l0t && tids[k] >= 0) my_cand = min(my_cand, tids[k]);
  const int t_hi = block_min(my_cand, s_cand);
  const bool hi_valid = l0t < HI_LEVELS && t_hi < t_count;
  const size_t plane = static_cast<size_t>(H) * W;
  static_assert(PER == 4, "four pixels a thread");
#define RTVB_SAMPLE(k)                                                      \
  if (idx[k] >= 0)                                                          \
    sample_pixel(atlas, tids[k], lvls[k], us[k], vs[k], l0t, t_hi,      \
                     hi_valid, out + idx[k], plane);
  RTVB_SAMPLE(0)
  RTVB_SAMPLE(1)
  RTVB_SAMPLE(2)
  RTVB_SAMPLE(3)
#undef RTVB_SAMPLE
}

}  // namespace

// lo4 / hi4: the atlas's interleaved copy (16-byte texels).  Returns a
// cudaError_t code.
RTVB_EXPORT int rtvb_texture_tiles(const int* tid, const float* u,
                                   const float* v, const float* lvl,
                                   const void* lo4, const void* hi4, int H,
                                   int W, int t_count, float* out,
                                   void* stream) {
  if (H == 0 || W == 0) return 0;
  const Atlas atlas{static_cast<const uint4*>(lo4),
                    static_cast<const uint4*>(hi4), t_count * LO_ROWS,
                    t_count * HI_ROWS};
  const dim3 grid(rtvb::blocks_for(W, TILE_C), rtvb::blocks_for(H, TILE_R));
  texture_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      tid, u, v, lvl, atlas, H, W, t_count, out);
  return rtvb::launch_status();
}
