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
// What bounds it on Hopper: scattered 4-byte reads — 2 levels × 4 taps ×
// 3 planes per pixel from a ~40 MB atlas (nine textures) — so latency and
// L2 hit rate, not arithmetic.  Design: one block per tile does the two
// tile reductions (min level, padding 6; demand texture, padding 32) in
// shared memory, then each thread samples its pixels straight from the
// atlas in device memory: the whole pyramid stays resident (no demand
// paging, no DMA window), and neighbouring pixels hit the same cache lines.
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
constexpr int THREADS = 256;
constexpr int PER_THREAD = TILE_R * TILE_C / THREADS;

struct Atlas {
  const float* lo;
  const float* hi;
  int lo_rows, hi_rows;   // rows per plane
};

// the 3 packed planes of texel (py, px) at level li
__device__ __forceinline__ void fetch(const Atlas& a, int li, int tid, int py,
                                      int px, uint32_t out[3]) {
  if (li < HI_LEVELS) {
    const int off = li == 0 ? 0 : (li == 1 ? 512 : 768);
    const int row = rtvb::clampi(tid * HI_ROWS + off + py, 0, a.hi_rows - 1);
    const size_t plane = static_cast<size_t>(a.hi_rows) * S0;
    size_t idx = static_cast<size_t>(row) * S0 + px;
    idx = idx < plane ? idx : plane - 1;
    for (int p = 0; p < 3; ++p)
      out[p] = __float_as_uint(__ldg(a.hi + p * plane + idx));
  } else {
    const int s_lo = 64 >> (li - HI_LEVELS);
    const int off = (LO_ROWS - 8) - 2 * s_lo;
    const int row = rtvb::clampi(tid * LO_ROWS + off + py, 0, a.lo_rows - 1);
    const size_t plane = static_cast<size_t>(a.lo_rows) * LO_COLS;
    size_t idx = static_cast<size_t>(row) * LO_COLS + px;
    idx = idx < plane ? idx : plane - 1;
    for (int p = 0; p < 3; ++p)
      out[p] = __float_as_uint(__ldg(a.lo + p * plane + idx));
  }
}

// bilinear 6-channel sample at integer level li (the plain version's
// _sample_level_ref, op for op)
__device__ void sample_level(const Atlas& a, int li, int tid, float u,
                             float v, float out[6]) {
  const int s = S0 >> li;
  const float sf = static_cast<float>(s);
  const float x = u * sf - 0.5f;
  const float y = v * sf - 0.5f;
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float wx = x - x0f;
  const float wy = y - y0f;
  const int x0 = rtvb::pymod(rtvb::floor_i32(x0f), s);
  const int y0 = rtvb::pymod(rtvb::floor_i32(y0f), s);
  const int x1 = rtvb::pymod(x0 + 1, s);
  const int y1 = rtvb::pymod(y0 + 1, s);
  uint32_t f00[3], f01[3], f10[3], f11[3];
  fetch(a, li, tid, y0, x0, f00);
  fetch(a, li, tid, y0, x1, f01);
  fetch(a, li, tid, y1, x0, f10);
  fetch(a, li, tid, y1, x1, f11);
  for (int p = 0; p < 3; ++p) {
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

__global__ void texture_kernel(const int* __restrict__ tid_g,
                               const float* __restrict__ u_g,
                               const float* __restrict__ v_g,
                               const float* __restrict__ lvl_g, Atlas atlas,
                               int H, int W, int t_count,
                               float* __restrict__ out) {
  __shared__ int s_min_lvl;
  __shared__ int s_t_hi;
  const int y0 = blockIdx.y * TILE_R;
  const int x0 = blockIdx.x * TILE_C;
  if (threadIdx.x == 0) {
    s_min_lvl = LEVELS - 1;
    s_t_hi = MAX_TEXTURES;
  }
  __syncthreads();

  // reduction 1: the tile's finest level (padding counts as LEVELS - 1)
  int lvl_i[PER_THREAD];
  int tids[PER_THREAD];
  int my_min = LEVELS - 1;
  for (int k = 0; k < PER_THREAD; ++k) {
    const int p = threadIdx.x + k * THREADS;
    const int y = y0 + p / TILE_C, x = x0 + p % TILE_C;
    if (y < H && x < W) {
      const int i = y * W + x;
      lvl_i[k] = static_cast<int>(lvl_g[i]);    // lvl ≥ 0: trunc = floor
      tids[k] = tid_g[i];
    } else {
      lvl_i[k] = LEVELS - 1;
      tids[k] = -1;
    }
    my_min = min(my_min, lvl_i[k]);
  }
  atomicMin(&s_min_lvl, my_min);
  __syncthreads();
  const int l0t = rtvb::clampi(s_min_lvl, 0, LEVELS - 2);

  // reduction 2: the demand texture (lowest textured id at the tile level)
  int my_cand = MAX_TEXTURES;
  for (int k = 0; k < PER_THREAD; ++k)
    if (lvl_i[k] == l0t && tids[k] >= 0) my_cand = min(my_cand, tids[k]);
  atomicMin(&s_t_hi, my_cand);
  __syncthreads();
  const int t_hi = s_t_hi;
  const bool hi_valid = l0t < HI_LEVELS && t_hi < t_count;

  const size_t plane = static_cast<size_t>(H) * W;
  for (int k = 0; k < PER_THREAD; ++k) {
    const int p = threadIdx.x + k * THREADS;
    const int y = y0 + p / TILE_C, x = x0 + p % TILE_C;
    if (y >= H || x >= W) continue;
    const int i = y * W + x;
    const int tid = tids[k];
    float res[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (tid >= 0) {
      const bool main_hi = hi_valid && tid == t_hi;
      const int la = main_hi ? l0t : max(l0t, HI_LEVELS);
      const float w1 =
          rtvb::clampf(lvl_g[i] - static_cast<float>(la), 0.0f, 1.0f);
      float c0[6], c1[6];
      sample_level(atlas, la, tid, u_g[i], v_g[i], c0);
      sample_level(atlas, min(la + 1, LEVELS - 1), tid, u_g[i], v_g[i], c1);
      for (int c = 0; c < 6; ++c) res[c] = c0[c] * (1.0f - w1) + c1[c] * w1;
    }
    for (int c = 0; c < 6; ++c) out[c * plane + i] = res[c];
  }
}

}  // namespace

RTVB_EXPORT int rtvb_texture(const int* tid, const float* u, const float* v,
                             const float* lvl, const float* lo,
                             const float* hi, int H, int W, int t_count,
                             float* out, void* stream) {
  if (H == 0 || W == 0) return 0;
  Atlas atlas{lo, hi, t_count * LO_ROWS, t_count * HI_ROWS};
  dim3 grid(rtvb::blocks_for(W, TILE_C), rtvb::blocks_for(H, TILE_R));
  texture_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      tid, u, v, lvl, atlas, H, W, t_count, out);
  return rtvb::launch_status();
}
