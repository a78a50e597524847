// K2 — closest-hit Möller–Trumbore intersection of every ray with a small
// packed triangle soup (T, 9) = [v0 | e1 | e2] (decorations and entities).
// Ties keep the lowest triangle index; rows with a zero e1 (the zero
// padding) never hit.
//
// Replaces: rtvb_tpu/ops/tri_kernel.py `_tri_tiles` / `_make_kernel`
// (entry `intersect_packed_tpu`).  Plain version:
// rtvb_tpu_torch/ops/triangles.py `intersect_packed_plain`.
//
// What bounds it on Hopper: the sweep.  A ray moves 45 bytes (24 in, a
// 4-byte cap where the caller passes one, 17 out), but testing it against
// all 16 triangles of the canonical flower soup costs ~1,100 instructions
// under --fmad=false (each test's cross products, dots, IEEE division and
// compares): the first kernel ran the 1080p camera wave in 0.1121 ms
// against a byte bound of 0.0279.  The flowers cover a few percent of the
// screen, so nearly every ray's sweep finds nothing.  Design:
// - boxes, as the TPU kernel had one: each block stages the soup in
//   shared memory and, in its prologue, reduces the box of every cluster
//   of 4 consecutive rows (a flower) and the soup's box over them, each
//   over the rows the sweep tests and padded by 1e-3.  A ray first
//   slab-tests the soup's box within its cap, then each cluster's, and
//   runs Möller–Trumbore only on the rows of a cluster it can reach; a
//   warp none of whose rays reach the soup's box skips the sweep.  The
//   soup's box alone let 27% of the camera rays through to all 16 tests
//   (0.0578 ms); the clusters' boxes stop nearly all of them (0.0378 ms,
//   NVIDIA H100 80GB HBM3 at 700 W, kernel_ab.py in turns).  The slab
//   bounds are widened by 2^-20 of their size, more than their own
//   rounding, so a cull drops no ray whose computed hit lies within the
//   padding of its triangle.  That holds unless the determinant is mostly
//   rounding (a ray nearly in the plane of a triangle that is not
//   axis-aligned), where Möller–Trumbore's own u, v and t are noise and
//   its "hit" can lie anywhere on the ray;
// - inside the sweep, |det| ≤ EPS skips the division and the rest of the
//   test (the plain version's test fails there for any u, v, t);
// - persistent blocks: as many 256-thread blocks as the card holds at once
//   (fewer for few rays) walk the rays grid-stride, so the soup is staged
//   and its boxes reduced once per block, not once per 256 rays;
// - the function's own bytes: a 1-byte hit written straight into the
//   caller's torch.bool tensor, and a null cap for "no cap" (BIG).
#include "common.cuh"

namespace {

using rtvb::BIG;
constexpr float EPS = 1e-7f;
constexpr float BOX_PAD = 1e-3f;           // the TPU kernel's padding
constexpr float SLAB_SLACK = 9.5367431640625e-7f;   // 2^-20
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CLUSTER = 4;                 // rows under one cluster box

struct Rays {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *tcap;   // tcap may be null
  int n;
};

struct Record {
  uint8_t* hit;
  float* t;
  int* tri;
  float *u, *v;
};

// the TPU kernel's slab reciprocal: |c| < 1e-12 → ±1e-12 (+ for ±0)
__device__ __forceinline__ float slab_inv(float c) {
  return 1.0f / (fabsf(c) < 1e-12f ? (c >= 0.0f ? 1e-12f : -1e-12f) : c);
}

// a box bound moved out by the TPU kernel's padding, and by 2^-20 of the
// coordinate for the rounding of v0 + e at far-out soups
__device__ __forceinline__ float pad_down(float x) {
  return x - BOX_PAD - fabsf(x) * SLAB_SLACK;
}
__device__ __forceinline__ float pad_up(float x) {
  return x + BOX_PAD + fabsf(x) * SLAB_SLACK;
}

// can the ray reach the box [lo, hi] at some t in [0, cap]?  inv: the
// slab reciprocals of its direction.  Each slab's near bound moves down
// and its far bound up by 2^-20 of its size: more than the three
// roundings of (lo - o) * (1 / d)
__device__ __forceinline__ bool reaches(const float lo[3], const float hi[3],
                                        const float o[3], const float inv[3],
                                        float cap) {
  float tmin = -BIG, tmax = BIG;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t0 = (lo[a] - o[a]) * inv[a], t1 = (hi[a] - o[a]) * inv[a];
    const float near = fminf(t0, t1), far = fmaxf(t0, t1);
    tmin = fmaxf(tmin, near - fabsf(near) * SLAB_SLACK);
    tmax = fminf(tmax, far + fabsf(far) * SLAB_SLACK);
  }
  return tmax >= fmaxf(tmin, 0.0f) && tmin <= cap;
}

__global__ void __launch_bounds__(THREADS)
    tri_kernel(const Rays q, const float* __restrict__ tri_g, int n_tri,
               const Record out) {
  extern __shared__ float tri[];            // 9 a row, then 6 a cluster
  __shared__ float s_box[WARPS][6];
  const int n_cl = (n_tri + CLUSTER - 1) / CLUSTER;
  float* cbox = tri + 9 * n_tri;
  for (int i = threadIdx.x; i < n_tri * 9; i += THREADS) tri[i] = tri_g[i];
  __syncthreads();

  // each cluster's box of the rows the sweep tests (e1 != 0), padded, and
  // the soup's box over them: min / max are exact, so the reduction's
  // order does not matter
  float box[6] = {BIG, BIG, BIG, -BIG, -BIG, -BIG};
  for (int c = threadIdx.x; c < n_cl; c += THREADS) {
    float cb[6] = {BIG, BIG, BIG, -BIG, -BIG, -BIG};
    const int end = min(n_tri, (c + 1) * CLUSTER);
    for (int i = c * CLUSTER; i < end; ++i) {
      const float* p = tri + 9 * i;
      if (p[3] == 0.0f && p[4] == 0.0f && p[5] == 0.0f) continue;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float v0 = p[a], v1 = p[a] + p[3 + a], v2 = p[a] + p[6 + a];
        cb[a] = fminf(cb[a], fminf(fminf(v0, v1), v2));
        cb[3 + a] = fmaxf(cb[3 + a], fmaxf(fmaxf(v0, v1), v2));
      }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      box[a] = fminf(box[a], cb[a]);
      box[3 + a] = fmaxf(box[3 + a], cb[3 + a]);
      cbox[6 * c + a] = pad_down(cb[a]);
      cbox[6 * c + 3 + a] = pad_up(cb[3 + a]);
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      box[a] = fminf(box[a], __shfl_xor_sync(0xFFFFFFFFu, box[a], s));
      box[3 + a] =
          fmaxf(box[3 + a], __shfl_xor_sync(0xFFFFFFFFu, box[3 + a], s));
    }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int a = 0; a < 6; ++a) s_box[warp][a] = box[a];
  __syncthreads();
  float lo[3], hi[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float l = s_box[0][a], h = s_box[0][3 + a];
    for (int w = 1; w < WARPS; ++w) {
      l = fminf(l, s_box[w][a]);
      h = fmaxf(h, s_box[w][3 + a]);
    }
    lo[a] = pad_down(l);
    hi[a] = pad_up(h);
  }
  const bool any_row = lo[0] <= hi[0];     // else every row is padding

  for (int r = blockIdx.x * THREADS + threadIdx.x; r < q.n;
       r += gridDim.x * THREADS) {
    const float o[3] = {q.ox[r], q.oy[r], q.oz[r]};
    const float d[3] = {q.dx[r], q.dy[r], q.dz[r]};
    const float cap = q.tcap != nullptr ? q.tcap[r] : BIG;
    float best_t = BIG, best_u = 0.0f, best_v = 0.0f;
    int best_i = -1;
    const float inv[3] = {slab_inv(d[0]), slab_inv(d[1]), slab_inv(d[2])};
    // the branch is uniform across a warp none of whose rays reach the box
    if (any_row && reaches(lo, hi, o, inv, cap)) {
      const float ox = o[0], oy = o[1], oz = o[2];
      const float dx = d[0], dy = d[1], dz = d[2];
      for (int c = 0; c < n_cl; ++c) {
        const float* cb = cbox + 6 * c;
        // an empty cluster's box is inverted
        if (!(cb[0] <= cb[3]) || !reaches(cb, cb + 3, o, inv, cap)) continue;
        const int end = min(n_tri, (c + 1) * CLUSTER);
        for (int i = c * CLUSTER; i < end; ++i) {
          const float* p = tri + 9 * i;
          const float e1x = p[3], e1y = p[4], e1z = p[5];
          if (e1x == 0.0f && e1y == 0.0f && e1z == 0.0f) continue;  // pad
          const float e2x = p[6], e2y = p[7], e2z = p[8];
          const float px = dy * e2z - dz * e2y;
          const float py = dz * e2x - dx * e2z;
          const float pz = dx * e2y - dy * e2x;
          const float det = e1x * px + e1y * py + e1z * pz;
          if (!(fabsf(det) > EPS)) continue;     // the plain test fails
          const float inv_det = 1.0f / det;
          const float tx = ox - p[0], ty = oy - p[1], tz = oz - p[2];
          const float u = (tx * px + ty * py + tz * pz) * inv_det;
          const float qx = ty * e1z - tz * e1y;
          const float qy = tz * e1x - tx * e1z;
          const float qz = tx * e1y - ty * e1x;
          const float v = (dx * qx + dy * qy + dz * qz) * inv_det;
          const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
          if (u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 1e-4f &&
              t < cap && t < best_t) {
            best_t = t;
            best_i = i;
            best_u = u;
            best_v = v;
          }
        }
      }
    }
    const bool found = best_t < BIG;
    out.hit[r] = found ? 1 : 0;
    out.t[r] = found ? best_t : BIG;
    out.tri[r] = found ? best_i : -1;
    out.u[r] = best_u;
    out.v[r] = best_v;
  }
}

}  // namespace

// tcap: null for no cap; hit: one byte a ray (a torch.bool tensor).
// Returns a cudaError_t code.
RTVB_EXPORT int rtvb_tri_box(const float* ox, const float* oy,
                             const float* oz, const float* dx,
                             const float* dy, const float* dz,
                             const float* tcap, const float* tri, int n,
                             int n_tri, uint8_t* hit, float* t, int* idx,
                             float* u, float* v, void* stream) {
  if (n == 0) return 0;
  const size_t smem = sizeof(float) * (9 * static_cast<size_t>(n_tri) +
                                       6 * ((n_tri + CLUSTER - 1) / CLUSTER));
  static rtvb::GridCache cache;
  int grid = 0;
  const cudaError_t e = rtvb::persistent_grid(
      cache, tri_kernel, THREADS, smem, rtvb::blocks_for(n, THREADS), &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  tri_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      Rays{ox, oy, oz, dx, dy, dz, tcap, n}, tri, n_tri,
      Record{hit, t, idx, u, v});
  return rtvb::launch_status();
}
