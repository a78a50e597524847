// K2 — closest-hit Möller–Trumbore intersection of every ray with a small
// packed triangle soup (T, 9) = [v0 | e1 | e2] (decorations and entities).
// Ties keep the lowest triangle index; zero padding rows never hit.
//
// Replaces: rtvb_tpu/ops/tri_kernel.py `_tri_tiles` / `_make_kernel`
// (entry `intersect_packed_tpu`).  Plain version:
// rtvb_tpu_torch/ops/triangles.py `intersect_packed_plain`.
//
// What bounds it on Hopper: arithmetic, ~40 flops per ray-triangle test,
// 16 triangles for the canonical flowers (≤ 2048 supported); the rays
// themselves are 32 bytes in, 20 out.  Design: one thread per ray, the
// whole soup staged once per block in shared memory (a broadcast read per
// triangle for the whole warp — the role SMEM plays in the TPU kernel).
// The TPU kernel's per-tile AABB cull is left out: it changes no result,
// and with 16 triangles the test is cheaper than the cull's divergence.
#include "common.cuh"

namespace {

using rtvb::BIG;
constexpr float EPS = 1e-7f;

__global__ void tri_kernel(const float* __restrict__ oxp,
                           const float* __restrict__ oyp,
                           const float* __restrict__ ozp,
                           const float* __restrict__ dxp,
                           const float* __restrict__ dyp,
                           const float* __restrict__ dzp,
                           const float* __restrict__ tcap,
                           const float* __restrict__ tri_g, int n, int n_tri,
                           int* __restrict__ hit_o, float* __restrict__ t_o,
                           int* __restrict__ tri_o, float* __restrict__ u_o,
                           float* __restrict__ v_o) {
  extern __shared__ float tri[];
  for (int i = threadIdx.x; i < n_tri * 9; i += blockDim.x) tri[i] = tri_g[i];
  __syncthreads();
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const float ox = oxp[r], oy = oyp[r], oz = ozp[r];
  const float dx = dxp[r], dy = dyp[r], dz = dzp[r];
  const float cap = tcap[r];
  float best_t = BIG, best_u = 0.0f, best_v = 0.0f;
  int best_i = -1;
  for (int i = 0; i < n_tri; ++i) {
    const float* q = tri + 9 * i;
    const float v0x = q[0], v0y = q[1], v0z = q[2];
    const float e1x = q[3], e1y = q[4], e1z = q[5];
    const float e2x = q[6], e2y = q[7], e2z = q[8];
    if (e1x == 0.0f && e1y == 0.0f && e1z == 0.0f) continue;  // padding
    const float px = dy * e2z - dz * e2y;
    const float py = dz * e2x - dx * e2z;
    const float pz = dx * e2y - dy * e2x;
    const float det = e1x * px + e1y * py + e1z * pz;
    const bool ok_det = fabsf(det) > EPS;
    const float inv_det = ok_det ? 1.0f / det : 0.0f;
    const float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
    const float u = (tx * px + ty * py + tz * pz) * inv_det;
    const float qx = ty * e1z - tz * e1y;
    const float qy = tz * e1x - tx * e1z;
    const float qz = tx * e1y - ty * e1x;
    const float v = (dx * qx + dy * qy + dz * qz) * inv_det;
    const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
    if (ok_det && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 1e-4f &&
        t < cap && t < best_t) {
      best_t = t;
      best_i = i;
      best_u = u;
      best_v = v;
    }
  }
  const bool found = best_t < BIG;
  hit_o[r] = found ? 1 : 0;
  t_o[r] = found ? best_t : BIG;
  tri_o[r] = found ? best_i : -1;
  u_o[r] = best_u;
  v_o[r] = best_v;
}

}  // namespace

RTVB_EXPORT int rtvb_tri(const float* ox, const float* oy, const float* oz,
                         const float* dx, const float* dy, const float* dz,
                         const float* tcap, const float* tri, int n,
                         int n_tri, int* hit, float* t, int* idx, float* u,
                         float* v, void* stream) {
  const int threads = 256;
  const size_t smem = sizeof(float) * 9 * static_cast<size_t>(n_tri);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        tri_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (n == 0) return 0;
  tri_kernel<<<rtvb::blocks_for(n, threads), threads, smem,
               static_cast<cudaStream_t>(stream)>>>(
      ox, oy, oz, dx, dy, dz, tcap, tri, n, n_tri, hit, t, idx, u, v);
  return rtvb::launch_status();
}
