// K1 — voxel-world ray traversal: column DDA over (x, z) with the y range
// of each column segment resolved against the column's 32-bit occupancy
// mask, empty space skipped with the supercolumn height envelope and the
// Chebyshev distance field.  Closest hit (t, voxel, face normal, material
// index) or any hit (occlusion bit + entry t of the hitting column).
//
// Replaces: rtvb_tpu/ops/trace_kernel.py `_trace_tiles` / `_make_kernel`
// (the Pallas TPU kernel around rtvb_tpu/ops/dda.py `trace`), including its
// block-id / exception-search / material-index epilogue.  Plain version:
// rtvb_tpu_torch/ops/dda.py `trace_plain`.
//
// What bounds it on Hopper: divergent per-ray loops (up to 96 column
// sub-steps) with a table lookup per step — latency and branch divergence,
// not bandwidth (a ray reads 28 bytes and writes ≤ 36).  Design: one thread
// per ray, so a ray leaves the loop as soon as it is done instead of
// waiting on its tile (the TPU kernel's granularity); the per-step tables
// (column masks, schema words, the 128-slot envelope and distance field;
// 33 KB for the 64×32×64 world) sit in shared memory, loaded once per
// block; the exception list and the material map are read from global
// memory once per ray.  No `_pack_heights` byte table: the shared-memory
// mask fetch is already one load.
#include "common.cuh"

namespace {

using rtvb::BIG;
constexpr float EPS = 1e-6f;

struct World {
  int X, Y, Z, ss, sl, super_z, max_steps, maxh_max, n_exc, n_b2m;
};

__device__ __forceinline__ float safe_inv(float v) {
  float s = fabsf(v) < EPS ? (v >= 0.0f ? EPS : -EPS) : v;
  return 1.0f / s;
}

__device__ __forceinline__ void slab(float lo_t, float hi_t, float d, float o,
                                     float size, float& tin, float& tout) {
  tin = fminf(lo_t, hi_t);
  tout = fmaxf(lo_t, hi_t);
  if (fabsf(d) < EPS) {
    bool inside = (o >= 0.0f) && (o < size);
    tin = inside ? -BIG : BIG;
    tout = inside ? BIG : -BIG;
  }
}

// bits [ylo, yhi] of a u32 (0 when yhi < ylo); arguments already clamped
// to the world's y range by the caller, as in the plain version
__device__ __forceinline__ uint32_t range_mask(int ylo, int yhi) {
  if (yhi < ylo) return 0u;
  int lo = rtvb::clampi(ylo, 0, 31);
  int hi = rtvb::clampi(yhi, 0, 31);
  uint32_t hi_mask = hi >= 31 ? 0xFFFFFFFFu : ((1u << (hi + 1)) - 1u);
  uint32_t lo_mask = (1u << lo) - 1u;
  return hi_mask & ~lo_mask;
}

__device__ int material_index(const World& w, const int* __restrict__ schema,
                              const int* __restrict__ exc_mask,
                              const int* __restrict__ exc_key,
                              const int* __restrict__ exc_id,
                              const int* __restrict__ b2m, int ix, int iy,
                              int iz) {
  int c = rtvb::clampi(ix * w.Z + iz, 0, w.X * w.Z - 1);
  int sch = schema[c];
  uint32_t emask = static_cast<uint32_t>(__ldg(exc_mask + c));
  int h1 = sch & 31;
  int h2 = (sch >> 5) & 31;
  int bid = iy < h1 ? (sch >> 10) & 63
                    : (iy < h2 ? (sch >> 16) & 63 : (sch >> 22) & 63);
  bool has_exc = ((emask >> rtvb::clampi(iy, 0, 31)) & 1u) == 1u;
  int key = c * w.Y + iy;
  int lo = 0, hi = w.n_exc;                 // lower bound of key
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (__ldg(exc_key + mid) < key) lo = mid + 1; else hi = mid;
  }
  lo = rtvb::clampi(lo, 0, w.n_exc - 1);
  if (has_exc && __ldg(exc_key + lo) == key) bid = __ldg(exc_id + lo);
  return __ldg(b2m + rtvb::clampi(bid, 0, w.n_b2m - 1));
}

template <bool ANY_HIT>
__global__ void trace_kernel(
    const float* __restrict__ oxp, const float* __restrict__ oyp,
    const float* __restrict__ ozp, const float* __restrict__ dxp,
    const float* __restrict__ dyp, const float* __restrict__ dzp,
    const float* __restrict__ tcap, int n, const int* __restrict__ colmask_g,
    const int* __restrict__ df_g, const int* __restrict__ maxh_g,
    const int* __restrict__ schema_g, const int* __restrict__ exc_mask,
    const int* __restrict__ exc_key, const int* __restrict__ exc_id,
    const int* __restrict__ b2m, World w, int* __restrict__ hit_o,
    float* __restrict__ t_o, int* __restrict__ ix_o, int* __restrict__ iy_o,
    int* __restrict__ iz_o, float* __restrict__ nx_o,
    float* __restrict__ ny_o, float* __restrict__ nz_o,
    int* __restrict__ mi_o) {
  extern __shared__ int smem[];
  const int n_cols = w.X * w.Z;
  uint32_t* colmask = reinterpret_cast<uint32_t*>(smem);
  int* schema = smem + n_cols;
  int* df = schema + (ANY_HIT ? 0 : n_cols);
  int* maxh = df + 128;
  for (int i = threadIdx.x; i < n_cols; i += blockDim.x) {
    colmask[i] = static_cast<uint32_t>(colmask_g[i]);
    if (!ANY_HIT) schema[i] = schema_g[i];
  }
  for (int i = threadIdx.x; i < 128; i += blockDim.x) {
    df[i] = df_g[i];
    maxh[i] = maxh_g[i];
  }
  __syncthreads();

  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const float ox = oxp[r], oy = oyp[r], oz = ozp[r];
  const float dx = dxp[r], dy = dyp[r], dz = dzp[r];
  const int X = w.X, Y = w.Y, Z = w.Z;

  const float inv_dx = safe_inv(dx), inv_dy = safe_inv(dy),
              inv_dz = safe_inv(dz);
  float txi, txo, tzi, tzo, tyi, tyo;
  slab((0.0f - ox) * inv_dx, (static_cast<float>(X) - ox) * inv_dx, dx, ox,
       static_cast<float>(X), txi, txo);
  slab((0.0f - oz) * inv_dz, (static_cast<float>(Z) - oz) * inv_dz, dz, oz,
       static_cast<float>(Z), tzi, tzo);
  slab((0.0f - oy) * inv_dy, (static_cast<float>(Y) - oy) * inv_dy, dy, oy,
       static_cast<float>(Y), tyi, tyo);
  const float t_enter = fmaxf(fmaxf(txi, tzi), fmaxf(tyi, 0.0f));
  float t_exit = fminf(fminf(txo, tzo), tyo);
  t_exit = fminf(t_exit, tcap[r]);
  // global ascending-ray exit cap at the world's height envelope
  const float t_gm = (static_cast<float>(w.maxh_max) - oy) * inv_dy;
  if (dy > EPS) t_exit = fminf(t_exit, t_gm);
  bool alive = !(t_enter >= t_exit);

  float t = t_enter + EPS;
  int ix = rtvb::clampi(rtvb::floor_i32(ox + dx * t), 0, X - 1);
  int iz = rtvb::clampi(rtvb::floor_i32(oz + dz * t), 0, Z - 1);
  const int step_x = dx >= 0.0f ? 1 : -1;
  const int step_z = dz >= 0.0f ? 1 : -1;
  const int pos_x = step_x > 0 ? 1 : 0;
  const int pos_z = step_z > 0 ? 1 : 0;
  const float tdelta_x = fabsf(inv_dx), tdelta_z = fabsf(inv_dz);
  float tmax_x = (static_cast<float>(ix + pos_x) - ox) * inv_dx;
  float tmax_z = (static_cast<float>(iz + pos_z) - oz) * inv_dz;
  const float max_d = fmaxf(fabsf(dx), fabsf(dz));
  int last_axis = (tyi >= txi && tyi >= tzi) ? 1 : (txi >= tzi ? 0 : 2);

  bool hit = false;
  float hit_t = BIG;
  int hit_ix = 0, hit_iy = 0, hit_iz = 0, hit_axis = 0;

  // two sub-steps per iteration of the reference's while loop: an odd cap
  // runs max_steps + 1 sub-steps there, and here
  const int n_sub = 2 * ((w.max_steps + 1) / 2);
  for (int s = 0; s < n_sub && alive; ++s) {
    const float t0 = t;
    const float t1 = fminf(fminf(tmax_x, tmax_z), t_exit);
    const bool inb = ix >= 0 && ix < X && iz >= 0 && iz < Z;
    const int c = rtvb::clampi(ix * Z + iz, 0, n_cols - 1);
    const uint32_t word = inb ? colmask[c] : 0u;
    const float ya = oy + dy * t0;
    const float yb = oy + dy * t1;
    const int ylo = rtvb::floor_i32(fminf(ya, yb));
    int yhi = rtvb::floor_i32(fmaxf(ya, yb) - EPS);
    yhi = max(yhi, ylo);
    const uint32_t hitbits =
        word & range_mask(max(ylo, 0), min(yhi, Y - 1));
    const bool got = hitbits != 0u;
    if (!ANY_HIT && got) {
      const int yv = dy >= 0.0f ? __ffs(static_cast<int>(hitbits)) - 1
                                : 31 - __clz(static_cast<int>(hitbits));
      const float ty_enter =
          (static_cast<float>(dy >= 0.0f ? yv : yv + 1) - oy) * inv_dy;
      hit_t = fmaxf(t0, ty_enter);
      hit_axis = ty_enter > t0 ? 1 : last_axis;
      hit_ix = ix;
      hit_iy = yv;
      hit_iz = iz;
    }
    hit = hit || got;

    const bool take_x = tmax_x < tmax_z;
    float t_next = take_x ? tmax_x : tmax_z;
    int nix = take_x ? ix + step_x : ix;
    int niz = take_x ? iz : iz + step_z;
    float ntmx = take_x ? tmax_x + tdelta_x : tmax_x;
    float ntmz = take_x ? tmax_z : tmax_z + tdelta_z;

    // supercolumn empty-space skipping
    const int scx = nix >> w.sl;
    const int scz = niz >> w.sl;
    const int sidx = rtvb::clampi(scx * w.super_z + scz, 0, 127);
    float jt = t_next;
    const float mh = static_cast<float>(maxh[sidx]);
    const float y_next = oy + dy * t_next;
    if (y_next >= mh + EPS) {
      const float t_cx =
          (static_cast<float>((scx + pos_x) * w.ss) - ox) * inv_dx;
      const float t_cz =
          (static_cast<float>((scz + pos_z) * w.ss) - oz) * inv_dz;
      const float t_env = dy < -EPS ? (mh - oy) * inv_dy : BIG;
      jt = fmaxf(jt, fminf(fminf(t_cx, t_cz), t_env));
    }
    const int dfv = df[sidx];
    if (word == 0u && dfv >= 2 && max_d > EPS) {
      const float t_df = t_next + static_cast<float>((dfv - 1) * w.ss) /
                                      fmaxf(max_d, EPS);
      jt = fmaxf(jt, t_df);
    }
    const bool can_jump = jt > t_next + EPS;
    jt = fminf(jt + EPS, t_exit);
    if (can_jump) {
      nix = rtvb::clampi(rtvb::floor_i32(ox + dx * jt), 0, X - 1);
      niz = rtvb::clampi(rtvb::floor_i32(oz + dz * jt), 0, Z - 1);
      ntmx = (static_cast<float>(nix + pos_x) - ox) * inv_dx;
      ntmz = (static_cast<float>(niz + pos_z) - oz) * inv_dz;
      t_next = jt;
    }
    const bool oob = nix < 0 || nix >= X || niz < 0 || niz >= Z;
    const bool done = got || t_next >= t_exit || oob;
    if (!done) {
      t = t_next;
      ix = nix;
      iz = niz;
      tmax_x = ntmx;
      tmax_z = ntmz;
      if (!ANY_HIT) last_axis = take_x ? 0 : 2;
    }
    alive = !done;
  }

  hit_o[r] = hit ? 1 : 0;
  if (ANY_HIT) {
    t_o[r] = hit ? t : BIG;
    return;
  }
  t_o[r] = hit ? hit_t : BIG;
  ix_o[r] = hit_ix;
  iy_o[r] = hit_iy;
  iz_o[r] = hit_iz;
  const float sx = dx > 0.0f ? 1.0f : (dx < 0.0f ? -1.0f : 0.0f);
  const float sy = dy > 0.0f ? 1.0f : (dy < 0.0f ? -1.0f : 0.0f);
  const float sz = dz > 0.0f ? 1.0f : (dz < 0.0f ? -1.0f : 0.0f);
  nx_o[r] = hit_axis == 0 ? -sx : 0.0f;
  ny_o[r] = hit_axis == 1 ? -sy : 0.0f;
  nz_o[r] = hit_axis == 2 ? -sz : 0.0f;
  mi_o[r] = material_index(w, schema, exc_mask, exc_key, exc_id, b2m,
                           hit_ix, hit_iy, hit_iz);
}

}  // namespace

RTVB_EXPORT int rtvb_trace(
    const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, const float* tcap, int n,
    const int* colmask, const int* df, const int* maxh, const int* schema,
    const int* exc_mask, const int* exc_key, const int* exc_id,
    const int* b2m, int n_exc, int n_b2m, int X, int Y, int Z,
    int super_size, int super_z, int max_steps, int maxh_max, int any_hit,
    int* hit, float* t, int* ix, int* iy, int* iz, float* nx, float* ny,
    float* nz, int* mi, void* stream) {
  int sl = 0;
  while ((1 << sl) < super_size) ++sl;
  World w{X, Y, Z, super_size, sl, super_z, max_steps, maxh_max, n_exc,
          n_b2m};
  const int threads = 256;
  const int n_cols = X * Z;
  const size_t smem =
      sizeof(int) * (static_cast<size_t>(n_cols) * (any_hit ? 1 : 2) + 256);
  auto kern = any_hit ? trace_kernel<true> : trace_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (n == 0) return 0;
  kern<<<rtvb::blocks_for(n, threads), threads, smem,
         static_cast<cudaStream_t>(stream)>>>(
      ox, oy, oz, dx, dy, dz, tcap, n, colmask, df, maxh, schema, exc_mask,
      exc_key, exc_id, b2m, w, hit, t, ix, iy, iz, nx, ny, nz, mi);
  return rtvb::launch_status();
}
