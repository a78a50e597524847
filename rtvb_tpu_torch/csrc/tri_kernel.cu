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
//   padding of its triangle, as long as Möller–Trumbore's determinant is
//   not mostly rounding.  A ray nearly in the plane of a tilted triangle
//   breaks that: there the computed u, v and t are noise, and the "hit"
//   can lie anywhere on the ray, far outside the padded box;
// - so the cull is exact (it drops no hit the plain version reports): a
//   ray skips a box only if it misses the box padded further by E, a bound
//   on how far from its triangle any hit of a row in the box can be
//   computed.  From the rounding of each cross product, dot product and
//   quotient (ε = 2^-24, ℓ1 norms |·|₁): a computed hit o + t·d lies within
//   27ε·|o − v0|₁·|d|₁·|e1|₁·|e2|₁ / |det| of the triangle.  Each row's
//   normal n = e1 × e2 is scaled in the block's prologue by
//   1/K, K = 54ε·|e1|₁·|e2|₁ (twice the bound), so that q = |d·n/K| −
//   (5/16)|d|₁ ≤ |det|/K for the determinant Möller–Trumbore computes, and
//   E = Tn·|d|₁ / min q over the box's rows, with Tn ≥ |o − v0|₁ from the
//   box's centre and half extent (the soup's E bounds each cluster's, so
//   a cluster computes its own only where the soup's is unbounded); a
//   row whose |det| is certainly ≤ EPS (it cannot hit)
//   sets no bound, and where some q ≤ 0 the ray cannot skip the box.  Rows
//   whose e1 and e2 both have an exactly zero component a (axis-aligned
//   quads: flowers, torches, lanterns) have a determinant that is d_a
//   times their normal's a component to within 5ε, and exactly 0 where
//   d_a = 0; their bound is |d_a|·min |n_a|/K over the box's such rows,
//   one product a ray and axis.  Every box is padded by a further 1/64
//   (E_FREE), and a ray pads it by E only where E is larger: nearly never
//   (for camera rays E is about a millimetre), so a ray adds a few
//   products and compares, and the boxes cull nearly as before;
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
// more padding: a ray whose bound E (below) is at most this skips the
// bound's padding arithmetic
constexpr float E_FREE = 0.015625f;
constexpr float SLAB_SLACK = 9.5367431640625e-7f;   // 2^-20
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CLUSTER = 4;                 // rows under one cluster box
// 54ε (twice the hit's rounding bound, 27ε), rounded up a little
constexpr float K_SCALE = 54.0f * 5.9604644775390625e-8f * 1.0009765625f;
// |d·n/K| is within (11/54)|d|₁ of the exact d·n/K, and the determinant
// Möller–Trumbore computes within (5/54)|d|₁·K of the exact one
constexpr float Q_OFF = 0.3125f;
// an axis row's determinant is d_a times its exact n_a to within 3ε of
// n_a's two products, and the computed n_a is within 2ε of them
constexpr float AXIS_REL = 6.0f * 5.9604644775390625e-8f * 1.0009765625f;
constexpr int ROWQ = 4;                    // a row's n/K and EPS bound
constexpr int ROWA = 2;                    // a row's axis and |n_a|/K
constexpr int CREC = 10;                   // a cluster's box, axis q, rows

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

// the TPU kernel's slab reciprocal: |c| < 1e-12 → ±1e-12 (+ for ±0); an
// approximate reciprocal (within 2 ulps; |c| ≤ 1e30 keeps the result
// normal): the slabs' 2^-20 slack covers it
__device__ __forceinline__ float slab_inv(float c) {
  const float x =
      fabsf(c) < 1e-12f ? (c >= 0.0f ? 1e-12f : -1e-12f)
                        : fminf(fmaxf(c, -1e30f), 1e30f);
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// a box bound moved out by the TPU kernel's padding and E_FREE, and by
// 2^-20 of the coordinate for the rounding of v0 + e at far-out soups
__device__ __forceinline__ float pad_down(float x) {
  return x - (BOX_PAD + E_FREE) - fabsf(x) * SLAB_SLACK;
}
__device__ __forceinline__ float pad_up(float x) {
  return x + (BOX_PAD + E_FREE) + fabsf(x) * SLAB_SLACK;
}

// can the ray reach the box [lo − e, hi + e] at some t in [0, cap]?  inv:
// the slab reciprocals of its direction.  Each slab's near bound moves
// down and its far bound up by 2^-20 of its size: more than the roundings
// of (lo - e - o) * (1 / d).  E: e is not 0
template <bool E>
__device__ __forceinline__ bool reaches(const float lo[3], const float hi[3],
                                        float e, const float o[3],
                                        const float inv[3], float cap) {
  float tmin = -BIG, tmax = BIG;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t0 = ((E ? lo[a] - e : lo[a]) - o[a]) * inv[a];
    const float t1 = ((E ? hi[a] + e : hi[a]) - o[a]) * inv[a];
    const float near = fminf(t0, t1), far = fmaxf(t0, t1);
    tmin = fmaxf(tmin, near - fabsf(near) * SLAB_SLACK);
    tmax = fminf(tmax, far + fabsf(far) * SLAB_SLACK);
  }
  return tmax >= fmaxf(tmin, 0.0f) && tmin <= cap;
}

// A row's bound terms.  axis: the component a in which e1 and e2 are both
// exactly 0 (-1 if none), with mag ≤ |det|/(K·|d_a|); else q_row (n/K and
// the EPS bound) for rows_q
struct RowBound {
  int axis;
  float mag;
  float q[ROWQ];
};

__device__ __forceinline__ RowBound row_bound(const float* p) {
  RowBound b;
  const float e1x = p[3], e1y = p[4], e1z = p[5];
  const float e2x = p[6], e2y = p[7], e2z = p[8];
  const float s1 = fabsf(e1x) + fabsf(e1y) + fabsf(e1z);
  const float s2 = fabsf(e2x) + fabsf(e2y) + fabsf(e2z);
  const float K = fmaxf(K_SCALE * s1 * s2, 1e-30f);
  // 1/K from below: the approximate reciprocal (within 2^-22) scaled down,
  // so every term scaled by it errs toward a smaller bound q, a larger E
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(K));
  r *= 0.99999904632568359375f;            // 1 - 2^-20
  const float nx = e1y * e2z - e1z * e2y;
  const float ny = e1z * e2x - e1x * e2z;
  const float nz = e1x * e2y - e1y * e2x;
  b.axis = -1;
  b.mag = 0.0f;
  const bool live = !(e1x == 0.0f && e1y == 0.0f && e1z == 0.0f);
  // the two products of n_a, whose rounding bounds the determinant's
  float na = 0.0f, terms = 0.0f;
  if (e1x == 0.0f && e2x == 0.0f) {
    b.axis = 0; na = nx; terms = fabsf(e1y * e2z) + fabsf(e1z * e2y);
  } else if (e1y == 0.0f && e2y == 0.0f) {
    b.axis = 1; na = ny; terms = fabsf(e1z * e2x) + fabsf(e1x * e2z);
  } else if (e1z == 0.0f && e2z == 0.0f) {
    b.axis = 2; na = nz; terms = fabsf(e1x * e2y) + fabsf(e1y * e2x);
  }
  if (!live) b.axis = -2;                  // padding: never hits, no bound
  if (b.axis >= 0)
    b.mag = fmaxf((fabsf(na) - AXIS_REL * terms) * r * 0.9990234375f, 0.0f);
  // a general row: n/K, and the |d·n/K| below which |det| ≤ EPS for sure
  const bool general = b.axis == -1;
  b.q[0] = general ? nx * r : 0.0f;
  b.q[1] = general ? ny * r : 0.0f;
  b.q[2] = general ? nz * r : 0.0f;
  b.q[3] = general ? EPS * r * 0.9990234375f : BIG;
  return b;
}

// a general row's lower bound on |det|/K for direction d (|d|₁ = d1):
// BIG where its |det| is certainly ≤ EPS
__device__ __forceinline__ float general_q(const float* q, const float d[3],
                                           float d1) {
  const float h = fabsf(d[0] * q[0] + d[1] * q[1] + d[2] * q[2]);
  return h + Q_OFF * d1 <= q[3] ? BIG : h - Q_OFF * d1;
}

// the axis rows' lower bound: |d_a|·min |n_a|/K (BIG where d_a = 0: their
// determinant is then exactly 0)
__device__ __forceinline__ float axis_q(const float amin[3],
                                        const float ad[3]) {
  float q = BIG;
#pragma unroll
  for (int a = 0; a < 3; ++a)
    if (ad[a] != 0.0f) q = fminf(q, ad[a] * amin[a]);
  return q;
}

// the extra padding of a box [lo, hi] (beyond E_FREE) for the ray (o, d)
// whose rows' bound is q: 0 where E = Tn·|d|₁/q ≤ E_FREE (nearly every
// ray), BIG where the ray cannot skip the box (q ≤ 0), else E.  Tn ≥
// |o − v0|₁ for any v0 in the box: |o − c|₁ + |h|₁ (the box's centre
// and half extent)
__device__ __forceinline__ float extra_pad(float q, const float c[3],
                                           float h1, const float o[3],
                                           float d1) {
  const float tn_d1 =
      (fabsf(o[0] - c[0]) + fabsf(o[1] - c[1]) + fabsf(o[2] - c[2]) + h1) *
      d1 * 1.0009765625f;
  if (q * E_FREE >= tn_d1) return 0.0f;
  if (!(q > 0.0f)) return BIG;
  return __fdividef(tn_d1, q) * 1.0009765625f;
}

__global__ void __launch_bounds__(THREADS)
    tri_kernel(const Rays q, const float* __restrict__ tri_g, int n_tri,
               const Record out) {
  // 9 a row, ROWQ a row, ROWA a row, CREC a cluster, then the general
  // rows' indices
  extern __shared__ float tri[];
  __shared__ float s_box[WARPS][9];
  __shared__ float s_soup[13];     // lo, hi, amin, ctr, h1 of the soup
  __shared__ int s_n_gen;
  const int n_cl = (n_tri + CLUSTER - 1) / CLUSTER;
  float* rowq = tri + 9 * n_tri;
  float* rowa = rowq + ROWQ * n_tri;
  float* crec = rowa + ROWA * n_tri;
  int* gen = reinterpret_cast<int*>(crec + CREC * n_cl);
  for (int i = threadIdx.x; i < n_tri * 9; i += THREADS) tri[i] = tri_g[i];
  if (threadIdx.x == 0) s_n_gen = 0;
  __syncthreads();

  // each row's bound terms, a thread a row
  for (int i = threadIdx.x; i < n_tri; i += THREADS) {
    const RowBound b = row_bound(tri + 9 * i);
#pragma unroll
    for (int k = 0; k < ROWQ; ++k) rowq[ROWQ * i + k] = b.q[k];
    rowa[ROWA * i] = static_cast<float>(b.axis);
    rowa[ROWA * i + 1] = b.mag;
    if (b.axis == -1) gen[atomicAdd(&s_n_gen, 1)] = i;
  }
  __syncthreads();

  // each cluster's box of the rows the sweep tests (e1 != 0), padded, and
  // its rows' bound terms; the soup's box and axis terms over them: min /
  // max are exact, so the reductions' order does not matter
  float box[9] = {BIG, BIG, BIG, -BIG, -BIG, -BIG, BIG, BIG, BIG};
  for (int c = threadIdx.x; c < n_cl; c += THREADS) {
    float cb[9] = {BIG, BIG, BIG, -BIG, -BIG, -BIG, BIG, BIG, BIG};
    int n_gen = 0;
    const int end = min(n_tri, (c + 1) * CLUSTER);
    for (int i = c * CLUSTER; i < end; ++i) {
      const float* p = tri + 9 * i;
      const float axis = rowa[ROWA * i], mag = rowa[ROWA * i + 1];
      if (axis == -2.0f) continue;          // padding
      if (axis >= 0.0f) {
#pragma unroll
        for (int a = 0; a < 3; ++a)
          if (axis == static_cast<float>(a)) cb[6 + a] = fminf(cb[6 + a], mag);
      } else {
        ++n_gen;
      }
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
      box[6 + a] = fminf(box[6 + a], cb[6 + a]);
      crec[CREC * c + a] = pad_down(cb[a]);
      crec[CREC * c + 3 + a] = pad_up(cb[3 + a]);
      crec[CREC * c + 6 + a] = cb[6 + a];
    }
    crec[CREC * c + 9] = static_cast<float>(n_gen);
  }
#pragma unroll
  for (int a = 0; a < 9; ++a)
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      const float other = __shfl_xor_sync(0xFFFFFFFFu, box[a], s);
      box[a] = (a >= 3 && a < 6) ? fmaxf(box[a], other) : fminf(box[a], other);
    }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int a = 0; a < 9; ++a) s_box[warp][a] = box[a];
  __syncthreads();
  // the soup's padded box, axis terms, centre and half extent, reduced by
  // one thread into shared memory (every ray reads them: in registers they
  // cost the ray loop occupancy)
  float* lo = s_soup;
  float* hi = s_soup + 3;
  float* amin = s_soup + 6;
  float* ctr = s_soup + 9;
  if (threadIdx.x == 0) {
    float h1 = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float l = s_box[0][a], h = s_box[0][3 + a], m = s_box[0][6 + a];
      for (int w = 1; w < WARPS; ++w) {
        l = fminf(l, s_box[w][a]);
        h = fmaxf(h, s_box[w][3 + a]);
        m = fminf(m, s_box[w][6 + a]);
      }
      lo[a] = pad_down(l);
      hi[a] = pad_up(h);
      amin[a] = m;
      // the centre and half extent rounded outward (and by 2^-20 of the
      // coordinates for the centre's rounding)
      ctr[a] = 0.5f * (lo[a] + hi[a]);
      h1 += fmaxf(hi[a] - ctr[a], ctr[a] - lo[a]) * 1.0009765625f +
            (fabsf(lo[a]) + fabsf(hi[a])) * SLAB_SLACK;
    }
    s_soup[12] = h1;
  }
  __syncthreads();
  const float h1 = s_soup[12];
  const bool any_row = lo[0] <= hi[0];     // else every row is padding
  const int n_gen = s_n_gen;

  for (int r = blockIdx.x * THREADS + threadIdx.x; r < q.n;
       r += gridDim.x * THREADS) {
    const float o[3] = {q.ox[r], q.oy[r], q.oz[r]};
    const float d[3] = {q.dx[r], q.dy[r], q.dz[r]};
    const float cap = q.tcap != nullptr ? q.tcap[r] : BIG;
    float best_t = BIG, best_u = 0.0f, best_v = 0.0f;
    int best_i = -1;
    const float inv[3] = {slab_inv(d[0]), slab_inv(d[1]), slab_inv(d[2])};
    const float ad[3] = {fabsf(d[0]), fabsf(d[1]), fabsf(d[2])};
    const float d1 = ad[0] + ad[1] + ad[2];
    // the soup's bound: its axis rows and every general row
    float qs = any_row ? axis_q(amin, ad) : BIG;
    for (int k = 0; k < n_gen; ++k)
      qs = fminf(qs, general_q(rowq + ROWQ * gen[k], d, d1));
    const float es = extra_pad(qs, ctr, h1, o, d1);
    // the branch is uniform across a warp none of whose rays reach the box
    if (any_row &&
        (es == 0.0f ? reaches<false>(lo, hi, 0.0f, o, inv, cap)
                    : es >= BIG || reaches<true>(lo, hi, es, o, inv, cap))) {
      const float ox = o[0], oy = o[1], oz = o[2];
      const float dx = d[0], dy = d[1], dz = d[2];
      for (int c = 0; c < n_cl; ++c) {
        const float* cb = crec + CREC * c;
        // an empty cluster's box is inverted
        if (!(cb[0] <= cb[3])) continue;
        const int end = min(n_tri, (c + 1) * CLUSTER);
        // the soup's padding bounds every cluster's (its rows are the
        // soup's, its box inside the soup's); only where that one is
        // unbounded, the cluster's own rows bound it
        float ec = es;
        if (es >= BIG) {
          float qc = axis_q(cb + 6, ad);
          if (cb[9] > 0.0f)
            for (int i = c * CLUSTER; i < end; ++i)
              qc = fminf(qc, general_q(rowq + ROWQ * i, d, d1));
          float cc[3], ch1 = 0.0f;
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            cc[a] = 0.5f * (cb[a] + cb[3 + a]);
            ch1 += fmaxf(cb[3 + a] - cc[a], cc[a] - cb[a]) * 1.0009765625f +
                   (fabsf(cb[a]) + fabsf(cb[3 + a])) * SLAB_SLACK;
          }
          ec = extra_pad(qc, cc, ch1, o, d1);
        }
        if (ec == 0.0f ? !reaches<false>(cb, cb + 3, 0.0f, o, inv, cap)
                       : ec < BIG && !reaches<true>(cb, cb + 3, ec, o, inv,
                                                    cap))
          continue;
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
  const size_t n_cl = (n_tri + CLUSTER - 1) / CLUSTER;
  const size_t smem = sizeof(float) * ((9 + ROWQ + ROWA + 1) *
                                           static_cast<size_t>(n_tri) +
                                       CREC * n_cl);
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
