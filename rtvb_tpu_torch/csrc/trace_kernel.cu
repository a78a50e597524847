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
// What bounds it on Hopper: the march.  A ray reads 28 bytes and writes
// ≤ 36, then runs a data-dependent loop of column sub-steps (up to
// max_steps + 1, ≈ 100 instructions and three table lookups each), so the
// card's time goes to issuing that loop and to lanes that wait for the
// slowest ray of their warp.  Design:
// - persistent blocks: the grid is as many 256-thread blocks as the card
//   holds at once (or fewer for few rays).  Each block stages what the
//   march reads — the column masks, the supercolumn distance field and the
//   height envelope, 17 KB for the 64×32×64 world — into shared memory
//   once, reduces the envelope's maximum (the ascending rays' exit height)
//   from it, then walks its rays, instead of restaging them for every 256
//   rays.  The maximum is read from the table at every launch, as the TPU
//   kernel does, so a table rewritten in place needs no host value.  The
//   schema, the exception list and the material map are read once per
//   ray in the epilogue, through the read-only cache.
// - warp-sized chunks: block b's share of the rays is the 32-ray chunks b,
//   b + grid, b + 2·grid, …, spread over the whole ray set; a warp takes
//   the share's next chunk from a shared-memory counter when its 32 rays
//   are done, so a warp that drew short rays does not idle while its
//   neighbours march, and no global atomic is contended.
// - one thread per ray and each ray's arithmetic in the plain version's
//   order: the library is built with --fmad=false, so every record field
//   equals the plain version's to the bit.
#include <climits>

#include "common.cuh"

namespace {

using rtvb::BIG;
constexpr float EPS = 1e-6f;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SLOTS = 128;            // supercolumn table length

struct World {
  int X, Y, Z, ss, sl, super_z, max_steps, n_exc, n_b2m;
};

struct Rays {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *tcap;
  int n;
};

struct Tables {
  const int *colmask, *df, *maxh, *schema, *exc_mask, *exc_key, *exc_id,
      *b2m;
};

struct Record {
  int* hit;
  float* t;
  int *ix, *iy, *iz;
  float *nx, *ny, *nz;
  int* mi;
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

// the bits of −sign(v) as the plain version's `-torch.sign(v)` gives them:
// −1, +1, or −0 where v is ±0 or NaN.  Selected as integers: a float
// select lets the compiler fold the −0 into +0.
__device__ __forceinline__ uint32_t neg_sign_bits(float v) {
  return v > 0.0f ? 0xBF800000u : (v < 0.0f ? 0x3F800000u : 0x80000000u);
}

__device__ int material_index(const World& w, const Tables& tab, int ix,
                              int iy, int iz) {
  int c = rtvb::clampi(ix * w.Z + iz, 0, w.X * w.Z - 1);
  int sch = __ldg(tab.schema + c);
  uint32_t emask = static_cast<uint32_t>(__ldg(tab.exc_mask + c));
  int h1 = sch & 31;
  int h2 = (sch >> 5) & 31;
  int bid = iy < h1 ? (sch >> 10) & 63
                    : (iy < h2 ? (sch >> 16) & 63 : (sch >> 22) & 63);
  // the exception list is searched only for a voxel its column marks:
  // the plain version searches for every ray and keeps the schema's id
  // for the others, so the result is the same without the search's chain
  // of dependent loads for nearly every ray
  if ((emask >> rtvb::clampi(iy, 0, 31)) & 1u) {
    int key = c * w.Y + iy;
    int lo = 0, hi = w.n_exc;               // lower bound of key
    while (lo < hi) {
      int mid = (lo + hi) >> 1;
      if (__ldg(tab.exc_key + mid) < key) lo = mid + 1; else hi = mid;
    }
    lo = rtvb::clampi(lo, 0, w.n_exc - 1);
    if (__ldg(tab.exc_key + lo) == key) bid = __ldg(tab.exc_id + lo);
  }
  return __ldg(tab.b2m + rtvb::clampi(bid, 0, w.n_b2m - 1));
}

template <bool ANY_HIT>
__device__ __forceinline__ void trace_ray(
    int r, const Rays& q, const World& w, const Tables& tab,
    const uint32_t* __restrict__ colmask, const int* __restrict__ df,
    const int* __restrict__ maxh, float maxh_g, const Record& out) {
  const float ox = q.ox[r], oy = q.oy[r], oz = q.oz[r];
  const float dx = q.dx[r], dy = q.dy[r], dz = q.dz[r];
  const int X = w.X, Y = w.Y, Z = w.Z;
  const int n_cols = X * Z;

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
  t_exit = fminf(t_exit, q.tcap[r]);
  // global ascending-ray exit cap at the world's height envelope
  const float t_gm = (maxh_g - oy) * inv_dy;
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
    const int sidx = rtvb::clampi(scx * w.super_z + scz, 0, SLOTS - 1);
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

  out.hit[r] = hit ? 1 : 0;
  if (ANY_HIT) {
    out.t[r] = hit ? t : BIG;
    return;
  }
  out.t[r] = hit ? hit_t : BIG;
  out.ix[r] = hit_ix;
  out.iy[r] = hit_iy;
  out.iz[r] = hit_iz;
  out.nx[r] = __uint_as_float(hit_axis == 0 ? neg_sign_bits(dx) : 0u);
  out.ny[r] = __uint_as_float(hit_axis == 1 ? neg_sign_bits(dy) : 0u);
  out.nz[r] = __uint_as_float(hit_axis == 2 ? neg_sign_bits(dz) : 0u);
  out.mi[r] = material_index(w, tab, hit_ix, hit_iy, hit_iz);
}

template <bool ANY_HIT>
__global__ void __launch_bounds__(THREADS)
trace_kernel(Rays q, Tables tab, World w, Record out) {
  extern __shared__ int smem[];
  __shared__ int next;        // the block's next chunk, counted in its share
  const int n_cols = w.X * w.Z;
  if (threadIdx.x == 0) next = 0;
  uint32_t* colmask = reinterpret_cast<uint32_t*>(smem);
  int* df = smem + n_cols;
  int* maxh = df + SLOTS;
  for (int i = threadIdx.x; i < n_cols; i += THREADS)
    colmask[i] = static_cast<uint32_t>(__ldg(tab.colmask + i));
  // the envelope's maximum: each of the first SLOTS threads holds one
  // slot, reduced within its warp, then across the SLOTS / 32 warps
  static_assert(SLOTS <= THREADS && SLOTS % 32 == 0, "one slot a thread");
  __shared__ int warp_max[SLOTS / 32];
  int m = INT_MIN;
  for (int i = threadIdx.x; i < SLOTS; i += THREADS) {
    df[i] = __ldg(tab.df + i);
    m = __ldg(tab.maxh + i);
    maxh[i] = m;
  }
  for (int o = 16; o > 0; o >>= 1)
    m = max(m, __shfl_xor_sync(0xFFFFFFFFu, m, o));
  if (threadIdx.x < SLOTS && (threadIdx.x & 31) == 0)
    warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  int mm = warp_max[0];
  for (int k = 1; k < SLOTS / 32; ++k) mm = max(mm, warp_max[k]);
  const float maxh_g = static_cast<float>(mm);

  // chunks of 32 consecutive rays; block b's share is chunks b, b + grid,
  // b + 2·grid, …, and a warp takes the share's next chunk when its 32
  // rays are done
  const int lane = threadIdx.x & 31;
  const int n_chunks = (q.n + 31) / 32;
  for (;;) {
    int k = 0;
    if (lane == 0) k = atomicAdd(&next, 1);
    k = __shfl_sync(0xFFFFFFFFu, k, 0);
    const int chunk = blockIdx.x + k * gridDim.x;
    if (chunk >= n_chunks) return;
    const int r = chunk * 32 + lane;
    if (r < q.n)
      trace_ray<ANY_HIT>(r, q, w, tab, colmask, df, maxh, maxh_g, out);
  }
}

size_t staged_bytes(int X, int Z) {
  return sizeof(int) * (static_cast<size_t>(X) * Z + 2 * SLOTS);
}

template <bool ANY_HIT>
int launch(const Rays& q, const Tables& tab, const World& w,
           const Record& out, cudaStream_t stream) {
  const size_t smem = staged_bytes(w.X, w.Z);
  // the blocks the card holds at once, no more than the chunks need
  static rtvb::GridCache cache;
  int grid = 0;
  const cudaError_t e =
      rtvb::persistent_grid(cache, trace_kernel<ANY_HIT>, THREADS, smem,
                            rtvb::blocks_for(q.n, THREADS), &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  trace_kernel<ANY_HIT><<<grid, THREADS, smem, stream>>>(q, tab, w, out);
  return rtvb::launch_status();
}

}  // namespace

RTVB_EXPORT int rtvb_trace(
    const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, const float* tcap, int n,
    const int* colmask, const int* df, const int* maxh, const int* schema,
    const int* exc_mask, const int* exc_key, const int* exc_id,
    const int* b2m, int n_exc, int n_b2m, int X, int Y, int Z,
    int super_size, int super_z, int max_steps, int any_hit,
    int* hit, float* t, int* ix, int* iy, int* iz, float* nx, float* ny,
    float* nz, int* mi, void* stream) {
  if (n == 0) return 0;
  int sl = 0;
  while ((1 << sl) < super_size) ++sl;
  World w{X, Y, Z, super_size, sl, super_z, max_steps, n_exc, n_b2m};
  Rays q{ox, oy, oz, dx, dy, dz, tcap, n};
  Tables tab{colmask, df, maxh, schema, exc_mask, exc_key, exc_id, b2m};
  Record out{hit, t, ix, iy, iz, nx, ny, nz, mi};
  auto s = static_cast<cudaStream_t>(stream);
  return any_hit ? launch<true>(q, tab, w, out, s)
                 : launch<false>(q, tab, w, out, s);
}

