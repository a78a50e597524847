// K4 — fused per-bounce shading: streaming RIS over n_local local-light
// candidates plus the sun and sky candidates (MIS-weighted), the temporal
// ReSTIR combine of n_taps warped reservoirs (M cap, depth / normal tests,
// light-slot remap), winner shading before visibility, and the Disney BSDF
// continuation sample with its pdf proxy.  26 SoA planes out (ShadeOut).
//
// Replaces: rtvb_tpu/render/ris_kernel.py:484 `_shade_tiles` (`_make_kernel`
// over `_fused_body`).  Plain version: rtvb_tpu_torch/render/ris_kernel.py
// `fused_shade_plain`; device math in shade_math.cuh.
//
// What bounds it on Hopper: the issue of a long body, not its bytes.
// Bounce 0 at 1920×1080 with 3 taps and blue noise reads 15 + 1 + 3·9 + 4
// = 47 planes and writes 26: 73 × 4 B × 2,073,600 px ≈ 605 MB, ≈ 0.18 ms at
// 3.35 TB/s; the half-res bounces (19 in, 26 out) ≈ 93 MB, ≈ 0.03 ms.  But
// a pixel runs ~5,000 instructions under --fmad=false (the bounce-0
// instance's SASS is ~4,400 with the BSDF proxy called up to six times,
// the full BSDF twice, IEEE divisions and square roots, accurate
// sin / cos / exp): ≈ 0.35 ms of issue at one instruction a clock on each
// of the card's 528 schedulers.  The first kernel (one thread a pixel,
// planes read where the body needs them, every tap twice) ran 0.4869 ms,
// and bounce 1, with 19 planes in, 2.9× its byte bound.  Design:
// - persistent blocks walk 128-pixel tiles (grid: the blocks the card holds
//   at once); a block's tile of every input plane comes into shared memory
//   by bulk asynchronous copies (cp.async.bulk, one 512-byte copy a plane,
//   issued by one thread and completing on the block's mbarrier).  The
//   last warp done with the tile issues the block's next one; the other
//   blocks on the SM compute meanwhile;
// - each tap is read once from device memory: both passes of the combine
//   read the staged tile;
// - a plane whose base is not 16-byte aligned, and the ragged last tile,
//   come in by each thread's own loads into its pixel's slots instead;
// - 26 planes out by plain coalesced stores (a warp writes 128 B a plane);
// - __launch_bounds__(128, 6): the first kernel's 24 warps an SM (≤ 80
//   registers; a bounce-0 tile is 24 KB).  Two stages (tile i+1's copies
//   in flight while tile i is shaded) take 48 KB a bounce-0 block, so 4
//   blocks an SM, and ran 8% slower than the first kernel; one tile at
//   6 blocks runs as fast (kernel_ab.py, NVIDIA H100 80GB HBM3, 700 W).
//   Some instances keep a little spill there (at most 40 bytes stored, in
//   the 8-candidate blue-noise one): (128, 5) spills none and ran bounce 0
//   2% slower;
// - bit-exact savings in the body: an invalid tap skips its BSDF proxy
//   (its target pdf is 0), a tap that is not a local light skips the
//   light table, sin and cos of one angle come from one sincosf (one
//   argument reduction): the same bits as the two calls the plain version
//   makes (the gpu tests check every angle in [0, 2π]), and a blue-noise
//   draw picks its word by selects, so the words stay out of local memory.
// The per-frame tables (the 72-float sky / sun vector, the env alias rows,
// the blue-noise Sobol terms of this launch's dimensions) are staged in
// shared memory once a block; the light table (18 + 3 rows × K slots) is
// read through the read-only cache, so K and the env map have none of the
// TPU's one-lane-row limits.  The random numbers are drawn in the
// plain version's order (native uint32 PCG, or the blue-noise byte
// planes).  The combine's two passes (the confidence sum, then each tap
// decoded again and merged) keep no tap's 11 values live across the
// others.  The shipped frame's (n_local, n_taps) pairs are compile-time
// instances with unrolled loops, their plane pointers in the launch's
// parameters; any other pair runs the generic instance with runtime
// counts: its plane pointers in a device table the wrapper allocates and a
// small kernel fills on the stream (any number of taps), its staged tile and Sobol terms sized from the
// counts in dynamic shared memory (opting past 48 KB), so only the card's
// shared memory bounds the counts (the wrapper raises past it).  The frame
// index is read from device memory, once a block, so the launch can be
// captured in a CUDA graph and replayed frame after frame.
#include "shade_math.cuh"

namespace {

using namespace rtvb::shade;

constexpr int THREADS = 128;               // one pixel a thread
constexpr int WARPS = THREADS / 32;
constexpr int TILE = THREADS;              // pixels of a staged tile
constexpr int MIN_BLOCKS = 6;              // blocks an SM: ≤ 80 registers
constexpr uint32_t PLANE_BYTES = TILE * sizeof(float);
// the compile-time instances' limits: their pointers are passed by value
// and their Sobol terms staged in a static array (the generic instance
// has neither limit)
constexpr int MAX_TAPS = 4;
constexpr int MAX_LOCAL = 16;
constexpr int MAX_DRAWS = 5 * MAX_LOCAL + 10 + MAX_TAPS;
constexpr int ENV_N = 32;
constexpr int N_IN_MAX = 15 + 1 + 9 * MAX_TAPS + 4;
constexpr int N_OUT_F = 22, N_OUT_I = 4;
constexpr int KIND_LOCAL = 1, KIND_SUN = 2, KIND_SKY = 3;
// rows of the flat light tables (ris_kernel.LF_* / LI_*)
constexpr int LF_V0X = 0, LF_E1X = 3, LF_E2X = 6, LF_NX = 9, LF_AREA = 12,
              LF_RADR = 13, LF_PROB = 16, LF_PMF = 17;
constexpr int LI_ALIAS = 0, LI_ENT = 1, LI_REMAP = 2;
constexpr float INV_ENV_OMEGA = 5.092958178940651f;   // float(1/(2π/32))

// input planes of a launch: the surface, the depth and 9 a tap when it
// has taps, the 4 blue-noise words
__host__ __device__ constexpr int planes_in(int n_taps, bool bn) {
  return 15 + (n_taps > 0 ? 1 + 9 * n_taps : 0) + (bn ? 4 : 0);
}

struct ShadeIO {
  const float* in[N_IN_MAX];   // the compile-time instances' planes
  const float* const* in_tab;  // the generic instance's: a device table
  float* out_f[N_OUT_F];
  int* out_i[N_OUT_I];
  unsigned long long bulk;     // bit k: plane k's base is 16-byte aligned
};

// input plane k: by value in a compile-time instance, from the device
// table in the generic one
template <bool TAB>
__device__ __forceinline__ const float* plane_in(const ShadeIO& io, int k) {
  return TAB ? io.in_tab[k] : io.in[k];
}
// can a bulk copy take plane k (its base 16-byte aligned)?
template <bool TAB>
__device__ __forceinline__ bool bulk_ok(const ShadeIO& io, int k) {
  return TAB ? (reinterpret_cast<uintptr_t>(io.in_tab[k]) & 15u) == 0u
             : ((io.bulk >> k) & 1ull) != 0ull;
}

struct ShadeParams {
  const float* sf;
  const float* lf;
  const int* li;
  const float* envf;
  const int* envi;
  const uint32_t* basis;
  int HW, W, y0, K, n_local, n_taps, base_dim, n_draws, n_in, n_tiles;
  const long long* frame;      // the frame index, in device memory
  bool ent_unreachable;
  float m_cap, dis_thr;
};

// ---------------------------------------------------------------------------
// bulk asynchronous copies and their mbarriers (PTX, sm_90)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
}
// global → shared, `bytes` a multiple of 16, both addresses 16-byte aligned
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// one thread: the bulk copies of `tile`'s planes into the block's tile (the
// aligned planes of a whole tile; none for the ragged last tile), or a
// bare arrival.  n_bulk: the count of aligned planes
template <bool TAB>
__device__ __forceinline__ void issue_tile(const ShadeIO& io,
                                           const ShadeParams& P, int n_in,
                                           int n_bulk, int tile,
                                           float* planes, uint64_t* bar) {
  const bool whole = (tile + 1) * TILE <= P.HW;
  const uint32_t bytes = whole ? n_bulk * PLANE_BYTES : 0u;
  if (bytes == 0u) {
    mbar_arrive(bar);
    return;
  }
  mbar_arrive_tx(bar, bytes);
  const size_t at = static_cast<size_t>(tile) * TILE;
  for (int k = 0; k < n_in; ++k)
    if (bulk_ok<TAB>(io, k))
      bulk_load(planes + k * TILE, plane_in<TAB>(io, k) + at, PLANE_BYTES,
                bar);
}

struct Reservoir {
  int kind, slot;
  float fa, fb;
  V3 dir;
  float dist;
  V3 le;
  float phat, wsum;
};

struct Ctx {
  const ShadeParams& P;
  const float* sob;      // to_unit_float(sobol(frame, base_dim + k)), BN
  uint32_t frame;        // the frame index (its low 32 bits)
  uint32_t base;
  uint32_t bnw[4];
  Mat mat;
  V3 p, n, wo;

  template <bool BN>
  __device__ __forceinline__ float draw(int k) const {
    const int dim = P.base_dim + k;
    if (BN) return bn_draw(bnw, sob[k], dim);
    return pcg_draw(base, frame, dim);
  }
  __device__ __forceinline__ float lf(int row, int slot) const {
    return __ldg(P.lf + row * P.K + rtvb::clampi(slot, 0, P.K - 1));
  }
  __device__ __forceinline__ int li(int row, int slot) const {
    return __ldg(P.li + row * P.K + rtvb::clampi(slot, 0, P.K - 1));
  }
  // one RIS candidate into the streaming reservoir
  __device__ __forceinline__ void stream(Reservoir& r, V3 wi, float dist,
                                         V3 le, float src_pdf, float u,
                                         int kind, int slot, float fa,
                                         float fb, float mis_w,
                                         bool force_full) const {
    const EvalLum el = eval_lum(mat, n, wo, wi);
    const float cos_i = clamp_min(dot(n, wi), 0.0f);
    const float p_hat = el.f * cos_i * lum(le);
    float balance = src_pdf * (1.0f / clamp_min(src_pdf + el.pdf, 1e-9f));
    if (force_full) balance = 1.0f;
    const float w = src_pdf > 1e-9f ? mis_w * balance * p_hat *
                                          (1.0f / clamp_min(src_pdf, 1e-9f))
                                    : 0.0f;
    r.wsum = r.wsum + w;
    if ((u * clamp_min(r.wsum, 1e-20f)) < w) {
      r.kind = kind;
      r.slot = slot;
      r.fa = fa;
      r.fb = fb;
      r.dir = wi;
      r.dist = dist;
      r.le = le;
      r.phat = p_hat;
    }
  }
};

struct Tap {
  int kind, slot;
  float fa, fb, W, M;
  V3 wi, le;
  float dist, phat;
  bool valid;
};

// tap t's stored reservoir at this pixel, from its staged planes `pl`
// (plane k at pl[k * TILE]); `full` also reconstructs the sample at the
// current surface (pass 2), else only validity and capped M
__device__ __forceinline__ Tap decode_tap(const Ctx& c, const float* pl,
                                          float depth, bool full) {
  auto word = [&](int k) { return __float_as_uint(pl[k * TILE]); };
  Tap tp;
  const int w0 = static_cast<int>(word(0));
  tp.kind = w0 & 3;
  int pslot = w0 >> 2;
  const uint32_t m_le = word(4);
  const float pM = rtvb::bf16_lo(m_le);
  const float pdepth = pl[5 * TILE];
  const uint32_t nw = word(6);
  const V3 pn = octa_decode(rtvb::bf16_lo(nw), rtvb::bf16_hi(nw));
  const int tvalid = __float_as_int(pl[8 * TILE]);
  const bool depth_ok = fabsf(pdepth - depth) <=
                        c.P.dis_thr * clamp_min(depth, 1.0f);
  const bool normal_ok = dot(pn, c.n) > 0.8f;
  bool valid = (tvalid != 0) && depth_ok && normal_ok && (tp.kind != 0) &&
               (depth < rtvb::BIG);
  // the light-slot remap and the light table matter to local samples only
  const bool is_local = tp.kind == KIND_LOCAL;
  if (is_local) {
    const int remapped = c.li(LI_REMAP, pslot);
    valid = valid && remapped >= 0;
    pslot = remapped > 0 ? remapped : 0;
  }
  tp.slot = pslot;
  tp.valid = valid;
  tp.M = valid ? clamp_max(pM, c.P.m_cap) : 0.0f;
  if (!full) return tp;

  const uint32_t fw = word(1);
  tp.fa = rtvb::bf16_lo(fw);
  tp.fb = rtvb::bf16_hi(fw);
  tp.W = pl[3 * TILE];
  if (is_local) {
    const V3 lp = {
        c.lf(LF_V0X, pslot) + tp.fa * c.lf(LF_E1X, pslot) +
            tp.fb * c.lf(LF_E2X, pslot),
        c.lf(LF_V0X + 1, pslot) + tp.fa * c.lf(LF_E1X + 1, pslot) +
            tp.fb * c.lf(LF_E2X + 1, pslot),
        c.lf(LF_V0X + 2, pslot) + tp.fa * c.lf(LF_E1X + 2, pslot) +
            tp.fb * c.lf(LF_E2X + 2, pslot)};
    const V3 to_l = sub(lp, c.p);
    const float d2 = clamp_min(dot(to_l, to_l), 1e-6f);
    const float inv_d = rsqrtf(d2);
    tp.wi = scale(to_l, inv_d);
    tp.dist = d2 * inv_d;
    tp.le = {c.lf(LF_RADR, pslot), c.lf(LF_RADR + 1, pslot),
             c.lf(LF_RADR + 2, pslot)};
  } else {
    const uint32_t dw = word(2), lw = word(7);
    const bool is_dist = tp.kind == KIND_SUN || tp.kind == KIND_SKY;
    tp.wi = octa_decode(rtvb::bf16_lo(dw), rtvb::bf16_hi(dw));
    tp.dist = rtvb::BIG;
    tp.le = is_dist ? V3{rtvb::bf16_lo(lw), rtvb::bf16_hi(lw),
                         rtvb::bf16_hi(m_le)}
                    : V3{0.0f, 0.0f, 0.0f};
  }
  // an invalid tap's target pdf is 0 and its sample is never taken
  tp.phat = 0.0f;
  if (valid) {
    const EvalLum el = eval_lum(c.mat, c.n, c.wo, tp.wi);
    const float cos_i = clamp_min(dot(c.n, tp.wi), 0.0f);
    tp.phat = el.f * cos_i * lum(tp.le);
  }
  return tp;
}

struct Tables {
  const float* sf;       // SF_LEN
  const float* envf;     // 2 × ENV_N
  const int* envi;       // ENV_N
  const float* sob;      // this launch's Sobol terms (BN)
  uint32_t frame;        // the frame index, loaded once a block
};

// one pixel: `x` is its slot of the staged tile (plane k at x[k * TILE])
template <int NL, int NT, bool BN>
__device__ __forceinline__ void shade_pixel(const ShadeIO& io,
                                            const ShadeParams& P,
                                            const Tables& tab, const float* x,
                                            int pix) {
  const int n_local = NL >= 0 ? NL : P.n_local;
  const int n_taps = NT >= 0 ? NT : P.n_taps;
  const float* s_sf = tab.sf;

  auto in = [&](int k) { return x[k * TILE]; };
  Ctx c{P, tab.sob, tab.frame};
  c.p = {in(0), in(1), in(2)};
  c.n = {in(3), in(4), in(5)};
  c.wo = {in(6), in(7), in(8)};
  c.mat = {in(9), in(10), in(11), in(12), in(13), in(14)};
  const int bn_at = 15 + (n_taps > 0 ? 1 + 9 * n_taps : 0);
  if (BN) {
#pragma unroll
    for (int i = 0; i < 4; ++i) c.bnw[i] = __float_as_uint(in(bn_at + i));
  } else {
    // the wave's own pixel coordinates, rows offset by y0
    const uint32_t px = static_cast<uint32_t>(pix % P.W);
    const uint32_t py = static_cast<uint32_t>(pix / P.W + P.y0);
    const uint32_t h0 = pcg_hash(0x9E3779B9u ^ px);
    c.base = pcg_hash(h0 ^ (py * 9277u));
  }

  Reservoir r;
  r.kind = 0;
  r.slot = 0;
  r.fa = r.fb = 0.0f;
  r.dir = {0.0f, 0.0f, 0.0f};
  r.dist = rtvb::BIG;
  r.le = {0.0f, 0.0f, 0.0f};
  r.phat = r.wsum = 0.0f;
  const bool any_lights = s_sf[SF_ANY_LIGHTS] > 0.5f;
  int k = 0;    // draw index within this bounce

  // local light candidates (alias-sampled slot, uniform triangle point)
  const float mis_local =
      n_local > 0 ? static_cast<float>(1.0 / static_cast<double>(n_local))
                  : 0.0f;
#pragma unroll (NL > 0 ? NL : 1)
  for (int cand = 0; cand < n_local; ++cand) {
    const float u_slot = c.draw<BN>(k), u_take = c.draw<BN>(k + 1);
    const float u2 = c.draw<BN>(k + 3), u3 = c.draw<BN>(k + 4);
    k += 5;
    const float un = u_slot * static_cast<float>(P.K);
    const int col = rtvb::clampi(static_cast<int>(un), 0, P.K - 1);
    const float frac = un - static_cast<float>(col);
    const int slot = frac < c.lf(LF_PROB, col) ? col : c.li(LI_ALIAS, col);
    const float pmf = c.lf(LF_PMF, slot);
    const bool flip = (u2 + u3) > 1.0f;
    const float fa = flip ? 1.0f - u2 : u2;
    const float fb = flip ? 1.0f - u3 : u3;
    const V3 lp = {
        c.lf(LF_V0X, slot) + fa * c.lf(LF_E1X, slot) +
            fb * c.lf(LF_E2X, slot),
        c.lf(LF_V0X + 1, slot) + fa * c.lf(LF_E1X + 1, slot) +
            fb * c.lf(LF_E2X + 1, slot),
        c.lf(LF_V0X + 2, slot) + fa * c.lf(LF_E1X + 2, slot) +
            fb * c.lf(LF_E2X + 2, slot)};
    const V3 ln = {c.lf(LF_NX, slot), c.lf(LF_NX + 1, slot),
                   c.lf(LF_NX + 2, slot)};
    const float area = c.lf(LF_AREA, slot);
    const V3 to_l = sub(lp, c.p);
    const float dist2 = clamp_min(dot(to_l, to_l), 1e-6f);
    const float inv_dist = rsqrtf(dist2);
    const float dist = dist2 * inv_dist;
    const V3 wi = scale(to_l, inv_dist);
    const float cos_l = clamp_min(dot(ln, neg(wi)), 0.0f);
    const float pdf_sa = pmf * (1.0f / clamp_min(area, 1e-8f)) * dist2 *
                         (1.0f / clamp_min(cos_l, 1e-6f));
    V3 le = {c.lf(LF_RADR, slot), c.lf(LF_RADR + 1, slot),
             c.lf(LF_RADR + 2, slot)};
    if (!((cos_l > 0.0f) && any_lights)) le = {0.0f, 0.0f, 0.0f};
    const bool force = P.ent_unreachable && c.li(LI_ENT, slot) > 0;
    c.stream(r, wi, dist, le, pdf_sa, u_take, KIND_LOCAL, slot, fa, fb,
             mis_local, force);
  }

  {  // sun candidate: uniform cone around the sun direction
    const float u1 = c.draw<BN>(k), u2 = c.draw<BN>(k + 1);
    const float u_take = c.draw<BN>(k + 2);
    k += 3;
    const float cos_t = 1.0f - u1 * (1.0f - s_sf[SF_COS_SUN]);
    const float sin_t = sqrtf(clamp_min(1.0f - cos_t * cos_t, 0.0f));
    float sp, cp;
    sin_cos(TWO_PI_F * u2, sp, cp);
    const V3 local = {sin_t * cp, sin_t * sp, cos_t};
    const V3 sun = {s_sf[SF_SUN_X], s_sf[SF_SUN_X + 1], s_sf[SF_SUN_X + 2]};
    V3 t_, bt_;
    onb(sun, t_, bt_);
    c.stream(r, from_local(local, t_, bt_, sun), rtvb::BIG,
             sun_radiance_cone(sin_t, s_sf), s_sf[SF_PDF_SUN], u_take,
             KIND_SUN, 0, 0.0f, 0.0f, 1.0f, false);
  }
  {  // sky candidate: env alias sample + analytic radiance
    const float u1 = c.draw<BN>(k), u2 = c.draw<BN>(k + 1);
    const float u3 = c.draw<BN>(k + 2), u_take = c.draw<BN>(k + 3);
    k += 4;
    const float un = u1 * static_cast<float>(ENV_N);
    const int col = rtvb::clampi(static_cast<int>(un), 0, ENV_N - 1);
    const float frac = un - static_cast<float>(col);
    const int texel = frac < tab.envf[col] ? col : tab.envi[col];
    const float pmf = tab.envf[ENV_N + rtvb::clampi(texel, 0, ENV_N - 1)];
    const float iu = static_cast<float>(rtvb::pymod(texel, 8));
    const float iv = static_cast<float>(texel >= 0 ? texel / 8
                                                   : -((-texel + 7) / 8));
    const float phi = TWO_PI_F * (iu + u2) * 0.125f;
    const float cos_t = 1.0f - (iv + u3) * 0.25f;
    const float sin_t = sqrtf(clamp_min(1.0f - cos_t * cos_t, 0.0f));
    float sp, cp;
    sin_cos(phi, sp, cp);
    const V3 wi_sky = {sin_t * cp, cos_t, sin_t * sp};
    c.stream(r, wi_sky, rtvb::BIG, sky_radiance(wi_sky, s_sf),
             pmf * INV_ENV_OMEGA, u_take, KIND_SKY, 0, 0.0f, 0.0f, 1.0f,
             false);
  }

  // temporal reservoir combine (restir.temporal_combine role); the taps'
  // planes are staged, so pass 2 re-reads shared memory only
  float M_new;
  if (n_taps > 0) {
    const int k_taps = k;
    k += n_taps;
    const float depth = in(15);
    const float W_cur = r.phat > 1e-9f
                            ? r.wsum * (1.0f / clamp_min(r.phat, 1e-9f))
                            : 0.0f;
    float m_sum = 0.0f;    // Python's sum(): 0 + M0 + M1 + ...
#pragma unroll (NT > 0 ? NT : 1)
    for (int t = 0; t < n_taps; ++t) {
      m_sum = m_sum + decode_tap(c, x + (16 + 9 * t) * TILE, depth, false).M;
    }
    const float c_total = 1.0f + m_sum;
    const float inv_ct = 1.0f / c_total;
    float wsum = inv_ct * r.phat * W_cur;
#pragma unroll 1
    for (int t = 0; t < n_taps; ++t) {
      const Tap tp = decode_tap(c, x + (16 + 9 * t) * TILE, depth, true);
      const float w_t = (tp.M * inv_ct) * tp.phat * tp.W;
      wsum = wsum + w_t;
      if (tp.valid &&
          ((c.draw<BN>(k_taps + t) * clamp_min(wsum, 1e-20f)) < w_t)) {
        r.kind = tp.kind;
        r.slot = tp.slot;
        r.fa = tp.fa;
        r.fb = tp.fb;
        r.dir = tp.wi;
        r.dist = tp.dist;
        r.le = tp.le;
        r.phat = tp.phat;
      }
    }
    r.wsum = wsum;
    M_new = c_total;
  } else {
    M_new = static_cast<float>(n_local + 2);
  }
  const float W_new =
      r.phat > 1e-9f ? r.wsum * (1.0f / clamp_min(r.phat, 1e-9f)) : 0.0f;

  // winner shading (pre-visibility): full per-channel BSDF
  const Eval ev = evaluate(c.mat, c.n, c.wo, r.dir);
  const float cos2 = clamp_min(dot(c.n, r.dir), 0.0f);
  const V3 nee = {ev.f.x * cos2 * r.le.x * W_new,
                  ev.f.y * cos2 * r.le.y * W_new,
                  ev.f.z * cos2 * r.le.z * W_new};

  // BSDF continuation sample + MIS pdf proxy
  const Sample s = sample(c.mat, c.n, c.wo, c.draw<BN>(k), c.draw<BN>(k + 1),
                          c.draw<BN>(k + 2));
  const float pcp = s.is_delta ? 0.0f : eval_lum(c.mat, c.n, c.wo, s.wi).pdf;

  const float outs[N_OUT_F] = {
      r.fa,     r.fb,     r.dir.x,    r.dir.y,    r.dir.z,    r.dist,
      r.le.x,   r.le.y,   r.le.z,     r.phat,     M_new,      W_new,
      nee.x,    nee.y,    nee.z,      s.wi.x,     s.wi.y,     s.wi.z,
      s.weight.x, s.weight.y, s.weight.z, pcp};
#pragma unroll
  for (int i = 0; i < N_OUT_F; ++i) io.out_f[i][pix] = outs[i];
  io.out_i[0][pix] = r.kind;
  io.out_i[1][pix] = r.slot;
  io.out_i[2][pix] = s.is_delta ? 1 : 0;
  io.out_i[3][pix] = s.is_trans ? 1 : 0;
}

template <int NL, int NT, bool BN>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    shade_kernel(const __grid_constant__ ShadeIO io,
                 const __grid_constant__ ShadeParams P) {
  // the generic instance: its plane pointers in a device table, its Sobol
  // terms after the planes in dynamic shared memory
  constexpr bool TAB = NL < 0 || NT < 0;
  extern __shared__ __align__(128) float s_planes[];   // n_in × TILE
  __shared__ float s_sf[SF_LEN];
  __shared__ float s_envf[2 * ENV_N];
  __shared__ int s_envi[ENV_N];
  __shared__ float s_sob_fixed[BN && !TAB ? MAX_DRAWS : 1];
  __shared__ __align__(8) uint64_t s_full;   // the tile's planes are in
  __shared__ unsigned s_done;                 // warps done with a tile
  __shared__ int s_n_bulk;                    // planes a bulk copy takes
  __shared__ uint32_t s_frame;                // the frame index
  const int n_in = NT >= 0 ? planes_in(NT, BN) : P.n_in;
  float* s_sob = TAB ? s_planes + n_in * TILE : s_sob_fixed;
  if (threadIdx.x == 0) {
    mbar_init(&s_full, 1);
    s_done = 0u;
    int n_bulk = 0;
    if (TAB)
      for (int k = 0; k < n_in; ++k) n_bulk += bulk_ok<TAB>(io, k);
    s_n_bulk = TAB ? n_bulk : __popcll(io.bulk);
    // the frame index from device memory: one load a block, so a captured
    // graph's replays each draw their own frame's numbers
    s_frame = static_cast<uint32_t>(*P.frame);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = threadIdx.x; i < SF_LEN; i += THREADS) s_sf[i] = P.sf[i];
  for (int i = threadIdx.x; i < 2 * ENV_N; i += THREADS)
    s_envf[i] = P.envf[i];
  for (int i = threadIdx.x; i < ENV_N; i += THREADS) s_envi[i] = P.envi[i];
  __syncthreads();
  const uint32_t frame = s_frame;
  if (BN) {
    for (int i = threadIdx.x; i < P.n_draws; i += THREADS)
      s_sob[i] = to_unit_float(sobol(P.basis, frame, P.base_dim + i));
    __syncthreads();
  }
  const int n_bulk = s_n_bulk;
  if (threadIdx.x == 0)
    issue_tile<TAB>(io, P, n_in, n_bulk, blockIdx.x, s_planes, &s_full);
  const Tables tab{s_sf, s_envf, s_envi, s_sob, frame};
  // every plane comes in by a bulk copy (for a whole tile)
  const bool all_bulk = n_bulk == n_in;

  // tile j of this block is blockIdx.x + j·grid, phase j of the barrier
  for (int j = 0;; ++j) {
    const int tile = blockIdx.x + j * gridDim.x;
    if (tile >= P.n_tiles) break;
    mbar_wait(&s_full, static_cast<uint32_t>(j) & 1u);
    const int pix = tile * TILE + threadIdx.x;
    if (pix < P.HW) {
      // the planes no bulk copy brought: this thread's own slots
      const bool whole = (tile + 1) * TILE <= P.HW;
      if (!whole || !all_bulk)
        for (int q = 0; q < n_in; ++q)
          if (!whole || !bulk_ok<TAB>(io, q))
            s_planes[q * TILE + threadIdx.x] =
                __ldg(plane_in<TAB>(io, q) + pix);
      shade_pixel<NL, NT, BN>(io, P, tab, s_planes + threadIdx.x, pix);
    }
    // the last warp done with the tile brings in the block's next one
    __syncwarp();
    if ((threadIdx.x & 31) == 0) {
      __threadfence_block();
      if ((atomicAdd(&s_done, 1u) + 1u) % WARPS == 0u) {
        __threadfence_block();
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        const int next = tile + gridDim.x;
        if (next < P.n_tiles)
          issue_tile<TAB>(io, P, n_in, n_bulk, next, s_planes, &s_full);
      }
    }
  }
}

// dynamic shared memory of a launch: the staged tile, and for the generic
// instance its Sobol terms
size_t shade_smem(const ShadeParams& P, bool generic, bool bn) {
  return sizeof(float) * (static_cast<size_t>(P.n_in) * TILE +
                          (generic && bn ? P.n_draws : 0));
}

template <int NL, int NT, bool BN>
cudaError_t launch(const ShadeIO& io, const ShadeParams& P, cudaStream_t s) {
  const size_t smem = shade_smem(P, NL < 0 || NT < 0, BN);
  // the blocks the card holds at once, no more than the tiles need
  static rtvb::GridCache cache;
  int grid = 0;
  const cudaError_t e = rtvb::persistent_grid(
      cache, shade_kernel<NL, NT, BN>, THREADS, smem, P.n_tiles, &grid);
  if (e != cudaSuccess) return e;
  shade_kernel<NL, NT, BN><<<grid, THREADS, smem, s>>>(io, P);
  return cudaGetLastError();
}

// the (n_local, n_taps) pairs with compile-time instances: the shipped
// frame's with no local lights, (0, 3) and (0, 0); with lights the primary
// vertex's 8 candidates + 3 taps and the secondary's 2 + none
bool compiled_pair(int n_local, int n_taps) {
  return (n_local == 0 || n_local == 8) && n_taps == 3 ||
         (n_local == 0 || n_local == 2) && n_taps == 0;
}

template <bool BN>
cudaError_t dispatch(const ShadeIO& io, const ShadeParams& P,
                     cudaStream_t s) {
  if (P.n_local == 0 && P.n_taps == 3) return launch<0, 3, BN>(io, P, s);
  if (P.n_local == 0 && P.n_taps == 0) return launch<0, 0, BN>(io, P, s);
  if (P.n_local == 8 && P.n_taps == 3) return launch<8, 3, BN>(io, P, s);
  if (P.n_local == 2 && P.n_taps == 0) return launch<2, 0, BN>(io, P, s);
  return launch<-1, -1, BN>(io, P, s);
}

// the generic instance's pointer table, written on the stream by a kernel
// that takes the pointers by value (a captured graph keeps them in the
// kernel's parameters; a copy from host memory would replay a dead
// buffer)
constexpr int PTR_CHUNK = 256;
struct PtrChunk {
  const float* p[PTR_CHUNK];
};

__global__ void fill_ptr_table(const __grid_constant__ PtrChunk c, int n,
                               const float** dst) {
  const int i = threadIdx.x;
  if (i < n) dst[i] = c.p[i];
}

cudaError_t write_ptr_table(const void* const* in, int n_in, void* in_tab,
                            cudaStream_t s) {
  const float** dst = static_cast<const float**>(in_tab);
  for (int at = 0; at < n_in; at += PTR_CHUNK) {
    PtrChunk c;
    const int n = n_in - at < PTR_CHUNK ? n_in - at : PTR_CHUNK;
    for (int i = 0; i < PTR_CHUNK; ++i)
      c.p[i] = i < n ? static_cast<const float*>(in[at + i]) : nullptr;
    fill_ptr_table<<<1, PTR_CHUNK, 0, s>>>(c, n, dst + at);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

// in / out_f / out_i: host arrays of device plane pointers, in
// ris_kernel.fused_shade_cuda's order; frame: the frame index (int64) in
// device memory; in_tab: device room for n_in pointers, which the generic
// instance reads its planes from (written here on the stream; may be null
// for a pair with a compile-time instance).  Returns a cudaError_t code.
RTVB_EXPORT int rtvb_shade_dev(const void* const* in, int n_in,
                               void* const* out_f, void* const* out_i,
                               const float* sf, const float* lf,
                               const int* li, const float* envf,
                               const int* envi, const int* basis, int H,
                               int W, int y0, const long long* frame, int K,
                               int n_local, int n_taps, int base_dim,
                               int ent_unreachable, int blue_noise,
                               float m_cap, float dis_thr, void* in_tab,
                               void* stream) {
  const bool generic = !compiled_pair(n_local, n_taps);
  if (n_taps < 0 || n_local < 0 || K < 1 || frame == nullptr ||
      n_in != planes_in(n_taps, blue_noise != 0) ||
      (generic && in_tab == nullptr) ||
      (!generic && n_in > N_IN_MAX))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long HW = static_cast<long long>(H) * W;
  if (HW == 0) return 0;
  ShadeIO io;
  io.bulk = 0ull;
  io.in_tab = static_cast<const float* const*>(in_tab);
  for (int i = 0; i < N_IN_MAX; ++i) {
    io.in[i] = i < n_in ? static_cast<const float*>(in[i]) : nullptr;
    if (i < n_in && reinterpret_cast<uintptr_t>(in[i]) % 16 == 0)
      io.bulk |= 1ull << i;
  }
  for (int i = 0; i < N_OUT_F; ++i) io.out_f[i] = static_cast<float*>(out_f[i]);
  for (int i = 0; i < N_OUT_I; ++i) io.out_i[i] = static_cast<int*>(out_i[i]);
  ShadeParams P;
  P.sf = sf;
  P.lf = lf;
  P.li = li;
  P.envf = envf;
  P.envi = envi;
  P.basis = reinterpret_cast<const uint32_t*>(basis);
  P.HW = static_cast<int>(HW);
  P.W = W;
  P.y0 = y0;
  P.K = K;
  P.n_local = n_local;
  P.n_taps = n_taps;
  P.base_dim = base_dim;
  P.n_draws = 5 * n_local + 10 + n_taps;
  P.n_in = n_in;
  P.n_tiles = static_cast<int>((HW + TILE - 1) / TILE);
  P.frame = frame;
  P.ent_unreachable = ent_unreachable != 0;
  P.m_cap = m_cap;
  P.dis_thr = dis_thr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (generic) {
    const cudaError_t ec = write_ptr_table(in, n_in, in_tab, s);
    if (ec != cudaSuccess) return static_cast<int>(ec);
  }
  const cudaError_t e =
      blue_noise ? dispatch<true>(io, P, s) : dispatch<false>(io, P, s);
  return static_cast<int>(e);
}

namespace {
__global__ void sin_cos_kernel(const float* __restrict__ x,
                               float* __restrict__ s, float* __restrict__ c,
                               long long n) {
  const long long i = blockIdx.x * 256ll + threadIdx.x;
  if (i < n) sin_cos(x[i], s[i], c[i]);
}
}  // namespace

// sin_cos (shade_math.cuh), the form K4 takes the sine and cosine of one
// angle in, over n floats: the tests hold it against torch.sin / torch.cos
RTVB_EXPORT int rtvb_sin_cos(const float* x, float* s, float* c,
                             long long n, void* stream) {
  if (n == 0) return 0;
  sin_cos_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                   static_cast<cudaStream_t>(stream)>>>(x, s, c, n);
  return rtvb::launch_status();
}
