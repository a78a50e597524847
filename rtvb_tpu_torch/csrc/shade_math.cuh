// Device math of the fused shade kernel (K4): the Disney BSDF, the RNG
// streams and the packed-scalar sky, each a line-for-line twin of the
// plain PyTorch version it must equal on the card:
//   rtvb_tpu_torch/ops/bsdf.py, ops/mathutil.py, ops/pack.py, ops/rng.py,
//   render/sky.py (`sky_radiance_scalars`, `sun_radiance_scalars_cone`).
//
// Rounding rules that make the twin exact (the library is built with
// --fmad=false, so no product is fused into the add that follows):
//   * every expression keeps the plain version's association order;
//   * a division by a Python scalar is a product with its reciprocal as
//     common.cuh states it, so `x / PI` and `x / 3.0` are products with
//     INV_PI / INV_3, and `c / tensor` is (1.0f / t) * c;
//   * torch.rsqrt is rsqrtf (not 1 / sqrtf), torch.sqrt is IEEE sqrtf;
//   * torch.clamp propagates NaN (clamp_min / clamp_max in common.cuh).
#pragma once

#include "common.cuh"

namespace rtvb {
namespace shade {

constexpr float PI_F = 3.14159265358979323846f;
constexpr float TWO_PI_F = 6.28318530717958647692f;   // float(2·π)
// x / PI and x / 3.0 on CUDA
constexpr float INV_PI = static_cast<float>(1.0 / 3.14159265358979323846);
constexpr float INV_3 = static_cast<float>(1.0 / 3.0);
constexpr float ROUGHNESS_THRESHOLD = 0.02f;
constexpr float SMOOTH_TRANS_ROUGHNESS = 0.1f;
constexpr float MAX_THROUGHPUT = 32.0f;
constexpr float MIN_LOBE_PROB = 0.05f;
constexpr float MIN_COS = 1e-4f;

// kernels take the math through `using namespace rtvb::shade`
using rtvb::clamp2;
using rtvb::clamp_max;
using rtvb::clamp_min;
using rtvb::pcg_hash;
using rtvb::to_unit_float;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 scale(V3 a, float s) {
  return {a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ float lum(V3 c) {
  return 0.2126f * c.x + 0.7152f * c.y + 0.0722f * c.z;
}
// mathutil.normalize: v · rsqrt(max(|v|², 1e-20))
__device__ __forceinline__ V3 normalize(V3 a) {
  return scale(a, rsqrtf(clamp_min(dot(a, a), 1e-20f)));
}
// mathutil.orthonormal_basis (Duff et al. 2017)
__device__ __forceinline__ void onb(V3 n, V3& t, V3& bt) {
  const float s = n.z >= 0.0f ? 1.0f : -1.0f;
  const float a = (1.0f / (s + n.z)) * -1.0f;
  const float b = n.x * n.y * a;
  t = {1.0f + s * n.x * n.x * a, s * b, -s * n.x};
  bt = {b, s + n.y * n.y * a, -n.y};
}
// mathutil.from_local: t·v.x + bt·v.y + n·v.z
__device__ __forceinline__ V3 from_local(V3 v, V3 t, V3 bt, V3 n) {
  return add(add(scale(t, v.x), scale(bt, v.y)), scale(n, v.z));
}
__device__ __forceinline__ V3 reflect(V3 i, V3 n) {
  return sub(i, scale(n, 2.0f * dot(i, n)));
}
// torch.sign (0 for NaN) of where(x == 0, 1, x): pack._sign_nz
__device__ __forceinline__ float sign_nz(float x) {
  const float y = x == 0.0f ? 1.0f : x;
  return static_cast<float>((0.0f < y) - (y < 0.0f));
}
// sinf and cosf of one angle with one argument reduction (sincosf): the
// same bits as the two calls, and as torch.sin / torch.cos on the card,
// for every angle in [0, 2π] (tests/test_torch_gpu.py checks each one)
__device__ __forceinline__ void sin_cos(float x, float& s, float& c) {
  sincosf(x, &s, &c);
}
// pack.octa_decode
__device__ __forceinline__ V3 octa_decode(float u, float v) {
  const float z = 1.0f - fabsf(u) - fabsf(v);
  const float uf = (1.0f - fabsf(v)) * sign_nz(u);
  const float vf = (1.0f - fabsf(u)) * sign_nz(v);
  const bool ng = z < 0.0f;
  const float x = ng ? uf : u, y = ng ? vf : v;
  const float inv = rsqrtf(clamp_min(x * x + y * y + z * z, 1e-12f));
  return {x * inv, y * inv, z * inv};
}

// ---------------------------------------------------------------------------
// RNG (ops/rng.py): PCG + R2 keyed by pixel, or blue-noise byte planes
// (pcg_hash and to_unit_float in common.cuh)
// ---------------------------------------------------------------------------

constexpr uint32_t PHI2_X_BITS = 3242174889u;
constexpr uint32_t PHI2_Y_BITS = 2447445413u;

__device__ __forceinline__ float pcg_draw(uint32_t base, uint32_t frame,
                                          int dim) {
  const uint32_t d = static_cast<uint32_t>(dim);
  const uint32_t bits = pcg_hash(base ^ (d * 26699u));
  const uint32_t stride = (d & 1u) == 0u ? PHI2_X_BITS : PHI2_Y_BITS;
  return to_unit_float(bits + frame * stride);
}
// bn_draw: frac((mask byte + 0.5)/256 + sobol(frame, dim)/2^32); `sob` is
// to_unit_float(sobol(frame, dim))
__device__ __forceinline__ float bn_draw(const uint32_t bnw[4], float sob,
                                         int dim) {
  const int d16 = dim & 15;
  // the word by selects, not an index: bnw stays in registers
  const uint32_t w = d16 < 8 ? (d16 < 4 ? bnw[0] : bnw[1])
                             : (d16 < 12 ? bnw[2] : bnw[3]);
  const uint32_t byte = (w >> (8 * (d16 & 3))) & 0xFFu;
  const float mask_f =
      __uint_as_float((byte << 15) | 0x3F800000u) - 0.998046875f;
  const float u = mask_f + sob;
  return u - floorf(u);
}
// sobol(frame & 255, dim): XOR of the basis words of the frame's set bits
__device__ __forceinline__ uint32_t sobol(const uint32_t* basis,
                                          uint32_t frame, int dim) {
  const uint32_t* b = basis + 8 * (dim & 255);
  uint32_t v = 0u;
  for (int k = 0; k < 8; ++k)
    if ((frame >> k) & 1u) v ^= __ldg(b + k);
  return v;
}

// ---------------------------------------------------------------------------
// Disney BSDF (ops/bsdf.py)
// ---------------------------------------------------------------------------

struct Mat {
  float ar, ag, ab, rough, metal, trans;
};

__device__ __forceinline__ float schlick(float f0, float cos_t) {
  const float x = clamp2(1.0f - cos_t, 0.0f, 1.0f);
  const float x2 = x * x;
  return f0 + (1.0f - f0) * x2 * x2 * x;
}
__device__ __forceinline__ float ggx_d(float alpha2, float cos_h) {
  const float c2 = cos_h * cos_h;
  const float den = c2 * (alpha2 - 1.0f) + 1.0f;
  return alpha2 / clamp_min(PI_F * den * den, 1e-8f);
}
__device__ __forceinline__ float smith_g1(float alpha2, float cos_v) {
  const float c2 = clamp_min(cos_v * cos_v, 1e-8f);
  const float tan2 = (1.0f - c2) / c2;
  return (1.0f / (1.0f + sqrtf(1.0f + alpha2 * tan2))) * 2.0f;
}
__device__ __forceinline__ float alpha2_of(const Mat& m) {
  float a = clamp_min(m.rough, ROUGHNESS_THRESHOLD);
  a = a * a;
  return a * a;
}
struct Lobes {
  float diff, spec, trans;
};
__device__ __forceinline__ Lobes lobe_probs(const Mat& m, float f_avg) {
  const float spec_w = clamp2(f_avg + m.metal, 0.0f, 1.0f);
  const float trans_w = m.trans * (1.0f - m.metal);
  const float diff_w = (1.0f - spec_w) * (1.0f - trans_w);
  const float p_spec = clamp_min(spec_w, MIN_LOBE_PROB);
  const float p_trans = trans_w > 0.0f ? clamp_min(trans_w, MIN_LOBE_PROB)
                                       : 0.0f;
  const float p_diff = clamp_min(diff_w, MIN_LOBE_PROB);
  const float total = p_spec + p_trans + p_diff;
  return {p_diff / total, p_spec / total, p_trans / total};
}
__device__ __forceinline__ float f0_of(float a, float metal) {
  return 0.04f + (a - 0.04f) * metal;
}

struct Eval {
  V3 f;
  float pdf;
};

// bsdf.evaluate: BSDF value f(wo, wi) (rgb) and sampling pdf
__device__ __noinline__ Eval evaluate(const Mat m, V3 n, V3 wo, V3 wi) {
  const float cos_o = dot(n, wo);
  const float cos_i = dot(n, wi);
  const bool reflect_side = (cos_i > MIN_COS) && (cos_o > MIN_COS);
  const bool trans_side = (cos_i < -MIN_COS) && (cos_o > MIN_COS);
  const float alpha2 = alpha2_of(m);
  const V3 h = normalize(add(wo, wi));
  const float cos_h = clamp_min(dot(n, h), 0.0f);
  const float cos_oh = clamp_min(dot(wo, h), MIN_COS);
  const float f0r = f0_of(m.ar, m.metal), f0g = f0_of(m.ag, m.metal),
              f0b = f0_of(m.ab, m.metal);
  const float D = ggx_d(alpha2, cos_h);
  const float G =
      smith_g1(alpha2, fabsf(cos_o)) * smith_g1(alpha2, fabsf(cos_i));
  const float spec_den = clamp_min(4.0f * fabsf(cos_o) * fabsf(cos_i), 1e-6f);
  const float sr = schlick(f0r, cos_oh) * D * G / spec_den;
  const float sg = schlick(f0g, cos_oh) * D * G / spec_den;
  const float sb = schlick(f0b, cos_oh) * D * G / spec_den;
  const float diff_scale = (1.0f - m.metal) * (1.0f - m.trans) * INV_PI;
  const bool smooth_trans = m.rough < SMOOTH_TRANS_ROUGHNESS;
  const float trans_scale =
      smooth_trans ? 0.0f : (1.0f - m.metal) * m.trans * INV_PI;
  const bool mirror = m.rough < ROUGHNESS_THRESHOLD;
  auto lobe = [&](float a, float s) {
    return reflect_side ? a * diff_scale + (mirror ? 0.0f : s)
                        : (trans_side ? a * trans_scale : 0.0f);
  };
  Eval e;
  e.f = {lobe(m.ar, sr), lobe(m.ag, sg), lobe(m.ab, sb)};
  const Lobes p = lobe_probs(m, schlick((f0r + f0g + f0b) * INV_3, cos_o));
  const float pdf_diff = clamp_min(cos_i, 0.0f) * INV_PI;
  const float pdf_spec = D * cos_h / clamp_min(4.0f * cos_oh, 1e-6f);
  const float pdf_trans = clamp_min(-cos_i, 0.0f) * INV_PI;
  e.pdf = p.diff * (reflect_side ? pdf_diff : 0.0f) +
          (mirror ? 0.0f : p.spec * (reflect_side ? pdf_spec : 0.0f)) +
          (smooth_trans ? 0.0f : p.trans * (trans_side ? pdf_trans : 0.0f));
  return e;
}

struct EvalLum {
  float f, pdf;
};

// bsdf.eval_lum: luminance proxy (f_lum, pdf_proxy)
__device__ __noinline__ EvalLum eval_lum(const Mat m, V3 n, V3 wo, V3 wi) {
  constexpr float ONE_OVER_PI = 0.3183098861837907f;   // float(1.0 / PI)
  const float cos_o = dot(n, wo);
  const float cos_i = dot(n, wi);
  const bool reflect_side = (cos_i > MIN_COS) && (cos_o > MIN_COS);
  const bool trans_side = (cos_i < -MIN_COS) && (cos_o > MIN_COS);
  const float alpha2 = alpha2_of(m);
  const V3 h = normalize(add(wo, wi));
  const float cos_h = clamp_min(dot(n, h), 0.0f);
  const float cos_oh = clamp_min(dot(wo, h), MIN_COS);
  const float alb_lum = 0.2126f * m.ar + 0.7152f * m.ag + 0.0722f * m.ab;
  const float F = schlick(0.04f + (alb_lum - 0.04f) * m.metal, cos_oh);
  const float c2 = cos_h * cos_h;
  const float den = c2 * (alpha2 - 1.0f) + 1.0f;
  const bool mirror = m.rough < ROUGHNESS_THRESHOLD;
  const float d_base =
      alpha2 / clamp_min(PI_F * den * den * 4.0f * cos_oh, 1e-7f);
  const float spec =
      mirror ? 0.0f
             : F * d_base * cos_oh /
                   clamp_min(cos_o * clamp_min(cos_i, MIN_COS), 1e-6f);
  const float one_m_metal = 1.0f - m.metal;
  const float diff = alb_lum * one_m_metal * (1.0f - m.trans) * ONE_OVER_PI;
  const bool smooth_trans = m.rough < SMOOTH_TRANS_ROUGHNESS;
  const float trans =
      smooth_trans ? 0.0f : alb_lum * one_m_metal * m.trans * ONE_OVER_PI;
  EvalLum r;
  r.f = reflect_side ? diff + spec : (trans_side ? trans : 0.0f);
  const float pdf_spec = mirror ? 0.0f : d_base * cos_h;
  r.pdf = reflect_side
              ? 0.5f * clamp_min(cos_i, 0.0f) * ONE_OVER_PI + 0.5f * pdf_spec
              : ((trans_side && !smooth_trans)
                     ? clamp_min(-cos_i, 0.0f) * ONE_OVER_PI
                     : 0.0f);
  return r;
}

struct Sample {
  V3 wi, weight;
  bool is_delta, is_trans;
};

// bsdf.sample: u1 picks the lobe, u2 / u3 sample it
__device__ __noinline__ Sample sample(const Mat m, V3 n, V3 wo, float u1,
                                      float u2, float u3) {
  V3 t, bt;
  onb(n, t, bt);
  const float cos_o = clamp_min(dot(n, wo), MIN_COS);
  const float alpha2 = alpha2_of(m);
  const float f0r = f0_of(m.ar, m.metal), f0g = f0_of(m.ag, m.metal),
              f0b = f0_of(m.ab, m.metal);
  const float f0_avg = (f0r + f0g + f0b) * INV_3;
  const Lobes p = lobe_probs(m, schlick(f0_avg, cos_o));

  // cosine-weighted hemisphere (mathutil.cosine_sample_hemisphere)
  const float r = sqrtf(u2);
  float sd, cd;
  sin_cos(TWO_PI_F * u3, sd, cd);
  const V3 wi_d_local = {r * cd, r * sd, sqrtf(clamp_min(1.0f - u2, 0.0f))};
  const V3 wi_d = from_local(wi_d_local, t, bt, n);

  float sh, ch;
  sin_cos(TWO_PI_F * u2, sh, ch);
  const float cos_h = sqrtf(
      clamp2((1.0f - u3) / (1.0f + (alpha2 - 1.0f) * u3), 0.0f, 1.0f));
  const float sin_h = sqrtf(clamp_min(1.0f - cos_h * cos_h, 0.0f));
  const V3 h_local = {sin_h * ch, sin_h * sh, cos_h};
  const V3 h = from_local(h_local, t, bt, n);
  const bool mirror = m.rough < ROUGHNESS_THRESHOLD;
  const V3 wi_s = mirror ? reflect(neg(wo), n) : reflect(neg(wo), h);
  const bool smooth_trans = m.rough < SMOOTH_TRANS_ROUGHNESS;
  const V3 wi_t = smooth_trans ? neg(wo) : neg(wi_d);

  const bool sel_spec = u1 < p.spec;
  const bool sel_trans = !sel_spec && (u1 < p.spec + p.trans);
  Sample s;
  s.wi = sel_spec ? wi_s : (sel_trans ? wi_t : wi_d);
  const bool delta_trans = sel_trans && smooth_trans;
  const bool delta = (sel_spec && mirror) || delta_trans;

  const Eval e = evaluate(m, n, wo, s.wi);
  const float cos_i = fabsf(dot(n, s.wi));
  const float safe_pdf = clamp_min(e.pdf, 1e-8f);
  const float trans_w = m.trans * (1.0f - m.metal);
  const float spec_den = clamp_min(p.spec, MIN_LOBE_PROB);
  const float trans_den = clamp_min(p.trans, MIN_LOBE_PROB);
  const bool valid = (e.pdf > 0.0f) || delta;
  auto weight = [&](float fc, float f0c, float a) {
    const float w_rough = clamp2(fc * cos_i / safe_pdf, 0.0f, MAX_THROUGHPUT);
    const float w_delta =
        clamp2(schlick(f0c, cos_o) / spec_den, 0.0f, MAX_THROUGHPUT);
    const float w_dtrans = clamp2(a * trans_w / trans_den, 0.0f,
                                  MAX_THROUGHPUT);
    const float w = delta_trans ? w_dtrans : (delta ? w_delta : w_rough);
    return valid ? w : 0.0f;
  };
  s.weight = {weight(e.f.x, f0r, m.ar), weight(e.f.y, f0g, m.ag),
              weight(e.f.z, f0b, m.ab)};
  s.is_delta = delta;
  s.is_trans = sel_trans;
  return s;
}

// ---------------------------------------------------------------------------
// Sky and sun over the packed scalar vector (render/sky.py SF_* layout)
// ---------------------------------------------------------------------------

constexpr int SF_SUN_X = 0, SF_COS_SUN = 3, SF_PDF_SUN = 4,
              SF_ANY_LIGHTS = 5, SF_INV_SIN2R = 6, SF_SUN_POLY = 8,
              SF_BASIS_P = 26, SF_BASIS_M = 30, SF_LEN = 72, N_BASIS = 12;

// sky._acos_poly (Abramowitz–Stegun 4.4.45)
__device__ __forceinline__ float acos_poly(float x) {
  const float ax = fabsf(x);
  const float r = sqrtf(clamp_min(1.0f - ax, 0.0f)) *
                  (1.5707963f +
                   ax * (-0.2121144f + ax * (0.0742610f - 0.0187293f * ax)));
  return x >= 0.0f ? r : PI_F - r;
}

// sky.sky_radiance_scalars with exact reciprocals and rsqrtf
__device__ __noinline__ V3 sky_radiance(V3 d, const float* sf) {
  const V3 sun = {sf[SF_SUN_X], sf[SF_SUN_X + 1], sf[SF_SUN_X + 2]};
  const float cos_t = clamp2(d.y, 0.0f, 1.0f);
  const float cos_g = clamp2(dot(d, sun), -1.0f, 1.0f);
  const float gamma = acos_poly(cos_g);
  const float B = sf[SF_BASIS_P], E1 = sf[SF_BASIS_P + 1],
              E2 = sf[SF_BASIS_P + 2], Hm = sf[SF_BASIS_P + 3];
  // sky_spectral._features, in its order
  const float eu = expf(B * (1.0f / (cos_t + 0.01f)));
  const float e1 = expf(E1 * gamma);
  const float e2 = expf(E2 * gamma);
  const float g2 = cos_g * cos_g;
  const float md = 1.0f + Hm * Hm - 2.0f * Hm * cos_g;
  const float mie = (1.0f + g2) * (1.0f / md) * rsqrtf(md);
  const float z = sqrtf(cos_t);
  const float f[N_BASIS] = {1.0f,    eu,      g2,      z,       e1,
                            e2,      mie,     eu * g2, eu * z,  eu * e1,
                            eu * e2, eu * mie};
  const float* M = sf + SF_BASIS_M;
  float r = f[0] * M[0], g = f[0] * M[1], b = f[0] * M[2];
#pragma unroll
  for (int k = 1; k < N_BASIS; ++k) {
    r = r + f[k] * M[3 * k];
    g = g + f[k] * M[3 * k + 1];
    b = b + f[k] * M[3 * k + 2];
  }
  const float hz = d.y < 0.0f ? 0.35f : 1.0f;
  return {clamp_min(r, 0.0f) * hz, clamp_min(g, 0.0f) * hz,
          clamp_min(b, 0.0f) * hz};
}

// sky.sun_radiance_scalars_cone: limb sample cosine from the cone sine
__device__ __forceinline__ V3 sun_radiance_cone(float sin_t, const float* sf) {
  const float s =
      sqrtf(clamp2(1.0f - sin_t * sin_t * sf[SF_INV_SIN2R], 0.0f, 1.0f));
  const float* P = sf + SF_SUN_POLY;
  float r = P[15], g = P[16], b = P[17];
#pragma unroll
  for (int i = 4; i >= 0; --i) {
    r = r * s + P[3 * i];
    g = g * s + P[3 * i + 1];
    b = b * s + P[3 * i + 2];
  }
  return {clamp_min(r, 0.0f), clamp_min(g, 0.0f), clamp_min(b, 0.0f)};
}

}  // namespace shade
}  // namespace rtvb
