"""Disney-style uber BSDF: sample / evaluate, branchless (port of
rtvb_tpu/ops/bsdf.py — same lobes, clamps and operation order)."""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import mathutil as m
from .mathutil import clip, maximum

ROUGHNESS_THRESHOLD = 0.02
SMOOTH_TRANS_ROUGHNESS = 0.1
MAX_THROUGHPUT = 32.0
MIN_LOBE_PROB = 0.05
MIN_COS = 1e-4
PI = math.pi


class Material(NamedTuple):
    albedo_r: torch.Tensor
    albedo_g: torch.Tensor
    albedo_b: torch.Tensor
    roughness: torch.Tensor
    metallic: torch.Tensor
    translucency: torch.Tensor

    @property
    def albedo(self):
        return (self.albedo_r, self.albedo_g, self.albedo_b)


class BsdfSample(NamedTuple):
    wi: tuple
    weight: tuple
    pdf: torch.Tensor
    is_delta: torch.Tensor
    is_transmission: torch.Tensor


def _schlick(f0, cos_t):
    x = clip(1.0 - cos_t, 0.0, 1.0)
    x2 = x * x
    return f0 + (1.0 - f0) * x2 * x2 * x


def _ggx_d(alpha2, cos_h):
    c2 = cos_h * cos_h
    den = c2 * (alpha2 - 1.0) + 1.0
    return alpha2 / maximum(PI * den * den, 1e-8)


def _smith_g1(alpha2, cos_v):
    c2 = maximum(cos_v * cos_v, 1e-8)
    tan2 = (1.0 - c2) / c2
    return 2.0 / (1.0 + m.sqrt(1.0 + alpha2 * tan2))


def _lobe_probs(mat: Material, f_avg):
    spec_w = clip(f_avg + mat.metallic, 0.0, 1.0)
    trans_w = mat.translucency * (1.0 - mat.metallic)
    diff_w = (1.0 - spec_w) * (1.0 - trans_w)
    p_spec = maximum(spec_w, MIN_LOBE_PROB)
    p_trans = torch.where(trans_w > 0.0, maximum(trans_w, MIN_LOBE_PROB), 0.0)
    p_diff = maximum(diff_w, MIN_LOBE_PROB)
    total = p_spec + p_trans + p_diff
    return p_diff / total, p_spec / total, p_trans / total


def _f0(mat: Material):
    return tuple(0.04 + (a - 0.04) * mat.metallic for a in mat.albedo)


def _alpha2(mat: Material):
    alpha = maximum(mat.roughness, ROUGHNESS_THRESHOLD) ** 2
    return alpha * alpha


def evaluate(mat: Material, n, wo, wi):
    """BSDF value f(wo, wi) (rgb) and sampling pdf for MIS."""
    cos_o = m.dot(n, wo)
    cos_i = m.dot(n, wi)
    reflect_side = (cos_i > MIN_COS) & (cos_o > MIN_COS)
    trans_side = (cos_i < -MIN_COS) & (cos_o > MIN_COS)

    alpha2 = _alpha2(mat)
    h = m.normalize(m.add(wo, wi))
    cos_h = maximum(m.dot(n, h), 0.0)
    cos_oh = maximum(m.dot(wo, h), MIN_COS)

    f0r, f0g, f0b = _f0(mat)
    Fr = _schlick(f0r, cos_oh)
    Fg = _schlick(f0g, cos_oh)
    Fb = _schlick(f0b, cos_oh)
    D = _ggx_d(alpha2, cos_h)
    G = _smith_g1(alpha2, torch.abs(cos_o)) * _smith_g1(alpha2, torch.abs(cos_i))
    spec_den = maximum(4.0 * torch.abs(cos_o) * torch.abs(cos_i), 1e-6)
    spec = tuple(F * D * G / spec_den for F in (Fr, Fg, Fb))

    diff_scale = (1.0 - mat.metallic) * (1.0 - mat.translucency) / PI
    diff = tuple(a * diff_scale for a in mat.albedo)

    is_smooth_trans = mat.roughness < SMOOTH_TRANS_ROUGHNESS
    trans_scale = torch.where(is_smooth_trans, 0.0,
                              (1.0 - mat.metallic) * mat.translucency / PI)
    trans = tuple(a * trans_scale for a in mat.albedo)

    is_mirror = mat.roughness < ROUGHNESS_THRESHOLD
    f = tuple(
        torch.where(reflect_side, d + torch.where(is_mirror, 0.0, s),
                    torch.where(trans_side, t, 0.0))
        for d, s, t in zip(diff, spec, trans))

    p_diff, p_spec, p_trans = _lobe_probs(
        mat, _schlick((f0r + f0g + f0b) / 3.0, cos_o))
    pdf_diff = maximum(cos_i, 0.0) / PI
    pdf_spec = D * cos_h / maximum(4.0 * cos_oh, 1e-6)
    pdf_trans = maximum(-cos_i, 0.0) / PI
    pdf = (p_diff * torch.where(reflect_side, pdf_diff, 0.0)
           + torch.where(is_mirror, 0.0,
                         p_spec * torch.where(reflect_side, pdf_spec, 0.0))
           + torch.where(is_smooth_trans, 0.0,
                         p_trans * torch.where(trans_side, pdf_trans, 0.0)))
    return f, pdf


def eval_lum(mat: Material, n, wo, wi):
    """Luminance-only BSDF proxy: (f_lum, pdf_proxy) — RIS target pdfs and
    the light-vs-BSDF balance weights (see the JAX docstring)."""
    cos_o = m.dot(n, wo)
    cos_i = m.dot(n, wi)
    reflect_side = (cos_i > MIN_COS) & (cos_o > MIN_COS)
    trans_side = (cos_i < -MIN_COS) & (cos_o > MIN_COS)

    alpha2 = _alpha2(mat)
    h = m.normalize(m.add(wo, wi))
    cos_h = maximum(m.dot(n, h), 0.0)
    cos_oh = maximum(m.dot(wo, h), MIN_COS)

    alb_lum = m.luminance(mat.albedo_r, mat.albedo_g, mat.albedo_b)
    F = _schlick(0.04 + (alb_lum - 0.04) * mat.metallic, cos_oh)

    c2 = cos_h * cos_h
    den = c2 * (alpha2 - 1.0) + 1.0
    is_mirror = mat.roughness < ROUGHNESS_THRESHOLD
    d_base = alpha2 / maximum(PI * den * den * 4.0 * cos_oh, 1e-7)
    spec = torch.where(is_mirror, 0.0,
                       F * d_base * cos_oh / maximum(
                           cos_o * maximum(cos_i, MIN_COS), 1e-6))
    one_m_metal = 1.0 - mat.metallic
    diff = alb_lum * one_m_metal * (1.0 - mat.translucency) * (1.0 / PI)
    is_smooth_trans = mat.roughness < SMOOTH_TRANS_ROUGHNESS
    trans = torch.where(is_smooth_trans, 0.0,
                        alb_lum * one_m_metal * mat.translucency * (1.0 / PI))
    f_lum = torch.where(reflect_side, diff + spec,
                        torch.where(trans_side, trans, 0.0))

    pdf_spec = torch.where(is_mirror, 0.0, d_base * cos_h)
    pdf = torch.where(
        reflect_side,
        0.5 * maximum(cos_i, 0.0) * (1.0 / PI) + 0.5 * pdf_spec,
        torch.where(trans_side & ~is_smooth_trans,
                    maximum(-cos_i, 0.0) * (1.0 / PI), 0.0))
    return f_lum, pdf


def sample(mat: Material, n, wo, u1, u2, u3) -> BsdfSample:
    """Sample an outgoing direction (u1 picks the lobe, u2/u3 sample it)."""
    t, bt = m.orthonormal_basis(n)
    cos_o = maximum(m.dot(n, wo), MIN_COS)

    alpha2 = _alpha2(mat)
    f0r, f0g, f0b = _f0(mat)
    f0_avg = (f0r + f0g + f0b) / 3.0
    p_diff, p_spec, p_trans = _lobe_probs(mat, _schlick(f0_avg, cos_o))

    wi_d_local = m.cosine_sample_hemisphere(u2, u3)
    wi_d = m.from_local(wi_d_local, t, bt, n)

    phi = 2.0 * PI * u2
    cos_h = m.sqrt(clip((1.0 - u3) / (1.0 + (alpha2 - 1.0) * u3), 0.0, 1.0))
    sin_h = m.sqrt(maximum(1.0 - cos_h * cos_h, 0.0))
    h_local = (sin_h * torch.cos(phi), sin_h * torch.sin(phi), cos_h)
    h = m.from_local(h_local, t, bt, n)
    wi_s = m.reflect(m.neg(wo), h)

    is_mirror = mat.roughness < ROUGHNESS_THRESHOLD
    wi_mirror = m.reflect(m.neg(wo), n)
    wi_s = m.where3(is_mirror, wi_mirror, wi_s)

    smooth_trans = mat.roughness < SMOOTH_TRANS_ROUGHNESS
    wi_t = m.where3(smooth_trans, m.neg(wo), m.neg(wi_d))

    sel_spec = u1 < p_spec
    sel_trans = (~sel_spec) & (u1 < p_spec + p_trans)
    wi = m.where3(sel_spec, wi_s, m.where3(sel_trans, wi_t, wi_d))

    delta_trans = sel_trans & smooth_trans
    delta = (sel_spec & is_mirror) | delta_trans

    f, pdf = evaluate(mat, n, wo, wi)
    cos_i = torch.abs(m.dot(n, wi))
    safe_pdf = maximum(pdf, 1e-8)
    w_rough = tuple(clip(fc * cos_i / safe_pdf, 0.0, MAX_THROUGHPUT) for fc in f)

    Fd = (_schlick(f0r, cos_o), _schlick(f0g, cos_o), _schlick(f0b, cos_o))
    w_delta = tuple(clip(Fc / maximum(p_spec, MIN_LOBE_PROB), 0.0, MAX_THROUGHPUT)
                    for Fc in Fd)
    trans_w = mat.translucency * (1.0 - mat.metallic)
    w_dtrans = tuple(
        clip(a * trans_w / maximum(p_trans, MIN_LOBE_PROB), 0.0, MAX_THROUGHPUT)
        for a in mat.albedo)

    weight = tuple(
        torch.where(delta_trans, wt, torch.where(delta, wd, wr))
        for wt, wd, wr in zip(w_dtrans, w_delta, w_rough))
    valid = (pdf > 0.0) | delta
    weight = tuple(torch.where(valid, w, 0.0) for w in weight)

    return BsdfSample(wi=wi, weight=weight,
                      pdf=torch.where(delta, 0.0, pdf),
                      is_delta=delta, is_transmission=sel_trans)
