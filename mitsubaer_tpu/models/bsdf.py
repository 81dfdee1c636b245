"""BSDF models, tagged-union dispatch over a parameter table.

Reference: include/mitsuba/render/bsdf.h:215 + src/bsdfs/*.cpp. Conventions
match Mitsuba: directions live in the local shading frame (+z = normal),
`wi` points toward the camera/previous vertex, `eval` returns f * |cos(wo)|,
`pdf` is a solid-angle density, `sample` returns weight = f*cos/pdf. Delta
lobes eval/pdf to zero and set the `delta` flag (integrators use it to skip
MIS). The h-dielectric (hdielectric.cpp:115) takes its IOR per-lane from the
RIF via `eta_override`.

Every lobe is evaluated branchlessly for the whole wavefront and selected by
the per-lane `kind` — with O(10) BSDF types this trades a few flops for
zero divergence in a wide array program.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..core import smalltab, warp
from ..core.math import (
    INV_PI,
    abs_cos_theta,
    cos_theta,
    dot,
    fresnel_conductor,
    fresnel_dielectric,
    normalize,
    reflect_local,
    safe_sqrt,
)
from ..scene.types import (
    BSDF_COATING,
    BSDF_CONDUCTOR,
    BSDF_DIELECTRIC,
    BSDF_DIFFTRANS,
    BSDF_HK,
    BSDF_ROUGHCOATING,
    BSDF_ROUGHDIFFUSE,
    BSDF_DIFFUSE,
    BSDF_HDIELECTRIC,
    BSDF_HROUGHDIELECTRIC,
    BSDF_MIRROR,
    BSDF_MIXTURE,
    BSDF_NULL,
    BSDF_PHONG,
    BSDF_PLASTIC,
    BSDF_ROUGHCONDUCTOR,
    BSDF_ROUGHDIELECTRIC,
    BSDF_ROUGHPLASTIC,
    BSDF_THINDIELECTRIC,
    BSDF_TWOSIDED,
    BSDF_WARD,
    BSDFs,
)

_FLIP_Z = jnp.array([1.0, 1.0, -1.0])


def _wrapper_resolve(bs: BSDFs, idx, wi, active=None):
    """Resolve twosided/mixture WRAPPER rows (twosided.cpp, mixturebsdf.cpp)
    to effective base rows + a possibly-mirrored frame.

    Returns (idx_a, idx_b, w_a, wi2, flip): for non-mixture lanes idx_b
    equals idx_a and w_a is 1. One wrapper level only (builder-enforced)."""
    if not _on(active, BSDF_TWOSIDED, BSDF_MIXTURE):
        return idx, idx, jnp.ones(idx.shape, jnp.float32), wi, \
            jnp.zeros(idx.shape, bool)
    i = jnp.clip(idx, 0, bs.kind.shape[0] - 1)
    kind = jnp.where(idx >= 0, smalltab.take(bs.kind, i), BSDF_NULL)
    is_ts = kind == BSDF_TWOSIDED
    is_mix = kind == BSDF_MIXTURE
    c0 = smalltab.take(bs.child0, i)
    c1 = smalltab.take(bs.child1, i)
    w = smalltab.take(bs.mix_w, i)
    idx_a = jnp.where(is_ts | is_mix, c0, idx)
    idx_b = jnp.where(is_mix, c1, idx_a)
    w_a = jnp.where(is_mix, w, 1.0)
    # twosided: mirror the local frame for back-face shading
    flip = is_ts & (cos_theta(wi) < 0)
    wi2 = jnp.where(flip[..., None], wi * _FLIP_Z, wi)
    return idx_a, idx_b, w_a, wi2, flip


class BSDFSample(NamedTuple):
    wo: jnp.ndarray       # (N, 3) sampled outgoing direction (local frame)
    weight: jnp.ndarray   # (N, 3) f * cos / pdf
    pdf: jnp.ndarray      # (N,) solid-angle pdf (discrete prob for delta)
    delta: jnp.ndarray    # (N,) bool: sampled lobe is a Dirac delta
    eta: jnp.ndarray      # (N,) relative IOR of the sampled event (1 = none)
    null_passthrough: jnp.ndarray  # (N,) bool: null transmission event


def _params(bs: BSDFs, idx, refl_scale=None):
    i = jnp.clip(idx, 0, bs.kind.shape[0] - 1)
    take = lambda a: smalltab.take(a, i)
    refl = take(bs.reflectance)
    if refl_scale is not None:
        refl = refl * refl_scale  # texture-modulated reflectance
    return (
        jnp.where(idx >= 0, take(bs.kind), BSDF_NULL),
        refl,
        take(bs.specular_r),
        take(bs.specular_t),
        take(bs.eta),
        take(bs.cond_eta),
        take(bs.cond_k),
        take(bs.alpha),
        take(bs.exponent),
    )


def _params_aniso(bs: BSDFs, idx):
    i = jnp.clip(idx, 0, bs.kind.shape[0] - 1)
    return smalltab.take(bs.alpha_v, i), smalltab.take(bs.opacity, i)


# --------------------------------------------------------------------------
# Walter-style rough dielectric helpers (roughdielectric.cpp)
# --------------------------------------------------------------------------
def _rough_diel_halfvec(wi, wo, eta_rel):
    """Half vector for reflection or refraction config; eta_rel = eta_t/eta_i
    on wi's side."""
    ci, co = cos_theta(wi), cos_theta(wo)
    is_refl = ci * co > 0
    m_refl = normalize(wi + wo)
    m_refr = normalize(wi + wo * eta_rel[..., None])
    m = jnp.where(is_refl[..., None], m_refl, m_refr)
    # orient to +z hemisphere
    m = jnp.where((cos_theta(m) < 0)[..., None], -m, m)
    return m, is_refl


def _ward_spec(wi, wo, au, av):
    """Ward specular term * cos(wo) (ward.cpp eval, balanced variant)."""
    ci, co = cos_theta(wi), cos_theta(wo)
    h = wi + wo
    hz2 = h[..., 2] * h[..., 2]
    expo = -(h[..., 0] ** 2 / jnp.maximum(au * au, 1e-12)
             + h[..., 1] ** 2 / jnp.maximum(av * av, 1e-12)) / jnp.maximum(hz2, 1e-12)
    denom = 4.0 * jnp.pi * au * av * jnp.sqrt(jnp.maximum(ci * co, 1e-12))
    return jnp.where((ci > 0) & (co > 0),
                     jnp.exp(expo) / jnp.maximum(denom, 1e-12) * co, 0.0)


# --------------------------------------------------------------------------
# Microfacet helpers (GGX) — src/libcore microfacet.h analogue
# --------------------------------------------------------------------------
def _ggx_d(m, alpha):
    ct = cos_theta(m)
    ct2 = ct * ct
    a2 = alpha * alpha
    denom = jnp.pi * (ct2 * (a2 - 1.0) + 1.0) ** 2
    return jnp.where(ct > 0, a2 / jnp.maximum(denom, 1e-20), 0.0)


def _ggx_g1(v, m, alpha):
    ct = cos_theta(v)
    tan2 = jnp.maximum(1.0 - ct * ct, 0.0) / jnp.maximum(ct * ct, 1e-12)
    same_side = dot(v, m) * ct > 0
    lam = 0.5 * (-1.0 + jnp.sqrt(1.0 + alpha * alpha * tan2))
    return jnp.where(same_side, 1.0 / (1.0 + lam), 0.0)


def _ggx_sample(alpha, u):
    ct = 1.0 / jnp.sqrt(1.0 + alpha * alpha * u[..., 0] / jnp.maximum(1.0 - u[..., 0], 1e-9))
    st = safe_sqrt(1.0 - ct * ct)
    phi = 2.0 * jnp.pi * u[..., 1]
    return jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), ct], axis=-1)


def _ggx_pdf_m(m, alpha):
    return _ggx_d(m, alpha) * jnp.maximum(cos_theta(m), 0.0)


# --------------------------------------------------------------------------
# eval / pdf (smooth lobes only)
# --------------------------------------------------------------------------
def _on(active, *ks):
    """Static lobe filter: `active` is the (static) set of BSDF kinds present
    in the scene (RenderConfig.bsdf_kinds via the builder) or None for all.
    Skipped lobes cost nothing — jit specializes per scene."""
    return active is None or any(k in active for k in ks)


def _oren_nayar_factor(wi, wo, sigma):
    """Fast Oren-Nayar factor A + B max(0, cos(phi_i - phi_o)) sinA tanB
    (roughdiffuse.cpp:159-174); sigma in radians-of-slope units."""
    s2 = sigma * sigma
    A = 1.0 - 0.5 * s2 / (s2 + 0.33)
    B = 0.45 * s2 / (s2 + 0.09)
    ci, co = jnp.abs(cos_theta(wi)), jnp.abs(cos_theta(wo))
    si = safe_sqrt(1.0 - ci * ci)
    so = safe_sqrt(1.0 - co * co)
    # cos(phi_i - phi_o) from the tangential projections
    denom = jnp.maximum(si * so, 1e-7)
    cos_dphi = jnp.clip(
        (wi[..., 0] * wo[..., 0] + wi[..., 1] * wo[..., 1]) / denom,
        -1.0, 1.0)
    sin_alpha = jnp.where(ci > co, so, si)
    tan_beta = jnp.where(ci > co, si / jnp.maximum(ci, 1e-6),
                         so / jnp.maximum(co, 1e-6))
    return A + B * jnp.maximum(cos_dphi, 0.0) * sin_alpha * tan_beta


def _eval_base(bs: BSDFs, idx, wi, wo, eta_override=None, refl_scale=None,
               active=None):
    kind, refl, spec_r, spec_t, eta, ceta, ck, alpha, expn = _params(
        bs, idx, refl_scale)
    if eta_override is not None:
        eta = jnp.where((kind == BSDF_HDIELECTRIC)
                        | (kind == BSDF_HROUGHDIELECTRIC), eta_override, eta)
    ci, co = cos_theta(wi), cos_theta(wo)
    front = (ci > 0) & (co > 0)

    f_diffuse = refl * (INV_PI * jnp.maximum(co, 0.0))[..., None]
    zero = jnp.zeros_like(f_diffuse)
    out = zero
    if _on(active, BSDF_DIFFUSE):
        out = jnp.where((kind == BSDF_DIFFUSE)[..., None], f_diffuse, out)

    if _on(active, BSDF_ROUGHDIFFUSE):
        # Oren-Nayar qualitative model, fast variant
        # (roughdiffuse.cpp:159-174): sigma = alpha,
        # A = 1 - sigma^2/(2(sigma^2+0.33)), B = 0.45 sigma^2/(sigma^2+0.09)
        out = jnp.where((kind == BSDF_ROUGHDIFFUSE)[..., None],
                        refl * (_oren_nayar_factor(wi, wo, alpha)
                                * INV_PI * jnp.maximum(co, 0.0))[..., None],
                        out)

    if _on(active, BSDF_PLASTIC, BSDF_ROUGHPLASTIC):
        # plastic: diffuse part attenuated by (1-Fi)(1-Fo) with internal
        # scattering approximation omitted -> "nonlinear=false" plastic
        Fi, _ = fresnel_dielectric(ci, eta)
        Fo, _ = fresnel_dielectric(co, eta)
        f_plastic = refl * ((1.0 - Fi) * (1.0 - Fo) * INV_PI
                            * jnp.maximum(co, 0.0))[..., None]
        out = jnp.where((kind == BSDF_PLASTIC)[..., None], f_plastic, out)

    if _on(active, BSDF_ROUGHCONDUCTOR, BSDF_ROUGHPLASTIC):
        m = normalize(wi + wo)
        m = jnp.where((ci < 0)[..., None], -m, m)
        D = _ggx_d(m, alpha)
        G = _ggx_g1(wi, m, alpha) * _ggx_g1(wo, m, alpha)

    if _on(active, BSDF_ROUGHCONDUCTOR):
        Fc = fresnel_conductor(dot(wi, m), ceta, ck)
        f_roughcond = spec_r * Fc * (
            D * G / jnp.maximum(4.0 * jnp.abs(ci), 1e-12))[..., None]
        out = jnp.where((kind == BSDF_ROUGHCONDUCTOR)[..., None], f_roughcond, out)

    if _on(active, BSDF_PHONG):
        wr = reflect_local(wi)
        cos_r = jnp.maximum(dot(wr, wo), 0.0)
        f_phong = (
            refl * (INV_PI * jnp.maximum(co, 0.0))[..., None]
            + spec_r * ((expn + 2.0) / (2.0 * jnp.pi) * cos_r ** expn
                        * jnp.maximum(co, 0.0))[..., None])
        out = jnp.where((kind == BSDF_PHONG)[..., None], f_phong, out)

    if _on(active, BSDF_WARD):
        av, _ = _params_aniso(bs, idx)
        f_ward = (refl * (INV_PI * jnp.maximum(co, 0.0))[..., None]
                  + spec_r * _ward_spec(wi, wo, alpha, av)[..., None])
        out = jnp.where((kind == BSDF_WARD)[..., None], f_ward, out)

    if _on(active, BSDF_ROUGHPLASTIC):
        Fm = fresnel_dielectric(dot(wi, m), eta)[0]
        f_rplastic = (spec_r * (Fm * D * G
                                / jnp.maximum(4.0 * jnp.abs(ci), 1e-12))[..., None]
                      + f_plastic)
        out = jnp.where((kind == BSDF_ROUGHPLASTIC)[..., None], f_rplastic, out)

    out = jnp.where(front[..., None], out, zero)

    # ---- transmission-capable lobes (no front gate) ----
    if _on(active, BSDF_DIFFTRANS):
        f_dt = refl * (INV_PI * jnp.abs(co))[..., None]
        out = jnp.where((kind == BSDF_DIFFTRANS)[..., None],
                        jnp.where((ci * co < 0)[..., None], f_dt, zero), out)

    if _on(active, BSDF_HK):
        # Hanrahan-Krueger thin-slab single scattering (hk.cpp): sigma_s =
        # spec_r, sigma_a = spec_t, thickness = alpha, HG g = mix_w. The
        # closed-form single-scatter slab lobes; the attenuated straight-
        # through transmission is a delta (sample-only).
        f_hk_r, f_hk_t, _ = _hk_lobes(bs, idx, spec_r, spec_t, alpha,
                                      wi, wo)
        f_hk = jnp.where((ci * co > 0)[..., None], f_hk_r, f_hk_t) \
            * jnp.abs(co)[..., None]
        out = jnp.where((kind == BSDF_HK)[..., None], f_hk, out)

    if _on(active, BSDF_ROUGHDIELECTRIC, BSDF_HROUGHDIELECTRIC):
        # rough dielectric (Walter et al. 2007; roughdielectric.cpp)
        is_rd = (kind == BSDF_ROUGHDIELECTRIC) | (kind == BSDF_HROUGHDIELECTRIC)
        eta_rel = jnp.where(ci > 0, eta, 1.0 / eta)
        mh, is_refl = _rough_diel_halfvec(wi, wo, eta_rel)
        Frd = fresnel_dielectric(dot(wi, mh), eta)[0]
        Drd = _ggx_d(mh, alpha)
        Grd = _ggx_g1(wi, mh, alpha) * _ggx_g1(wo, mh, alpha)
        f_rd_refl = Frd * Drd * Grd / jnp.maximum(4.0 * jnp.abs(ci), 1e-12)
        im, om = dot(wi, mh), dot(wo, mh)
        denom_t = im + eta_rel * om
        f_rd_trans = (jnp.abs(im * om) / jnp.maximum(jnp.abs(ci), 1e-12)
                      * (eta_rel * eta_rel) * (1.0 - Frd) * Drd * Grd
                      / jnp.maximum(denom_t * denom_t, 1e-12))
        # radiance (non-symmetric) transport: transmission scaled by 1/eta^2
        f_rd_trans = f_rd_trans / jnp.maximum(eta_rel * eta_rel, 1e-12)
        # Walter's f carries 1/(|ci||co|); returning f*|co| cancels the |co|
        f_rd = jnp.where(is_refl[..., None], spec_r * f_rd_refl[..., None],
                         spec_t * f_rd_trans[..., None])
        out = jnp.where(is_rd[..., None], f_rd, out)
    # mask.cpp: the non-delta part of a masked material is opacity * f; the
    # (1-opacity) passthrough is a delta lobe and evals to zero. opacity
    # defaults to 1, so this is a no-op for ordinary materials.
    _, opacity = _params_aniso(bs, idx)
    return out * opacity[..., None]


def _hk_lobes(bs: BSDFs, idx, sig_s, sig_a, thickness, wi, wo):
    """HK single-scatter slab lobes: (f_reflect, f_transmit, q_delta).

    With tau = sigma_t * d, albedo w = sigma_s/sigma_t, mu = |cos|:
      f_r = w p(gamma) / (mu_i + mu_o) * (1 - e^{-tau(1/mu_i + 1/mu_o)})
      f_t = w p(gamma) (e^{-tau/mu_i} - e^{-tau/mu_o}) / (mu_i - mu_o)
          -> w p tau e^{-tau/mu} / mu^2 as mu_i -> mu_o
    q_delta = mean_channel e^{-tau/mu_i}: the unscattered straight-through
    probability (the delta lobe's discrete sampling weight).

    Deliberate deviation from the reference: hk.cpp:233/254 multiplies both
    glossy lobes by an extra cosThetaI factor, which makes the BSDF
    non-reciprocal (eval(wi,wo) != eval(wo,wi)). We omit it so the lobes are
    reciprocal and sample/eval/pdf-consistent (enforced by tests/test_hk.py);
    HK renders are therefore unbiased but brighter than hk.cpp by |cos_i|
    per glossy lobe."""
    i_c = jnp.clip(idx, 0, bs.kind.shape[0] - 1)
    g = smalltab.take(bs.mix_w, i_c)
    ci, co = cos_theta(wi), cos_theta(wo)
    mu_i = jnp.maximum(jnp.abs(ci), 1e-5)
    mu_o = jnp.maximum(jnp.abs(co), 1e-5)
    st = sig_s + sig_a
    tau = st * jnp.maximum(thickness, 1e-6)[..., None]
    w_alb = sig_s / jnp.maximum(st, 1e-9)
    # HG phase between propagation directions (-wi -> wo)
    cg = dot(-wi, wo)
    denom = jnp.maximum(1.0 + g * g - 2.0 * g * cg, 1e-9)
    p_hg = (INV_PI * 0.25) * (1.0 - g * g) / (denom * jnp.sqrt(denom))
    f_r = (w_alb * p_hg[..., None] / (mu_i + mu_o)[..., None]
           * (1.0 - jnp.exp(-tau * (1.0 / mu_i + 1.0 / mu_o)[..., None])))
    dmu = mu_i - mu_o
    near = jnp.abs(dmu) < 1e-4
    safe = jnp.where(near, 1.0, dmu)
    f_t_gen = (jnp.exp(-tau / mu_i[..., None])
               - jnp.exp(-tau / mu_o[..., None])) / safe[..., None]
    f_t_lim = tau * jnp.exp(-tau / mu_i[..., None]) / (mu_i * mu_i)[..., None]
    f_t = w_alb * p_hg[..., None] * jnp.where(near[..., None], f_t_lim,
                                              f_t_gen)
    q_delta = jnp.mean(jnp.exp(-tau / mu_i[..., None]), axis=-1)
    return f_r, f_t, q_delta


def _pdf_base(bs: BSDFs, idx, wi, wo, eta_override=None, refl_scale=None,
              active=None):
    kind, refl, spec_r, spec_t, eta, ceta, ck, alpha, expn = _params(
        bs, idx, refl_scale)
    if eta_override is not None:
        eta = jnp.where((kind == BSDF_HDIELECTRIC)
                        | (kind == BSDF_HROUGHDIELECTRIC), eta_override, eta)
    ci, co = cos_theta(wi), cos_theta(wo)
    front = (ci > 0) & (co > 0)

    p_cos = warp.square_to_cosine_hemisphere_pdf(wo)
    out = jnp.where(kind == BSDF_DIFFUSE, p_cos, 0.0)
    if _on(active, BSDF_ROUGHDIFFUSE):
        out = jnp.where(kind == BSDF_ROUGHDIFFUSE, p_cos, out)

    if _on(active, BSDF_ROUGHCONDUCTOR, BSDF_ROUGHPLASTIC):
        m = normalize(wi + wo)
        m = jnp.where((ci < 0)[..., None], -m, m)
        p_rough = _ggx_pdf_m(m, alpha) / jnp.maximum(
            4.0 * jnp.abs(dot(wo, m)), 1e-12)
        out = jnp.where(kind == BSDF_ROUGHCONDUCTOR, p_rough, out)

    if _on(active, BSDF_PLASTIC, BSDF_ROUGHPLASTIC):
        Fi, _ = fresnel_dielectric(ci, eta)
        p_plastic = (1.0 - Fi) * p_cos
        out = jnp.where(kind == BSDF_PLASTIC, p_plastic, out)

    if _on(active, BSDF_PHONG):
        wr = reflect_local(wi)
        cos_r = jnp.maximum(dot(wr, wo), 0.0)
        p_phong_spec = (expn + 1.0) / (2.0 * jnp.pi) * cos_r ** expn
        spec_w = jnp.max(spec_r, axis=-1) / jnp.maximum(
            jnp.max(spec_r, axis=-1) + jnp.max(refl, axis=-1), 1e-12)
        p_phong = spec_w * p_phong_spec + (1.0 - spec_w) * p_cos
        out = jnp.where(kind == BSDF_PHONG, p_phong, out)

    if _on(active, BSDF_WARD):
        av, _ = _params_aniso(bs, idx)
        h = normalize(wi + wo)
        spec_w_ward = jnp.max(spec_r, axis=-1) / jnp.maximum(
            jnp.max(spec_r, axis=-1) + jnp.max(refl, axis=-1), 1e-12)
        hz = jnp.maximum(cos_theta(h), 1e-6)
        d_ward = jnp.exp(-(h[..., 0] ** 2 / jnp.maximum(alpha * alpha, 1e-12)
                           + h[..., 1] ** 2 / jnp.maximum(av * av, 1e-12))
                         / jnp.maximum(hz * hz, 1e-12))
        # anisotropic-Beckmann half-vector density p(m) = D(m) cos(m)
        p_h = d_ward / (jnp.pi * alpha * av * hz ** 3)
        p_ward_spec = p_h / jnp.maximum(4.0 * jnp.abs(dot(wo, h)), 1e-12)
        p_ward = spec_w_ward * p_ward_spec + (1.0 - spec_w_ward) * p_cos
        out = jnp.where(kind == BSDF_WARD, p_ward, out)

    if _on(active, BSDF_ROUGHPLASTIC):
        p_rp = Fi * p_rough + (1.0 - Fi) * p_cos
        out = jnp.where(kind == BSDF_ROUGHPLASTIC, p_rp, out)

    out = jnp.where(front, out, 0.0)

    if _on(active, BSDF_DIFFTRANS):
        p_dt = warp.square_to_cosine_hemisphere_pdf(jnp.abs(wo))
        out = jnp.where(kind == BSDF_DIFFTRANS,
                        jnp.where(ci * co < 0, p_dt, 0.0), out)

    if _on(active, BSDF_HK):
        # proposal: (1-q_delta) x [half/half cosine lobe per side]
        _, _, q_hk = _hk_lobes(bs, idx, spec_r, spec_t, alpha, wi, wo)
        p_hk = (1.0 - q_hk) * 0.5 * jnp.abs(co) * INV_PI
        out = jnp.where(kind == BSDF_HK, p_hk, out)

    if _on(active, BSDF_ROUGHDIELECTRIC, BSDF_HROUGHDIELECTRIC):
        is_rd = (kind == BSDF_ROUGHDIELECTRIC) | (kind == BSDF_HROUGHDIELECTRIC)
        eta_rel = jnp.where(ci > 0, eta, 1.0 / eta)
        mh, is_refl = _rough_diel_halfvec(wi, wo, eta_rel)
        Frd = fresnel_dielectric(dot(wi, mh), eta)[0]
        pdf_m_rd = _ggx_pdf_m(mh, alpha)
        im, om = dot(wi, mh), dot(wo, mh)
        jac_refl = 1.0 / jnp.maximum(4.0 * jnp.abs(om), 1e-12)
        denom_t = im + eta_rel * om
        jac_trans = (eta_rel * eta_rel) * jnp.abs(om) / jnp.maximum(
            denom_t * denom_t, 1e-12)
        p_rd = jnp.where(is_refl, Frd * pdf_m_rd * jac_refl,
                         (1.0 - Frd) * pdf_m_rd * jac_trans)
        out = jnp.where(is_rd, p_rd, out)
    # mask.cpp: the continuous lobe is selected with prob opacity (the
    # remaining (1-opacity) mass is the delta passthrough, not part of the
    # solid-angle pdf). Mirrors the opacity factor applied in eval().
    _, opacity = _params_aniso(bs, idx)
    return out * opacity


# --------------------------------------------------------------------------
# sample
# --------------------------------------------------------------------------
def _sample_base(bs: BSDFs, idx, wi, u2, u1, eta_override=None,
                 refl_scale=None, active=None, u_op=None) -> BSDFSample:
    """Sample all lobes branchlessly and select by kind.

    u2: (N, 2) for direction, u1: (N,) for lobe selection, u_op: optional
    dedicated uniform for the mask/opacity passthrough test (falls back to a
    bit-mix of u1, which correlates with lobe choice under LDS samplers)."""
    kind, refl, spec_r, spec_t, eta, ceta, ck, alpha, expn = _params(
        bs, idx, refl_scale)
    if eta_override is not None:
        eta = jnp.where((kind == BSDF_HDIELECTRIC)
                        | (kind == BSDF_HROUGHDIELECTRIC), eta_override, eta)
    av, opacity = _params_aniso(bs, idx)
    ci = cos_theta(wi)
    n = wi.shape[0]
    ones3 = jnp.ones((n, 3), jnp.float32)

    # ---- diffuse ----
    wo_diff = warp.square_to_cosine_hemisphere(u2)
    wo_diff = jnp.where((ci < 0)[..., None], -wo_diff, wo_diff)  # reflect to wi side
    pdf_diff = warp.square_to_cosine_hemisphere_pdf(jnp.abs(wo_diff))
    w_diff = refl

    # ---- smooth dielectric (dielectric.cpp) ----
    F, cos_t = fresnel_dielectric(ci, eta)
    reflect_choice = u1 < F
    wo_refl = reflect_local(wi)
    eta_rel = jnp.where(ci > 0, eta, 1.0 / eta)
    # refracted direction in local frame: scaled tangential + cos_t on z
    scale_t = 1.0 / eta_rel
    wo_refr = jnp.stack(
        [-wi[..., 0] * scale_t, -wi[..., 1] * scale_t, cos_t], axis=-1
    )
    wo_refr = normalize(wo_refr)
    # radiance scaling for transmission: 1/eta_rel^2 (radiance compression)
    w_trans = spec_t * (scale_t * scale_t)[..., None]
    wo_diel = jnp.where(reflect_choice[..., None], wo_refl, wo_refr)
    w_diel = jnp.where(reflect_choice[..., None], spec_r, w_trans)
    pdf_diel = jnp.where(reflect_choice, F, 1.0 - F)
    eta_diel = jnp.where(reflect_choice, 1.0, eta_rel)

    # ---- thin dielectric (thindielectric.cpp): interaction with both faces,
    # transmission leaves direction unchanged ----
    R = jnp.where(F < 1.0, F * 2.0 / (1.0 + F), 1.0)
    thin_reflect = u1 < R
    wo_thin = jnp.where(thin_reflect[..., None], wo_refl, -wi)
    w_thin = jnp.where(thin_reflect[..., None], spec_r, spec_t)
    pdf_thin = jnp.where(thin_reflect, R, 1.0 - R)

    # ---- conductor / mirror ----
    Fc = fresnel_conductor(ci, ceta, ck)
    w_cond = spec_r * Fc
    w_mirror = spec_r

    # ---- null (medium boundary passthrough) ----
    wo_null = -wi
    w_null = ones3

    # ---- plastic: specular w.p. F, else cosine diffuse ----
    spec_choice = u1 < F
    wo_plastic = jnp.where(spec_choice[..., None], wo_refl, wo_diff)
    w_plastic = jnp.where(
        spec_choice[..., None],
        spec_r,
        refl * ((1.0 - fresnel_dielectric(cos_theta(wo_diff), eta)[0]) / jnp.maximum(1.0 - F, 1e-6))[..., None],
    )
    pdf_plastic = jnp.where(spec_choice, F, (1.0 - F) * pdf_diff)

    wo_d = {BSDF_DIFFUSE: wo_diff, BSDF_DIELECTRIC: wo_diel,
            BSDF_HDIELECTRIC: wo_diel, BSDF_THINDIELECTRIC: wo_thin,
            BSDF_CONDUCTOR: wo_refl, BSDF_MIRROR: wo_refl, BSDF_NULL: wo_null,
            BSDF_PLASTIC: wo_plastic}
    w_d = {BSDF_DIFFUSE: w_diff, BSDF_DIELECTRIC: w_diel,
           BSDF_HDIELECTRIC: w_diel, BSDF_THINDIELECTRIC: w_thin,
           BSDF_CONDUCTOR: w_cond, BSDF_MIRROR: w_mirror, BSDF_NULL: w_null,
           BSDF_PLASTIC: w_plastic}
    p_d = {BSDF_DIFFUSE: pdf_diff, BSDF_DIELECTRIC: pdf_diel,
           BSDF_HDIELECTRIC: pdf_diel, BSDF_THINDIELECTRIC: pdf_thin,
           BSDF_CONDUCTOR: jnp.ones_like(ci), BSDF_MIRROR: jnp.ones_like(ci),
           BSDF_NULL: jnp.ones_like(ci), BSDF_PLASTIC: pdf_plastic}

    # ---- rough conductor (GGX) — m reused by roughplastic/roughdielectric --
    if _on(active, BSDF_ROUGHCONDUCTOR, BSDF_ROUGHPLASTIC,
           BSDF_ROUGHDIELECTRIC, BSDF_HROUGHDIELECTRIC):
        m = _ggx_sample(alpha, u2)
        m = jnp.where((ci < 0)[..., None], -m, m)
        wo_rough = 2.0 * dot(wi, m, keepdims=True) * m - wi
        pdf_m = _ggx_pdf_m(jnp.abs(m), alpha)
        pdf_rough = pdf_m / jnp.maximum(4.0 * jnp.abs(dot(wi, m)), 1e-12)
        G = _ggx_g1(wi, m, alpha) * _ggx_g1(wo_rough, m, alpha)

    if _on(active, BSDF_ROUGHCONDUCTOR):
        Fcr = fresnel_conductor(dot(wi, m), ceta, ck)
        # weight = F * G * dot(wi, m) / (ci * cos_m) (Walter et al.)
        w_rough = spec_r * Fcr * jnp.where(
            (cos_theta(wo_rough) * ci > 0),
            G * jnp.abs(dot(wi, m)) / jnp.maximum(
                jnp.abs(ci) * jnp.abs(cos_theta(m)), 1e-12),
            0.0,
        )[..., None]
        wo_d[BSDF_ROUGHCONDUCTOR] = wo_rough
        w_d[BSDF_ROUGHCONDUCTOR] = w_rough
        p_d[BSDF_ROUGHCONDUCTOR] = pdf_rough

    if _on(active, BSDF_PHONG):
        spec_w = jnp.max(spec_r, axis=-1) / jnp.maximum(
            jnp.max(spec_r, axis=-1) + jnp.max(refl, axis=-1), 1e-12
        )
        phong_spec = u1 < spec_w
        wr = reflect_local(wi)
        # sample cos^n lobe around wr
        ct_lobe = u2[..., 0] ** (1.0 / (expn + 1.0))
        st_lobe = safe_sqrt(1.0 - ct_lobe * ct_lobe)
        phi = 2.0 * jnp.pi * u2[..., 1]
        lobe_local = jnp.stack(
            [st_lobe * jnp.cos(phi), st_lobe * jnp.sin(phi), ct_lobe], axis=-1
        )
        from ..core.math import Frame

        wo_ph_spec = Frame.from_normal(wr).to_world(lobe_local)
        wo_phong = jnp.where(phong_spec[..., None], wo_ph_spec, wo_diff)
        f_ph = _eval_base(bs, idx, wi, wo_phong, refl_scale=refl_scale, active=active)
        p_ph = _pdf_base(bs, idx, wi, wo_phong, refl_scale=refl_scale, active=active)
        w_phong = f_ph / jnp.maximum(p_ph, 1e-12)[..., None]
        wo_d[BSDF_PHONG] = wo_phong
        w_d[BSDF_PHONG] = w_phong
        p_d[BSDF_PHONG] = p_ph

    if _on(active, BSDF_DIFFTRANS):
        # diffuse transmitter (difftrans.cpp): cosine lobe, opposite side
        wo_dt = wo_diff * jnp.array([1.0, 1.0, -1.0])  # mirror to far side
        wo_d[BSDF_DIFFTRANS] = wo_dt
        w_d[BSDF_DIFFTRANS] = refl
        p_d[BSDF_DIFFTRANS] = pdf_diff

    if _on(active, BSDF_ROUGHDIFFUSE):
        # cosine proposal; weight = f/(p cos) = refl * Oren-Nayar factor
        wo_d[BSDF_ROUGHDIFFUSE] = wo_diff
        w_d[BSDF_ROUGHDIFFUSE] = refl * _oren_nayar_factor(
            wi, wo_diff, alpha)[..., None]
        p_d[BSDF_ROUGHDIFFUSE] = pdf_diff

    hk_delta = None
    if _on(active, BSDF_HK):
        # HK (hk.cpp): with prob q_delta take the attenuated straight-
        # through delta; else a half/half per-side cosine proposal whose
        # weight is eval/pdf (single-scatter lobes)
        _, _, q_hk = _hk_lobes(bs, idx, spec_r, spec_t, alpha, wi, wi)
        hk_delta = u1 < q_hk
        u1_r = jnp.clip((u1 - q_hk) / jnp.maximum(1.0 - q_hk, 1e-6),
                        0.0, 1.0)
        hk_back = u1_r < 0.5
        wo_hk_nd = jnp.where(hk_back[..., None],
                             wo_diff * jnp.array([1.0, 1.0, -1.0]), wo_diff)
        wo_hk = jnp.where(hk_delta[..., None], -wi, wo_hk_nd)
        f_hk_s = _eval_base(bs, idx, wi, wo_hk, refl_scale=refl_scale,
                            active=active)
        p_hk_s = _pdf_base(bs, idx, wi, wo_hk, refl_scale=refl_scale,
                           active=active)
        st_hk = spec_r + spec_t
        tau_hk = st_hk * jnp.maximum(alpha, 1e-6)[..., None]
        mu_i_hk = jnp.maximum(jnp.abs(ci), 1e-5)
        w_hk_delta = jnp.exp(-tau_hk / mu_i_hk[..., None]) \
            / jnp.maximum(q_hk, 1e-6)[..., None]
        w_hk = jnp.where(hk_delta[..., None], w_hk_delta,
                         f_hk_s / jnp.maximum(p_hk_s, 1e-12)[..., None])
        wo_d[BSDF_HK] = wo_hk
        w_d[BSDF_HK] = w_hk
        p_d[BSDF_HK] = jnp.where(hk_delta, jnp.maximum(q_hk, 1e-6), p_hk_s)

    if _on(active, BSDF_WARD):
        # ward: sample the anisotropic specular lobe or cosine diffuse
        spec_w_ward = jnp.max(spec_r, axis=-1) / jnp.maximum(
            jnp.max(spec_r, axis=-1) + jnp.max(refl, axis=-1), 1e-12)
        ward_spec = u1 < spec_w_ward
        phi_in = 2.0 * jnp.pi * u2[..., 1]
        # phi_h distributed with tan(phi_h) = (av/au) tan(phi)
        phi_h = jnp.arctan2(av * jnp.sin(phi_in), alpha * jnp.cos(phi_in))
        cph, sph = jnp.cos(phi_h), jnp.sin(phi_h)
        tan2_th = -jnp.log(jnp.maximum(u2[..., 0], 1e-9)) / jnp.maximum(
            cph * cph / jnp.maximum(alpha * alpha, 1e-12)
            + sph * sph / jnp.maximum(av * av, 1e-12), 1e-12)
        ct_h = 1.0 / jnp.sqrt(1.0 + tan2_th)
        st_h = safe_sqrt(1.0 - ct_h * ct_h)
        h_ward = jnp.stack([st_h * cph, st_h * sph, ct_h], axis=-1)
        h_ward = jnp.where((ci < 0)[..., None], -h_ward, h_ward)
        wo_ward_s = 2.0 * dot(wi, h_ward, keepdims=True) * h_ward - wi
        wo_ward = jnp.where(ward_spec[..., None], wo_ward_s, wo_diff)
        f_w = _eval_base(bs, idx, wi, wo_ward, refl_scale=refl_scale, active=active)
        p_w = _pdf_base(bs, idx, wi, wo_ward, refl_scale=refl_scale, active=active)
        w_ward = f_w / jnp.maximum(p_w, 1e-12)[..., None]
        wo_d[BSDF_WARD] = wo_ward
        w_d[BSDF_WARD] = w_ward
        p_d[BSDF_WARD] = p_w

    if _on(active, BSDF_ROUGHPLASTIC):
        # rough plastic: GGX specular w.p. F(ci), else cosine diffuse
        rp_spec = u1 < F
        wo_rp = jnp.where(rp_spec[..., None], wo_rough, wo_diff)
        f_rp = _eval_base(bs, idx, wi, wo_rp, refl_scale=refl_scale, active=active)
        p_rp = _pdf_base(bs, idx, wi, wo_rp, refl_scale=refl_scale, active=active)
        w_rp = f_rp / jnp.maximum(p_rp, 1e-12)[..., None]
        wo_d[BSDF_ROUGHPLASTIC] = wo_rp
        w_d[BSDF_ROUGHPLASTIC] = w_rp
        p_d[BSDF_ROUGHPLASTIC] = p_rp

    has_rd = _on(active, BSDF_ROUGHDIELECTRIC, BSDF_HROUGHDIELECTRIC)
    if has_rd:
        # rough dielectric (Walter): sample m, Fresnel-select branch
        m_rd = m  # GGX-sampled microfacet (already wi-side oriented)
        im = dot(wi, m_rd)
        F_rd, cos_t_rd = fresnel_dielectric(im, eta)
        rd_reflect = u1 < F_rd
        wo_rd_refl = 2.0 * im[..., None] * m_rd - wi
        eta_rel_rd = jnp.where(im > 0, eta, 1.0 / eta)
        inv_eta = 1.0 / eta_rel_rd
        # refract wi about m (Walter eq. 40)
        c = im
        sign_m = jnp.sign(c)
        cos_t_abs = safe_sqrt(1.0 - (1.0 - c * c) * inv_eta * inv_eta)
        wo_rd_tr = normalize(
            (inv_eta * jnp.abs(c) - cos_t_abs)[..., None] * (sign_m[..., None] * m_rd)
            - inv_eta[..., None] * wi)
        wo_rd = jnp.where(rd_reflect[..., None], wo_rd_refl, wo_rd_tr)
        G_rd = _ggx_g1(wi, m_rd, alpha) * _ggx_g1(wo_rd, m_rd, alpha)
        # Walter's weight: |wi.m| G / (|ci| |m.z|) — Fresnel cancels per branch
        w_scalar_rd = jnp.abs(im) * G_rd / jnp.maximum(
            jnp.abs(ci) * jnp.abs(cos_theta(m_rd)), 1e-12)
        w_rd = jnp.where(rd_reflect[..., None], spec_r,
                         spec_t * (inv_eta * inv_eta)[..., None]) \
            * w_scalar_rd[..., None]
        # total internal reflection: refraction branch invalid
        tir = cos_t_rd == 0.0
        w_rd = jnp.where((~rd_reflect & tir)[..., None], 0.0, w_rd)
        pdf_m_rd = _ggx_pdf_m(jnp.abs(m_rd), alpha)
        om_rd = dot(wo_rd, m_rd)
        denom_rd = im + eta_rel_rd * om_rd
        pdf_rd = jnp.where(
            rd_reflect,
            F_rd * pdf_m_rd / jnp.maximum(4.0 * jnp.abs(om_rd), 1e-12),
            (1.0 - F_rd) * pdf_m_rd * (eta_rel_rd * eta_rel_rd) * jnp.abs(om_rd)
            / jnp.maximum(denom_rd * denom_rd, 1e-12))
        eta_rd_out = jnp.where(rd_reflect, 1.0, eta_rel_rd)
        for k in (BSDF_ROUGHDIELECTRIC, BSDF_HROUGHDIELECTRIC):
            wo_d[k] = wo_rd
            w_d[k] = w_rd
            p_d[k] = pdf_rd

    # ---- select by kind ----
    def sel(vals):
        out = vals[BSDF_DIFFUSE]
        for k, v in vals.items():
            if k == BSDF_DIFFUSE:
                continue
            cond = kind == k
            out = jnp.where(
                cond[..., None] if v.ndim == out.ndim and out.ndim == 2 else cond, v, out
            )
        return out

    wo = sel(wo_d)
    weight = sel(w_d)
    pdf_out = sel(p_d)
    delta_kinds = (
        (kind == BSDF_DIELECTRIC) | (kind == BSDF_HDIELECTRIC)
        | (kind == BSDF_THINDIELECTRIC) | (kind == BSDF_CONDUCTOR)
        | (kind == BSDF_MIRROR) | (kind == BSDF_NULL)
    )
    delta = delta_kinds | ((kind == BSDF_PLASTIC) & spec_choice)
    if hk_delta is not None:
        delta = delta | ((kind == BSDF_HK) & hk_delta)
    eta_out = jnp.where(
        ((kind == BSDF_DIELECTRIC) | (kind == BSDF_HDIELECTRIC)) & ~reflect_choice,
        eta_diel,
        1.0,
    )
    if has_rd:
        is_rd_kind = (kind == BSDF_ROUGHDIELECTRIC) | (kind == BSDF_HROUGHDIELECTRIC)
        eta_out = jnp.where(is_rd_kind, eta_rd_out, eta_out)
    null_pass = kind == BSDF_NULL

    # mask.cpp: pass through unchanged with prob (1 - opacity). The selection
    # uniform is decorrelated from u1 by bit-mixing (opacity defaults to 1,
    # so ordinary materials never take this branch).
    if u_op is None:
        u_op = jnp.abs(u1 * 4096.0) % 1.0
    masked = u_op >= opacity
    wo = jnp.where(masked[..., None], -wi, wo)
    weight = jnp.where(masked[..., None], 1.0, weight)
    pdf_out = jnp.where(masked, jnp.maximum(1.0 - opacity, 1e-6), pdf_out)
    delta = delta | masked
    null_pass = null_pass | masked

    # invalid sample (zero weight) handling
    bad = jnp.all(weight == 0.0, axis=-1) | (pdf_out <= 0.0)
    weight = jnp.where(bad[..., None], 0.0, weight)
    return BSDFSample(
        wo=wo, weight=weight, pdf=pdf_out, delta=delta, eta=eta_out,
        null_passthrough=null_pass,
    )


# --------------------------------------------------------------------------
# Dielectric coating wrapper (coating.cpp / roughcoating.cpp): a smooth (or
# GGX-rough) dielectric layer of IOR `eta` over the nested BSDF `child0`,
# with absorption optical depth sigmaA*thickness packed in `specular_t`.
# Directions refract into the coat before hitting the nested BSDF
# (refractIn, coating.cpp:208) and the nested value/pdf pick up the
# invEta^2 cos(wo)/cos(wo') solid-angle compression (coating.cpp eval/pdf).
# --------------------------------------------------------------------------
def _refract_into(w, eta):
    """Map a direction to its continuation inside the coat (same side);
    returns (w_inside, Fresnel R, TIR). coating.cpp:208 refractIn."""
    cw = cos_theta(w)
    F, cos_t = fresnel_dielectric(jnp.abs(cw), eta)
    inv_eta = 1.0 / eta
    wp = jnp.stack([inv_eta * w[..., 0], inv_eta * w[..., 1],
                    -jnp.sign(cw) * cos_t], axis=-1)
    return wp, F, cos_t == 0.0


def _refract_outof(w, eta):
    """Coat -> exterior (refractOut, coating.cpp:215)."""
    cw = cos_theta(w)
    F, cos_t = fresnel_dielectric(jnp.abs(cw), 1.0 / eta)
    wp = jnp.stack([eta * w[..., 0], eta * w[..., 1],
                    -jnp.sign(cw) * cos_t], axis=-1)
    return wp, F, cos_t == 0.0


def _coat_rows(bs: BSDFs, idx):
    i = jnp.clip(idx, 0, bs.kind.shape[0] - 1)
    kind = jnp.where(idx >= 0, smalltab.take(bs.kind, i), BSDF_NULL)
    is_coat = (kind == BSDF_COATING) | (kind == BSDF_ROUGHCOATING)
    is_rough = kind == BSDF_ROUGHCOATING
    child = smalltab.take(bs.child0, i)
    eta = jnp.maximum(smalltab.take(bs.eta, i), 1.0 + 1e-4)
    spec_r = smalltab.take(bs.specular_r, i)
    sigd = smalltab.take(bs.specular_t, i)       # sigmaA * thickness
    alpha = smalltab.take(bs.alpha, i)
    child_refl = smalltab.take(bs.reflectance,
                               jnp.clip(child, 0, bs.kind.shape[0] - 1))
    sw = jnp.max(spec_r, axis=-1) / jnp.maximum(
        jnp.max(spec_r, axis=-1) + jnp.max(child_refl, axis=-1), 1e-12)
    return is_coat, is_rough, child, eta, spec_r, sigd, alpha, sw


def _coat_absorb(sigd, wip, wop):
    return jnp.exp(-sigd * (1.0 / jnp.maximum(abs_cos_theta(wip), 1e-6)
                            + 1.0 / jnp.maximum(abs_cos_theta(wop), 1e-6)
                            )[..., None])


def _coating_eval(bs: BSDFs, idx, wi, wo, f_base, active=None):
    is_coat, is_rough, child, eta, spec_r, sigd, alpha, _ = _coat_rows(
        bs, idx)
    wip, R12, t1 = _refract_into(wi, eta)
    wop, R21, t2 = _refract_into(wo, eta)
    f_n = _eval_base(bs, jnp.where(is_coat, child, -1), wip, wop,
                     active=active)
    conv = (1.0 / (eta * eta)) * jnp.abs(cos_theta(wo)) \
        / jnp.maximum(abs_cos_theta(wop), 1e-6)
    f_c = f_n * ((1.0 - R12) * (1.0 - R21) * conv)[..., None] \
        * _coat_absorb(sigd, wip, wop)
    f_c = jnp.where((t1 | t2)[..., None], 0.0, f_c)
    if _on(active, BSDF_ROUGHCOATING):
        # GGX specular reflection on the rough coat (roughcoating.cpp)
        ci, co = cos_theta(wi), cos_theta(wo)
        m = normalize(wi + wo)
        m = jnp.where((ci < 0)[..., None], -m, m)
        D = _ggx_d(m, alpha)
        G = _ggx_g1(wi, m, alpha) * _ggx_g1(wo, m, alpha)
        Fm = fresnel_dielectric(dot(wi, m), eta)[0]
        f_s = spec_r * (Fm * D * G
                        / jnp.maximum(4.0 * jnp.abs(ci), 1e-12))[..., None]
        f_c = jnp.where((is_rough & (ci * co > 0))[..., None], f_c + f_s,
                        f_c)
    return jnp.where(is_coat[..., None], f_c, f_base)


def _coating_pdf(bs: BSDFs, idx, wi, wo, p_base, active=None):
    is_coat, is_rough, child, eta, spec_r, sigd, alpha, sw = _coat_rows(
        bs, idx)
    wip, R12, t1 = _refract_into(wi, eta)
    wop, R21, t2 = _refract_into(wo, eta)
    prob_s = (R12 * sw) / jnp.maximum(
        R12 * sw + (1.0 - R12) * (1.0 - sw), 1e-9)
    p_n = _pdf_base(bs, jnp.where(is_coat, child, -1), wip, wop,
                    active=active)
    conv = (1.0 / (eta * eta)) * jnp.abs(cos_theta(wo)) \
        / jnp.maximum(abs_cos_theta(wop), 1e-6)
    p_c = p_n * conv * (1.0 - prob_s)
    p_c = jnp.where(t1 | t2, 0.0, p_c)
    if _on(active, BSDF_ROUGHCOATING):
        ci = cos_theta(wi)
        m = normalize(wi + wo)
        m = jnp.where((ci < 0)[..., None], -m, m)
        p_spec = _ggx_pdf_m(m, alpha) / jnp.maximum(
            4.0 * jnp.abs(dot(wo, m)), 1e-12)
        p_c = jnp.where(is_rough, p_c + prob_s * p_spec, p_c)
    return jnp.where(is_coat, p_c, p_base)


def _coating_sample(bs: BSDFs, idx, wi, u2, u1, res: "BSDFSample",
                    active=None) -> "BSDFSample":
    is_coat, is_rough, child, eta, spec_r, sigd, alpha, sw = _coat_rows(
        bs, idx)
    wip, R12, t1 = _refract_into(wi, eta)
    prob_s = (R12 * sw) / jnp.maximum(
        R12 * sw + (1.0 - R12) * (1.0 - sw), 1e-9)
    chose_s = u1 < prob_s
    u1r = jnp.clip((u1 - prob_s) / jnp.maximum(1.0 - prob_s, 1e-9),
                   0.0, 0.9999994)
    # --- nested branch: sample the child with the refracted incident ---
    res_n = _sample_base(bs, jnp.where(is_coat, child, -1), wip, u2, u1r,
                         active=active)
    wo_out, R21, t2 = _refract_outof(res_n.wo, eta)
    w_n = res_n.weight * ((1.0 - R12) * (1.0 - R21)
                          / jnp.maximum(1.0 - prob_s, 1e-9))[..., None] \
        * _coat_absorb(sigd, wip, res_n.wo)
    conv = (1.0 / (eta * eta)) * jnp.abs(cos_theta(wo_out)) \
        / jnp.maximum(abs_cos_theta(res_n.wo), 1e-6)
    p_nn = res_n.pdf * (1.0 - prob_s) * conv
    bad_n = t1 | t2
    w_n = jnp.where(bad_n[..., None], 0.0, w_n)
    # --- specular branch ---
    ci = cos_theta(wi)
    if _on(active, BSDF_ROUGHCOATING):
        m_s = _ggx_sample(alpha, u2)
        m_s = jnp.where((ci < 0)[..., None], -m_s, m_s)
    else:
        m_s = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]),
                               wi.shape).astype(wi.dtype)
        m_s = jnp.where((ci < 0)[..., None], -m_s, m_s)
    wo_s = 2.0 * dot(wi, m_s, keepdims=True) * m_s - wi
    wo_c = jnp.where(chose_s[..., None], wo_s, wo_out)
    smooth_spec = chose_s & ~is_rough
    if _on(active, BSDF_ROUGHCOATING):
        # non-delta: weight = f/p at the sampled direction
        f_all = _coating_eval(bs, idx, wi, wo_c, jnp.zeros_like(w_n),
                              active=active)
        p_all = _coating_pdf(bs, idx, wi, wo_c, jnp.zeros_like(p_nn),
                             active=active)
        w_rough_c = f_all / jnp.maximum(p_all, 1e-12)[..., None]
    else:
        w_rough_c = w_n
        p_all = p_nn
    w_spec_smooth = spec_r * (R12 / jnp.maximum(prob_s, 1e-9))[..., None]
    w_c = jnp.where(smooth_spec[..., None], w_spec_smooth,
                    jnp.where(is_rough[..., None], w_rough_c, w_n))
    p_c = jnp.where(smooth_spec, prob_s,
                    jnp.where(is_rough, p_all, p_nn))
    delta_c = jnp.where(smooth_spec, True,
                        jnp.where(is_rough, False, res_n.delta))
    bad = jnp.all(w_c == 0.0, axis=-1) | (p_c <= 0.0)
    w_c = jnp.where(bad[..., None], 0.0, w_c)
    return BSDFSample(
        wo=jnp.where(is_coat[..., None], wo_c, res.wo),
        weight=jnp.where(is_coat[..., None], w_c, res.weight),
        pdf=jnp.where(is_coat, p_c, res.pdf),
        delta=jnp.where(is_coat, delta_c, res.delta),
        eta=jnp.where(is_coat, 1.0, res.eta),
        null_passthrough=jnp.where(is_coat, False, res.null_passthrough),
    )


# --------------------------------------------------------------------------
# Public API: base lobes + one level of wrapper kinds
# (twosided.cpp, mixturebsdf.cpp/blendbsdf.cpp, coating.cpp)
# --------------------------------------------------------------------------
def _eval_full(bs, idx, wi, wo, eta_override=None, refl_scale=None,
               active=None):
    f = _eval_base(bs, idx, wi, wo, eta_override, refl_scale, active)
    if _on(active, BSDF_COATING, BSDF_ROUGHCOATING):
        f = _coating_eval(bs, idx, wi, wo, f, active)
    return f


def _pdf_full(bs, idx, wi, wo, eta_override=None, refl_scale=None,
              active=None):
    p = _pdf_base(bs, idx, wi, wo, eta_override, refl_scale, active)
    if _on(active, BSDF_COATING, BSDF_ROUGHCOATING):
        p = _coating_pdf(bs, idx, wi, wo, p, active)
    return p


def eval(bs: BSDFs, idx, wi, wo, eta_override=None, refl_scale=None,
         active=None):
    idx_a, idx_b, w_a, wi2, flip = _wrapper_resolve(bs, idx, wi, active)
    wo2 = jnp.where(flip[..., None], wo * _FLIP_Z, wo)
    f = _eval_full(bs, idx_a, wi2, wo2, eta_override, refl_scale, active)
    if _on(active, BSDF_MIXTURE):
        f_b = _eval_full(bs, idx_b, wi2, wo2, eta_override, refl_scale,
                         active)
        f = w_a[..., None] * f + (1.0 - w_a)[..., None] * f_b
    return f


def pdf(bs: BSDFs, idx, wi, wo, eta_override=None, refl_scale=None,
        active=None):
    idx_a, idx_b, w_a, wi2, flip = _wrapper_resolve(bs, idx, wi, active)
    wo2 = jnp.where(flip[..., None], wo * _FLIP_Z, wo)
    p = _pdf_full(bs, idx_a, wi2, wo2, eta_override, refl_scale, active)
    if _on(active, BSDF_MIXTURE):
        p_b = _pdf_full(bs, idx_b, wi2, wo2, eta_override, refl_scale,
                        active)
        p = w_a * p + (1.0 - w_a) * p_b
    return p


def sample(bs: BSDFs, idx, wi, u2, u1, eta_override=None,
           refl_scale=None, active=None, u_op=None) -> BSDFSample:
    idx_a, idx_b, w_a, wi2, flip = _wrapper_resolve(bs, idx, wi, active)
    if _on(active, BSDF_MIXTURE):
        # one-sample MIS over the two children: pick A w.p. w_a, reuse the
        # rescaled selection uniform for the child's own lobe choice
        pick_a = u1 < w_a
        u1r = jnp.where(pick_a, u1 / jnp.maximum(w_a, 1e-9),
                        (u1 - w_a) / jnp.maximum(1.0 - w_a, 1e-9))
        # non-mixture lanes keep their original u1 stream
        i0 = jnp.clip(idx, 0, bs.kind.shape[0] - 1)
        is_mix = jnp.where(idx >= 0, smalltab.take(bs.kind, i0),
                           BSDF_NULL) == BSDF_MIXTURE
        u1_eff = jnp.where(is_mix, jnp.minimum(u1r, 0.9999994), u1)
        c_idx = jnp.where(is_mix, jnp.where(pick_a, idx_a, idx_b), idx_a)
        res = _sample_base(bs, c_idx, wi2, u2, u1_eff, eta_override,
                           refl_scale, active, u_op)
        # smooth-lobe lanes: MIS-combined weight f_mix / p_mix; delta
        # lanes keep the picked child's weight (the other child's f is
        # a.s. zero there) with pdf scaled by the pick probability
        f_mix = eval(bs, idx, wi, jnp.where(flip[..., None],
                                            res.wo * _FLIP_Z, res.wo),
                     eta_override, refl_scale, active)
        p_mix = pdf(bs, idx, wi, jnp.where(flip[..., None],
                                           res.wo * _FLIP_Z, res.wo),
                    eta_override, refl_scale, active)
        pick_p = jnp.where(pick_a, w_a, 1.0 - w_a)
        wt = jnp.where((is_mix & ~res.delta)[..., None],
                       f_mix / jnp.maximum(p_mix, 1e-12)[..., None],
                       res.weight)
        pp = jnp.where(is_mix,
                       jnp.where(res.delta, res.pdf * pick_p, p_mix),
                       res.pdf)
        res = res._replace(weight=wt, pdf=pp)
    else:
        res = _sample_base(bs, idx_a, wi2, u2, u1, eta_override,
                           refl_scale, active, u_op)
    if _on(active, BSDF_COATING, BSDF_ROUGHCOATING):
        res = _coating_sample(bs, idx_a, wi2, u2, u1, res, active)
    wo_out = jnp.where(flip[..., None], res.wo * _FLIP_Z, res.wo)
    return res._replace(wo=wo_out)
