"""Eikonal core: curved-ray marching through a continuously varying
refractive-index field (RIF) and curved next-event estimation.

Reference: src/medium/heterogeneousrefractive.cpp (1284 LoC) — the research
contribution of MitsubaER ("Path tracing estimators for refractive radiative
transfer", TOG 2020). Rays obey the eikonal ODE d/ds(n dx/ds) = grad n; with
scaled velocity v (|v| = n) one velocity-Verlet step of size h is

    v += h/2 grad n(p);  p += h v / n(p);  v += h/2 grad n(p)
    optical_length += h n                       (er_step, :653-669)

Curved NEE solves a boundary value problem for the initial velocity v0 that
connects a medium vertex to a target point: the reference uses Ceres BFGS
over the endpoint error with forward-sensitivity Jacobians dp/dv0, dv/dv0
propagated alongside the ray (er_derivativestep, :798-814, needs the RIF
Hessian). Here the solver is a batched damped Newton (Levenberg) iteration —
every pending connection in the wavefront iterates in lockstep;
failures are russian-rouletted exactly like the reference (:1146-1155).

RIF backends: analytic fields (constant / linear / radial-Gaussian /
ultrasound Bessel, covering the reference's scene generators
mfiles/createLinearRIFWithBox.m + src/volume/acousticrifvolume.cpp) evaluate
closed-form value/gradient/Hessian — the fast path; general
voxel grids use the cubic B-spline interpolator (core/spline.py ==
basisspline.h) and are the differentiable path for RIF reconstruction.

Inside-tests: analytic sphere/box SDFs (replacing the reference's
hardcoded hackForSphere/hackForBox, :707-726, and the UT_SolidAngle winding
numbers) or a B-spline SDF grid (splinevolume.cpp usage).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import kernels as kernels_m
from ..core import spline
from ..core.math import dot, length, normalize, safe_sqrt, sgn
from ..scene.types import Media

# The 3x3 products below feed Newton solves and gradients: keep them in
# full f32 (a GPU runs DEFAULT-precision f32 dots in TF32).
_HI = jax.lax.Precision.HIGHEST

# RIF kinds (media.rif_kind)
RIF_CONST = 0
RIF_LINEAR = 1    # n = p0 + g . p                      params [p0, gx, gy, gz]
RIF_RADIAL = 2    # n = p0 + a exp(-|p-c|^2 / w^2)      params [p0, a, w, cx, cy, cz]
RIF_ACOUSTIC = 3  # n = p0 + nmax J_mode(kr r_perp) cos(mode phi), beam +x;
#                   params [p0, nmax, kr, mode] (modes 0..4)
RIF_SPLINE = 4    # cubic B-spline over rif_coeff

# SDF kinds (media.sdf_kind)
SDF_NONE = 0
SDF_SPHERE = 1    # params [cx, cy, cz, radius]
SDF_BOX = 2       # params [cx, cy, cz, hx, hy, hz]
SDF_SPLINE = 3


# ---------------------------------------------------------------------------
# Bessel J0/J1 (Abramowitz & Stegun rational approximations, public domain)
# for the ultrasound RIF (acousticrifvolume.cpp:243-315)
# ---------------------------------------------------------------------------
def bessel_j0(x):
    """J0 via power series (|x| < 8) + leading asymptotic expansion."""
    ax = jnp.abs(x)
    small = ax < 8.0
    xs = jnp.where(small, ax, 0.0)
    q = -0.25 * xs * xs
    term = jnp.ones_like(xs)
    acc = jnp.ones_like(xs)
    for k in range(1, 24):
        term = term * q / (k * k)
        acc = acc + term
    z = jnp.maximum(ax, 8.0)
    iz2 = 1.0 / (z * z)
    P = 1.0 - 0.0703125 * iz2 + 0.1121520996 * iz2 * iz2
    Q = -0.125 / z + 0.0732421875 / (z * z * z)
    xx = z - 0.78539816339
    big = jnp.sqrt(0.63661977236 / z) * (jnp.cos(xx) * P - jnp.sin(xx) * Q)
    return jnp.where(small, acc, big)


def bessel_jm(m_static: int, x):
    """J_m for a STATIC small integer order (acoustic RIF modes 0..4,
    acousticrifvolume.cpp jn(mode, .)): small-|x| power series + upward
    recurrence from J0/J1 for large arguments (stable for x > m)."""
    if m_static == 0:
        return bessel_j0(x)
    if m_static == 1:
        return bessel_j1(x)
    ax = jnp.abs(x)
    # power series around 0: J_m(x) = sum_k (-1)^k (x/2)^(2k+m)/(k!(k+m)!)
    small = ax < 4.0
    xs = jnp.where(small, ax, 0.0)
    q = -0.25 * xs * xs
    import math
    term = (0.5 * xs) ** m_static / math.factorial(m_static)
    acc = term
    for k in range(1, 18):
        term = term * q / (k * (k + m_static))
        acc = acc + term
    # upward recurrence J_{m+1} = (2m/x) J_m - J_{m-1}
    xb = jnp.maximum(ax, 4.0)
    jm1, jm = bessel_j0(xb), bessel_j1(xb)
    for mm in range(1, m_static):
        jm1, jm = jm, (2.0 * mm / xb) * jm - jm1
    val = jnp.where(small, acc, jm)
    if m_static % 2 == 1:
        val = val * jnp.sign(x)
    return val


def bessel_j1(x):
    """J1 via power series (|x| < 8) + leading asymptotic expansion."""
    ax = jnp.abs(x)
    small = ax < 8.0
    xs = jnp.where(small, ax, 0.0)
    q = -0.25 * xs * xs
    term = 0.5 * xs
    acc = term
    for k in range(1, 24):
        term = term * q / (k * (k + 1))
        acc = acc + term
    z = jnp.maximum(ax, 8.0)
    iz2 = 1.0 / (z * z)
    P = 1.0 + 0.1171875 * iz2 - 0.1441955566 * iz2 * iz2
    Q = 0.375 / z - 0.1025390625 / (z * z * z)
    xx = z - 2.35619449019
    big = jnp.sqrt(0.63661977236 / z) * (jnp.cos(xx) * P - jnp.sin(xx) * Q)
    val = jnp.where(small, acc, big)
    return val * jnp.sign(x)


# ---------------------------------------------------------------------------
# RIF evaluation (value / gradient / Hessian)
# ---------------------------------------------------------------------------
class RifField(NamedTuple):
    kind: jnp.ndarray     # () int32
    params: jnp.ndarray   # (8,)
    coeff: jnp.ndarray    # spline coefficients (nz, ny, nx)
    aabb_min: jnp.ndarray
    aabb_max: jnp.ndarray
    kinds: tuple = ()     # static: the RIF kinds `kind` can take; only
    #                       these branches are compiled (() = all kinds)


# `kinds` is static pytree metadata, not a leaf: it selects code at trace time
jax.tree_util.register_pytree_node(
    RifField,
    lambda f: ((f.kind, f.params, f.coeff, f.aabb_min, f.aabb_max), f.kinds),
    lambda kinds, ch: RifField(*ch, kinds=kinds))


def rif_from_media(media: Media, kinds: tuple = ()) -> RifField:
    """kinds: RenderConfig.rif_kinds (the scene's static RIF kind set)."""
    return RifField(
        kind=media.rif_kind,
        params=media.rif_params,
        coeff=media.rif_coeff,
        aabb_min=media.rif_min,
        aabb_max=media.rif_max,
        kinds=tuple(kinds),
    )


def _rif_analytic(kind, prm, p, need_hess: bool, kinds: tuple = ()):
    """Closed-form value/grad/Hessian for analytic RIF kinds (batched).
    Only the kinds in `kinds` (all if empty) are compiled: the acoustic
    branch alone is most of an eikonal program's size."""
    def on(k):
        return not kinds or k in kinds

    n = p.shape[0]
    zero3 = jnp.zeros((n, 3), jnp.float32)
    zero33 = jnp.zeros((n, 3, 3), jnp.float32)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (n, 3, 3))

    # constant (also the value of kinds without a closed form here)
    val = jnp.full((n,), prm[0])
    grad = zero3
    H = zero33

    if on(RIF_LINEAR):
        g_vec = prm[1:4]
        v_l = prm[0] + jnp.dot(p, g_vec, precision=_HI)
        val = jnp.where(kind == RIF_LINEAR, v_l, val)
        grad = jnp.where(kind == RIF_LINEAR, jnp.broadcast_to(g_vec, (n, 3)),
                         grad)

    if on(RIF_RADIAL):
        # radial gaussian: n0 + a exp(-r^2/w^2)
        c = prm[3:6]
        w2 = jnp.maximum(prm[2] * prm[2], 1e-12)
        dp = p - c
        r2 = dot(dp, dp)
        e = prm[1] * jnp.exp(-r2 / w2)
        g_r = (-2.0 / w2) * e[..., None] * dp
        val = jnp.where(kind == RIF_RADIAL, prm[0] + e, val)
        grad = jnp.where(kind == RIF_RADIAL, g_r, grad)
        if need_hess:
            H_r = (-2.0 / w2) * (
                e[..., None, None] * eye
                + dp[..., :, None] * g_r[..., None, :]
            )
            H = jnp.where(kind == RIF_RADIAL, H_r, H)

    if not on(RIF_ACOUSTIC):
        return val, grad, (H if need_hess else None)

    # acoustic: n0 + nmax J_mode(kr r_perp) cos(mode phi), r_perp/phi in the
    # y-z plane, beam along +x (acousticrifvolume.cpp:240-330 — arbitrary
    # Bessel mode with azimuthal dependence; phi = atan2(y, z) as upstream).
    # Value + gradient in closed form; Hessian by forward-mode jacobian of
    # the closed-form gradient (exact, and immune to the long hand
    # expansion upstream uses).
    kr = prm[2]
    A_ac = prm[1]
    mode_f = prm[3]

    def _ac_grad(yzv):
        y, z = yzv[..., 0], yzv[..., 1]
        rr = jnp.maximum(jnp.sqrt(y * y + z * z), 1e-6)
        phi = jnp.arctan2(y, z)
        xx = kr * rr
        jms = [bessel_jm(m, xx) for m in range(6)]
        Jm = jms[0] * 0.0
        dJm = Jm
        cmp_ = Jm
        smp_ = Jm
        for m in range(5):
            selm = mode_f == m
            Jm = jnp.where(selm, jms[m], Jm)
            dJ = (m / jnp.maximum(xx, 1e-9)) * jms[m] - jms[m + 1]
            dJm = jnp.where(selm, dJ, dJm)
            cmp_ = jnp.where(selm, jnp.cos(m * phi), cmp_)
            smp_ = jnp.where(selm, jnp.sin(m * phi), smp_)
        invr = 1.0 / rr
        gy = A_ac * (dJm * kr * y * invr * cmp_
                     - Jm * mode_f * smp_ * z * invr * invr)
        gz = A_ac * (dJm * kr * z * invr * cmp_
                     + Jm * mode_f * smp_ * y * invr * invr)
        return jnp.stack([gy, gz], axis=-1), (Jm, cmp_)

    yz = p[..., 1:3]
    g_yz, (Jm_v, cmp_v) = _ac_grad(yz)
    v_a = prm[0] + A_ac * Jm_v * cmp_v
    g_a = jnp.concatenate([jnp.zeros_like(g_yz[..., :1]), g_yz], axis=-1)
    val = jnp.where(kind == RIF_ACOUSTIC, v_a, val)
    grad = jnp.where(kind == RIF_ACOUSTIC, g_a, grad)
    if not need_hess:
        return val, grad, None
    H_yz = jax.vmap(jax.jacfwd(lambda w: _ac_grad(w[None])[0][0]))(yz)
    H_a = zero33.at[..., 1:, 1:].set(0.5 * (H_yz
                                            + jnp.swapaxes(H_yz, -1, -2)))
    return val, grad, jnp.where(kind == RIF_ACOUSTIC, H_a, H)


def rif_value(f: RifField, p):
    v, _, _ = _rif_analytic(f.kind, f.params, p, False, f.kinds)
    if f.coeff.size > 1:
        grid = spline.SplineGrid3D(f.coeff, f.aabb_min, f.aabb_max)
        v = jnp.where(f.kind == RIF_SPLINE, spline.value(grid, p), v)
    return v


def rif_value_grad(f: RifField, p):
    v, g, _ = _rif_analytic(f.kind, f.params, p, False, f.kinds)
    if f.coeff.size > 1:
        grid = spline.SplineGrid3D(f.coeff, f.aabb_min, f.aabb_max)
        vs, gs = spline.value_gradient(grid, p)
        sel = f.kind == RIF_SPLINE
        v = jnp.where(sel, vs, v)
        g = jnp.where(sel, gs, g)
    return v, g


def rif_value_grad_hess(f: RifField, p):
    v, g, H = _rif_analytic(f.kind, f.params, p, True, f.kinds)
    if f.coeff.size > 1:
        grid = spline.SplineGrid3D(f.coeff, f.aabb_min, f.aabb_max)
        vs, gs, Hs = spline.value_gradient_hessian(grid, p)
        sel = f.kind == RIF_SPLINE
        v = jnp.where(sel, vs, v)
        g = jnp.where(sel, gs, g)
        H = jnp.where(sel, Hs, H)
    return v, g, H


# ---------------------------------------------------------------------------
# Inside-tests (SDF)
# ---------------------------------------------------------------------------
class SdfField(NamedTuple):
    kind: jnp.ndarray     # () int32
    params: jnp.ndarray   # (8,)
    coeff: jnp.ndarray
    aabb_min: jnp.ndarray
    aabb_max: jnp.ndarray


def sdf_from_media(media: Media) -> SdfField:
    return SdfField(
        kind=media.sdf_kind,
        params=media.sdf_params,
        coeff=media.sdf_coeff,
        aabb_min=media.sdf_min,
        aabb_max=media.sdf_max,
    )


def sdf_value(f: SdfField, p):
    """Signed distance, negative inside."""
    c = f.params[0:3]
    dp = p - c
    v_sph = length(dp) - f.params[3]
    q = jnp.abs(dp) - f.params[3:6]
    v_box = length(jnp.maximum(q, 0.0)) + jnp.minimum(jnp.max(q, axis=-1), 0.0)
    v = jnp.where(f.kind == SDF_SPHERE, v_sph, jnp.full(p.shape[:-1], 1.0))
    v = jnp.where(f.kind == SDF_BOX, v_box, v)
    if f.coeff.size > 1:
        grid = spline.SplineGrid3D(f.coeff, f.aabb_min, f.aabb_max)
        v = jnp.where(f.kind == SDF_SPLINE, spline.value(grid, p), v)
    return v


def sdf_gradient(f: SdfField, p):
    c = f.params[0:3]
    dp = p - c
    g_sph = normalize(dp)
    q = jnp.abs(dp) - f.params[3:6]
    outside = jnp.maximum(q, 0.0)
    g_box_out = normalize(outside * sgn(dp))
    # inside the box: gradient along the closest face axis
    ax = jnp.argmax(q, axis=-1)
    g_box_in = jax.nn.one_hot(ax, 3, dtype=dp.dtype) * sgn(dp)
    g_box = jnp.where(jnp.any(q > 0, axis=-1)[..., None], g_box_out, g_box_in)
    g = jnp.where((f.kind == SDF_SPHERE)[..., None], g_sph, g_box)
    if f.coeff.size > 1:
        grid = spline.SplineGrid3D(f.coeff, f.aabb_min, f.aabb_max)
        _, gs = spline.value_gradient(grid, p)
        g = jnp.where((f.kind == SDF_SPLINE)[..., None], gs, g)
    return g


def inside_shape(f: SdfField, p):
    return sdf_value(f, p) < 0.0


# ---------------------------------------------------------------------------
# Curved-ray marching
# ---------------------------------------------------------------------------
def er_step(rif: RifField, p, v, h):
    """One velocity-Verlet step (er_step, heterogeneousrefractive.cpp:653).
    h may be per-lane (N,). Returns (p, v, d_optical)."""
    hh = h[..., None] if jnp.ndim(h) else h
    n0, g0 = rif_value_grad(rif, p)
    v = v + 0.5 * hh * g0
    p = p + hh * v / n0[..., None]
    _, g1 = rif_value_grad(rif, p)
    v = v + 0.5 * hh * g1
    return p, v, h * n0


def _er_kernel_on(rif: RifField, sdf: SdfField, differentiable: bool,
                  kernels: str) -> bool:
    """Static part of the ER-march kernel gate: the route chosen by
    core/kernels.py, forward-only, analytic (non-spline) RIF and SDF. The
    RIF *kind* is a runtime value — callers pair this with a lax.cond on
    kind <= RIF_RADIAL so acoustic lanes take the XLA path
    (models/ermarch.py scope)."""
    return (kernels_m.route(kernels) == kernels_m.TRITON
            and not differentiable and rif.coeff.size <= 1
            and sdf.coeff.size <= 1)


def trace_curved(rif: RifField, sdf: SdfField, p, v, distance, h,
                 max_steps: int, active, differentiable: bool = False,
                 kernels: str = "auto"):
    """March a batch of curved rays a given arc distance, stopping at the
    medium boundary (trace(), :671-691). Returns
    (p, v, optical_len, dist_marched, exited, steps).

    With analytic RIF/SDF on the kernel route the march runs in the Pallas
    kernel (models/ermarch.py): an XLA while_loop pays a round of kernel
    launches and a predicate read-back per velocity-Verlet step."""
    if _er_kernel_on(rif, sdf, differentiable, kernels):
        from . import ermarch

        def _kern(_):
            return ermarch.trace(rif, sdf, p, v, distance, h, max_steps,
                                 active)

        def _xla(_):
            return _trace_curved_xla(rif, sdf, p, v, distance, h,
                                     max_steps, active, differentiable)

        return jax.lax.cond(rif.kind <= RIF_RADIAL, _kern, _xla, None)
    return _trace_curved_xla(rif, sdf, p, v, distance, h, max_steps,
                             active, differentiable)


def _trace_curved_xla(rif: RifField, sdf: SdfField, p, v, distance, h,
                      max_steps: int, active, differentiable: bool = False):
    from .medium import bounded_while

    n = p.shape[0]

    def cond(st):
        running = st[4]
        it = st[6]
        return jnp.any(running) & (it < max_steps)

    def body(st):
        p, v, opt, marched, running, exited, it = st
        remaining = distance - marched
        step = jnp.minimum(h, jnp.maximum(remaining, 0.0))
        p2, v2, dopt = er_step(rif, p, v, step)
        out = ~inside_shape(sdf, p2)
        # exited lanes roll back to the last inside position (the reference
        # steps back, :684; the boundary refinement happens in the caller)
        take = running & ~out
        stop_out = running & out
        p = jnp.where(take[..., None], p2, p)
        v = jnp.where(take[..., None], v2, v)
        opt = jnp.where(take, opt + dopt, opt)
        marched = jnp.where(take, marched + step, marched)
        done = take & (marched >= distance - 1e-7)
        running = running & ~out & ~done
        exited = exited | stop_out
        return (p, v, opt, marched, running, exited, it + 1)

    st = (p, v, jnp.zeros((n,), p.dtype), jnp.zeros((n,), p.dtype), active,
          jnp.zeros((n,), bool), jnp.int32(0))
    p, v, opt, marched, _, exited, steps = bounded_while(
        cond, body, st, max_steps, differentiable
    )
    return p, v, opt, marched, exited, steps


def refine_boundary(rif: RifField, sdf: SdfField, p, v, h, n_bisect: int = 10):
    """Bisection refinement to the boundary from the last inside point
    (traceTillBoundary / computefdf boundary handling). Returns
    (p_boundary, v_boundary, extra_opt, extra_dist)."""
    def body(i, st):
        p, v, opt, adv, step = st
        step = step * 0.5
        p2, v2, dopt = er_step(rif, p, v, step)
        ok = inside_shape(sdf, p2)
        p = jnp.where(ok[..., None], p2, p)
        v = jnp.where(ok[..., None], v2, v)
        opt = jnp.where(ok, opt + dopt, opt)
        adv = jnp.where(ok, adv + step, adv)
        return (p, v, opt, adv, step)

    n = p.shape[0]
    st = (p, v, jnp.zeros((n,), p.dtype), jnp.zeros((n,), p.dtype),
          jnp.broadcast_to(jnp.asarray(h, p.dtype), (n,)))
    p, v, opt, adv, _ = jax.lax.fori_loop(0, n_bisect, body, st)
    return p, v, opt, adv


def boundary_velocity(v, N, n_in, n_out):
    """Snell refraction of the scaled velocity at the boundary
    (boundaryVelocity, :1036-1051): v' = v - (v.N)N + sgn(v.N) sqrt((
    (n_out/n_in)^2-1)|v|^2 + (v.N)^2) N; reflects on TIR."""
    dotp = dot(v, N)
    r = (n_out / n_in) ** 2 - 1.0
    n2 = dot(v, v)
    sq = r * n2 + dotp * dotp
    tir = sq < 1e-9
    sq_s = safe_sqrt(sq)
    v_refr = v - dotp[..., None] * N + (sgn(dotp) * sq_s)[..., None] * N
    # physical mirror reflection on TIR (the reference's `2 dotp N - v`,
    # :1045, reverses the ray direction; we keep tangential momentum)
    v_refl = v - 2.0 * dotp[..., None] * N
    return jnp.where(tir[..., None], v_refl, v_refr), tir


# ---------------------------------------------------------------------------
# Forward-sensitivity step (for the BVP Jacobian)
# ---------------------------------------------------------------------------
def er_derivative_step(rif: RifField, p, v, dpdv0, dvdv0, h):
    """er_derivativestep (:798-814): leapfrog + propagation of the 3x3
    sensitivities of (p, v) w.r.t. the initial velocity."""
    hh = h[..., None] if jnp.ndim(h) else h
    hhm = hh[..., None] if jnp.ndim(h) else h
    n0, g0, H0 = rif_value_grad_hess(rif, p)
    v = v + 0.5 * hh * g0
    dvdv0 = dvdv0 + 0.5 * hhm * jnp.einsum("...ij,...jk->...ik", H0, dpdv0,
                                             precision=_HI)
    p = p + hh * v / n0[..., None]
    n1, g1, H1 = rif_value_grad_hess(rif, p)
    invn = 1.0 / n1
    # d(p step) = h [ -1/n^2 v (g . dpdv0) + 1/n dvdv0 ]
    vg = jnp.einsum("...i,...j->...ij", v, g1)
    dpdv0 = dpdv0 + hhm * (
        -(invn * invn)[..., None, None]
        * jnp.einsum("...ij,...jk->...ik", vg, dpdv0, precision=_HI)
        + invn[..., None, None] * dvdv0
    )
    v = v + 0.5 * hh * g1
    dvdv0 = dvdv0 + 0.5 * hhm * jnp.einsum("...ij,...jk->...ik", H1, dpdv0,
                                             precision=_HI)
    return p, v, dpdv0, dvdv0


def integrate_with_sensitivities(rif: RifField, sdf: SdfField, p1, v0, p2,
                                 h, max_steps: int, active,
                                 differentiable: bool = False,
                                 kernels: str = "auto"):
    """computefdfBDPT core (:816-939): integrate from p1 with initial scaled
    velocity v0 until passing the plane where (p - p2) . v changes sign or
    exiting the shape; returns endpoint error + its Jacobian w.r.t. v0.

    Exit-through-boundary lanes refract (sensor-side connection support,
    :1036-1074) and extrapolate to the closest point to p2."""
    from .medium import bounded_while

    n = p1.shape[0]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (n, 3, 3))

    # normalize v0 magnitude to the local index (|v| = n(p1)), propagating
    # the projection Jacobian (:846-851)
    r0 = rif_value(rif, p1)
    nv = length(v0)
    dvdv0 = (r0 / jnp.maximum(nv, 1e-12) ** 3)[..., None, None] * (
        (nv ** 2)[..., None, None] * eye
        - jnp.einsum("...i,...j->...ij", v0, v0)
    )
    v = v0 / jnp.maximum(nv, 1e-12)[..., None] * r0[..., None]
    dpdv0 = jnp.zeros((n, 3, 3), p1.dtype)

    def sign_of(p, v):
        return dot(p - p2, v) < 0

    def cond(st):
        running = st[6]
        it = st[8]
        return jnp.any(running) & (it < max_steps)

    def body(st):
        p, v, dp_, dv_, opt, marched, running, crossed, it = st
        p2_, v2_, dp2, dv2 = er_derivative_step(rif, p, v, dp_, dv_, h)
        out = ~inside_shape(sdf, p2_)
        flip = sign_of(p2_, v2_) != sign_of(p, v)
        stop = out | flip
        take = running & ~stop
        n_here = rif_value(rif, p)
        p = jnp.where(take[..., None], p2_, p)
        v = jnp.where(take[..., None], v2_, v)
        dp_ = jnp.where(take[..., None, None], dp2, dp_)
        dv_ = jnp.where(take[..., None, None], dv2, dv_)
        opt = jnp.where(take, opt + h * n_here, opt)
        marched = jnp.where(take, marched + h, marched)
        crossed = crossed | (running & out)
        running = running & ~stop
        return (p, v, dp_, dv_, opt, marched, running, crossed, it + 1)

    def _march_xla(_):
        st = (p1, v, dpdv0, dvdv0, jnp.zeros((n,), p1.dtype),
              jnp.zeros((n,), p1.dtype), active,
              jnp.zeros((n,), bool), jnp.int32(0))
        pp, vv, dp_, dv_, opt_, mar_, _, ex_, _ = bounded_while(
            cond, body, st, max_steps, differentiable
        )
        return pp, vv, dp_, dv_, opt_, mar_, ex_

    if _er_kernel_on(rif, sdf, differentiable, kernels):
        from . import ermarch

        def _march_kern(_):
            return ermarch.sens_march(rif, sdf, p1, v, dpdv0, dvdv0, p2,
                                      h, max_steps, active)

        p, v, dpdv0, dvdv0, opt, marched, exited = jax.lax.cond(
            rif.kind <= RIF_RADIAL, _march_kern, _march_xla, None)
    else:
        p, v, dpdv0, dvdv0, opt, marched, exited = _march_xla(None)

    # boundary handling for exited lanes: refract, then extrapolate straight
    N_b = normalize(sdf_gradient(sdf, p))
    nb = rif_value(rif, p)
    # dt_b/dv0 from the implicit boundary condition (:920-927)
    dpdt_b = v / nb[..., None]
    denom = jnp.where(jnp.abs(dot(N_b, dpdt_b)) > 1e-9, dot(N_b, dpdt_b), 1e9)
    dtbdv0 = -jnp.einsum("...i,...ij->...j", N_b, dpdv0,
                         precision=_HI) / denom[..., None]
    _, g_b = rif_value_grad(rif, p)
    v_refr, tir = boundary_velocity(v, N_b, nb, jnp.ones_like(nb))
    # refraction Jacobian (boundaryVelocityDerivative, :1057-1074)
    dotp = dot(v, N_b)
    r = 1.0 / jnp.maximum(nb, 1e-9) ** 2 - 1.0
    sq = safe_sqrt(jnp.maximum(r * dot(v, v) + dotp * dotp, 1e-12))
    NN = jnp.einsum("...i,...j->...ij", N_b, N_b)
    eye3 = eye
    inner = dvdv0 + jnp.einsum("...i,...j->...ij", g_b, dtbdv0)
    refr_J = jnp.einsum(
        "...ij,...jk->...ik",
        eye3 - NN + sgn(dotp)[..., None, None] * jnp.einsum(
            "...i,...j->...ij", N_b,
            (r[..., None] * v + dotp[..., None] * N_b) / sq[..., None],
        ),
        inner, precision=_HI,
    )
    refl_J = jnp.einsum("...ij,...jk->...ik", eye3 - 2.0 * NN, inner,
                        precision=_HI)
    dvdv0_b = jnp.where(tir[..., None, None], refl_J, refr_J)

    extra_t = -dot(v_refr, p - p2) / jnp.maximum(dot(v_refr, v_refr), 1e-12)
    p_ext = p + extra_t[..., None] * v_refr
    dpdv0_b = (
        dpdv0
        + jnp.einsum("...i,...j->...ij", dpdt_b - v_refr, dtbdv0)
        + extra_t[..., None, None] * dvdv0_b
    )

    # interior lanes: change of variables to the closest point on the ray
    # w.r.t. p2 (:924-938)
    n_end, dvdt_in = rif_value_grad(rif, p)
    dpdt_in = v / n_end[..., None]
    dpdt = jnp.where(exited[..., None], v_refr, dpdt_in)
    dvdt = jnp.where(exited[..., None], jnp.zeros_like(dvdt_in), dvdt_in)
    v_eff = jnp.where(exited[..., None], v_refr, v)
    dpdv0_eff = jnp.where(exited[..., None, None], dpdv0_b, dpdv0)
    dvdv0_eff = jnp.where(exited[..., None, None], dvdv0_b, dvdv0)
    num = (
        jnp.einsum("...i,...ij->...j", v_eff, dpdv0_eff, precision=_HI)
        + jnp.einsum("...i,...ij->...j", p - p2, dvdv0_eff, precision=_HI)
    )
    den = dot(v_eff, dpdt) + dot(p - p2, dvdt)
    dtstar = -num / jnp.where(jnp.abs(den) > 1e-9, den, 1e9)[..., None]

    # move the interior endpoint to the closest point of approach to p2
    # along dp/dt (the dtstar Jacobian already accounts for this motion)
    tstar_in = -dot(p - p2, dpdt_in) / jnp.maximum(dot(dpdt_in, dpdt_in), 1e-12)
    p_in = p + tstar_in[..., None] * dpdt_in
    opt = jnp.where(exited, opt + extra_t, opt + tstar_in * n_end)
    # geometric lengths: inside-medium arc (absorption) vs total connection
    # (inverse-square falloff) — conflating them makes near-boundary scatter
    # vertices produce unbounded 1/geo^2 fireflies
    geo_inside = jnp.where(exited, marched, marched + tstar_in)
    geo_total = jnp.where(exited, marched + extra_t, marched + tstar_in)

    p_final = jnp.where(exited[..., None], p_ext, p_in)
    err = p_final - p2
    J = dpdv0_eff + jnp.einsum("...i,...j->...ij", dpdt, dtstar)
    return err, J, exited, opt, geo_inside, geo_total, v_eff


# ---------------------------------------------------------------------------
# Batched BVP solve (replaces Ceres BFGS, :1087-1163)
# ---------------------------------------------------------------------------
class BVPResult(NamedTuple):
    dir_to_target: jnp.ndarray  # (N, 3) unit initial direction
    converged: jnp.ndarray      # (N,)
    weight: jnp.ndarray         # (N,) RR / multiplicity weight
    opt_len: jnp.ndarray        # (N,) optical connection length
    geo_inside: jnp.ndarray     # (N,) curved arc length inside the medium
    geo_total: jnp.ndarray      # (N,) full connection length (falloff)
    rev_dir: jnp.ndarray        # (N, 3) -normalize(v) at arrival


def _solve33(A, b):
    """Batched 3x3 solve by the adjugate (Cramer): pure elementwise
    arithmetic — cheaper than the batched-LU path of jnp.linalg.solve."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c01 + a02 * c02
    ok = jnp.abs(det) > 1e-30
    inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    x0 = (c00 * b[..., 0] + c01 * b[..., 1] + c02 * b[..., 2]) * inv_det
    x1 = (c10 * b[..., 0] + c11 * b[..., 1] + c12 * b[..., 2]) * inv_det
    x2 = (c20 * b[..., 0] + c21 * b[..., 1] + c22 * b[..., 2]) * inv_det
    return jnp.stack([x0, x1, x2], axis=-1)


def _levenberg_solve(rif: RifField, sdf: SdfField, p1, p2, v0, h,
                     max_steps: int, active, tol2: float,
                     max_iters: int = 12, kernels: str = "auto"):
    """Convergence-masked Levenberg-Marquardt over the endpoint error with
    real accept/reject (replaces Ceres line-search BFGS, options :215-227):
    a trial step is kept only if it decreases the cost; rejected steps
    re-damp and retry from the incumbent. The whole batch iterates in
    lockstep and the loop exits as soon as every active lane converged or
    stalled. Returns (v, cost) at the best point found."""
    n = p1.shape[0]
    eyeb = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (n, 3, 3))

    def eval_err(v, act):
        err, J, *_ = integrate_with_sensitivities(
            rif, sdf, p1, v, p2, h, max_steps, act, differentiable=False,
            kernels=kernels)
        return err, J

    def lm_step(err, J, lam):
        JT = jnp.swapaxes(J, -1, -2)
        A = jnp.einsum("...ij,...jk->...ik", JT, J, precision=_HI)
        A = A + (lam[..., None, None] + 1e-9) * eyeb
        b = -jnp.einsum("...ij,...j->...i", JT, err, precision=_HI)
        return _solve33(A, b)

    err0, J0 = eval_err(v0, active)
    cost0 = dot(err0, err0)
    lam0 = jnp.full((n,), 1e-3, cost0.dtype)
    running = active & (cost0 >= tol2)
    v_trial = v0 + lm_step(err0, J0, lam0)

    def cond(st):
        return jnp.any(st[6]) & (st[7] < max_iters)

    def body(st):
        v_cur, err_cur, J_cur, cost_cur, lam, v_trial, running, it = st
        err_t, J_t = eval_err(v_trial, running)
        cost_t = dot(err_t, err_t)
        better = cost_t < cost_cur
        acc = running & better
        v_cur = jnp.where(acc[..., None], v_trial, v_cur)
        err_cur = jnp.where(acc[..., None], err_t, err_cur)
        J_cur = jnp.where(acc[..., None, None], J_t, J_cur)
        cost_cur = jnp.where(acc, cost_t, cost_cur)
        lam = jnp.where(running,
                        jnp.where(better, lam * 0.33, lam * 6.0), lam)
        lam = jnp.clip(lam, 1e-8, 1e3)
        running = running & (cost_cur >= tol2)
        dv = lm_step(err_cur, J_cur, lam)
        v_trial = jnp.where(running[..., None], v_cur + dv, v_trial)
        return (v_cur, err_cur, J_cur, cost_cur, lam, v_trial, running,
                it + 1)

    st = (v0, err0, J0, cost0, lam0, v_trial, running, jnp.int32(0))
    v_fin, _, _, cost_fin, _, _, _, _ = jax.lax.while_loop(cond, body, st)
    return v_fin, cost_fin


def _restart_uniform(seed_bits, round_idx, dim):
    from ..core import rng as _rng
    bits = _rng._hash_u32(
        seed_bits
        + jnp.uint32(round_idx) * jnp.uint32(0x85EBCA6B)
        + jnp.uint32(dim) * jnp.uint32(0xC2B2AE35))
    return _rng._u32_to_float(bits)


def solve_bvp(rif: RifField, sdf: SdfField, p1, p2, init_dir, h,
              max_steps: int, active, tol2: float = 1e-6,
              newton_iters: int = 12, differentiable: bool = False,
              rr_weight: float = 1e-2, seed_bits=None,
              max_restarts: int = 0, dir_match_tol2: float = 1e-4,
              kernels: str = "auto"):
    """Solve the curved-connection BVP for the initial velocity p1 -> p2.

    With max_restarts == 0 (or no seed_bits): a single deterministic solve
    from `init_dir`; the returned weight is 1 and the caller owns retries.

    With max_restarts > 0: the reference's full makeDirectConnections loop
    (heterogeneousrefractive.cpp:1087-1163) —
      * every attempt restarts from a uniform hemisphere direction around
        the chord (uniformSample, :1078-1084);
      * a failed solve is russian-rouletted: continue with prob rr_weight
        and weight /= rr_weight, else give up (:1146-1155);
      * the first converged solution is only accepted once an independent
        restart re-finds it within 2*tol2 ("Zeltner test", :1121-1138);
      * solution multiplicity is compensated by weight *= (iterations - 1)
        where iterations counts converged solves + 1 (:1160) — the Booth
        [2007] expectation estimator for the number of distinct solutions.
    """
    n = p1.shape[0]
    if differentiable:
        # Differentiate the connection's TRANSPORT quantities but not the
        # solved direction: run the Newton iteration on fully detached
        # inputs (reverse AD prunes it entirely — differentiating through
        # linalg.solve chains is NaN-prone and wasteful), then do one
        # attached final integration. Dropping d(direction)/d(RIF) is exact
        # for the optical-length gradient: by Fermat's principle the optical
        # path length is stationary w.r.t. path perturbations at the
        # solution. (The reference computes no parameter gradients at all;
        # its dp/dv0 machinery only solves the BVP, SURVEY.md §2.9.)
        sg = jax.lax.stop_gradient
        res_sg = solve_bvp(
            jax.tree.map(sg, rif), jax.tree.map(sg, sdf), sg(p1), sg(p2),
            sg(init_dir), h, max_steps, active, tol2=tol2,
            newton_iters=newton_iters, differentiable=False,
            rr_weight=rr_weight, seed_bits=seed_bits,
            max_restarts=max_restarts, dir_match_tol2=dir_match_tol2,
            kernels=kernels,
        )
        v_fin_sg = res_sg.dir_to_target
        r0 = rif_value(rif, p1)
        err, _, exited, opt, geo_in, geo_tot, v_end = integrate_with_sensitivities(
            rif, sdf, p1, v_fin_sg * r0[..., None], p2, h, max_steps, active,
            differentiable=True,
        )
        cost = dot(jax.lax.stop_gradient(err), jax.lax.stop_gradient(err))
        converged = active & (cost < tol2) & res_sg.converged
        return BVPResult(
            dir_to_target=v_fin_sg, converged=converged,
            weight=res_sg.weight, opt_len=opt, geo_inside=geo_in,
            geo_total=geo_tot, rev_dir=-normalize(v_end),
        )

    r0 = rif_value(rif, p1)

    if max_restarts <= 0 or seed_bits is None:
        # legacy single-shot solve from init_dir (weight 1, caller retries)
        v_fin, cost = _levenberg_solve(
            rif, sdf, p1, p2, init_dir * r0[..., None], h, max_steps, active,
            tol2, max_iters=newton_iters, kernels=kernels)
        conv_final = active & (cost < tol2)
        d_final = normalize(v_fin)
        weight = jnp.ones((n,))
        iterations = jnp.ones((n,), jnp.int32)
    else:
        from ..core import warp as warp_m
        from ..core.math import Frame as _Frame

        frame_c = _Frame.from_normal(init_dir)
        # ---- r5: batched restart PREFIX + sequential tail ----
        # Every accepted connection needs at least TWO converged solves
        # (the first find + the Zeltner re-find), and each round's solve is
        # independent of history (round-indexed counter RNG) — so rounds 0
        # and 1 are solved as ONE width-2n batch (halving the dominant
        # sequential depth at zero wasted work for the common
        # find-then-refind case), and only the minority of lanes still
        # looping after round 1 pay the sequential while_loop tail.
        # (Batching ALL rounds was measured 4x SLOWER on the er bench: the
        # sequential loop already exits after ~2 rounds, so an R-wide batch
        # just multiplies work — BENCH history r5.)
        R = int(max_restarts)
        B = min(2, R)

        def round_dir(r):
            u1 = _restart_uniform(seed_bits, r, 0)
            u2 = _restart_uniform(seed_bits, r, 1)
            return frame_c.to_world(warp_m.square_to_uniform_hemisphere(
                jnp.stack([u1, u2], axis=-1)))

        tile = lambda a: jnp.concatenate([a] * B, axis=0)
        d0_all = jnp.concatenate([round_dir(r) for r in range(B)], axis=0)
        v_fin_all, cost_all = _levenberg_solve(
            rif, sdf, tile(p1), tile(p2), d0_all * tile(r0)[..., None],
            h, max_steps, tile(active), tol2, max_iters=newton_iters,
            kernels=kernels)
        conv_all = (cost_all < tol2).reshape(B, n) & active[None]
        d_all = normalize(v_fin_all).reshape(B, n, 3)

        looping = active
        iterations = jnp.ones((n,), jnp.int32)
        weight = jnp.ones((n,))
        have_first = jnp.zeros((n,), bool)
        first_dir = init_dir
        final_dir = init_dir
        conv_final = jnp.zeros((n,), bool)

        def bookkeep(st, conv_i_raw, d_i, r_idx):
            (looping, iterations, weight, have_first, first_dir, final_dir,
             conv_final) = st
            conv_i = looping & conv_i_raw
            new_first = conv_i & ~have_first
            first_dir = jnp.where(new_first[..., None], d_i, first_dir)
            have_first = have_first | new_first
            iterations = iterations + conv_i.astype(jnp.int32)
            # Zeltner/Booth consistency: accept once an independent restart
            # re-finds the first solution. The reference compares |ddir|^2
            # against 2*m_tol (:1134) — workable in its double-precision
            # eikonal math, but f32 LM solves of the SAME solution scatter
            # by ~1e-3 in direction, so a separate (looser) direction-match
            # tolerance is needed; distinct solutions separate by O(0.1-1).
            dd = first_dir - d_i
            refind = conv_i & ~new_first & (dot(dd, dd) < dir_match_tol2)
            final_dir = jnp.where(refind[..., None], d_i, final_dir)
            conv_final = conv_final | refind
            # failed solve: russian roulette the continuation
            fail = looping & ~conv_i
            u_rr = _restart_uniform(seed_bits, r_idx, 3)
            keep = u_rr < rr_weight
            weight = jnp.where(fail & keep, weight / rr_weight, weight)
            give_up = fail & ~keep
            looping = looping & ~refind & ~give_up
            return (looping, iterations, weight, have_first, first_dir,
                    final_dir, conv_final)

        st = (looping, iterations, weight, have_first, first_dir,
              final_dir, conv_final)
        for r in range(B):
            st = bookkeep(st, conv_all[r], d_all[r], r)

        if R > B:
            def rcond(c):
                return jnp.any(c[0][0]) & (c[1] < R)

            def rbody(c):
                st, r = c
                d0 = round_dir_dyn(r)
                v_fin, cost = _levenberg_solve(
                    rif, sdf, p1, p2, d0 * r0[..., None], h, max_steps,
                    st[0], tol2, max_iters=newton_iters, kernels=kernels)
                st = bookkeep(st, cost < tol2, normalize(v_fin), r)
                return (st, r + 1)

            def round_dir_dyn(r):
                u1 = _restart_uniform(seed_bits, r, 0)
                u2 = _restart_uniform(seed_bits, r, 1)
                return frame_c.to_world(
                    warp_m.square_to_uniform_hemisphere(
                        jnp.stack([u1, u2], axis=-1)))

            st, _ = jax.lax.while_loop(rcond, rbody, (st, jnp.int32(B)))
        (_, iterations, weight, _, _, d_final, conv_final, ) = st
        # Multiplicity compensation. `iterations` here = 1 (init) + number
        # of converged solves including the first find and the re-find, so
        # the Booth count "converged re-tries until the first solution is
        # re-found" is iterations-2; E[count] = 1/P(converged solve lands on
        # this solution), making the summed-over-solutions connection
        # unbiased. NOTE the reference source (:1121-1160) *intends* this
        # estimator but a missing brace in the else-branch makes dirToP2 be
        # assigned unconditionally, so it always breaks at the first
        # convergence with weight*1 — i.e. upstream multiplicity handling is
        # dead code. We implement the corrected estimator (validated by the
        # two-solution lens bias test in tests/test_volpath_er.py).
        weight = weight * jnp.maximum(iterations - 2, 1).astype(jnp.float32)

    # final geometric measurement at the accepted direction
    # (computePathLengthsTillClosestP2, :941-1030 — "can still fail")
    err, _, exited, opt, geo_in, geo_tot, v_end = integrate_with_sensitivities(
        rif, sdf, p1, d_final * r0[..., None], p2, h, max_steps, active,
        differentiable=differentiable, kernels=kernels,
    )
    cost = dot(err, err)
    converged = conv_final & (cost < tol2)
    rev = -normalize(v_end)
    return BVPResult(
        dir_to_target=d_final, converged=converged, weight=weight,
        opt_len=opt, geo_inside=geo_in, geo_total=geo_tot, rev_dir=rev,
    )
