"""Special math: quadrature, root finding, vMF, spherical harmonics, and a
chi-square goodness-of-fit harness.

Array-program port of the reference's libcore special math:
  - Gauss-Lobatto adaptive quadrature     (src/libcore/quad.cpp, 1433 LoC)
  - Brent's method root finding           (src/libcore/brent.cpp)
  - von Mises-Fisher distribution         (src/libcore/vmf.cpp)
  - real spherical harmonics              (src/libcore/shvector.cpp)
  - chi-square test statistic             (include/mitsuba/core/chisquare.h:81)

Design: the reference's adaptive quadrature recurses on sub-intervals until a
tolerance is met; data-dependent recursion does not map to XLA, so we expose a
*fixed-depth composite* Gauss-Lobatto rule — each jitted call evaluates the
integrand on a static set of nodes (batched over the last axis), which is how
every caller in the reference uses it (rough-transmittance tables, chi-square
cell integrals). Brent becomes a fixed-iteration bisection/inverse-quadratic
hybrid with masked convergence, vmapped over lanes.
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

# ---------------------------------------------------------------------------
# Gauss-Lobatto quadrature (quad.cpp gaussLobatto nodes, 7-point kernel)
# ---------------------------------------------------------------------------
# 7-point Gauss-Lobatto nodes/weights on [-1, 1] (degree-9 exactness);
# the same kernel rule the reference's adaptive GaussLobattoIntegrator uses.
_GL7_X = np.array([
    -1.0, -np.sqrt(5.0 / 11.0 + 2.0 / 11.0 * np.sqrt(5.0 / 3.0)),
    -np.sqrt(5.0 / 11.0 - 2.0 / 11.0 * np.sqrt(5.0 / 3.0)), 0.0,
    np.sqrt(5.0 / 11.0 - 2.0 / 11.0 * np.sqrt(5.0 / 3.0)),
    np.sqrt(5.0 / 11.0 + 2.0 / 11.0 * np.sqrt(5.0 / 3.0)), 1.0])
_GL7_W = np.array([
    1.0 / 21.0, (124.0 - 7.0 * np.sqrt(15.0)) / 350.0,
    (124.0 + 7.0 * np.sqrt(15.0)) / 350.0, 256.0 / 525.0,
    (124.0 + 7.0 * np.sqrt(15.0)) / 350.0,
    (124.0 - 7.0 * np.sqrt(15.0)) / 350.0, 1.0 / 21.0])


def gauss_lobatto(f: Callable, a, b, n_intervals: int = 16):
    """Composite 7-point Gauss-Lobatto integral of f over [a, b].

    f maps an array of nodes to integrand values (broadcasting over leading
    dims of a/b is supported). Fixed subdivision replaces the reference's
    adaptive recursion (quad.cpp:GaussLobattoIntegrator::integrate); accuracy
    is controlled by n_intervals (error ~ h^10 for smooth integrands)."""
    a = jnp.asarray(a, jnp.float32)
    b = jnp.asarray(b, jnp.float32)
    h = (b - a) / n_intervals
    edges = a[..., None] + h[..., None] * jnp.arange(n_intervals, dtype=jnp.float32)
    x01 = (jnp.asarray(_GL7_X, jnp.float32) + 1.0) * 0.5  # (7,) in [0,1]
    nodes = edges[..., :, None] + h[..., None, None] * x01  # (..., I, 7)
    vals = f(nodes)
    w = jnp.asarray(_GL7_W, jnp.float32) * 0.5
    return jnp.sum(vals * w, axis=(-1, -2)) * h


def simpson(f: Callable, a, b, n_intervals: int = 32):
    """Composite Simpson (the reference's integrateDensity rule,
    heterogeneous.cpp:301)."""
    a = jnp.asarray(a, jnp.float32)
    b = jnp.asarray(b, jnp.float32)
    n = 2 * n_intervals
    h = (b - a) / n
    i = jnp.arange(n + 1, dtype=jnp.float32)
    x = a[..., None] + h[..., None] * i
    w = jnp.where((i % 2) == 1, 4.0, 2.0).at[0].set(1.0).at[-1].set(1.0)
    return jnp.sum(f(x) * w, axis=-1) * h / 3.0


# ---------------------------------------------------------------------------
# Brent's method (brent.cpp BrentSolver::solve)
# ---------------------------------------------------------------------------
def brent(f: Callable, lo, hi, iters: int = 64, tol: float = 1e-7):
    """Vectorized Brent root find on [lo, hi] (f(lo), f(hi) must bracket).

    Returns (root, converged). Fixed `iters` with masked convergence replaces
    the reference's while-loop (brent.cpp); bisection/secant/IQI hybrid."""
    a = jnp.asarray(lo, jnp.float32)
    b = jnp.asarray(hi, jnp.float32)
    fa, fb = f(a), f(b)
    # ensure |f(b)| <= |f(a)| (b is the best guess)
    swap = jnp.abs(fa) < jnp.abs(fb)
    a, b = jnp.where(swap, b, a), jnp.where(swap, a, b)
    fa, fb = jnp.where(swap, fb, fa), jnp.where(swap, fa, fb)
    c, fc = a, fa
    mflag = jnp.ones_like(a, bool)
    d = a

    def body(state, _):
        a, b, c, d, fa, fb, fc, mflag = state
        done = jnp.abs(fb) < tol
        # inverse quadratic interpolation / secant
        use_iqi = (fa != fc) & (fb != fc)
        s_iqi = (a * fb * fc / jnp.where(use_iqi, (fa - fb) * (fa - fc), 1.0)
                 + b * fa * fc / jnp.where(use_iqi, (fb - fa) * (fb - fc), 1.0)
                 + c * fa * fb / jnp.where(use_iqi, (fc - fa) * (fc - fb), 1.0))
        s_sec = b - fb * (b - a) / jnp.where(fb != fa, fb - fa, 1.0)
        s = jnp.where(use_iqi, s_iqi, s_sec)
        lo_b = (3.0 * a + b) / 4.0
        cond_bisect = (
            ((s < jnp.minimum(lo_b, b)) | (s > jnp.maximum(lo_b, b)))
            | (mflag & (jnp.abs(s - b) >= jnp.abs(b - c) / 2.0))
            | (~mflag & (jnp.abs(s - b) >= jnp.abs(c - d) / 2.0))
            | (mflag & (jnp.abs(b - c) < tol))
            | (~mflag & (jnp.abs(c - d) < tol)))
        s = jnp.where(cond_bisect, (a + b) / 2.0, s)
        fs = f(s)
        d2, c2, fc2 = c, b, fb
        neg = fa * fs < 0
        a2 = jnp.where(neg, a, s)
        fa2 = jnp.where(neg, fa, fs)
        b2 = jnp.where(neg, s, b)
        fb2 = jnp.where(neg, fs, fb)
        swap2 = jnp.abs(fa2) < jnp.abs(fb2)
        a3 = jnp.where(swap2, b2, a2)
        b3 = jnp.where(swap2, a2, b2)
        fa3 = jnp.where(swap2, fb2, fa2)
        fb3 = jnp.where(swap2, fa2, fb2)
        new = (a3, b3, c2, d2, fa3, fb3, fc2, cond_bisect)
        out = tuple(jnp.where(done, o, n) for o, n in zip(state, new))
        return out, None

    state = (a, b, c, d, fa, fb, fc, mflag)
    state, _ = jax.lax.scan(body, state, None, length=iters)
    a, b, fb = state[0], state[1], state[5]
    return b, (jnp.abs(fb) < tol * 10.0) | (jnp.abs(b - a) < tol * 4.0 * (1.0 + jnp.abs(b)))


# ---------------------------------------------------------------------------
# von Mises-Fisher (vmf.cpp) — S2 distribution with concentration kappa
# ---------------------------------------------------------------------------
def vmf_pdf(cos_theta, kappa):
    """pdf over the sphere w.r.t. solid angle (vmf.cpp VonMisesFisherDistr::eval)."""
    kappa = jnp.asarray(kappa, jnp.float32)
    small = kappa < 1e-4
    k = jnp.where(small, 1.0, kappa)
    norm = k / (4.0 * jnp.pi * jnp.sinh(k))
    val = norm * jnp.exp(k * cos_theta)
    # numerically stable for large kappa: k e^{k(c-1)} / (2 pi (1 - e^{-2k}))
    stable = (k * jnp.exp(k * (cos_theta - 1.0))
              / (2.0 * jnp.pi * (1.0 - jnp.exp(-2.0 * k))))
    return jnp.where(small, 1.0 / (4.0 * jnp.pi),
                     jnp.where(kappa > 30.0, stable, val))


def vmf_sample(u1, u2, kappa):
    """Sample direction around +z (vmf.cpp::sample). Returns (N,3)."""
    kappa = jnp.maximum(jnp.asarray(kappa, jnp.float32), 1e-9)
    # stable inverse-CDF for cos(theta)
    w = 1.0 + jnp.log(u1 + (1.0 - u1) * jnp.exp(-2.0 * kappa)) / kappa
    st = jnp.sqrt(jnp.maximum(1.0 - w * w, 0.0))
    phi = 2.0 * jnp.pi * u2
    return jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), w], axis=-1)


def vmf_kappa_for_mean_cosine(r):
    """Banerjee approximation kappa(r) (vmf.cpp::forMeanCosine)."""
    r = jnp.asarray(r, jnp.float32)
    return r * (3.0 - r * r) / jnp.maximum(1.0 - r * r, 1e-9)


# ---------------------------------------------------------------------------
# Real spherical harmonics (shvector.cpp) — bands 0..3 explicit
# ---------------------------------------------------------------------------
def sh_eval(d, order: int = 3):
    """Real SH basis values at unit directions d (..., 3), bands 0..order-1
    (order<=4 supported, i.e. up to 16 coefficients), Condon-Shortley-free
    convention as in shvector.cpp."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    out = [jnp.full(x.shape, 0.28209479177387814)]
    if order > 1:
        out += [0.4886025119029199 * y,
                0.4886025119029199 * z,
                0.4886025119029199 * x]
    if order > 2:
        out += [1.0925484305920792 * x * y,
                1.0925484305920792 * y * z,
                0.31539156525252005 * (3.0 * z * z - 1.0),
                1.0925484305920792 * x * z,
                0.5462742152960396 * (x * x - y * y)]
    if order > 3:
        out += [
            0.5900435899266435 * y * (3 * x * x - y * y),
            2.890611442640554 * x * y * z,
            0.4570457994644658 * y * (5 * z * z - 1.0),
            0.3731763325901154 * z * (5 * z * z - 3.0),
            0.4570457994644658 * x * (5 * z * z - 1.0),
            1.445305721320277 * z * (x * x - y * y),
            0.5900435899266435 * x * (x * x - 3 * y * y),
        ]
    return jnp.stack(out, axis=-1)


def sh_project(fn: Callable, order: int = 3, res: int = 64):
    """Project fn(dirs)->(...,) onto SH coefficients by lat-long quadrature
    (shvector.cpp SHVector::project)."""
    theta = (jnp.arange(res, dtype=jnp.float32) + 0.5) / res * jnp.pi
    phi = (jnp.arange(2 * res, dtype=jnp.float32) + 0.5) / (2 * res) * 2.0 * jnp.pi
    T, P = jnp.meshgrid(theta, phi, indexing="ij")
    st = jnp.sin(T)
    d = jnp.stack([st * jnp.cos(P), st * jnp.sin(P), jnp.cos(T)], axis=-1)
    vals = fn(d.reshape(-1, 3)).reshape(res, 2 * res)
    basis = sh_eval(d.reshape(-1, 3), order).reshape(res, 2 * res, -1)
    dA = (jnp.pi / res) * (jnp.pi / res) * st  # sin(theta) dtheta dphi
    return jnp.sum(vals[..., None] * basis * dA[..., None], axis=(0, 1))


# ---------------------------------------------------------------------------
# Chi-square goodness-of-fit harness (chisquare.h:81)
# ---------------------------------------------------------------------------
def chi2_test(counts, expected, n_samples, min_exp_frequency: float = 5.0):
    """Pearson chi-square statistic with cell pooling, as in the reference's
    ChiSquare::runTest: cells with expected count < minExpFrequency are pooled
    into one. Returns (chi2, dof). Survival-function evaluation is left to
    the caller (tests use scipy-free thresholds)."""
    counts = np.asarray(counts, np.float64).ravel()
    expected = np.asarray(expected, np.float64).ravel() * n_samples
    keep = expected >= min_exp_frequency
    pooled_c = counts[~keep].sum()
    pooled_e = expected[~keep].sum()
    c = counts[keep]
    e = expected[keep]
    chi2 = float((((c - e) ** 2) / np.maximum(e, 1e-9)).sum())
    dof = int(keep.sum()) - 1
    if pooled_e > min_exp_frequency:
        chi2 += float((pooled_c - pooled_e) ** 2 / pooled_e)
        dof += 1
    return chi2, max(dof, 1)


def chi2_threshold(dof: int, significance: float = 0.0025) -> float:
    """Upper critical value via Wilson-Hilferty approximation (avoids a scipy
    dependency; accurate to ~1% for dof >= 3)."""
    from math import sqrt

    # inverse normal via Acklam rational approximation (central region ok)
    p = 1.0 - significance
    # rational approximation for the normal quantile
    a = [-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00]
    plow = 0.02425
    if p < plow:
        q = sqrt(-2 * np.log(p))
        z = (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
            ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    elif p <= 1 - plow:
        q = p - 0.5
        r = q * q
        z = (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q / \
            (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)
    else:
        q = sqrt(-2 * np.log(1 - p))
        z = -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
            ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    k = float(dof)
    return k * (1.0 - 2.0 / (9.0 * k) + z * sqrt(2.0 / (9.0 * k))) ** 3
