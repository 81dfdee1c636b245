"""Vector/geometry math substrate.

Array-program analogue of the reference's libcore math layer
(reference: include/mitsuba/core/{vector.h,normal.h,frame.h,util.h}).
Everything operates on trailing-dim-3 float32 arrays ("structure of arrays"
over ray batches) so that XLA fuses the whole shading pipeline; there are no
scalar Vector classes.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

Float = jnp.float32

EPSILON = 1e-4          # reference: mitsuba/core/constants.h Epsilon (float)
INV_PI = 0.3183098861837907
INV_TWOPI = 0.15915494309189535
INV_FOURPI = 0.07957747154594767
ONE_MINUS_EPS = 0.999999940395355225  # largest float < 1


def dot(a: jnp.ndarray, b: jnp.ndarray, keepdims: bool = False) -> jnp.ndarray:
    return jnp.sum(a * b, axis=-1, keepdims=keepdims)


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.cross(a, b)


def length(v: jnp.ndarray, keepdims: bool = False) -> jnp.ndarray:
    # the 1e-30 floor keeps sqrt' finite at 0 under reverse-mode AD
    return jnp.sqrt(jnp.maximum(dot(v, v, keepdims=keepdims), 1e-30))


def length_sq(v: jnp.ndarray, keepdims: bool = False) -> jnp.ndarray:
    return dot(v, v, keepdims=keepdims)


def normalize(v: jnp.ndarray) -> jnp.ndarray:
    """Safe normalize; returns v/|v| (zero vectors produce zeros, not NaN).
    The floor is applied INSIDE rsqrt so the backward pass stays finite."""
    l2 = dot(v, v, keepdims=True)
    return v * jax.lax.rsqrt(jnp.maximum(l2, 1e-24))


def safe_sqrt(x: jnp.ndarray) -> jnp.ndarray:
    # the tiny positive floor keeps sqrt' finite at 0 under reverse-mode AD
    # (e.g. cos_theta_t at exactly-critical TIR angles); forward error <= 1e-6
    return jnp.sqrt(jnp.maximum(x, 1e-12))


def safe_acos(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.arccos(jnp.clip(x, -1.0, 1.0))


def lerp(t, a, b):
    return a + t * (b - a)


def coordinate_system(n: jnp.ndarray):
    """Build an orthonormal basis (s, t) around unit vector n.

    Branchless Duff et al. / Frisvad construction (the reference uses
    coordinateSystem() in mitsuba/core/util.cpp; this variant is
    select-friendly for SIMD execution).
    Returns (s, t) with s x t = n for right-handed frames.
    """
    z = n[..., 2]
    sign = jnp.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = n[..., 0] * n[..., 1] * a
    s = jnp.stack(
        [1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0]],
        axis=-1,
    )
    t = jnp.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], axis=-1)
    return s, t


class Frame:
    """Shading frame helpers (reference: mitsuba/core/frame.h).

    Represented implicitly as (s, t, n) arrays; use `from_normal` to build.
    """

    def __init__(self, s, t, n):
        self.s, self.t, self.n = s, t, n

    @staticmethod
    def from_normal(n: jnp.ndarray) -> "Frame":
        s, t = coordinate_system(n)
        return Frame(s, t, n)

    def to_local(self, v: jnp.ndarray) -> jnp.ndarray:
        return jnp.stack([dot(v, self.s), dot(v, self.t), dot(v, self.n)], axis=-1)

    def to_world(self, v: jnp.ndarray) -> jnp.ndarray:
        return (
            v[..., 0:1] * self.s + v[..., 1:2] * self.t + v[..., 2:3] * self.n
        )


# Local-frame trigonometry (z = normal), reference frame.h:104-170
def cos_theta(v):
    return v[..., 2]


def abs_cos_theta(v):
    return jnp.abs(v[..., 2])


def sin_theta2(v):
    return jnp.maximum(1.0 - v[..., 2] * v[..., 2], 0.0)


def sin_theta(v):
    return jnp.sqrt(sin_theta2(v))


def tan_theta(v):
    return sin_theta(v) / jnp.where(v[..., 2] == 0, 1e-20, v[..., 2])


def reflect_local(wi):
    """Mirror reflection in the local frame: (-x, -y, z)."""
    return jnp.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], axis=-1)


def reflect(wi, n):
    """Reflect direction wi (pointing away from surface) about normal n."""
    return 2.0 * dot(wi, n, keepdims=True) * n - wi


def refract(wi, n, eta):
    """Refract wi (away from surface) through normal n with relative IOR eta
    (= int_ior/ext_ior when entering). Returns (wt, total_internal_reflection).

    Follows the convention of mitsuba/core/util.cpp refract(): cosThetaT has
    the opposite sign of cosThetaI.
    """
    cos_i = dot(wi, n, keepdims=True)
    eta_rel = jnp.where(cos_i > 0, eta, 1.0 / eta)
    cos_t2 = 1.0 - (1.0 - cos_i * cos_i) / (eta_rel * eta_rel)
    tir = cos_t2 <= 0.0
    cos_t = safe_sqrt(cos_t2)
    cos_t = jnp.where(cos_i > 0, -cos_t, cos_t)
    wt = -wi / eta_rel + (cos_i / eta_rel + cos_t) * n
    return normalize(wt), tir[..., 0]


def fresnel_dielectric(cos_theta_i, eta):
    """Unpolarized Fresnel reflectance for a dielectric.

    eta = int_ior/ext_ior. cos_theta_i may be signed (negative = exiting).
    Returns (F, cos_theta_t) where cos_theta_t carries the transmitted cosine
    with sign opposite to cos_theta_i (reference: libcore/util.cpp
    fresnelDielectricExt).
    """
    eta_rel = jnp.where(cos_theta_i > 0, eta, 1.0 / eta)
    # Snell
    sin_t2 = (1.0 - cos_theta_i * cos_theta_i) / (eta_rel * eta_rel)
    cos_t = safe_sqrt(1.0 - sin_t2)
    tir = sin_t2 > 1.0

    abs_ci = jnp.abs(cos_theta_i)
    rs = (abs_ci - eta_rel * cos_t) / jnp.where(
        abs_ci + eta_rel * cos_t == 0, 1.0, abs_ci + eta_rel * cos_t
    )
    rp = (eta_rel * abs_ci - cos_t) / jnp.where(
        eta_rel * abs_ci + cos_t == 0, 1.0, eta_rel * abs_ci + cos_t
    )
    F = 0.5 * (rs * rs + rp * rp)
    F = jnp.where(tir, 1.0, F)
    cos_theta_t = jnp.where(cos_theta_i > 0, -cos_t, cos_t)
    cos_theta_t = jnp.where(tir, 0.0, cos_theta_t)
    return F, cos_theta_t


def fresnel_conductor(cos_theta_i, eta, k):
    """Approximate unpolarized conductor Fresnel (reference:
    libcore/util.cpp fresnelConductorApprox / Exact). eta, k are (..., 3)."""
    ci = jnp.abs(cos_theta_i)[..., None]
    ci2 = ci * ci
    si2 = 1.0 - ci2
    eta2 = eta * eta
    k2 = k * k
    t0 = eta2 - k2 - si2
    a2b2 = safe_sqrt(t0 * t0 + 4.0 * eta2 * k2)
    t1 = a2b2 + ci2
    a = safe_sqrt(0.5 * (a2b2 + t0))
    t2 = 2.0 * a * ci
    rs2 = (t1 - t2) / (t1 + t2)
    t3 = ci2 * a2b2 + si2 * si2
    t4 = t2 * si2
    rp2 = rs2 * (t3 - t4) / (t3 + t4)
    return 0.5 * (rp2 + rs2)


def spherical_direction(theta, phi):
    st, ct = jnp.sin(theta), jnp.cos(theta)
    sp, cp = jnp.sin(phi), jnp.cos(phi)
    return jnp.stack([st * cp, st * sp, ct], axis=-1)


def spherical_coordinates(d):
    theta = safe_acos(d[..., 2])
    phi = jnp.arctan2(d[..., 1], d[..., 0])
    phi = jnp.where(phi < 0, phi + 2.0 * jnp.pi, phi)
    return theta, phi


def mis_weight_power(pdf_a, pdf_b):
    """Power heuristic (beta=2) as used by all reference integrators
    (e.g. src/integrators/path/path.cpp miWeight). The max() inside the
    division keeps the 0/0 branch NaN-free under reverse-mode AD."""
    pdf_a2 = pdf_a * pdf_a
    pdf_b2 = pdf_b * pdf_b
    denom = pdf_a2 + pdf_b2
    return jnp.where(denom > 0, pdf_a2 / jnp.maximum(denom, 1e-30), 0.0)


def sgn(x):
    return jnp.where(x >= 0, 1.0, -1.0)
