"""Specular manifold walks (libbidir SpecularManifold, manifold.cpp:35).

The reference solves for chains of specular vertices between two fixed
endpoints by Newton iteration on the specular constraint manifold, with
hand-derived derivative blocks. Array-program redesign of the core machinery, in
miniature: a batched Newton walk for a single specular vertex (reflection
or refraction) on an analytic surface (sphere or plane), with the 2x2
tangent-space Jacobian obtained by forward-mode AD (`jax.jacfwd`) instead
of manifold.cpp's manual chain — the generalized half-vector constraint
(Walter et al.) is

    C(u) = [h . t1, h . t2],   h = normalize(wa + eta * wb),

where u parametrizes the surface, wa/wb are unit vectors from the vertex
x(u) to the endpoints and (t1, t2) the tangent frame at x(u). C = 0 iff h
is parallel to the surface normal, i.e. Snell/mirror holds (eta = 1 for
reflection).

`solve_specular_vertex` handles one vertex; `solve_specular_chain` (r5)
handles V-vertex chains by Newton on the stacked (2V)-dim constraint with
an AD Jacobian and Levenberg damping — the machinery the reference's MLT
manifold perturbation drives (mut_manifold.cpp). Consumers: exact
specular/caustic connections (manifold-NEE, tests/test_manifold.py
validates the two-refraction glass-sphere chain against ray tracing) and
the erpt/pssmlt chain family.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .math import dot, normalize

SURF_SPHERE = 0
SURF_PLANE = 1


class ManifoldResult(NamedTuple):
    x: jnp.ndarray          # (N, 3) solved specular vertex
    n: jnp.ndarray          # (N, 3) surface normal at x
    converged: jnp.ndarray  # (N,)
    resid: jnp.ndarray      # (N,) final |C|


def _surface_point(kind, params, u):
    """x(u) and tangent frame for the parametrized surface.

    sphere: params = (cx, cy, cz, R); u = (theta, phi)
    plane:  params = (px, py, pz, nx, ny, nz); u = offsets along tangents
    """
    if kind == SURF_SPHERE:
        c = params[..., :3]
        R = params[..., 3]
        st, ct = jnp.sin(u[..., 0]), jnp.cos(u[..., 0])
        sp, cp = jnp.sin(u[..., 1]), jnp.cos(u[..., 1])
        n = jnp.stack([st * cp, st * sp, ct], axis=-1)
        x = c + R[..., None] * n
        t1 = jnp.stack([ct * cp, ct * sp, -st], axis=-1)
        t2 = jnp.stack([-sp, cp, jnp.zeros_like(sp)], axis=-1)
        return x, n, t1, t2
    # plane
    p0 = params[..., :3]
    n = normalize(params[..., 3:6])
    a = jnp.where(jnp.abs(n[..., :1]) < 0.9,
                  jnp.asarray([1.0, 0.0, 0.0]), jnp.asarray([0.0, 1.0, 0.0]))
    t1 = normalize(jnp.cross(n, jnp.broadcast_to(a, n.shape)))
    t2 = jnp.cross(n, t1)
    x = p0 + u[..., :1] * t1 + u[..., 1:2] * t2
    return x, n, t1, t2


def _constraint(kind, params, u, a, b, eta):
    x, n, t1, t2 = _surface_point(kind, params, u)
    wa = normalize(a - x)
    wb = normalize(b - x)
    # generalized half vector; eta = ior ratio across the boundary as seen
    # from the `a` side (1 = mirror reflection)
    h = wa + eta[..., None] * wb
    h = h / jnp.maximum(jnp.linalg.norm(h, axis=-1, keepdims=True), 1e-12)
    return jnp.stack([dot(h, t1), dot(h, t2)], axis=-1)


def solve_specular_vertex(kind: int, params, a, b, eta, u0,
                          iters: int = 16, tol: float = 1e-6,
                          damping: float = 1.0) -> ManifoldResult:
    """Batched Newton walk for one specular vertex between endpoints a, b.

    kind: SURF_SPHERE | SURF_PLANE (static). params: (N, 4|6). eta: (N,)
    relative IOR (1 = reflection). u0: (N, 2) initial surface parameters.
    """
    a = jnp.asarray(a, jnp.float32)
    b = jnp.asarray(b, jnp.float32)
    eta = jnp.broadcast_to(jnp.asarray(eta, jnp.float32), a.shape[:-1])

    def C_single(u, prm, aa, bb, ee):
        return _constraint(kind, prm[None], u[None], aa[None], bb[None],
                           ee[None])[0]

    jac = jax.vmap(jax.jacfwd(C_single), in_axes=(0, 0, 0, 0, 0))
    Cv = jax.vmap(C_single, in_axes=(0, 0, 0, 0, 0))

    def body(i, u):
        c = Cv(u, params, a, b, eta)
        J = jac(u, params, a, b, eta)           # (N, 2, 2)
        det = J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]
        ok = jnp.abs(det) > 1e-14
        inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
        du0 = (J[..., 1, 1] * c[..., 0] - J[..., 0, 1] * c[..., 1]) * inv_det
        du1 = (-J[..., 1, 0] * c[..., 0] + J[..., 0, 0] * c[..., 1]) * inv_det
        step = jnp.stack([du0, du1], axis=-1)
        return u - damping * step

    u = jax.lax.fori_loop(0, iters, body, jnp.asarray(u0, jnp.float32))
    resid = jnp.linalg.norm(Cv(u, params, a, b, eta), axis=-1)
    x, n, _, _ = _surface_point(kind, params, u)
    return ManifoldResult(x=x, n=n, converged=resid < tol, resid=resid)


class ChainResult(NamedTuple):
    x: jnp.ndarray          # (N, V, 3) solved specular vertices
    n: jnp.ndarray          # (N, V, 3) surface normals
    converged: jnp.ndarray  # (N,)
    resid: jnp.ndarray      # (N,) final |C|


def _chain_constraint(kinds, params, u, a, b, etas):
    """Stacked constraint for a V-vertex chain (single lane): rows 2i..2i+1
    are the generalized half-vector tangentials at vertex i with neighbors
    x_{i-1}, x_{i+1} (x_{-1} = a, x_{V} = b). manifold.cpp computes the
    same residual with hand-derived blocks; here the (2V,2V) Jacobian comes
    from forward-mode AD of this function."""
    V = len(kinds)
    xs, ns, t1s, t2s = [], [], [], []
    for i, k in enumerate(kinds):
        x, nrm, t1, t2 = _surface_point(k, params[i][None], u[i][None])
        xs.append(x[0])
        ns.append(nrm[0])
        t1s.append(t1[0])
        t2s.append(t2[0])
    rows = []
    for i in range(V):
        prev = a if i == 0 else xs[i - 1]
        nxt = b if i == V - 1 else xs[i + 1]
        wa = normalize(prev - xs[i])
        wb = normalize(nxt - xs[i])
        h = wa + etas[i] * wb
        h = h / jnp.maximum(jnp.linalg.norm(h), 1e-12)
        rows.append(jnp.stack([dot(h, t1s[i]), dot(h, t2s[i])]))
    return jnp.concatenate(rows)                          # (2V,)


def solve_specular_chain(kinds, params, a, b, etas, u0,
                         iters: int = 24, tol: float = 1e-6,
                         damping: float = 1.0) -> ChainResult:
    """Batched Newton walk for a CHAIN of V specular vertices between fixed
    endpoints a, b (SpecularManifold::move, manifold.cpp:35 — the machinery
    under the MLT manifold perturbation, mut_manifold.cpp).

    kinds: static tuple of SURF_* per vertex. params: (N, V, P) surface
    params. etas: (N, V) IOR ratios (1 = mirror). u0: (N, V, 2)."""
    V = len(kinds)
    a = jnp.asarray(a, jnp.float32)
    b = jnp.asarray(b, jnp.float32)
    etas = jnp.asarray(etas, jnp.float32)

    def C_flat(uf, prm, aa, bb, ee):
        return _chain_constraint(kinds, prm, uf.reshape(V, 2), aa, bb, ee)

    jac = jax.vmap(jax.jacfwd(C_flat), in_axes=(0, 0, 0, 0, 0))
    Cv = jax.vmap(C_flat, in_axes=(0, 0, 0, 0, 0))

    uf0 = jnp.asarray(u0, jnp.float32).reshape(a.shape[0], V * 2)

    def cost(uf):
        c = Cv(uf, params, a, b, etas)
        return jnp.sum(c * c, axis=-1)

    def body(i, uf):
        c = Cv(uf, params, a, b, etas)                    # (N, 2V)
        J = jac(uf, params, a, b, etas)                   # (N, 2V, 2V)
        # damped pseudo-solve: (J^T J + lam I)^-1 J^T c keeps rank-deficient
        # configurations (grazing chains) from exploding
        JT = jnp.swapaxes(J, -1, -2)
        # full f32 products: a GPU may run DEFAULT-precision f32 dots in TF32
        A = jnp.matmul(JT, J, precision=jax.lax.Precision.HIGHEST) \
            + 1e-9 * jnp.eye(2 * V)
        g = jnp.einsum("...ij,...j->...i", JT, c,
                       precision=jax.lax.Precision.HIGHEST)
        step = jnp.linalg.solve(A, g[..., None])[..., 0]
        # backtracking line search (SpecularManifold::move's step-size
        # control): a raw Newton step overshoots chains whose constraint
        # is strongly nonlinear and diverges — take the largest scale in
        # {1, 1/2, 1/4, 1/10} that decreases |C|^2, else stay put
        c0 = jnp.sum(c * c, axis=-1)
        best_u = uf
        best_c = c0
        for sc in (1.0, 0.5, 0.25, 0.1, 0.03, 0.01):
            u_t = uf - (damping * sc) * step
            c_t = cost(u_t)
            take = c_t < best_c
            best_u = jnp.where(take[..., None], u_t, best_u)
            best_c = jnp.where(take, c_t, best_c)
        return best_u

    uf = jax.lax.fori_loop(0, iters, body, uf0)
    resid = jnp.linalg.norm(Cv(uf, params, a, b, etas), axis=-1)
    u = uf.reshape(a.shape[0], V, 2)
    xs, ns = [], []
    for i, k in enumerate(kinds):
        x, nrm, _, _ = _surface_point(k, params[:, i], u[:, i])
        xs.append(x)
        ns.append(nrm)
    return ChainResult(x=jnp.stack(xs, axis=1), n=jnp.stack(ns, axis=1),
                       converged=resid < tol, resid=resid)


def sphere_init(params, a, b):
    """Chord-midpoint projection: a robust u0 for sphere surfaces."""
    c = params[..., :3]
    m = normalize(0.5 * (a + b) - c)
    theta = jnp.arccos(jnp.clip(m[..., 2], -1.0, 1.0))
    phi = jnp.arctan2(m[..., 1], m[..., 0])
    return jnp.stack([theta, phi], axis=-1)
