"""Cubic B-spline interpolation over 1/2/3-D uniform grids with analytic
value/gradient/Hessian (reference: mitsuba/core/basisspline.h, the
interpolation engine under the refractive-index field; Spline<3>::value /
gradient / hessian / valueAndGradient / valueGradientAndHessian at
basisspline.h:302-473).

Array-program redesign: coefficients are a dense (nz, ny, nx) array; a lookup gathers
the 4x4x4 coefficient neighborhood per query point and contracts it against
tensor-product basis weights — one fused XLA computation, batched over all
query points, no pointer chasing. The interpolation *prefilter* (turning grid
samples into B-spline coefficients so the spline passes through the data,
reference basisspline.h build()) runs host-side in numpy at scene build time.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# Prefilter (host side): samples -> B-spline coefficients.
# Classic Unser-style recursive filtering with pole z1 = sqrt(3) - 2.
# ---------------------------------------------------------------------------
_POLE = np.sqrt(3.0) - 2.0


def _prefilter_axis(data: np.ndarray, axis: int) -> np.ndarray:
    c = np.moveaxis(np.asarray(data, np.float64), axis, 0).copy()
    n = c.shape[0]
    if n == 1:
        return np.moveaxis(c, 0, axis)
    z = _POLE
    lam = (1.0 - z) * (1.0 - 1.0 / z)
    c *= lam
    # causal init (mirror boundary, truncated sum)
    horizon = min(n, max(12, int(np.ceil(np.log(1e-9) / np.log(abs(z))))))
    zn = z
    c0 = c[0].copy()
    for k in range(1, horizon):
        c0 += zn * c[k]
        zn *= z
    c[0] = c0
    for k in range(1, n):
        c[k] += z * c[k - 1]
    # anticausal init
    c[n - 1] = (z / (z * z - 1.0)) * (z * c[n - 2] + c[n - 1])
    for k in range(n - 2, -1, -1):
        c[k] = z * (c[k + 1] - c[k])
    return np.moveaxis(c, 0, axis)


def prefilter(data: np.ndarray) -> np.ndarray:
    """Convert grid samples to interpolating cubic B-spline coefficients."""
    out = np.asarray(data, np.float64)
    for ax in range(out.ndim):
        out = _prefilter_axis(out, ax)
    return out.astype(np.float32)


# ---------------------------------------------------------------------------
# Basis functions: weights for coefficients at offsets (-1, 0, 1, 2) relative
# to the cell index, with local coordinate t in [0, 1).
# (reference basisspline.h kernel<0|1|2>, :40-91)
# ---------------------------------------------------------------------------
def _bspline_w(t):
    t2 = t * t
    t3 = t2 * t
    w0 = (1.0 - 3.0 * t + 3.0 * t2 - t3) * (1.0 / 6.0)
    w1 = (4.0 - 6.0 * t2 + 3.0 * t3) * (1.0 / 6.0)
    w2 = (1.0 + 3.0 * t + 3.0 * t2 - 3.0 * t3) * (1.0 / 6.0)
    w3 = t3 * (1.0 / 6.0)
    return jnp.stack([w0, w1, w2, w3], axis=-1)


def _bspline_dw(t):
    t2 = t * t
    w0 = (-1.0 + 2.0 * t - t2) * 0.5
    w1 = (-4.0 * t + 3.0 * t2) * 0.5
    w2 = (1.0 + 2.0 * t - 3.0 * t2) * 0.5
    w3 = t2 * 0.5
    return jnp.stack([w0, w1, w2, w3], axis=-1)


def _bspline_d2w(t):
    w0 = 1.0 - t
    w1 = -2.0 + 3.0 * t
    w2 = 1.0 - 3.0 * t
    w3 = t
    return jnp.stack([w0, w1, w2, w3], axis=-1)


class SplineGrid3D(NamedTuple):
    """B-spline field over an axis-aligned box. coeff is (nz, ny, nx)."""

    coeff: jnp.ndarray      # (nz, ny, nx) float32
    aabb_min: jnp.ndarray   # (3,) world-space box min (x, y, z)
    aabb_max: jnp.ndarray   # (3,)

    @property
    def res(self):
        nz, ny, nx = self.coeff.shape
        return (nx, ny, nz)

    @staticmethod
    def from_samples(data_zyx: np.ndarray, aabb_min, aabb_max) -> "SplineGrid3D":
        return SplineGrid3D(
            coeff=jnp.asarray(prefilter(data_zyx)),
            aabb_min=jnp.asarray(aabb_min, jnp.float32),
            aabb_max=jnp.asarray(aabb_max, jnp.float32),
        )


def _grid_coords(grid: SplineGrid3D, p):
    """World point -> continuous grid coords (voxel index space), cell index
    and local t per axis, plus 1/h derivative scale per axis."""
    nz, ny, nx = grid.coeff.shape
    res = jnp.array([nx, ny, nz], jnp.float32)
    extent = grid.aabb_max - grid.aabb_min
    # Sample i sits at min + i * h with h = extent / (n - 1) (gridvolume.cpp
    # convention: endpoints inclusive).
    h = extent / jnp.maximum(res - 1.0, 1.0)
    x = (p - grid.aabb_min) / h
    x = jnp.clip(x, 0.0, res - 1.0)
    idx = jnp.clip(jnp.floor(x), 0.0, jnp.maximum(res - 2.0, 0.0))
    t = x - idx
    return idx.astype(jnp.int32), t, 1.0 / h


def _gather_neighborhood(grid: SplineGrid3D, idx):
    """Gather the 4x4x4 coefficient neighborhood: returns (..., 4, 4, 4)
    ordered [dz, dy, dx]."""
    nz, ny, nx = grid.coeff.shape
    offs = jnp.arange(-1, 3)
    ix = jnp.clip(idx[..., 0, None] + offs, 0, nx - 1)  # (..., 4)
    iy = jnp.clip(idx[..., 1, None] + offs, 0, ny - 1)
    iz = jnp.clip(idx[..., 2, None] + offs, 0, nz - 1)
    flat = (
        iz[..., :, None, None] * (ny * nx)
        + iy[..., None, :, None] * nx
        + ix[..., None, None, :]
    )  # (..., 4z, 4y, 4x)
    return jnp.take(grid.coeff.reshape(-1), flat, axis=0)


def _contract(c, wz, wy, wx):
    """Contract (..., 4, 4, 4) neighborhood with per-axis weight vectors."""
    return jnp.einsum("...zyx,...z,...y,...x->...", c, wz, wy, wx)


def value(grid: SplineGrid3D, p):
    idx, t, _ = _grid_coords(grid, p)
    c = _gather_neighborhood(grid, idx)
    return _contract(c, _bspline_w(t[..., 2]), _bspline_w(t[..., 1]), _bspline_w(t[..., 0]))


def value_gradient(grid: SplineGrid3D, p):
    """Fused value + world-space gradient (basisspline.h valueAndGradient)."""
    idx, t, inv_h = _grid_coords(grid, p)
    c = _gather_neighborhood(grid, idx)
    wx, wy, wz = _bspline_w(t[..., 0]), _bspline_w(t[..., 1]), _bspline_w(t[..., 2])
    dx, dy, dz = _bspline_dw(t[..., 0]), _bspline_dw(t[..., 1]), _bspline_dw(t[..., 2])
    v = _contract(c, wz, wy, wx)
    gx = _contract(c, wz, wy, dx) * inv_h[..., 0]
    gy = _contract(c, wz, dy, wx) * inv_h[..., 1]
    gz = _contract(c, dz, wy, wx) * inv_h[..., 2]
    return v, jnp.stack([gx, gy, gz], axis=-1)


def value_gradient_hessian(grid: SplineGrid3D, p):
    """Fused value + gradient + symmetric Hessian
    (basisspline.h valueGradientAndHessian)."""
    idx, t, inv_h = _grid_coords(grid, p)
    c = _gather_neighborhood(grid, idx)
    wx, wy, wz = _bspline_w(t[..., 0]), _bspline_w(t[..., 1]), _bspline_w(t[..., 2])
    dx, dy, dz = _bspline_dw(t[..., 0]), _bspline_dw(t[..., 1]), _bspline_dw(t[..., 2])
    d2x, d2y, d2z = _bspline_d2w(t[..., 0]), _bspline_d2w(t[..., 1]), _bspline_d2w(t[..., 2])
    ix, iy, iz = inv_h[..., 0], inv_h[..., 1], inv_h[..., 2]

    v = _contract(c, wz, wy, wx)
    gx = _contract(c, wz, wy, dx) * ix
    gy = _contract(c, wz, dy, wx) * iy
    gz = _contract(c, dz, wy, wx) * iz
    hxx = _contract(c, wz, wy, d2x) * ix * ix
    hyy = _contract(c, wz, d2y, wx) * iy * iy
    hzz = _contract(c, d2z, wy, wx) * iz * iz
    hxy = _contract(c, wz, dy, dx) * ix * iy
    hxz = _contract(c, dz, wy, dx) * ix * iz
    hyz = _contract(c, dz, dy, wx) * iy * iz
    g = jnp.stack([gx, gy, gz], axis=-1)
    H = jnp.stack(
        [
            jnp.stack([hxx, hxy, hxz], axis=-1),
            jnp.stack([hxy, hyy, hyz], axis=-1),
            jnp.stack([hxz, hyz, hzz], axis=-1),
        ],
        axis=-2,
    )
    return v, g, H


# ---------------------------------------------------------------------------
# Trilinear lookup (gridvolume.cpp trilinear interpolation) for density grids
# ---------------------------------------------------------------------------
def trilinear(data_zyx: jnp.ndarray, aabb_min, aabb_max, p):
    nz, ny, nx = data_zyx.shape
    res = jnp.array([nx, ny, nz], jnp.float32)
    extent = jnp.asarray(aabb_max) - jnp.asarray(aabb_min)
    h = extent / jnp.maximum(res - 1.0, 1.0)
    x = (p - jnp.asarray(aabb_min)) / h
    inside = jnp.all((x >= 0.0) & (x <= res - 1.0), axis=-1)
    x = jnp.clip(x, 0.0, res - 1.0)
    idx = jnp.clip(jnp.floor(x), 0.0, jnp.maximum(res - 2.0, 0.0)).astype(jnp.int32)
    t = x - idx
    ix, iy, iz = idx[..., 0], idx[..., 1], idx[..., 2]
    tx, ty, tz = t[..., 0], t[..., 1], t[..., 2]

    flat = data_zyx.reshape(-1)

    def at(dz, dy, dx):
        ii = (
            jnp.clip(iz + dz, 0, nz - 1) * (ny * nx)
            + jnp.clip(iy + dy, 0, ny - 1) * nx
            + jnp.clip(ix + dx, 0, nx - 1)
        )
        return jnp.take(flat, ii, axis=0)

    c00 = at(0, 0, 0) * (1 - tx) + at(0, 0, 1) * tx
    c01 = at(0, 1, 0) * (1 - tx) + at(0, 1, 1) * tx
    c10 = at(1, 0, 0) * (1 - tx) + at(1, 0, 1) * tx
    c11 = at(1, 1, 0) * (1 - tx) + at(1, 1, 1) * tx
    c0 = c00 * (1 - ty) + c01 * ty
    c1 = c10 * (1 - ty) + c11 * ty
    val = c0 * (1 - tz) + c1 * tz
    return jnp.where(inside, val, 0.0)
