"""Ray-scene intersection.

Array-program replacement for the reference's SAH kd-tree + SSE packet traversal
(include/mitsuba/render/{skdtree.h,gkdtree.h}, triaccel_sse.h). Pointer-based
tree traversal is the wrong shape for a vector machine; instead we evaluate
Moller-Trumbore for a whole ray wavefront against triangle chunks and keep a
running closest hit — fully fused by XLA, no divergence. Scenes in the target
workloads have O(10-100) triangles, so brute force *is* speed of light; the
chunked scan keeps memory bounded for larger meshes.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import numpy as np
import jax.numpy as jnp

from ..core import smalltab
from ..core.math import dot, cross, safe_sqrt
from .types import Geometry

# Small scenes keep per-prim fetches as select chains (see core/smalltab.py);
# the unrolled-intersector threshold (64) is the natural cutover.
_TAKE_UNROLL = 64

INF = np.float32(3.0e38)  # np scalar: jnp module constants become captured
# buffers that break the jax-0.9 dispatch fastpath (see integrators/render.py)
_CHUNK = 256


class Hit(NamedTuple):
    t: jnp.ndarray         # (N,) distance, INF when no hit
    valid: jnp.ndarray     # (N,) bool
    prim: jnp.ndarray      # (N,) int32 triangle id (or sphere id | 1<<30)
    shape_id: jnp.ndarray  # (N,) int32
    p: jnp.ndarray         # (N, 3) hit position
    ng: jnp.ndarray        # (N, 3) geometric normal (unit, faces outward)
    uv: jnp.ndarray        # (N, 2) barycentric
    tex_uv: jnp.ndarray    # (N, 2) interpolated texture coordinates


SPHERE_FLAG = np.int32(1 << 30)


def _tri_chunk_hit(v0, e1, e2, o, d, t_best):
    """Moller-Trumbore: rays (N,3) x tris (C,3) -> per-ray best in chunk.

    Returns (t, prim_in_chunk, u, v) with t=INF when missed."""
    # pvec: (N, C, 3)
    pvec = jnp.cross(d[:, None, :], e2[None, :, :])
    det = jnp.sum(pvec * e1[None, :, :], axis=-1)            # (N, C)
    # guard the denominator INSIDE the division: 1/0 on the masked branch
    # still produces an INF primal whose VJP poisons gradients with NaN
    ok_det = jnp.abs(det) > 1e-12
    inv_det = jnp.where(ok_det, 1.0 / jnp.where(ok_det, det, 1.0), 0.0)
    tvec = o[:, None, :] - v0[None, :, :]
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1[None, :, :])
    v = jnp.sum(d[:, None, :] * qvec, axis=-1) * inv_det
    t = jnp.sum(e2[None, :, :] * qvec, axis=-1) * inv_det
    ok = (
        ok_det
        & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t > 0.0)
    )
    t = jnp.where(ok, t, INF)
    best = jnp.argmin(t, axis=-1)
    n = jnp.arange(t.shape[0])
    return t[n, best], best, u[n, best], v[n, best]


_UNROLL_MAX = 64


def _tri_unrolled_hit_vec(geo: Geometry, o, d):
    """(N,3)-vector form of the unrolled MT loop (jnp.cross/stack based).
    Fewer, larger HLOs than the component form — kept selectable because
    fusion behavior differs when embedded in a big pass (WF_ISECT env)."""
    n = o.shape[0]
    best_t = jnp.full((n,), INF)
    best_prim = jnp.zeros((n,), jnp.int32)
    best_u = jnp.zeros((n,))
    best_v = jnp.zeros((n,))
    for i in range(geo.v0.shape[0]):
        tv0, te1, te2 = geo.v0[i], geo.e1[i], geo.e2[i]
        pvec = jnp.cross(d, te2[None, :])
        det = pvec @ te1
        ok = jnp.abs(det) > 1e-12
        inv = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
        tvec = o - tv0[None, :]
        u = jnp.sum(tvec * pvec, -1) * inv
        qvec = jnp.cross(tvec, te1[None, :])
        v = jnp.sum(d * qvec, -1) * inv
        t = (qvec @ te2) * inv
        hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
        closer = hit & (t < best_t)
        best_t = jnp.where(closer, t, best_t)
        best_prim = jnp.where(closer, i, best_prim)
        best_u = jnp.where(closer, u, best_u)
        best_v = jnp.where(closer, v, best_v)
    return best_t, best_prim, best_u, best_v


def _tri_unrolled_hit(geo: Geometry, o, d):
    """Small scenes: statically unrolled per-triangle Moller-Trumbore.

    Fully component-wise over (N,) lane arrays — no jnp.cross / stack /
    dot_general, whose stacked (N,3) intermediates defeat XLA elementwise
    fusion and turn a 12-triangle test into device-memory round trips at
    wavefront width. With scalar triangle constants folded in, the whole
    loop fuses into one elementwise kernel (bandwidth: read o,d + write 4
    arrays)."""
    import os
    if os.environ.get("WF_ISECT") == "vector":
        return _tri_unrolled_hit_vec(geo, o, d)
    n = o.shape[0]
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    best_t = jnp.full((n,), INF)
    best_prim = jnp.zeros((n,), jnp.int32)
    best_u = jnp.zeros((n,))
    best_v = jnp.zeros((n,))
    for i in range(geo.v0.shape[0]):
        tv0, te1, te2 = geo.v0[i], geo.e1[i], geo.e2[i]
        e1x, e1y, e1z = te1[0], te1[1], te1[2]
        e2x, e2y, e2z = te2[0], te2[1], te2[2]
        # pvec = d x e2
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = px * e1x + py * e1y + pz * e1z
        ok = jnp.abs(det) > 1e-12
        inv = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
        tx = ox - tv0[0]
        ty = oy - tv0[1]
        tz = oz - tv0[2]
        u = (tx * px + ty * py + tz * pz) * inv
        # qvec = tvec x e1
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        v = (dx * qx + dy * qy + dz * qz) * inv
        t = (e2x * qx + e2y * qy + e2z * qz) * inv
        hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
        closer = hit & (t < best_t)
        best_t = jnp.where(closer, t, best_t)
        best_prim = jnp.where(closer, i, best_prim)
        best_u = jnp.where(closer, u, best_u)
        best_v = jnp.where(closer, v, best_v)
    return best_t, best_prim, best_u, best_v


def intersect_triangles(geo: Geometry, o, d, t_min, t_max):
    """Closest triangle hit over the whole scene buffer."""
    T = geo.v0.shape[0]
    n = o.shape[0]

    if geo.bvh is not None:
        # big meshes: flattened-BVH traversal (scene/bvh.py), replacing the
        # reference's SAH kd-tree (skdtree.h:69)
        from . import bvh as bvh_m

        t, packed, u, v = bvh_m.intersect_bvh(geo.bvh, o, d, t_min, t_max)
        prim = jnp.take(geo.bvh.tri_id,
                        jnp.clip(packed, 0, geo.bvh.tri_id.shape[0] - 1))
        ok = t < INF
        valid_prim = smalltab.take(
            geo.shape_id, jnp.clip(prim, 0, T - 1),
            max_unroll=_TAKE_UNROLL) >= 0
        return t, prim, u, v, ok & valid_prim

    if T <= _UNROLL_MAX:
        t, prim, u, v = _tri_unrolled_hit(geo, o, d)
    elif T <= _CHUNK:
        t, prim, u, v = _tri_chunk_hit(geo.v0, geo.e1, geo.e2, o, d, None)
    else:
        pad = (-T) % _CHUNK
        v0 = jnp.pad(geo.v0, ((0, pad), (0, 0)))
        e1 = jnp.pad(geo.e1, ((0, pad), (0, 0)), constant_values=0)
        e2 = jnp.pad(geo.e2, ((0, pad), (0, 0)), constant_values=0)
        nchunks = (T + pad) // _CHUNK

        def body(carry, ci):
            bt, bp, bu, bv = carry
            s = ci * _CHUNK
            cv0 = jax.lax.dynamic_slice_in_dim(v0, s, _CHUNK)
            ce1 = jax.lax.dynamic_slice_in_dim(e1, s, _CHUNK)
            ce2 = jax.lax.dynamic_slice_in_dim(e2, s, _CHUNK)
            t, p, u, v = _tri_chunk_hit(cv0, ce1, ce2, o, d, bt)
            closer = t < bt
            return (
                jnp.where(closer, t, bt),
                jnp.where(closer, p + s, bp),
                jnp.where(closer, u, bu),
                jnp.where(closer, v, bv),
            ), None

        init = (
            jnp.full((n,), INF), jnp.zeros((n,), jnp.int32),
            jnp.zeros((n,)), jnp.zeros((n,)),
        )
        (t, prim, u, v), _ = jax.lax.scan(body, init, jnp.arange(nchunks))

    in_range = (t >= t_min) & (t <= t_max) & (t < INF)
    # mask out padding / invalid prims
    valid_prim = smalltab.take(
        geo.shape_id, jnp.clip(prim, 0, T - 1), max_unroll=_TAKE_UNROLL) >= 0
    ok = in_range & valid_prim
    return t, prim, u, v, ok


def intersect_spheres(geo: Geometry, o, d, t_min, t_max):
    """Analytic sphere intersection (shapes/sphere.cpp)."""
    S = geo.sph_center.shape[0]
    if S <= 8:
        n = o.shape[0]
        best_t = jnp.full((n,), INF)
        best = jnp.zeros((n,), jnp.int32)
        for i in range(S):
            c, r = geo.sph_center[i], geo.sph_radius[i]
            oc = o - c[None, :]
            b = jnp.sum(oc * d, -1)
            ct = jnp.sum(oc * oc, -1) - r * r
            disc = b * b - ct
            sq = safe_sqrt(disc)
            t0, t1 = -b - sq, -b + sq
            t = jnp.where((t0 >= t_min) & (t0 <= t_max), t0, t1)
            ok = (disc > 0) & (t >= t_min) & (t <= t_max) & (r > 0)
            closer = ok & (t < best_t)
            best_t = jnp.where(closer, t, best_t)
            best = jnp.where(closer, i, best)
        return best_t, best, best_t < INF

    c = geo.sph_center           # (S, 3)
    r = geo.sph_radius           # (S,)
    oc = o[:, None, :] - c[None, :, :]
    b = jnp.sum(oc * d[:, None, :], axis=-1)
    cterm = jnp.sum(oc * oc, axis=-1) - (r * r)[None, :]
    disc = b * b - cterm
    sq = safe_sqrt(disc)
    t0 = -b - sq
    t1 = -b + sq
    t = jnp.where((t0 >= t_min[:, None]) & (t0 <= t_max[:, None]), t0, t1)
    ok = (disc > 0) & (t >= t_min[:, None]) & (t <= t_max[:, None]) & (r[None, :] > 0)
    t = jnp.where(ok, t, INF)
    best = jnp.argmin(t, axis=-1)
    n = jnp.arange(t.shape[0])
    return t[n, best], best, t[n, best] < INF


def intersect(geo: Geometry, o, d, t_min, t_max, need_uv: bool = False) -> Hit:
    """Closest-hit over triangles + analytic spheres.

    need_uv: interpolate texture coordinates (static; textured scenes only —
    the three extra per-triangle attribute fetches cost real bandwidth at
    wavefront width)."""
    t_min = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), o.shape[:1])
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), o.shape[:1])
    tt, tprim, tu, tv, tok = intersect_triangles(geo, o, d, t_min, t_max)
    st, sprim, sok = intersect_spheres(geo, o, d, t_min, t_max)

    use_sph = sok & (st < jnp.where(tok, tt, INF))
    t = jnp.where(use_sph, st, jnp.where(tok, tt, INF))
    valid = tok | sok
    prim = jnp.where(use_sph, sprim | SPHERE_FLAG, tprim)
    # keep p finite on misses (INF * 0 = NaN poisons reverse-mode AD even on
    # masked lanes): misses report p = o
    p = o + jnp.where(valid, t, 0.0)[:, None] * d

    Tn = geo.v0.shape[0]
    tprim_c = jnp.clip(tprim, 0, Tn - 1)
    tri_ng = smalltab.take(geo.ng, tprim_c, max_unroll=_TAKE_UNROLL)
    tri_shape = smalltab.take(geo.shape_id, tprim_c, max_unroll=_TAKE_UNROLL)
    sph_c = smalltab.take(geo.sph_center, sprim)
    sph_r = smalltab.take(geo.sph_radius, sprim)
    # normalize instead of dividing by the radius: dummy radius-0 sphere
    # slots would otherwise produce ~1e20 "normals" that overflow downstream
    from ..core.math import normalize as _normalize

    sph_ng = _normalize(p - sph_c)
    sph_shape = smalltab.take(geo.sph_shape_id, sprim)

    ng = jnp.where(use_sph[:, None], sph_ng, tri_ng)
    shape_id = jnp.where(use_sph, sph_shape, tri_shape)
    uv = jnp.stack([tu, tv], axis=-1)
    if need_uv:
        # interpolated texture coords (trimesh texcoords; spheres: lat-long)
        uv0 = smalltab.take(geo.uv0, tprim_c, max_unroll=_TAKE_UNROLL)
        uve1 = smalltab.take(geo.uve1, tprim_c, max_unroll=_TAKE_UNROLL)
        uve2 = smalltab.take(geo.uve2, tprim_c, max_unroll=_TAKE_UNROLL)
        tri_uv = uv0 + tu[:, None] * uve1 + tv[:, None] * uve2
        sph_u = 0.5 + jnp.arctan2(sph_ng[:, 1], sph_ng[:, 0]) / (2 * np.pi)
        sph_v = 0.5 - jnp.arcsin(jnp.clip(sph_ng[:, 2], -1, 1)) / np.pi
        tex_uv = jnp.where(use_sph[:, None],
                           jnp.stack([sph_u, sph_v], axis=-1), tri_uv)
    else:
        tex_uv = uv
    return Hit(
        t=t, valid=valid, prim=prim,
        shape_id=jnp.where(valid, shape_id, -1),
        p=p, ng=ng, uv=uv, tex_uv=tex_uv,
    )


def occluded(geo: Geometry, o, d, t_min, t_max) -> jnp.ndarray:
    """Any-hit shadow query: True if something blocks (o + t*d, t in range)."""
    hit = intersect(geo, o, d, t_min, t_max)
    return hit.valid


def ray_aabb(o, d, aabb_min, aabb_max):
    """Slab test: returns (t_near, t_far) of the box interval (may be empty:
    t_near > t_far)."""
    inv = 1.0 / jnp.where(jnp.abs(d) < 1e-20, jnp.where(d >= 0, 1e-20, -1e-20), d)
    t0 = (aabb_min - o) * inv
    t1 = (aabb_max - o) * inv
    tn = jnp.max(jnp.minimum(t0, t1), axis=-1)
    tf = jnp.min(jnp.maximum(t0, t1), axis=-1)
    return tn, tf
