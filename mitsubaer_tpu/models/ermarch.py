"""Pallas (Triton route) kernels for the eikonal (ER) curved-ray march loops.

The ER integrators are SEQUENTIAL-DEPTH bound, not width bound: a curved
segment is hundreds of velocity-Verlet steps (er_step,
heterogeneousrefractive.cpp:653) and every BVP Levenberg iteration
re-integrates the ray with 3x3 sensitivities (er_derivativestep,
:798-814). As an XLA while_loop every step is a separate round of kernel
launches plus a device-to-host read of the loop predicate. In these
kernels each program owns a block of lanes and keeps every lane's 12 (trace)
or 32 (sensitivity) state floats in registers for the whole march; memory
is touched once on entry and once on exit.

Two kernels, exact transcriptions of models/eikonal.py's loops:

* trace:  the while-loop of eikonal.trace_curved (march a fixed arc
  length, stop at the medium boundary).
* sens:   the while-loop of eikonal.integrate_with_sensitivities (march
  until passing the target plane or exiting, propagating dpdv0/dvdv0).

Scope (the gate lives in eikonal.py): analytic RIFs const/linear/radial
(runtime-selected from the params vector — acoustic/spline lanes take
the XLA path via lax.cond on rif.kind / a static coeff-size check) and
analytic sphere/box SDFs. Boundary refinement, refraction and the
post-march change of variables stay in XLA (one-shot work).

Layout: per-lane state is passed as (rows, n) f32 with the row count
padded to a power of two (Triton's block sizes); each program loads its
(rows, B) block row by row into (B,) vectors. The 16-float parameter
vector is an unblocked input read as scalars.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

# params vector layout (f32): rif kind, rif params[0:8], sdf kind,
# sdf params[0:6]; h is per-lane (state row)
_Q_RKIND = 0
_Q_RPRM = 1
_Q_SKIND = 9
_Q_SPRM = 10
_Q_NP = 16

RIF_CONST = 0
RIF_LINEAR = 1
RIF_RADIAL = 2
SDF_SPHERE = 1    # eikonal.py:51-54 (SDF_NONE=0 -> always outside)
SDF_BOX = 2


def _rif(qv, p, need_hess):
    """value / grad 3-tuple (/ row-major Hessian 9-tuple) at p = (x, y, z)
    for const/linear/radial."""
    kind = qv(_Q_RKIND)
    p0 = qv(_Q_RPRM + 0)
    is_lin = kind == jnp.float32(RIF_LINEAR)
    is_rad = kind == jnp.float32(RIF_RADIAL)
    gx = jnp.where(is_lin, qv(_Q_RPRM + 1), 0.0)
    gy = jnp.where(is_lin, qv(_Q_RPRM + 2), 0.0)
    gz = jnp.where(is_lin, qv(_Q_RPRM + 3), 0.0)
    # radial: n0 + a exp(-|p-c|^2/w^2)
    a_r = qv(_Q_RPRM + 1)
    w2 = jnp.maximum(qv(_Q_RPRM + 2) * qv(_Q_RPRM + 2), 1e-12)
    dp3 = (p[0] - qv(_Q_RPRM + 3), p[1] - qv(_Q_RPRM + 4),
           p[2] - qv(_Q_RPRM + 5))
    r2 = dp3[0] * dp3[0] + dp3[1] * dp3[1] + dp3[2] * dp3[2]
    e = a_r * jnp.exp(-r2 / w2)

    v = p0 + p[0] * gx + p[1] * gy + p[2] * gz + jnp.where(is_rad, e, 0.0)
    k_r = jnp.where(is_rad, -2.0 / w2, 0.0)
    ke = k_r * e
    g = (gx + ke * dp3[0], gy + ke * dp3[1], gz + ke * dp3[2])
    if not need_hess:
        return v, g, None
    # H_r = k (e I + dp g_r^T) with g_r = k e dp (radial only; others 0)
    gr3 = (ke * dp3[0], ke * dp3[1], ke * dp3[2])
    H = []
    for i in range(3):
        for j in range(3):
            val = dp3[i] * gr3[j] * k_r
            if i == j:
                val = val + ke
            H.append(val)
    return v, g, tuple(H)


def _sdf_val(qv, p):
    kind = qv(_Q_SKIND)
    dx = p[0] - qv(_Q_SPRM + 0)
    dy = p[1] - qv(_Q_SPRM + 1)
    dz = p[2] - qv(_Q_SPRM + 2)
    r = jnp.sqrt(jnp.maximum(dx * dx + dy * dy + dz * dz, 1e-30))
    v_sph = r - qv(_Q_SPRM + 3)
    qx = jnp.abs(dx) - qv(_Q_SPRM + 3)
    qy = jnp.abs(dy) - qv(_Q_SPRM + 4)
    qz = jnp.abs(dz) - qv(_Q_SPRM + 5)
    mx = jnp.maximum(qx, 0.0)
    my = jnp.maximum(qy, 0.0)
    mz = jnp.maximum(qz, 0.0)
    outside = jnp.sqrt(jnp.maximum(mx * mx + my * my + mz * mz, 1e-30))
    inside = jnp.minimum(jnp.maximum(qx, jnp.maximum(qy, qz)), 0.0)
    v_box = outside + inside
    v = jnp.where(kind == jnp.float32(SDF_SPHERE), v_sph,
                  jnp.ones_like(v_sph))
    return jnp.where(kind == jnp.float32(SDF_BOX), v_box, v)


def _add3(a, s, b):
    """a + s * b on 3-tuples."""
    return tuple(a[i] + s * b[i] for i in range(3))


def _where3(c, a, b):
    return tuple(jnp.where(c, a[i], b[i]) for i in range(len(a)))


def _any(flag_f):
    return jnp.max(flag_f) > 0.5


def _trace_kernel(max_steps, q_ref, st_ref, out_ref):
    """Rows in/out: 0:3 p, 3:6 v, 6 opt, 7 marched, 8 running, 9 exited,
    10 distance (in) / steps (out), 11 h, 12:16 pad."""
    def qv(i):
        return q_ref[i]

    def row(r):
        return st_ref[r, :]

    dist = row(10)
    h = row(11)

    def body(carry):
        it, p, v, opt, marched, running_f, exited = carry
        running = running_f > 0.5
        remaining = dist - marched
        step = jnp.minimum(h, jnp.maximum(remaining, 0.0))
        n0, g0, _ = _rif(qv, p, False)
        v1 = _add3(v, 0.5 * step, g0)
        p1 = _add3(p, step / n0, v1)
        _, g1, _ = _rif(qv, p1, False)
        v2 = _add3(v1, 0.5 * step, g1)
        dopt = step * n0

        out = _sdf_val(qv, p1) >= 0.0
        take = running & ~out
        stop_out = running & out
        p = _where3(take, p1, p)
        v = _where3(take, v2, v)
        opt = jnp.where(take, opt + dopt, opt)
        marched = jnp.where(take, marched + step, marched)
        done = take & (marched >= dist - 1e-7)
        running_f = jnp.where(running & ~stop_out & ~done, 1.0, 0.0)
        exited = jnp.maximum(exited, jnp.where(stop_out, 1.0, 0.0))
        return it + 1, p, v, opt, marched, running_f, exited

    def cond(carry):
        return (carry[0] < max_steps) & _any(carry[5])

    init = (jnp.int32(0), (row(0), row(1), row(2)), (row(3), row(4), row(5)),
            row(6), row(7), row(8), row(9))
    it, p, v, opt, marched, running_f, exited = jax.lax.while_loop(
        cond, body, init)
    outs = (*p, *v, opt, marched, running_f, exited,
            jnp.full(h.shape, it.astype(jnp.float32)), h)
    for r, val in enumerate(outs):
        out_ref[r, :] = val


def _mat33(A, Bm):
    """Row-major 3x3 product of 9-tuples: C_ij = sum_k A_ik B_kj."""
    out = []
    for i in range(3):
        for j in range(3):
            out.append(A[3 * i] * Bm[j] + A[3 * i + 1] * Bm[3 + j]
                       + A[3 * i + 2] * Bm[6 + j])
    return tuple(out)


def _sens_kernel(max_steps, q_ref, st_ref, out_ref):
    """integrate_with_sensitivities march loop. Rows: 0:3 p, 3:6 v,
    6:15 dpdv0, 15:24 dvdv0, 24 opt, 25 marched, 26 running, 27 crossed,
    28:31 p2, 31 h."""
    def qv(i):
        return q_ref[i]

    def row(r):
        return st_ref[r, :]

    p2t = (row(28), row(29), row(30))
    h = row(31)

    def sign_of(p, v):
        s = ((p[0] - p2t[0]) * v[0] + (p[1] - p2t[1]) * v[1]
             + (p[2] - p2t[2]) * v[2])
        return s < 0.0

    def body(carry):
        it, p, v, dp_, dv_, opt, marched, running_f, crossed = carry
        running = running_f > 0.5
        # er_derivative_step (eikonal.py), tuple form
        n0, g0, H0 = _rif(qv, p, True)
        v1 = _add3(v, 0.5 * h, g0)
        HdP = _mat33(H0, dp_)
        dv1 = tuple(dv_[k] + 0.5 * h * HdP[k] for k in range(9))
        p1 = _add3(p, h / n0, v1)
        n1, g1, H1 = _rif(qv, p1, True)
        invn = 1.0 / n1
        # gdp_j = sum_k g1_k dp_kj ; dpdv0 += h(-invn^2 v1 (x) gdp + invn dv1)
        gdp = [g1[0] * dp_[j] + g1[1] * dp_[3 + j] + g1[2] * dp_[6 + j]
               for j in range(3)]
        dp1 = tuple(
            dp_[3 * i + j] + h * (-invn * invn * v1[i] * gdp[j]
                                  + invn * dv1[3 * i + j])
            for i in range(3) for j in range(3))
        v2 = _add3(v1, 0.5 * h, g1)
        HdP1 = _mat33(H1, dp1)
        dv2 = tuple(dv1[k] + 0.5 * h * HdP1[k] for k in range(9))

        out = _sdf_val(qv, p1) >= 0.0
        flip = sign_of(p1, v2) != sign_of(p, v)
        stop = out | flip
        take = running & ~stop
        p = _where3(take, p1, p)
        v = _where3(take, v2, v)
        dp_ = _where3(take, dp1, dp_)
        dv_ = _where3(take, dv2, dv_)
        opt = jnp.where(take, opt + h * n0, opt)
        marched = jnp.where(take, marched + h, marched)
        crossed = jnp.maximum(crossed, jnp.where(running & out, 1.0, 0.0))
        running_f = jnp.where(take, 1.0, 0.0)
        return it + 1, p, v, dp_, dv_, opt, marched, running_f, crossed

    def cond(carry):
        return (carry[0] < max_steps) & _any(carry[7])

    init = (jnp.int32(0), (row(0), row(1), row(2)), (row(3), row(4), row(5)),
            tuple(row(6 + k) for k in range(9)),
            tuple(row(15 + k) for k in range(9)),
            row(24), row(25), row(26), row(27))
    _, p, v, dp_, dv_, opt, marched, running_f, crossed = jax.lax.while_loop(
        cond, body, init)
    outs = (*p, *v, *dp_, *dv_, opt, marched, running_f, crossed, *p2t, h)
    for r, val in enumerate(outs):
        out_ref[r, :] = val


def _pack_q(rif, sdf):
    q = jnp.concatenate([
        rif.kind.astype(jnp.float32).reshape(1),
        rif.params[:8].astype(jnp.float32),
        sdf.kind.astype(jnp.float32).reshape(1),
        sdf.params[:6].astype(jnp.float32),
    ])
    return jnp.pad(q, (0, _Q_NP - q.shape[0]))


def _call(kernel, rows, q, max_steps, B, num_warps, interpret, name):
    """Run `kernel` over (R, n) state rows in blocks of B lanes."""
    R, n = rows.shape
    npad = -(-n // B) * B
    rows = jnp.pad(rows, ((0, 0), (0, npad - n)))
    out = pl.pallas_call(
        functools.partial(kernel, max_steps),
        grid=(npad // B,),
        out_shape=jax.ShapeDtypeStruct((R, npad), jnp.float32),
        in_specs=[
            pl.BlockSpec((_Q_NP,), lambda i: (0,)),
            pl.BlockSpec((R, B), lambda i: (0, i)),
        ],
        out_specs=pl.BlockSpec((R, B), lambda i: (0, i)),
        compiler_params=pl_triton.CompilerParams(num_warps=num_warps,
                                                 num_stages=1),
        backend="triton",
        interpret=interpret,
        name=name,
    )(q, rows)
    return out[:, :n]


@functools.partial(jax.jit, static_argnames=("max_steps", "B", "num_warps",
                                             "interpret"))
def trace(rif, sdf, p, v, distance, h, max_steps, active, B=128,
          num_warps=4, interpret=False):
    """Kernel version of eikonal.trace_curved's loop. Returns
    (p, v, opt, marched, exited, steps)."""
    n = p.shape[0]
    f32 = jnp.float32
    z = jnp.zeros((n,), f32)
    rows = jnp.stack([
        p[:, 0], p[:, 1], p[:, 2], v[:, 0], v[:, 1], v[:, 2], z, z,
        active.astype(f32), z,
        jnp.broadcast_to(distance, (n,)).astype(f32),
        jnp.broadcast_to(jnp.asarray(h, f32), (n,)), z, z, z, z,
    ], axis=0)
    out = _call(_trace_kernel, rows, _pack_q(rif, sdf), max_steps, B,
                num_warps, interpret, "ermarch_trace")
    p_o = jnp.stack([out[0], out[1], out[2]], axis=-1)
    v_o = jnp.stack([out[3], out[4], out[5]], axis=-1)
    steps = jnp.max(out[10]).astype(jnp.int32)
    return p_o, v_o, out[6], out[7], out[9] > 0.5, steps


@functools.partial(jax.jit, static_argnames=("max_steps", "B", "num_warps",
                                             "interpret"))
def sens_march(rif, sdf, p1, v, dpdv0, dvdv0, p2, h, max_steps, active,
               B=128, num_warps=4, interpret=False):
    """Kernel version of integrate_with_sensitivities' march loop.
    Returns (p, v, dpdv0, dvdv0, opt, marched, exited/crossed)."""
    n = p1.shape[0]
    f32 = jnp.float32
    z = jnp.zeros((n,), f32)
    rows = [p1[:, 0], p1[:, 1], p1[:, 2], v[:, 0], v[:, 1], v[:, 2]]
    rows += [dpdv0[:, i, j] for i in range(3) for j in range(3)]
    rows += [dvdv0[:, i, j] for i in range(3) for j in range(3)]
    rows += [z, z, active.astype(f32), z, p2[:, 0], p2[:, 1], p2[:, 2],
             jnp.broadcast_to(jnp.asarray(h, f32), (n,))]
    out = _call(_sens_kernel, jnp.stack(rows, axis=0), _pack_q(rif, sdf),
                max_steps, B, num_warps, interpret, "ermarch_sens")
    p_o = jnp.stack([out[0], out[1], out[2]], axis=-1)
    v_o = jnp.stack([out[3], out[4], out[5]], axis=-1)
    dp_o = out[6:15].T.reshape(n, 3, 3)
    dv_o = out[15:24].T.reshape(n, 3, 3)
    return (p_o, v_o, dp_o, dv_o, out[24], out[25], out[27] > 0.5)
