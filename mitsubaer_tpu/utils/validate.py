"""Deterministic validation references.

The reference repo has no image-regression tests (SURVEY.md section 4); its
statistical chi^2 harness (test_chisquare.cpp) checks sample()/pdf()
consistency. For volumetric transport we can do better: a
deterministic single-scatter quadrature that both engines (loop + wavefront)
must converge to. Used by tests/test_wavefront.py and
scripts/quadrature_ref.py.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..models import medium as medium_m
from ..models import phase as phase_m
from ..models import sensor as sensor_m
from ..scene import intersect as isect


def single_scatter_quadrature(scene, cfg, *, medium: int = 0,
                              emitter: int = 0, sub: int = 4,
                              nt: int = 128, nl: int = 64) -> np.ndarray:
    """Ground-truth image for a single-scatter (max_depth=2) point-lit
    heterogeneous medium bounded by the scene AABB:

      L(pix) = avg_subpix INT T_cam(t) sigma_s dens rho_HG T_light I/d^2 dt

    Shares DensityBricks / phase eval / sensor ray generation with the
    engines so it isolates exactly the tracking estimators. Deterministic
    midpoint quadrature: `sub`^2 subpixel rays, `nt` camera steps, `nl`
    light-segment steps."""
    bricks = medium_m.DensityBricks(scene.media)
    sa = scene.media.sigma_a[medium]
    ss = scene.media.sigma_s[medium]
    st = sa + ss
    scale = scene.media.scale[medium]
    light_p = scene.emitters.position[emitter]
    light_I = scene.emitters.radiance[emitter]
    W, H = cfg.width, cfg.height
    lo, hi = scene.aabb_min, scene.aabb_max

    @jax.jit
    def block(px, py):
        rays = sensor_m.sample_rays(scene.sensor, px, py, W, H,
                                    u_lens=jnp.full((px.shape[0], 2), 0.5))
        o, d = rays.o, rays.d
        t0, t1 = isect.ray_aabb(o, d, lo, hi)
        t0 = jnp.maximum(t0, 0.0)
        dt = jnp.maximum(t1 - t0, 0.0) / nt

        k = jnp.arange(nt, dtype=jnp.float32) + 0.5
        tmid = t0[:, None] + k[None, :] * dt[:, None]
        pmid = o[:, None, :] + tmid[..., None] * d[:, None, :]
        dmid = (bricks.lookup(pmid.reshape(-1, 3)) * scale
                ).reshape(pmid.shape[:2])
        dtau = dmid[..., None] * st[None, None, :] * dt[:, None, None]
        T_cam = jnp.exp(-(jnp.cumsum(dtau, axis=1) - 0.5 * dtau))

        to_l = light_p[None, None, :] - pmid
        dist_l = jnp.linalg.norm(to_l, axis=-1)
        wl = to_l / dist_l[..., None]
        pf, wf = pmid.reshape(-1, 3), wl.reshape(-1, 3)
        _, tl_exit = isect.ray_aabb(pf, wf, lo, hi)
        tl_exit = jnp.minimum(jnp.maximum(tl_exit, 0.0), dist_l.reshape(-1))
        dl = tl_exit / nl
        kk = jnp.arange(nl, dtype=jnp.float32) + 0.5
        pl = pf[:, None, :] + (kk[None, :] * dl[:, None])[..., None] * wf[:, None, :]
        dml = (bricks.lookup(pl.reshape(-1, 3)) * scale).reshape(pl.shape[:2])
        tau_l = jnp.sum(dml, axis=1) * dl
        T_light = jnp.exp(-tau_l[:, None] * st[None, :]).reshape(
            pmid.shape[0], nt, 3)

        rho = phase_m.eval(scene.media.phase,
                           jnp.full((pf.shape[0],), medium, jnp.int32),
                           jnp.repeat(d, nt, axis=0), wf
                           ).reshape(pmid.shape[:2])
        emit = light_I[None, None, :] / (dist_l ** 2)[..., None]
        integrand = (T_cam * (dmid[..., None] * ss[None, None, :])
                     * rho[..., None] * T_light * emit)
        return jnp.sum(integrand * dt[:, None, None], axis=1)

    offs = (np.arange(sub) + 0.5) / sub
    img = np.zeros((H, W, 3), np.float64)
    for oy in offs:
        for ox in offs:
            px = (np.arange(W * H) % W + ox).astype(np.float32)
            py = (np.arange(W * H) // W + oy).astype(np.float32)
            img += np.asarray(block(jnp.asarray(px), jnp.asarray(py))
                              ).reshape(H, W, 3)
    return img / (sub * sub)


def beam_double_scatter_quadrature(scene, cfg, *, medium: int = 0,
                                   sub: int = 2, nt: int = 96,
                                   ns: int = 192) -> np.ndarray:
    """Ground-truth image for the collimated-beam scene at max_depth=2:
    the shortest light path is camera -> x (scatter) <- y (scatter ON the
    beam) <- beam, a deterministic double integral

      L_c(pix) = avg_sub INT_t T_cam,c sigma_s_c(x)
                 INT_s rho(d_cam,d_xy) e^{-sigma_t_c d} / d^2
                        sigma_s_c(y) rho(b_d,d_yx) T_beam,c(s) P_c ds dt

    evaluated by midpoint quadrature (nt camera steps x ns beam steps).
    Validates the beam-NEE estimator of the wavefront AND boxwalk engines
    (volpath.py sample_beam_point / boxwalk.py) including the shadow
    transmittance between x and y (quadrature along the chord here; the
    engines ratio-track it)."""
    from ..integrators.volpath import get_beam

    bricks = medium_m.DensityBricks(scene.media)
    sa = scene.media.sigma_a[medium]
    ss = scene.media.sigma_s[medium]
    st = sa + ss
    scale = scene.media.scale[medium]
    beam = get_beam(scene)
    W, H = cfg.width, cfg.height
    lo, hi = scene.aabb_min, scene.aabb_max
    nsh = 64                        # shadow-chord quadrature steps

    @jax.jit
    def block(px, py):
        rays = sensor_m.sample_rays(scene.sensor, px, py, W, H,
                                    u_lens=jnp.full((px.shape[0], 2), 0.5))
        o, d = rays.o, rays.d
        t0, t1 = isect.ray_aabb(o, d, lo, hi)
        t0 = jnp.maximum(t0, 0.0)
        dt = jnp.maximum(t1 - t0, 0.0) / nt
        k = jnp.arange(nt, dtype=jnp.float32) + 0.5
        tmid = t0[:, None] + k[None, :] * dt[:, None]
        x = o[:, None, :] + tmid[..., None] * d[:, None, :]   # (N,nt,3)
        dx = (bricks.lookup(x.reshape(-1, 3)) * scale
              ).reshape(x.shape[:2])
        dtau = dx[..., None] * st[None, None, :] * dt[:, None, None]
        T_cam = jnp.exp(-(jnp.cumsum(dtau, axis=1) - 0.5 * dtau))

        # beam samples y_j (shared across pixels)
        ds_ = (beam.s1 - beam.s0) / ns
        sj = beam.s0 + (jnp.arange(ns, dtype=jnp.float32) + 0.5) * ds_
        y = beam.o[None, :] + sj[:, None] * beam.d[None, :]    # (ns,3)
        dy = bricks.lookup(y) * scale                          # (ns,)
        tau_beam = (jnp.cumsum(dy) - 0.5 * dy) * ds_
        T_beam = jnp.exp(-tau_beam[:, None] * st[None, :])     # (ns,3)

        def per_t(xi, Ti, di):
            # xi (nt,3) one pixel's camera points; contributions (nt,3)
            to_x = xi[:, None, :] - y[None, :, :]              # (nt,ns,3)
            dist = jnp.maximum(jnp.linalg.norm(to_x, axis=-1), 1e-6)
            w = to_x / dist[..., None]
            # shadow optical depth along the chord (midpoint, nsh steps)
            kk = (jnp.arange(nsh, dtype=jnp.float32) + 0.5) / nsh
            pssh = y[None, :, None, :] \
                + (kk[None, None, :, None]
                   * dist[..., None, None]) * w[:, :, None, :]
            dsh = (bricks.lookup(pssh.reshape(-1, 3)) * scale
                   ).reshape(nt, ns, nsh)
            tau_sh = jnp.sum(dsh, axis=-1) * (dist / nsh)
            T_sh = jnp.exp(-tau_sh[..., None] * st[None, None, :])
            midx = jnp.full((nt * ns,), medium, jnp.int32)
            rho_x = phase_m.eval(
                scene.media.phase, midx,
                jnp.broadcast_to(di[None, None, :], w.shape
                                 ).reshape(-1, 3),
                (-w).reshape(-1, 3)).reshape(nt, ns)
            rho_y = phase_m.eval(
                scene.media.phase, midx,
                jnp.broadcast_to(beam.d[None, None, :], w.shape
                                 ).reshape(-1, 3),
                w.reshape(-1, 3)).reshape(nt, ns)
            inner = (rho_x[..., None] * T_sh / (dist ** 2)[..., None]
                     * (dy[None, :, None] * ss[None, None, :])
                     * rho_y[..., None] * T_beam[None, :, :]
                     * beam.power[None, None, :]) * ds_
            return jnp.sum(inner, axis=1)                      # (nt,3)

        inner_all = jax.lax.map(lambda args: per_t(*args), (x, T_cam, d))
        integrand = (T_cam * (dx[..., None] * ss[None, None, :])
                     * inner_all)
        return jnp.sum(integrand * dt[:, None, None], axis=1)

    offs = (np.arange(sub) + 0.5) / sub
    img = np.zeros((H, W, 3), np.float64)
    for oy in offs:
        for ox in offs:
            px = (np.arange(W * H) % W + ox).astype(np.float32)
            py = (np.arange(W * H) // W + oy).astype(np.float32)
            img += np.asarray(block(jnp.asarray(px), jnp.asarray(py))
                              ).reshape(H, W, 3)
    return img / (sub * sub)
