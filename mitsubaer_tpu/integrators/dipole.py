"""Classical dipole BSSRDF subsurface integrator (src/subsurface/dipole.cpp,
Jensen et al. 2001).

The reference precomputes an irradiance OCTREE over surface samples and
hierarchically gathers R_d-weighted irradiance per shading point.
Array-program redesign: the irradiance cache is a dense (M,) array of area-weighted
surface samples (no tree — the gather is a chunked (n_pix, M) pairwise
R_d evaluation, which is exactly the dense regular compute accelerators want; at
the reference's default sample densities M is a few thousand, so the full
pairwise product is cheaper than any tree walk).

  * cache: M surface points x_i with area weights A_i and direct-light
    irradiance E_i (NEE with Fresnel transmittance folded, the reference's
    irradiance sampling, dipole.cpp preprocess);
  * diffusion: R_d(r) from the classical dipole with the Groenhuis
    internal-reflection parameter A = (1+F_dr)/(1-F_dr);
  * shading: Lo(x, wo) = Ft(eta, wo)/pi * sum_i R_d(|x-x_i|) E_i A_i.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core import rng
from ..core.math import dot, fresnel_dielectric, normalize
from ..models import medium as medium_m
from ..models import sensor as sensor_m
from ..scene import intersect as isect
from ..scene.types import RenderConfig, Scene
from . import common
from .singlescatter import _find_mesh_target


def rd_dipole(r, sigma_a, sigma_s_p, eta):
    """Classical dipole diffuse reflectance R_d(r) (dipole.cpp / Jensen
    2001 eq. 4). All inputs broadcast; channels on the last axis."""
    sigma_t_p = sigma_a + sigma_s_p
    alpha_p = sigma_s_p / jnp.maximum(sigma_t_p, 1e-9)
    sigma_tr = jnp.sqrt(3.0 * sigma_a * sigma_t_p)
    F_dr = -1.440 / (eta * eta) + 0.710 / eta + 0.668 + 0.0636 * eta
    A = (1.0 + F_dr) / jnp.maximum(1.0 - F_dr, 1e-6)
    z_r = 1.0 / jnp.maximum(sigma_t_p, 1e-9)
    z_v = z_r * (1.0 + 4.0 / 3.0 * A)
    r2 = r * r
    d_r = jnp.sqrt(r2 + z_r * z_r)
    d_v = jnp.sqrt(r2 + z_v * z_v)
    c1 = z_r * (sigma_tr * d_r + 1.0) * jnp.exp(-sigma_tr * d_r) \
        / jnp.maximum(d_r ** 3, 1e-12)
    c2 = z_v * (sigma_tr * d_v + 1.0) * jnp.exp(-sigma_tr * d_v) \
        / jnp.maximum(d_v ** 3, 1e-12)
    return alpha_p / (4.0 * jnp.pi) * (c1 + c2)


def _surface_samples(scene, sid, m, seed):
    """Area-weighted surface samples + normals + per-sample area of shape
    `sid` (triangle mesh)."""
    tri_ids = np.argwhere(np.asarray(scene.geo.shape_id) == sid).ravel()
    v0 = np.asarray(scene.geo.v0)[tri_ids]
    e1 = np.asarray(scene.geo.e1)[tri_ids]
    e2 = np.asarray(scene.geo.e2)[tri_ids]
    ng = np.asarray(scene.geo.ng)[tri_ids]
    areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    total = areas.sum()
    rs = np.random.default_rng(seed)
    which = rs.choice(len(tri_ids), size=m, p=areas / total)
    u = rs.random((m, 2)).astype(np.float32)
    su = np.sqrt(u[:, 0])
    b1 = 1.0 - su
    b2 = u[:, 1] * su
    pts = v0[which] + b1[:, None] * e1[which] + b2[:, None] * e2[which]
    return (jnp.asarray(pts), jnp.asarray(ng[which]),
            jnp.full((m,), total / m, jnp.float32))


def render_dipole(scene: Scene, cfg: RenderConfig, seed: int = 0,
                  n_cache: int = 4096, chunk: int = 1024):
    """Dipole-subsurface image of the target mesh shape; returns (H,W,3)."""
    H, W = cfg.height, cfg.width
    npix = H * W
    eps = common.scene_epsilon(scene)
    sid, med_id = _find_mesh_target(scene)
    b_idx = int(np.asarray(scene.shapes.bsdf)[sid])
    eta = float(np.asarray(scene.bsdfs.eta)[b_idx]) if b_idx >= 0 else 1.3
    kind, sa, ss, _, _ = medium_m.params(
        scene.media, jnp.full((1,), med_id, jnp.int32))
    g = float(np.asarray(scene.media.g)[med_id]) \
        if hasattr(scene.media, "g") else 0.0
    sigma_a = sa[0]
    sigma_s_p = ss[0] * (1.0 - g)
    em = scene.emitters
    li = int(np.argmax(np.asarray(em.kind) >= 0))
    l_pos = em.position[li]
    I = em.radiance[li]

    # ---- irradiance cache (dipole.cpp preprocess) ----
    xi, ni, Ai = _surface_samples(scene, sid, n_cache, seed)

    @jax.jit
    def cache_irradiance(xi, ni):
        to_l = jnp.broadcast_to(l_pos, xi.shape) - xi
        d2 = jnp.maximum(jnp.sum(to_l * to_l, -1), 1e-9)
        wl = to_l / jnp.sqrt(d2)[..., None]
        cos_i = jnp.maximum(dot(wl, ni), 0.0)
        blocked = isect.occluded(scene.geo, xi + wl * (2 * eps), wl,
                                 jnp.full((xi.shape[0],), eps),
                                 jnp.sqrt(d2) - 4 * eps)
        F_i, _ = fresnel_dielectric(cos_i, eta)
        E = I[None, :] * ((1.0 - F_i) * cos_i / d2)[..., None]
        return jnp.where(blocked[..., None], 0.0, E)

    Ei = cache_irradiance(xi, ni)

    @jax.jit
    def one_spp(s_idx):
        pixel = jnp.arange(npix, dtype=jnp.uint32)
        smp = rng.make_sampler(
            jnp.asarray(seed, jnp.uint32) ^ jnp.uint32(0xD1B),
            pixel, jnp.full((npix,), s_idx, jnp.uint32))
        u_jit, smp = rng.next_2d(smp)
        px = (pixel % W).astype(jnp.float32) + u_jit[:, 0]
        py = (pixel // W).astype(jnp.float32) + u_jit[:, 1]
        rays = sensor_m.sample_rays(scene.sensor, px, py, W, H)
        hit = isect.intersect(scene.geo, rays.o, rays.d,
                              jnp.full((npix,), eps),
                              jnp.full((npix,), isect.INF))
        on_tgt = hit.valid & (hit.shape_id == sid)
        F_o, _ = fresnel_dielectric(dot(-rays.d, hit.ng), eta)

        def gather(x):
            # chunked (n, M) pairwise R_d * E * A reduction
            acc = jnp.zeros((x.shape[0], 3), jnp.float32)
            for c0 in range(0, xi.shape[0], chunk):
                xc = jax.lax.dynamic_slice_in_dim(xi, c0, chunk, 0)
                Ec = jax.lax.dynamic_slice_in_dim(Ei, c0, chunk, 0)
                Ac = jax.lax.dynamic_slice_in_dim(Ai, c0, chunk, 0)
                d = x[:, None, :] - xc[None, :, :]
                r = jnp.sqrt(jnp.maximum(jnp.sum(d * d, -1), 1e-12))
                rd = rd_dipole(r[..., None], sigma_a[None, None, :],
                               sigma_s_p[None, None, :], eta)
                acc = acc + jnp.sum(rd * Ec[None] * Ac[None, :, None], 1)
            return acc

        Mo = gather(hit.p)
        Lo = Mo * ((1.0 - F_o) / jnp.pi)[..., None]
        return jnp.where(on_tgt[..., None], Lo, 0.0)

    img = jnp.zeros((npix, 3), jnp.float32)
    for s in range(cfg.spp):
        img = img + one_spp(jnp.uint32(s))
    return (img / jnp.float32(cfg.spp)).reshape(H, W, 3)
