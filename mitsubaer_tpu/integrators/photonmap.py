"""Photon mapping: photonmapper + progressive (ppm) / stochastic progressive
(sppm) variants.

Reference: src/integrators/photonmapper/{photonmapper,ppm,sppm}.cpp over the
kd-tree photon map (src/librender/{photon,photonmap,gatherproc}.cpp).

Array-program redesign: the pointer-based balanced kd-tree is replaced by a
**sorted uniform hash grid** — photons are binned to grid cells, sorted by
cell id (one XLA sort), and cell segments located by searchsorted. A gather
then scans the 27 neighbor cells with a *bounded* per-cell photon budget —
branchless, fixed shapes, no pointers. Photon tracing reuses the particle
walk of integrators/ptracer.py with deposits instead of camera connections.

PPM/SPPM follow Knaus-Zwicker: iteration i uses radius
r_i^2 = r_0^2 * prod (j+alpha)/(j+1) and averages the per-iteration images,
which is exactly the reference's progressive estimator without per-pixel
statistics state.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import rng
from ..core.math import Frame, dot
from ..models import bsdf as bsdf_m
from ..models import emitter as emitter_m
from ..models import medium as medium_m
from ..models import phase as phase_m
from ..models import sensor as sensor_m
from ..scene import intersect as isect
from ..scene.types import BSDF_DIFFUSE, RenderConfig, Scene
from . import common
from .ptracer import _sample_emitter_ray
from .volpath import _is_null_surface, _shape_tables

INV_PI = np.float32(1.0 / np.pi)


class PhotonMap(NamedTuple):
    pos: jnp.ndarray      # (M, 3) sorted by cell id
    power: jnp.ndarray    # (M, 3) photon power (flux / N_emitted)
    wi: jnp.ndarray       # (M, 3) incident propagation direction
    valid: jnp.ndarray    # (M,) bool
    cell_of: jnp.ndarray  # (M,) int32 sorted cell ids
    grid_min: jnp.ndarray  # (3,)
    cell_size: jnp.ndarray  # ()
    res: int               # static grid resolution per axis


def trace_photons(scene: Scene, cfg: RenderConfig, n_photons: int, seed,
                  pass_idx, radius: float):
    """Trace photons and build the sorted-grid photon map. Photon deposits
    happen at every non-specular surface hit (photonmapper.cpp global map)."""
    eps = common.scene_epsilon(scene)
    n = n_photons
    act = cfg.bsdf_kinds or None
    smp = rng.make_sampler(jnp.asarray(seed, jnp.uint32) ^ jnp.uint32(0x9407),
                           jnp.arange(n, dtype=jnp.uint32), pass_idx)
    o, d, tp, med, n_e, is_area_e, smp, _, _ = _sample_emitter_ray(scene, smp)
    alive = jnp.any(tp > 0, axis=-1)

    max_bounce = min(cfg.max_depth, 8)
    P_pos = jnp.zeros((max_bounce, n, 3), jnp.float32)
    P_pow = jnp.zeros((max_bounce, n, 3), jnp.float32)
    P_wi = jnp.zeros((max_bounce, n, 3), jnp.float32)
    P_ok = jnp.zeros((max_bounce, n), bool)

    def body(carry, i):
        o, d, tp, med, alive, smp = carry
        hit = isect.intersect(scene.geo, o, d, jnp.full((n,), eps),
                              jnp.full((n,), isect.INF))
        on_surface = alive & hit.valid
        b_idx, _, m_in, m_ex = _shape_tables(scene, hit.shape_id)
        is_null = _is_null_surface(scene, b_idx)
        frame = Frame.from_normal(hit.ng)
        wi_srf = frame.to_local(-d)

        # deposit at non-null surfaces (all photons: the camera pass decides
        # what to gather; matches the reference's global photon map)
        dep = on_surface & ~is_null
        u2, smp = rng.next_2d(smp)
        u1, smp = rng.next_1d(smp)
        bs = bsdf_m.sample(scene.bsdfs, b_idx, wi_srf, u2, u1, active=act)
        new_d = frame.to_world(bs.wo)
        null_cross = on_surface & is_null
        new_d = jnp.where(null_cross[..., None], d, new_d)
        w = jnp.where(null_cross[..., None], 1.0, bs.weight)
        cross = on_surface & (is_null | (dot(new_d, hit.ng) * dot(-d, hit.ng) < 0))
        med = jnp.where(cross, jnp.where(dot(new_d, hit.ng) < 0, m_in, m_ex), med)

        out = (hit.p, jnp.where(dep[..., None], tp, 0.0), d, dep)

        tp2 = tp * w
        u_rr, smp = rng.next_1d(smp)
        tp_rr, survive = common.russian_roulette(tp2, jnp.ones((n,)), u_rr,
                                                 i, cfg)
        tp2 = jnp.where(null_cross[..., None], tp2, tp_rr)
        alive = on_surface & jnp.any(tp2 > 0, -1) & (survive | null_cross)
        o = hit.p + new_d * eps
        return (o, new_d, tp2, med, alive, smp), out

    (o, d, tp, med, alive, smp), (pp, pw, pwi, pok) = jax.lax.scan(
        body, (o, d, tp, med, alive, smp), jnp.arange(max_bounce))

    pos = pp.reshape(-1, 3)
    power = pw.reshape(-1, 3)
    wi = pwi.reshape(-1, 3)
    ok = pok.reshape(-1)

    # ---- sorted uniform grid (cell = gather radius) ----
    res = 128
    lo = scene.aabb_min
    extent = jnp.max(scene.aabb_max - scene.aabb_min)
    cell = jnp.maximum(jnp.asarray(radius, jnp.float32), extent / res)
    ci = jnp.clip(((pos - lo) / cell).astype(jnp.int32), 0, res - 1)
    cell_id = (ci[:, 2] * res + ci[:, 1]) * res + ci[:, 0]
    cell_id = jnp.where(ok, cell_id, res * res * res)  # invalid to the end
    order = jnp.argsort(cell_id)
    return PhotonMap(
        pos=pos[order], power=power[order], wi=wi[order],
        valid=ok[order], cell_of=cell_id[order],
        grid_min=lo, cell_size=cell, res=res,
    )


def gather_radiance(pm: PhotonMap, p, n_srf, refl, radius, n_emitted,
                    max_per_cell: int = 24):
    """Density estimation at surface points p: sum photon power within
    `radius`, diffuse BRDF, divided by pi r^2 (photonmapper.cpp gather).

    Bounded work: scans <= 27 cells x max_per_cell photons per query.
    Dropped photons (overfull cells) slightly darken — the same truncation
    the reference's fixed-size lookup applies (photonmap.cpp knn cap)."""
    res = pm.res
    ci = ((p - pm.grid_min) / pm.cell_size).astype(jnp.int32)
    r2 = radius * radius
    M = pm.cell_of.shape[0]
    # 27-neighbor x per-cell-budget loops as scan/fori (fully unrolled
    # this emits ~650 gather ops and dominates the pass's compile time)
    offs = jnp.asarray([[dx, dy, dz]
                        for dz in (-1, 0, 1)
                        for dy in (-1, 0, 1)
                        for dx in (-1, 0, 1)], jnp.int32)

    def cell_body(total, off):
        cc = ci + off
        inb = jnp.all((cc >= 0) & (cc < res), axis=-1)
        cid = (cc[:, 2] * res + cc[:, 1]) * res + cc[:, 0]
        cid = jnp.where(inb, cid, res * res * res)
        start = jnp.searchsorted(pm.cell_of, cid)

        def k_body(k, tot):
            j = jnp.minimum(start + k, M - 1)
            in_cell = (jnp.take(pm.cell_of, j) == cid) & inb
            pj = jnp.take(pm.pos, j, axis=0)
            d2 = jnp.sum((pj - p) ** 2, axis=-1)
            wj = jnp.take(pm.wi, j, axis=0)
            front = dot(-wj, n_srf) > 0
            sel = in_cell & (d2 < r2) & front
            return tot + jnp.where(
                sel[..., None], jnp.take(pm.power, j, axis=0), 0.0)

        return jax.lax.fori_loop(0, max_per_cell, k_body, total), None

    total, _ = jax.lax.scan(cell_body, jnp.zeros_like(p), offs)
    # Lambertian radiance estimate: rho/pi * flux / (pi r^2 N)
    return refl * INV_PI * total / (jnp.pi * r2 * n_emitted)


@functools.partial(jax.jit, static_argnames=("cfg", "n_photons"),
                   keep_unused=True)
def _pm_pass(scene: Scene, cfg: RenderConfig, n_photons: int, seed, pass_idx,
             radius):
    """One photon-map iteration: trace photons, then render the camera image
    with density estimation at the first non-specular hit (final gather via
    direct illumination stays analytic: NEE handles direct light, photons
    provide indirect — photonmapper.cpp's separation)."""
    H, W = cfg.height, cfg.width
    npix = H * W
    eps = common.scene_epsilon(scene)
    act = cfg.bsdf_kinds or None
    pm = trace_photons(scene, cfg, n_photons, seed, pass_idx, radius)

    pixel = jnp.arange(npix, dtype=jnp.uint32)
    smp = rng.make_sampler(seed, pixel, pass_idx,
                           n_samples=max(cfg.spp, 1))
    jit2, smp = rng.next_2d(smp)
    px = (pixel % W).astype(jnp.float32) + jit2[:, 0]
    py = (pixel // W).astype(jnp.float32) + jit2[:, 1]
    rays = sensor_m.sample_rays(scene.sensor, px, py, W, H)
    o, d = rays.o, rays.d

    # walk through specular/null surfaces to the first diffuse hit
    tp = jnp.ones((npix, 3), jnp.float32)
    L = jnp.zeros((npix, 3), jnp.float32)
    alive = jnp.ones((npix,), bool)
    hit_p = jnp.zeros((npix, 3))
    hit_n = jnp.zeros((npix, 3))
    hit_refl = jnp.zeros((npix, 3))
    found = jnp.zeros((npix,), bool)

    for bounce in range(4):
        hit = isect.intersect(scene.geo, o, d, jnp.full((npix,), eps),
                              jnp.full((npix,), isect.INF))
        on_surface = alive & hit.valid
        b_idx, e_idx, m_in, m_ex = _shape_tables(scene, hit.shape_id)
        is_null = _is_null_surface(scene, b_idx)
        # emitter hit contributes directly
        le = emitter_m.eval_hit(scene, e_idx, hit.ng, -d)
        L = L + jnp.where((on_surface & (e_idx >= 0))[..., None], tp * le, 0.0)

        from ..core import smalltab
        nb = scene.bsdfs.kind.shape[0]
        bk = jnp.where(b_idx >= 0, smalltab.take(
            scene.bsdfs.kind, jnp.clip(b_idx, 0, nb - 1)), -1)
        refl = smalltab.take(scene.bsdfs.reflectance,
                             jnp.clip(b_idx, 0, nb - 1))
        diffuse_hit = on_surface & (bk == BSDF_DIFFUSE) & ~found
        hit_p = jnp.where(diffuse_hit[..., None], hit.p, hit_p)
        hit_n = jnp.where(diffuse_hit[..., None], hit.ng, hit_n)
        hit_refl = jnp.where(diffuse_hit[..., None], tp * refl, hit_refl)
        found = found | diffuse_hit

        # continue through specular / null only
        frame = Frame.from_normal(hit.ng)
        u2, smp = rng.next_2d(smp)
        u1, smp = rng.next_1d(smp)
        bs = bsdf_m.sample(scene.bsdfs, b_idx, frame.to_local(-d), u2, u1,
                           active=act)
        new_d = jnp.where(is_null[..., None], d, frame.to_world(bs.wo))
        w = jnp.where(is_null[..., None], 1.0, bs.weight)
        cont = on_surface & ~found & (bs.delta | is_null)
        tp = jnp.where(cont[..., None], tp * w, tp)
        o = jnp.where(cont[..., None], hit.p + new_d * eps, o)
        d = jnp.where(cont[..., None], new_d, d)
        alive = cont

    # indirect radiance via photon density estimation
    Lp = gather_radiance(pm, hit_p, hit_n, hit_refl, radius, n_photons)
    L = L + jnp.where(found[..., None], Lp, 0.0)
    return L


def render_photonmap(scene: Scene, cfg: RenderConfig, seed: int = 0,
                     n_photons: int = None, initial_radius: float = None,
                     alpha: float = 0.7):
    """Photon-map render. cfg.spp controls the number of progressive
    iterations (ppm.cpp/sppm.cpp); alpha is the Knaus-Zwicker radius
    shrink exponent. Returns (H, W, 3)."""
    H, W = cfg.height, cfg.width
    if n_photons is None:
        n_photons = max(H * W, 1 << 16)
    if initial_radius is None:
        ext = float(np.asarray(scene.aabb_max - scene.aabb_min).max())
        initial_radius = 0.015 * ext
    img = jnp.zeros((H * W, 3), jnp.float32)
    r2 = initial_radius ** 2
    iters = max(cfg.spp // 4, 1)
    for i in range(iters):
        img = img + _pm_pass(scene, cfg, n_photons, jnp.uint32(seed),
                             jnp.uint32(i), jnp.float32(np.sqrt(r2)))
        r2 = r2 * (i + 1 + alpha) / (i + 2)  # progressive shrink
    return (img / iters).reshape(H, W, 3)
