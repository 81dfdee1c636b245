"""Instant-radiosity VPL integrator.

Reference: src/integrators/vpl/vpl.cpp — trace a small set of light
subpaths, store every vertex as a virtual point light (VPL), then shade
each camera hit by summing the clamped contribution of all VPLs. The
reference uses this as its preview/GI integrator; here it completes the
integrator inventory and doubles as a many-light validation path (on a
diffuse scene VPL shading equals path tracing up to the distance clamp).

Array-program design: VPL generation is one short batched light walk (reusing the
ptracer emission sampling); shading is a `lax.scan` over VPLs where each
step evaluates the (npix*spp)-wide camera-hit batch against ONE VPL —
camera-side BSDF, VPL-side kernel, clamped geometry term, and a
media-aware attenuated visibility walk. No kd-tree, no irradiance cache:
the scan body is a dense, fully-masked kernel XLA fuses well.

Radiometry (all evals include their cosine, Mitsuba convention):
  L(x->cam) = f_x(wi_cam, w_xy) * k_y(w_yx) * V(x,y) * Phi_y / max(d^2, c^2)
  k_y = cos_y/pi            for area-emission VPLs   (Phi = L*pi*A/pdf)
      = 1/(4*pi)            for point-emission VPLs  (Phi = I*4*pi)
      = falloff(w_yx)       for spot-emission VPLs   (Phi = I, falloff from
                            the stored emitter id, spot.cpp falloffCurve)
      = f_y(wi_y, w_yx)     for surface-bounce VPLs  (Phi = path throughput)
Directional/constant/envmap emission vertices are direction-delta and are
skipped as VPLs (their bounce vertices still contribute); scenes lit only
by such emitters should use path/volpath instead.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import rng
from ..core.math import Frame, dot, normalize
from ..models import bsdf as bsdf_m
from ..models import emitter as emitter_m
from ..models import medium as medium_m
from ..models import sensor as sensor_m
from ..scene import intersect as isect
from ..scene.types import EM_AREA, EM_POINT, EM_SPOT, RenderConfig, Scene
from . import common
from .ptracer import _sample_emitter_ray
from .volpath import (
    _is_null_surface,
    _shape_tables,
    attenuated_visibility,
    segment_transmittance,
)

K_AREA, K_POINT, K_SURFACE, K_SPOT = 0, 1, 2, 3


def generate_vpls(scene: Scene, cfg: RenderConfig, n_paths: int, seed,
                  max_bounce: int = 3):
    """Trace n_paths light subpaths; returns a dict of stacked VPL arrays
    of length NV = n_paths * (1 + max_bounce) (invalid slots have flux 0)."""
    eps = common.scene_epsilon(scene)
    act = cfg.bsdf_kinds or None
    lane = jnp.arange(n_paths, dtype=jnp.uint32)
    smp = rng.make_sampler(jnp.asarray(seed, jnp.uint32) ^ jnp.uint32(0x1D5),
                           lane, jnp.zeros((n_paths,), jnp.uint32))
    o, d, w, med, n_e, is_area_e, smp, em_idx, em_kind = \
        _sample_emitter_ray(scene, smp)
    bricks = medium_m.DensityBricks(scene.media)
    # emission VPLs: area (cos/pi kernel), point (isotropic kernel) and spot
    # (falloff kernel evaluated at shading time from the stored emitter id —
    # the reference's generateVPLs stores an EPointEmitterVPL for spots too,
    # librender/vpl.cpp:116). Directional/constant/envmap emission vertices
    # are direction-delta and are skipped (their bounce vertices still
    # contribute).
    is_spot_e = em_kind == EM_SPOT
    is_point_e = em_kind == EM_POINT
    emit_ok = is_area_e | is_point_e | is_spot_e
    # spot VPL flux is the bare intensity: the falloff kernel supplies the
    # directional dependence deterministically (w is falloff(d)*omega_cone
    # weighted for the *walk*, wrong as a VPL flux)
    from ..core import smalltab

    I_spot = smalltab.take(scene.emitters.radiance, em_idx)
    w_emit = jnp.where(is_spot_e[..., None], I_spot, w)

    vp, vn, vwi, vflux, vbsdf, vkern, vem = [], [], [], [], [], [], []
    vp.append(o)
    vn.append(n_e)
    vwi.append(d)                     # unused for emission kernels
    vflux.append(jnp.where(emit_ok[..., None], w_emit, 0.0))
    vbsdf.append(jnp.full((n_paths,), -1, jnp.int32))
    vkern.append(jnp.where(is_area_e, K_AREA,
                           jnp.where(is_spot_e, K_SPOT, K_POINT))
                 .astype(jnp.int32))
    vem.append(em_idx.astype(jnp.int32))

    tp = w
    alive = jnp.any(tp > 0, axis=-1)
    # media-aware walk: each iteration consumes one surface event — a real
    # scatter stores a VPL and samples the BSDF; a null (medium-boundary)
    # crossing passes straight through with the medium switched. Segment
    # transmittance attenuates tp either way (vpl.cpp's walk runs inside
    # evalTransmittance-attenuated space).
    for _b in range(max_bounce):
        hit = isect.intersect(scene.geo, o, d, jnp.full((n_paths,), eps),
                              jnp.full((n_paths,), isect.INF))
        seg = jnp.where(hit.valid, hit.t, 0.0)
        tr_seg, smp = segment_transmittance(scene, med, o, d, seg, smp,
                                            alive & hit.valid, bricks=bricks)
        tp = tp * jnp.where((alive & hit.valid)[..., None], tr_seg, 1.0)
        b_idx, e_idx, m_in, m_ex = _shape_tables(scene, hit.shape_id)
        is_null = _is_null_surface(scene, b_idx)
        ok = alive & hit.valid & ~is_null & jnp.any(tp > 0, axis=-1)
        crossing = alive & hit.valid & is_null
        frame = Frame.from_normal(hit.ng)
        wi_l = frame.to_local(-d)
        vp.append(hit.p)
        vn.append(hit.ng)
        vwi.append(wi_l)
        vflux.append(jnp.where(ok[..., None], tp, 0.0))
        vbsdf.append(jnp.where(ok, b_idx, 0))
        vkern.append(jnp.full((n_paths,), K_SURFACE, jnp.int32))
        vem.append(jnp.full((n_paths,), -1, jnp.int32))
        # continue the walk: BSDF sample on real surfaces, pass-through on
        # null boundaries (direction unchanged, medium switched)
        u2, smp = rng.next_2d(smp)
        u1, smp = rng.next_1d(smp)
        bs = bsdf_m.sample(scene.bsdfs, b_idx, wi_l, u2, u1, active=act)
        d_new = jnp.where(crossing[..., None], d, frame.to_world(bs.wo))
        tp = tp * jnp.where(ok[..., None], bs.weight, 1.0)
        entering = dot(d_new, hit.ng) < 0
        med = jnp.where(crossing, jnp.where(entering, m_in, m_ex), med)
        d = d_new
        o = hit.p + d * eps
        alive = (ok & (bs.pdf > 0) | crossing) & jnp.any(tp > 0, axis=-1)

    return dict(
        p=jnp.concatenate(vp), n=jnp.concatenate(vn),
        wi=jnp.concatenate(vwi), flux=jnp.concatenate(vflux),
        bsdf=jnp.concatenate(vbsdf), kern=jnp.concatenate(vkern),
        em=jnp.concatenate(vem), n_paths=n_paths,
    )


def render_vpl(scene: Scene, cfg: RenderConfig, seed: int = 0,
               n_paths: int | None = None, clamp: float | None = None):
    """Render with VPL shading; returns (H, W, 3) float32.

    clamp: minimum squared distance in the geometry term (vpl.cpp's
    bias-for-variance trade); defaults to (2% of the scene diagonal)^2."""
    H, W = cfg.height, cfg.width
    npix = H * W
    eps = common.scene_epsilon(scene)
    act = cfg.bsdf_kinds or None
    if n_paths is None:
        n_paths = max(8, min(128, cfg.spp * 4))
    diag = jnp.linalg.norm(scene.aabb_max - scene.aabb_min)
    c2 = jnp.float32((0.02 * diag) ** 2 if clamp is None else clamp * clamp)
    bricks = medium_m.DensityBricks(scene.media)

    vpls = generate_vpls(scene, cfg, n_paths, seed,
                         max_bounce=max(1, min(cfg.max_depth - 1, 3)))
    inv_paths = 1.0 / jnp.float32(n_paths)

    def one_spp(s_idx):
        pixel = jnp.arange(npix, dtype=jnp.uint32)
        smp = rng.make_sampler(jnp.asarray(seed, jnp.uint32), pixel,
                               jnp.full((npix,), s_idx, jnp.uint32))
        u_jit, smp = rng.next_2d(smp)
        px = (pixel % W).astype(jnp.float32) + u_jit[:, 0]
        py = (pixel // W).astype(jnp.float32) + u_jit[:, 1]
        rays = sensor_m.sample_rays(scene.sensor, px, py, W, H)
        # primary walk: cross up to 3 null (medium-boundary) surfaces,
        # tracking the medium and accumulating segment transmittance, so
        # camera hits inside bounded media shade with the correct medium
        # (in-scattering along the primary ray is not modelled — the
        # standard VPL preview approximation)
        med_x = jnp.broadcast_to(scene.camera_medium, (npix,)).astype(
            jnp.int32)
        o_c, d_c0 = rays.o, rays.d
        tr0 = jnp.ones((npix, 3), jnp.float32)
        walking = jnp.ones((npix,), bool)
        smp_w = smp
        for _c in range(3 + 1):
            hit = isect.intersect(scene.geo, o_c, d_c0,
                                  jnp.full((npix,), eps),
                                  jnp.full((npix,), isect.INF))
            seg = jnp.where(hit.valid, hit.t, 0.0)
            tr_seg, smp_w = segment_transmittance(
                scene, med_x, o_c, d_c0, seg, smp_w, walking & hit.valid,
                bricks=bricks)
            tr0 = tr0 * jnp.where((walking & hit.valid)[..., None],
                                  tr_seg, 1.0)
            b_idx, e_idx, m_in, m_ex = _shape_tables(scene, hit.shape_id)
            is_null = _is_null_surface(scene, b_idx)
            crossing = walking & hit.valid & is_null
            entering = dot(rays.d, hit.ng) < 0
            med_x = jnp.where(crossing,
                              jnp.where(entering, m_in, m_ex), med_x)
            o_c = jnp.where(crossing[..., None], hit.p + d_c0 * eps, o_c)
            walking = crossing
        smp = smp_w
        frame = Frame.from_normal(hit.ng)
        wi_l = frame.to_local(-rays.d)
        valid = hit.valid & ~_is_null_surface(scene, b_idx)

        # directly visible emitters (VPLs only carry reflected transport)
        le = emitter_m.eval_hit(scene, e_idx, hit.ng, -rays.d)
        L0 = jnp.where((valid & (e_idx >= 0))[..., None], le * tr0, 0.0)
        env = emitter_m.env_radiance(scene, rays.d)
        L0 = L0 + jnp.where(hit.valid[..., None], 0.0, env * tr0)

        def body(carry, v):
            L, smp = carry
            yp, yn, ywi, yflux, ybsdf, ykern, yem = v
            to_y = yp[None, :] - hit.p
            d2 = jnp.sum(to_y * to_y, axis=-1)
            dist = jnp.sqrt(jnp.maximum(d2, 1e-12))
            w_xy = to_y / dist[..., None]
            f_x = bsdf_m.eval(scene.bsdfs, b_idx, wi_l,
                              frame.to_local(w_xy), active=act)
            # VPL-side kernel
            fr_y = Frame.from_normal(jnp.broadcast_to(yn, (npix, 3)))
            w_yx_l = fr_y.to_local(-w_xy)
            cos_y = jnp.maximum(w_yx_l[..., 2], 0.0)
            f_y = bsdf_m.eval(scene.bsdfs,
                              jnp.full((npix,), ybsdf, jnp.int32),
                              jnp.broadcast_to(ywi, (npix, 3)), w_yx_l,
                              active=act)
            k_area = (cos_y / jnp.pi)[..., None]
            k_point = jnp.full((npix, 1), 1.0 / (4.0 * jnp.pi))
            # spot: falloff(w_yx) from the stored emitter id (spot.cpp
            # falloffCurve); flux carries the bare intensity
            em = scene.emitters
            yem_c = jnp.clip(yem, 0, em.kind.shape[0] - 1)
            sdir = em.direction[yem_c]
            cutoff = em.cutoff_cos[yem_c]
            beam_c = em.beam_falloff_cos[yem_c]
            ct = jnp.sum(-w_xy * sdir[None, :], axis=-1)
            k_spot = jnp.clip((ct - cutoff)
                              / jnp.maximum(beam_c - cutoff, 1e-6),
                              0.0, 1.0)[..., None]
            k = jnp.where(ykern == K_AREA, k_area,
                          jnp.where(ykern == K_POINT, k_point,
                                    jnp.where(ykern == K_SPOT, k_spot, f_y)))
            g = 1.0 / jnp.maximum(d2, c2)
            contrib = f_x * k * (jnp.broadcast_to(yflux, (npix, 3))
                                 * (g * inv_paths)[..., None]) * tr0
            ok = (valid & jnp.any(contrib > 0, axis=-1)
                  & jnp.all(jnp.isfinite(contrib), axis=-1))
            tr, smp = attenuated_visibility(
                scene, eps, hit.p + w_xy * eps, w_xy,
                dist - 2 * eps, med_x, smp, ok, bricks=bricks)
            L = L + jnp.where(ok[..., None], contrib * tr, 0.0)
            return (L, smp), None

        (L, _), _ = jax.lax.scan(
            body, (L0, smp),
            (vpls["p"], vpls["n"], vpls["wi"], vpls["flux"], vpls["bsdf"],
             vpls["kern"], vpls["em"]))
        return L

    img = jnp.zeros((npix, 3), jnp.float32)
    f = jax.jit(one_spp)
    for s in range(cfg.spp):
        img = img + f(jnp.uint32(s))
    return (img / jnp.float32(cfg.spp)).reshape(H, W, 3)
