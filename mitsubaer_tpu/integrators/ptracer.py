"""Adjoint particle tracer (light tracing with per-vertex camera
connections).

Reference: src/integrators/ptracer/{ptracer,ptracer_proc}.cpp — particles
start at emitters, random-walk through the scene, and every vertex connects
to the sensor, splatting importance-weighted radiance onto the film. This is
also the general (s>=1, t=1) light-image family of the reference's BDPT
(bdpt_proc.cpp putLightSample), generalizing the collimated-beam splat pass
(integrators/render.py beam_splat_pass) to all emitters and path lengths.

Array-program design: a fixed-width particle wavefront advanced by a bounded
batch-synchronous loop; camera connections use the same attenuated
visibility walker as camera-side NEE, and land on the film through ONE
scatter-add per bounce (the only scatter in the engine; particle counts are
modest because light tracing is a coverage/validation integrator here).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import rng
from ..core.math import Frame, dot, normalize
from ..models import bsdf as bsdf_m
from ..models import emitter as emitter_m
from ..models import medium as medium_m
from ..models import phase as phase_m
from ..models import sensor as sensor_m
from ..scene import intersect as isect
from ..scene.types import (
    EM_AREA,
    EM_COLLIMATED,
    EM_CONSTANT,
    EM_DIRECTIONAL,
    EM_ENVMAP,
    EM_POINT,
    EM_SPOT,
    MED_HETEROGENEOUS,
    MED_HOMOGENEOUS,
    RenderConfig,
    Scene,
)
from . import common
from .volpath import _is_null_surface, _shape_tables, attenuated_visibility


def _sample_emitter_ray(scene: Scene, smp):
    """Pick an emitter uniformly and sample an emission ray.

    Returns (o, d, power_weight (N,3), medium (N,), smp): power_weight is
    emitted-power/pdf so that splatting sum(weight * f * W_e)/Np is
    unbiased. Mirrors the reference's Scene::sampleEmitterRay."""
    em = scene.emitters
    ne = em.kind.shape[0]
    u_sel, smp = rng.next_1d(smp)
    u_pos, smp = rng.next_2d(smp)
    u_dir, smp = rng.next_2d(smp)
    n = u_sel.shape[0]
    e_idx = jnp.clip((u_sel * ne).astype(jnp.int32), 0, ne - 1)
    u_tri = jnp.minimum(u_sel * ne - e_idx, 0.9999994)

    from ..core import smalltab, warp

    kind = smalltab.take(em.kind, e_idx)
    radiance = smalltab.take(em.radiance, e_idx)
    pos = smalltab.take(em.position, e_idx)
    edir = smalltab.take(em.direction, e_idx)
    area = smalltab.take(em.area, e_idx)

    # area: uniform position, cosine-weighted direction about the normal;
    # weight = L * pi * A  (radiance -> power with the cos/pdf cancelling)
    p_area, n_area, _ = emitter_m._sample_area_position(scene, e_idx, u_pos,
                                                        u_tri)
    d_cos = Frame.from_normal(n_area).to_world(
        warp.square_to_cosine_hemisphere(u_dir))
    w_area = radiance * (jnp.pi * area)[..., None]

    # point: uniform-sphere direction; weight = I * 4pi
    d_sph = warp.square_to_uniform_sphere(u_dir)
    w_point = radiance * (4.0 * jnp.pi)

    # spot: sample the cone uniformly, weight by falloff * cone solid angle
    cutoff = smalltab.take(em.cutoff_cos, e_idx)
    beam = smalltab.take(em.beam_falloff_cos, e_idx)
    ct_cone = 1.0 - u_dir[..., 0] * (1.0 - cutoff)
    st_cone = jnp.sqrt(jnp.maximum(1.0 - ct_cone * ct_cone, 0.0))
    phi = 2.0 * jnp.pi * u_dir[..., 1]
    d_cone = Frame.from_normal(edir).to_world(jnp.stack(
        [st_cone * jnp.cos(phi), st_cone * jnp.sin(phi), ct_cone], axis=-1))
    falloff = jnp.clip((ct_cone - cutoff) / jnp.maximum(beam - cutoff, 1e-6),
                       0.0, 1.0)
    omega_cone = 2.0 * jnp.pi * (1.0 - cutoff)
    w_spot = radiance * (falloff * omega_cone)[..., None]

    is_area = kind == EM_AREA
    is_point = kind == EM_POINT
    is_spot = kind == EM_SPOT
    is_coll = kind == EM_COLLIMATED
    is_dir = kind == EM_DIRECTIONAL
    is_const = kind == EM_CONSTANT
    is_env = kind == EM_ENVMAP

    # distant emitters (directional/constant/envmap) emit from the scene
    # bounding sphere (constant.cpp/envmap.cpp sampleRay): pick an emission
    # direction de, then a uniform point on the disk of radius R facing de,
    # pushed back outside the sphere. pdf = pdf(de) * 1/(pi R^2).
    center = 0.5 * (scene.aabb_min + scene.aabb_max)
    R = 0.5 * jnp.linalg.norm(scene.aabb_max - scene.aabb_min) * 1.01
    if emitter_m._has_envmap(scene):
        d_env, pdf_env, L_env = emitter_m.sample_env_direction(scene, u_pos)
    else:
        d_env, pdf_env, L_env = d_sph, jnp.ones_like(u_sel), radiance
    # d_env points from the scene toward the environment; light propagates
    # the other way. edir is already the propagation direction.
    de = jnp.where(is_dir[..., None], edir,
                   jnp.where(is_env[..., None], -d_env, -d_sph))
    fr_disk = Frame.from_normal(de)
    disk2 = warp.square_to_uniform_disk_concentric(u_dir)
    p_disk = (center - de * R
              + fr_disk.to_world(jnp.concatenate(
                  [disk2 * R, jnp.zeros_like(disk2[..., :1])], axis=-1)))
    disk_area = jnp.pi * R * R
    w_dir = radiance * disk_area            # irradiance E * pi R^2
    w_const = radiance * (4.0 * jnp.pi * disk_area)  # L/(1/4pi * 1/(piR^2))
    w_env = L_env * (disk_area / jnp.maximum(pdf_env, 1e-12))[..., None]

    distant = is_dir | is_const | is_env
    o = jnp.where(is_area[..., None], p_area, pos)
    o = jnp.where(distant[..., None], p_disk, o)
    d = jnp.where(is_area[..., None], d_cos, d_sph)
    d = jnp.where(is_spot[..., None], d_cone, d)
    d = jnp.where(distant[..., None], de, d)
    d = jnp.where(is_coll[..., None], edir, d)
    w = jnp.where(is_area[..., None], w_area, w_point)
    w = jnp.where(is_spot[..., None], w_spot, w)
    w = jnp.where(is_coll[..., None], radiance, w)  # beam power as-is
    w = jnp.where(is_dir[..., None], w_dir, w)
    w = jnp.where(is_const[..., None], w_const, w)
    w = jnp.where(is_env[..., None], w_env, w)
    w = w * jnp.float32(ne)  # uniform emitter pick

    # emission-side medium: area emitters start in the shape's exterior;
    # point-likes in the camera medium (scene-global media)
    se = smalltab.take(em.shape_id, e_idx)
    se_c = jnp.clip(se, 0, scene.shapes.exterior.shape[0] - 1)
    med_area = jnp.where(se >= 0, smalltab.take(scene.shapes.exterior, se_c),
                         -1)
    med = jnp.where(is_area, med_area,
                    jnp.broadcast_to(scene.camera_medium, (n,)).astype(jnp.int32))
    return o, d, w, med, n_area, is_area, smp, e_idx, kind


def trace_particles(scene: Scene, cfg: RenderConfig, n_particles: int, seed,
                    pass_idx):
    """Trace one wavefront of light particles; returns the (H*W, 3) splat sum
    (divide by total particles and multiply by npix for the film estimate)."""
    H, W = cfg.height, cfg.width
    eps = common.scene_epsilon(scene)
    media = scene.media
    bricks = medium_m.DensityBricks(media)
    cam_p = scene.sensor.to_world[:3, 3]
    pact = cfg.phase_kinds or None
    act = cfg.bsdf_kinds or None

    lane = jnp.arange(n_particles, dtype=jnp.uint32)
    smp = rng.make_sampler(jnp.asarray(seed, jnp.uint32) ^ jnp.uint32(0x97AC),
                           lane, pass_idx)
    o, d, tp, med, n_e, is_area_e, smp, _, _ = _sample_emitter_ray(scene, smp)
    n = n_particles
    film = jnp.zeros((H * W, 3), jnp.float32)
    alive = jnp.any(tp > 0, axis=-1)

    def connect(film, vtx, f_vtx, tp, med_v, smp, ok):
        """Connect vertices to the camera: value = tp * f(->cam) * Tr * W_e."""
        to_c = cam_p - vtx
        dist = jnp.sqrt(jnp.maximum(jnp.sum(to_c * to_c, -1), 1e-12))
        d_c = to_c / dist[..., None]
        fs = sensor_m.project(scene.sensor, vtx, W, H)
        ok = ok & fs.valid
        tr, smp = attenuated_visibility(
            scene, eps, vtx + d_c * eps, d_c, dist - 2 * eps, med_v, smp, ok,
            bricks=bricks)
        val = (tp * f_vtx * tr
               * (fs.inv_pixel_omega / jnp.maximum(dist * dist, 1e-12))[..., None])
        # NOTE: importance W_e = inv_pixel_omega converts the per-area
        # connection into the mean-radiance pixel estimate; 1/d^2 is the
        # geometric term of the vertex-to-aperture connection.
        val = jnp.where((ok & jnp.all(jnp.isfinite(val), -1))[..., None],
                        val, 0.0)
        px = jnp.clip(fs.px.astype(jnp.int32), 0, W - 1)
        py = jnp.clip(fs.py.astype(jnp.int32), 0, H - 1)
        film = film.at[py * W + px].add(val)
        return film, smp

    # s=1 family: the emission vertex itself is visible to the camera
    # (bdpt's (s=1, t=1) light-image connection, bdpt_proc.cpp). With
    # tp = L*pi*A for area emitters, the emitted kernel toward the camera
    # is cos(theta_e)/pi.
    to_c0 = normalize(jnp.broadcast_to(cam_p, (n, 3)) - o)
    cos_e = jnp.maximum(dot(n_e, to_c0), 0.0)
    f_emit = jnp.broadcast_to((cos_e / jnp.pi)[..., None], (n, 3))
    ok0 = alive & is_area_e & (cos_e > 0)
    film, smp = connect(film, o + n_e * eps, f_emit, tp, med, smp, ok0)

    state = (o, d, tp, med, alive, film, smp, jnp.int32(0))

    def cond(st):
        return jnp.any(st[4]) & (st[7] < cfg.max_depth)

    def body(st):
        o, d, tp, med, alive, film, smp, depth = st
        hit = isect.intersect(scene.geo, o, d, jnp.full((n,), eps),
                              jnp.full((n,), isect.INF))
        _, t_scene = isect.ray_aabb(o, d, scene.aabb_min, scene.aabb_max)
        t_far = jnp.where(hit.valid, hit.t, jnp.maximum(t_scene, 0.0))

        # medium transport along the segment
        kind_m, sa, ss, sw, scale = medium_m.params(media, med)
        u_h, smp = rng.next_1d(smp)
        uc_h, smp = rng.next_1d(smp)
        hs, ht, hw, _ = medium_m.sample_distance_homogeneous(
            sa, ss, sw, t_far, u_h, uc_h)
        in_hom = alive & (kind_m == MED_HOMOGENEOUS)
        in_het = alive & (kind_m == MED_HETEROGENEOUS)
        whit, wdist, ww, wp, smp, _ = medium_m.sample_distance_woodcock(
            media, sa, ss, scale, o, d, t_far, smp, in_het, bricks=bricks)
        scattered = (in_hom & hs) | (in_het & whit)
        m_t = jnp.where(in_het, wdist, ht)
        m_w = jnp.where(in_het[..., None], ww, jnp.where(in_hom[..., None], hw, 1.0))
        tp = tp * jnp.where(alive[..., None], m_w, 1.0)
        m_p = o + m_t[..., None] * d

        on_surface = alive & ~scattered & hit.valid
        escaped = alive & ~scattered & ~hit.valid
        vtx = jnp.where(scattered[..., None], m_p, hit.p)

        b_idx, _, m_in, m_ex = _shape_tables(scene, hit.shape_id)
        is_null = _is_null_surface(scene, b_idx)
        frame = Frame.from_normal(hit.ng)
        wi_srf = frame.to_local(-d)

        # ---- camera connection at this vertex ----
        to_c = normalize(cam_p - vtx)
        f_srf = bsdf_m.eval(scene.bsdfs, b_idx, wi_srf, frame.to_local(to_c),
                            active=act)
        f_med = phase_m.eval(media.phase, med, d, to_c, active=pact)[..., None]
        f_vtx = jnp.where(scattered[..., None], f_med, f_srf)
        ok = (scattered | (on_surface & ~is_null)) & jnp.any(f_vtx > 0, -1)
        med_v = jnp.where(scattered, med,
                          jnp.where(dot(to_c, hit.ng) > 0, m_ex, m_in))
        film, smp = connect(film, vtx, f_vtx, tp, med_v, smp, ok)

        # ---- continue the walk ----
        u2, smp = rng.next_2d(smp)
        u1, smp = rng.next_1d(smp)
        ps = phase_m.sample(media.phase, med, d, u2, active=pact)
        bs = bsdf_m.sample(scene.bsdfs, b_idx, wi_srf, u2, u1, active=act)
        wo_world = frame.to_world(bs.wo)
        new_d = jnp.where(scattered[..., None], ps.wo, wo_world)
        w_scat = jnp.where(scattered[..., None], ps.weight[..., None], bs.weight)

        null_cross = on_surface & is_null
        new_d = jnp.where(null_cross[..., None], d, new_d)
        w_scat = jnp.where(null_cross[..., None], 1.0, w_scat)
        cross = on_surface & (is_null | (dot(new_d, hit.ng) * dot(-d, hit.ng) < 0))
        entering = dot(new_d, hit.ng) < 0
        med = jnp.where(cross, jnp.where(entering, m_in, m_ex), med)

        tp = tp * jnp.where((scattered | on_surface)[..., None], w_scat, 1.0)
        u_rr, smp = rng.next_1d(smp)
        tp_rr, survive = common.russian_roulette(
            tp, jnp.ones((n,)), u_rr, depth, cfg)
        tp = jnp.where(null_cross[..., None], tp, tp_rr)
        alive = ((scattered | on_surface) & ~escaped
                 & jnp.any(tp > 0, -1) & (survive | null_cross))
        o = vtx + new_d * eps
        d = jnp.where(alive[..., None], new_d, d)
        return (o, d, tp, med, alive, film, smp, depth + 1)

    state = jax.lax.while_loop(cond, body, state)
    return state[5]


def render_ptracer(scene: Scene, cfg: RenderConfig, seed: int = 0):
    """Full light-traced image: spp * npix particles, averaged per pixel."""
    import functools

    H, W = cfg.height, cfg.width
    n_per_pass = H * W
    n_pass = max(cfg.spp, 1)

    @functools.partial(jax.jit, static_argnames=("cfg", "np_"), keep_unused=True)
    def one(scene, film, cfg, np_, seed, pidx):
        return film + trace_particles(scene, cfg, np_, seed, pidx)

    film = jnp.zeros((H * W, 3), jnp.float32)
    for i in range(n_pass):
        film = one(scene, film, cfg, n_per_pass, jnp.uint32(seed),
                   jnp.uint32(i))
    total = n_pass * n_per_pass
    # each pixel estimate: sum(splats) * (1 / total_particles)
    return (film / total).reshape(H, W, 3)
