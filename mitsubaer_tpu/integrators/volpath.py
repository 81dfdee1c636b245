"""Volumetric path tracer with attenuated NEE + MIS and beam ("collimated")
next-event estimation.

Reference: src/integrators/path/volpath.cpp (+ volpath_simple.cpp), with
Scene::sampleAttenuatedEmitterDirect / evalTransmittanceAll
(scene.cpp:619-668, 854-876) for shadow rays that cross index-matched (null)
medium boundaries.

Wavefront redesign: one lax.while_loop advances all lanes a bounce at a time;
lanes in a medium run distance sampling (analytic homogeneous or Woodcock
delta tracking), lanes on surfaces run the path.cpp surface logic; null
boundaries cross without consuming path depth, updating the per-lane current
medium (the reference tracks this via Intersection::getTargetMedium).

The collimated beam emitter is delta in position AND direction, so classical
NEE has measure zero; the reference renders such scenes with BDPT light
subpaths (bdpt_proc.cpp). Here we add the equivalent camera-side technique:
*beam NEE* — every path vertex samples a point on the beam segment inside
the medium (equiangular) and connects through one extra medium vertex. The
same family of paths cannot be produced by phase/BSDF sampling (measure
zero), so no MIS is needed. The missing single-scatter (beam -> camera)
family is covered by a separate light-tracing splat pass (render driver).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import rng, smalltab
from ..core.math import Frame, dot, length, mis_weight_power, normalize
from ..models import bsdf as bsdf_m
from ..models import texture as texture_m
from ..models import emitter as emitter_m
from ..models import medium as medium_m
from ..models import phase as phase_m
from ..scene import intersect as isect
from ..scene.types import (
    BSDF_NULL,
    EM_COLLIMATED,
    MED_HETEROGENEOUS,
    MED_HOMOGENEOUS,
    RenderConfig,
    Scene,
)
from . import common


def _shape_tables(scene, shape_id):
    ns = scene.shapes.bsdf.shape[0]
    i = jnp.clip(shape_id, 0, ns - 1)
    ok = shape_id >= 0
    b = jnp.where(ok, smalltab.take(scene.shapes.bsdf, i), -1)
    e = jnp.where(ok, smalltab.take(scene.shapes.emitter, i), -1)
    mi = jnp.where(ok, smalltab.take(scene.shapes.interior, i), -1)
    mx = jnp.where(ok, smalltab.take(scene.shapes.exterior, i), -1)
    return b, e, mi, mx


def _is_null_surface(scene, bsdf_idx):
    nb = scene.bsdfs.kind.shape[0]
    kind = smalltab.take(scene.bsdfs.kind, jnp.clip(bsdf_idx, 0, nb - 1))
    return (bsdf_idx < 0) | (kind == BSDF_NULL)


def segment_transmittance(scene, medium_idx, o, d, dist, smp, active,
                          differentiable: bool = False, bricks=None):
    """Transmittance of a straight segment inside medium `medium_idx`
    (-1 = vacuum -> 1). Homogeneous analytic; heterogeneous ratio tracking."""
    media = scene.media
    kind, sa, ss, _, scale = medium_m.params(media, medium_idx)
    tr = jnp.ones((o.shape[0], 3), jnp.float32)
    hom = active & (kind == MED_HOMOGENEOUS)
    tr_h = medium_m.eval_transmittance_homogeneous(sa, ss, dist)
    tr = jnp.where(hom[..., None], tr_h, tr)
    het = active & (kind == MED_HETEROGENEOUS)
    tr_r, smp = medium_m.transmittance_ratio_tracking(
        media, sa, ss, scale, o, d, dist, smp, het,
        differentiable=differentiable, bricks=bricks,
    )
    tr = jnp.where(het[..., None], tr_r, tr)
    return tr, smp


def attenuated_visibility(scene, eps, o, d, dist, medium_idx, smp, active,
                          max_crossings: int = 4, differentiable: bool = False,
                          bricks=None, block_refractive: bool = False):
    """Transmittance along a shadow segment, walking through null medium
    boundaries (Scene::evalTransmittanceAll, scene.cpp:762). Opaque surfaces
    block (returns 0). With block_refractive, a boundary whose far side is a
    refractive (eikonal) medium also blocks: straight-line transmittance is
    meaningless there — the curved-connection BVP owns those segments
    (edge.cpp:473 pathConnectAndCollapse medium-consistency checks)."""
    n = o.shape[0]

    def body(carry):
        cur_o, remaining, med, tr, running, s, it = carry
        hit = isect.intersect(scene.geo, cur_o, d, jnp.full((n,), eps * 0.5),
                              remaining - eps)
        seg = jnp.where(hit.valid, hit.t, remaining)
        tr_seg, s = segment_transmittance(scene, med, cur_o, d, seg, s, running,
                                          differentiable=differentiable,
                                          bricks=bricks)
        tr = jnp.where(running[..., None], tr * tr_seg, tr)

        b_idx, _, m_in, m_ex = _shape_tables(scene, hit.shape_id)
        is_null = _is_null_surface(scene, b_idx)
        if block_refractive:
            from ..scene.types import MED_REFRACTIVE
            nm = scene.media.kind.shape[0]
            ref_in = smalltab.take(scene.media.kind,
                                   jnp.clip(m_in, 0, nm - 1)) \
                == MED_REFRACTIVE
            ref_ex = smalltab.take(scene.media.kind,
                                   jnp.clip(m_ex, 0, nm - 1)) \
                == MED_REFRACTIVE
            is_null = is_null & ~((m_in >= 0) & ref_in) \
                & ~((m_ex >= 0) & ref_ex)
        blocked = running & hit.valid & ~is_null
        tr = jnp.where(blocked[..., None], 0.0, tr)

        crossing = running & hit.valid & is_null
        entering = dot(d, hit.ng) < 0
        new_med = jnp.where(entering, m_in, m_ex)
        med = jnp.where(crossing, new_med, med)
        cur_o = jnp.where(crossing[..., None], hit.p + d * eps, cur_o)
        remaining = jnp.where(crossing, remaining - seg - eps, remaining)
        running = crossing & (remaining > eps)
        return (cur_o, remaining, med, tr, running, s, it + 1)

    def cond(carry):
        running, it = carry[4], carry[6]
        return jnp.any(running) & (it < max_crossings)

    init = (o, dist, medium_idx, jnp.ones((n, 3), jnp.float32), active, smp,
            jnp.int32(0))
    out = medium_m.bounded_while(cond, body, init, max_crossings, differentiable)
    return out[3], out[5]


# ---------------------------------------------------------------------------
# Beam NEE (collimated emitters)
# ---------------------------------------------------------------------------
class _Beam(NamedTuple):
    exists: jnp.ndarray   # () bool
    o: jnp.ndarray        # (3,)
    d: jnp.ndarray        # (3,) unit
    power: jnp.ndarray    # (3,)
    emitter: jnp.ndarray  # () int32
    s0: jnp.ndarray       # () beam param where it enters the scene medium
    s1: jnp.ndarray       # ()
    medium: jnp.ndarray   # () int32 medium the beam traverses


def get_beam(scene: Scene) -> _Beam:
    em = scene.emitters
    is_coll = em.kind == EM_COLLIMATED
    exists = jnp.any(is_coll)
    e = jnp.argmax(is_coll)
    o = em.position[e]
    d = em.direction[e]
    power = em.radiance[e]
    # beam segment inside the scene AABB (the medium boundary for the target
    # scenes; transmittance before entry is handled by the segment walker)
    tn, tf = isect.ray_aabb(o, d, scene.aabb_min, scene.aabb_max)
    s0 = jnp.maximum(tn, 0.0)
    s1 = jnp.maximum(tf, s0)
    # medium the beam threads: interior medium of the first shape it enters
    hit = isect.intersect(scene.geo, o[None, :], d[None, :],
                          jnp.zeros((1,)), jnp.full((1,), 3e38))
    _, _, m_in, m_ex = _shape_tables(scene, hit.shape_id)
    entering = dot(d[None, :], hit.ng[0][None, :]) < 0
    med = jnp.where(hit.valid, jnp.where(entering, m_in, m_ex), -1)[0]
    return _Beam(exists=exists, o=o, d=d, power=power,
                 emitter=jnp.asarray(e, jnp.int32), s0=s0, s1=s1, medium=med)


def sample_beam_point(beam: _Beam, p, u):
    """Equiangular sampling of a point y on the beam w.r.t. vertex p.
    Returns (y, s, pdf_s, dist_to_p, dir_y_to_p)."""
    delta = dot(p - beam.o, beam.d)
    closest = beam.o + delta[..., None] * beam.d
    h = jnp.maximum(length(p - closest), 1e-6)
    a = beam.s0 - delta
    b = beam.s1 - delta
    theta_a = jnp.arctan2(a, h)
    theta_b = jnp.arctan2(b, h)
    theta = theta_a + u * (theta_b - theta_a)
    s_rel = h * jnp.tan(theta)
    s = delta + s_rel
    pdf = h / jnp.maximum((theta_b - theta_a) * (h * h + s_rel * s_rel), 1e-12)
    y = beam.o + s[..., None] * beam.d
    to_p = p - y
    dist = jnp.maximum(length(to_p), 1e-6)
    return y, s, pdf, dist, to_p / dist[..., None]


def build_beam_tau(scene, beam: _Beam, bricks, n: int = 256):
    """Precomputed optical-depth/density table along the beam (midpoint
    quadrature, the array-program analogue of the reference's Simpson
    integrateDensity, heterogeneous.cpp:301). Rows pack everything a
    beam-NEE evaluation needs from the beam parameter s so the hot loop
    pays ONE row-gather instead of three (two tau taps + the density tap):

        row i = [tau_rgb(s_i), dtau_rgb(s_i), density(s_i)*scale, 0]   (n, 8)
    """
    si = beam.s0 + (jnp.arange(n, dtype=jnp.float32) + 0.5) / n * (beam.s1 - beam.s0)
    pts = beam.o[None, :] + si[:, None] * beam.d[None, :]
    bmed = jnp.broadcast_to(beam.medium, (n,))
    kind, sa, ss, _, scale = medium_m.params(scene.media, bmed)
    dens = jnp.where(
        kind == MED_HETEROGENEOUS, bricks.lookup(pts) * scale,
        jnp.where(kind == MED_HOMOGENEOUS, 1.0, 0.0),
    )
    st = (sa + ss) * dens[:, None]
    ds_ = (beam.s1 - beam.s0) / n
    dtau = st * ds_
    tau = jnp.cumsum(dtau, axis=0) - 0.5 * dtau          # (n, 3) at centers
    tau_next = jnp.concatenate([tau[1:], tau[-1:]], axis=0)
    return jnp.concatenate(
        [tau, tau_next - tau, dens[:, None], jnp.zeros((n, 1))], axis=-1)


def beam_transmittance(beam: _Beam, tau_table, s, with_density: bool = False):
    """Tr(beam origin -> s) (and optionally density(s)*scale) via ONE
    row-gather + lerp of the packed table from build_beam_tau."""
    n = tau_table.shape[0]
    f = (s - beam.s0) / jnp.maximum(beam.s1 - beam.s0, 1e-9) * n - 0.5
    f = jnp.clip(f, 0.0, n - 1.0)
    i0 = jnp.floor(f).astype(jnp.int32)
    t = (f - i0)[..., None]
    row = smalltab.onehot_take(tau_table, i0)                         # (N,8)
    tau = row[:, 0:3] + row[:, 3:6] * t
    tau = jnp.where((s < beam.s0)[..., None], 0.0, tau)
    tr = jnp.exp(-tau)
    if with_density:
        return tr, row[:, 6]
    return tr


# ---------------------------------------------------------------------------
# Main integrator
# ---------------------------------------------------------------------------
class _State(NamedTuple):
    o: jnp.ndarray
    d: jnp.ndarray
    throughput: jnp.ndarray
    sink: common.Sink
    active: jnp.ndarray
    depth: jnp.ndarray
    plen: jnp.ndarray
    eta_scale: jnp.ndarray
    last_pdf: jnp.ndarray
    last_delta: jnp.ndarray
    medium: jnp.ndarray
    log_p: jnp.ndarray
    iters: jnp.ndarray
    sampler: object


def li(scene: Scene, cfg: RenderConfig, o, d, sampler, pixel=None,
       simple: bool = False, differentiable: bool = False):
    n = o.shape[0]
    eps = common.scene_epsilon(scene)
    sink = common.new_sink(cfg, n, pixel)
    beam = get_beam(scene)
    bricks = medium_m.DensityBricks(scene.media)  # one gather per pass
    beam_tau = build_beam_tau(scene, beam, bricks) if cfg.has_beam else None

    state = _State(
        o=o, d=d,
        throughput=jnp.ones((n, 3), jnp.float32),
        sink=sink,
        active=jnp.ones((n,), bool),
        depth=jnp.ones((n,), jnp.int32),
        plen=jnp.zeros((n,), jnp.float32),
        eta_scale=jnp.ones((n,), jnp.float32),
        last_pdf=jnp.zeros((n,), jnp.float32),
        last_delta=jnp.ones((n,), bool),
        medium=jnp.broadcast_to(scene.camera_medium, (n,)).astype(jnp.int32),
        log_p=jnp.zeros((n,), jnp.float32),
        iters=jnp.zeros((), jnp.int32),
        sampler=sampler,
    )
    max_iters = 2 * cfg.max_depth + 8

    def cond(s: _State):
        return jnp.any(s.active) & (s.iters < max_iters)

    def body(s: _State):
        smp = s.sampler
        media = scene.media
        hit = isect.intersect(scene.geo, s.o, s.d,
                              jnp.full((n,), eps), jnp.full((n,), isect.INF),
                              need_uv=cfg.has_textures)
        # bound medium marching for escaped rays by the scene AABB exit
        _, t_scene = isect.ray_aabb(s.o, s.d, scene.aabb_min, scene.aabb_max)
        t_far = jnp.where(hit.valid, hit.t, jnp.maximum(t_scene, 0.0))

        # ---------- medium distance sampling ----------
        in_medium = s.active & (s.medium >= 0)
        kind, sa, ss, sw, scale = medium_m.params(media, s.medium)

        u_hom, smp = rng.next_1d(smp)
        uc_hom, smp = rng.next_1d(smp)
        if cfg.medium_strategies:
            _strat = medium_m.params_strategy(scene.media, s.medium)
        else:
            _strat = (None, None)
        hs, ht, hw, h_logp = medium_m.sample_distance_homogeneous(
            sa, ss, sw, t_far, u_hom, uc_hom,
            strategy=_strat[0], manual_density=_strat[1]
        )
        het = in_medium & (kind == MED_HETEROGENEOUS)
        ws, wt, ww, wp, smp, w_logp = medium_m.sample_distance_woodcock(
            media, sa, ss, scale, s.o, s.d, t_far, smp, het,
            differentiable=differentiable, bricks=bricks,
        )
        is_hom = kind == MED_HOMOGENEOUS
        m_success = in_medium & jnp.where(is_hom, hs, ws)
        m_t = jnp.where(is_hom, ht, wt)
        m_weight = jnp.where(is_hom[..., None], hw, ww)
        m_weight = jnp.where(in_medium[..., None], m_weight, 1.0)
        log_p = s.log_p + jnp.where(
            in_medium, jnp.where(is_hom, h_logp, w_logp), 0.0
        )
        throughput = s.throughput * m_weight
        m_p = s.o + m_t[..., None] * s.d

        scattered = m_success                      # medium interaction lanes
        reached = s.active & ~m_success            # surface / escaped lanes
        plen_here = s.plen + jnp.where(scattered, m_t, jnp.where(hit.valid, hit.t, 0.0))

        # ---------- escaped lanes: environment ----------
        escaped = reached & ~hit.valid
        env = emitter_m.env_radiance(scene, s.d)
        env_pdf = emitter_m.pdf_direct_env(scene, s.d)
        w_env = jnp.where(s.last_delta, 1.0, mis_weight_power(s.last_pdf, env_pdf))
        if simple:
            w_env = jnp.where(s.last_delta, 1.0, 0.0)
        sink_new = common.add_contribution(
            s.sink, cfg, throughput * env * w_env[..., None], s.plen, s.depth,
            escaped, log_p=log_p,
        )

        # ---------- surface tables ----------
        b_idx, e_idx, m_in, m_ex = _shape_tables(scene, hit.shape_id)
        on_surface = reached & hit.valid
        is_null = _is_null_surface(scene, b_idx)

        # ---------- emitter hit ----------
        hit_emitter = on_surface & (e_idx >= 0)
        le = emitter_m.eval_hit(scene, e_idx, hit.ng, -s.d)
        lum_pdf = emitter_m.pdf_direct_hit(scene, e_idx, s.o, hit.p, hit.ng)
        w_hit = jnp.where(s.last_delta, 1.0, mis_weight_power(s.last_pdf, lum_pdf))
        if simple:
            w_hit = jnp.where(s.last_delta, 1.0, 0.0)
        hide = cfg.hide_emitters & (s.depth == 1)
        sink_new = common.add_contribution(
            sink_new, cfg, throughput * le * w_hit[..., None], plen_here,
            s.depth, hit_emitter & ~hide, log_p=log_p,
        )

        depth_ok = s.depth < cfg.max_depth

        # =========== NEE (shared for medium + surface vertices) ===========
        vtx_p = jnp.where(scattered[..., None], m_p, hit.p)
        nee_active = (scattered | (on_surface & ~is_null)) & depth_ok
        u2e, smp = rng.next_2d(smp)
        u1e, smp = rng.next_1d(smp)
        ds = emitter_m.sample_direct(scene, vtx_p, u2e, u1e)

        # scatter kernel toward the light
        frame = Frame.from_normal(hit.ng)
        wi_srf = frame.to_local(-s.d)
        wo_srf = frame.to_local(ds.d)
        act = cfg.bsdf_kinds or None
        rscale = texture_m.bsdf_refl_scale(scene, b_idx, hit.tex_uv,
                                           hit.uv, enabled=cfg.has_textures)
        f_srf = bsdf_m.eval(scene.bsdfs, b_idx, wi_srf, wo_srf,
                            refl_scale=rscale, active=act)
        pdf_srf = bsdf_m.pdf(scene.bsdfs, b_idx, wi_srf, wo_srf,
                             refl_scale=rscale, active=act)
        pact = cfg.phase_kinds or None
        # per-voxel orientation field (heterogeneous.cpp:164): local axis
        # for microflake/kkay lobes at the scatter vertex
        ax_ov = medium_m.orientation_axis(media, s.medium, m_p) \
            if cfg.phase_orient else None
        f_med = phase_m.eval(media.phase, s.medium, s.d, ds.d, active=pact,
                             axis_override=ax_ov)[..., None]
        pdf_med = f_med[..., 0]
        f_vtx = jnp.where(scattered[..., None], f_med, f_srf)
        pdf_vtx = jnp.where(scattered, pdf_med, pdf_srf)

        # medium vertices stay in the same medium; surface shadow rays start
        # in the medium on the light's side of the interface
        srf_entering = dot(ds.d, hit.ng) < 0
        srf_med = jnp.where(srf_entering, m_in, m_ex)
        nee_med = jnp.where(scattered, s.medium, srf_med)
        vis_needed = (
            nee_active & (ds.pdf > 0) & jnp.any(f_vtx > 0, axis=-1)
            & jnp.any(ds.value > 0, axis=-1)
        )

        # ---- build ALL shadow segments for this bounce and walk them in ONE
        # batched visibility call (emitter NEE + optionally the two beam-NEE
        # segments). Sequential tracking loops dominate the time, so fusing
        # the three queries cuts the per-bounce loop count 3x. ----
        seg_o = [vtx_p + ds.d * eps]
        seg_d = [ds.d]
        seg_dist = [ds.dist - 2 * eps]
        seg_med = [nee_med]
        seg_act = [vis_needed]
        if cfg.has_beam:
            u_b, smp = rng.next_1d(smp)
            y_b, s_b, pdf_sb, dist_b, d_yp = sample_beam_point(beam, vtx_p, u_b)
            bmed = jnp.broadcast_to(beam.medium, (n,))
            seg_o += [y_b + d_yp * eps]
            seg_d += [d_yp]
            seg_dist += [dist_b - 2 * eps]
            seg_med += [bmed]
            seg_act += [nee_active]
        # dedicated decorrelated stream for the (variable-draw-count)
        # visibility walk, keyed on the bounce counter; the main sampler's
        # dimension layout stays deterministic
        k = len(seg_o)
        vis_smp = rng.Sampler(
            lane=jnp.concatenate(
                [smp.lane + jnp.uint32(i * 0x9E37) for i in range(k)]
            ),
            index=jnp.concatenate([smp.index] * k),
            dim=jnp.zeros((k * n,), jnp.uint32),
            seed=rng.hash_combine(smp.seed, jnp.uint32(0x51BB), s.iters),
        )
        tr_all, _ = attenuated_visibility(
            scene, eps,
            jnp.concatenate(seg_o), jnp.concatenate(seg_d),
            jnp.concatenate(seg_dist), jnp.concatenate(seg_med),
            vis_smp, jnp.concatenate(seg_act), differentiable=differentiable,
            bricks=bricks,
        )
        tr_nee = tr_all[:n]

        w_nee = jnp.where(ds.delta, 1.0, mis_weight_power(ds.pdf, pdf_vtx))
        if simple:
            w_nee = jnp.ones_like(w_nee)
        contrib = (
            throughput * f_vtx * ds.value * tr_nee
            * (w_nee / jnp.maximum(ds.pdf, 1e-12))[..., None]
        )
        sink_new = common.add_contribution(
            sink_new, cfg, contrib, plen_here + ds.dist, s.depth + 1,
            vis_needed, log_p=log_p,
        )

        # =========== beam NEE (collimated; see module docstring) ===========
        if cfg.has_beam:
            tr_beam = beam_transmittance(beam, beam_tau, s_b)
            tr_conn = tr_all[n:]
            kind_b, sa_b, ss_b, _, scale_b = medium_m.params(media, bmed)
            dens_b = jnp.where(
                kind_b == MED_HETEROGENEOUS,
                bricks.lookup(y_b) * scale_b,
                jnp.ones((n,)),
            )
            sigma_s_y = ss_b * dens_b[..., None]
            rho_y = phase_m.eval(
                media.phase, bmed, jnp.broadcast_to(beam.d, (n, 3)), d_yp
            )
            bval = (
                beam.power * tr_beam * sigma_s_y * tr_conn
                * (rho_y / jnp.maximum(pdf_sb * dist_b * dist_b, 1e-12))[..., None]
            )
            # light arrives at the vertex propagating along d_yp (y -> p);
            # the direction from the vertex toward the beam vertex is -d_yp
            f_srf_b = bsdf_m.eval(scene.bsdfs, b_idx, wi_srf,
                                  frame.to_local(-d_yp),
                                  refl_scale=rscale, active=act)
            f_med_b = phase_m.eval(media.phase, s.medium, s.d, -d_yp, active=pact)[..., None]
            f_b = jnp.where(scattered[..., None], f_med_b, f_srf_b)
            sink_new = common.add_contribution(
                sink_new, cfg, throughput * f_b * bval,
                plen_here + s_b + dist_b, s.depth + 2, nee_active, log_p=log_p,
            )

        # =========== direction sampling ===========
        u2p, smp = rng.next_2d(smp)
        u1p, smp = rng.next_1d(smp)

        # medium: phase sampling
        ps = phase_m.sample(media.phase, s.medium, s.d, u2p, active=pact,
                            axis_override=ax_ov)
        # surface: bsdf sampling
        bs = bsdf_m.sample(scene.bsdfs, b_idx, wi_srf, u2p, u1p,
                           refl_scale=rscale, active=act)
        wo_world_srf = frame.to_world(bs.wo)

        new_d = jnp.where(scattered[..., None], ps.wo, wo_world_srf)
        scatter_w = jnp.where(
            scattered[..., None], ps.weight[..., None], bs.weight
        )
        log_p = log_p + jnp.where(
            scattered, jnp.log(jnp.maximum(ps.pdf, 1e-30)), 0.0
        )
        new_pdf = jnp.where(scattered, ps.pdf, bs.pdf)
        new_delta = jnp.where(scattered, False, bs.delta)

        # null surfaces: pass straight through, no weight, no depth
        new_d = jnp.where((on_surface & is_null)[..., None], s.d, new_d)
        scatter_w = jnp.where((on_surface & is_null)[..., None], 1.0, scatter_w)
        new_delta = jnp.where(on_surface & is_null, s.last_delta, new_delta)
        new_pdf = jnp.where(on_surface & is_null, s.last_pdf, new_pdf)

        # medium transitions at any crossing surface (null or refractive)
        crossing = on_surface & (is_null | (jnp.sum(new_d * hit.ng, axis=-1) * jnp.sum(-s.d * hit.ng, axis=-1) < 0))
        entering = jnp.sum(new_d * hit.ng, axis=-1) < 0
        new_medium = jnp.where(
            crossing, jnp.where(entering, m_in, m_ex), s.medium
        )

        throughput2 = throughput * scatter_w
        cont = (scattered | on_surface) & depth_ok
        dead = jnp.all(throughput2 <= 0, axis=-1)
        active = cont & ~dead

        # RR (skip for null crossings to keep transmittance unbiased cheaply)
        eta_scale = s.eta_scale * jnp.where(on_surface, bs.eta, 1.0)
        u_rr, smp = rng.next_1d(smp)
        rr_exempt = on_surface & is_null
        tp_rr, survive = common.russian_roulette(
            throughput2, eta_scale, u_rr, s.depth, cfg
        )
        throughput2 = jnp.where(rr_exempt[..., None], throughput2, tp_rr)
        active = active & (survive | rr_exempt)

        inc_depth = (scattered | (on_surface & ~is_null)) & active
        # NaN firewall (see volpath_er): kill non-finite lanes
        finite = (
            jnp.all(jnp.isfinite(vtx_p), axis=-1)
            & jnp.all(jnp.isfinite(new_d), axis=-1)
            & jnp.all(jnp.isfinite(throughput2), axis=-1)
        )
        active = active & finite
        throughput2 = jnp.nan_to_num(throughput2, posinf=0.0, neginf=0.0)
        new_o = jnp.nan_to_num(vtx_p, posinf=0.0, neginf=0.0) + jnp.nan_to_num(new_d) * eps

        return _State(
            o=jnp.where(active[..., None], new_o, s.o),
            d=jnp.where(active[..., None], jnp.nan_to_num(new_d), s.d),
            throughput=jnp.where(active[..., None], throughput2, s.throughput),
            sink=sink_new,
            active=active,
            depth=jnp.where(inc_depth, s.depth + 1, s.depth),
            plen=jnp.where(active, plen_here, s.plen),
            eta_scale=jnp.where(active, eta_scale, s.eta_scale),
            last_pdf=jnp.where(active, new_pdf, s.last_pdf),
            last_delta=jnp.where(active, new_delta, s.last_delta),
            medium=jnp.where(active, new_medium, s.medium),
            log_p=jnp.where(active, log_p, s.log_p),
            iters=s.iters + 1,
            sampler=smp,
        )

    if differentiable:
        # reverse-mode AD cannot differentiate while_loop; run a fixed-trip
        # scan with rematerialized bodies instead
        ck_body = jax.checkpoint(lambda st, _: (body(st), None))
        final, _ = jax.lax.scan(ck_body, state, None, length=max_iters)
    else:
        final = jax.lax.while_loop(cond, body, state)
    return final.sink, final.sampler
