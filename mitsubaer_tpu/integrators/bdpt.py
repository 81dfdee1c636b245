"""Bidirectional path tracer with per-(s,t) connections and MIS.

Reference: src/integrators/bdpt/bdpt_proc.cpp:140-480 (the reference's
primary integrator — all bundled ER/transient scenes render through it) on
top of libbidir's PathVertex/PathEdge (vertex.cpp, edge.cpp). Array-program redesign:

* Subpaths are FIXED-DEPTH stacked arrays (n, K, ...) built by `lax.scan`
  random walks — no pointer-chasing vertex lists; every lane walks in
  lockstep with masked liveness (the wavefront analogue of
  Path::alternatingRandomWalkFromPixel, path.cpp:115).
* The (s,t) double loop is STATIC (python), so each connection compiles to
  one masked visibility ray + arithmetic over the whole wavefront.
* MIS weights use the area-measure pdf-ratio recursion (Path::miWeight;
  same structure as pbrt-v3 MISWeight) from stored pdfFwd/pdfRev with the
  four junction pdfs recomputed per (s,t); delta vertices gate terms
  exactly like vertex.cpp's EDeltaDirection logic.
* t=1 strategies splat to the light image through the sensor projection
  (putLightSample, bdpt_wr.cpp:50-73) — one scatter-add per s.
* Per-vertex path-length prefixes support transient binning of each
  (s,t) contribution at its total length (bdpt_proc.cpp:147-189,455-476).

Vertex indexing follows Veach/pbrt: camera vertices z_0..z_{t-1} with z_0
the pinhole; light vertices y_0..y_{s-1} with y_0 on the emitter. The
stored camera array cam[k] = z_{k+1} (the pinhole is implicit: delta
position, never connectible, t'=0 strategies impossible); the stored light
array lt[k] = y_{k+1}, with y_0 kept separately in LightStart.

Scope: surface + volumetric transport (area + point emitters, every
surface BSDF, homogeneous/heterogeneous media) and — matching the
reference's primary ER integrator — CURVED eikonal transport (r5):

* the random walks march curved rays inside the refractive medium
  (trace_curved), record medium vertices whose incident direction is the
  curved exit velocity (vertex.cpp:250-256), treat the medium boundary as
  an h-dielectric delta vertex with RIF-queried eta (hdielectric.cpp:115),
  and accumulate OPTICAL path length;
* (s,t) connections with an endpoint inside the medium route through the
  batched BVP solver (edge.cpp:473-643 -> eikonal.solve_bvp), feeding the
  curved exit/reverse directions into the endpoint f terms, 1/geo^2
  falloff, refRatioSq radiance compression, and the optical connection
  length into the transient binning (bdpt_proc.cpp:396-399);
* t=1 strategies from in-medium vertices solve the sensor-side BVP and
  splat at the pixel of the ARRIVAL direction (edge.cpp:535-543).

Approximations vs the reference (documented, all MIS-weight-only): walk-
internal reverse-pdf measure conversions use the straight chord between
stored vertices, and the outside tail of a curved connection is not
re-tested for occlusion (matches volpath_er's curved-NEE scope).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import rng, smalltab
from ..core.math import Frame, dot, fresnel_dielectric, normalize
from ..models import eikonal as ek
from ..models import bsdf as bsdf_m
from ..models import emitter as emitter_m
from ..models import medium as medium_m
from ..models import phase as phase_m
from ..models import sensor as sensor_m
from ..scene import intersect as isect
from ..scene.types import (
    EM_AREA,
    EM_COLLIMATED,
    EM_DIRECTIONAL,
    EM_POINT,
    MED_HETEROGENEOUS,
    MED_HOMOGENEOUS,
    MED_REFRACTIVE,
    RenderConfig,
    Scene,
)
from . import common
from .volpath import _is_null_surface, _shape_tables, attenuated_visibility
from .volpath_er import _refractive_params


class SubPath(NamedTuple):
    """Stacked vertex arrays; array index k = k-th (surface OR medium)
    vertex of the walk (pbrt vertex k+1). Medium vertices (vertex.cpp
    EMediumInteraction, :250-256) carry is_med=True, their phase medium in
    `med`, zero ng, and distance-sampling pdf factors for MIS."""
    p: jnp.ndarray        # (n, K, 3)
    ng: jnp.ndarray       # (n, K, 3) geometric normal (zeros for medium)
    d_in: jnp.ndarray     # (n, K, 3) unit direction the walk ARRIVED along
    beta: jnp.ndarray     # (n, K, 3) cumulative weight up to this vertex
    pdf_fwd: jnp.ndarray  # (n, K) generalized-measure pdf of generating it
    pdf_rev: jnp.ndarray  # (n, K) pdf of regenerating it backward
    delta: jnp.ndarray    # (n, K) ARRIVED via a delta lobe
    spec: jnp.ndarray     # (n, K) vertex's own BSDF sampled a delta lobe
    bsdf: jnp.ndarray     # (n, K) int32 (-1 at medium vertices)
    emitter: jnp.ndarray  # (n, K) int32
    valid: jnp.ndarray    # (n, K)
    plen: jnp.ndarray     # (n, K) path length from the walk origin
    is_med: jnp.ndarray   # (n, K) medium-interaction vertex
    med: jnp.ndarray      # (n, K) int32 medium at the vertex (segment med)
    shape: jnp.ndarray    # (n, K) int32 hit shape (-1 at medium vertices)
    seg_psucc: jnp.ndarray  # (n, K) arrival-segment distance-pdf (scatter)
    seg_pfail: jnp.ndarray  # (n, K) arrival-segment distance-pdf (pass)
    rdepth: jnp.ndarray   # (n, K) int32 # of REAL (non-null) vertices in
    #   array[0..k] — null boundary crossings don't consume path depth
    #   (mirrors volpath's ENull chains not incrementing depth)


class LightStart(NamedTuple):
    p: jnp.ndarray         # (n, 3) y_0
    ng: jnp.ndarray        # (n, 3)
    beta1: jnp.ndarray     # (n, 3) cumulative weight at y_1
    inv_pdf_pos: jnp.ndarray  # (n,) 1 / (area pdf * pick)
    pdf_pos: jnp.ndarray   # (n,)
    pdf_dir: jnp.ndarray   # (n,) emission solid-angle pdf
    radiance: jnp.ndarray  # (n, 3) emitted radiance / intensity
    is_area: jnp.ndarray
    delta_pos: jnp.ndarray   # position is a Dirac (point/collimated/
    #   directional): the s'=0 hit family cannot see it (MIS gate)
    delta_dir: jnp.ndarray   # EMISSION DIRECTION is a Dirac (collimated/
    #   directional beams): s=1 connections are impossible; point lights
    #   are position-delta but freely connectable (vertex.cpp point case)
    emitter: jnp.ndarray


def _remap0(x):
    return jnp.where(x > 0, x, 1.0)


def _to_area(pdf_dir, p_from, p_to, ng_to, is_med_to=None):
    """Solid-angle -> generalized area/volume measure: x|cos|/d^2 onto a
    surface, x1/d^2 into a medium (vertex.cpp:1339 pdf conversion)."""
    dvec = p_to - p_from
    d2 = jnp.maximum(jnp.sum(dvec * dvec, -1), 1e-12)
    w = dvec / jnp.sqrt(d2)[..., None]
    cos_t = jnp.abs(dot(w, ng_to))
    if is_med_to is not None:
        cos_t = jnp.where(is_med_to, 1.0, cos_t)
    return pdf_dir * cos_t / d2


def _seg_pdf_factors(scene, med_seg, dist):
    """Distance-sampling pdf factors of a segment of length `dist` inside
    medium `med_seg` under the balance strategy (homogeneous.cpp:275-350):
    (pdf of scattering AT dist [per length], pdf of passing THROUGH).
    Vacuum -> (1, 1). Heterogeneous -> (1, 1): an approximate-but-
    deterministic pdf model; MIS weights stay a partition of unity (every
    strategy in one evaluation uses the same model), so the estimator is
    unbiased with suboptimal weights — the reference instead evaluates
    quadrature pdfs (heterogeneous.cpp integrateDensity)."""
    kind, sa, ss, sw, _ = medium_m.params(scene.media, med_seg)
    stc = sa + ss
    tmp = jnp.exp(-stc * dist[..., None])
    hom = kind == MED_HOMOGENEOUS
    pdf_succ = jnp.where(hom, sw * jnp.mean(stc * tmp, -1), 1.0)
    pdf_fail = jnp.where(hom, (1.0 - sw) + sw * jnp.mean(tmp, -1), 1.0)
    return pdf_succ, pdf_fail


def _conn_medium(scene, is_med_v, med_v, shape_v, ng_v, wconn):
    """Medium along a connection leaving a vertex toward wconn: the vertex's
    own medium at medium vertices, the shape's interior/exterior by the
    crossing side at surface vertices (edge.cpp medium-consistency logic)."""
    _, _, m_in, m_ex = _shape_tables(scene, shape_v)
    entering = dot(wconn, ng_v) < 0
    srf_med = jnp.where(entering, m_in, m_ex)
    return jnp.where(is_med_v, med_v, srf_med)


def _surface_walk(scene, cfg, o0, d0, beta1, pdf0_dir, origin_p, origin_ng,
                  smp, K: int, eps, med0=None, any_het: bool = False,
                  any_er: bool = False):
    """Walk K vertices (surface + medium interactions) from ray (o0, d0).

    Each step: intersect, sample a medium distance in the current medium
    (homogeneous analytic; heterogeneous Woodcock when any_het), then
    either record a MEDIUM vertex (phase sampling continues the walk,
    vertex.cpp:250-256) or a SURFACE vertex (BSDF sampling; null boundaries
    pass through and switch the tracked medium). pdf0_dir: solid-angle pdf
    of d0 (-> pdf_fwd of array vertex 0 in generalized measure).
    origin_ng: normal at the origin for the origin's reverse-pdf
    conversion. Stored seg_psucc/seg_pfail are the arrival segment's
    distance-pdf factors (used by MIS junction recomputes)."""
    n = o0.shape[0]
    act = cfg.bsdf_kinds or None
    pact = cfg.phase_kinds or None
    media = scene.media
    if med0 is None:
        med0 = jnp.broadcast_to(scene.camera_medium, (n,)).astype(jnp.int32)
    if any_er:
        # eikonal support: curved marching inside the (single) refractive
        # medium + h-dielectric boundary vertices. The walk then produces
        # medium vertices whose incident direction is the curved exit
        # velocity (vertex.cpp:250-256) and whose path length is OPTICAL
        # (edge.cpp opticalLength bookkeeping).
        rif = ek.rif_from_media(media, cfg.rif_kinds)
        sdf = ek.sdf_from_media(media)
        _, sa_er, ss_er, sw_er, er_idx = _refractive_params(scene)
        st_er = sa_er + ss_er
        h_er = cfg.er_stepsize
        max_march = cfg.er_maxsteps
        er_shape = jnp.argmax(
            scene.shapes.interior == er_idx).astype(jnp.int32)
        er_exterior = smalltab.take(scene.shapes.exterior, er_shape)

    def body(carry, _):
        (o, d, beta, pdf_dir, alive, plen, prev_delta, med, lr_p,
         fail_since, smp) = carry
        hit = isect.intersect(scene.geo, o, d, jnp.full((n,), eps),
                              jnp.full((n,), isect.INF))
        t_surf = jnp.where(hit.valid, hit.t, jnp.float32(3e37))
        kind, sa, ss, sw, scale = medium_m.params(media, med)
        if any_er:
            # inside-ER lanes transport along curved rays — the straight
            # intersection result is meaningless for them
            er_ln = alive & (kind == MED_REFRACTIVE)
            t_surf = jnp.where(er_ln, jnp.float32(3e37), t_surf)
            hit_valid = hit.valid & ~er_ln
        else:
            er_ln = jnp.zeros((n,), bool)
            hit_valid = hit.valid
        u_h, smp = rng.next_1d(smp)
        uc_h, smp = rng.next_1d(smp)
        hs, ht, hw, _ = medium_m.sample_distance_homogeneous(
            sa, ss, sw, t_surf, u_h, uc_h)
        hom = kind == MED_HOMOGENEOUS
        if any_het:
            het = kind == MED_HETEROGENEOUS
            bricks = medium_m.DensityBricks(media)
            ws, wt, ww, _, smp, _ = medium_m.sample_distance_woodcock(
                media, sa, ss, scale, o, d, t_surf, smp, alive & het,
                bricks=bricks)
            hs = jnp.where(het, ws, hs)
            ht = jnp.where(het, wt, ht)
            hw = jnp.where(het[..., None], ww, hw)
            in_medium = hom | het
        else:
            in_medium = hom
        scat = alive & in_medium & hs
        dist_w = jnp.where(in_medium[..., None], hw, 1.0)

        valid_srf = alive & hit_valid & ~scat
        if any_er:
            # ---- curved marching inside the refractive medium ----
            march_dist = jnp.where(hs, ht, jnp.float32(1e6))
            n_start = jnp.maximum(ek.rif_value(rif, o), 1e-6)
            v_in = d * n_start[..., None]
            p_m, v_m, opt_m, geo_m, exited_m, _ = ek.trace_curved(
                rif, sdf, o, v_in, march_dist, h_er, max_march, er_ln,
                kernels=cfg.kernels)
            scat_er = er_ln & hs & ~exited_m
            exit_er = er_ln & (exited_m | ~hs)
            p_b, v_b, opt_b, adv_b = ek.refine_boundary(rif, sdf, p_m, v_m,
                                                        h_er)
            p_m = jnp.where(exit_er[..., None], p_b, p_m)
            v_m = jnp.where(exit_er[..., None], v_b, v_m)
            opt_m = jnp.where(exit_er, opt_m + opt_b, opt_m)
            geo_m = jnp.where(exit_er, geo_m + adv_b, geo_m)
            n_end_er = jnp.maximum(ek.rif_value(rif, p_m), 1e-6)
            d_arr_er = normalize(v_m)
            N_out = normalize(ek.sdf_gradient(sdf, p_m))
            # balance-strategy estimator weights at the CURVED arc length
            tr_er = jnp.exp(-st_er[None, :] * geo_m[..., None])
            pdf_fail_er = (1.0 - sw_er) + sw_er * jnp.mean(tr_er, -1)
            pdf_succ_er = sw_er * jnp.mean(st_er[None, :] * tr_er, -1)
            w_sc_er = ss_er[None, :] * tr_er \
                / jnp.maximum(pdf_succ_er, 1e-12)[..., None]
            w_ex_er = tr_er / jnp.maximum(pdf_fail_er, 1e-12)[..., None]
            rrsq = (n_end_er / n_start) ** 2
            dist_w_er = jnp.where(scat_er[..., None], w_sc_er, w_ex_er) \
                * rrsq[..., None]
            scat = scat | scat_er
            dist_w = jnp.where(er_ln[..., None], dist_w_er, dist_w)
        else:
            exit_er = jnp.zeros((n,), bool)
        valid = scat | valid_srf | exit_er
        t_v = jnp.where(scat, ht, t_surf)
        p_v = jnp.where(scat[..., None], o + t_v[..., None] * d, hit.p)
        ng_v = jnp.where(scat[..., None], 0.0, hit.ng)
        plen_here = plen + jnp.where(valid, t_v, 0.0)
        if any_er:
            t_v = jnp.where(er_ln, geo_m, t_v)
            p_v = jnp.where(er_ln[..., None], p_m, p_v)
            ng_v = jnp.where(exit_er[..., None], N_out, ng_v)
            # OPTICAL path length inside the medium (bdpt_proc.cpp:396-399)
            plen_here = jnp.where(er_ln & valid, plen + opt_m, plen_here)

        # arrival-segment distance-pdf factors (balance strategy; exact for
        # homogeneous, 1 otherwise — see _seg_pdf_factors). Null boundary
        # crossings are collinear pass-throughs that get COMPACTED out of
        # the vertex arrays after the walk, so the stored factors and the
        # direction-pdf conversion are EFFECTIVE values spanning the whole
        # null run: fail-probabilities of the crossed sub-segments multiply
        # in, and the measure conversion runs from the last REAL vertex
        # (exact, because pass-through preserves the direction).
        stc = sa + ss
        tmp = jnp.exp(-stc * t_v[..., None])
        seg_psucc = fail_since * jnp.where(
            hom, sw * jnp.mean(stc * tmp, -1), 1.0)
        seg_pfail = fail_since * jnp.where(
            hom, (1.0 - sw) + sw * jnp.mean(tmp, -1), 1.0)

        if any_er:
            seg_psucc = jnp.where(er_ln, fail_since * pdf_succ_er, seg_psucc)
            seg_pfail = jnp.where(er_ln, fail_since * pdf_fail_er, seg_pfail)

        pdf_fwd = _to_area(pdf_dir, lr_p, p_v, ng_v, is_med_to=scat) \
            * jnp.where(scat, seg_psucc, seg_pfail)
        if any_er:
            # curved measure conversion: |cos|/geo^2 at the CURVED arc
            # length with the curved arrival direction (vertex.cpp:1339)
            cos_b = jnp.abs(dot(d_arr_er, N_out))
            pdf_fwd_er = pdf_dir * jnp.where(exit_er, cos_b, 1.0) \
                / jnp.maximum(geo_m * geo_m, 1e-12) \
                * jnp.where(scat, seg_psucc, seg_pfail)
            pdf_fwd = jnp.where(er_ln, pdf_fwd_er, pdf_fwd)

        sid = jnp.clip(hit.shape_id, 0, scene.shapes.bsdf.shape[0] - 1)
        b_idx = jnp.where(valid_srf, smalltab.take(scene.shapes.bsdf, sid),
                          -1)
        e_idx = jnp.where(valid_srf,
                          smalltab.take(scene.shapes.emitter, sid), -1)
        _, _, m_in, m_ex = _shape_tables(scene, hit.shape_id)

        frame = Frame.from_normal(hit.ng)
        wi_l = frame.to_local(-d)
        u2, smp = rng.next_2d(smp)
        u1, smp = rng.next_1d(smp)
        bs = bsdf_m.sample(scene.bsdfs, b_idx, wi_l, u2, u1, active=act)
        d_ph = jnp.where(er_ln[..., None], d_arr_er, d) if any_er else d
        ps = phase_m.sample(media.phase, med, d_ph, u2, active=pact)
        # null (medium-boundary) surfaces pass straight through as delta
        # vertices: direction unchanged, weight 1, gated out of every
        # connectible strategy by their delta flags (volpath ENull chains)
        raw_b = smalltab.take(scene.shapes.bsdf, sid)
        null_srf = valid_srf & _is_null_surface(scene, raw_b)
        if any_er:
            # a boundary of the refractive medium is an h-dielectric, NOT a
            # null pass-through (shape.cpp:129-180 enforces h-BSDFs there)
            bnd_entry = valid_srf & ((m_in == er_idx) | (m_ex == er_idx))
            null_srf = null_srf & ~bnd_entry
        wo_w = jnp.where(scat[..., None], ps.wo, frame.to_world(bs.wo))
        wo_w = jnp.where(null_srf[..., None], d, wo_w)
        if any_er:
            # --- h-dielectric ENTRY (straight hit on the boundary shape):
            # Fresnel with RIF-queried eta (hdielectric.cpp:115-118)
            n_at = jnp.maximum(ek.rif_value(rif, hit.p), 1e-6)
            cos_i = dot(-d, hit.ng)
            F_in, _ = fresnel_dielectric(cos_i, n_at)
            refl_in = u1 < F_in
            v_refl_in = d - 2.0 * dot(d, hit.ng, keepdims=True) * hit.ng
            N_in = jnp.where(cos_i[..., None] > 0, hit.ng, -hit.ng)
            v_refr_in, _ = ek.boundary_velocity(d, N_in, jnp.ones((n,)),
                                                n_at)
            wo_entry = jnp.where(refl_in[..., None], v_refl_in,
                                 normalize(v_refr_in))
            wo_w = jnp.where(bnd_entry[..., None], wo_entry, wo_w)
            # --- h-dielectric EXIT (curved march reached the boundary)
            u_fx, smp = rng.next_1d(smp)
            cos_x = dot(d_arr_er, N_out)
            F_x, _ = fresnel_dielectric(-cos_x, n_end_er)
            v_refr_x, tir_x = ek.boundary_velocity(v_m, N_out, n_end_er,
                                                   jnp.ones((n,)))
            refl_x = (u_fx < F_x) | tir_x
            v_refl_x = v_m - 2.0 * dot(v_m, N_out, keepdims=True) * N_out
            wo_exit = jnp.where(refl_x[..., None], normalize(v_refl_x),
                                normalize(v_refr_x))
            wo_w = jnp.where(exit_er[..., None], wo_exit, wo_w)
            bnd_any = bnd_entry | exit_er
        # density of regenerating the INCOMING direction from the sampled
        # outgoing one (reverse walk), used for the predecessor's pdf_rev
        pdf_rev_bs = bsdf_m.pdf(scene.bsdfs, b_idx, bs.wo, wi_l, active=act)
        pdf_rev_ph = phase_m.eval(media.phase, med, -ps.wo, -d_ph,
                                  active=pact)
        pdf_rev_dir = jnp.where(scat, pdf_rev_ph, pdf_rev_bs)
        step_w = jnp.where(scat[..., None], ps.weight[..., None], bs.weight)
        step_w = jnp.where(null_srf[..., None], 1.0, step_w)
        spec = jnp.where(scat, False, jnp.where(null_srf, True, bs.delta))
        pdf_next = jnp.where(scat, ps.pdf,
                             jnp.where(null_srf, 1.0, bs.pdf))
        if any_er:
            pdf_rev_dir = jnp.where(bnd_any, 1.0, pdf_rev_dir)
            step_w = jnp.where(bnd_any[..., None], 1.0, step_w)
            spec = jnp.where(bnd_any, True, spec)
            pdf_next = jnp.where(bnd_any, 1.0, pdf_next)
        beta_here = beta * dist_w
        beta_next = beta_here * step_w
        cont = valid & (scat | (b_idx >= 0) | null_srf
                        | (bnd_any if any_er else False)) \
            & jnp.any(step_w > 0, axis=-1)

        # medium transition at surface crossings (incl. null passthrough)
        crossed = valid_srf & (dot(wo_w, hit.ng) * dot(-d, hit.ng) < 0)
        entering = dot(wo_w, hit.ng) < 0
        med_next = jnp.where(crossed, jnp.where(entering, m_in, m_ex), med)
        if any_er:
            med_next = jnp.where(exit_er,
                                 jnp.where(refl_x, med, er_exterior),
                                 med_next)

        is_real = valid & ~null_srf
        d_in_rec = jnp.where(er_ln[..., None], d_arr_er, d) if any_er else d
        vert = dict(p=p_v, ng=ng_v, d_in=d_in_rec, beta=beta_here,
                    pdf_fwd=jnp.where(valid, pdf_fwd, 0.0),
                    pdf_rev_dir=jnp.where(valid, pdf_rev_dir, 0.0),
                    delta=prev_delta, spec=spec,
                    bsdf=b_idx, emitter=e_idx, valid=valid, plen=plen_here,
                    is_med=scat, med=jnp.where(scat, med, med_next),
                    shape=(jnp.where(exit_er, er_shape,
                                     jnp.where(valid_srf, hit.shape_id, -1))
                           if any_er else
                           jnp.where(valid_srf, hit.shape_id, -1)),
                    seg_psucc=seg_psucc, seg_pfail=seg_pfail,
                    is_real=is_real)
        o2 = p_v + wo_w * eps
        if any_er:
            o2 = jnp.where((exit_er & ~refl_x)[..., None],
                           p_m + N_out * eps + wo_w * eps, o2)
            o2 = jnp.where((exit_er & refl_x)[..., None],
                           p_m - N_out * eps + wo_w * eps, o2)
        # carries across null runs: last-real anchor, accumulated
        # fail-probability, arrival-delta passes straight through
        lr_p2 = jnp.where(is_real[..., None], p_v, lr_p)
        fail2 = jnp.where(is_real, 1.0, jnp.where(valid, seg_pfail,
                                                  fail_since))
        pdf_dir2 = jnp.where(is_real, pdf_next,
                             jnp.where(valid, pdf_dir, pdf_dir))
        delta2 = jnp.where(null_srf, prev_delta, spec)
        return (o2, wo_w, beta_next, pdf_dir2, cont, plen_here, delta2,
                med_next, lr_p2, fail2, smp), vert

    init = (o0, d0, beta1, pdf0_dir, jnp.ones((n,), bool),
            jnp.zeros((n,), jnp.float32), jnp.zeros((n,), bool), med0,
            origin_p, jnp.ones((n,), jnp.float32), smp)
    carry, verts = jax.lax.scan(body, init, None, length=K)
    smp = carry[-1]
    tr = lambda a: jnp.moveaxis(a, 0, 1)

    # ---- compact null pass-through slots out of the arrays ----
    # real vertices keep their order; the (s,t) machinery then always sees
    # REAL neighbors, whose straight-line measure conversions are exact
    # (collinear pass-through)
    realv = tr(verts["is_real"])                     # (n, K)
    kidx = jnp.broadcast_to(jnp.arange(K, dtype=jnp.int32), realv.shape)
    key = jnp.where(realv, kidx, K + kidx)
    _, order = jax.lax.sort_key_val(key, kidx, dimension=1)

    def cpk(a):
        x = tr(verts[a]) if isinstance(a, str) else a
        if x.ndim == 3:
            return jnp.take_along_axis(x, order[..., None], axis=1)
        return jnp.take_along_axis(x, order, axis=1)

    nreal = jnp.sum(realv, axis=1)                   # (n,)
    slot_ok = jnp.arange(K, dtype=jnp.int32)[None, :] < nreal[:, None]

    p = cpk("p")
    ng = cpk("ng")
    is_med = cpk("is_med") & slot_ok
    seg_psucc = cpk("seg_psucc")
    seg_pfail = cpk("seg_pfail")
    pdf_rev_dir = cpk("pdf_rev_dir")
    # pdf_rev[k] = pdf of vertex k as re-generated from vertex k+1: the
    # walk computed the reverse DIRECTION pdf at k+1; convert at k and
    # apply the shared segment's distance-pdf factor (symmetric for
    # homogeneous media).
    pdf_rev = jnp.zeros((n, K))
    if K > 1:
        rev_area = _to_area(pdf_rev_dir[:, 1:], p[:, 1:], p[:, :-1],
                            ng[:, :-1], is_med_to=is_med[:, :-1]) \
            * jnp.where(is_med[:, :-1], seg_psucc[:, 1:], seg_pfail[:, 1:])
        pdf_rev = pdf_rev.at[:, :-1].set(rev_area)
    # reverse pdf ONTO the walk origin (light y_0) from array vertex 0
    rev_to_origin = _to_area(pdf_rev_dir[:, 0], p[:, 0], origin_p,
                             origin_ng) * seg_pfail[:, 0]
    valid_c = cpk("valid") & slot_ok
    sub = SubPath(
        p=p, ng=ng, d_in=cpk("d_in"), beta=cpk("beta"),
        pdf_fwd=cpk("pdf_fwd"), pdf_rev=pdf_rev,
        delta=cpk("delta"), spec=cpk("spec"),
        bsdf=cpk("bsdf"), emitter=cpk("emitter"),
        valid=valid_c, plen=cpk("plen"),
        is_med=is_med, med=cpk("med"), shape=cpk("shape"),
        seg_psucc=seg_psucc, seg_pfail=seg_pfail,
        rdepth=jnp.cumsum(valid_c.astype(jnp.int32), axis=1),
    )
    return sub, rev_to_origin, smp


def _sample_light_vertex(scene, smp):
    """y_0 + emission ray (Scene::sampleEmitterRay; area + point kinds)."""
    from ..core import warp

    em = scene.emitters
    ne = em.kind.shape[0]
    u_sel, smp = rng.next_1d(smp)
    u_pos, smp = rng.next_2d(smp)
    u_dir, smp = rng.next_2d(smp)
    n = u_sel.shape[0]
    e_idx = jnp.clip((u_sel * ne).astype(jnp.int32), 0, ne - 1)
    u_tri = jnp.minimum(u_sel * ne - e_idx, 0.9999994)
    kind = smalltab.take(em.kind, e_idx)
    radiance = smalltab.take(em.radiance, e_idx)
    pos = smalltab.take(em.position, e_idx)

    p_area, n_area, pdf_area = emitter_m._sample_area_position(
        scene, e_idx, u_pos, u_tri)
    d_cos = Frame.from_normal(n_area).to_world(
        warp.square_to_cosine_hemisphere(u_dir))
    d_sph = warp.square_to_uniform_sphere(u_dir)

    is_area = kind == EM_AREA
    # collimated beams / directional emitters: position- AND direction-delta
    # starts. The bundled volumetric/ToF scenes are beam-lit
    # (collimated.cpp:25); convention: pdf_pos = 1/ne, pdf_dir = 1 with
    # delta_pos=True — every MIS term that would sample or connect through
    # the delta is already gated on delta_pos (see _mis_weight), so the
    # placeholder pdf values never reach an un-gated term.
    is_coll = kind == EM_COLLIMATED
    is_dir = kind == EM_DIRECTIONAL
    edir = smalltab.take(em.direction, e_idx)
    p0 = jnp.where(is_area[..., None], p_area, pos)
    ng0 = jnp.where(is_area[..., None], n_area, d_sph)
    ng0 = jnp.where((is_coll | is_dir)[..., None], edir, ng0)
    d0 = jnp.where(is_area[..., None], d_cos, d_sph)
    d0 = jnp.where((is_coll | is_dir)[..., None], edir, d0)
    cos0 = jnp.maximum(dot(d0, n_area), 1e-8)
    pdf_pos = jnp.where(is_area, pdf_area, 1.0) / ne
    pdf_dir = jnp.where(is_area, cos0 / jnp.pi,
                        warp.square_to_uniform_sphere_pdf())
    pdf_dir = jnp.where(is_coll | is_dir, 1.0, pdf_dir)
    beta1 = jnp.where(
        is_area[..., None],
        radiance * (cos0 / jnp.maximum(pdf_pos * pdf_dir, 1e-12))[..., None],
        radiance / jnp.maximum(pdf_pos * pdf_dir, 1e-12)[..., None])
    return LightStart(
        p=p0, ng=ng0, beta1=beta1,
        inv_pdf_pos=1.0 / jnp.maximum(pdf_pos, 1e-12), pdf_pos=pdf_pos,
        pdf_dir=pdf_dir, radiance=radiance, is_area=is_area,
        delta_pos=(kind == EM_POINT) | is_coll | is_dir,
        delta_dir=is_coll | is_dir, emitter=e_idx,
    ), d0, smp


def _bsdf_pdf_at(scene, cfg, sub, k, wi_w, wo_w):
    """Scattering pdf at vertex k for wi_w -> wo_w (both pointing AWAY from
    the vertex): BSDF pdf at surfaces, phase pdf (= value) at medium
    vertices (vertex.cpp medium branch)."""
    act = cfg.bsdf_kinds or None
    pact = cfg.phase_kinds or None
    frame = Frame.from_normal(sub.ng[:, k])
    p_srf = bsdf_m.pdf(scene.bsdfs, sub.bsdf[:, k], frame.to_local(wi_w),
                       frame.to_local(wo_w), active=act)
    p_med = phase_m.eval(scene.media.phase, sub.med[:, k], -wi_w, wo_w,
                         active=pact)
    return jnp.where(sub.is_med[:, k], p_med, p_srf)


def _bsdf_f_at(scene, cfg, sub, k, wi_w, wo_w):
    """Vertex throughput f for wi_w -> wo_w: BSDF eval (carries |cos wo|)
    at surfaces, phase value at medium vertices (the medium vertex's
    sigma_s is already folded into beta by the distance-sampling weight,
    so f is the bare phase function — vertex.cpp:250-256)."""
    act = cfg.bsdf_kinds or None
    pact = cfg.phase_kinds or None
    frame = Frame.from_normal(sub.ng[:, k])
    f_srf = bsdf_m.eval(scene.bsdfs, sub.bsdf[:, k], frame.to_local(wi_w),
                        frame.to_local(wo_w), active=act)
    f_med = phase_m.eval(scene.media.phase, sub.med[:, k], -wi_w, wo_w,
                         active=pact)[..., None]
    return jnp.where(sub.is_med[:, k][..., None], f_med, f_srf)


def _mis_weight(scene, cam, lt, light0, s, t, ov_cam, ov_cam2, ov_lt,
                ov_lt2, rev_lt_origin, npix):
    """Balance-heuristic MIS over strategies with the same path length.

    pbrt-v3 MISWeight structure on z_1..z_{t-1} (= cam[0..t-2]) and
    y_0..y_{s-1} (= light0 + lt[0..s-2]); junction reverse pdfs supplied:
      ov_cam  = pdfRev of z_{t-1}, ov_cam2 = pdfRev of z_{t-2}
      ov_lt   = pdfRev of y_{s-1}, ov_lt2  = pdfRev of y_{s-2}
    rev_lt_origin: stored pdfRev of y_0 as regenerated from y_1.

    Count-weighted balance heuristic (Veach 9.2.4): the light-image family
    (t'=1) draws npix-times more samples per pixel estimate than the
    per-pixel families (every light subpath can splat anywhere), so its
    pdf is weighted by npix in the balance — and a t=1 strategy's
    competitors are each down-weighted by 1/npix."""
    n = cam.p.shape[0] if t >= 2 else lt.p.shape[0]
    sum_ri = jnp.zeros((n,))
    F = jnp.zeros((n,), bool)

    def cam_fwd(i):   # pbrt z_i, i>=1
        return cam.pdf_fwd[:, i - 1]

    def cam_rev(i):
        if i == t - 1:
            return ov_cam
        if i == t - 2:
            return ov_cam2
        return cam.pdf_rev[:, i - 1]

    def cam_delta(i):
        # z_{t-1} is the junction: connectible by construction of the
        # strategy loop (delta-spec vertices produce zero f anyway)
        if i == t - 1:
            return F
        return cam.delta[:, i - 1]

    ri = jnp.ones((n,))
    for i in range(t - 1, 0, -1):
        ri = ri * _remap0(cam_rev(i)) / _remap0(cam_fwd(i))
        d_here = cam_delta(i)
        d_prev = cam_delta(i - 1) if i - 1 >= 1 else F  # z_0 pinhole: the
        # t'=1 light-image strategy IS valid (splat), so no delta gate
        scale = npix if i == 1 else 1.0  # t'=1 family sample-count weight
        sum_ri = sum_ri + jnp.where(~d_here & ~d_prev, ri * scale, 0.0)

    def lt_fwd(i):    # pbrt y_i
        return light0.pdf_pos if i == 0 else lt.pdf_fwd[:, i - 1]

    def lt_rev(i):
        if i == s - 1:
            return ov_lt
        if i == s - 2:
            return ov_lt2
        return rev_lt_origin if i == 0 else lt.pdf_rev[:, i - 1]

    def lt_delta(i):
        # y_0's own "lobe" delta is its EMISSION-direction delta: a point
        # light is position-delta yet freely connectable (term i=1 must
        # stay in the balance — gating it on delta_pos double-counted every
        # point-lit path across the (s'=1, t'=1-vs-NEE) family pair)
        if i == s - 1:
            return F
        return light0.delta_dir if i == 0 else lt.delta[:, i - 1]

    ri = jnp.ones((n,))
    for i in range(s - 1, -1, -1):
        ri = ri * _remap0(lt_rev(i)) / _remap0(lt_fwd(i))
        d_here = lt_delta(i)
        # the i=0 term is the s'=0 "camera hits the light" family: it needs
        # the light HITTABLE (area), i.e. ~delta_pos
        d_light_origin = light0.delta_pos if i == 0 else lt_delta(i - 1)
        sum_ri = sum_ri + jnp.where(~d_here & ~d_light_origin, ri, 0.0)

    if t == 1:
        # this strategy's own sample count is npix x larger
        sum_ri = sum_ri / npix
    return 1.0 / (1.0 + sum_ri)


def render_bdpt(scene: Scene, cfg: RenderConfig, seed: int = 0,
                t_max: int = None, s_max: int = None):
    """Full bidirectional render; returns the (H, W, 3) image (steady) or
    (H, W, 3*frames) for transient decompositions."""
    import functools

    H, W = cfg.height, cfg.width
    npix = H * W
    # +2 array slots absorb null-boundary crossings (which don't count as
    # path depth — see SubPath.rdepth)
    T_MAX = t_max or min(cfg.max_depth, 8) + 2  # camera vertices
    S_MAX = s_max or min(cfg.max_depth, 8) + 2  # light vertices incl y_0

    import numpy as np

    from ..scene.types import MED_HETEROGENEOUS as _MH

    any_het = bool(np.any(np.asarray(scene.media.kind) == _MH))
    any_er = bool(np.any(np.asarray(scene.media.kind) == MED_REFRACTIVE))

    @functools.partial(jax.jit, static_argnames=("cfg",))
    def one_pass(scene, eye_img, splat_img, cfg, seed, pass_idx):
        return _bdpt_pass(scene, eye_img, splat_img, cfg, T_MAX, S_MAX,
                          seed, pass_idx, any_het=any_het, any_er=any_er)

    nF = cfg.n_frames
    eye = jnp.zeros((npix, 3 * nF), jnp.float32)
    splat = jnp.zeros((npix, 3 * nF), jnp.float32)
    for i in range(cfg.spp):
        eye, splat = one_pass(scene, eye, splat, cfg, jnp.uint32(seed),
                              jnp.uint32(i))
    # eye image: spp camera paths per pixel; light image: npix*spp light
    # subpaths each able to splat anywhere -> divide by the total count
    img = eye / cfg.spp + splat / (cfg.spp * npix)
    return img.reshape(H, W, 3 * nF)


def _transient_slot(cfg, contrib, plen, base):
    """Scatter a contribution into its transient frame (steady: identity)."""
    nF = cfg.n_frames
    if nF == 1:
        return base + contrib
    idx = jnp.clip(((plen - cfg.min_bound) / cfg.bin_width).astype(jnp.int32),
                   0, nF - 1)
    oh = jax.nn.one_hot(idx, nF)                       # (n, F)
    return base + (oh[..., None] * contrib[:, None, :]).reshape(
        contrib.shape[0], -1)


def _strategy_on(s, t):
    """Debug filter: BDPT_ONLY='s,t' isolates one strategy (weights
    forced to 1 via BDPT_NOMIS=1)."""
    import os
    only = os.environ.get("BDPT_ONLY")
    if not only:
        return True
    ss, tt = only.split(",")
    return int(ss) == s and int(tt) == t


def _nomis():
    import os
    return bool(os.environ.get("BDPT_NOMIS"))


def _bdpt_pass(scene, eye_img, splat_img, cfg, T_MAX, S_MAX, seed, pass_idx,
               any_het=False, any_er=False):
    H, W = cfg.height, cfg.width
    npix = H * W
    n = npix
    eps = common.scene_epsilon(scene)
    cam_p = scene.sensor.to_world[:3, 3]
    act = cfg.bsdf_kinds or None
    bricks = medium_m.DensityBricks(scene.media)
    if any_er:
        rif = ek.rif_from_media(scene.media, cfg.rif_kinds)
        sdf = ek.sdf_from_media(scene.media)
        _, sa_er, ss_er, _, er_idx = _refractive_params(scene)
        st_er = sa_er + ss_er
        h_bvp = cfg.er_stepsize * cfg.er_bvp_hscale
        bvp_steps = max(int(cfg.er_maxsteps / cfg.er_bvp_hscale), 16)
    mod_w = None
    if cfg.modulation != "none":
        from ..models import tof as tof_m
        mod_w = lambda plen: tof_m.correlation_function(cfg, plen)

    lane = jnp.arange(n, dtype=jnp.uint32)
    smp = rng.make_sampler(jnp.asarray(seed, jnp.uint32), lane, pass_idx)

    # ---------------- camera subpath ----------------
    u_jit, smp = rng.next_2d(smp)
    px = (lane % W).astype(jnp.float32) + u_jit[:, 0]
    py = (lane // W).astype(jnp.float32) + u_jit[:, 1]
    rays = sensor_m.sample_rays(
        scene.sensor, px, py, W, H,
        kind_hint=(cfg.sensor_kind if cfg.sensor_kind >= 0 else None))
    # camera direction pdf: uniform over the pixel's solid angle
    fs0 = sensor_m.project(scene.sensor, rays.o + rays.d, W, H)
    pdf_cam_dir = fs0.inv_pixel_omega
    cam, _, smp = _surface_walk(
        scene, cfg, rays.o, rays.d, jnp.ones((n, 3)), pdf_cam_dir,
        rays.o, jnp.zeros((n, 3)), smp, T_MAX, eps, any_het=any_het,
        any_er=any_er)

    # ---------------- light subpath ----------------
    light0, d0, smp = _sample_light_vertex(scene, smp)
    # emission-side medium: area emitters start in the shape's exterior,
    # point-likes in the scene-global camera medium (ptracer convention)
    em = scene.emitters
    se = smalltab.take(em.shape_id, light0.emitter)
    se_c = jnp.clip(se, 0, scene.shapes.exterior.shape[0] - 1)
    med_l0 = jnp.where(
        se >= 0, smalltab.take(scene.shapes.exterior, se_c),
        jnp.broadcast_to(scene.camera_medium, (n,)).astype(jnp.int32))
    lt, rev_lt_origin, smp = _surface_walk(
        scene, cfg, light0.p + d0 * eps, d0, light0.beta1, light0.pdf_dir,
        light0.p, light0.ng, smp, max(S_MAX - 1, 1), eps, med0=med_l0,
        any_het=any_het, any_er=any_er)

    F = jnp.zeros((n,), bool)
    ones = jnp.ones((n,))

    # null pass-through slots are compacted out of the subpath arrays, so
    # array index == real path depth; the extra +2 walk slots only buy the
    # WALK room to traverse null boundaries

    # ---------------- s = 0: camera path hits an emitter ----------------
    for t in range(2, T_MAX + 2):
        k = t - 2                      # array index of z_{t-1}
        if k >= T_MAX or t - 1 > cfg.max_depth:
            break
        if not _strategy_on(0, t):
            continue
        e_idx = cam.emitter[:, k]
        ok = cam.valid[:, k] & (e_idx >= 0) \
            & (cam.rdepth[:, k] <= cfg.max_depth)
        wo = -cam.d_in[:, k]
        Le = emitter_m.eval_hit(scene, e_idx, cam.ng[:, k], wo)
        contrib = cam.beta[:, k] * Le
        # junction pdfs: z_{t-1} regenerated as a light origin; z_{t-2}
        # regenerated by emission from z_{t-1}
        earea = smalltab.take(scene.emitters.area,
                              jnp.clip(e_idx, 0, scene.emitters.area.shape[0] - 1))
        ne = scene.emitters.kind.shape[0]
        pdf_light_origin = 1.0 / jnp.maximum(earea * ne, 1e-12)
        if t >= 3:
            prev_p = cam.p[:, k - 1]
            prev_ng = cam.ng[:, k - 1]
        else:
            prev_p = jnp.broadcast_to(cam_p, (n, 3))
            prev_ng = jnp.zeros((n, 3))
        cos_l = jnp.maximum(dot(normalize(prev_p - cam.p[:, k]),
                                cam.ng[:, k]), 0.0)
        pdf_emit_dir = cos_l / jnp.pi
        if t >= 3:
            ov_cam2 = _to_area(pdf_emit_dir, cam.p[:, k], prev_p, prev_ng,
                               is_med_to=cam.is_med[:, k - 1]) \
                * jnp.where(cam.is_med[:, k - 1], cam.seg_psucc[:, k],
                            cam.seg_pfail[:, k])
        else:
            ov_cam2 = ones
        w = ones if _nomis() else _mis_weight(
            scene, cam, lt, light0, 0, t, pdf_light_origin, ov_cam2, ones,
            ones, rev_lt_origin, npix)
        val = contrib * w[..., None]
        ok = ok & jnp.all(jnp.isfinite(val), -1)
        eye_img = _transient_slot(
            cfg, jnp.where(ok[..., None], val, 0.0),
            cam.plen[:, k], eye_img)

    # ---------------- t >= 2, s >= 1 connections ----------------
    for t in range(2, T_MAX + 2):
        kc = t - 2
        if kc >= T_MAX:
            break
        for s in range(1, S_MAX + 1):
            if s + t - 1 > cfg.max_depth or not _strategy_on(s, t):
                continue
            if s == 1:
                yp, yng = light0.p, light0.ng
                y_valid = jnp.ones((n,), bool)
                s_real = jnp.ones((n,), jnp.int32)
            else:
                kl = s - 2
                if kl >= lt.p.shape[1]:
                    continue
                yp, yng = lt.p[:, kl], lt.ng[:, kl]
                y_valid = lt.valid[:, kl]
                s_real = 1 + lt.rdepth[:, kl]
            zp, zng = cam.p[:, kc], cam.ng[:, kc]
            t_real = 1 + cam.rdepth[:, kc]
            ok = cam.valid[:, kc] & y_valid \
                & (s_real + t_real - 1 <= cfg.max_depth)
            dvec = yp - zp
            d2 = jnp.maximum(jnp.sum(dvec * dvec, -1), 1e-12)
            dist = jnp.sqrt(d2)
            wconn = dvec / dist[..., None]
            # ---- curved ER connection (edge.cpp:473-643): when either
            # endpoint is a medium vertex inside the refractive medium, the
            # straight chord is replaced by the BVP-curved connection; its
            # exit direction / reverse direction feed the endpoint f terms,
            # its optical length corrects the transient path length and
            # refRatioSq compresses radiance (bdpt_proc.cpp:396-399) ----
            if any_er:
                z_er = cam.is_med[:, kc] & (cam.med[:, kc] == er_idx)
                y_er = (lt.is_med[:, kl] & (lt.med[:, kl] == er_idx)) \
                    if s >= 2 else jnp.zeros((n,), bool)
                er_conn = ok & (z_er | y_er)
                from_z = z_er  # solve from the camera side when inside
                p1 = jnp.where(from_z[..., None], zp, yp)
                p2 = jnp.where(from_z[..., None], yp, zp)
                chord = normalize(p2 - p1)
                seed_er = rng._hash_u32(
                    smp.lane + smp.seed * jnp.uint32(0xC2B2AE35)
                    + jnp.uint32(s * 131 + t * 31337))
                bvp = ek.solve_bvp(
                    rif, sdf, p1, p2, chord, h_bvp, bvp_steps, er_conn,
                    tol2=cfg.bvp_tol2, rr_weight=cfg.rr_weight,
                    seed_bits=seed_er, max_restarts=cfg.bvp_restarts,
                    kernels=cfg.kernels)
                er_ok = er_conn & bvp.converged
                # direction leaving z / leaving y along the curved path
                wz_er = jnp.where(from_z[..., None], bvp.dir_to_target,
                                  bvp.rev_dir)
                wy_er = jnp.where(from_z[..., None], bvp.rev_dir,
                                  bvp.dir_to_target)
                wconn_z = jnp.where(er_conn[..., None], wz_er, wconn)
                wconn_y = jnp.where(er_conn[..., None], wy_er, -wconn)
                g2 = jnp.maximum(bvp.geo_total * bvp.geo_total, 1e-12)
                # radiance compression (n_receiver/n_source)^2, receiver =
                # camera side (volpath_er NEE uses (n(z)/1)^2 with z the
                # receiving scatter vertex; trace_er_particles uses
                # (1/n(y))^2 with y the emitting vertex — same rule)
                n_z = jnp.where(z_er,
                                jnp.maximum(ek.rif_value(rif, zp), 1e-6),
                                1.0)
                n_y = jnp.where(y_er,
                                jnp.maximum(ek.rif_value(rif, yp), 1e-6),
                                1.0)
                rr_sq = (n_z / n_y) ** 2
                tr_er_conn = jnp.exp(
                    -st_er[None, :] * bvp.geo_inside[..., None]) \
                    * (rr_sq * bvp.weight)[..., None]
            else:
                er_conn = jnp.zeros((n,), bool)
                er_ok = er_conn
                wconn_z, wconn_y = wconn, -wconn
            # camera-side f
            f_c = _bsdf_f_at(scene, cfg, cam, kc, -cam.d_in[:, kc], wconn_z)
            # light-side f (and Le for s=1)
            # NOTE bsdf_m.eval returns f * |cos(wo)|, so f_c already carries
            # the camera-side cosine and f_y (s>=2) the light-side cosine;
            # the remaining geometric factor is only the 1/d^2 (+ emission
            # cosine for s=1 area lights, which has no BSDF to carry it)
            if s == 1:
                cos_y = jnp.maximum(dot(wconn_y, light0.ng), 0.0)
                f_y_over_cos = jnp.where(
                    light0.is_area[..., None],
                    light0.radiance * jnp.where(cos_y > 0, 1.0, 0.0)[..., None],
                    light0.radiance)  # point: intensity, no cos
                beta_y = light0.inv_pdf_pos[..., None] * jnp.ones((n, 3))
                G = jnp.where(light0.is_area, cos_y / d2, 1.0 / d2)
                # delta-direction starts (collimated/directional) cannot be
                # connected to; point lights are position-delta only and
                # connect freely (fixed r5: the old delta_pos gate zeroed
                # every s=1 strategy in point-lit scenes)
                ok = ok & ~light0.delta_dir
            else:
                f_y_over_cos = _bsdf_f_at(scene, cfg, lt, kl,
                                          -lt.d_in[:, kl], wconn_y)
                G = 1.0 / d2
                beta_y = lt.beta[:, kl]
            if any_er:
                # curved falloff 1/geo_total^2 replaces 1/d^2
                G = jnp.where(er_conn, G * d2 / g2, G)
            contrib = (cam.beta[:, kc] * f_c * beta_y * f_y_over_cos
                       * G[..., None])
            any_c = jnp.any(contrib > 0, -1)
            ok = ok & any_c
            # transmittance + occlusion across null boundaries
            # (pathConnectAndCollapse / evalTransmittanceAll analogue)
            conn_med = _conn_medium(scene, cam.is_med[:, kc],
                                    cam.med[:, kc], cam.shape[:, kc],
                                    cam.ng[:, kc], wconn)
            tr_conn, smp = attenuated_visibility(
                scene, eps, zp + wconn * eps, wconn, dist - 2 * eps,
                conn_med, smp, ok & ~er_conn, bricks=bricks,
                block_refractive=any_er)
            if any_er:
                # curved connections: in-medium transmittance from the BVP
                # (straight occlusion of the outside tail not re-checked —
                # matches volpath_er's curved-NEE scope)
                tr_conn = jnp.where(er_conn[..., None], tr_er_conn, tr_conn)
                ok = ok & (~er_conn | er_ok)
            contrib = contrib * tr_conn
            ok = ok & jnp.any(tr_conn > 0, -1)
            c_psucc, c_pfail = _seg_pdf_factors(scene, conn_med, dist)
            if any_er:
                # ER connection-segment pdf factors at the curved length
                tmp_er = jnp.exp(
                    -st_er[None, :] * bvp.geo_inside[..., None])
                c_psucc = jnp.where(er_conn,
                                    jnp.mean(st_er[None, :] * tmp_er, -1),
                                    c_psucc)
                c_pfail = jnp.where(er_conn, jnp.mean(tmp_er, -1), c_pfail)

            # ---- junction reverse pdfs ----
            # z_{t-1} from y_{s-1}
            if s == 1:
                cos_y1 = jnp.maximum(dot(wconn_y, light0.ng), 1e-8)
                pdf_y_dir = jnp.where(light0.is_area, cos_y1 / jnp.pi,
                                      1.0 / (4.0 * jnp.pi))
            else:
                pdf_y_dir = _bsdf_pdf_at(scene, cfg, lt, kl,
                                         -lt.d_in[:, kl], wconn_y)
            ov_cam = _to_area(pdf_y_dir, yp, zp, zng,
                              is_med_to=cam.is_med[:, kc]) \
                * jnp.where(cam.is_med[:, kc], c_psucc, c_pfail)
            if any_er:
                # curved measure conversion scales with the curved length
                ov_cam = jnp.where(er_conn, ov_cam * d2 / g2, ov_cam)
            # z_{t-2} from z_{t-1} (scattering backward given wconn in)
            pdf_z_back = _bsdf_pdf_at(scene, cfg, cam, kc, wconn_z,
                                      -cam.d_in[:, kc])
            if t >= 3:
                ov_cam2 = _to_area(pdf_z_back, zp, cam.p[:, kc - 1],
                                   cam.ng[:, kc - 1],
                                   is_med_to=cam.is_med[:, kc - 1]) \
                    * jnp.where(cam.is_med[:, kc - 1],
                                cam.seg_psucc[:, kc], cam.seg_pfail[:, kc])
            else:
                ov_cam2 = ones
            # y_{s-1} from z_{t-1}
            pdf_z_dir = _bsdf_pdf_at(scene, cfg, cam, kc,
                                     -cam.d_in[:, kc], wconn_z)
            y_is_med = lt.is_med[:, kl] if s >= 2 else F
            ov_lt = _to_area(pdf_z_dir, zp, yp, yng, is_med_to=y_is_med) \
                * jnp.where(y_is_med, c_psucc, c_pfail)
            if any_er:
                ov_lt = jnp.where(er_conn, ov_lt * d2 / g2, ov_lt)
            # y_{s-2} from y_{s-1}
            if s >= 2:
                if s == 2:
                    prev_lp, prev_lng = light0.p, light0.ng
                    prev_l_med = F
                else:
                    prev_lp, prev_lng = lt.p[:, kl - 1], lt.ng[:, kl - 1]
                    prev_l_med = lt.is_med[:, kl - 1]
                pdf_y_back = _bsdf_pdf_at(scene, cfg, lt, kl, wconn_y,
                                          -lt.d_in[:, kl])
                ov_lt2 = _to_area(pdf_y_back, yp, prev_lp, prev_lng,
                                  is_med_to=prev_l_med) \
                    * jnp.where(prev_l_med, lt.seg_psucc[:, kl],
                                lt.seg_pfail[:, kl])
            else:
                ov_lt2 = ones
            w = ones if _nomis() else _mis_weight(
                scene, cam, lt, light0, s, t, ov_cam, ov_cam2, ov_lt,
                ov_lt2, rev_lt_origin, npix)
            conn_len = dist
            if any_er:
                # optical connection length (bdpt_proc.cpp:396-399)
                conn_len = jnp.where(er_conn, bvp.opt_len, dist)
            plen_tot = cam.plen[:, kc] + conn_len + \
                (lt.plen[:, kl] if s >= 2 else 0.0)
            val = contrib * w[..., None]
            if mod_w is not None:
                val = val * mod_w(plen_tot)[..., None]
            ok = ok & jnp.all(jnp.isfinite(val), -1)
            eye_img = _transient_slot(
                cfg, jnp.where(ok[..., None], val, 0.0), plen_tot, eye_img)

    # ---------------- t = 1: light image ----------------
    for s in range(1, S_MAX + 2):
        if s > cfg.max_depth:
            break
        if not _strategy_on(s, 1):
            continue
        if s == 1:
            kl = -1
            yp, yng = light0.p, light0.ng
            ok = jnp.ones((n,), bool)
        else:
            kl = s - 2
            if kl >= lt.p.shape[1]:
                break
            yp, yng = lt.p[:, kl], lt.ng[:, kl]
            ok = lt.valid[:, kl] \
                & (1 + lt.rdepth[:, kl] <= cfg.max_depth)
        to_c = jnp.broadcast_to(cam_p, (n, 3)) - yp
        d2 = jnp.maximum(jnp.sum(to_c * to_c, -1), 1e-12)
        dist = jnp.sqrt(d2)
        d_c = to_c / dist[..., None]
        if any_er and s >= 2:
            # curved sensor-side connection from an in-medium light vertex
            # (edge.cpp:535-543 h-dielectric sensor-direct support; the
            # splat pixel comes from the ARRIVAL direction at the camera)
            y_er1 = ok & lt.is_med[:, kl] & (lt.med[:, kl] == er_idx)
            seed_t1 = rng._hash_u32(
                smp.lane + smp.seed * jnp.uint32(0x85EBCA6B)
                + jnp.uint32(s * 977 + 13))
            bvp1 = ek.solve_bvp(
                rif, sdf, yp, jnp.broadcast_to(cam_p, (n, 3)), d_c,
                h_bvp, bvp_steps, y_er1, tol2=cfg.bvp_tol2,
                rr_weight=cfg.rr_weight, seed_bits=seed_t1,
                max_restarts=cfg.bvp_restarts, kernels=cfg.kernels)
            y_er1_ok = y_er1 & bvp1.converged
            d_c = jnp.where(y_er1[..., None], bvp1.dir_to_target, d_c)
            d_arr1 = -bvp1.rev_dir
            proj_p = jnp.where(y_er1[..., None],
                               jnp.broadcast_to(cam_p, (n, 3)) - d_arr1, yp)
            fs = sensor_m.project(scene.sensor, proj_p, W, H)
            ok = ok & fs.valid & (~y_er1 | y_er1_ok)
        else:
            y_er1 = jnp.zeros((n,), bool)
            fs = sensor_m.project(scene.sensor, yp, W, H)
            ok = ok & fs.valid
        if s == 1:
            # y_0 itself: emitted radiance toward the camera over pdf_pos
            cos_y0 = jnp.maximum(dot(d_c, light0.ng), 0.0)
            f_y = jnp.where(
                light0.is_area[..., None],
                light0.radiance * cos_y0[..., None], 0.0)
            beta_y = light0.inv_pdf_pos[..., None] * jnp.ones((n, 3))
            ok = ok & light0.is_area & (cos_y0 > 0)
        else:
            f_y = _bsdf_f_at(scene, cfg, lt, kl, -lt.d_in[:, kl], d_c)
            beta_y = lt.beta[:, kl]
        y_is_med = lt.is_med[:, kl] if s >= 2 else F
        conn_med = _conn_medium(
            scene, y_is_med,
            lt.med[:, kl] if s >= 2 else jnp.zeros((n,), jnp.int32),
            lt.shape[:, kl] if s >= 2 else jnp.full((n,), -1, jnp.int32),
            yng, d_c)
        tr_c, smp = attenuated_visibility(
            scene, eps, yp + d_c * eps, d_c, dist - 2 * eps, conn_med, smp,
            ok & ~y_er1, bricks=bricks, block_refractive=any_er)
        geom_t1 = fs.inv_pixel_omega / d2
        if any_er and s >= 2:
            tr_er1 = jnp.exp(-st_er[None, :] * bvp1.geo_inside[..., None])
            n_y1 = jnp.maximum(ek.rif_value(rif, yp), 1e-6)
            tr_er1 = tr_er1 * ((1.0 / n_y1) ** 2 * bvp1.weight)[..., None]
            tr_c = jnp.where(y_er1[..., None], tr_er1, tr_c)
            geom_t1 = jnp.where(
                y_er1, fs.inv_pixel_omega
                / jnp.maximum(bvp1.geo_total ** 2, 1e-9), geom_t1)
        ok = ok & jnp.any(tr_c > 0, -1)
        val = (beta_y * f_y * tr_c * geom_t1[..., None])
        c_psucc, c_pfail = _seg_pdf_factors(scene, conn_med, dist)
        if any_er and s >= 2:
            tmp1 = jnp.exp(-st_er[None, :] * bvp1.geo_inside[..., None])
            c_psucc = jnp.where(y_er1,
                                jnp.mean(st_er[None, :] * tmp1, -1), c_psucc)
            c_pfail = jnp.where(y_er1, jnp.mean(tmp1, -1), c_pfail)
        # junction pdfs: y_{s-1} regenerated from the camera
        pdf_cam_dir2 = fs.inv_pixel_omega
        ov_lt = _to_area(pdf_cam_dir2, jnp.broadcast_to(cam_p, (n, 3)),
                         yp, yng, is_med_to=y_is_med) \
            * jnp.where(y_is_med, c_psucc, c_pfail)
        if any_er and s >= 2:
            ov_lt = jnp.where(
                y_er1, ov_lt * d2 / jnp.maximum(bvp1.geo_total ** 2, 1e-9),
                ov_lt)
        if s >= 3:
            prev_lp, prev_lng = ((light0.p, light0.ng) if s == 3 else
                                 (lt.p[:, kl - 1], lt.ng[:, kl - 1]))
            prev_l_med = (F if s == 3 else lt.is_med[:, kl - 1])
            pdf_y_back = _bsdf_pdf_at(scene, cfg, lt, kl, d_c,
                                      -lt.d_in[:, kl])
            ov_lt2 = _to_area(pdf_y_back, yp, prev_lp, prev_lng,
                              is_med_to=prev_l_med) \
                * jnp.where(prev_l_med, lt.seg_psucc[:, kl],
                            lt.seg_pfail[:, kl])
        elif s == 2:
            # y_0 regenerated from y_1: the junction at y_{s-1}=y_1 changes
            # y_1's incoming to the camera direction; its backward pdf onto
            # y_0 is the BSDF pdf at y_1 from d_c toward y_0
            pdf_y0 = _bsdf_pdf_at(scene, cfg, lt, 0, d_c,
                                  normalize(light0.p - lt.p[:, 0]))
            ov_lt2 = _to_area(pdf_y0, lt.p[:, 0], light0.p, light0.ng)
        else:
            ov_lt2 = ones
        w = ones if _nomis() else _mis_weight(
            scene, cam, lt, light0, s, 1, ones, ones, ov_lt, ov_lt2,
            rev_lt_origin, npix)
        conn_len1 = dist
        if any_er and s >= 2:
            conn_len1 = jnp.where(y_er1, bvp1.opt_len, dist)
        plen_tot = (lt.plen[:, kl] if s >= 2 else 0.0) + conn_len1
        val = val * w[..., None]
        if mod_w is not None:
            val = val * mod_w(plen_tot)[..., None]
        ok = ok & jnp.all(jnp.isfinite(val), -1)
        val = jnp.where(ok[..., None], val, 0.0)
        pxi = jnp.clip(fs.px.astype(jnp.int32), 0, W - 1)
        pyi = jnp.clip(fs.py.astype(jnp.int32), 0, H - 1)
        pix_id = pyi * W + pxi
        nF = cfg.n_frames
        if nF == 1:
            splat_img = splat_img.at[pix_id].add(val)
        else:
            fidx = jnp.clip(((plen_tot - cfg.min_bound)
                             / cfg.bin_width).astype(jnp.int32), 0, nF - 1)
            flat = jnp.zeros_like(splat_img).at[pix_id].add(
                (jax.nn.one_hot(fidx, nF)[..., None]
                 * val[:, None, :]).reshape(n, -1))
            splat_img = splat_img + flat

    return eye_img, splat_img
