"""Refractive radiative transfer integrator: volumetric path tracing with
*curved* rays through a refractive-index field.

Reference: the ER pipeline of heterogeneousrefractive.cpp wired through
PathVertex/PathEdge (vertex.cpp:250-256, edge.cpp:27-92,473-643) and
bdpt_proc.cpp. This integrator is the volpath-family equivalent (the north
star's estimator): camera paths march curved rays inside the refractive
medium, scatter with the medium's (homogeneous) sigma coefficients, connect
to emitters by solving the curved BVP (NEE), and refract through the
h-dielectric boundary with position-dependent eta (hdielectric.cpp:115).

Transport bookkeeping mirrors the reference:
  - radiance compression refRatioSq = (n_end/n_start)^2 multiplies the
    throughput for every traversed curved segment (edge.cpp:91-92,
    sampleDistance :468-531);
  - optical (not geometric) path length accumulates for transient/ToF
    binning (bdpt_proc.cpp:396-399);
  - failed BVP solves are russian-rouletted with weight 1/rrweight
    (heterogeneousrefractive.cpp:1146-1155).

Scene contract: media[refractive_id].kind == MED_REFRACTIVE, with the RIF +
SDF fields describing the medium body; the boundary shape's interior points
at that medium (h-dielectric behavior is implied — hdielectric.cpp forbids
the position-independent overloads). Lights and camera sit outside the
medium (the bundled reference ER scenes' configuration); curved NEE
connections refract once through the boundary (computePathLengthsTillClosestP2
sensor-side handling, :960-992).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import rng, smalltab
from ..core.math import Frame, dot, fresnel_dielectric, length, mis_weight_power, normalize
from ..models import bsdf as bsdf_m
from ..models import eikonal as ek
from ..models import emitter as emitter_m
from ..models import phase as phase_m
from ..scene import intersect as isect
from ..scene.types import MED_REFRACTIVE, RenderConfig, Scene
from . import common


class _State(NamedTuple):
    o: jnp.ndarray
    v: jnp.ndarray            # scaled velocity: |v| = n(p) inside, 1 outside
    inside: jnp.ndarray       # (N,) bool: inside the refractive medium
    throughput: jnp.ndarray
    sink: common.Sink
    active: jnp.ndarray
    depth: jnp.ndarray
    plen: jnp.ndarray         # OPTICAL path length
    last_pdf: jnp.ndarray
    last_delta: jnp.ndarray
    from_medium: jnp.ndarray  # (N,) bool: most recent non-delta event was a
    #   medium scatter inside the refractive body. Such transport to area
    #   emitters is estimated EXCLUSIVELY by the curved-NEE family (the
    #   phase-sampled exit chain is all-delta, so an emitter hit would
    #   otherwise be double-counted at full weight — there is no tractable
    #   solid-angle pdf through the solved BVP to MIS the two families).
    iters: jnp.ndarray
    sampler: object


def _refractive_params(scene: Scene):
    """sigma coefficients of the (single) refractive medium."""
    media = scene.media
    is_ref = media.kind == MED_REFRACTIVE
    idx = jnp.argmax(is_ref)
    return (
        jnp.any(is_ref),
        media.sigma_a[idx],
        media.sigma_s[idx],
        media.sampling_weight[idx],
        idx.astype(jnp.int32),
    )


def li(scene: Scene, cfg: RenderConfig, o, d, sampler, pixel=None,
       differentiable: bool = False, max_iters_override: int = None):
    state, cond, body, max_iters = _li_build(
        scene, cfg, o, d, sampler, pixel=pixel,
        differentiable=differentiable, max_iters_override=max_iters_override)
    if differentiable:
        ck = jax.checkpoint(lambda st, _: (body(st), None))
        final, _ = jax.lax.scan(ck, state, None, length=max_iters)
    else:
        final = jax.lax.while_loop(cond, body, state)
    return final.sink, final.sampler


def _li_build(scene: Scene, cfg: RenderConfig, o, d, sampler, pixel=None,
              differentiable: bool = False, max_iters_override: int = None):
    """Build (state0, cond, body, max_iters) for the ER bounce loop (li runs
    it as one on-device while_loop, or a checkpointed scan when
    differentiating)."""
    n = o.shape[0]
    eps = common.scene_epsilon(scene)
    sink = common.new_sink(cfg, n, pixel)
    rif = ek.rif_from_media(scene.media, cfg.rif_kinds)
    sdf = ek.sdf_from_media(scene.media)
    _, sigma_a, sigma_s, samp_w, med_idx = _refractive_params(scene)
    sigma_t = sigma_a + sigma_s
    h = cfg.er_stepsize
    max_march = cfg.er_maxsteps

    state = _State(
        o=o, v=d,
        inside=jnp.zeros((n,), bool),
        throughput=jnp.ones((n, 3), jnp.float32),
        sink=sink,
        active=jnp.ones((n,), bool),
        depth=jnp.ones((n,), jnp.int32),
        plen=jnp.zeros((n,), jnp.float32),
        last_pdf=jnp.zeros((n,), jnp.float32),
        last_delta=jnp.ones((n,), bool),
        from_medium=jnp.zeros((n,), bool),
        iters=jnp.zeros((), jnp.int32),
        sampler=sampler,
    )
    max_iters = max_iters_override or (2 * cfg.max_depth + 8)

    def cond(s: _State):
        return jnp.any(s.active) & (s.iters < max_iters)

    def body(s: _State):
        smp = s.sampler
        media = scene.media

        # ================= OUTSIDE lanes: straight transport =============
        d_out = normalize(s.v)
        out_act = s.active & ~s.inside
        hit = isect.intersect(scene.geo, s.o, d_out,
                              jnp.full((n,), eps), jnp.full((n,), isect.INF))

        escaped = out_act & ~hit.valid
        env = emitter_m.env_radiance(scene, d_out)
        env_pdf = emitter_m.pdf_direct_env(scene, d_out)
        w_env = jnp.where(s.last_delta, 1.0, mis_weight_power(s.last_pdf, env_pdf))
        sink_new = common.add_contribution(
            s.sink, cfg, s.throughput * env * w_env[..., None], s.plen,
            s.depth, escaped,
        )

        ns_ = scene.shapes.bsdf.shape[0]
        sid = jnp.clip(hit.shape_id, 0, ns_ - 1)
        ok_s = hit.shape_id >= 0
        b_idx = jnp.where(ok_s, smalltab.take(scene.shapes.bsdf, sid), -1)
        e_idx = jnp.where(ok_s, smalltab.take(scene.shapes.emitter, sid), -1)
        m_in = jnp.where(ok_s, smalltab.take(scene.shapes.interior, sid), -1)
        is_ref_boundary = ok_s & (m_in == med_idx) & jnp.any(media.kind == MED_REFRACTIVE)

        hide = cfg.hide_emitters & (s.depth == 1)
        # medium-scatter -> area-emitter transport is owned by curved NEE
        # (see _State.from_medium) — drop the hit-family contribution there
        hit_emitter = out_act & hit.valid & (e_idx >= 0) & ~s.from_medium
        le = emitter_m.eval_hit(scene, e_idx, hit.ng, -d_out)
        lum_pdf = emitter_m.pdf_direct_hit(scene, e_idx, s.o, hit.p, hit.ng)
        w_hit = jnp.where(s.last_delta, 1.0, mis_weight_power(s.last_pdf, lum_pdf))
        plen_srf = s.plen + jnp.where(hit.valid, hit.t, 0.0)
        sink_new = common.add_contribution(
            sink_new, cfg, s.throughput * le * w_hit[..., None], plen_srf,
            s.depth, hit_emitter & ~hide,
        )

        depth_ok = s.depth < cfg.max_depth

        # --- ordinary surfaces (non-boundary): diffuse-style path logic ---
        srf = out_act & hit.valid & ~is_ref_boundary & depth_ok & (b_idx >= 0)
        frame = Frame.from_normal(hit.ng)
        wi_l = frame.to_local(-d_out)
        u2e, smp = rng.next_2d(smp)
        u1e, smp = rng.next_1d(smp)
        ds = emitter_m.sample_direct(scene, hit.p, u2e, u1e)
        act = cfg.bsdf_kinds or None
        f_nee = bsdf_m.eval(scene.bsdfs, b_idx, wi_l, frame.to_local(ds.d),
                            active=act)
        pdf_dir = bsdf_m.pdf(scene.bsdfs, b_idx, wi_l, frame.to_local(ds.d),
                             active=act)
        vis = srf & (ds.pdf > 0) & jnp.any(f_nee > 0, axis=-1) & jnp.any(ds.value > 0, axis=-1)
        blocked = isect.occluded(
            scene.geo, hit.p + ds.d * eps, ds.d,
            jnp.full((n,), eps * 0.1), ds.dist - 2 * eps,
        )
        w_nee = jnp.where(ds.delta, 1.0, mis_weight_power(ds.pdf, pdf_dir))
        sink_new = common.add_contribution(
            sink_new, cfg,
            s.throughput * f_nee * ds.value
            * (w_nee / jnp.maximum(ds.pdf, 1e-12))[..., None],
            plen_srf + ds.dist, s.depth + 1, vis & ~blocked,
        )
        u2b, smp = rng.next_2d(smp)
        u1b, smp = rng.next_1d(smp)
        bs = bsdf_m.sample(scene.bsdfs, b_idx, wi_l, u2b, u1b, active=act)
        wo_srf = frame.to_world(bs.wo)

        # --- refractive boundary crossing (h-dielectric entry) ---
        entering = out_act & hit.valid & is_ref_boundary & depth_ok
        n_at = ek.rif_value(rif, hit.p)
        cos_i = dot(-d_out, hit.ng)  # > 0 when hitting the outside face
        F, _ = fresnel_dielectric(cos_i, n_at)
        u_f, smp = rng.next_1d(smp)
        do_reflect = u_f < F
        v_refl = d_out - 2.0 * dot(d_out, hit.ng, keepdims=True) * hit.ng
        # refract the (unit) outside velocity into scaled inside velocity
        N_in = jnp.where(cos_i[..., None] > 0, hit.ng, -hit.ng)
        v_refr, _tir = ek.boundary_velocity(d_out, N_in, jnp.ones((n,)), n_at)

        # ================= INSIDE lanes: curved transport ================
        in_act = s.active & s.inside
        # exponential distance sampling with the balance strategy gate
        u_d, smp = rng.next_1d(smp)
        uc_d, smp = rng.next_1d(smp)
        from ..models import medium as medium_m
        from ..models.medium import sample_distance_homogeneous

        # in-medium 4-strategy split (heterogeneousrefractive.cpp:239-255:
        # the refractive medium reuses the homogeneous strategy family)
        if cfg.medium_strategies:
            _strat, _md = medium_m.params_strategy(
                scene.media, jnp.broadcast_to(med_idx, (n,)))
        else:
            _strat, _md = None, None
        t_big = jnp.full((n,), 1e7)
        hs_, t_samp, _, _ = sample_distance_homogeneous(
            jnp.broadcast_to(sigma_a, (n, 3)), jnp.broadcast_to(sigma_s, (n, 3)),
            jnp.broadcast_to(samp_w, (n,)), t_big, u_d, uc_d,
            strategy=_strat, manual_density=_md,
        )
        want_scatter = hs_  # medium interaction requested by the sampler
        march_dist = jnp.where(want_scatter, t_samp, 1e6)
        n_start = ek.rif_value(rif, s.o)
        # er_f64: run the eikonal ODE core in float64 (the reference compiles
        # its eikonal math double via FLOATDEBUG, fwd.h:174-184) — JAX's
        # promotion rules carry the f64 state through rif/sdf evaluations;
        # the per-event cast back to the f32 path state is one rounding vs
        # the thousands of accumulating steps it protects
        if cfg.er_f64:
            import jax as _jax
            if not _jax.config.read("jax_enable_x64"):
                raise RuntimeError(
                    "cfg.er_f64 requires jax_enable_x64 (set "
                    "JAX_ENABLE_X64=1 or jax.config.update)")
            _erf = jnp.float64
        else:
            _erf = jnp.float32
        p_m, v_m, opt_m, geo_m, exited_m, _ = ek.trace_curved(
            rif, sdf, s.o.astype(_erf), s.v.astype(_erf),
            march_dist.astype(_erf), h, max_march, in_act,
            differentiable=differentiable, kernels=cfg.kernels,
        )
        scattered = in_act & want_scatter & ~exited_m
        exited = in_act & (exited_m | ~want_scatter)
        # boundary refinement for exiting lanes
        p_b, v_b, opt_b, adv_b = ek.refine_boundary(rif, sdf, p_m, v_m, h)
        p_m = jnp.where(exited[..., None], p_b, p_m)
        v_m = jnp.where(exited[..., None], v_b, v_m)
        opt_m = jnp.where(exited, opt_m + opt_b, opt_m)
        geo_m = jnp.where(exited, geo_m + adv_b, geo_m)
        p_m = p_m.astype(jnp.float32)
        v_m = v_m.astype(jnp.float32)
        opt_m = opt_m.astype(jnp.float32)
        geo_m = geo_m.astype(jnp.float32)

        n_end = ek.rif_value(rif, p_m)
        ref_ratio_sq = (n_end / jnp.maximum(n_start, 1e-6)) ** 2
        tr_seg = jnp.exp(-sigma_t[None, :] * geo_m[..., None])
        # estimator weights: strategy pdfs re-evaluated at the CURVED arc
        # length (balance unless cfg.medium_strategies)
        pdf_succ, pdf_fail = medium_m.homog_strategy_pdfs(
            jnp.broadcast_to(sigma_t, (n, 3)), geo_m, _strat, _md)
        w_sc = sigma_s[None, :] * tr_seg / jnp.maximum(
            (pdf_succ * samp_w)[..., None], 1e-12
        )
        w_ex = tr_seg / jnp.maximum(
            (samp_w * pdf_fail + (1.0 - samp_w))[..., None], 1e-12
        )
        seg_w = jnp.where(
            scattered[..., None], w_sc, jnp.where(exited[..., None], w_ex, 1.0)
        ) * jnp.where(in_act[..., None], ref_ratio_sq[..., None], 1.0)
        throughput = s.throughput * seg_w
        plen_med = s.plen + jnp.where(in_act, opt_m, 0.0)

        # --- curved NEE from scatter vertices (BVP) ---
        u2n, smp = rng.next_2d(smp)
        u1n, smp = rng.next_1d(smp)
        dsm = emitter_m.sample_direct(scene, p_m, u2n, u1n)
        # constant/env emitters have no finite connection point for the BVP;
        # their transport is estimated by the escape-hit family instead
        from ..scene.types import EM_CONSTANT
        dsm_kind = smalltab.take(scene.emitters.kind, dsm.emitter)
        nee_in = (scattered & depth_ok & (dsm.pdf > 0)
                  & jnp.any(dsm.value > 0, axis=-1) & (dsm_kind != EM_CONSTANT))
        chord = normalize(dsm.p - p_m)
        # full reference restart machinery (makeDirectConnections,
        # heterogeneousrefractive.cpp:1087-1163): uniform-hemisphere
        # restarts, RR'd failures with 1/rr_weight compensation, Zeltner
        # re-find consistency check and Booth multiplicity compensation —
        # all inside solve_bvp. The per-lane restart RNG is decorrelated
        # from the path sampler by hashing (lane, sample index, bounce).
        seed_bits = rng._hash_u32(
            smp.lane + smp.index * jnp.uint32(0x9E3779B9)
            + smp.seed * jnp.uint32(0xC2B2AE35)
            + s.iters.astype(jnp.uint32) * jnp.uint32(0x85EBCA6B))
        bvp = ek.solve_bvp(
            rif, sdf, p_m.astype(_erf), dsm.p.astype(_erf),
            chord.astype(_erf), h * cfg.er_bvp_hscale,
            max(int(max_march / cfg.er_bvp_hscale), 16), nee_in,
            tol2=cfg.bvp_tol2, differentiable=differentiable,
            rr_weight=cfg.rr_weight, seed_bits=seed_bits,
            max_restarts=cfg.bvp_restarts, kernels=cfg.kernels,
        )
        if cfg.er_f64:
            bvp = jax.tree.map(
                lambda a: a.astype(jnp.float32)
                if jnp.issubdtype(a.dtype, jnp.floating) else a, bvp)
        bvp_ok = bvp.converged
        conn_w = jnp.where(bvp.converged, bvp.weight, 0.0)
        d_in_m = normalize(v_m)
        ph_val = phase_m.eval(media.phase,
                              jnp.broadcast_to(med_idx, (n,)),
                              d_in_m, bvp.dir_to_target)
        tr_conn = jnp.exp(-sigma_t[None, :] * bvp.geo_inside[..., None])
        # radiance compression along the connection: light is outside (n=1)
        nee_ratio = (ek.rif_value(rif, p_m) / 1.0) ** 2
        # convert the emitter's straight-measure value to the curved path:
        # replace the 1/d_straight^2 falloff by 1/geo_len^2
        d_straight = jnp.maximum(dsm.dist, 1e-6)
        falloff_fix = (d_straight * d_straight) / jnp.maximum(
            bvp.geo_total * bvp.geo_total, 1e-9
        )
        contrib = (
            throughput * ph_val[..., None] * dsm.value * tr_conn
            * (nee_ratio * falloff_fix * conn_w / jnp.maximum(dsm.pdf, 1e-12))[..., None]
        )
        sink_new = common.add_contribution(
            sink_new, cfg, contrib, plen_med + bvp.opt_len, s.depth + 1,
            nee_in & bvp_ok,
        )

        # --- phase sampling at scatter vertices ---
        u2p, smp = rng.next_2d(smp)
        ps = phase_m.sample(media.phase, jnp.broadcast_to(med_idx, (n,)),
                            d_in_m, u2p)
        v_scatter = ps.wo * n_end[..., None]

        # --- boundary exit: Fresnel / TIR via the h-dielectric ---
        N_out = normalize(ek.sdf_gradient(sdf, p_m))
        cos_exit = dot(normalize(v_m), N_out)
        F_exit, _ = fresnel_dielectric(-cos_exit, n_end)  # exiting: signed
        u_fx, smp = rng.next_1d(smp)
        exit_reflect = u_fx < F_exit
        v_exit_refr, tir_x = ek.boundary_velocity(v_m, N_out, n_end, jnp.ones((n,)))
        exit_reflect = exit_reflect | tir_x
        v_exit_refl = v_m - 2.0 * dot(v_m, N_out, keepdims=True) * N_out

        # ================= merge state ================
        new_o = s.o
        new_v = s.v
        new_inside = s.inside
        new_delta = s.last_delta
        new_pdf = s.last_pdf

        # outside, ordinary surface bounce
        cont_srf = srf & jnp.any(bs.weight > 0, axis=-1)
        new_o = jnp.where(cont_srf[..., None], hit.p + wo_srf * eps, new_o)
        new_v = jnp.where(cont_srf[..., None], wo_srf, new_v)
        new_delta = jnp.where(cont_srf, bs.delta, new_delta)
        new_pdf = jnp.where(cont_srf, bs.pdf, new_pdf)
        throughput = jnp.where(cont_srf[..., None], throughput * bs.weight, throughput)

        # outside, boundary: reflect off it
        refl_b = entering & do_reflect
        new_o = jnp.where(refl_b[..., None], hit.p + v_refl * eps, new_o)
        new_v = jnp.where(refl_b[..., None], v_refl, new_v)
        new_delta = jnp.where(refl_b, True, new_delta)
        # outside, boundary: enter the medium (scaled velocity, marches next)
        enter_b = entering & ~do_reflect
        new_o = jnp.where(enter_b[..., None], hit.p - hit.ng * (eps * 0.5)
                          + normalize(v_refr) * eps, new_o)
        new_v = jnp.where(enter_b[..., None], v_refr, new_v)
        new_inside = jnp.where(enter_b, True, new_inside)
        new_delta = jnp.where(enter_b, True, new_delta)

        # inside: scattered -> continue curved
        new_o = jnp.where(scattered[..., None], p_m, new_o)
        new_v = jnp.where(scattered[..., None], v_scatter, new_v)
        new_delta = jnp.where(scattered, False, new_delta)
        new_pdf = jnp.where(scattered, ps.pdf, new_pdf)

        # inside: exit through / reflect at the boundary
        stay = exited & exit_reflect
        leave = exited & ~exit_reflect
        inward = p_m - N_out * (2.0 * eps)
        new_o = jnp.where(stay[..., None], inward, new_o)
        new_v = jnp.where(stay[..., None], v_exit_refl, new_v)
        new_delta = jnp.where(stay, True, new_delta)
        d_leave = normalize(v_exit_refr)
        new_o = jnp.where(leave[..., None], p_m + N_out * eps + d_leave * eps, new_o)
        new_v = jnp.where(leave[..., None], d_leave, new_v)
        new_inside = jnp.where(leave, False, new_inside)
        new_delta = jnp.where(leave, True, new_delta)

        plen_new = jnp.where(in_act, plen_med, jnp.where(out_act, plen_srf, s.plen))

        moved = cont_srf | refl_b | enter_b | scattered | stay | leave
        active = s.active & moved & depth_ok
        dead = jnp.all(throughput <= 0, axis=-1)
        active = active & ~dead

        u_rr, smp = rng.next_1d(smp)
        tp_rr, survive = common.russian_roulette(
            throughput, jnp.ones((n,)), u_rr, s.depth, cfg
        )
        throughput = tp_rr
        active = active & survive

        inc = (cont_srf | scattered | enter_b | leave) & active
        # NaN firewall: deactivate lanes whose state went non-finite and
        # scrub the stored values so they cannot poison later iterations
        # (forward or backward)
        finite = (
            jnp.all(jnp.isfinite(new_o), axis=-1)
            & jnp.all(jnp.isfinite(new_v), axis=-1)
            & jnp.all(jnp.isfinite(throughput), axis=-1)
        )
        active = active & finite
        new_o = jnp.nan_to_num(new_o, posinf=0.0, neginf=0.0)
        new_v = jnp.nan_to_num(new_v, nan=1.0, posinf=1.0, neginf=-1.0)
        throughput = jnp.nan_to_num(throughput, posinf=0.0, neginf=0.0)
        new_from_medium = jnp.where(
            scattered, True, jnp.where(cont_srf, False, s.from_medium))
        return _State(
            o=jnp.where(active[..., None], new_o, s.o),
            v=jnp.where(active[..., None], new_v, s.v),
            inside=jnp.where(active, new_inside, s.inside),
            throughput=jnp.where(active[..., None], throughput, s.throughput),
            sink=sink_new,
            active=active,
            depth=jnp.where(inc, s.depth + 1, s.depth),
            plen=jnp.where(active, plen_new, s.plen),
            last_pdf=jnp.where(active, new_pdf, s.last_pdf),
            last_delta=jnp.where(active, new_delta, s.last_delta),
            from_medium=jnp.where(active, new_from_medium, s.from_medium),
            iters=s.iters + 1,
            sampler=smp,
        )

    return state, cond, body, max_iters


# ---------------------------------------------------------------------------
# Sensor-side curved connections: the light image through the refractive body
# (makeSensorDirectConnections, heterogeneousrefractive.cpp:960-992 +
# edge.cpp:535-543). Light particles enter the medium, scatter along curved
# paths, and every in-medium vertex solves the BVP TO THE CAMERA — the
# integrator's sensitivity machinery already handles the single boundary
# refraction + straight extrapolation to the closest point of approach
# (integrate_with_sensitivities, eikonal.py), so the same solve_bvp serves
# camera-side and sensor-side connections.
# ---------------------------------------------------------------------------
def trace_er_particles(scene: Scene, cfg: RenderConfig, n_particles: int,
                       seed, pass_idx):
    """One wavefront of light particles through the refractive medium;
    returns the (H*W, 3) splat sum (divide by total particles for the
    light-image estimate)."""
    from ..models import sensor as sensor_m
    from ..models import medium as medium_m
    from ..integrators import ptracer as ptracer_m

    H, W = cfg.height, cfg.width
    n = n_particles
    eps = common.scene_epsilon(scene)
    rif = ek.rif_from_media(scene.media, cfg.rif_kinds)
    sdf = ek.sdf_from_media(scene.media)
    _, sigma_a, sigma_s, samp_w, med_idx = _refractive_params(scene)
    sigma_t = sigma_a + sigma_s
    h = cfg.er_stepsize
    max_march = cfg.er_maxsteps
    cam_p = scene.sensor.to_world[:3, 3]
    media = scene.media

    lane = jnp.arange(n, dtype=jnp.uint32)
    smp = rng.make_sampler(jnp.asarray(seed, jnp.uint32) ^ jnp.uint32(0xE51),
                           lane, pass_idx)
    o, d, tp, _med, _ne, _ia, smp, _, _ = ptracer_m._sample_emitter_ray(scene, smp)
    film = jnp.zeros((H * W, 3), jnp.float32)

    inside = jnp.zeros((n,), bool)
    v = d
    active = jnp.any(tp > 0, axis=-1)
    max_iters = 2 * cfg.max_depth + 6

    def body(carry, _):
        o, v, tp, inside, active, film, smp = carry

        # ---- outside: straight flight to the refractive boundary ----
        d_out = normalize(v)
        hit = isect.intersect(scene.geo, o, d_out, jnp.full((n,), eps),
                              jnp.full((n,), isect.INF))
        ns_ = scene.shapes.bsdf.shape[0]
        sid = jnp.clip(hit.shape_id, 0, ns_ - 1)
        ok_s = hit.shape_id >= 0
        m_in = jnp.where(ok_s, smalltab.take(scene.shapes.interior, sid), -1)
        is_ref_b = ok_s & (m_in == med_idx)
        out_act = active & ~inside
        entering = out_act & hit.valid & is_ref_b
        dead_out = out_act & ~entering   # missed the body: particle done

        n_at = ek.rif_value(rif, hit.p)
        cos_i = dot(-d_out, hit.ng)
        F, _c = fresnel_dielectric(cos_i, n_at)
        u_f, smp = rng.next_1d(smp)
        refl = u_f < F
        N_in = jnp.where(cos_i[..., None] > 0, hit.ng, -hit.ng)
        v_refr, _tir = ek.boundary_velocity(d_out, N_in, jnp.ones((n,)), n_at)

        # ---- inside: curved free flight ----
        in_act = active & inside
        u_d, smp = rng.next_1d(smp)
        from ..models import medium as medium_m
        from ..models.medium import sample_distance_homogeneous
        t_big = jnp.full((n,), 1e7)
        uc_d, smp = rng.next_1d(smp)
        if cfg.medium_strategies:
            _strat, _md = medium_m.params_strategy(
                scene.media, jnp.broadcast_to(med_idx, (n,)))
        else:
            _strat, _md = None, None
        hs_, t_samp, _, _ = sample_distance_homogeneous(
            jnp.broadcast_to(sigma_a, (n, 3)),
            jnp.broadcast_to(sigma_s, (n, 3)),
            jnp.broadcast_to(samp_w, (n,)), t_big, u_d, uc_d,
            strategy=_strat, manual_density=_md)
        march = jnp.where(hs_, t_samp, 1e6)
        p_m, v_m, opt_m, geo_m, exited_m, _ = ek.trace_curved(
            rif, sdf, o, v, march, h, max_march, in_act,
            kernels=cfg.kernels)
        scattered = in_act & hs_ & ~exited_m
        exited = in_act & (exited_m | ~hs_)
        p_b, v_b, opt_b, adv_b = ek.refine_boundary(rif, sdf, p_m, v_m, h)
        p_m = jnp.where(exited[..., None], p_b, p_m)
        v_m = jnp.where(exited[..., None], v_b, v_m)
        geo_m = jnp.where(exited, geo_m + adv_b, geo_m)
        tr_seg = jnp.exp(-sigma_t[None, :] * geo_m[..., None])
        pdf_succ, pdf_fail = medium_m.homog_strategy_pdfs(
            jnp.broadcast_to(sigma_t, (n, 3)), geo_m, _strat, _md)
        w_sc = sigma_s[None, :] * tr_seg / jnp.maximum(
            (pdf_succ * samp_w)[..., None], 1e-12)
        w_ex = tr_seg / jnp.maximum(
            (samp_w * pdf_fail + (1.0 - samp_w))[..., None], 1e-12)
        tp_in = tp * jnp.where(scattered[..., None], w_sc,
                               jnp.where(exited[..., None], w_ex, 1.0))

        # ---- sensor-side curved connection from scatter vertices ----
        chord = normalize(jnp.broadcast_to(cam_p, (n, 3)) - p_m)
        seed_bits = rng._hash_u32(lane + smp.index * jnp.uint32(0x9E3779B9))
        bvp = ek.solve_bvp(
            rif, sdf, p_m, jnp.broadcast_to(cam_p, (n, 3)), chord,
            h * cfg.er_bvp_hscale,
            max(int(max_march / cfg.er_bvp_hscale), 16),
            scattered, tol2=cfg.bvp_tol2,
            rr_weight=cfg.rr_weight, seed_bits=seed_bits,
            max_restarts=cfg.bvp_restarts, kernels=cfg.kernels)
        ok_c = scattered & bvp.converged
        d_in_m = normalize(v_m)
        ph_val = phase_m.eval(media.phase, jnp.broadcast_to(med_idx, (n,)),
                              d_in_m, bvp.dir_to_target)
        tr_conn = jnp.exp(-sigma_t[None, :] * bvp.geo_inside[..., None])
        # radiance compression entering->exiting + boundary Fresnel pass
        n_here = ek.rif_value(rif, p_m)
        ref_ratio = (1.0 / jnp.maximum(n_here, 1e-6)) ** 2
        # arrival direction at the camera: -rev_dir points p->cam along the
        # final straight segment; pick the pixel looking back along it
        d_arr = -bvp.rev_dir
        fs = sensor_m.project(scene.sensor,
                              jnp.broadcast_to(cam_p, (n, 3)) - d_arr, W, H)
        ok_c = ok_c & fs.valid
        val = (tp_in * ph_val[..., None] * tr_conn
               * (ref_ratio * bvp.weight
                  * fs.inv_pixel_omega
                  / jnp.maximum(bvp.geo_total ** 2, 1e-9))[..., None])
        val = jnp.where((ok_c & jnp.all(jnp.isfinite(val), -1))[..., None],
                        val, 0.0)
        px = jnp.clip(fs.px.astype(jnp.int32), 0, W - 1)
        py = jnp.clip(fs.py.astype(jnp.int32), 0, H - 1)
        film = film.at[py * W + px].add(val)

        # ---- phase sampling to continue in-medium walk ----
        u2p, smp = rng.next_2d(smp)
        ps = phase_m.sample(media.phase, jnp.broadcast_to(med_idx, (n,)),
                            d_in_m, u2p)
        n_end = ek.rif_value(rif, p_m)
        v_scat = ps.wo * n_end[..., None]

        # ---- state merge ----
        new_o = jnp.where(entering[..., None] & ~refl[..., None],
                          hit.p - hit.ng * (eps * 0.5)
                          + normalize(v_refr) * eps, o)
        new_v = jnp.where(entering[..., None] & ~refl[..., None], v_refr, v)
        new_inside = jnp.where(entering & ~refl, True, inside)
        new_o = jnp.where(scattered[..., None], p_m, new_o)
        new_v = jnp.where(scattered[..., None], v_scat, new_v)
        tp2 = jnp.where(in_act[..., None], tp_in, tp)
        # exiting particles terminate (their outside continuation carries
        # negligible light-image mass and is served by the plain ptracer)
        new_active = active & ~dead_out & ~exited & ~(entering & refl)
        finite = jnp.all(jnp.isfinite(new_o), -1) & \
            jnp.all(jnp.isfinite(new_v), -1) & jnp.all(jnp.isfinite(tp2), -1)
        new_active = new_active & finite
        return (jnp.nan_to_num(new_o), jnp.nan_to_num(new_v, nan=1.0),
                jnp.nan_to_num(tp2), new_inside, new_active, film, smp), None

    carry = (o, v, tp, inside, active, film, smp)
    carry, _ = jax.lax.scan(body, carry, None, length=max_iters)
    return carry[5]


def render_er_light_image(scene: Scene, cfg: RenderConfig, seed: int = 0,
                          n_passes: int = 2):
    """Light image (t=1 family) through the refractive medium."""
    import functools

    H, W = cfg.height, cfg.width
    n_per = H * W

    @functools.partial(jax.jit, static_argnames=("cfg", "np_"))
    def one(scene, film, cfg, np_, seed, pidx):
        return film + trace_er_particles(scene, cfg, np_, seed, pidx)

    film = jnp.zeros((H * W, 3), jnp.float32)
    for i in range(n_passes):
        film = one(scene, film, cfg, n_per, jnp.uint32(seed), jnp.uint32(i))
    return (film / (n_passes * n_per)).reshape(H, W, 3)
