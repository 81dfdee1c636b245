"""Persistent-wavefront volumetric path tracer (forward rendering engine).

Array-program redesign of the hot render loop. The previous engine
(integrators/volpath.py) nests batch-synchronous `lax.while_loop`s: per
bounce it runs a Woodcock loop, then a shadow-tracking loop, each at full
wavefront width until the *slowest* lane converges — measured occupancy on
the heterogeneous benchmark is a few percent, because every inner iteration
pays a full-width density gather for mostly-idle lanes.

This engine flattens everything into ONE loop over "super-iterations":

  super-iteration = 1 event pass + T tracking iterations

* The **event pass** (full width, masked) performs all per-bounce logic for
  lanes whose free-flight/shadow tracking has resolved: emitter-hit/env
  contributions, next-event estimation setup (emitter or collimated-beam
  family), phase/BSDF direction sampling, Russian roulette, null-boundary
  medium transitions, ray-segment intersection, and **path regeneration** —
  a finished lane immediately starts its pixel's next sample, keeping
  occupancy high for the whole pass instead of decaying with the wavefront
  tail (the reference gets the same effect from its pull scheduler,
  sched.cpp:427: idle workers immediately acquire new blocks).

* Each **tracking iteration** advances every lane's pending heterogeneous
  work by exactly one majorant jump: one fused density tap (bricked trilinear
  gather) serves EITHER the lane's extension free-flight sampling (Woodcock,
  heterogeneous.cpp:420) OR its shadow-ray ratio-tracking transmittance.
  Lanes in vacuum/homogeneous media resolve analytically in the event pass
  and never enter the tracking loop.

Lane <-> pixel mapping is static (lane i serves pixel i for all its samples),
so film accumulation is a per-lane add — no scatter. Box filter semantics
(the per-sample jitter still moves the sub-pixel position, matching the
reference's `box` rfilter).

Feature scope: steady-state volpath (vacuum/homogeneous/heterogeneous media,
all BSDF/phase/emitter models, MIS, attenuated NEE across null boundaries,
collimated-beam NEE). Transient/ToF decompositions and the eikonal medium
render through the loop engine (integrators/volpath.py, volpath_er.py).
"""
from __future__ import annotations

import os
from typing import NamedTuple

import jax
import jax.numpy as jnp

# temporary perf-ablation switches (scripts/profile_event_ablate.py); renders
# are WRONG with any of these set — timing only
_ABL = set(os.environ.get("WF_ABLATE", "").split(","))

from ..core import rng
from ..core.math import Frame, dot, mis_weight_power
from ..models import bsdf as bsdf_m
from ..models import emitter as emitter_m
from ..models import medium as medium_m
from ..models import phase as phase_m
from ..models import sensor as sensor_m
from ..scene import intersect as isect
from ..scene.types import (
    MED_HETEROGENEOUS,
    MED_HOMOGENEOUS,
    RenderConfig,
    Scene,
)
from . import common
from .volpath import (
    _is_null_surface,
    _shape_tables,
    beam_transmittance,
    build_beam_tau,
    get_beam,
    sample_beam_point,
)


class WFState(NamedTuple):
    # path / extension segment
    o: jnp.ndarray            # (n,3) current ray origin
    d: jnp.ndarray            # (n,3) current ray direction
    t_far: jnp.ndarray        # (n,) segment end (surface hit or scene exit)
    hit_valid: jnp.ndarray    # (n,) segment ends on a surface
    hit_shape: jnp.ndarray    # (n,) int32
    hit_ng: jnp.ndarray       # (n,3)
    throughput: jnp.ndarray   # (n,3)
    medium: jnp.ndarray       # (n,) int32 current medium (-1 vacuum)
    depth: jnp.ndarray        # (n,) int32
    eta_scale: jnp.ndarray    # (n,)
    last_pdf: jnp.ndarray     # (n,)
    last_delta: jnp.ndarray   # (n,) bool
    sample_idx: jnp.ndarray   # (n,) int32 sample number in this pass (-1 = none yet)
    path_alive: jnp.ndarray   # (n,) bool
    ext_need_isect: jnp.ndarray  # (n,) bool
    ext_tracking: jnp.ndarray    # (n,) bool heterogeneous tracking in flight
    ext_done: jnp.ndarray        # (n,) bool outcome ready
    ext_scat: jnp.ndarray        # (n,) bool outcome: medium scatter
    ext_t: jnp.ndarray           # (n,) tracking position / sampled distance
    ext_w: jnp.ndarray           # (n,3) free-flight estimator weight
    # shadow ray (one slot; NEE family chosen per bounce)
    sh_active: jnp.ndarray    # (n,) bool
    sh_need_isect: jnp.ndarray  # (n,) bool
    sh_o: jnp.ndarray         # (n,3)
    sh_d: jnp.ndarray         # (n,3)
    sh_remaining: jnp.ndarray  # (n,) distance to light still to cover
    sh_seg: jnp.ndarray       # (n,) current subsegment length
    sh_t: jnp.ndarray         # (n,) tracking position in subsegment
    sh_med: jnp.ndarray       # (n,) int32
    sh_tr: jnp.ndarray        # (n,3) running transmittance
    sh_val: jnp.ndarray       # (n,3) contribution if unoccluded
    sh_hit_null: jnp.ndarray  # (n,) subsegment ends at null crossing
    sh_cross_p: jnp.ndarray   # (n,3) crossing point
    sh_cross_med: jnp.ndarray  # (n,) int32 medium beyond the crossing
    # outputs / misc
    pix: jnp.ndarray          # (n,) int32 pixel served by the current sample
    sample_open: jnp.ndarray  # (n,) bool a sample is in flight / unflushed
    L: jnp.ndarray            # (n,3) current-sample radiance accumulator
    pend: jnp.ndarray         # (E,n,3) epoch ring of flushed radiance: the
    #   lane->pixel map is a static rotation per SAMPLE EPOCH, so epoch j's
    #   buffer folds into the film with ONE roll once every lane passed j.
    #   The ring (E=4) replaces the previous (sppc,n,3) slots array whose
    #   32 masked slot-writes per event pass dominated state traffic;
    #   in-loop scatters to the film would serialize catastrophically.
    film: jnp.ndarray         # (n,3) pixel-space film accumulator (drained)
    drained: jnp.ndarray      # () int32 epochs folded into film so far
    tap_ctr: jnp.ndarray      # (n,) uint32 tracking-RNG counter
    sampler: object           # event-pass Sampler
    n_segments: jnp.ndarray   # () uint32 ray segments traced (ext + shadow)
    n_taps: jnp.ndarray       # () uint32 density taps
    it: jnp.ndarray           # () int32 super-iteration counter
    pending: jnp.ndarray      # () bool any work left (outer-loop cond reads
    #   this precomputed scalar instead of reducing 6 lane arrays per iter)
    track_work: jnp.ndarray   # () bool any tracking work pending (inner
    #   tracking-loop cond: scalar carried by the passes, not recomputed)


def _tap_uniform(seed, lane, ctr):
    """Cheap decorrelated per-tap uniform (counter-based)."""
    bits = rng._hash_u32(
        (lane ^ jnp.uint32(0x9E3779B9)) + ctr * jnp.uint32(0x85EBCA6B) + seed
    )
    return rng._u32_to_float(bits)


def _medium_params(scene, idx):
    return medium_m.params(scene.media, idx)


def _is_het(scene, idx):
    kind = _medium_params(scene, idx)[0]
    return kind == MED_HETEROGENEOUS


def make_engine(scene: Scene, cfg: RenderConfig, sppc: int, seed,
                pass_idx, n_lanes: int | None = None,
                has_direct: bool = True, any_het: bool = True,
                row0=None, full_height: int | None = None):
    """Build the wavefront engine pieces for one render pass.

    Returns (init_state, event_pass, tracking_iter, cond, finalize) so the
    driver (render_wavefront) or profiling/test harnesses can step the
    engine manually.

    row0/full_height: optional global row offset + full image height when
    this engine renders a row-block shard of a larger image (shard_map over
    the device mesh, parallel/driver.py) — camera rays and sampler keys use
    GLOBAL pixel coordinates so the sharded render estimates the same
    integral as the single-device one."""
    H, W = cfg.height, cfg.width
    npix = H * W
    row0 = jnp.asarray(0 if row0 is None else row0, jnp.int32)
    H_full = full_height or H
    # film ring depth: small caps pending-buffer traffic but imposes a
    # min-completed barrier (measured: E=4 tripled super-iterations on the
    # heterogeneous bench — fast lanes stall on the slowest epoch); default
    # 0 = sppc (no barrier)
    _EPOCH_RING = cfg.wf_epoch_ring if cfg.wf_epoch_ring > 0 else sppc
    _EPOCH_RING = min(_EPOCH_RING, sppc)
    pact = cfg.phase_kinds or None
    n = npix if n_lanes is None else n_lanes
    assert n == npix, "v1: one lane per pixel"
    eps = common.scene_epsilon(scene)
    media = scene.media
    bricks = medium_m.DensityBricks(media, dtype=jnp.bfloat16)
    has_beam = cfg.has_beam
    beam = get_beam(scene) if has_beam else None
    beam_tau = build_beam_tau(scene, beam, bricks) if has_beam else None
    # tracking iterations per event pass: heterogeneous scenes need several
    # majorant jumps per bounce; surface/homogeneous scenes resolve in the
    # event pass itself
    T_TRACK = cfg.wf_track_iters if any_het else 0
    act = cfg.bsdf_kinds or None

    lane = jnp.arange(n, dtype=jnp.uint32)
    seed = jnp.asarray(seed, jnp.uint32)
    pass_idx = jnp.asarray(pass_idx, jnp.uint32)
    # decorrelate the tracking-tap streams across passes AND across mesh
    # shards (which arrive here as distinct pass indices / row offsets):
    # without this every pass reuses the same per-lane tap-uniform sequence
    # (tap_ctr restarts at 0 each pass). The PATH sampler keeps the bare
    # seed — its keys are (pixel, global sample index), already
    # pass-invariant by construction (replay/checkpoint identity).
    tap_seed = seed ^ (pass_idx * jnp.uint32(0x9E3779B9)
                       + jnp.uint32(0x7F4A7C15)
                       + row0.astype(jnp.uint32) * jnp.uint32(0x85EBCA6B))
    f0 = jnp.zeros((n,), jnp.float32)
    f3 = jnp.zeros((n, 3), jnp.float32)
    b0 = jnp.zeros((n,), bool)
    i0 = jnp.zeros((n,), jnp.int32)

    mode = rng.MODES.get(cfg.sampler, rng.INDEPENDENT)
    sampler = rng.Sampler(lane=lane, index=jnp.zeros((n,), jnp.uint32),
                          dim=jnp.zeros((n,), jnp.uint32), seed=seed, mode=mode,
                          n_samples=cfg.spp)

    st = WFState(
        o=f3, d=jnp.concatenate([f3[:, :2], jnp.ones((n, 1))], axis=-1),
        t_far=f0, hit_valid=b0, hit_shape=i0 - 1, hit_ng=f3,
        throughput=f3, medium=i0 - 1, depth=i0, eta_scale=f0 + 1.0,
        last_pdf=f0, last_delta=~b0, sample_idx=i0 - 1, path_alive=b0,
        ext_need_isect=b0, ext_tracking=b0, ext_done=b0, ext_scat=b0,
        ext_t=f0, ext_w=f3 + 1.0,
        sh_active=b0, sh_need_isect=b0, sh_o=f3, sh_d=f3,
        sh_remaining=f0, sh_seg=f0, sh_t=f0, sh_med=i0 - 1, sh_tr=f3,
        sh_val=f3, sh_hit_null=b0, sh_cross_p=f3, sh_cross_med=i0 - 1,
        pix=i0, sample_open=b0,
        L=f3, pend=jnp.zeros((_EPOCH_RING, n, 3), jnp.float32),
        film=f3, drained=jnp.zeros((), jnp.int32),
        tap_ctr=jnp.zeros((n,), jnp.uint32), sampler=sampler,
        n_segments=jnp.zeros((), jnp.uint32),
        n_taps=jnp.zeros((), jnp.uint32),
        it=jnp.zeros((), jnp.int32),
        pending=jnp.ones((), bool),
        track_work=jnp.zeros((), bool),
    )

    max_super = sppc * (6 * cfg.max_depth + 16) + 64

    # ------------------------------------------------------------------
    def event_pass(st: WFState, mini: bool = False) -> WFState:
        """Full event pass, or (mini=True) the cheap *transition pass*.

        The transition pass performs only the administrative path events —
        shadow subsegment completion, null-boundary crossings, environment
        escapes, sample flush + regeneration, segment intersection and
        analytic-medium resolution — skipping NEE setup, direction sampling
        and Russian roulette. Lanes whose extension outcome is a scatter or
        a real surface bounce are left untouched for the next full pass.
        This is what lets a volumetric-box sample cost ~1 full pass (the
        scatter) instead of ~5: entering/leaving the bounded medium and the
        final env escape all resolve in transition passes at a fraction of
        the cost (VERDICT r2 'cut super-iterations/sample toward ~2')."""
        smp = st.sampler

        # ---------- stage 1: shadow subsegment completion ----------
        sh_done = st.sh_active & ~st.sh_need_isect & (st.sh_t >= st.sh_seg)
        tr_dead = jnp.max(st.sh_tr, axis=-1) <= 0.0
        # reached the light point
        complete = sh_done & ~st.sh_hit_null
        L = st.L + jnp.where(complete[..., None], st.sh_val * st.sh_tr, 0.0)
        # null crossing: advance to the far side, request re-intersect
        crossing = sh_done & st.sh_hit_null & ~tr_dead
        sh_o = jnp.where(crossing[..., None],
                         st.sh_cross_p + st.sh_d * eps, st.sh_o)
        sh_remaining = jnp.where(
            crossing, st.sh_remaining - st.sh_seg - eps, st.sh_remaining)
        sh_med = jnp.where(crossing, st.sh_cross_med, st.sh_med)
        still = crossing & (sh_remaining > eps)
        sh_need_isect = st.sh_need_isect | still
        sh_active = jnp.where(sh_done, still, st.sh_active)
        sh_active = sh_active & ~(st.sh_active & tr_dead)

        # ---------- stage 2: extension outcome processing ----------
        b_idx, e_idx, m_in, m_ex = _shape_tables(scene, st.hit_shape)
        is_null = _is_null_surface(scene, b_idx)

        proc = st.ext_done & ~sh_active & ~sh_need_isect & st.path_alive
        if mini:
            # transition pass handles only escapes and non-emissive null
            # crossings; scatters/bounces wait for the full pass
            proc = proc & ~st.ext_scat & (
                ~st.hit_valid | (is_null & (e_idx < 0)))
        m_p = st.o + st.ext_t[..., None] * st.d
        tp = st.throughput * jnp.where(proc[..., None], st.ext_w, 1.0)
        scattered = proc & st.ext_scat
        escaped = proc & ~st.ext_scat & ~st.hit_valid
        on_surface = proc & ~st.ext_scat & st.hit_valid

        hit_p = st.o + st.t_far[..., None] * st.d

        # environment
        env = emitter_m.env_radiance(scene, st.d)
        env_pdf = emitter_m.pdf_direct_env(scene, st.d)
        w_env = jnp.where(st.last_delta, 1.0,
                          mis_weight_power(st.last_pdf, env_pdf))
        L = L + jnp.where(escaped[..., None], tp * env * w_env[..., None], 0.0)

        # emitter hit
        if not mini:
            hit_em = on_surface & (e_idx >= 0)
            le = emitter_m.eval_hit(scene, e_idx, st.hit_ng, -st.d)
            lum_pdf = emitter_m.pdf_direct_hit(scene, e_idx, st.o, hit_p,
                                               st.hit_ng)
            w_hit = jnp.where(st.last_delta, 1.0,
                              mis_weight_power(st.last_pdf, lum_pdf))
            hide = cfg.hide_emitters & (st.depth == 1)
            L = L + jnp.where((hit_em & ~hide)[..., None],
                              tp * le * w_hit[..., None], 0.0)

        depth_ok = st.depth < cfg.max_depth
        vtx = jnp.where(scattered[..., None], m_p, hit_p)
        nee_ok = (scattered | (on_surface & ~is_null)) & depth_ok

        if not mini:
            frame = Frame.from_normal(st.hit_ng)
            wi_srf = frame.to_local(-st.d)

            # ---------- NEE setup ----------
            u_nee2, smp = rng.next_2d(smp)
            u_nee1, smp = rng.next_1d(smp)
            u_fam, smp = rng.next_1d(smp)

        new_sh_active = b0
        new_sh_d = st.sh_d
        new_sh_o = st.sh_o
        new_sh_rem = st.sh_remaining
        new_sh_med = st.sh_med
        new_sh_val = st.sh_val

        if mini:
            use_beam = b0
            fam_w = 1.0
        elif has_direct and has_beam:
            use_beam = u_fam < 0.5
            fam_w = 2.0
        elif has_beam:
            use_beam = jnp.ones((n,), bool)
            fam_w = 1.0
        else:
            use_beam = b0
            fam_w = 1.0

        if has_direct and not mini:
            ds = emitter_m.sample_direct(scene, vtx, u_nee2, u_nee1)
            wo_srf = frame.to_local(ds.d)
            f_srf = bsdf_m.eval(scene.bsdfs, b_idx, wi_srf, wo_srf, active=act)
            pdf_srf = bsdf_m.pdf(scene.bsdfs, b_idx, wi_srf, wo_srf, active=act)
            ax_ov = medium_m.orientation_axis(media, st.medium, m_p) \
                if cfg.phase_orient else None
            f_med = phase_m.eval(media.phase, st.medium, st.d, ds.d,
                                 active=pact, axis_override=ax_ov)[..., None]
            pdf_med = f_med[..., 0]
            f_vtx = jnp.where(scattered[..., None], f_med, f_srf)
            pdf_vtx = jnp.where(scattered, pdf_med, pdf_srf)
            w_nee = jnp.where(ds.delta, 1.0, mis_weight_power(ds.pdf, pdf_vtx))
            val = (tp * f_vtx * ds.value
                   * (fam_w * w_nee / jnp.maximum(ds.pdf, 1e-12))[..., None])
            ok = (nee_ok & ~use_beam & (ds.pdf > 0)
                  & jnp.any(f_vtx > 0, axis=-1) & jnp.any(ds.value > 0, axis=-1))
            srf_entering = dot(ds.d, st.hit_ng) < 0
            nee_med = jnp.where(scattered, st.medium,
                                jnp.where(srf_entering, m_in, m_ex))
            new_sh_active = jnp.where(ok, True, new_sh_active)
            sel = ok[..., None]
            new_sh_d = jnp.where(sel, ds.d, new_sh_d)
            new_sh_o = jnp.where(sel, vtx + ds.d * eps, new_sh_o)
            new_sh_rem = jnp.where(ok, ds.dist - 2 * eps, new_sh_rem)
            new_sh_med = jnp.where(ok, nee_med, new_sh_med)
            new_sh_val = jnp.where(sel, val, new_sh_val)

        if has_beam and not mini and "nobeam" not in _ABL:
            u_b, smp = rng.next_1d(smp)
            y_b, s_b, pdf_sb, dist_b, d_yp = sample_beam_point(beam, vtx, u_b)
            bmed = jnp.broadcast_to(beam.medium, (n,))
            kind_b, sa_b, ss_b, _, scale_b = _medium_params(scene, bmed)
            # tr AND density(y) come from the same packed table row (the
            # density is table-interpolated along the beam — the same
            # quadrature resolution the tau itself uses)
            tr_beam, dens_tab = beam_transmittance(beam, beam_tau, s_b,
                                                   with_density=True)
            dens_b = jnp.where(kind_b == MED_HETEROGENEOUS, dens_tab,
                               jnp.ones((n,)))
            sigma_s_y = ss_b * dens_b[..., None]
            rho_y = phase_m.eval(media.phase, bmed,
                                 jnp.broadcast_to(beam.d, (n, 3)), d_yp,
                                 active=pact)
            bval = (beam.power * tr_beam * sigma_s_y
                    * (rho_y / jnp.maximum(pdf_sb * dist_b * dist_b, 1e-12))[..., None])
            f_srf_b = bsdf_m.eval(scene.bsdfs, b_idx, wi_srf,
                                  frame.to_local(-d_yp), active=act)
            f_med_b = phase_m.eval(media.phase, st.medium, st.d, -d_yp, active=pact)[..., None]
            f_b = jnp.where(scattered[..., None], f_med_b, f_srf_b)
            val_b = tp * f_b * bval * fam_w
            ok_b = nee_ok & use_beam & jnp.any(val_b > 0, axis=-1)
            selb = ok_b[..., None]
            new_sh_active = jnp.where(ok_b, True, new_sh_active)
            new_sh_d = jnp.where(selb, d_yp, new_sh_d)
            new_sh_o = jnp.where(selb, y_b + d_yp * eps, new_sh_o)
            new_sh_rem = jnp.where(ok_b, dist_b - 2 * eps, new_sh_rem)
            new_sh_med = jnp.where(ok_b, bmed, new_sh_med)
            new_sh_val = jnp.where(selb, val_b, new_sh_val)

        # commit new shadow state only on proc lanes
        setup = proc & new_sh_active
        sh_active = sh_active | setup
        sh_need_isect = sh_need_isect | setup
        sel = setup[..., None]
        sh_o = jnp.where(sel, new_sh_o, sh_o)
        sh_d = jnp.where(sel, new_sh_d, st.sh_d)
        sh_remaining = jnp.where(setup, new_sh_rem, sh_remaining)
        sh_med = jnp.where(setup, new_sh_med, sh_med)
        sh_val = jnp.where(sel, new_sh_val, st.sh_val)
        sh_tr = jnp.where(sel, 1.0, st.sh_tr)

        # ---------- direction sampling ----------
        if mini:
            # transition lanes are all escapes or null crossings: the ray
            # continues unchanged (exactly the null_cross branch below)
            new_d = st.d
            scatter_w = jnp.ones((n, 3), jnp.float32)
            new_delta = st.last_delta
            new_pdf = st.last_pdf
        else:
            u_dir2, smp = rng.next_2d(smp)
            u_dir1, smp = rng.next_1d(smp)
            if "nodir" in _ABL:
                from ..core import warp as _warp
                wo_i = _warp.square_to_uniform_sphere(u_dir2)
                ps = phase_m.PhaseSample(wo=wo_i, weight=f0 + 1.0,
                                         pdf=f0 + 1.0)
                bs = bsdf_m.BSDFSample(wo=wo_i, weight=f3 + 1.0, pdf=f0 + 1.0,
                                       delta=b0, eta=f0 + 1.0,
                                       null_passthrough=b0)
            else:
                ax_ov2 = medium_m.orientation_axis(media, st.medium, m_p) \
                    if cfg.phase_orient else None
                ps = phase_m.sample(media.phase, st.medium, st.d, u_dir2,
                                    active=pact, axis_override=ax_ov2)
                bs = bsdf_m.sample(scene.bsdfs, b_idx, wi_srf, u_dir2, u_dir1,
                                   active=act)
            wo_world = frame.to_world(bs.wo)
            new_d = jnp.where(scattered[..., None], ps.wo, wo_world)
            scatter_w = jnp.where(scattered[..., None], ps.weight[..., None],
                                  bs.weight)
            new_pdf = jnp.where(scattered, ps.pdf, bs.pdf)
            new_delta = jnp.where(scattered, False, bs.delta)

            null_cross = on_surface & is_null
            new_d = jnp.where(null_cross[..., None], st.d, new_d)
            scatter_w = jnp.where(null_cross[..., None], 1.0, scatter_w)
            new_delta = jnp.where(null_cross, st.last_delta, new_delta)
            new_pdf = jnp.where(null_cross, st.last_pdf, new_pdf)

        cross = on_surface & (
            is_null
            | (jnp.sum(new_d * st.hit_ng, -1) * jnp.sum(-st.d * st.hit_ng, -1) < 0))
        entering = jnp.sum(new_d * st.hit_ng, -1) < 0
        new_medium = jnp.where(cross, jnp.where(entering, m_in, m_ex), st.medium)

        tp2 = tp * scatter_w
        cont = (scattered | on_surface) & depth_ok
        dead = jnp.all(tp2 <= 0, axis=-1)

        if mini:
            # all transition lanes are RR-exempt null crossings
            eta_scale = st.eta_scale
            keep = cont & ~dead
        else:
            eta_scale = st.eta_scale * jnp.where(on_surface, bs.eta, 1.0)
            u_rr, smp = rng.next_1d(smp)
            rr_exempt = null_cross
            tp_rr, survive = common.russian_roulette(tp2, eta_scale, u_rr,
                                                     st.depth, cfg)
            tp2 = jnp.where(rr_exempt[..., None], tp2, tp_rr)
            keep = cont & ~dead & (survive | rr_exempt)

        finite = (jnp.all(jnp.isfinite(vtx), -1) & jnp.all(jnp.isfinite(new_d), -1)
                  & jnp.all(jnp.isfinite(tp2), -1))
        keep = keep & finite
        tp2 = jnp.nan_to_num(tp2, posinf=0.0, neginf=0.0)

        inc_depth = (scattered | (on_surface & ~is_null)) & keep
        new_o = jnp.nan_to_num(vtx) + jnp.nan_to_num(new_d) * eps

        # commit extension state for continuing lanes
        path_alive = jnp.where(proc, keep, st.path_alive)
        o = jnp.where((proc & keep)[..., None], new_o, st.o)
        d = jnp.where((proc & keep)[..., None], jnp.nan_to_num(new_d), st.d)
        throughput = jnp.where(proc[..., None], tp2, st.throughput)
        depth = jnp.where(inc_depth, st.depth + 1, st.depth)
        last_pdf = jnp.where(proc & keep, new_pdf, st.last_pdf)
        last_delta = jnp.where(proc & keep, new_delta, st.last_delta)
        medium = jnp.where(proc & keep, new_medium, st.medium)
        ext_need = proc & keep
        ext_done = jnp.where(proc, False, st.ext_done)

        # ---------- sample flush + regeneration ----------
        # a sample is complete when its path died and no shadow work remains;
        # scatter its accumulated radiance to the film and free the lane
        flush = (st.sample_open & ~path_alive & ~sh_active & ~sh_need_isect
                 & ~st.ext_tracking & ~ext_need)
        pend = st.pend
        if "noslots" in _ABL:
            pend = pend.at[0].add(jnp.where(flush[..., None], L, 0.0))
        else:
            for e in range(_EPOCH_RING):
                pend = pend.at[e].add(jnp.where(
                    (flush & (st.sample_idx % _EPOCH_RING == e))[..., None],
                    L, 0.0))
        L = jnp.where(flush[..., None], 0.0, L)
        sample_open = st.sample_open & ~flush

        # ---------- epoch drain (only when the ring is a real window) ----
        # fold epoch `drained` into the film (one roll) once every lane has
        # completed it. With _EPOCH_RING >= sppc (the default) every epoch
        # has a private slot, no barrier exists, and finalize() does all the
        # rolls — the in-loop drain would be pure overhead (measured +4.8
        # ms/super-iteration from the roll + dynamic slot update).
        if _EPOCH_RING < sppc:
            completed = st.sample_idx + 1 - sample_open.astype(jnp.int32)
            m_done = jnp.min(completed)
            do_drain = st.drained < m_done
            e_cur = st.drained % _EPOCH_RING
            stride_c = jnp.int32(104729 % npix)
            pend_e = jax.lax.dynamic_index_in_dim(pend, e_cur, axis=0,
                                                  keepdims=False)
            shift = (st.drained * stride_c) % jnp.int32(npix)
            film = st.film + jnp.where(do_drain,
                                       jnp.roll(pend_e, shift, axis=0), 0.0)
            pend = jax.lax.dynamic_update_index_in_dim(
                pend, jnp.where(do_drain, 0.0, pend_e), e_cur, axis=0)
            drained = st.drained + do_drain.astype(jnp.int32)
        else:
            film = st.film
            drained = st.drained

        # rotated lane->pixel assignment: lane i serves pixels
        # (i + j*STRIDE) mod npix for sample j — a bijection per sample, so
        # every pixel receives exactly sppc samples, while each lane's work
        # mixes cheap (background) and expensive (medium) pixels. This is the
        # wavefront analogue of the reference's pull scheduler balancing
        # heterogeneous blocks across workers (sched.cpp:427).
        want = (~sample_open) & ~path_alive & (st.sample_idx + 1 < sppc) \
            & ~sh_active & ~sh_need_isect & ~st.ext_tracking \
            & (st.sample_idx + 1 < drained + _EPOCH_RING)  # ring slot free
        new_idx = st.sample_idx + 1
        sample_idx = jnp.where(want, new_idx, st.sample_idx)
        stride = jnp.int32(104729 % npix)
        new_pix = (lane.astype(jnp.int32)
                   + new_idx * stride) % jnp.int32(npix)
        pix = jnp.where(want, new_pix, st.pix)
        sample_open = sample_open | want
        smp_index = pass_idx * jnp.uint32(sppc) + sample_idx.astype(jnp.uint32)
        gpix = pix + row0 * jnp.int32(W)    # global pixel id (sharded rows)
        smp = rng.Sampler(
            lane=jnp.where(want, gpix.astype(jnp.uint32), smp.lane),
            index=jnp.where(want, smp_index, smp.index),
            dim=jnp.where(want, jnp.uint32(0), smp.dim),
            seed=smp.seed, mode=smp.mode, n_samples=smp.n_samples,
        )
        u_jit, smp = rng.next_2d(smp)
        u_lens, smp = rng.next_2d(smp)
        px = (gpix % W).astype(jnp.float32) + u_jit[:, 0]
        py = (gpix // W).astype(jnp.float32) + u_jit[:, 1]
        if "nosensor" in _ABL:
            rays = sensor_m.CameraRays(o=f3, d=jnp.concatenate(
                [f3[:, :2], jnp.ones((n, 1))], axis=-1))
        else:
            rays = sensor_m.sample_rays(
                scene.sensor, px, py, W, H_full, u_lens=u_lens,
                kind_hint=(cfg.sensor_kind if cfg.sensor_kind >= 0 else None))
        selr = want[..., None]
        o = jnp.where(selr, rays.o, o)
        d = jnp.where(selr, rays.d, d)
        throughput = jnp.where(selr, 1.0, throughput)
        medium = jnp.where(want, jnp.broadcast_to(
            scene.camera_medium, (n,)).astype(jnp.int32), medium)
        depth = jnp.where(want, 1, depth)
        eta_scale = jnp.where(want, 1.0, eta_scale)
        last_pdf = jnp.where(want, 0.0, last_pdf)
        last_delta = jnp.where(want, True, last_delta)
        path_alive = path_alive | want
        ext_need = ext_need | want

        # ---------- stage 3: extension intersect + analytic media ----------
        if "noextisect" in _ABL:
            hit = isect.Hit(t=f0 + 2.0, valid=~b0, prim=i0, shape_id=i0,
                            p=o + 2.0 * d, ng=d, uv=jnp.zeros((n, 2)),
                            tex_uv=jnp.zeros((n, 2)))
        else:
            hit = isect.intersect(scene.geo, o, d, jnp.full((n,), eps),
                                  jnp.full((n,), isect.INF))
        _, t_scene = isect.ray_aabb(o, d, scene.aabb_min, scene.aabb_max)
        seg_far = jnp.where(hit.valid, hit.t, jnp.maximum(t_scene, 0.0))
        t_far = jnp.where(ext_need, seg_far, st.t_far)
        hit_valid = jnp.where(ext_need, hit.valid, st.hit_valid)
        hit_shape = jnp.where(ext_need, hit.shape_id, st.hit_shape)
        hit_ng = jnp.where(ext_need[..., None], hit.ng, st.hit_ng)

        kind_m, sa_m, ss_m, sw_m, _ = _medium_params(scene, medium)
        u_hom, smp = rng.next_1d(smp)
        uc_hom, smp = rng.next_1d(smp)
        if cfg.medium_strategies:
            _strat = medium_m.params_strategy(scene.media, medium)
        else:
            _strat = (None, None)
        hs, ht, hw, _ = medium_m.sample_distance_homogeneous(
            sa_m, ss_m, sw_m, t_far, u_hom, uc_hom,
            strategy=_strat[0], manual_density=_strat[1])
        in_hom = ext_need & (kind_m == MED_HOMOGENEOUS)
        in_het = ext_need & (kind_m == MED_HETEROGENEOUS)
        in_vac = ext_need & ~in_hom & ~in_het

        ext_done2 = ext_done | in_hom | in_vac
        ext_scat = jnp.where(in_hom, hs, jnp.where(in_vac, False, st.ext_scat))
        ext_t = jnp.where(in_hom, ht, jnp.where(in_vac, t_far, st.ext_t))
        ext_w = jnp.where(in_hom[..., None], hw,
                          jnp.where(in_vac[..., None], 1.0, st.ext_w))
        ext_tracking = jnp.where(ext_need, in_het, st.ext_tracking)
        ext_t = jnp.where(in_het, 0.0, ext_t)
        ext_w = jnp.where(in_het[..., None], 1.0, ext_w)

        # ---------- stage 4: shadow intersect + analytic subsegments ----------
        shx = sh_need_isect & sh_active
        if "noshisect" in _ABL:
            shit = isect.Hit(t=f0 + 2.0, valid=b0, prim=i0, shape_id=i0,
                             p=sh_o, ng=sh_d, uv=jnp.zeros((n, 2)),
                             tex_uv=jnp.zeros((n, 2)))
        else:
            # the full-width intersect is ~40% of a transition pass; in
            # passes where no lane requested a shadow re-intersect (e.g.
            # in-medium beam NEE never crosses the null wall) skip it with
            # a runtime cond — all consumers of `shit` are masked by shx.
            def _do_shisect(_):
                return isect.intersect(scene.geo, sh_o, sh_d,
                                       jnp.full((n,), eps * 0.5),
                                       jnp.maximum(sh_remaining - eps, 0.0))

            def _no_shisect(_):
                return isect.Hit(t=f0, valid=b0, prim=i0, shape_id=i0 - 1,
                                 p=f3, ng=f3, uv=jnp.zeros((n, 2)),
                                 tex_uv=jnp.zeros((n, 2)))

            shit = jax.lax.cond(jnp.any(shx), _do_shisect, _no_shisect,
                                operand=None)
        sb_idx, _, sm_in, sm_ex = _shape_tables(scene, shit.shape_id)
        s_null = _is_null_surface(scene, sb_idx)
        blocked = shx & shit.valid & ~s_null
        sh_active = sh_active & ~blocked
        hitting = shx & shit.valid & s_null
        sh_seg = jnp.where(shx, jnp.where(shit.valid, shit.t, sh_remaining),
                           st.sh_seg)
        sh_hit_null = jnp.where(shx, hitting, st.sh_hit_null)
        s_enter = dot(sh_d, shit.ng) < 0
        sh_cross_med = jnp.where(hitting, jnp.where(s_enter, sm_in, sm_ex),
                                 st.sh_cross_med)
        sh_cross_p = jnp.where(hitting[..., None], shit.p, st.sh_cross_p)

        skind, ssa, sss, _, _ = _medium_params(scene, sh_med)
        s_hom = shx & sh_active & (skind == MED_HOMOGENEOUS)
        s_het = shx & sh_active & (skind == MED_HETEROGENEOUS)
        s_vac = shx & sh_active & ~s_hom & ~s_het
        tr_h = medium_m.eval_transmittance_homogeneous(ssa, sss, sh_seg)
        sh_tr = jnp.where(s_hom[..., None], sh_tr * tr_h, sh_tr)
        # analytic subsegments are immediately "tracked to completion"
        sh_t = jnp.where(s_hom | s_vac, sh_seg,
                         jnp.where(s_het, 0.0, st.sh_t))
        sh_need_isect = sh_need_isect & ~shx

        # counters (exact in uint32 for any realistic pass)
        n_segments = st.n_segments + jnp.sum(ext_need).astype(jnp.uint32) \
            + jnp.sum(shx).astype(jnp.uint32)

        # precompute the loop-control scalars (single fused reductions here
        # instead of per-cond reductions in the while loops)
        pending = jnp.any(
            path_alive | sh_active | sh_need_isect | ext_tracking | ext_done2
            | sample_open | (sample_idx + 1 < sppc))
        track_work = jnp.any(
            (sh_active & ~sh_need_isect & (sh_t < sh_seg)) | ext_tracking)

        return WFState(
            o=o, d=d, t_far=t_far, hit_valid=hit_valid, hit_shape=hit_shape,
            hit_ng=hit_ng, throughput=throughput, medium=medium, depth=depth,
            eta_scale=eta_scale, last_pdf=last_pdf, last_delta=last_delta,
            sample_idx=sample_idx, path_alive=path_alive,
            ext_need_isect=b0, ext_tracking=ext_tracking, ext_done=ext_done2,
            ext_scat=ext_scat, ext_t=ext_t, ext_w=ext_w,
            sh_active=sh_active, sh_need_isect=sh_need_isect, sh_o=sh_o,
            sh_d=sh_d, sh_remaining=sh_remaining, sh_seg=sh_seg, sh_t=sh_t,
            sh_med=sh_med, sh_tr=sh_tr, sh_val=sh_val,
            sh_hit_null=sh_hit_null, sh_cross_p=sh_cross_p,
            sh_cross_med=sh_cross_med,
            pix=pix, sample_open=sample_open,
            L=L, pend=pend, film=film, drained=drained,
            tap_ctr=st.tap_ctr, sampler=smp,
            n_segments=n_segments, n_taps=st.n_taps,
            it=st.it + (0 if mini else 1),
            pending=pending, track_work=track_work,
        )

    macro = medium_m.MacroMajorant(media, m=cfg.wf_dda) \
        if (cfg.wf_dda > 0 and any_het) else None

    # ------------------------------------------------------------------
    def tracking_iter(st: WFState, K: int = 1, compact: int = 0) -> WFState:
        if compact > 0:
            return tracking_ladder(st)
        if macro is not None:
            return tracking_dda(st, K)
        return tracking_full(st, K)

    def tracking_full(st: WFState, K: int = 1) -> WFState:
        """K majorant jumps per lane in ONE pass: shadow ratio-tracking has
        priority, otherwise extension Woodcock.

        Key structural fact: Woodcock / ratio-tracking jump POSITIONS are
        independent of the density values (t_{k+1} = t_k - log(u)/majorant
        regardless of collision outcomes), so the K density taps can all be
        gathered up-front and the K accept/terminate decisions resolved as
        register-level where-chains — the per-pass overhead (state r/w,
        kernel dispatch, loop cond) amortizes over K taps instead of being
        paid per tap. Taps past a lane's termination are masked (they were
        full-width-wasted before anyway)."""
        do_sh = st.sh_active & ~st.sh_need_isect & (st.sh_t < st.sh_seg)
        do_ext = ~do_sh & st.ext_tracking
        any_work = do_sh | do_ext

        med = jnp.where(do_sh, st.sh_med, st.medium)
        kind, sa, ss, _, scale = _medium_params(scene, med)
        st_color = sa + ss
        st_mean = jnp.mean(st_color, axis=-1)
        majorant = jax.lax.stop_gradient(jnp.maximum(
            media.majorant * jnp.max(st_color, axis=-1), 1e-6))

        t_cur = jnp.where(do_sh, st.sh_t, st.ext_t)
        o_cur = jnp.where(do_sh[..., None], st.sh_o, st.o)
        d_cur = jnp.where(do_sh[..., None], st.sh_d, st.d)
        t_lim = jnp.where(do_sh, st.sh_seg, st.t_far)

        # --- precompute the K jump positions + their densities ---
        ts = []
        t_k = t_cur
        for k in range(K):
            u1 = _tap_uniform(tap_seed, lane, st.tap_ctr + jnp.uint32(2 * k))
            t_k = t_k - jnp.log1p(-u1) / majorant
            ts.append(t_k)
        if K == 1:
            dens_all = bricks.lookup(o_cur + ts[0][..., None] * d_cur)[None]
        else:
            # ONE (K*n)-row gather instead of K kernels
            p_all = (o_cur[None, :, :]
                     + jnp.stack(ts)[:, :, None] * d_cur[None, :, :])
            dens_all = bricks.lookup(p_all.reshape(K * n, 3)).reshape(K, n)
        dens_k = [dens_all[k] * scale for k in range(K)]

        # --- resolve K decisions sequentially (registers only) ---
        ext_w = st.ext_w
        sh_tr = st.sh_tr
        ext_t = st.ext_t
        sh_t = st.sh_t
        ext_live = do_ext          # still jumping this pass
        sh_live = do_sh
        resolved_hit = jnp.zeros((n,), bool)
        taps_used = jnp.zeros((n,), jnp.uint32)
        w_real = ss / jnp.maximum(st_mean, 1e-12)[..., None]
        for k in range(K):
            t_new = ts[k]
            dens = dens_k[k]
            active_k = ext_live | sh_live
            taps_used = taps_used + active_k.astype(jnp.uint32)
            # extension Woodcock
            escaped = t_new >= t_lim
            p_real = dens * st_mean / majorant
            u2 = _tap_uniform(tap_seed, lane, st.tap_ctr + jnp.uint32(2 * k + 1))
            real = u2 < p_real
            hit_k = ext_live & ~escaped & real
            null_k = ext_live & ~escaped & ~real
            factor = 1.0 - dens[..., None] * st_color / majorant[..., None]
            w_null = factor / jnp.maximum(1.0 - p_real, 1e-12)[..., None]
            ext_w = jnp.where(hit_k[..., None], ext_w * w_real, ext_w)
            ext_w = jnp.where(null_k[..., None], ext_w * w_null, ext_w)
            ext_t = jnp.where(ext_live, jnp.minimum(t_new, t_lim), ext_t)
            resolved_hit = resolved_hit | hit_k
            ext_live = ext_live & ~escaped & ~real
            # shadow ratio tracking
            sh_esc = t_new >= t_lim
            upd = sh_live & ~sh_esc
            sh_tr = jnp.where(upd[..., None], sh_tr * factor, sh_tr)
            sh_t = jnp.where(sh_live,
                             jnp.where(sh_esc, t_lim, t_new), sh_t)
            sh_live = sh_live & ~sh_esc

        tap_ctr = st.tap_ctr + jnp.uint32(2 * K) * any_work.astype(jnp.uint32)
        ext_resolved = do_ext & ~ext_live
        ext_tracking = st.ext_tracking & ~ext_resolved
        ext_done = st.ext_done | ext_resolved
        ext_scat = jnp.where(ext_resolved, resolved_hit, st.ext_scat)

        n_taps = st.n_taps + jnp.sum(taps_used)
        # remaining work AFTER this pass (scalar for the loop cond)
        track_work = jnp.any(
            (st.sh_active & ~st.sh_need_isect & (sh_t < st.sh_seg))
            | ext_tracking)

        return st._replace(
            ext_tracking=ext_tracking, ext_done=ext_done, ext_scat=ext_scat,
            ext_t=ext_t, ext_w=ext_w, sh_tr=jnp.maximum(sh_tr, 0.0),
            sh_t=sh_t, tap_ctr=tap_ctr, n_taps=n_taps,
            track_work=track_work,
        )

    # ------------------------------------------------------------------
    def tracking_dda(st: WFState, K: int) -> WFState:
        """K tracking slots with a LOCAL (macro-cell) majorant.

        Regular tracking with a spatially varying majorant: within a macro
        cell of majorant m_c the jump is Exp(m_c); a jump that crosses the
        cell-exit plane restarts at the boundary with the next cell's
        majorant (memoryless — no weight), so low-density regions are
        crossed in a few tap-free hops instead of many rejected taps. Each
        slot spends up to H hop draws + one tentative collision; the K
        tentative positions (density-independent, like the global-majorant
        case) feed ONE batched brick gather, and accept/terminate decisions
        resolve in registers. Reference context: heterogeneous.cpp:420
        tracks against the single global maximum; the macro grid is this framework's
        refinement (see medium_m.MacroMajorant)."""
        H = cfg.wf_dda_hops
        do_sh = st.sh_active & ~st.sh_need_isect & (st.sh_t < st.sh_seg)
        do_ext = ~do_sh & st.ext_tracking
        any_work = do_sh | do_ext

        med = jnp.where(do_sh, st.sh_med, st.medium)
        kind, sa, ss, _, scale = _medium_params(scene, med)
        st_color = sa + ss
        st_mean = jnp.mean(st_color, axis=-1)
        st_max = jnp.max(st_color, axis=-1)

        t_cur = jnp.where(do_sh, st.sh_t, st.ext_t)
        o_cur = jnp.where(do_sh[..., None], st.sh_o, st.o)
        d_cur = jnp.where(do_sh[..., None], st.sh_d, st.d)
        t_lim = jnp.where(do_sh, st.sh_seg, st.t_far)

        # --- slot loop: positions + per-slot majorants (registers only) ---
        t0_ab, _ = isect.ray_aabb(o_cur, d_cur, macro.aabb_min,
                                  macro.aabb_max)
        sc_maj = jax.lax.stop_gradient(scale * st_max)
        t_k = t_cur
        draw = 0
        tap_ts, tap_majs, tap_ok, after_ts = [], [], [], []
        for k in range(K):
            has_tap = jnp.zeros((n,), bool)
            tap_t = t_cur
            tap_maj = jnp.ones((n,), jnp.float32)
            for h in range(H + 1):
                u1 = _tap_uniform(tap_seed, lane,
                                  st.tap_ctr + jnp.uint32(draw))
                draw += 1
                pending = ~has_tap & (t_k < t_lim)
                p_here = o_cur + t_k[..., None] * d_cur
                majd, cell = macro.lookup(p_here)
                inside = jnp.all((p_here >= macro.aabb_min)
                                 & (p_here <= macro.aabb_max), axis=-1)
                maj = jnp.maximum(jnp.where(inside, majd, 1e-7) * sc_maj,
                                  1e-7)
                tex = macro.t_exit(o_cur, d_cur, cell)
                # outside the grid density is zero: hop to the (re-)entry
                # point, or to the segment end if the ray has left for good
                t_entry = jnp.where(t0_ab > t_k, t0_ab, t_lim)
                tex = jnp.where(inside,
                                jnp.maximum(tex, t_k * (1 + 1e-6) + 1e-6),
                                t_entry)
                dt = -jnp.log1p(-u1) / maj
                t_new = t_k + dt
                crosses = t_new > tex
                is_tap = pending & ~crosses & (t_new < t_lim)
                t_adv = jnp.where(crosses, jnp.minimum(tex, t_lim),
                                  jnp.minimum(t_new, t_lim))
                t_k = jnp.where(pending, t_adv, t_k)
                tap_t = jnp.where(is_tap, t_new, tap_t)
                tap_maj = jnp.where(is_tap, maj, tap_maj)
                has_tap = has_tap | is_tap
            tap_ts.append(tap_t)
            tap_majs.append(tap_maj)
            tap_ok.append(has_tap)
            after_ts.append(t_k)

        # --- ONE batched density gather over the K tentative positions ---
        if K == 1:
            dens_all = bricks.lookup(
                o_cur + tap_ts[0][..., None] * d_cur)[None]
        else:
            p_all = (o_cur[None, :, :]
                     + jnp.stack(tap_ts)[:, :, None] * d_cur[None, :, :])
            dens_all = bricks.lookup(p_all.reshape(K * n, 3)).reshape(K, n)

        # --- resolve K decisions sequentially (registers only) ---
        ext_w = st.ext_w
        sh_tr = st.sh_tr
        ext_t = st.ext_t
        sh_t = st.sh_t
        ext_live = do_ext
        sh_live = do_sh
        resolved_hit = jnp.zeros((n,), bool)
        taps_used = jnp.zeros((n,), jnp.uint32)
        w_real = ss / jnp.maximum(st_mean, 1e-12)[..., None]
        for k in range(K):
            active_k = ext_live | sh_live
            taps_used = taps_used + (active_k & tap_ok[k]).astype(jnp.uint32)
            dens = dens_all[k] * scale
            maj_k = tap_majs[k]
            p_real = jnp.clip(dens * st_mean / maj_k, 0.0, 1.0)
            u2 = _tap_uniform(tap_seed, lane, st.tap_ctr + jnp.uint32(draw + k))
            real = u2 < p_real
            factor = jnp.maximum(
                1.0 - dens[..., None] * st_color / maj_k[..., None], 0.0)
            w_null = factor / jnp.maximum(1.0 - p_real, 1e-12)[..., None]
            # extension Woodcock
            hit_k = ext_live & tap_ok[k] & real
            null_k = ext_live & tap_ok[k] & ~real
            escaped_k = ext_live & ~tap_ok[k] & (after_ts[k] >= t_lim)
            ext_w = jnp.where(hit_k[..., None], ext_w * w_real, ext_w)
            ext_w = jnp.where(null_k[..., None], ext_w * w_null, ext_w)
            ext_t = jnp.where(hit_k, tap_ts[k],
                              jnp.where(ext_live, after_ts[k], ext_t))
            resolved_hit = resolved_hit | hit_k
            ext_live = ext_live & ~hit_k & ~escaped_k
            # shadow ratio tracking: hops contribute factor 1
            upd = sh_live & tap_ok[k]
            sh_tr = jnp.where(upd[..., None], sh_tr * factor, sh_tr)
            sh_t = jnp.where(sh_live, after_ts[k], sh_t)
            sh_live = sh_live & (after_ts[k] < t_lim)

        tap_ctr = st.tap_ctr + jnp.uint32(K * (H + 2)) \
            * any_work.astype(jnp.uint32)
        ext_resolved = do_ext & ~ext_live
        ext_tracking = st.ext_tracking & ~ext_resolved
        ext_done = st.ext_done | ext_resolved
        ext_scat = jnp.where(ext_resolved, resolved_hit, st.ext_scat)

        n_taps = st.n_taps + jnp.sum(taps_used)
        track_work = jnp.any(
            (st.sh_active & ~st.sh_need_isect & (sh_t < st.sh_seg))
            | ext_tracking)

        return st._replace(
            ext_tracking=ext_tracking, ext_done=ext_done, ext_scat=ext_scat,
            ext_t=ext_t, ext_w=ext_w, sh_tr=jnp.maximum(sh_tr, 0.0),
            sh_t=sh_t, tap_ctr=tap_ctr, n_taps=n_taps,
            track_work=track_work,
        )

    # ------------------------------------------------------------------
    def tracking_compact(st: WFState, K: int, W: int) -> WFState:
        """Compacted K-jump tracking pass (r5 rework): only ~active-many
        lanes issue density lookups.

        The full-width engine spends most of its lookup cost on idle
        lanes; compaction trades that for a sort plus a pack gather and an
        unpack scatter. Design:
          1. sort (need ? lane : BIG) -> first W sorted values are the
             active lanes (the caller's width ladder guarantees W >= count,
             so there are no overflow-delayed lanes);
          2. ONE packed-row gather pulls their tracking state;
          3. K jumps run at width W (slot cost scales with W, not n);
          4. ONE (W,8) outcome-row scatter puts results back (invalid rows
             carry processed=0 and merge as no-ops)."""
        need_sh = st.sh_active & ~st.sh_need_isect & (st.sh_t < st.sh_seg)
        need = need_sh | st.ext_tracking
        do_sh = need_sh
        # per-lane tracking inputs (cheap full-width selects). Medium-derived
        # quantities (sigma tables, majorant) are NOT computed here — they
        # derive from the medium id alone at compacted width W below.
        t_cur = jnp.where(do_sh, st.sh_t, st.ext_t)
        o_cur = jnp.where(do_sh[..., None], st.sh_o, st.o)
        d_cur = jnp.where(do_sh[..., None], st.sh_d, st.d)
        t_lim = jnp.where(do_sh, st.sh_seg, st.t_far)
        med = jnp.where(do_sh, st.sh_med, st.medium)

        # --- pack per-lane state into one row table (n, 12) ---
        lanes = jnp.arange(n, dtype=jnp.int32)
        packed = jnp.concatenate([
            o_cur, d_cur, t_cur[:, None], t_lim[:, None],
            med.astype(jnp.float32)[:, None],
            jax.lax.bitcast_convert_type(st.tap_ctr,
                                         jnp.float32)[:, None],
            need.astype(jnp.float32)[:, None],
            do_sh.astype(jnp.float32)[:, None],
        ], axis=-1)                                   # (n, 12)

        # --- sort-based compaction ---
        key = jnp.where(need, lanes, jnp.int32(2 ** 30))
        _, src = jax.lax.sort_key_val(key, lanes)
        src_w = src[:W]

        rows = jnp.take(packed, src_w, axis=0)        # (W, 12)
        o_g = rows[:, 0:3]
        d_g = rows[:, 3:6]
        t_g = rows[:, 6]
        lim_g = rows[:, 7]
        med_g = rows[:, 8].astype(jnp.int32)
        ctr_g = jax.lax.bitcast_convert_type(rows[:, 9], jnp.uint32)
        s_valid = rows[:, 10] > 0.5
        sh_g = (rows[:, 11] > 0.5) & s_valid
        _, sa_g, ss_g, _, scale_g = _medium_params(scene, med_g)
        stc_g = sa_g + ss_g
        stm_g = jnp.mean(stc_g, axis=-1)
        maj_g = jax.lax.stop_gradient(jnp.maximum(
            media.majorant * jnp.max(stc_g, axis=-1), 1e-6))
        lane_g = src_w.astype(jnp.uint32)

        # --- K jumps at width W ---
        ts = []
        t_k = t_g
        for k in range(K):
            u1 = _tap_uniform(tap_seed, lane_g, ctr_g + jnp.uint32(2 * k))
            t_k = t_k - jnp.log1p(-u1) / maj_g
            ts.append(t_k)
        p_all = (o_g[None, :, :] + jnp.stack(ts)[:, :, None] * d_g[None, :, :])
        dens_all = bricks.lookup(p_all.reshape(K * W, 3)).reshape(K, W)

        fac = jnp.ones((W, 3), jnp.float32)
        live = s_valid
        hit = jnp.zeros((W,), bool)
        t_out = t_g
        taps_g = jnp.zeros((W,), jnp.uint32)
        w_real = ss_g / jnp.maximum(stm_g, 1e-12)[..., None]
        for k in range(K):
            t_new = ts[k]
            dens = dens_all[k] * scale_g
            taps_g = taps_g + live.astype(jnp.uint32)
            esc = t_new >= lim_g
            p_real = dens * stm_g / maj_g
            u2 = _tap_uniform(tap_seed, lane_g, ctr_g + jnp.uint32(2 * k + 1))
            real = u2 < p_real
            factor = 1.0 - dens[..., None] * stc_g / maj_g[..., None]
            w_null = factor / jnp.maximum(1.0 - p_real, 1e-12)[..., None]
            hit_k = live & ~sh_g & ~esc & real
            null_k = live & ~sh_g & ~esc & ~real
            fac = jnp.where(hit_k[..., None], fac * w_real, fac)
            fac = jnp.where(null_k[..., None], fac * w_null, fac)
            upd = live & sh_g & ~esc
            fac = jnp.where(upd[..., None], fac * factor, fac)
            t_out = jnp.where(live, jnp.minimum(t_new, lim_g), t_out)
            hit = hit | hit_k
            live = live & ~esc & ~(real & ~sh_g)

        resolved_g = s_valid & ~live
        out_rows = jnp.concatenate([
            t_out[:, None], fac,
            hit[:, None].astype(jnp.float32),
            resolved_g[:, None].astype(jnp.float32),
            taps_g[:, None].astype(jnp.float32),
            s_valid[:, None].astype(jnp.float32),
        ], axis=-1)                                   # (W, 8)

        # --- ONE W-row scatter puts outcomes back in lane order ---
        staging = jnp.zeros((n, 8), jnp.float32).at[src_w].set(
            out_rows, unique_indices=True)
        processed = (staging[:, 7] > 0.5) & need
        t_b = staging[:, 0]
        fac_b = staging[:, 1:4]
        hit_b = staging[:, 4] > 0.5
        res_b = (staging[:, 5] > 0.5) & processed
        taps_b = staging[:, 6].astype(jnp.uint32)

        p_ext = processed & ~do_sh
        p_sh = processed & do_sh
        ext_w = jnp.where(p_ext[..., None], st.ext_w * fac_b, st.ext_w)
        ext_t = jnp.where(p_ext, t_b, st.ext_t)
        ext_resolved = p_ext & res_b
        ext_tracking = st.ext_tracking & ~ext_resolved
        ext_done = st.ext_done | ext_resolved
        ext_scat = jnp.where(ext_resolved, hit_b, st.ext_scat)
        sh_tr = jnp.where(p_sh[..., None],
                          jnp.maximum(st.sh_tr * fac_b, 0.0), st.sh_tr)
        sh_t = jnp.where(p_sh, t_b, st.sh_t)
        tap_ctr = st.tap_ctr + jnp.uint32(2 * K) * processed.astype(jnp.uint32)
        n_taps = st.n_taps + jnp.sum(jnp.where(processed, taps_b, 0))
        track_work = jnp.any(
            (st.sh_active & ~st.sh_need_isect & (sh_t < st.sh_seg))
            | ext_tracking)
        return st._replace(
            ext_tracking=ext_tracking, ext_done=ext_done, ext_scat=ext_scat,
            ext_t=ext_t, ext_w=ext_w, sh_tr=sh_tr, sh_t=sh_t,
            tap_ctr=tap_ctr, n_taps=n_taps, track_work=track_work,
        )

    def tracking_ladder(st: WFState) -> WFState:
        """Pick the smallest compacted width that holds the active count.

        Rungs n/8, n/4, n/2 + a full-width fallback; every rung is compiled
        once and lax.switch executes exactly one per pass. W >= count by
        construction, so compaction never delays lanes (the r3 variant's
        overflow lanes cost it ~20% extra full passes)."""
        K = max(1, cfg.wf_compact_k)
        need = (st.sh_active & ~st.sh_need_isect & (st.sh_t < st.sh_seg)) \
            | st.ext_tracking
        cnt = jnp.sum(need.astype(jnp.int32))
        rungs = [min(n, max(256, n // 8)), min(n, max(256, n // 4)),
                 min(n, max(256, n // 2))]
        ix = ((cnt > rungs[0]).astype(jnp.int32)
              + (cnt > rungs[1]).astype(jnp.int32)
              + (cnt > rungs[2]).astype(jnp.int32))
        return jax.lax.switch(ix, [
            lambda s: tracking_compact(s, K, rungs[0]),
            lambda s: tracking_compact(s, K, rungs[1]),
            lambda s: tracking_compact(s, K, rungs[2]),
            lambda s: (tracking_dda(s, K) if macro is not None
                       else tracking_full(s, K)),
        ], st)

    # ------------------------------------------------------------------
    def cond(st: WFState):
        # the heavy any() reduction is precomputed inside the passes
        return st.pending & (st.it < max_super)

    def finalize(st: WFState):
        unfinished = jnp.sum(st.sample_open
                             | (st.sample_idx + 1 < sppc)).astype(jnp.uint32)
        stats = (st.n_segments, st.n_taps, st.it, unfinished)
        # drain the (at most _EPOCH_RING) epochs still pending in the ring:
        # film[p] += pend[j % E][(p - j*stride) mod npix] for undrained j
        stride = 104729 % npix
        film = st.film
        for j in range(sppc):
            live = (j >= st.drained) & (j < st.drained + _EPOCH_RING)
            film = film + jnp.where(
                live, jnp.roll(st.pend[j % _EPOCH_RING], j * stride, axis=0),
                0.0)
        return film, stats

    return st, event_pass, tracking_iter, cond, finalize


def render_wavefront(scene: Scene, cfg: RenderConfig, sppc: int, seed,
                     pass_idx, n_lanes: int | None = None,
                     has_direct: bool = True, any_het: bool = True,
                     row0=None, full_height: int | None = None):
    """Render sppc samples/pixel; returns ((npix,3) radiance sum, stats).

    stats = (segments uint32, taps uint32, super_iterations int32,
    unfinished uint32)."""
    st, event_pass, tracking_iter, cond, finalize = make_engine(
        scene, cfg, sppc, seed, pass_idx, n_lanes=n_lanes,
        has_direct=has_direct, any_het=any_het, row0=row0,
        full_height=full_height)
    T_TRACK = cfg.wf_track_iters if any_het else 0
    act = cfg.bsdf_kinds or None

    def track_block(s: WFState) -> WFState:
        # one batched tracking pass (compacted when cfg.wf_track_compact>0);
        # skipped entirely (scalar cond) when no lane has tracking work
        return jax.lax.cond(
            s.track_work,
            lambda x: tracking_iter(x, K=T_TRACK, compact=cfg.wf_track_compact),
            lambda x: x, s)

    def super_iter(s: WFState) -> WFState:
        # pass pattern: E [M T]*k (k = wf_mini_passes) or E T when k = 0.
        # The first transition pass directly consumes the analytic outcomes
        # the event pass produced (e.g. a fresh camera ray crossing the null
        # wall of a bounded medium), so tracking starts the same iteration.
        s = event_pass(s)
        if cfg.wf_mini_passes == 0:
            return track_block(s) if T_TRACK else s
        for _ in range(cfg.wf_mini_passes):
            s = event_pass(s, mini=True)
            if T_TRACK:
                s = track_block(s)
        return s

    st = jax.lax.while_loop(cond, super_iter, st)
    return finalize(st)
