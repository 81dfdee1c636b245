"""Grouped-tile persistent-wavefront engine (forward renderer, v2).

Round-4 architecture change. The v1 engine (integrators/wavefront.py) runs
every pass at FULL wavefront width with masked lanes, so its cost is
(iterations x lane count x pass unit cost) regardless of how many lanes
actually have work — low lane occupancy on the heterogeneous bench. The
premise of v2: per-LANE compaction pays a random row gather per lane,
while CONTIGUOUS-BLOCK gathers/scatters are cheap. So v2 makes pass width
track the active set at GROUP granularity:

* Lanes are bound to pixels 1:1 (identity mapping) through a 2-D tile
  swizzle: one GROUP = 512 lanes = one 16x32-pixel tile. Work is spatially
  coherent, so groups are bimodal (a tile is mostly-medium or
  mostly-background) and retire at their own pace — the wavefront analogue
  of the reference's pull scheduler handing 32x32 blocks to idle workers
  (sched.cpp:427) with NO idle-worker cost at all.
* All per-lane state lives in four PACKED arrays (f3/f1/i1/b1), so a
  grouped pass is: select top-K groups by need -> 4 block-row gathers ->
  run the same pass body at width K*512 -> 4 block-row scatters.
* Pass width adapts at runtime through a `lax.cond` ladder (full, 1/2,
  1/8, ... of the groups): every rung is compiled once; each iteration
  executes only the narrowest rung that covers the active-group count.
* Sample queues are per-pixel (a lane renders all sppc samples of its own
  pixel), which deletes v1's epoch-ring film machinery: the film IS the
  per-lane accumulator, unswizzled once per pass.

Feature scope matches v1's steady-state volpath family (vacuum /
homogeneous / heterogeneous media, every BSDF/phase/emitter model, MIS,
attenuated NEE across null boundaries, collimated-beam NEE); v1 remains
for resolutions that don't tile and as the A/B baseline.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from mitsubaer_tpu.core import rng
from mitsubaer_tpu.core.math import Frame, dot, mis_weight_power
from mitsubaer_tpu.models import bsdf as bsdf_m
from mitsubaer_tpu.models import emitter as emitter_m
from mitsubaer_tpu.models import medium as medium_m
from mitsubaer_tpu.models import phase as phase_m
from mitsubaer_tpu.models import sensor as sensor_m
from mitsubaer_tpu.scene import intersect as isect
from mitsubaer_tpu.scene.types import (
    MED_HETEROGENEOUS,
    MED_HOMOGENEOUS,
    RenderConfig,
    Scene,
)
from mitsubaer_tpu.integrators import common
from mitsubaer_tpu.integrators.volpath import (
    _is_null_surface,
    _shape_tables,
    beam_transmittance,
    build_beam_tau,
    get_beam,
    sample_beam_point,
)
from mitsubaer_tpu.integrators.wavefront import _tap_uniform

GSZ = 512          # lanes per group = pixels per tile
TILE_H, TILE_W = 16, 32

# ---- packed column indices ----
# f3 (n, 12, 3) float32 — tracking-hot columns first (cols 0..5)
F3_O, F3_D, F3_SH_O, F3_SH_D, F3_EXT_W, F3_SH_TR = 0, 1, 2, 3, 4, 5
F3_HIT_NG, F3_TP, F3_SH_VAL, F3_SH_CROSS_P, F3_L, F3_PEND = 6, 7, 8, 9, 10, 11
NF3 = 12
# f1 (n, 7) float32
F1_T_FAR, F1_EXT_T, F1_SH_SEG, F1_SH_T = 0, 1, 2, 3
F1_ETA, F1_LAST_PDF, F1_SH_REM = 4, 5, 6
NF1 = 7
# i1 (n, 9) int32 (uint32 fields bitcast)
I1_MED, I1_SH_MED, I1_TAP_CTR, I1_HIT_SHAPE, I1_DEPTH = 0, 1, 2, 3, 4
I1_SAMPLE_IDX, I1_SH_CROSS_MED, I1_SMP_INDEX, I1_SMP_DIM = 5, 6, 7, 8
NI1 = 9
# b1 (n, 10) bool
B1_EXT_TRACKING, B1_EXT_DONE, B1_EXT_SCAT, B1_SH_ACTIVE = 0, 1, 2, 3
B1_SH_NEED_ISECT, B1_HIT_VALID, B1_LAST_DELTA, B1_PATH_ALIVE = 4, 5, 6, 7
B1_SAMPLE_OPEN, B1_SH_HIT_NULL = 8, 9
NB1 = 10


class WF2State(NamedTuple):
    f3: jnp.ndarray          # (n, NF3, 3)
    f1: jnp.ndarray          # (n, NF1)
    i1: jnp.ndarray          # (n, NI1) int32
    b1: jnp.ndarray          # (n, NB1) bool
    n_segments: jnp.ndarray  # () uint32
    n_taps: jnp.ndarray      # () uint32
    it: jnp.ndarray          # () int32
    pending: jnp.ndarray     # () bool
    track_work: jnp.ndarray  # () bool


def supports(cfg: RenderConfig) -> bool:
    return (cfg.height % TILE_H == 0 and cfg.width % TILE_W == 0
            and (cfg.height * cfg.width) % GSZ == 0)


def _lane_to_pixel_xy(lane_i32, W):
    """Raster (px, py) of a lane under the tile swizzle."""
    tpr = W // TILE_W                 # tiles per row
    t = lane_i32 // GSZ
    o = lane_i32 % GSZ
    ty, tx = t // tpr, t % tpr
    iy, ix = o // TILE_W, o % TILE_W
    return tx * TILE_W + ix, ty * TILE_H + iy


def lane_of_pixel_perm(H, W):
    """Static permutation: lane index serving each raster pixel."""
    py, px = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    tpr = W // TILE_W
    t = (py // TILE_H) * tpr + px // TILE_W
    o = (py % TILE_H) * TILE_W + px % TILE_W
    return (t * GSZ + o).reshape(-1).astype(np.int32)


def _select_groups(need, G, K):
    """Top-K group indices by active-lane count (descending)."""
    counts = jnp.sum(need.reshape(G, GSZ), axis=1).astype(jnp.int32)
    _, order = jax.lax.sort_key_val(-counts, jnp.arange(G, dtype=jnp.int32))
    return order[:K]


def _ggather(arr, sel, n):
    G = n // GSZ
    r = arr.reshape((G, GSZ) + arr.shape[1:])
    out = jnp.take(r, sel, axis=0)
    return out.reshape((sel.shape[0] * GSZ,) + arr.shape[1:])


def _gscatter(arr, sel, vals, n):
    G = n // GSZ
    K = sel.shape[0]
    r = arr.reshape((G, GSZ) + arr.shape[1:])
    r = r.at[sel].set(vals.reshape((K, GSZ) + arr.shape[1:]))
    return r.reshape(arr.shape)


def make_engine2(scene: Scene, cfg: RenderConfig, sppc: int, seed,
                 pass_idx, has_direct: bool = True, any_het: bool = True):
    H, W = cfg.height, cfg.width
    npix = H * W
    n = npix
    G = n // GSZ
    assert supports(cfg), "wavefront2 requires 16x32-tileable resolutions"
    eps = common.scene_epsilon(scene)
    media = scene.media
    bricks = medium_m.DensityBricks(media, dtype=jnp.bfloat16)
    has_beam = cfg.has_beam
    beam = get_beam(scene) if has_beam else None
    beam_tau = build_beam_tau(scene, beam, bricks) if has_beam else None
    macro = medium_m.MacroMajorant(media, m=cfg.wf_dda) \
        if (cfg.wf_dda > 0 and any_het) else None
    act = cfg.bsdf_kinds or None
    pact = cfg.phase_kinds or None
    T_TRACK = cfg.wf_track_iters if any_het else 0

    seed = jnp.asarray(seed, jnp.uint32)
    pass_idx = jnp.asarray(pass_idx, jnp.uint32)
    # decorrelate tracking taps across spp passes (same fix as wavefront.py:
    # tap_ctr restarts at 0 each pass, so the bare seed would replay the
    # identical per-lane tap sequence every pass)
    tap_seed = seed ^ (pass_idx * jnp.uint32(0x9E3779B9)
                       + jnp.uint32(0x7F4A7C15))
    all_lane = jnp.arange(n, dtype=jnp.int32)

    def init_state():
        f3 = jnp.zeros((n, NF3, 3), jnp.float32)
        f3 = f3.at[:, F3_D, 2].set(1.0)
        f1 = jnp.zeros((n, NF1), jnp.float32)
        f1 = f1.at[:, F1_ETA].set(1.0)
        i1 = jnp.zeros((n, NI1), jnp.int32)
        i1 = i1.at[:, I1_MED].set(-1)
        i1 = i1.at[:, I1_SH_MED].set(-1)
        i1 = i1.at[:, I1_HIT_SHAPE].set(-1)
        i1 = i1.at[:, I1_SAMPLE_IDX].set(-1)
        b1 = jnp.zeros((n, NB1), bool)
        b1 = b1.at[:, B1_LAST_DELTA].set(True)
        return WF2State(
            f3=f3, f1=f1, i1=i1, b1=b1,
            n_segments=jnp.zeros((), jnp.uint32),
            n_taps=jnp.zeros((), jnp.uint32),
            it=jnp.zeros((), jnp.int32),
            pending=jnp.ones((), bool),
            track_work=jnp.zeros((), bool),
        )

    max_super = sppc * (6 * cfg.max_depth + 16) + 64

    # ------------------------------------------------------------------
    # event-pass body at arbitrary width (port of wavefront.py event_pass
    # with identity pixel mapping and no epoch ring)
    # ------------------------------------------------------------------
    def event_body(f3, f1, i1, b1, lane, mini: bool):
        m = lane.shape[0]
        b0 = jnp.zeros((m,), bool)
        f0m = jnp.zeros((m,), jnp.float32)
        f3m = jnp.zeros((m, 3), jnp.float32)
        i0m = jnp.zeros((m,), jnp.int32)

        o = f3[:, F3_O]
        d = f3[:, F3_D]
        sh_o = f3[:, F3_SH_O]
        sh_d = f3[:, F3_SH_D]
        ext_w = f3[:, F3_EXT_W]
        sh_tr = f3[:, F3_SH_TR]
        hit_ng = f3[:, F3_HIT_NG]
        throughput = f3[:, F3_TP]
        sh_val = f3[:, F3_SH_VAL]
        sh_cross_p = f3[:, F3_SH_CROSS_P]
        L = f3[:, F3_L]
        pend = f3[:, F3_PEND]
        t_far = f1[:, F1_T_FAR]
        ext_t = f1[:, F1_EXT_T]
        sh_seg = f1[:, F1_SH_SEG]
        sh_t = f1[:, F1_SH_T]
        eta_scale = f1[:, F1_ETA]
        last_pdf = f1[:, F1_LAST_PDF]
        sh_remaining = f1[:, F1_SH_REM]
        medium = i1[:, I1_MED]
        sh_med = i1[:, I1_SH_MED]
        tap_ctr = i1[:, I1_TAP_CTR].astype(jnp.uint32)
        hit_shape = i1[:, I1_HIT_SHAPE]
        depth = i1[:, I1_DEPTH]
        sample_idx = i1[:, I1_SAMPLE_IDX]
        sh_cross_med = i1[:, I1_SH_CROSS_MED]
        smp_index = i1[:, I1_SMP_INDEX].astype(jnp.uint32)
        smp_dim = i1[:, I1_SMP_DIM].astype(jnp.uint32)
        ext_tracking = b1[:, B1_EXT_TRACKING]
        ext_done = b1[:, B1_EXT_DONE]
        ext_scat_f = b1[:, B1_EXT_SCAT]
        sh_active = b1[:, B1_SH_ACTIVE]
        sh_need_isect = b1[:, B1_SH_NEED_ISECT]
        hit_valid = b1[:, B1_HIT_VALID]
        last_delta = b1[:, B1_LAST_DELTA]
        path_alive = b1[:, B1_PATH_ALIVE]
        sample_open = b1[:, B1_SAMPLE_OPEN]
        sh_hit_null = b1[:, B1_SH_HIT_NULL]

        pix = lane  # identity lane<->pixel binding (raster id via swizzle)
        mode = rng.MODES.get(cfg.sampler, rng.INDEPENDENT)
        smp = rng.Sampler(lane=pix.astype(jnp.uint32), index=smp_index,
                          dim=smp_dim, seed=seed, mode=mode,
                          n_samples=cfg.spp)

        # ---------- stage 1: shadow subsegment completion ----------
        sh_done = sh_active & ~sh_need_isect & (sh_t >= sh_seg)
        tr_dead = jnp.max(sh_tr, axis=-1) <= 0.0
        complete = sh_done & ~sh_hit_null
        L = L + jnp.where(complete[..., None], sh_val * sh_tr, 0.0)
        crossing = sh_done & sh_hit_null & ~tr_dead
        sh_o = jnp.where(crossing[..., None], sh_cross_p + sh_d * eps, sh_o)
        sh_remaining = jnp.where(crossing, sh_remaining - sh_seg - eps,
                                 sh_remaining)
        sh_med = jnp.where(crossing, sh_cross_med, sh_med)
        still = crossing & (sh_remaining > eps)
        sh_need_isect = sh_need_isect | still
        sh_active = jnp.where(sh_done, still, sh_active)
        sh_active = sh_active & ~(sh_done & tr_dead)

        # ---------- stage 2: extension outcome processing ----------
        b_idx, e_idx, m_in, m_ex = _shape_tables(scene, hit_shape)
        is_null = _is_null_surface(scene, b_idx)

        proc = ext_done & ~sh_active & ~sh_need_isect & path_alive
        if mini:
            proc = proc & ~ext_scat_f & (
                ~hit_valid | (is_null & (e_idx < 0)))
        m_p = o + ext_t[..., None] * d
        tp = throughput * jnp.where(proc[..., None], ext_w, 1.0)
        scattered = proc & ext_scat_f
        escaped = proc & ~ext_scat_f & ~hit_valid
        on_surface = proc & ~ext_scat_f & hit_valid

        hit_p = o + t_far[..., None] * d

        env = emitter_m.env_radiance(scene, d)
        env_pdf = emitter_m.pdf_direct_env(scene, d)
        w_env = jnp.where(last_delta, 1.0,
                          mis_weight_power(last_pdf, env_pdf))
        L = L + jnp.where(escaped[..., None], tp * env * w_env[..., None],
                          0.0)

        if not mini:
            hit_em = on_surface & (e_idx >= 0)
            le = emitter_m.eval_hit(scene, e_idx, hit_ng, -d)
            lum_pdf = emitter_m.pdf_direct_hit(scene, e_idx, o, hit_p, hit_ng)
            w_hit = jnp.where(last_delta, 1.0,
                              mis_weight_power(last_pdf, lum_pdf))
            hide = cfg.hide_emitters & (depth == 1)
            L = L + jnp.where((hit_em & ~hide)[..., None],
                              tp * le * w_hit[..., None], 0.0)

        depth_ok = depth < cfg.max_depth
        vtx = jnp.where(scattered[..., None], m_p, hit_p)
        nee_ok = (scattered | (on_surface & ~is_null)) & depth_ok

        if not mini:
            frame = Frame.from_normal(hit_ng)
            wi_srf = frame.to_local(-d)
            u_nee2, smp = rng.next_2d(smp)
            u_nee1, smp = rng.next_1d(smp)
            u_fam, smp = rng.next_1d(smp)

        new_sh_active = b0
        new_sh_d = sh_d
        new_sh_o = sh_o
        new_sh_rem = sh_remaining
        new_sh_med = sh_med
        new_sh_val = sh_val

        if mini:
            use_beam = b0
            fam_w = 1.0
        elif has_direct and has_beam:
            use_beam = u_fam < 0.5
            fam_w = 2.0
        elif has_beam:
            use_beam = jnp.ones((m,), bool)
            fam_w = 1.0
        else:
            use_beam = b0
            fam_w = 1.0

        if has_direct and not mini:
            ds = emitter_m.sample_direct(scene, vtx, u_nee2, u_nee1)
            wo_srf = frame.to_local(ds.d)
            f_srf = bsdf_m.eval(scene.bsdfs, b_idx, wi_srf, wo_srf,
                                active=act)
            pdf_srf = bsdf_m.pdf(scene.bsdfs, b_idx, wi_srf, wo_srf,
                                 active=act)
            ax_ov = medium_m.orientation_axis(media, medium, m_p) \
                if cfg.phase_orient else None
            f_med = phase_m.eval(media.phase, medium, d, ds.d,
                                 active=pact, axis_override=ax_ov)[..., None]
            pdf_med = f_med[..., 0]
            f_vtx = jnp.where(scattered[..., None], f_med, f_srf)
            pdf_vtx = jnp.where(scattered, pdf_med, pdf_srf)
            w_nee = jnp.where(ds.delta, 1.0,
                              mis_weight_power(ds.pdf, pdf_vtx))
            val = (tp * f_vtx * ds.value
                   * (fam_w * w_nee / jnp.maximum(ds.pdf, 1e-12))[..., None])
            ok = (nee_ok & ~use_beam & (ds.pdf > 0)
                  & jnp.any(f_vtx > 0, axis=-1)
                  & jnp.any(ds.value > 0, axis=-1))
            srf_entering = dot(ds.d, hit_ng) < 0
            nee_med = jnp.where(scattered, medium,
                                jnp.where(srf_entering, m_in, m_ex))
            new_sh_active = jnp.where(ok, True, new_sh_active)
            sel = ok[..., None]
            new_sh_d = jnp.where(sel, ds.d, new_sh_d)
            new_sh_o = jnp.where(sel, vtx + ds.d * eps, new_sh_o)
            new_sh_rem = jnp.where(ok, ds.dist - 2 * eps, new_sh_rem)
            new_sh_med = jnp.where(ok, nee_med, new_sh_med)
            new_sh_val = jnp.where(sel, val, new_sh_val)

        if has_beam and not mini:
            u_b, smp = rng.next_1d(smp)
            y_b, s_b, pdf_sb, dist_b, d_yp = sample_beam_point(beam, vtx, u_b)
            bmed = jnp.broadcast_to(beam.medium, (m,))
            kind_b, sa_b, ss_b, _, scale_b = medium_m.params(media, bmed)
            tr_beam, dens_tab = beam_transmittance(beam, beam_tau, s_b,
                                                   with_density=True)
            dens_b = jnp.where(kind_b == MED_HETEROGENEOUS, dens_tab,
                               jnp.ones((m,)))
            sigma_s_y = ss_b * dens_b[..., None]
            rho_y = phase_m.eval(media.phase, bmed,
                                 jnp.broadcast_to(beam.d, (m, 3)), d_yp,
                                 active=pact)
            bval = (beam.power * tr_beam * sigma_s_y
                    * (rho_y / jnp.maximum(pdf_sb * dist_b * dist_b,
                                           1e-12))[..., None])
            f_srf_b = bsdf_m.eval(scene.bsdfs, b_idx, wi_srf,
                                  frame.to_local(-d_yp), active=act)
            f_med_b = phase_m.eval(media.phase, medium, d, -d_yp,
                                   active=pact)[..., None]
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

        setup = proc & new_sh_active
        sh_active = sh_active | setup
        sh_need_isect = sh_need_isect | setup
        sel = setup[..., None]
        sh_o = jnp.where(sel, new_sh_o, sh_o)
        sh_d2 = jnp.where(sel, new_sh_d, sh_d)
        sh_remaining = jnp.where(setup, new_sh_rem, sh_remaining)
        sh_med = jnp.where(setup, new_sh_med, sh_med)
        sh_val = jnp.where(sel, new_sh_val, sh_val)
        sh_tr = jnp.where(sel, 1.0, sh_tr)
        sh_d = sh_d2

        # ---------- direction sampling ----------
        if mini:
            new_d = d
            scatter_w = jnp.ones((m, 3), jnp.float32)
            new_delta = last_delta
            new_pdf = last_pdf
        else:
            u_dir2, smp = rng.next_2d(smp)
            u_dir1, smp = rng.next_1d(smp)
            ax_ov2 = medium_m.orientation_axis(media, medium, m_p) \
                if cfg.phase_orient else None
            ps = phase_m.sample(media.phase, medium, d, u_dir2,
                                active=pact, axis_override=ax_ov2)
            bs = bsdf_m.sample(scene.bsdfs, b_idx, wi_srf, u_dir2, u_dir1,
                               active=act)
            wo_world = frame.to_world(bs.wo)
            new_d = jnp.where(scattered[..., None], ps.wo, wo_world)
            scatter_w = jnp.where(scattered[..., None],
                                  ps.weight[..., None], bs.weight)
            new_pdf = jnp.where(scattered, ps.pdf, bs.pdf)
            new_delta = jnp.where(scattered, False, bs.delta)

            null_cross = on_surface & is_null
            new_d = jnp.where(null_cross[..., None], d, new_d)
            scatter_w = jnp.where(null_cross[..., None], 1.0, scatter_w)
            new_delta = jnp.where(null_cross, last_delta, new_delta)
            new_pdf = jnp.where(null_cross, last_pdf, new_pdf)

        cross = on_surface & (
            is_null
            | (jnp.sum(new_d * hit_ng, -1) * jnp.sum(-d * hit_ng, -1) < 0))
        entering = jnp.sum(new_d * hit_ng, -1) < 0
        new_medium = jnp.where(cross, jnp.where(entering, m_in, m_ex),
                               medium)

        tp2 = tp * scatter_w
        cont = (scattered | on_surface) & depth_ok
        dead = jnp.all(tp2 <= 0, axis=-1)

        if mini:
            keep = cont & ~dead
        else:
            eta_scale = eta_scale * jnp.where(on_surface, bs.eta, 1.0)
            u_rr, smp = rng.next_1d(smp)
            rr_exempt = null_cross
            tp_rr, survive = common.russian_roulette(tp2, eta_scale, u_rr,
                                                     depth, cfg)
            tp2 = jnp.where(rr_exempt[..., None], tp2, tp_rr)
            keep = cont & ~dead & (survive | rr_exempt)

        finite = (jnp.all(jnp.isfinite(vtx), -1)
                  & jnp.all(jnp.isfinite(new_d), -1)
                  & jnp.all(jnp.isfinite(tp2), -1))
        keep = keep & finite
        tp2 = jnp.nan_to_num(tp2, posinf=0.0, neginf=0.0)

        inc_depth = (scattered | (on_surface & ~is_null)) & keep
        new_o = jnp.nan_to_num(vtx) + jnp.nan_to_num(new_d) * eps

        path_alive = jnp.where(proc, keep, path_alive)
        o = jnp.where((proc & keep)[..., None], new_o, o)
        d = jnp.where((proc & keep)[..., None], jnp.nan_to_num(new_d), d)
        throughput = jnp.where(proc[..., None], tp2, throughput)
        depth = jnp.where(inc_depth, depth + 1, depth)
        last_pdf = jnp.where(proc & keep, new_pdf, last_pdf)
        last_delta = jnp.where(proc & keep, new_delta, last_delta)
        medium = jnp.where(proc & keep, new_medium, medium)
        ext_need = proc & keep
        ext_done = jnp.where(proc, False, ext_done)

        # ---------- sample flush + regeneration (per-pixel queues) -------
        flush = (sample_open & ~path_alive & ~sh_active & ~sh_need_isect
                 & ~ext_tracking & ~ext_need)
        pend = pend + jnp.where(flush[..., None], L, 0.0)
        L = jnp.where(flush[..., None], 0.0, L)
        sample_open = sample_open & ~flush

        want = ((~sample_open) & ~path_alive & (sample_idx + 1 < sppc)
                & ~sh_active & ~sh_need_isect & ~ext_tracking)
        new_idx = sample_idx + 1
        sample_idx = jnp.where(want, new_idx, sample_idx)
        sample_open = sample_open | want
        smp_index_new = pass_idx * jnp.uint32(sppc) \
            + sample_idx.astype(jnp.uint32)
        smp = rng.Sampler(
            lane=smp.lane,
            index=jnp.where(want, smp_index_new, smp.index),
            dim=jnp.where(want, jnp.uint32(0), smp.dim),
            seed=smp.seed, mode=smp.mode, n_samples=smp.n_samples,
        )
        u_jit, smp = rng.next_2d(smp)
        u_lens, smp = rng.next_2d(smp)
        px_i, py_i = _lane_to_pixel_xy(pix, W)
        px = px_i.astype(jnp.float32) + u_jit[:, 0]
        py = py_i.astype(jnp.float32) + u_jit[:, 1]
        rays = sensor_m.sample_rays(
            scene.sensor, px, py, W, H, u_lens=u_lens,
            kind_hint=(cfg.sensor_kind if cfg.sensor_kind >= 0 else None))
        selr = want[..., None]
        o = jnp.where(selr, rays.o, o)
        d = jnp.where(selr, rays.d, d)
        throughput = jnp.where(selr, 1.0, throughput)
        medium = jnp.where(want, jnp.broadcast_to(
            scene.camera_medium, (m,)).astype(jnp.int32), medium)
        depth = jnp.where(want, 1, depth)
        eta_scale = jnp.where(want, 1.0, eta_scale)
        last_pdf = jnp.where(want, 0.0, last_pdf)
        last_delta = jnp.where(want, True, last_delta)
        path_alive = path_alive | want
        ext_need = ext_need | want

        # ---------- stage 3: extension intersect + analytic media --------
        hit = isect.intersect(scene.geo, o, d, jnp.full((m,), eps),
                              jnp.full((m,), isect.INF))
        _, t_scene = isect.ray_aabb(o, d, scene.aabb_min, scene.aabb_max)
        seg_far = jnp.where(hit.valid, hit.t, jnp.maximum(t_scene, 0.0))
        t_far = jnp.where(ext_need, seg_far, t_far)
        hit_valid = jnp.where(ext_need, hit.valid, hit_valid)
        hit_shape = jnp.where(ext_need, hit.shape_id, hit_shape)
        hit_ng = jnp.where(ext_need[..., None], hit.ng, hit_ng)

        kind_m, sa_m, ss_m, sw_m, _ = medium_m.params(media, medium)
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

        ext_done = ext_done | in_hom | in_vac
        ext_scat_f = jnp.where(in_hom, hs,
                               jnp.where(in_vac, False, ext_scat_f))
        ext_t = jnp.where(in_hom, ht, jnp.where(in_vac, t_far, ext_t))
        ext_w = jnp.where(in_hom[..., None], hw,
                          jnp.where(in_vac[..., None], 1.0, ext_w))
        ext_tracking = jnp.where(ext_need, in_het, ext_tracking)
        ext_t = jnp.where(in_het, 0.0, ext_t)
        ext_w = jnp.where(in_het[..., None], 1.0, ext_w)

        # ---------- stage 4: shadow intersect + analytic subsegments -----
        shx = sh_need_isect & sh_active

        def _do_shisect(_):
            return isect.intersect(scene.geo, sh_o, sh_d,
                                   jnp.full((m,), eps * 0.5),
                                   jnp.maximum(sh_remaining - eps, 0.0))

        def _no_shisect(_):
            return isect.Hit(t=f0m, valid=b0, prim=i0m, shape_id=i0m - 1,
                             p=f3m, ng=f3m, uv=jnp.zeros((m, 2)),
                             tex_uv=jnp.zeros((m, 2)))

        shit = jax.lax.cond(jnp.any(shx), _do_shisect, _no_shisect,
                            operand=None)
        sb_idx, _, sm_in, sm_ex = _shape_tables(scene, shit.shape_id)
        s_null = _is_null_surface(scene, sb_idx)
        blocked = shx & shit.valid & ~s_null
        sh_active = sh_active & ~blocked
        hitting = shx & shit.valid & s_null
        sh_seg = jnp.where(shx, jnp.where(shit.valid, shit.t, sh_remaining),
                           sh_seg)
        sh_hit_null = jnp.where(shx, hitting, sh_hit_null)
        s_enter = dot(sh_d, shit.ng) < 0
        sh_cross_med = jnp.where(hitting, jnp.where(s_enter, sm_in, sm_ex),
                                 sh_cross_med)
        sh_cross_p = jnp.where(hitting[..., None], shit.p, sh_cross_p)

        skind, ssa, sss, _, _ = medium_m.params(media, sh_med)
        s_hom = shx & sh_active & (skind == MED_HOMOGENEOUS)
        s_het = shx & sh_active & (skind == MED_HETEROGENEOUS)
        s_vac = shx & sh_active & ~s_hom & ~s_het
        tr_h = medium_m.eval_transmittance_homogeneous(ssa, sss, sh_seg)
        sh_tr = jnp.where(s_hom[..., None], sh_tr * tr_h, sh_tr)
        sh_t = jnp.where(s_hom | s_vac, sh_seg,
                         jnp.where(s_het, 0.0, sh_t))
        sh_need_isect = sh_need_isect & ~shx

        d_segments = (jnp.sum(ext_need) + jnp.sum(shx)).astype(jnp.uint32)

        # ---------- repack ----------
        f3 = jnp.stack([o, d, sh_o, sh_d, ext_w, sh_tr, hit_ng, throughput,
                        sh_val, sh_cross_p, L, pend], axis=1)
        f1 = jnp.stack([t_far, ext_t, sh_seg, sh_t, eta_scale, last_pdf,
                        sh_remaining], axis=1)
        i1 = jnp.stack([medium, sh_med, tap_ctr.astype(jnp.int32),
                        hit_shape, depth, sample_idx, sh_cross_med,
                        smp.index.astype(jnp.int32),
                        smp.dim.astype(jnp.int32)], axis=1)
        b1 = jnp.stack([ext_tracking, ext_done, ext_scat_f, sh_active,
                        sh_need_isect, hit_valid, last_delta, path_alive,
                        sample_open, sh_hit_null], axis=1)
        return f3, f1, i1, b1, d_segments

    # ------------------------------------------------------------------
    # tracking body at arbitrary width (global-majorant or DDA core)
    # ------------------------------------------------------------------
    def track_body(f3, f1, i1, b1, lane, K: int):
        m = lane.shape[0]
        o = f3[:, F3_O]
        d = f3[:, F3_D]
        sh_o = f3[:, F3_SH_O]
        sh_d = f3[:, F3_SH_D]
        ext_w = f3[:, F3_EXT_W]
        sh_tr = f3[:, F3_SH_TR]
        t_far = f1[:, F1_T_FAR]
        ext_t = f1[:, F1_EXT_T]
        sh_seg = f1[:, F1_SH_SEG]
        sh_t = f1[:, F1_SH_T]
        medium = i1[:, I1_MED]
        sh_med = i1[:, I1_SH_MED]
        tap_ctr = i1[:, I1_TAP_CTR].astype(jnp.uint32)
        ext_tracking = b1[:, B1_EXT_TRACKING]
        ext_done = b1[:, B1_EXT_DONE]
        ext_scat_f = b1[:, B1_EXT_SCAT]
        sh_active = b1[:, B1_SH_ACTIVE]
        sh_need_isect = b1[:, B1_SH_NEED_ISECT]

        lane_u = lane.astype(jnp.uint32)
        do_sh = sh_active & ~sh_need_isect & (sh_t < sh_seg)
        do_ext = ~do_sh & ext_tracking
        any_work = do_sh | do_ext

        med = jnp.where(do_sh, sh_med, medium)
        kind, sa, ss, _, scale = medium_m.params(media, med)
        st_color = sa + ss
        st_mean = jnp.mean(st_color, axis=-1)
        st_max = jnp.max(st_color, axis=-1)

        t_cur = jnp.where(do_sh, sh_t, ext_t)
        o_cur = jnp.where(do_sh[..., None], sh_o, o)
        d_cur = jnp.where(do_sh[..., None], sh_d, d)
        t_lim = jnp.where(do_sh, sh_seg, t_far)

        if macro is not None:
            H_hops = cfg.wf_dda_hops
            t0_ab, _ = isect.ray_aabb(o_cur, d_cur, macro.aabb_min,
                                      macro.aabb_max)
            sc_maj = jax.lax.stop_gradient(scale * st_max)
            t_k = t_cur
            draw = 0
            tap_ts, tap_majs, tap_ok, after_ts = [], [], [], []
            for k in range(K):
                has_tap = jnp.zeros((m,), bool)
                tap_t = t_cur
                tap_maj = jnp.ones((m,), jnp.float32)
                for h in range(H_hops + 1):
                    u1 = _tap_uniform(tap_seed, lane_u,
                                      tap_ctr + jnp.uint32(draw))
                    draw += 1
                    pending_h = ~has_tap & (t_k < t_lim)
                    p_here = o_cur + t_k[..., None] * d_cur
                    majd, cell = macro.lookup(p_here)
                    inside = jnp.all((p_here >= macro.aabb_min)
                                     & (p_here <= macro.aabb_max), axis=-1)
                    maj = jnp.maximum(
                        jnp.where(inside, majd, 1e-7) * sc_maj, 1e-7)
                    tex = macro.t_exit(o_cur, d_cur, cell)
                    t_entry = jnp.where(t0_ab > t_k, t0_ab, t_lim)
                    tex = jnp.where(
                        inside, jnp.maximum(tex, t_k * (1 + 1e-6) + 1e-6),
                        t_entry)
                    dt = -jnp.log1p(-u1) / maj
                    t_new = t_k + dt
                    crosses = t_new > tex
                    is_tap = pending_h & ~crosses & (t_new < t_lim)
                    t_adv = jnp.where(crosses, jnp.minimum(tex, t_lim),
                                      jnp.minimum(t_new, t_lim))
                    t_k = jnp.where(pending_h, t_adv, t_k)
                    tap_t = jnp.where(is_tap, t_new, tap_t)
                    tap_maj = jnp.where(is_tap, maj, tap_maj)
                    has_tap = has_tap | is_tap
                tap_ts.append(tap_t)
                tap_majs.append(tap_maj)
                tap_ok.append(has_tap)
                after_ts.append(t_k)
            ctr_step = K * (H_hops + 2)
            accept_base = draw
        else:
            majorant = jax.lax.stop_gradient(jnp.maximum(
                media.majorant * jnp.max(st_color, axis=-1), 1e-6))
            tap_ts, tap_majs, tap_ok, after_ts = [], [], [], []
            t_k = t_cur
            for k in range(K):
                u1 = _tap_uniform(tap_seed, lane_u, tap_ctr + jnp.uint32(2 * k))
                t_k = t_k - jnp.log1p(-u1) / majorant
                tap_ts.append(t_k)
                tap_majs.append(majorant)
                tap_ok.append(t_k < t_lim)
                after_ts.append(jnp.minimum(t_k, t_lim))
            ctr_step = 2 * K
            accept_base = None  # accept draws at odd indices

        if K == 1:
            dens_all = bricks.lookup(
                o_cur + tap_ts[0][..., None] * d_cur)[None]
        else:
            p_all = (o_cur[None, :, :]
                     + jnp.stack(tap_ts)[:, :, None] * d_cur[None, :, :])
            dens_all = bricks.lookup(p_all.reshape(K * m, 3)).reshape(K, m)

        ext_live = do_ext
        sh_live = do_sh
        resolved_hit = jnp.zeros((m,), bool)
        taps_used = jnp.zeros((m,), jnp.uint32)
        w_real = ss / jnp.maximum(st_mean, 1e-12)[..., None]
        for k in range(K):
            active_k = ext_live | sh_live
            taps_used = taps_used + (active_k & tap_ok[k]).astype(jnp.uint32)
            dens = dens_all[k] * scale
            maj_k = tap_majs[k]
            p_real = jnp.clip(dens * st_mean / maj_k, 0.0, 1.0)
            idx2 = (jnp.uint32(accept_base + k) if accept_base is not None
                    else jnp.uint32(2 * k + 1))
            u2 = _tap_uniform(tap_seed, lane_u, tap_ctr + idx2)
            real = u2 < p_real
            factor = jnp.maximum(
                1.0 - dens[..., None] * st_color / maj_k[..., None], 0.0)
            w_null = factor / jnp.maximum(1.0 - p_real, 1e-12)[..., None]
            hit_k = ext_live & tap_ok[k] & real
            null_k = ext_live & tap_ok[k] & ~real
            escaped_k = ext_live & ~tap_ok[k] & (after_ts[k] >= t_lim)
            ext_w = jnp.where(hit_k[..., None], ext_w * w_real, ext_w)
            ext_w = jnp.where(null_k[..., None], ext_w * w_null, ext_w)
            ext_t = jnp.where(hit_k, tap_ts[k],
                              jnp.where(ext_live, after_ts[k], ext_t))
            resolved_hit = resolved_hit | hit_k
            ext_live = ext_live & ~hit_k & ~escaped_k
            upd = sh_live & tap_ok[k]
            sh_tr = jnp.where(upd[..., None], sh_tr * factor, sh_tr)
            sh_t = jnp.where(sh_live, after_ts[k], sh_t)
            sh_live = sh_live & (after_ts[k] < t_lim)

        tap_ctr = tap_ctr + jnp.uint32(ctr_step) * any_work.astype(jnp.uint32)
        ext_resolved = do_ext & ~ext_live
        ext_tracking = ext_tracking & ~ext_resolved
        ext_done = ext_done | ext_resolved
        ext_scat_f = jnp.where(ext_resolved, resolved_hit, ext_scat_f)

        d_taps = jnp.sum(taps_used)

        f3 = f3.at[:, F3_EXT_W].set(ext_w).at[:, F3_SH_TR].set(
            jnp.maximum(sh_tr, 0.0))
        f1 = f1.at[:, F1_EXT_T].set(ext_t).at[:, F1_SH_T].set(sh_t)
        i1 = i1.at[:, I1_TAP_CTR].set(tap_ctr.astype(jnp.int32))
        b1 = (b1.at[:, B1_EXT_TRACKING].set(ext_tracking)
              .at[:, B1_EXT_DONE].set(ext_done)
              .at[:, B1_EXT_SCAT].set(ext_scat_f))
        return f3, f1, i1, b1, d_taps

    # ------------------------------------------------------------------
    # need masks + scalar recompute
    # ------------------------------------------------------------------
    def lane_flags(st: WF2State):
        b1 = st.b1
        return dict(
            ext_tracking=b1[:, B1_EXT_TRACKING], ext_done=b1[:, B1_EXT_DONE],
            sh_active=b1[:, B1_SH_ACTIVE],
            sh_need_isect=b1[:, B1_SH_NEED_ISECT],
            path_alive=b1[:, B1_PATH_ALIVE],
            sample_open=b1[:, B1_SAMPLE_OPEN],
        )

    def need_track(st: WF2State):
        f = lane_flags(st)
        sh_mid = (f["sh_active"] & ~f["sh_need_isect"]
                  & (st.f1[:, F1_SH_T] < st.f1[:, F1_SH_SEG]))
        return sh_mid | (f["ext_tracking"] & ~f["ext_done"])

    def lane_pending(st: WF2State):
        f = lane_flags(st)
        more = st.i1[:, I1_SAMPLE_IDX] + 1 < sppc
        return (f["path_alive"] | f["sample_open"] | more | f["sh_active"]
                | f["sh_need_isect"] | f["ext_tracking"] | f["ext_done"])

    def need_event(st: WF2State):
        return lane_pending(st) & ~need_track(st)

    def refresh_scalars(st: WF2State):
        return st._replace(
            pending=jnp.any(lane_pending(st)),
            track_work=jnp.any(need_track(st)))

    # ------------------------------------------------------------------
    # grouped pass wrappers + cond ladders
    # ------------------------------------------------------------------
    def run_event(st: WF2State, Wg, mini: bool):
        if Wg is None:
            f3, f1, i1, b1, dseg = event_body(st.f3, st.f1, st.i1, st.b1,
                                              all_lane, mini)
            st = st._replace(f3=f3, f1=f1, i1=i1, b1=b1,
                             n_segments=st.n_segments + dseg)
        else:
            sel = _select_groups(need_event(st), G, Wg)
            lane = (sel[:, None] * GSZ
                    + jnp.arange(GSZ, dtype=jnp.int32)[None, :]).reshape(-1)
            f3, f1, i1, b1, dseg = event_body(
                _ggather(st.f3, sel, n), _ggather(st.f1, sel, n),
                _ggather(st.i1, sel, n), _ggather(st.b1, sel, n),
                lane, mini)
            st = st._replace(
                f3=_gscatter(st.f3, sel, f3, n),
                f1=_gscatter(st.f1, sel, f1, n),
                i1=_gscatter(st.i1, sel, i1, n),
                b1=_gscatter(st.b1, sel, b1, n),
                n_segments=st.n_segments + dseg)
        return refresh_scalars(st)._replace(
            it=st.it + (0 if mini else 1))

    def run_track(st: WF2State, Wg, K: int):
        if Wg is None:
            f3, f1, i1, b1, dtaps = track_body(st.f3, st.f1, st.i1, st.b1,
                                               all_lane, K)
            st = st._replace(f3=f3, f1=f1, i1=i1, b1=b1,
                             n_taps=st.n_taps + dtaps)
        else:
            sel = _select_groups(need_track(st), G, Wg)
            lane = (sel[:, None] * GSZ
                    + jnp.arange(GSZ, dtype=jnp.int32)[None, :]).reshape(-1)
            f3, f1, i1, b1, dtaps = track_body(
                _ggather(st.f3, sel, n), _ggather(st.f1, sel, n),
                _ggather(st.i1, sel, n), _ggather(st.b1, sel, n),
                lane, K)
            st = st._replace(
                f3=_gscatter(st.f3, sel, f3, n),
                f1=_gscatter(st.f1, sel, f1, n),
                i1=_gscatter(st.i1, sel, i1, n),
                b1=_gscatter(st.b1, sel, b1, n),
                n_taps=st.n_taps + dtaps)
        return st._replace(track_work=jnp.any(need_track(st)))

    def _ladder(st, count_groups, rungs, run_rung):
        """Dispatch to the narrowest rung covering the active-group count.
        rungs: descending list of group widths (None = full, no gather)."""
        def make(idx):
            return lambda s: run_rung(s, rungs[idx])
        expr = make(len(rungs) - 1)
        for i in range(len(rungs) - 2, -1, -1):
            thresh = rungs[i + 1] if rungs[i + 1] is not None else G
            expr = (lambda i=i, nxt=expr, th=thresh:
                    lambda s: jax.lax.cond(count_groups > th, make(i), nxt,
                                           s))()
        return expr(st)

    EV_RUNGS = [None] + [max(G // f, 1) for f in (2, 8) if G // f >= 1]
    TR_RUNGS = [None] + [max(G // f, 1) for f in (2, 8, 32) if G // f >= 1]

    def event_ladder(st: WF2State, mini: bool):
        cnt = jnp.sum(jnp.any(need_event(st).reshape(G, GSZ), axis=1)
                      .astype(jnp.int32))
        return _ladder(st, cnt, EV_RUNGS,
                       lambda s, Wg: run_event(s, Wg, mini))

    def track_ladder(st: WF2State):
        if T_TRACK == 0:
            return st
        cnt = jnp.sum(jnp.any(need_track(st).reshape(G, GSZ), axis=1)
                      .astype(jnp.int32))
        do = lambda s: _ladder(s, cnt, TR_RUNGS,
                               lambda x, Wg: run_track(x, Wg, T_TRACK))
        return jax.lax.cond(st.track_work, do, lambda s: s, st)

    def super_iter(st: WF2State):
        st = event_ladder(st, mini=False)
        if cfg.wf_mini_passes == 0:
            return track_ladder(st)
        for _ in range(cfg.wf_mini_passes):
            st = event_ladder(st, mini=True)
            st = track_ladder(st)
        return st

    def cond(st: WF2State):
        return st.pending & (st.it < max_super)

    perm = jnp.asarray(lane_of_pixel_perm(H, W))

    def finalize(st: WF2State):
        unfinished = jnp.sum(
            st.b1[:, B1_SAMPLE_OPEN]
            | (st.i1[:, I1_SAMPLE_IDX] + 1 < sppc)).astype(jnp.uint32)
        stats = (st.n_segments, st.n_taps, st.it, unfinished)
        film = jnp.take(st.f3[:, F3_PEND], perm, axis=0)
        return film, stats

    return init_state(), super_iter, cond, finalize


def render_wavefront2(scene: Scene, cfg: RenderConfig, sppc: int, seed,
                      pass_idx, has_direct: bool = True,
                      any_het: bool = True):
    """Render sppc samples/pixel; returns ((npix,3) radiance sum, stats)."""
    st, super_iter, cond, finalize = make_engine2(
        scene, cfg, sppc, seed, pass_idx, has_direct=has_direct,
        any_het=any_het)
    st = jax.lax.while_loop(cond, super_iter, st)
    return finalize(st)
