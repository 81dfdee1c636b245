"""Whole-path renderer for bounded-scattering-volume scenes.

The wavefront engine runs the per-sample walk as ~80 full-width masked
event passes per super-iteration, each a round trip of the whole lane
state through device memory. This module runs the ENTIRE per-sample walk
of the reference's headline volumetric benchmark scene class
(scenes/volumetric/BoundedScatteringVolume_directionalsource.xml — a
null-boundary box of heterogeneous HG medium lit by a collimated beam,
perspective camera, no other geometry) as one per-lane state machine:

  camera regeneration -> box entry -> Woodcock free flight
  (stochastic-trilinear taps) -> HG scatter with equiangular
  collimated-beam NEE -> shadow ratio tracking -> escape ->
  film accumulation -> next sample,

stepped by a while loop. A lane that finishes a sample regenerates the
next one in the same trip, so occupancy stays ~100% until a lane exhausts
its spp; the per-block tail is small because each lane's total trip count
is a SUM over sppc iid samples (CLT: the block max approaches the block
mean as spp grows). Exactly one density tap runs per trip (extension OR
shadow, selected by mode).

The per-trip body (`_trip`) is written once, on per-lane arrays, and runs
two ways:

  * in a Pallas kernel for the Triton route (`route="triton"`): each
    program owns a block of lanes whose state stays in registers as the
    loop carry; the density tap and the beam-tau row are direct indexed
    loads from the f32 grid and table in device memory (a 64^3 grid is
    1 MiB and stays L2-resident); each finished sample's RGB goes out by a
    masked store to its own (sample, lane) slot, written once, so no
    atomics are needed;
  * under jax.jit over all lanes as a plain lax.while_loop (`route="xla"`)
    — the reference for the kernel and what XLA makes of the same walk.

Estimator identity: the walk replicates integrators/wavefront.py's event
algebra for this scene class step for step — spectral Woodcock weights
(w_real/w_null against the mean-channel majorant), equiangular beam
sampling + packed beam-tau rows (volpath.py sample_beam_point /
build_beam_tau), HG sampling/eval (hg.cpp:74-107), Mitsuba-style RR
(path.cpp:200-208), depth gating, and the lane-rotation pixel mapping +
epoch film fold. The density tap is stochastic trilinear: each tap picks
ONE voxel per axis with probability equal to its trilinear weight
(corner = floor(x) + [u < frac(x)]). For delta/ratio tracking this is
exactly unbiased — every branch's probability times its weight is LINEAR
in the sampled density S (real: S*sm/maj * ss/sm = S*ss/maj; null:
(1-S*sm/maj) * (1-S*st/maj)/(1-S*sm/maj) = 1-S*st/maj; ratio factor:
1-S*st/maj), so marginalizing the per-tap jitter reproduces the
trilinear-density estimator term by term (the reference evaluates the
full stencil per tap, heterogeneous.cpp:420). Segment / tap counters
follow the wavefront engine's conventions.

Applicability is gated host-side (`supported()`): one heterogeneous
medium, all-null geometry, exactly one collimated emitter, perspective
sensor, box filter, steady state, iso/HG phase. Everything else renders
through the general engines.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ..core import kernels as kernels_m
from ..models import medium as medium_m
from ..scene.types import (
    EM_COLLIMATED,
    MED_HETEROGENEOUS,
    PH_HG,
    PH_ISOTROPIC,
    SENSOR_PERSPECTIVE,
    RenderConfig,
    Scene,
)
from . import common
from .volpath import build_beam_tau, get_beam

BEAM_N = 256          # beam-tau table rows (volpath.build_beam_tau)
BEAM_W = 8            # floats per beam-tau row

# params vector layout (f32)
_P_CAMR = 0           # 0:9   camera rotation, row major
_P_CAMO = 9           # 9:12  camera origin
_P_TANX = 12
_P_TANY = 13
_P_BMIN = 14          # 14:17 box aabb min
_P_BMAX = 17          # 17:20 box aabb max
_P_BEAMO = 20        # beam origin
_P_BEAMD = 23        # beam direction
_P_BEAMP = 26        # beam power
_P_BS0 = 29
_P_BS1 = 30
_P_G = 31            # HG g (0 => isotropic)
_P_SSU = 32          # 32:35 sigma_s (unscaled: sigma_s(y) = ssu*dens_tab)
_P_STCS = 35         # 35:38 sigma_t color * scale (null factors)
_P_STMS = 38         # sigma_t mean * scale (collision test)
_P_MAJ = 39          # media.majorant * max(sigma_t color) (world units)
_P_DMIN = 40         # 40:43 density aabb min
_P_INVH = 43         # 43:46 (res-1)/extent per axis
_P_WR = 46           # 46:49 w_real = sigma_s / sigma_t_mean
_P_EPS = 49
_P_NP = 64           # padded to a power of two

# mode of a lane
_REGEN, _TRACK, _SHADOW, _DONE = 0, 1, 2, 3


def supported(scene: Scene, cfg: RenderConfig) -> bool:
    """Host-side gate (needs concrete scene values)."""
    import numpy as np

    try:
        if cfg.engine not in ("wavefront", "auto"):
            return False
        if cfg.integrator not in ("volpath", "volpath_simple"):
            return False
        if cfg.filter != "box" or cfg.n_frames != 1:
            return False
        if cfg.decomposition != "steadystate":
            return False
        em_kind = np.asarray(scene.emitters.kind)
        if not (em_kind.size == 1 and em_kind[0] == EM_COLLIMATED):
            return False
        if int(np.asarray(scene.sensor.kind)) != SENSOR_PERSPECTIVE:
            return False
        med_kind = np.asarray(scene.media.kind)
        if not (med_kind.size == 1 and med_kind[0] == MED_HETEROGENEOUS):
            return False
        ph = int(np.asarray(scene.media.phase.kind)[0])
        if ph not in (PH_HG, PH_ISOTROPIC):
            return False
        sb = np.asarray(scene.shapes.bsdf)
        if sb.size and np.any(sb >= 0):
            return False
        if int(np.asarray(scene.camera_medium)) != -1:
            return False
        return True
    except Exception:
        return False


def _hash(x):
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0x846CA68B)
    x = x ^ (x >> 16)
    return x


def _unif(bits):
    return (bits >> jnp.uint32(8)).astype(jnp.int32).astype(jnp.float32) \
        * jnp.float32(5.9604644775390625e-08)


class _Static(NamedTuple):
    """Static (hashable) walk settings."""
    sppc: int
    max_depth: int
    rr_depth: int
    width: int
    height: int
    npix: int
    stride: int
    res: tuple            # density grid (nx, ny, nz)


class _Lane(NamedTuple):
    """Per-lane walk state; every leaf has the lane shape."""
    m: jnp.ndarray        # int32 mode (_REGEN/_TRACK/_SHADOW/_DONE)
    t: jnp.ndarray
    t_end: jnp.ndarray
    depth: jnp.ndarray    # int32
    idx: jnp.ndarray      # int32 current sample index (-1 before the first)
    sh_seg: jnp.ndarray
    sh_t: jnp.ndarray
    cont_ok: jnp.ndarray  # int32 flag: resume the stashed scatter after NEE
    segs: jnp.ndarray     # int32 traced segments
    taps: jnp.ndarray     # int32 density taps
    ctr: jnp.ndarray      # uint32 RNG counter
    p: tuple
    d: tuple
    tp: tuple
    L: tuple
    sh_o: tuple
    sh_d: tuple
    sh_tr: tuple
    sh_val: tuple
    cont_p: tuple
    cont_d: tuple


def _init_lanes(shape) -> _Lane:
    f0 = jnp.zeros(shape, jnp.float32)
    i0 = jnp.zeros(shape, jnp.int32)
    v0 = (f0, f0, f0)
    one = jnp.ones(shape, jnp.float32)
    return _Lane(m=i0, t=f0, t_end=f0, depth=i0,
                 idx=jnp.full(shape, -1, jnp.int32), sh_seg=f0, sh_t=f0,
                 cont_ok=i0, segs=i0, taps=i0,
                 ctr=jnp.zeros(shape, jnp.uint32),
                 p=v0, d=(one, one, one), tp=v0, L=v0, sh_o=v0, sh_d=v0,
                 sh_tr=v0, sh_val=v0, cont_p=v0, cont_d=v0)


def _w3(c, a, b):
    return tuple(jnp.where(c, a[i], b[i]) for i in range(3))


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _max3(a):
    return jnp.maximum(jnp.maximum(a[0], a[1]), a[2])


def _trip(s: _Lane, P, fetch_dens, fetch_beam, lane, seed, S: _Static):
    """One trip of every lane's state machine. P(i) reads params scalar i;
    fetch_dens / fetch_beam load the flat density grid / beam table at an
    int32 index array. Returns (state, finished, sample index, radiance):
    lanes with `finished` set completed sample `idx` with radiance L."""
    nx, ny, nz = S.res

    def P3(i):
        return (P(i), P(i + 1), P(i + 2))

    camR = [P(_P_CAMR + i) for i in range(9)]
    g = P(_P_G)
    g_safe = jnp.where(jnp.abs(g) < 1e-4, jnp.float32(1.0), g)
    stm_s = P(_P_STMS)
    maj = jnp.maximum(P(_P_MAJ), 1e-12)
    stc_s = P3(_P_STCS)
    ssu = P3(_P_SSU)
    w_real = P3(_P_WR)
    eps = P(_P_EPS)
    bmin = P3(_P_BMIN)
    bmax = P3(_P_BMAX)
    dmin = P3(_P_DMIN)
    invh = P3(_P_INVH)
    beam_o = P3(_P_BEAMO)
    beam_d = P3(_P_BEAMD)
    beam_pw = P3(_P_BEAMP)
    bs0 = P(_P_BS0)
    bs1 = P(_P_BS1)
    INV4PI = jnp.float32(0.07957747154594767)
    zero = jnp.zeros(lane.shape, jnp.float32)

    def hg_eval(cos_fwd):
        """phase eval with cos_forward = dot(wi, wo) (phase.py:76-82)."""
        temp = jnp.maximum(1.0 + g * g - 2.0 * g * cos_fwd, 1e-12)
        v = INV4PI * (1.0 - g * g) / (temp * jnp.sqrt(temp))
        return jnp.where(jnp.abs(g) < 1e-4, INV4PI, v)

    def ray_aabb(o, d):
        t0 = t1 = None
        for a in range(3):
            inv = 1.0 / jnp.where(jnp.abs(d[a]) < 1e-12,
                                  jnp.where(d[a] < 0, -1e-12, 1e-12), d[a])
            ta = (bmin[a] - o[a]) * inv
            tb = (bmax[a] - o[a]) * inv
            lo, hi = jnp.minimum(ta, tb), jnp.maximum(ta, tb)
            t0 = lo if t0 is None else jnp.maximum(t0, lo)
            t1 = hi if t1 is None else jnp.minimum(t1, hi)
        return t0, t1

    def tap(pos, u3):
        inside = None
        cell = []
        for a, n_a in enumerate((nx, ny, nz)):
            hi = jnp.float32(n_a - 1)
            x = (pos[a] - dmin[a]) * invh[a]
            ok = (x >= 0.0) & (x <= hi)
            inside = ok if inside is None else inside & ok
            x = jnp.clip(x, 0.0, hi)
            base = jnp.floor(x)
            c = base + (u3[a] < x - base).astype(jnp.float32)
            cell.append(jnp.minimum(c, hi).astype(jnp.int32))
        S_ = fetch_dens((cell[2] * ny + cell[1]) * nx + cell[0])
        return jnp.where(inside, S_, 0.0)

    m0 = s.m                                  # mode at trip start
    bits = (lane.astype(jnp.uint32) ^ jnp.uint32(0x9E3779B9)) \
        + s.ctr * jnp.uint32(0x85EBCA6B) + seed
    u = []
    for k in range(9):
        bits = _hash(bits + jnp.uint32((0x68E31DA4 + 0x3504F333 * k)
                                       & 0xFFFFFFFF))
        u.append(_unif(bits))
    ctr = s.ctr + jnp.where(s.m < _DONE, 9, 0).astype(jnp.uint32)

    # ================= regenerate =================
    regen = s.m == _REGEN
    has_more = s.idx + 1 < S.sppc
    start = regen & has_more
    m = jnp.where(regen & ~has_more, _DONE, s.m)
    idx = s.idx + jnp.where(start, 1, 0)
    pix = (lane + idx * S.stride) % S.npix
    fx = (pix % S.width).astype(jnp.float32) + u[0]
    fy = (pix // S.width).astype(jnp.float32) + u[1]
    dc_x = -(2.0 * fx / jnp.float32(S.width) - 1.0) * P(_P_TANX)
    dc_y = -(2.0 * fy / jnp.float32(S.height) - 1.0) * P(_P_TANY)
    dw = tuple(camR[3 * a] * dc_x + camR[3 * a + 1] * dc_y + camR[3 * a + 2]
               for a in range(3))
    inv_n = 1.0 / jnp.sqrt(_dot3(dw, dw))
    dw = tuple(c * inv_n for c in dw)
    ow = tuple(c + zero for c in P3(_P_CAMO))
    t0c, t1c = ray_aabb(ow, dw)
    t0c = jnp.maximum(t0c, 0.0)
    hitbox = (t1c > t0c + 2.0 * eps) & start
    p = _w3(start, tuple(ow[a] + (t0c + eps) * dw[a] for a in range(3)), s.p)
    d = _w3(start, dw, s.d)
    t = jnp.where(start, 0.0, s.t)
    t_end = jnp.where(start, t1c - t0c - 2.0 * eps, s.t_end)
    tp = _w3(start, (1.0, 1.0, 1.0), s.tp)
    depth = jnp.where(start, 1, s.depth)
    L = _w3(start, (0.0, 0.0, 0.0), s.L)
    m = jnp.where(hitbox, _TRACK, m)      # miss: stays REGEN (L=0 sample)
    segs = s.segs + jnp.where(start, 1, 0) + jnp.where(hitbox, 1, 0)

    # ============ one density tap serves extension OR shadow ============
    trk = m == _TRACK
    shd = m0 == _SHADOW
    jump = -jnp.log(jnp.maximum(1.0 - u[2], 1e-12)) / maj
    t_new = t + jump
    sh_new = s.sh_t + jump
    pos = tuple(jnp.where(shd, s.sh_o[a] + sh_new * s.sh_d[a],
                          p[a] + t_new * d[a]) for a in range(3))
    Sd = tap(pos, (u[3], u[4], u[5]))
    taps = s.taps + jnp.where(trk | shd, 1, 0)

    # ================= extension =================
    esc = t_new >= t_end
    p_real = Sd * stm_s / maj
    real = trk & (u[6] < p_real) & ~esc
    nullc = trk & ~esc & ~real
    factor = tuple(jnp.maximum(1.0 - Sd * c / maj, 0.0) for c in stc_s)
    inv_pn = 1.0 / jnp.maximum(1.0 - p_real, 1e-12)
    tp = _w3(nullc, tuple(tp[a] * factor[a] * inv_pn for a in range(3)), tp)
    t = jnp.where(trk, jnp.minimum(t_new, t_end), t)
    fin_esc = trk & esc
    segs = segs + jnp.where(fin_esc, 1, 0)        # vacuum exit leg

    x = tuple(p[a] + t * d[a] for a in range(3))
    tp = _w3(real, tuple(tp[a] * w_real[a] for a in range(3)), tp)
    depth_ok = depth < S.max_depth
    die_depth = real & ~depth_ok

    # ---- beam NEE (equiangular, volpath.py sample_beam_point) ----
    delta = _dot3(tuple(x[a] - beam_o[a] for a in range(3)), beam_d)
    closest = tuple(beam_o[a] + delta * beam_d[a] for a in range(3))
    off = tuple(x[a] - closest[a] for a in range(3))
    hdist = jnp.sqrt(jnp.maximum(_dot3(off, off), 1e-12))
    th_a = jnp.arctan2(bs0 - delta, hdist)
    th_b = jnp.arctan2(bs1 - delta, hdist)
    th = th_a + u[7] * (th_b - th_a)
    s_rel = hdist * jnp.tan(th)
    s_b = delta + s_rel
    pdf_sb = hdist / jnp.maximum(
        (th_b - th_a) * (hdist * hdist + s_rel * s_rel), 1e-12)
    y = tuple(beam_o[a] + s_b * beam_d[a] for a in range(3))
    to_x = tuple(x[a] - y[a] for a in range(3))
    dist_b = jnp.sqrt(jnp.maximum(_dot3(to_x, to_x), 1e-12))
    d_yp = tuple(c / dist_b for c in to_x)
    fb = (s_b - bs0) / jnp.maximum(bs1 - bs0, 1e-9) \
        * jnp.float32(BEAM_N) - 0.5
    fb = jnp.clip(fb, 0.0, jnp.float32(BEAM_N - 1))
    ib = jnp.floor(fb)
    frb = fb - ib
    row0 = ib.astype(jnp.int32) * BEAM_W
    brow = [fetch_beam(row0 + r) for r in range(7)]
    sigs_y = brow[6]                       # table density already scaled
    rho_y = hg_eval(_dot3(beam_d, d_yp))
    f_x = hg_eval(-_dot3(d, d_yp))
    geom = rho_y / jnp.maximum(pdf_sb * dist_b * dist_b, 1e-12)
    val = []
    for a in range(3):
        tau_b = jnp.where(s_b < bs0, 0.0, brow[a] + brow[3 + a] * frb)
        val.append(tp[a] * f_x * beam_pw[a] * jnp.exp(-tau_b)
                   * ssu[a] * sigs_y * geom)
    val = tuple(val)
    nee_ok = real & depth_ok & (_max3(val) > 0.0)

    # ---- HG/iso continuation direction ----
    sqr = (1.0 - g * g) / (1.0 - g + 2.0 * g * u[0])
    cth_a = (1.0 + g * g - sqr * sqr) / (2.0 * g_safe)
    cth = jnp.where(jnp.abs(g) < 1e-4, 1.0 - 2.0 * u[0], cth_a)
    sth = jnp.sqrt(jnp.maximum(1.0 - cth * cth, 0.0))
    phi = jnp.float32(6.283185307179586) * u[1]
    lx = sth * jnp.cos(phi)
    ly = sth * jnp.sin(phi)
    sgn = jnp.where(d[2] >= 0.0, 1.0, -1.0)
    a_f = -1.0 / (sgn + d[2])
    b_f = d[0] * d[1] * a_f
    new_d = (lx * (1.0 + sgn * d[0] * d[0] * a_f) + ly * b_f + cth * d[0],
             lx * (sgn * b_f) + ly * (sgn + d[1] * d[1] * a_f) + cth * d[1],
             lx * (-sgn * d[0]) + ly * (-d[1]) + cth * d[2])

    # ---- RR (common.russian_roulette, eta_scale=1) ----
    q = jnp.minimum(_max3(tp), 0.95)
    do_rr = depth >= S.rr_depth
    survive = ~do_rr | (u[8] < q)
    inv_q = 1.0 / jnp.maximum(q, 1e-6)
    tp = _w3(real & do_rr, tuple(c * inv_q for c in tp), tp)
    cont_after = real & depth_ok & survive
    depth = jnp.where(real & depth_ok, depth + 1, depth)

    cont_p = _w3(real, x, s.cont_p)
    cont_d = _w3(real, new_d, s.cont_d)
    cont_ok = jnp.where(real, jnp.where(cont_after, 1, 0), s.cont_ok)
    go = nee_ok
    m = jnp.where(go, _SHADOW, m)
    sh_o = _w3(go, tuple(y[a] + d_yp[a] * eps for a in range(3)), s.sh_o)
    sh_d = _w3(go, d_yp, s.sh_d)
    sh_seg = jnp.where(go, dist_b - 2.0 * eps, s.sh_seg)
    sh_t = jnp.where(go, 0.0, s.sh_t)
    sh_tr = _w3(go, (1.0, 1.0, 1.0), s.sh_tr)
    sh_val = _w3(go, val, s.sh_val)
    segs = segs + jnp.where(go, 1, 0)
    resume_now = real & ~nee_ok & cont_after
    die_now = (real & ~nee_ok & ~cont_after) | die_depth

    # ================= shadow (trip-start lanes) ============
    sh_esc = sh_new >= sh_seg
    upd = shd & ~sh_esc
    sh_tr = _w3(upd, tuple(sh_tr[a] * factor[a] for a in range(3)), sh_tr)
    sh_t = jnp.where(shd, jnp.minimum(sh_new, sh_seg), sh_t)
    tr_dead = _max3(sh_tr) <= 0.0
    sh_done = shd & (sh_esc | tr_dead)
    add = sh_done & ~tr_dead
    L = tuple(L[a] + jnp.where(add, sh_val[a] * sh_tr[a], 0.0)
              for a in range(3))
    res_sh = sh_done & (cont_ok > 0)
    die_sh = sh_done & ~(cont_ok > 0)

    # ---- resume the stashed continuation ----
    res_any = resume_now | res_sh
    p = _w3(res_any, tuple(cont_p[a] + cont_d[a] * eps for a in range(3)), p)
    d = _w3(res_any, cont_d, d)
    _, t1r = ray_aabb(p, d)
    t = jnp.where(res_any, 0.0, t)
    t_end = jnp.where(res_any, jnp.maximum(t1r - eps, 0.0), t_end)
    m = jnp.where(res_any, _TRACK, m)
    segs = segs + jnp.where(res_any, 1, 0)

    # ---- finished samples leave; the lane regenerates next trip ----
    fin = fin_esc | die_now | die_sh
    L_fin = L
    m = jnp.where(fin, _REGEN, m)
    L = _w3(fin, (0.0, 0.0, 0.0), L)

    st = _Lane(m=m, t=t, t_end=t_end, depth=depth, idx=idx, sh_seg=sh_seg,
               sh_t=sh_t, cont_ok=cont_ok, segs=segs, taps=taps, ctr=ctr,
               p=p, d=d, tp=tp, L=L, sh_o=sh_o, sh_d=sh_d, sh_tr=sh_tr,
               sh_val=sh_val, cont_p=cont_p, cont_d=cont_d)
    return st, fin, idx, L_fin


def _not_done(st: _Lane):
    return jnp.min(st.m) < _DONE


def _kernel(S, max_trips, params_ref, seed_ref, dens_ref, beam_ref,
            film_in_ref, film_ref, stats_ref):
    """One program: a block of B lanes walks until all its lanes are done.
    film_ref (aliased to the zero-filled film_in_ref) is the flat
    (sppc, 3, npad) radiance table; stats_ref rows: segs, taps, trips,
    last sample index."""
    del film_in_ref
    B = stats_ref.shape[1]
    npad = film_ref.shape[0] // (3 * S.sppc)
    lane = (jax.lax.broadcasted_iota(jnp.int32, (B,), 0)
            + B * pl.program_id(0))
    seed = seed_ref[0]

    def P(i):
        return params_ref[i]

    def fetch_dens(i):
        return dens_ref[i]

    def fetch_beam(i):
        return beam_ref[i]

    def body(carry):
        trips, st = carry
        st, fin, idx, L = _trip(st, P, fetch_dens, fetch_beam, lane, seed,
                                S)
        # each (sample, lane) slot is written once; masked-off lanes keep
        # an in-range slot of their own
        slot = jnp.where(fin, idx, 0) * (3 * npad) + lane
        for c in range(3):
            pl_triton.store(film_ref.at[slot + c * npad], L[c], mask=fin)
        return trips + 1, st

    def cond(carry):
        return (carry[0] < max_trips) & _not_done(carry[1])

    trips, st = jax.lax.while_loop(
        cond, body, (jnp.int32(0), _init_lanes((B,))))
    stats_ref[0, :] = st.segs.astype(jnp.float32)
    stats_ref[1, :] = st.taps.astype(jnp.float32)
    stats_ref[2, :] = jnp.full((B,), trips.astype(jnp.float32))
    stats_ref[3, :] = st.idx.astype(jnp.float32)


def _walk_xla(S, max_trips, params, seed, dens, beam):
    """The same walk over all npix lanes as one plain lax.while_loop."""
    n = S.npix
    lane = jnp.arange(n, dtype=jnp.int32)
    film = jnp.zeros((S.sppc * 3 * n,), jnp.float32)

    def body(carry):
        trips, st, film = carry
        st, fin, idx, L = _trip(st, lambda i: params[i], lambda i: dens[i],
                                lambda i: beam[i], lane, seed, S)
        slot = jnp.where(fin, idx * (3 * n) + lane, film.shape[0])
        for c in range(3):
            film = film.at[slot + c * n].set(L[c], mode="drop")
        return trips + 1, st, film

    def cond(carry):
        return (carry[0] < max_trips) & _not_done(carry[1])

    trips, st, film = jax.lax.while_loop(
        cond, body, (jnp.int32(0), _init_lanes((n,)), film))
    stats = jnp.stack([st.segs.astype(jnp.float32),
                       st.taps.astype(jnp.float32),
                       jnp.full((n,), trips.astype(jnp.float32)),
                       st.idx.astype(jnp.float32)])
    return film, stats


@functools.partial(jax.jit,
                   static_argnames=("cfg", "sppc", "route", "B", "interpret"),
                   keep_unused=True)
def render_boxwalk(scene: Scene, cfg: RenderConfig, sppc: int, seed,
                   pass_idx, route: str = kernels_m.TRITON, B: int = 128,
                   interpret: bool = False):
    """One sppc-sample pass; returns ((npix,3) radiance sum, stats) with
    render_wavefront-compatible stats (segments, taps, iters, unfinished).

    route: kernels_m.TRITON runs the Pallas kernel in blocks of B lanes
    (interpret=True runs it in the Pallas interpreter; B=128 measured
    faster than 256 on the H100, PERF.md); kernels_m.XLA runs the same
    per-trip body as a plain while_loop over all lanes."""
    H, W_img = cfg.height, cfg.width
    npix = H * W_img
    stride = 104729 % npix

    d = scene.media.density.data
    if d.ndim == 4:
        d = d[..., 0]
    nz, ny, nx = d.shape
    extent = scene.media.density.aabb_max - scene.media.density.aabb_min
    res_v = jnp.array([nx, ny, nz], jnp.float32)
    inv_h = jnp.maximum(res_v - 1.0, 1.0) / jnp.maximum(extent, 1e-30)
    bricks = medium_m.DensityBricks(scene.media)
    beam = get_beam(scene)
    beam_tab = build_beam_tau(scene, beam, bricks, n=BEAM_N).reshape(-1)
    _, sa, ss, _, scale = medium_m.params(
        scene.media, jnp.zeros((1,), jnp.int32))
    sa, ss, scale = sa[0], ss[0], scale[0]
    stc_u = sa + ss
    stm_u = jnp.mean(stc_u)
    majorant = jnp.maximum(scene.media.majorant * jnp.max(stc_u), 1e-6)
    w_real = ss / jnp.maximum(stm_u, 1e-12)
    eps = common.scene_epsilon(scene)
    g = scene.media.phase.g[0] \
        * (scene.media.phase.kind[0] == PH_HG).astype(jnp.float32)

    Rm = scene.sensor.to_world[:3, :3]
    cam_o = scene.sensor.to_world[:3, 3]
    params = jnp.concatenate([
        Rm.reshape(-1), cam_o,
        scene.sensor.tan_x.reshape(1), scene.sensor.tan_y.reshape(1),
        scene.aabb_min, scene.aabb_max,
        beam.o, beam.d, beam.power,
        beam.s0.reshape(1), beam.s1.reshape(1),
        g.reshape(1),
        ss, stc_u * scale,
        (stm_u * scale).reshape(1), majorant.reshape(1),
        scene.media.density.aabb_min, inv_h,
        w_real,
        eps.reshape(1),
    ]).astype(jnp.float32)
    params = jnp.pad(params, (0, _P_NP - params.shape[0]))
    dens = d.reshape(-1).astype(jnp.float32)

    seed_u = (jnp.asarray(seed, jnp.uint32)
              ^ (jnp.asarray(pass_idx, jnp.uint32)
                 * jnp.uint32(0x9E3779B9) + jnp.uint32(0x7F4A7C15)))
    S = _Static(sppc, cfg.max_depth, cfg.rr_depth, W_img, H, npix, stride,
                (nx, ny, nz))
    max_trips = sppc * (8 * cfg.max_depth + 48) + 256

    if route == kernels_m.XLA:
        film, stats = _walk_xla(S, max_trips, params, seed_u, dens, beam_tab)
        n = npix
    elif route == kernels_m.TRITON:
        n = -(-npix // B) * B
        film_spec = pl.BlockSpec((sppc * 3 * n,), lambda i: (0,))
        film, stats = pl.pallas_call(
            functools.partial(_kernel, S, max_trips),
            grid=(n // B,),
            out_shape=(
                jax.ShapeDtypeStruct((sppc * 3 * n,), jnp.float32),
                jax.ShapeDtypeStruct((4, n), jnp.float32),
            ),
            in_specs=[
                pl.BlockSpec((_P_NP,), lambda i: (0,)),
                pl.BlockSpec((1,), lambda i: (0,)),
                pl.BlockSpec(dens.shape, lambda i: (0,)),
                pl.BlockSpec(beam_tab.shape, lambda i: (0,)),
                film_spec,
            ],
            out_specs=(film_spec, pl.BlockSpec((4, B), lambda i: (0, i))),
            input_output_aliases={4: 0},
            compiler_params=pl_triton.CompilerParams(num_warps=4,
                                                     num_stages=1),
            backend="triton",
            interpret=interpret,
            name="boxwalk",
        )(params, jnp.reshape(seed_u, (1,)), dens, beam_tab,
          jnp.zeros((sppc * 3 * n,), jnp.float32))
    else:
        raise ValueError(f"route={route!r}")

    pend = film.reshape(sppc, 3, n)[:, :, :npix]
    L = jnp.zeros((npix, 3), jnp.float32)
    for j in range(sppc):
        L = L + jnp.roll(jnp.transpose(pend[j]), j * stride, axis=0)
    stats = stats[:, :npix]
    segs = jnp.sum(stats[0].astype(jnp.int32)).astype(jnp.uint32)
    taps = jnp.sum(stats[1].astype(jnp.int32)).astype(jnp.uint32)
    iters = jnp.max(stats[2]).astype(jnp.int32)
    unfinished = jnp.sum(stats[3] < (sppc - 1)).astype(jnp.uint32)
    return L, (segs, taps, iters, unfinished)
