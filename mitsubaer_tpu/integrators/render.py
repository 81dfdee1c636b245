"""Render driver: pixels -> camera rays -> integrator -> filtered film.

Replaces the reference's RenderJob/BlockedRenderProcess/Scheduler pipeline
(renderjob.cpp, renderproc.cpp, sched.cpp): there are no work units — the
whole image is one wavefront, jitted once, looped over spp passes on the
host with a donated film accumulator. Multi-chip sharding wraps this same
pass function in shard_map (parallel/driver.py).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..core import rng
from ..models import film as film_m
from ..models import sensor as sensor_m
from ..scene.types import RenderConfig, Scene
from . import path as path_m


def get_integrator(name: str):
    if name == "path":
        return path_m.li
    if name in ("volpath", "volpath_simple"):
        from . import volpath as volpath_m

        return functools.partial(volpath_m.li, simple=name.endswith("simple"))
    if name == "volpath_er":
        from . import volpath_er as er_m

        return er_m.li
    if name == "direct":
        return functools.partial(path_m.li, )  # direct = path with maxDepth 2
    if name == "ao":
        from . import misc as misc_m

        return misc_m.ao_li
    if name == "field":
        from . import misc as misc_m

        return misc_m.field_li
    raise ValueError(f"unknown integrator {name}")


def _sampler_mode(name: str) -> int:
    return rng.MODES.get(name, rng.INDEPENDENT)


@functools.partial(jax.jit,
                   static_argnames=("cfg", "sppc", "has_direct", "any_het"),
                   keep_unused=True)
def render_pass_wavefront(scene: Scene, accum_L, cfg: RenderConfig, sppc: int,
                          seed, pass_idx, has_direct: bool = True,
                          any_het: bool = True):
    """One spp chunk through the persistent-wavefront engine
    (integrators/wavefront.py). accum_L is a (npix, 3) radiance sum; divide
    by total spp to develop. Returns (accum_L, stats).

    (keep_unused=True: see note above render_pass.)"""
    from . import wavefront as wf_m

    L, stats = wf_m.render_wavefront(
        scene, cfg, sppc, seed, pass_idx, has_direct=has_direct,
        any_het=any_het)
    return accum_L + L, stats


def _any_het(scene) -> bool:
    import numpy as np

    from ..scene.types import MED_HETEROGENEOUS

    return bool(np.any(np.asarray(scene.media.kind) == MED_HETEROGENEOUS))


def _use_wavefront(cfg: RenderConfig) -> bool:
    if cfg.engine == "wavefront2":
        raise ValueError(
            "engine='wavefront2' (grouped-tile engine) was a measured"
            " negative result (2.5x slower, PERF.md) and now lives in"
            " experiments/wavefront2.py; use engine='wavefront'")
    if cfg.engine == "wavefront":
        return True
    if cfg.engine == "loop":
        return False
    return (cfg.integrator in ("volpath", "path")
            and cfg.n_frames == 1 and cfg.modulation == "none"
            and cfg.filter == "box")


def _has_direct(scene) -> bool:
    import numpy as np

    from ..scene.types import EM_COLLIMATED

    kinds = np.asarray(scene.emitters.kind)
    return bool(np.any(kinds != EM_COLLIMATED)) and kinds.size > 0


# NOTE: keep_unused=True everywhere a full Scene pytree is an argument: jax
# 0.9's dropped-unused-argument bookkeeping diverges between the compiled
# executable and the C++ fastpath dispatch once several such jits coexist
# ("Execution supplied N buffers but compiled program expected N+k").
@functools.partial(jax.jit, static_argnames=("cfg", "sppc"), keep_unused=True)
def render_pass(scene: Scene, accum, cfg: RenderConfig, sppc: int, seed, pass_idx):
    """One spp chunk: sppc samples for every pixel."""
    H, W = cfg.height, cfg.width
    npix = H * W
    pixel = jnp.tile(jnp.arange(npix, dtype=jnp.uint32), (sppc,))
    sample_index = jnp.repeat(
        pass_idx * sppc + jnp.arange(sppc, dtype=jnp.uint32), npix
    )
    smp = rng.make_sampler(seed, pixel, sample_index,
                           mode=_sampler_mode(cfg.sampler), n_samples=cfg.spp)

    jitter, smp = rng.next_2d(smp)  # position inside pixel (film dimension 0)
    u_lens, smp = rng.next_2d(smp)  # aperture sample (thin lens)
    px = (pixel % W).astype(jnp.float32) + jitter[:, 0]
    py = (pixel // W).astype(jnp.float32) + jitter[:, 1]
    rays = sensor_m.sample_rays(scene.sensor, px, py, W, H, u_lens=u_lens,
                                kind_hint=(cfg.sensor_kind
                                           if cfg.sensor_kind >= 0 else None))

    if cfg.integrator == "direct":
        cfg = cfg._replace(max_depth=2, integrator="path")
    integrator = get_integrator(cfg.integrator)
    if cfg.integrator == "field":
        sink, _ = integrator(scene, cfg, rays.o, rays.d, smp, pixel=pixel,
                             field=cfg.field)
    else:
        sink, _ = integrator(scene, cfg, rays.o, rays.d, smp, pixel=pixel)

    values = sink.steady.reshape(sppc, H, W, 3)
    jit_r = jitter.reshape(sppc, H, W, 2)
    if cfg.n_frames == 1:
        accum = film_m.splat(accum, values, jit_r, cfg.filter)
    else:
        # steady part of the sink is still splatted into frame 0 (e.g. CW-ToF
        # collapses to one frame); time-binned contributions land directly.
        accum = film_m.splat(accum, values, jit_r, cfg.filter)
        if sink.frames is not None:
            fr = sink.frames.reshape(H, W, cfg.n_frames * 3)
            # box-accumulated bins: weight channel already counts samples via
            # the steady splat; frames are averaged by the same weight.
            accum = accum.at[..., 0 : cfg.n_frames * 3].add(fr)
    return accum


@functools.partial(jax.jit, static_argnames=("cfg", "n_samples"), keep_unused=True)
def beam_splat_pass(scene: Scene, splat, cfg: RenderConfig, n_samples: int,
                    seed, pass_idx):
    """Single-scatter light-tracing splat for collimated beam emitters: the
    (emitter -> y -> camera) family has measure zero under camera-side
    sampling (the beam is delta in position+direction), so we integrate it
    directly along the beam: equiangular w.r.t. the camera, project y to the
    film, splat

        power * Tr(o_b, y) * sigma_s(y) * rho(w_b -> y->cam) * Tr(y, cam)
            / (d^2 * pdf(s))

    This is the camera-side equivalent of the reference BDPT's (s=2, t=1)
    light-image connections (bdpt_proc.cpp light-image splatting)."""
    from ..core.math import dot as _dot
    from ..models import medium as medium_m
    from ..models import phase as phase_m
    from . import common, volpath as volpath_m

    H, W = cfg.height, cfg.width
    beam = volpath_m.get_beam(scene)
    eps = common.scene_epsilon(scene)
    lane = jnp.arange(n_samples, dtype=jnp.uint32)
    smp = rng.make_sampler(seed ^ jnp.uint32(0xBEA11), lane, pass_idx)
    u, smp = rng.next_1d(smp)

    cam = jnp.broadcast_to(scene.sensor.to_world[:3, 3], (n_samples, 3))
    y, sdist, pdf_s, dist, d_yc = volpath_m.sample_beam_point(beam, cam, u)
    active = jnp.broadcast_to(beam.exists, (n_samples,))

    media = scene.media
    bmed = jnp.broadcast_to(beam.medium, (n_samples,))
    from ..scene.types import MED_HETEROGENEOUS

    kind, sa, ss, _, scale = medium_m.params(media, bmed)
    dens = jnp.where(
        kind == MED_HETEROGENEOUS,
        medium_m.density_at(media, y) * scale,
        jnp.ones((n_samples,)),
    )
    sigma_s_y = ss * dens[..., None]
    rho = phase_m.eval(media.phase, bmed, jnp.broadcast_to(beam.d, (n_samples, 3)), d_yc)

    bricks = medium_m.DensityBricks(scene.media)
    tau = volpath_m.build_beam_tau(scene, beam, bricks)
    tr1 = volpath_m.beam_transmittance(beam, tau, sdist)
    tr2, smp = volpath_m.attenuated_visibility(
        scene, eps, y + d_yc * eps, d_yc, dist - 2 * eps, bmed, smp, active,
        bricks=bricks,
    )
    value = (
        beam.power * tr1 * sigma_s_y * tr2
        * (rho / jnp.maximum(pdf_s * dist * dist, 1e-12))[..., None]
    )

    fs = sensor_m.project(scene.sensor, y, W, H)
    value = value * fs.inv_pixel_omega[..., None]
    ok = active & fs.valid & jnp.all(jnp.isfinite(value), axis=-1)
    value = jnp.where(ok[..., None], value, 0.0)
    px = jnp.clip(fs.px.astype(jnp.int32), 0, W - 1)
    py = jnp.clip(fs.py.astype(jnp.int32), 0, H - 1)
    pix = py * W + px

    if cfg.n_frames == 1:
        flat = splat.reshape(H * W, 3)
        flat = flat.at[pix].add(value)
        return flat.reshape(H, W, 3)
    else:
        plen = sdist + dist
        key = plen if cfg.decomposition != "bounce" else jnp.full_like(plen, 2.0)
        b = jnp.floor((key - cfg.min_bound) / cfg.bin_width).astype(jnp.int32)
        inside = (key >= cfg.min_bound) & (key < cfg.max_bound) & ok
        b = jnp.clip(b, 0, cfg.n_frames - 1)
        flat = splat.reshape(H * W, cfg.n_frames, 3)
        flat = flat.at[pix, b].add(jnp.where(inside[..., None], value, 0.0))
        return flat.reshape(H, W, cfg.n_frames * 3)


def _has_beam(scene) -> bool:
    import numpy as np

    from ..scene.types import EM_COLLIMATED

    return bool(np.any(np.asarray(scene.emitters.kind) == EM_COLLIMATED))


def render(scene: Scene, cfg: RenderConfig = None, spp: int = None, seed: int = 0,
           spp_per_pass: int = None, checkpoint_path: str = None,
           checkpoint_every: int = 0):
    """Render to a developed (H, W, 3*F) image.

    checkpoint_path/_every: optional resumable rendering — the accumulator +
    pass counter are persisted and reloaded (counter-based RNG makes the
    resumed render identical to an uninterrupted one)."""
    from ..utils import stats

    if cfg is None and isinstance(scene, tuple) and len(scene) == 2:
        scene, cfg = scene  # accept the (scene, cfg) pair presets return
    if cfg is None:
        cfg = RenderConfig()
    if spp is not None:
        cfg = cfg._replace(spp=spp)
    npix = cfg.width * cfg.height
    if cfg.integrator == "ptracer":
        from . import ptracer as ptracer_m

        with stats.timed("render.wall"):
            img = ptracer_m.render_ptracer(scene, cfg, seed=seed)
        return img
    if cfg.integrator == "vpl":
        from . import vpl as vpl_m

        with stats.timed("render.wall"):
            img = vpl_m.render_vpl(scene, cfg, seed=seed)
        return img
    if cfg.integrator == "bdpt":
        from . import bdpt as bdpt_m

        with stats.timed("render.wall"):
            img = bdpt_m.render_bdpt(scene, cfg, seed=seed)
        return img
    if cfg.integrator in ("pssmlt", "pssmlt_volpath", "mlt"):
        from . import pssmlt as pssmlt_m

        with stats.timed("render.wall"):
            img = pssmlt_m.render_pssmlt(scene, cfg, seed=seed)
        return img
    if cfg.integrator == "erpt":
        from . import erpt as erpt_m

        with stats.timed("render.wall"):
            img = erpt_m.render_erpt(scene, cfg, seed=seed)
        return img
    if cfg.integrator == "singlescatter":
        from . import singlescatter as ss_m

        with stats.timed("render.wall"):
            img = ss_m.render_singlescatter(scene, cfg, seed=seed)
        return img
    if cfg.integrator == "singlescatter_mesh":
        from . import singlescatter as ss_m

        with stats.timed("render.wall"):
            img = ss_m.render_singlescatter_mesh(scene, cfg, seed=seed)
        return img
    if cfg.integrator == "dipole":
        from . import dipole as dip_m

        with stats.timed("render.wall"):
            img = dip_m.render_dipole(scene, cfg, seed=seed)
        return img
    if cfg.integrator in ("photonmapper", "ppm", "sppm"):
        from . import photonmap as photonmap_m

        with stats.timed("render.wall"):
            img = photonmap_m.render_photonmap(scene, cfg, seed=seed)
        return img
    if cfg.integrator == "bre":
        from . import bre as bre_m

        with stats.timed("render.wall"):
            img = bre_m.render_bre(scene, cfg, seed=seed)
        return img
    if cfg.integrator == "irrcache":
        from . import irrcache as irr_m

        with stats.timed("render.wall"):
            img = irr_m.render_irrcache(scene, cfg, seed=seed)
        return img
    if spp_per_pass is None:
        # bound wavefront to ~2^21 lanes to fit memory comfortably
        spp_per_pass = max(1, min(cfg.spp, (1 << 21) // max(npix, 1)))
    if _use_wavefront(cfg):
        from ..core import kernels as kernels_m
        from . import boxwalk as bw_m

        hd = _has_direct(scene)
        use_bw = (kernels_m.route(cfg.kernels) == kernels_m.TRITON
                  and bw_m.supported(scene, cfg))
        L = jnp.zeros((cfg.height * cfg.width, 3), jnp.float32)
        segs = jnp.zeros((), jnp.uint32)
        done = 0
        pass_idx = 0
        if spp_per_pass is None:
            # big per-pass sample budgets amortize the wavefront tail (the
            # final samples of a pass run at decaying occupancy)
            spp_per_pass = max(1, min(cfg.spp, 64 if use_bw else 16))
        with stats.timed("render.wall"):
            while done < cfg.spp:
                sppc = min(spp_per_pass, cfg.spp - done)
                if use_bw:
                    # whole-path kernel for the bounded-volume scene class
                    # (integrators/boxwalk.py)
                    Lb, st = bw_m.render_boxwalk(
                        scene, cfg, sppc, jnp.asarray(seed, jnp.uint32),
                        jnp.asarray(pass_idx, jnp.uint32))
                    L = L + Lb
                else:
                    L, st = render_pass_wavefront(
                        scene, L, cfg, sppc, jnp.asarray(seed, jnp.uint32),
                        jnp.asarray(pass_idx, jnp.uint32), has_direct=hd,
                        any_het=_any_het(scene))
                segs = segs + st[0]
                done += sppc
                pass_idx += 1
                stats.counter_add("render.passes")
                stats.counter_add("render.camera_rays",
                                  cfg.width * cfg.height * sppc)
            stats.counter_add("render.segments", int(segs))
        img = (L / jnp.float32(cfg.spp)).reshape(cfg.height, cfg.width, 3)
        if cfg.integrator.startswith("volpath") and _has_beam(scene):
            n_splat = 4 * npix
            splat = jnp.zeros((cfg.height, cfg.width, cfg.n_frames * 3),
                              jnp.float32)
            n_passes = 4
            for i in range(n_passes):
                splat = beam_splat_pass(
                    scene, splat, cfg, n_splat,
                    jnp.asarray(seed, jnp.uint32), jnp.asarray(i, jnp.uint32))
            img = img + splat / (n_splat * n_passes)
        return img

    accum = film_m.new_accumulator(cfg)
    done = 0
    pass_idx = 0
    if checkpoint_path:
        from ..utils import checkpoint as ckpt

        st = ckpt.load_render_state(checkpoint_path)
        if st is not None:
            accum, pass_idx, seed, _ = st
            accum = jnp.asarray(accum)
            done = min(pass_idx * spp_per_pass, cfg.spp)
    with stats.timed("render.wall"):
        while done < cfg.spp:
            sppc = min(spp_per_pass, cfg.spp - done)
            accum = render_pass(
                scene, accum, cfg, sppc,
                jnp.asarray(seed, jnp.uint32), jnp.asarray(pass_idx, jnp.uint32),
            )
            done += sppc
            pass_idx += 1
            stats.counter_add("render.passes")
            stats.counter_add("render.camera_rays", npix * sppc)
            if checkpoint_path and checkpoint_every and pass_idx % checkpoint_every == 0:
                from ..utils import checkpoint as ckpt

                ckpt.save_render_state(checkpoint_path, accum, pass_idx, seed, cfg)
    img = film_m.develop(accum)

    if cfg.integrator.startswith("volpath") and _has_beam(scene):
        n_splat = 4 * npix
        splat = jnp.zeros((cfg.height, cfg.width, cfg.n_frames * 3), jnp.float32)
        n_passes = 4
        for i in range(n_passes):
            splat = beam_splat_pass(
                scene, splat, cfg, n_splat,
                jnp.asarray(seed, jnp.uint32), jnp.asarray(i, jnp.uint32),
            )
        img = img + splat / (n_splat * n_passes)
    return img
