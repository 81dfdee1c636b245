"""Miscellaneous integrators: ambient occlusion + field extraction.

Reference: src/integrators/direct/ao.cpp and src/integrators/misc/field.cpp
(used with the multichannel integrator for AOV outputs)."""
from __future__ import annotations

import jax.numpy as jnp

from ..core import rng, warp
from ..core.math import Frame
from ..scene import intersect as isect
from ..scene.types import RenderConfig, Scene
from . import common


def ao_li(scene: Scene, cfg: RenderConfig, o, d, sampler, pixel=None,
          ray_length_frac: float = 0.05, n_samples: int = 4):
    """Ambient occlusion (ao.cpp): cosine-hemisphere visibility with a ray
    length proportional to the scene extent."""
    n = o.shape[0]
    eps = common.scene_epsilon(scene)
    diag = jnp.linalg.norm(scene.aabb_max - scene.aabb_min)
    max_dist = diag * ray_length_frac

    hit = isect.intersect(scene.geo, o, d, jnp.full((n,), eps),
                          jnp.full((n,), isect.INF))
    frame = Frame.from_normal(hit.ng)
    occ_sum = jnp.zeros((n,), jnp.float32)
    smp = sampler
    for _ in range(n_samples):
        u2, smp = rng.next_2d(smp)
        wo = frame.to_world(warp.square_to_cosine_hemisphere(u2))
        blocked = isect.occluded(
            scene.geo, hit.p + wo * eps, wo,
            jnp.full((n,), eps * 0.1), jnp.full((n,), max_dist),
        )
        occ_sum = occ_sum + jnp.where(blocked, 0.0, 1.0)
    vis = occ_sum / n_samples
    value = jnp.where(hit.valid[..., None], vis[..., None], 1.0)
    sink = common.new_sink(cfg, n, pixel)
    sink = common.add_contribution(
        sink, cfg, jnp.broadcast_to(value, (n, 3)),
        jnp.where(hit.valid, hit.t, 0.0), jnp.ones((n,), jnp.int32),
        jnp.ones((n,), bool),
    )
    return sink, smp


def field_li(scene: Scene, cfg: RenderConfig, o, d, sampler, pixel=None,
             field: str = "shNormal"):
    """Field extraction (field.cpp): writes geometric quantities as colors.
    Fields: shNormal | geoNormal | position | distance | primIndex | uv."""
    n = o.shape[0]
    eps = common.scene_epsilon(scene)
    hit = isect.intersect(scene.geo, o, d, jnp.full((n,), eps),
                          jnp.full((n,), isect.INF))
    if field in ("shNormal", "geoNormal"):
        value = hit.ng * 0.5 + 0.5
    elif field == "position":
        value = hit.p
    elif field == "distance":
        value = jnp.broadcast_to(
            jnp.where(hit.valid, hit.t, 0.0)[..., None], (n, 3)
        )
    elif field == "primIndex":
        value = jnp.broadcast_to(hit.prim.astype(jnp.float32)[..., None], (n, 3))
    elif field == "uv":
        value = jnp.concatenate([hit.uv, jnp.zeros((n, 1))], axis=-1)
    else:
        raise ValueError(f"unknown field {field}")
    value = jnp.where(hit.valid[..., None], value, 0.0)
    sink = common.new_sink(cfg, n, pixel)
    sink = common.add_contribution(
        sink, cfg, value, jnp.where(hit.valid, hit.t, 0.0),
        jnp.ones((n,), jnp.int32), jnp.ones((n,), bool),
    )
    return sink, sampler


def render_multichannel(scene: Scene, cfg: RenderConfig, fields=None,
                        seed: int = 0):
    """Multi-channel render (misc/multichannel.cpp): the radiance image
    plus any number of field-extraction channels from the SAME camera rays,
    returned as (H, W, 3*(1+len(fields))). The reference nests
    sub-integrators writing into named film channels; here each extra
    channel is one more field evaluation over the shared primary hits."""
    import jax

    from ..core import rng as rng_m
    from ..models import sensor as sensor_m
    from . import render as render_m

    fields = list(fields or ["shNormal", "distance"])
    H, W = cfg.height, cfg.width
    npix = H * W
    img = render_m.render(scene, cfg, seed=seed)
    if img.shape[-1] != 3:
        img = img[..., :3]

    pixel = jnp.arange(npix, dtype=jnp.uint32)
    smp = rng_m.make_sampler(jnp.asarray(seed, jnp.uint32), pixel,
                             jnp.zeros((npix,), jnp.uint32))
    px = (pixel % W).astype(jnp.float32) + 0.5
    py = (pixel // W).astype(jnp.float32) + 0.5
    rays = sensor_m.sample_rays(scene.sensor, px, py, W, H)
    chans = [jnp.asarray(img)]
    for f in fields:
        sink, _ = field_li(scene, cfg, rays.o, rays.d, smp, pixel=pixel,
                           field=f)
        chans.append(sink.steady.reshape(H, W, 3))
    return jnp.concatenate(chans, axis=-1)


def render_adaptive(scene: Scene, cfg: RenderConfig, seed: int = 0,
                    max_error: float = 0.05, p_value: float = 0.05,
                    max_sample_factor: int = 8, base_spp: int = None):
    """Error-controlled adaptive sampling (misc/adaptive.cpp): render in
    passes, stop per pixel once the t-test confidence interval of its mean
    falls under max_error * mean (the reference's averageLuminance-relative
    criterion), cap total samples at max_sample_factor * spp.

    Shape note: XLA programs are fixed-width, so converged pixels still
    occupy lanes in later passes; their samples are simply not accumulated
    (each pixel divides by its own sample count — unbiased per pixel). The
    reference's win is reallocating CPU time; ours is the same variance
    control with the allocation expressed in sample counts."""
    import jax
    from scipy import stats as sstats

    from . import render as render_m

    H, W = cfg.height, cfg.width
    base = base_spp or max(4, cfg.spp)
    mean = jnp.zeros((H, W, 3))
    m2 = jnp.zeros((H, W, 3))
    count = jnp.zeros((H, W, 1))
    active = jnp.ones((H, W, 1), bool)
    passes = max_sample_factor
    for i in range(passes):
        img = jnp.asarray(render_m.render(
            scene, cfg._replace(spp=base), seed=seed + 1000 * i))[..., :3]
        # Welford over pass means (each pass is one observation per pixel)
        new_count = count + active
        delta = img - mean
        mean = jnp.where(active, mean + delta / jnp.maximum(new_count, 1),
                         mean)
        m2 = jnp.where(active, m2 + delta * (img - mean), m2)
        count = new_count
        if i >= 1:
            var = m2 / jnp.maximum(count - 1, 1)
            sem = jnp.sqrt(var / jnp.maximum(count, 1))
            tq = sstats.t.ppf(1.0 - 0.5 * p_value, df=max(int(i), 1))
            lum = jnp.mean(mean, axis=-1, keepdims=True)
            ci = tq * jnp.mean(sem, axis=-1, keepdims=True)
            conv = ci <= max_error * jnp.maximum(lum, 1e-4)
            active = active & ~conv
            if not bool(jnp.any(active)):
                break
    return mean
