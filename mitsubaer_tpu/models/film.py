"""Film: filtered sample accumulation and development.

Reference: src/films/hdrfilm.cpp + ImageBlock filter splatting
(imageblock.h:103) + rfilters (box/tent/gaussian/mitchell/catmullrom/lanczos).

Array-program redesign: instead of scatter-based splatting, samples are organized
per-pixel (each lane knows its pixel), so filter reconstruction becomes a
fixed set of *shifted dense adds*: for every tap offset (dx, dy) within the
filter radius we weight all samples, reduce over spp, and add the shifted
plane into the accumulator. No scatters, fully fused, deterministic
accumulation order (the reference serializes film writes for the same
reason, sched.cpp processResult).

Transient/bounce decomposition (film.cpp:56-80, bdpt_proc.cpp:455-476) uses a
time-binned accumulator with scatter-adds over (pixel, bin).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..scene.types import RenderConfig

_FILTERS = {
    "box": 0,
    "tent": 1,
    "gaussian": 2,
    "mitchell": 3,
    "catmullrom": 4,
    "lanczos": 5,
}


def filter_radius(name: str) -> int:
    return {"box": 0, "tent": 1, "gaussian": 2, "mitchell": 2,
            "catmullrom": 2, "lanczos": 3}[name]


def _filter_eval(name: str, x):
    """1D reconstruction filter value at offset x (pixels)."""
    ax = jnp.abs(x)
    if name == "box":
        return jnp.where(ax <= 0.5, 1.0, 0.0)
    if name == "tent":
        return jnp.maximum(1.0 - ax, 0.0)
    if name == "gaussian":
        # stddev 0.5, radius 2, truncated (rfilters/gaussian.cpp)
        alpha = 2.0  # 1/(2 sigma^2) with sigma = 0.5
        return jnp.maximum(jnp.exp(-alpha * x * x) - jnp.exp(-alpha * 4.0), 0.0)
    if name == "lanczos":
        # 3-lobed Lanczos-sinc window (rfilters/lanczos.cpp)
        pix = jnp.pi * ax
        sinc = jnp.where(ax < 1e-4, 1.0, jnp.sin(pix) / jnp.maximum(pix, 1e-9))
        wind = jnp.where(ax < 1e-4, 1.0,
                         jnp.sin(pix / 3.0) / jnp.maximum(pix / 3.0, 1e-9))
        return jnp.where(ax < 3.0, sinc * wind, 0.0)
    if name in ("mitchell", "catmullrom"):
        B, C = (1 / 3, 1 / 3) if name == "mitchell" else (0.0, 0.5)
        ax2, ax3 = ax * ax, ax * ax * ax
        v1 = (12 - 9 * B - 6 * C) * ax3 + (-18 + 12 * B + 6 * C) * ax2 + (6 - 2 * B)
        v2 = (-B - 6 * C) * ax3 + (6 * B + 30 * C) * ax2 + (-12 * B - 48 * C) * ax + (8 * B + 24 * C)
        return jnp.where(ax < 1, v1, jnp.where(ax < 2, v2, 0.0)) / 6.0
    raise ValueError(name)


def new_accumulator(cfg: RenderConfig):
    """(H, W, F*3 + 1) accumulator: F frame RGB groups + filter weight."""
    return jnp.zeros((cfg.height, cfg.width, cfg.n_frames * 3 + 1), jnp.float32)


def splat(accum, values, jitter, filter_name: str):
    """Accumulate one spp-chunk.

    values: (S, H, W, 3) radiance samples; jitter: (S, H, W, 2) sample offset
    within the pixel in [0,1)^2 (x, y). Returns updated accumulator.
    Only fills frame 0 (steady state) + weight.
    """
    S, H, W, _ = values.shape
    r = filter_radius(filter_name)
    jx = jitter[..., 0]
    jy = jitter[..., 1]
    img = accum[..., 0:3]
    wsum = accum[..., -1]
    # total of per-sample filter normalization is handled at develop time via
    # the weight channel, matching ImageBlock::put.
    for dy in range(-r, r + 1):
        wy = _filter_eval(filter_name, jy - (dy + 0.5))  # (S, H, W)
        for dx in range(-r, r + 1):
            wx = _filter_eval(filter_name, jx - (dx + 0.5))
            w = wx * wy
            plane = jnp.sum(w[..., None] * values, axis=0)  # (H, W, 3)
            wplane = jnp.sum(w, axis=0)
            img = img + _shift2d(plane, dx, dy)
            wsum = wsum + _shift2d(wplane[..., None], dx, dy)[..., 0]
    return jnp.concatenate(
        [img, accum[..., 3:-1], wsum[..., None]], axis=-1
    )


def _shift2d(plane, dx, dy):
    """Shift a (H, W, C) plane by (dx, dy) pixels with zero fill: the sample's
    contribution to pixel (px + dx, py + dy) lands at that pixel."""
    if dx == 0 and dy == 0:
        return plane
    H, W, C = plane.shape
    pad_y = (max(dy, 0), max(-dy, 0))
    pad_x = (max(dx, 0), max(-dx, 0))
    padded = jnp.pad(plane, (pad_y, pad_x, (0, 0)))
    return padded[pad_y[1] : pad_y[1] + H, pad_x[1] : pad_x[1] + W, :]


def splat_frames(accum, values, jitter, filter_name: str):
    """Accumulate a full (S, H, W, F, 3) decomposed sample block (transient /
    bounce). Box-filters frames spatially per reference transient practice
    would be cheaper, but we honor the configured filter for parity."""
    S, H, W, F, _ = values.shape
    r = filter_radius(filter_name)
    jx = jitter[..., 0]
    jy = jitter[..., 1]
    img = accum[..., :-1].reshape(H, W, F, 3)
    wsum = accum[..., -1]
    for dy in range(-r, r + 1):
        wy = _filter_eval(filter_name, jy - (dy + 0.5))
        for dx in range(-r, r + 1):
            wx = _filter_eval(filter_name, jx - (dx + 0.5))
            w = wx * wy
            plane = jnp.sum(w[..., None, None] * values, axis=0)
            wplane = jnp.sum(w, axis=0)
            img = img + _shift2d(plane.reshape(H, W, F * 3), dx, dy).reshape(H, W, F, 3)
            wsum = wsum + _shift2d(wplane[..., None], dx, dy)[..., 0]
    return jnp.concatenate([img.reshape(H, W, F * 3), wsum[..., None]], axis=-1)


def develop(accum):
    """Normalize by the filter-weight channel (ImageBlock -> Bitmap develop).
    Returns (H, W, C) with C = F*3 (frame groups)."""
    w = accum[..., -1:]
    return jnp.where(w > 0, accum[..., :-1] / jnp.maximum(w, 1e-20), 0.0)


def bin_index(cfg: RenderConfig, path_length):
    """Time/bounce bin for a contribution (bdpt_proc.cpp:455-476)."""
    f = jnp.floor((path_length - cfg.min_bound) / cfg.bin_width).astype(jnp.int32)
    inside = (path_length >= cfg.min_bound) & (path_length < cfg.max_bound)
    return jnp.clip(f, 0, cfg.n_frames - 1), inside
