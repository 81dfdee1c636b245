"""Differentiable rendering: gradients of the rendered image w.r.t. medium
parameters (sigma_a / sigma_s voxel-or-constant, density grid, phase g, and
later the RIF grid).

The reference renderer has NO parameter gradients (SURVEY.md §2.9 note); this
is the new capability this framework adds. Estimator design ("differential
path sampling"):
  - all sampling decisions (distances, collision accept/reject, directions)
    are DETACHED (stop_gradient) — the sample distribution is frozen at the
    current parameters;
  - contribution weights keep parameters attached (pathwise d(f/p) term);
  - every contribution also adds the zero-valued surrogate
    stop(value) * (log_p - stop(log_p)), whose derivative is the score term
    value * d(log p) — together the gradient estimator is unbiased:
    E[d(f/p) + (f/p) dlog p] = d/dtheta E[f/p].
  - the while_loop bounce loop is swapped for a fixed-trip lax.scan with
    jax.checkpoint (rematerialization) so reverse-mode AD works with O(1)
    stored bounces.

Validated against closed forms and finite differences in tests/test_grad.py.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import rng
from ..integrators import volpath as volpath_m
from ..models import sensor as sensor_m
from ..scene.types import Media, RenderConfig, Scene


class MediumParams(NamedTuple):
    """The differentiable parameter bundle."""

    sigma_a: jnp.ndarray   # (NM, 3)
    sigma_s: jnp.ndarray   # (NM, 3)
    density: jnp.ndarray   # (nz, ny, nx) heterogeneous density grid
    g: jnp.ndarray         # (NM,) HG asymmetry
    rif: jnp.ndarray       # (nz, ny, nx) refractive-index B-spline coeffs


def get_params(scene: Scene) -> MediumParams:
    return MediumParams(
        sigma_a=scene.media.sigma_a,
        sigma_s=scene.media.sigma_s,
        density=scene.media.density.data,
        g=scene.media.phase.g,
        rif=scene.media.rif_coeff,
    )


def put_params(scene: Scene, p: MediumParams) -> Scene:
    media = scene.media
    majorant = jax.lax.stop_gradient(
        jnp.max(p.density) * jnp.max(media.scale)
    )
    media = media._replace(
        sigma_a=p.sigma_a,
        sigma_s=p.sigma_s,
        density=media.density._replace(data=p.density),
        phase=media.phase._replace(g=p.g),
        rif_coeff=p.rif,
        majorant=majorant,
    )
    return scene._replace(media=media)


@functools.partial(jax.jit, static_argnames=("cfg", "sppc"))
def render_diff(scene: Scene, params: MediumParams, cfg: RenderConfig,
                sppc: int, seed, pass_idx):
    """Differentiable forward render (steady-state image, box filter):
    returns the (H, W, 3) mean-radiance image for one spp chunk."""
    scene = put_params(scene, params)
    H, W = cfg.height, cfg.width
    npix = H * W
    pixel = jnp.tile(jnp.arange(npix, dtype=jnp.uint32), (sppc,))
    sample_index = jnp.repeat(
        pass_idx * sppc + jnp.arange(sppc, dtype=jnp.uint32), npix
    )
    smp = rng.make_sampler(seed, pixel, sample_index)
    jitter, smp = rng.next_2d(smp)
    px = (pixel % W).astype(jnp.float32) + jitter[:, 0]
    py = (pixel // W).astype(jnp.float32) + jitter[:, 1]
    rays = sensor_m.sample_rays(scene.sensor, px, py, W, H)
    integ = cfg.integrator if cfg.integrator.startswith("volpath") else "volpath"
    sink, _ = volpath_m.li(
        scene, cfg._replace(integrator=integ), rays.o, rays.d, smp,
        pixel=pixel, differentiable=True,
    )
    return sink.steady.reshape(sppc, H, W, 3).mean(axis=0)


def loss_fn(scene, params, cfg, sppc, seed, pass_idx, target):
    img = render_diff(scene, params, cfg, sppc, seed, pass_idx)
    return jnp.mean((img - target) ** 2)


@functools.partial(jax.jit, static_argnames=("cfg", "sppc"))
def loss_and_grad(scene: Scene, params: MediumParams, cfg: RenderConfig,
                  sppc: int, seed, pass_idx, target):
    """(loss, dloss/dparams) for one spp chunk against a target image."""
    return jax.value_and_grad(
        lambda p: loss_fn(scene, p, cfg, sppc, seed, pass_idx, target)
    )(params)


def image_grad(scene: Scene, cfg: RenderConfig, sppc: int, seed=0,
               weight_image=None):
    """d(sum(image * weight_image))/dparams — direct adjoint of the image
    (weight_image defaults to all-ones)."""
    params = get_params(scene)

    def scalar(p):
        img = render_diff(scene, p, cfg, sppc, jnp.asarray(seed, jnp.uint32),
                          jnp.asarray(0, jnp.uint32))
        w = 1.0 if weight_image is None else weight_image
        return jnp.sum(img * w)

    return jax.grad(scalar)(params)
