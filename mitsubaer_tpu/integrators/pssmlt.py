"""Primary-sample-space Metropolis light transport (Kelemen et al. 2002).

Reference: src/integrators/pssmlt/{pssmlt,pssmlt_proc,pssmlt_sampler}.cpp —
Markov chains mutate the vector of primary sample-space uniforms feeding an
ordinary path sampler; acceptance is by path luminance, and both proposal
and current states splat with the Kelemen MIS weights. Two-stage
normalization estimates the average image luminance b by plain Monte Carlo.

Array-program redesign: thousands of INDEPENDENT chains run as wavefront lanes
(the reference runs one chain per worker thread, pssmlt_proc.cpp); each
mutation step re-traces every chain's path with the VECTOR (replayable)
sampler (core/rng.py; = the reference's ReplayableSampler, rsampler.cpp).
Kelemen's lazy per-dimension mutation becomes a dense per-step mutation of
the whole vector — same kernel, fixed shapes.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core import rng
from ..models import sensor as sensor_m
from ..scene.types import RenderConfig, Scene
from .render import get_integrator

_LUM = np.array([0.2126, 0.7152, 0.0722], np.float32)


def _trace(scene: Scene, cfg: RenderConfig, u):
    """Evaluate the path estimator at primary-sample vectors u (n, D).
    Returns (pixel ids (n,), rgb (n, 3))."""
    n = u.shape[0]
    H, W = cfg.height, cfg.width
    px = u[:, 0] * W
    py = u[:, 1] * H
    rays = sensor_m.sample_rays(scene.sensor, px, py, W, H,
                                u_lens=u[:, 2:4])
    smp = rng.Sampler(
        lane=jnp.arange(n, dtype=jnp.uint32),
        index=jnp.zeros((n,), jnp.uint32),
        dim=jnp.full((n,), 4, jnp.uint32),
        seed=jnp.uint32(0x4D4C54),
        mode=rng.VECTOR, table=u)
    integrator = get_integrator(
        "volpath" if cfg.integrator in ("pssmlt_volpath",) else "path")
    sink, _ = integrator(scene, cfg, rays.o, rays.d, smp,
                         pixel=(py.astype(jnp.int32) * W
                                + px.astype(jnp.int32)))
    pix = (jnp.clip(py.astype(jnp.int32), 0, H - 1) * W
           + jnp.clip(px.astype(jnp.int32), 0, W - 1))
    return pix, sink.steady


def _mutate_small(u, key_bits, s1: float = 1.0 / 1024.0, s2: float = 1.0 / 64.0):
    """Kelemen exponential perturbation of every dimension, wrapped to [0,1)
    (pssmlt_sampler.cpp mutate)."""
    r1 = rng._u32_to_float(key_bits)
    r2 = rng._u32_to_float(rng._hash_u32(key_bits ^ jnp.uint32(0xDECAF)))
    mag = s2 * jnp.exp(-jnp.log(s2 / s1) * r1)
    delta = jnp.where(r2 < 0.5, mag, -mag)
    return (u + delta) % 1.0


@functools.partial(jax.jit, static_argnames=("cfg", "n_chains", "n_mut", "D"),
                   keep_unused=True)
def _pssmlt_run(scene: Scene, cfg: RenderConfig, n_chains: int, n_mut: int,
                D: int, seed, b, u0):
    H, W = cfg.height, cfg.width
    key0 = rng.hash_combine(seed, jnp.uint32(0x5EED))
    lanes = jnp.arange(n_chains, dtype=jnp.uint32)

    def fresh(tag):
        bits = rng._hash_u32(
            lanes[:, None] * jnp.uint32(0x9E3779B9)
            + jnp.arange(D, dtype=jnp.uint32)[None, :] * jnp.uint32(0x85EBCA6B)
            + tag)
        return rng._u32_to_float(bits)

    u = u0  # luminance-resampled bootstrap states (two-stage MLT seeding:
    #   chains start in the stationary distribution, pssmlt_proc.cpp)
    pix, rgb = _trace(scene, cfg, u)
    lum = rgb @ jnp.asarray(_LUM)
    film = jnp.zeros((H * W, 3), jnp.float32)
    p_large = jnp.float32(0.3)

    def step(carry, i):
        u, pix, rgb, lum, film = carry
        tag = rng.hash_combine(key0, jnp.uint32(i))
        bits = rng._hash_u32(lanes + tag)
        u_large = jnp.float32(rng._u32_to_float(rng._hash_u32(bits)))
        is_large = u_large < p_large
        u_prop = jnp.where(
            is_large[:, None], fresh(tag ^ jnp.uint32(0xA11)),
            _mutate_small(u, rng._hash_u32(
                bits[:, None] + jnp.arange(D, dtype=jnp.uint32)[None, :])))
        pix2, rgb2 = _trace(scene, cfg, u_prop)
        lum2 = rgb2 @ jnp.asarray(_LUM)
        a = jnp.clip(lum2 / jnp.maximum(lum, 1e-12), 0.0, 1.0)
        # Kelemen MIS splat weights (pssmlt.cpp:expectations form)
        w_new = (a + is_large) / jnp.maximum(lum2 / b + p_large, 1e-12)
        w_old = (1.0 - a) / jnp.maximum(lum / b + p_large, 1e-12)
        film = film.at[pix2].add(jnp.where(
            (lum2 > 0)[:, None], rgb2 * w_new[:, None], 0.0))
        film = film.at[pix].add(jnp.where(
            (lum > 0)[:, None], rgb * w_old[:, None], 0.0))
        u_acc = rng._u32_to_float(rng._hash_u32(bits ^ jnp.uint32(0xACC)))
        accept = u_acc < a
        u = jnp.where(accept[:, None], u_prop, u)
        pix = jnp.where(accept, pix2, pix)
        rgb = jnp.where(accept[:, None], rgb2, rgb)
        lum = jnp.where(accept, lum2, lum)
        return (u, pix, rgb, lum, film), None

    (u, pix, rgb, lum, film), _ = jax.lax.scan(
        step, (u, pix, rgb, lum, film), jnp.arange(n_mut))
    return film


def render_pssmlt(scene: Scene, cfg: RenderConfig, seed: int = 0,
                  n_chains: int = None, n_bootstrap: int = 1 << 16):
    """Metropolis render: cfg.spp = mutations per pixel on average."""
    H, W = cfg.height, cfg.width
    npix = H * W
    if n_chains is None:
        n_chains = min(max(npix // 8, 4096), 1 << 16)
    D = min(8 + 8 * cfg.max_depth, 120)

    # stage 1: normalization constant b = E[lum] by ordinary MC
    @functools.partial(jax.jit,
                       static_argnames=("cfg", "nb", "D", "nc"),
                       keep_unused=True)
    def bootstrap(scene, cfg, nb, D, nc, seed):
        lanes = jnp.arange(nb, dtype=jnp.uint32)
        bits = rng._hash_u32(
            lanes[:, None] * jnp.uint32(0x9E3779B9)
            + jnp.arange(D, dtype=jnp.uint32)[None, :] + seed)
        u = rng._u32_to_float(bits)
        _, rgb = _trace(scene, cfg, u)
        lum = rgb @ jnp.asarray(_LUM)
        # systematic resampling of chain seeds proportional to luminance
        cdf = jnp.cumsum(lum)
        total = jnp.maximum(cdf[-1], 1e-20)
        jit = rng._u32_to_float(rng._hash_u32(
            jnp.arange(nc, dtype=jnp.uint32) + seed))
        targets = (jnp.arange(nc, dtype=jnp.float32) + jit) / nc * total
        idx = jnp.clip(jnp.searchsorted(cdf, targets), 0, nb - 1)
        return jnp.mean(lum), jnp.take(u, idx, axis=0)

    b, u0 = bootstrap(scene, cfg, n_bootstrap, D, n_chains, jnp.uint32(seed))
    b = jnp.maximum(b, 1e-9)

    n_mut = max((cfg.spp * npix) // n_chains, 1)
    film = _pssmlt_run(scene, cfg, n_chains, n_mut, D, jnp.uint32(seed), b, u0)
    # each mutation step deposits expectation-weighted contributions whose
    # mean is the image divided by the per-pixel sample density
    scale = npix / (n_chains * n_mut)
    return (film * scale).reshape(H, W, 3)
