"""Energy-redistribution path tracing (reference src/integrators/erpt/
erpt.cpp + erpt_proc.cpp; Cline, Talbot & Egbert 2005).

ERPT = ordinary path tracing for SEED paths + short Metropolis chains that
redistribute each bright seed's energy into its local path neighborhood.
Unlike pssmlt there are no large steps: every chain stays in the basin of
its seed, and every mutation deposits a FIXED energy quantum e_d split
between current and proposed path by the acceptance probability
(equal-deposition, Cline eq. 8) — the property that kills caustic "spike"
noise that plain PT and even pssmlt leave behind.

Array-program redesign: chains are a fixed-width batch in PRIMARY SAMPLE SPACE
(the pssmlt machinery's u-vector paths through the VECTOR sampler), so one
jitted scan advances every chain in lockstep:

  * seed stage: nb stratified PT samples; chain starts resampled
    proportional to seed luminance (the reference's numChains =
    ceil(lum/(e_d*m)) Poisson thinning has the same stationary law; the
    resampled form is wavefront-shaped);
  * mutation: Kelemen exponential perturbations of all path dimensions —
    the PSS stand-in for the reference's lens/caustic/multi-chain
    perturbations (mutator family mut_lens.cpp/mut_caustic.cpp); small
    steps only (p_large = 0, erpt.cpp keeps chains local);
  * deposition: e_d * a at the proposal's pixel, e_d * (1-a) at the
    current pixel, with the path's own chromaticity rgb/lum.

Normalization: total deposited energy equals the PT estimate of total
image energy (b * npix with b = mean seed luminance), making the
estimator consistent; e_d = b * npix / (n_chains * n_mut).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core import rng
from ..scene.types import RenderConfig, Scene
from .pssmlt import _LUM, _mutate_small, _trace


@functools.partial(jax.jit, static_argnames=("cfg", "n_chains", "n_mut", "D"),
                   keep_unused=True)
def _erpt_run(scene: Scene, cfg: RenderConfig, n_chains: int, n_mut: int,
              D: int, seed, e_d, u0):
    H, W = cfg.height, cfg.width
    key0 = rng.hash_combine(seed, jnp.uint32(0xE497))
    lanes = jnp.arange(n_chains, dtype=jnp.uint32)

    u = u0
    pix, rgb = _trace(scene, cfg, u)
    lum = rgb @ jnp.asarray(_LUM)
    film = jnp.zeros((H * W, 3), jnp.float32)

    def step(carry, i):
        u, pix, rgb, lum, film = carry
        tag = rng.hash_combine(key0, jnp.uint32(i))
        bits = rng._hash_u32(lanes + tag)
        u_prop = _mutate_small(u, rng._hash_u32(
            bits[:, None] + jnp.arange(D, dtype=jnp.uint32)[None, :]))
        pix2, rgb2 = _trace(scene, cfg, u_prop)
        lum2 = rgb2 @ jnp.asarray(_LUM)
        a = jnp.clip(lum2 / jnp.maximum(lum, 1e-12), 0.0, 1.0)
        # equal-deposition: each mutation deposits exactly e_d of energy,
        # split a : (1-a), carrying each path's chromaticity
        chroma2 = rgb2 / jnp.maximum(lum2, 1e-12)[:, None]
        chroma = rgb / jnp.maximum(lum, 1e-12)[:, None]
        film = film.at[pix2].add(jnp.where(
            (lum2 > 0)[:, None], chroma2 * (e_d * a)[:, None], 0.0))
        film = film.at[pix].add(jnp.where(
            (lum > 0)[:, None], chroma * (e_d * (1.0 - a))[:, None], 0.0))
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


def render_erpt(scene: Scene, cfg: RenderConfig, seed: int = 0,
                n_chains: int = None, n_bootstrap: int = 1 << 16,
                n_mut: int = None):
    """ERPT render; cfg.spp = average mutations per pixel."""
    H, W = cfg.height, cfg.width
    npix = H * W
    if n_chains is None:
        n_chains = min(max(npix // 8, 4096), 1 << 16)
    D = min(8 + 8 * cfg.max_depth, 120)

    @functools.partial(jax.jit, static_argnames=("cfg", "nb", "D", "nc"),
                       keep_unused=True)
    def bootstrap(scene, cfg, nb, D, nc, seed):
        lanes = jnp.arange(nb, dtype=jnp.uint32)
        bits = rng._hash_u32(
            lanes[:, None] * jnp.uint32(0x9E3779B9)
            + jnp.arange(D, dtype=jnp.uint32)[None, :] + seed)
        u = rng._u32_to_float(bits)
        _, rgb = _trace(scene, cfg, u)
        lum = rgb @ jnp.asarray(_LUM)
        cdf = jnp.cumsum(lum)
        total = jnp.maximum(cdf[-1], 1e-20)
        jit = rng._u32_to_float(rng._hash_u32(
            jnp.arange(nc, dtype=jnp.uint32) + seed))
        targets = (jnp.arange(nc, dtype=jnp.float32) + jit) / nc * total
        idx = jnp.clip(jnp.searchsorted(cdf, targets), 0, nb - 1)
        return jnp.mean(lum), jnp.take(u, idx, axis=0)

    b, u0 = bootstrap(scene, cfg, n_bootstrap, D, n_chains,
                      jnp.uint32(seed))
    b = float(np.asarray(b))
    if b <= 0:
        return jnp.zeros((H, W, 3), jnp.float32)
    if n_mut is None:
        n_mut = max((cfg.spp * npix) // n_chains, 1)
    e_d = jnp.full((n_chains,), b * npix / (n_chains * n_mut), jnp.float32)
    film = _erpt_run(scene, cfg, n_chains, n_mut, D, jnp.uint32(seed),
                     e_d, u0)
    return film.reshape(H, W, 3)
