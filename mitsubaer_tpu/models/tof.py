"""CW time-of-flight correlation functions + path-length importance sampling.

Reference: src/librender/pathlengthsampler.cpp (PathLengthSampler).
`correlationFunction(t)` weights a path contribution by the demodulation
profile at its optical path length; modes: sine / square / hamiltonian /
m-sequence / depth-selective codes (pathlengthsampler.cpp:67-120).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..scene.types import RenderConfig


def _mseq(cfg: RenderConfig, t, phase):
    """m-sequence correlation (pathlengthsampler.h mSeq): a sawtooth-like
    pseudo-random code correlation with period lambda, sharp peak of width
    lambda/P at the phase offset."""
    lam = cfg.lambda_
    P = cfg.P
    x = jnp.mod(t / lam + phase / (2 * np.pi), 1.0) * P  # in code chips
    tri = jnp.maximum(1.0 - jnp.abs(x - jnp.round(x)) * 2.0, 0.0)
    # peak at chip 0 only; elsewhere correlation floor -1/P
    near0 = jnp.round(x) % P == 0
    return jnp.where(near0, tri * (1.0 + 1.0 / P) - 1.0 / P, -1.0 / P)


def correlation_function(cfg: RenderConfig, t):
    """Weight for a contribution with optical path length t
    (pathlengthsampler.cpp:67)."""
    lam = cfg.lambda_
    phase = cfg.phase * np.pi / 180.0
    if cfg.modulation == "sine":
        tt = t + phase * lam / (2 * np.pi)
        return jnp.cos(tt * 2 * np.pi / lam)
    if cfg.modulation == "square":
        tt = t + phase * lam / (2 * np.pi)
        return 4.0 / lam * (jnp.abs(jnp.mod(tt, lam) - lam / 2) - lam / 4)
    if cfg.modulation == "hamiltonian":
        tt = jnp.mod(t + phase * lam / (2 * np.pi), lam)
        v = jnp.where(
            tt < lam / 6,
            6 * tt / lam,
            jnp.where(
                tt < lam / 2,
                1.0,
                jnp.where(tt < 2 * lam / 3, 1 - (tt - lam / 2) * 6 / lam, 0.0),
            ),
        )
        return v
    if cfg.modulation == "mseq":
        return _mseq(cfg, t, phase)
    if cfg.modulation == "depthselective":
        v = jnp.zeros_like(t)
        for i in range(cfg.neighbors):
            v = v + _mseq(cfg, t, phase - i * (2 * np.pi) / cfg.P)
        return v - (cfg.neighbors - 1) / cfg.P
    return jnp.ones_like(t)


def area_under_correlation(cfg: RenderConfig, n_bins: int = 1024):
    """∫ |R(t)| dt over [min_bound, max_bound]
    (pathlengthsampler.cpp areaUnderCorrelationGraph)."""
    edges = jnp.linspace(cfg.min_bound, cfg.max_bound, n_bins + 1)
    mids = 0.5 * (edges[:-1] + edges[1:])
    w = jnp.abs(correlation_function(cfg, mids))
    return jnp.sum(w) * (cfg.max_bound - cfg.min_bound) / n_bins


def sample_path_length(cfg: RenderConfig, u, n_bins: int = 256):
    """Importance-sample a target optical path length with density
    proportional to |R(t)| on [min_bound, max_bound]
    (pathlengthsampler.cpp sampleRestrictedPathLength — the reference's
    rejection sampler becomes a tabulated inverse CDF, branchless).

    Returns (t, pdf). Degenerates to uniform when no modulation is set."""
    lo = jnp.float32(cfg.min_bound)
    hi = jnp.float32(max(cfg.max_bound, cfg.min_bound + 1e-6))
    edges = jnp.linspace(lo, hi, n_bins + 1)
    mids = 0.5 * (edges[:-1] + edges[1:])
    w = jnp.abs(correlation_function(cfg, mids)) + 1e-8
    cdf = jnp.cumsum(w)
    total = cdf[-1]
    target = u * total
    idx = jnp.clip(jnp.searchsorted(cdf, target), 0, n_bins - 1)
    prev = jnp.where(idx > 0, jnp.take(cdf, jnp.maximum(idx - 1, 0)), 0.0)
    wi = jnp.take(w, idx)
    frac = jnp.clip((target - prev) / jnp.maximum(wi, 1e-12), 0.0, 1.0)
    bin_w = (hi - lo) / n_bins
    t = lo + (idx.astype(jnp.float32) + frac) * bin_w
    pdf = wi / jnp.maximum(total * bin_w, 1e-12)
    return t, pdf
