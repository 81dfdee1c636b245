"""Perlin noise + fractal sums (reference: src/librender/noise.cpp —
Perlin's improved noise with the classic 256-entry permutation, plus
fBm and turbulence used by procedural textures).

The permutation table is folded into a HASH (the table is a fixed
pseudorandom permutation; a counter-hash of the lattice corner
coordinates gives the same statistical construction without 512-entry
gathers — branchless elementwise arithmetic instead). Gradients are the 12 edge vectors of Perlin 2002 selected by
the corner hash; the fade curve is the standard quintic
6t^5 - 15t^4 + 10t^3. Values are in [-1, 1] with perlin(0) = 0 at
lattice points, exactly like the reference.
"""
from __future__ import annotations

import jax.numpy as jnp


def _hash3(xi, yi, zi):
    h = (xi.astype(jnp.uint32) * jnp.uint32(0x9E3779B1)
         ^ yi.astype(jnp.uint32) * jnp.uint32(0x85EBCA77)
         ^ zi.astype(jnp.uint32) * jnp.uint32(0xC2B2AE3D))
    h ^= h >> 15
    h = h * jnp.uint32(0x27D4EB2F)
    h ^= h >> 13
    return h


def _grad(h, x, y, z):
    """Perlin 2002 gradient: pick one of 12 edge vectors from the low
    hash bits (noise.cpp's grad())."""
    h = (h & jnp.uint32(15)).astype(jnp.int32)
    u = jnp.where(h < 8, x, y)
    v = jnp.where(h < 4, y, jnp.where((h == 12) | (h == 14), x, z))
    return (jnp.where(h & 1 == 0, u, -u)
            + jnp.where(h & 2 == 0, v, -v))


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def perlin(p):
    """Improved Perlin noise at points p (..., 3) -> (...,) in [-1, 1]."""
    pf = jnp.floor(p)
    xi = pf[..., 0].astype(jnp.int32)
    yi = pf[..., 1].astype(jnp.int32)
    zi = pf[..., 2].astype(jnp.int32)
    x = p[..., 0] - pf[..., 0]
    y = p[..., 1] - pf[..., 1]
    z = p[..., 2] - pf[..., 2]
    u, v, w = _fade(x), _fade(y), _fade(z)

    def corner(dx, dy, dz):
        h = _hash3(xi + dx, yi + dy, zi + dz)
        return _grad(h, x - dx, y - dy, z - dz)

    def lerp(t, a, b):
        return a + t * (b - a)

    c000 = corner(0, 0, 0)
    c100 = corner(1, 0, 0)
    c010 = corner(0, 1, 0)
    c110 = corner(1, 1, 0)
    c001 = corner(0, 0, 1)
    c101 = corner(1, 0, 1)
    c011 = corner(0, 1, 1)
    c111 = corner(1, 1, 1)
    return lerp(w,
                lerp(v, lerp(u, c000, c100), lerp(u, c010, c110)),
                lerp(v, lerp(u, c001, c101), lerp(u, c011, c111)))


def fbm(p, octaves: int = 4, lacunarity: float = 2.0, gain: float = 0.5):
    """Fractal Brownian motion: sum of scaled Perlin octaves
    (noise.cpp fbm), normalized to roughly [-1, 1]."""
    total = jnp.zeros(p.shape[:-1], p.dtype)
    amp = 1.0
    freq = 1.0
    norm = 0.0
    for _ in range(octaves):
        total = total + amp * perlin(p * freq)
        norm += amp
        amp *= gain
        freq *= lacunarity
    return total / norm


def turbulence(p, octaves: int = 4, lacunarity: float = 2.0,
               gain: float = 0.5):
    """Sum of |perlin| octaves (noise.cpp turbulence), in [0, ~1]."""
    total = jnp.zeros(p.shape[:-1], p.dtype)
    amp = 1.0
    freq = 1.0
    norm = 0.0
    for _ in range(octaves):
        total = total + amp * jnp.abs(perlin(p * freq))
        norm += amp
        amp *= gain
        freq *= lacunarity
    return total / norm
