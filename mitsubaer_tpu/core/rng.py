"""Counter-based samplers (reference: src/samplers/{independent,ldsampler,
stratified,sobol}.cpp + libcore/random.cpp SFMT).

Array-program redesign: instead of stateful per-thread SFMT streams we use
*stateless counter-based* hashing — every (seed, pixel, sample_index,
dimension) tuple deterministically produces a float. This makes wavefront
rendering order-independent, replayable, and trivially shardable across a
device mesh (no RNG state to ship, unlike the reference's per-worker Sampler
clones in sched.cpp).

Two modes:
  - INDEPENDENT: PCG-style hash per dimension (replaces independent.cpp).
  - LDS: Owen-scrambled (0,2)-sequence per 2D dimension pair, padded across
    pairs by decorrelating hashes (replaces ldsampler.cpp's
    Larcher-Pillichshammer points; same stratification guarantees per pair).

The Sampler is a tiny pytree (lane ids + dimension counter); drawing numbers
returns (value, new_sampler). All ops are uint32 elementwise arithmetic.
"""
from __future__ import annotations

import jax
import numpy as np
import jax.numpy as jnp

INDEPENDENT = 0
LDS = 1
STRATIFIED = 2
HALTON = 3
HAMMERSLEY = 4
SOBOL = 5
VECTOR = 6   # replayable: draws come from an explicit (N, D) uniform table
#   (the reference's ReplayableSampler, libbidir/rsampler.cpp; used by the
#   primary-sample-space MLT chains)

MODES = {
    "independent": INDEPENDENT,
    "lds": LDS,
    "ldsampler": LDS,
    "stratified": STRATIFIED,
    "halton": HALTON,
    "hammersley": HAMMERSLEY,
    "sobol": SOBOL,
}

_TWO_NEG_32 = np.float32(2.3283064365386963e-10)  # 2^-32 (np scalar, not jnp)


def _hash_u32(x: jnp.ndarray) -> jnp.ndarray:
    """lowbias32 finalizer (public-domain integer hash)."""
    x = jnp.asarray(x, jnp.uint32)
    x ^= x >> 16
    x = x * jnp.uint32(0x7FEB352D)
    x ^= x >> 15
    x = x * jnp.uint32(0x846CA68B)
    x ^= x >> 16
    return x


def hash_combine(*xs) -> jnp.ndarray:
    h = jnp.uint32(0x9E3779B9)
    for x in xs:
        h = _hash_u32(jnp.asarray(x, jnp.uint32) + h * jnp.uint32(0x01000193))
    return h


def _reverse_bits(x: jnp.ndarray) -> jnp.ndarray:
    x = jnp.asarray(x, jnp.uint32)
    x = ((x & jnp.uint32(0x55555555)) << 1) | ((x & jnp.uint32(0xAAAAAAAA)) >> 1)
    x = ((x & jnp.uint32(0x33333333)) << 2) | ((x & jnp.uint32(0xCCCCCCCC)) >> 2)
    x = ((x & jnp.uint32(0x0F0F0F0F)) << 4) | ((x & jnp.uint32(0xF0F0F0F0)) >> 4)
    x = ((x & jnp.uint32(0x00FF00FF)) << 8) | ((x & jnp.uint32(0xFF00FF00)) >> 8)
    return (x << 16) | (x >> 16)


def _owen_scramble(x: jnp.ndarray, seed: jnp.ndarray) -> jnp.ndarray:
    """Laine-Karras style nested uniform scramble on reversed bits."""
    x = jnp.asarray(x, jnp.uint32)
    x += seed
    x ^= x * jnp.uint32(0x6C50B47C)
    x ^= x * jnp.uint32(0xB82F1E52)
    x ^= x * jnp.uint32(0xC7AFE638)
    x ^= x * jnp.uint32(0x8D22F6E6)
    return x


def _sobol_2nd_dim(index: jnp.ndarray) -> jnp.ndarray:
    """Second Sobol' dimension via direction-number XOR (32 bits)."""
    index = jnp.asarray(index, jnp.uint32)
    v = jnp.uint32(1 << 31)
    result = jnp.zeros_like(index)
    for i in range(32):
        bit = (index >> jnp.uint32(i)) & jnp.uint32(1)
        result = jnp.where(bit == 1, result ^ v, result)
        v ^= v >> 1
    return result


def _u32_to_float(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.minimum(
        x.astype(jnp.float32) * _TWO_NEG_32, jnp.float32(0.99999994)
    )


# ---------------------------------------------------------------------------
# Full Sobol' direction numbers (reference: src/samplers/sobol.cpp +
# sobolseq.cpp generated tables). Instead of shipping 108k LoC of tables we
# generate direction numbers at import time from brute-forced primitive
# polynomials over GF(2) — any odd initial m-values yield a valid digital
# (t,s)-sequence in base 2; Owen scrambling (below) randomizes it per
# (seed, lane, dim) so the particular initialization has no bias impact.
# ---------------------------------------------------------------------------
_SOBOL_DIMS = 64


def _primitive_polys(max_count: int):
    """Brute-force primitive polynomials over GF(2), ascending degree.
    Returns list of (degree, coeff_bits) where coeff_bits encodes
    a_1..a_{s-1} (interior coefficients, MSB = a_1)."""
    def poly_mulmod(a, b, p, s):
        r = 0
        while b:
            if b & 1:
                r ^= a
            b >>= 1
            a <<= 1
            if a >> s:
                a ^= p
        return r

    def is_primitive(p, s):
        order = (1 << s) - 1
        # x^order mod p == 1 and x^(order/q) != 1 for prime factors q
        def powx(e):
            r, base = 1, 2
            while e:
                if e & 1:
                    r = poly_mulmod(r, base, p, s)
                base = poly_mulmod(base, base, p, s)
                e >>= 1
            return r

        if powx(order) != 1:
            return False
        n, fac = order, []
        d = 2
        while d * d <= n:
            if n % d == 0:
                fac.append(d)
                while n % d == 0:
                    n //= d
            d += 1
        if n > 1:
            fac.append(n)
        return all(powx(order // q) != 1 for q in fac)

    out = []
    s = 1
    while len(out) < max_count:
        # candidate: x^s + (interior bits) + 1
        for interior in range(1 << max(s - 1, 0)):
            p = (1 << s) | 1
            for i in range(s - 1):
                if (interior >> i) & 1:
                    p |= 1 << (i + 1)
            if is_primitive(p, s):
                out.append((s, interior))
                if len(out) >= max_count:
                    break
        s += 1
    return out


def _build_sobol_table(ndims: int) -> np.ndarray:
    rng = np.random.RandomState(0x5EB01)
    table = np.zeros((ndims, 32), np.uint32)
    table[0] = np.uint32(1) << (31 - np.arange(32))  # dim 0: van der Corput
    polys = _primitive_polys(ndims - 1)
    for j, (s, interior) in enumerate(polys, start=1):
        a = [(interior >> i) & 1 for i in range(s - 1)]  # a_1..a_{s-1}
        m = [0] * 33
        for i in range(1, s + 1):
            m[i] = 2 * rng.randint(0, 1 << (i - 1)) + 1 if i > 1 else 1
        for k in range(s + 1, 33):
            acc = m[k - s] ^ (m[k - s] << s)
            for i in range(1, s):
                if a[i - 1]:
                    acc ^= m[k - i] << i
            m[k] = acc
        for k in range(1, 33):
            table[j, k - 1] = np.uint32((m[k] << (32 - k)) & 0xFFFFFFFF)
    return table


_SOBOL_TABLE = _build_sobol_table(_SOBOL_DIMS)  # (64, 32) uint32


def sobol_sample(index, dim, scramble_key):
    """Owen-scrambled Sobol' point: dimension `dim` (traced) of sample
    `index`. scramble_key decorrelates (seed, lane, dim) streams."""
    index = jnp.asarray(index, jnp.uint32)
    dim = jnp.asarray(dim, jnp.uint32) % jnp.uint32(_SOBOL_DIMS)
    tab = jnp.asarray(_SOBOL_TABLE)  # (D, 32)
    cols = jnp.take(tab, dim, axis=0)  # (..., 32)
    x = jnp.zeros_like(index)
    for i in range(32):
        bit = (index >> jnp.uint32(i)) & jnp.uint32(1)
        x = jnp.where(bit == 1, x ^ cols[..., i], x)
    x = _reverse_bits(_owen_scramble(_reverse_bits(x), scramble_key))
    return _u32_to_float(x)


# first 20 primes for Halton/Hammersley radical inverses
_PRIMES = np.array([2, 3, 5, 7, 11, 13, 17, 19, 23, 29,
                    31, 37, 41, 43, 47, 53, 59, 61, 67, 71], np.uint32)


def radical_inverse(index, base, scramble_key=None):
    """Radical inverse of `index` in (traced) `base`, with optional per-digit
    scrambling (Faure-style digit randomization keyed by scramble_key;
    reference: src/samplers/halton.cpp + faure.cpp)."""
    index = jnp.asarray(index, jnp.uint32)
    base = jnp.asarray(base, jnp.uint32)
    basef = base.astype(jnp.float32)
    inv = 1.0 / basef
    x = index
    r = jnp.zeros(jnp.broadcast_shapes(index.shape, base.shape), jnp.float32)
    f = jnp.broadcast_to(inv, r.shape)
    # 32 digits covers u32 for base >= 2
    for i in range(32):
        d = x % base
        x = x // base
        if scramble_key is not None:
            h = _hash_u32(scramble_key + jnp.uint32((i * 0x9E3779B9) & 0xFFFFFFFF))
            d = (d + h % base) % base
        r = r + f * d.astype(jnp.float32)
        f = f * inv
    return jnp.minimum(r, 0.99999994)


def _kensler_permute(i, n, key):
    """Stateless pseudorandom permutation of [0, n) (cycle-walking hash;
    Kensler, 'Correlated Multi-Jittered Sampling')."""
    i = jnp.asarray(i, jnp.uint32)
    n = jnp.asarray(n, jnp.uint32)
    w = n - jnp.uint32(1)
    w |= w >> 1
    w |= w >> 2
    w |= w >> 4
    w |= w >> 8
    w |= w >> 16

    key = jnp.asarray(key, jnp.uint32)

    def rounds(x):
        # every step is a bijection on [0, w]: xor-with-constant, xor of
        # masked downshift, odd multiply (mod 2^32) followed by & w
        x ^= key
        x *= jnp.uint32(0xE170893D)
        x ^= key >> 16
        x ^= (x & w) >> 4
        x ^= key >> 8
        x *= jnp.uint32(0x0929EB3F)
        x ^= key >> 23
        x ^= (x & w) >> 1
        x *= jnp.uint32(1) | (key >> 27)
        x *= jnp.uint32(0x6935FA69)
        x ^= (x & w) >> 11
        x *= jnp.uint32(0x74DCCA23)
        x ^= (x & w) >> 2
        x *= jnp.uint32(0x9E501CC3)
        x ^= (x & w) >> 2
        x *= jnp.uint32(0xC860A3DF)
        x &= w
        x ^= x >> 5
        return x

    # cycle-walk until inside [0, n); bijective rounds guarantee termination
    x = rounds(i)
    x = jax.lax.while_loop(
        lambda v: jnp.any(v >= n), lambda v: jnp.where(v >= n, rounds(v), v), x)
    return (x + key) % jnp.maximum(n, 1)


@jax.tree_util.register_pytree_node_class
class Sampler:
    """Stateless sampler stream. `lane` identifies the pixel/ray, `index` the
    sample number within the pixel, `dim` the next dimension to draw.
    `mode` is static (part of the pytree structure) so jit specializes on it."""

    def __init__(self, lane, index, dim, seed, mode: int = INDEPENDENT,
                 n_samples: int = 16, table=None):
        self.lane = lane
        self.index = index
        self.dim = dim
        self.seed = seed
        self.mode = mode
        self.n_samples = n_samples  # static: spp (stratified/hammersley)
        self.table = table          # VECTOR mode: (N, D) uniforms

    def _replace(self, **kw):
        d = dict(lane=self.lane, index=self.index, dim=self.dim,
                 seed=self.seed, mode=self.mode, n_samples=self.n_samples,
                 table=self.table)
        d.update(kw)
        return Sampler(**d)

    def tree_flatten(self):
        return ((self.lane, self.index, self.dim, self.seed, self.table),
                (self.mode, self.n_samples))

    @classmethod
    def tree_unflatten(cls, aux, children):
        mode, n_samples = aux if isinstance(aux, tuple) else (aux, 16)
        return cls(*children[:4], mode=mode, n_samples=n_samples,
                   table=children[4] if len(children) > 4 else None)


def make_sampler(seed, lane, sample_index, mode: int = INDEPENDENT,
                 n_samples: int = 16) -> Sampler:
    return Sampler(
        lane=jnp.asarray(lane, jnp.uint32),
        index=jnp.asarray(sample_index, jnp.uint32),
        dim=jnp.zeros_like(jnp.asarray(lane, jnp.uint32)),
        seed=jnp.asarray(seed, jnp.uint32),
        mode=mode,
        n_samples=n_samples,
    )


def _independent_bits(s: Sampler, dim_offset) -> jnp.ndarray:
    return _hash_u32(
        hash_combine(s.seed, s.lane, s.index, s.dim + jnp.uint32(dim_offset))
    )


def _vector_draw(s: Sampler, k: int):
    # read dims [dim, dim+k) from the replay table; falls back to hashing
    # past the table end (long paths beyond the mutated prefix)
    D = s.table.shape[-1]
    outs = []
    for i in range(k):
        idx = s.dim + jnp.uint32(i)
        inb = idx < D
        v_tab = jnp.take_along_axis(
            s.table, jnp.minimum(idx, D - 1)[..., None].astype(jnp.int32),
            axis=-1)[..., 0]
        v_hash = _u32_to_float(_independent_bits(s, i))
        outs.append(jnp.where(inb, v_tab, v_hash))
    return outs


def next_1d(s: Sampler):
    if s.mode == VECTOR:
        (v,) = _vector_draw(s, 1)
        return v, s._replace(dim=s.dim + jnp.uint32(1))
    if s.mode == LDS:
        scramble = hash_combine(s.seed, s.lane, s.dim)
        shuffled = _owen_scramble(_reverse_bits(s.index), hash_combine(scramble, jnp.uint32(0x55)))
        x = _reverse_bits(_owen_scramble(_reverse_bits(shuffled), scramble))
        value = _u32_to_float(x)
    elif s.mode == STRATIFIED:
        # stratified.cpp: one permuted stratum per sample + jitter
        n = jnp.uint32(max(s.n_samples, 1))
        key = hash_combine(s.seed, s.lane, s.dim)
        p = _kensler_permute(s.index % n, n, key)
        jit = _u32_to_float(_independent_bits(s, 0))
        value = (p.astype(jnp.float32) + jit) / n.astype(jnp.float32)
    elif s.mode in (HALTON, HAMMERSLEY):
        base = jnp.take(jnp.asarray(_PRIMES), s.dim % jnp.uint32(len(_PRIMES)))
        key = hash_combine(s.seed, s.lane, s.dim)
        value = radical_inverse(s.index, base, scramble_key=key)
    elif s.mode == SOBOL:
        key = hash_combine(s.seed, s.lane, s.dim)
        value = sobol_sample(s.index, s.dim, key)
    else:
        value = _u32_to_float(_independent_bits(s, 0))
    return value, s._replace(dim=s.dim + jnp.uint32(1))


def next_2d(s: Sampler):
    if s.mode == VECTOR:
        a, b = _vector_draw(s, 2)
        return jnp.stack([a, b], axis=-1), s._replace(dim=s.dim + jnp.uint32(2))
    if s.mode == LDS:
        pair_scramble = hash_combine(s.seed, s.lane, s.dim)
        # Owen-shuffle the sample index per dimension-pair (padded sequence),
        # then draw the (0,2)-sequence point and Owen-scramble each axis.
        # idx = LK(reverse(index)) lives in the bit-reversed domain: it is both
        # the shuffled index's van-der-Corput bits (x axis) and, reversed, the
        # shuffled index itself (fed to the second Sobol' dimension).
        idx = _owen_scramble(_reverse_bits(s.index), hash_combine(pair_scramble, jnp.uint32(0xA5)))
        x_bits = idx
        y_bits = _sobol_2nd_dim(_reverse_bits(idx))
        x = _reverse_bits(_owen_scramble(_reverse_bits(x_bits), hash_combine(pair_scramble, jnp.uint32(1))))
        y = _reverse_bits(_owen_scramble(_reverse_bits(y_bits), hash_combine(pair_scramble, jnp.uint32(2))))
        value = jnp.stack([_u32_to_float(x), _u32_to_float(y)], axis=-1)
    elif s.mode == STRATIFIED:
        # 2D stratification on a res x res grid (stratified.cpp); res = the
        # largest square <= n_samples, remaining samples jitter freely
        n = max(s.n_samples, 1)
        res = max(int(np.sqrt(n)), 1)
        n2 = jnp.uint32(res * res)
        key = hash_combine(s.seed, s.lane, s.dim)
        p = _kensler_permute(s.index % n2, n2, key)
        sx = (p % jnp.uint32(res)).astype(jnp.float32)
        sy = (p // jnp.uint32(res)).astype(jnp.float32)
        jx = _u32_to_float(_independent_bits(s, 0))
        jy = _u32_to_float(_independent_bits(s, 1))
        value = jnp.stack([(sx + jx) / res, (sy + jy) / res], axis=-1)
    elif s.mode in (HALTON, HAMMERSLEY):
        nb = len(_PRIMES)
        b0 = jnp.take(jnp.asarray(_PRIMES), s.dim % jnp.uint32(nb))
        b1 = jnp.take(jnp.asarray(_PRIMES), (s.dim + 1) % jnp.uint32(nb))
        k0 = hash_combine(s.seed, s.lane, s.dim)
        k1 = hash_combine(s.seed, s.lane, s.dim + jnp.uint32(1))
        if s.mode == HAMMERSLEY:
            # hammersley.cpp: first dimension pair uses i/N as the x axis
            n = jnp.float32(max(s.n_samples, 1))
            shuffled = _kensler_permute(
                s.index % jnp.uint32(max(s.n_samples, 1)),
                jnp.uint32(max(s.n_samples, 1)), hash_combine(k0, jnp.uint32(7)))
            x = jnp.where(s.dim == 0,
                          (shuffled.astype(jnp.float32) +
                           _u32_to_float(_independent_bits(s, 2))) / n,
                          radical_inverse(s.index, b0, scramble_key=k0))
        else:
            x = radical_inverse(s.index, b0, scramble_key=k0)
        y = radical_inverse(s.index, b1, scramble_key=k1)
        value = jnp.stack([x, y], axis=-1)
    elif s.mode == SOBOL:
        k0 = hash_combine(s.seed, s.lane, s.dim)
        k1 = hash_combine(s.seed, s.lane, s.dim + jnp.uint32(1))
        value = jnp.stack([
            sobol_sample(s.index, s.dim, k0),
            sobol_sample(s.index, s.dim + jnp.uint32(1), k1),
        ], axis=-1)
    else:
        value = jnp.stack(
            [
                _u32_to_float(_independent_bits(s, 0)),
                _u32_to_float(_independent_bits(s, 1)),
            ],
            axis=-1,
        )
    return value, s._replace(dim=s.dim + jnp.uint32(2))
