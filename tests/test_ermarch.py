"""ER march kernels (models/ermarch.py) must reproduce the XLA loops
step for step (same math, same stop logic) for every analytic RIF kind.
The Triton-route kernels run here in the Pallas interpreter; on a GPU the
render path switches to them via the gate in eikonal.trace_curved /
integrate_with_sensitivities (core/kernels.py picks the route), and
tests/test_chip.py checks them as compiled for the card."""
import numpy as np
import jax.numpy as jnp
import pytest

from mitsubaer_tpu.models import eikonal as ek
from mitsubaer_tpu.models import ermarch


def _fields(kind, prm):
    rif = ek.RifField(kind=jnp.asarray(kind, jnp.int32),
                      params=jnp.asarray(prm, jnp.float32),
                      coeff=jnp.zeros(()), aabb_min=jnp.zeros(3),
                      aabb_max=jnp.ones(3))
    sdf = ek.SdfField(kind=jnp.asarray(ek.SDF_SPHERE, jnp.int32),
                      params=jnp.asarray([0, 0, 0, 1, 0, 0], jnp.float32),
                      coeff=jnp.zeros(()), aabb_min=jnp.zeros(3),
                      aabb_max=jnp.ones(3))
    return rif, sdf


@pytest.mark.parametrize("kind,prm", [
    (ek.RIF_LINEAR, (1.3, 0.15, 0.05, -0.1, 0, 0, 0, 0)),
    (ek.RIF_RADIAL, (1.2, 0.4, 0.6, 0.1, -0.1, 0.0, 0, 0)),
    (ek.RIF_CONST, (1.4, 0, 0, 0, 0, 0, 0, 0)),
])
def test_trace_kernel_matches_xla(kind, prm):
    rng = np.random.default_rng(0)
    n = 128
    rif, sdf = _fields(kind, prm)
    p = jnp.asarray(rng.uniform(-0.5, 0.5, (n, 3)), jnp.float32)
    v = rng.standard_normal((n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v = jnp.asarray(v * np.asarray(ek.rif_value(rif, p))[:, None])
    dist = jnp.asarray(rng.uniform(0.3, 1.5, (n,)), jnp.float32)
    act = jnp.ones((n,), bool)
    ra = ek._trace_curved_xla(rif, sdf, p, v, dist, 0.01, 300, act)
    rb = ermarch.trace(rif, sdf, p, v, dist, 0.01, 300, act, B=128,
                       interpret=True)
    for i in range(4):
        np.testing.assert_allclose(np.asarray(ra[i]), np.asarray(rb[i]),
                                   atol=3e-6, rtol=1e-5)
    assert (np.asarray(ra[4]) == np.asarray(rb[4])).all()


@pytest.mark.parametrize("kind,prm", [
    (ek.RIF_LINEAR, (1.3, 0.15, 0.05, -0.1, 0, 0, 0, 0)),
    (ek.RIF_RADIAL, (1.2, 0.4, 0.6, 0.1, -0.1, 0.0, 0, 0)),
])
def test_sens_kernel_matches_xla_march(kind, prm):
    """The sensitivity march: kernel vs a literal transcription of the
    integrate_with_sensitivities while-loop (eikonal.py:482-505)."""
    import jax

    from mitsubaer_tpu.models.medium import bounded_while

    rng = np.random.default_rng(1)
    n = 128
    h = 0.01
    rif, sdf = _fields(kind, prm)
    p1 = jnp.asarray(rng.uniform(-0.4, 0.4, (n, 3)), jnp.float32)
    v0 = jnp.asarray(rng.standard_normal((n, 3)), jnp.float32)
    p2 = jnp.asarray(rng.uniform(-0.8, 0.8, (n, 3)), jnp.float32)
    act = jnp.ones((n,), bool)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32), (n, 3, 3))
    r0 = ek.rif_value(rif, p1)
    nv = jnp.linalg.norm(v0, axis=-1)
    dvdv0 = (r0 / jnp.maximum(nv, 1e-12) ** 3)[..., None, None] * (
        (nv ** 2)[..., None, None] * eye
        - jnp.einsum("...i,...j->...ij", v0, v0))
    vn = v0 / jnp.maximum(nv, 1e-12)[..., None] * r0[..., None]
    dpdv0 = jnp.zeros((n, 3, 3), jnp.float32)

    def sign_of(pp, vv):
        return jnp.sum((pp - p2) * vv, -1) < 0

    def cond(st):
        return jnp.any(st[6]) & (st[8] < 300)

    def body(st):
        pp, vv, dp_, dv_, opt, marched, running, crossed, it = st
        p2_, v2_, dp2, dv2 = ek.er_derivative_step(rif, pp, vv, dp_, dv_, h)
        out = ~ek.inside_shape(sdf, p2_)
        flip = sign_of(p2_, v2_) != sign_of(pp, vv)
        stop = out | flip
        take = running & ~stop
        n_here = ek.rif_value(rif, pp)
        pp = jnp.where(take[..., None], p2_, pp)
        vv = jnp.where(take[..., None], v2_, vv)
        dp_ = jnp.where(take[..., None, None], dp2, dp_)
        dv_ = jnp.where(take[..., None, None], dv2, dv_)
        opt = jnp.where(take, opt + h * n_here, opt)
        marched = jnp.where(take, marched + h, marched)
        crossed = crossed | (running & out)
        running = running & ~stop
        return (pp, vv, dp_, dv_, opt, marched, running, crossed, it + 1)

    st = (p1, vn, dpdv0, dvdv0, jnp.zeros((n,)), jnp.zeros((n,)), act,
          jnp.zeros((n,), bool), jnp.int32(0))
    ref = bounded_while(cond, body, st, 300, False)
    ra = (ref[0], ref[1], ref[2], ref[3], ref[4], ref[5], ref[7])
    rb = ermarch.sens_march(rif, sdf, p1, vn, dpdv0, dvdv0, p2, h, 300,
                            act, B=128, interpret=True)
    for i in range(6):
        np.testing.assert_allclose(np.asarray(ra[i]), np.asarray(rb[i]),
                                   atol=3e-6, rtol=1e-4)
    assert (np.asarray(ra[6]) == np.asarray(rb[6])).all()
