"""Kernels as compiled for the GPU, against their plain-JAX references.

These tests need an NVIDIA GPU: the Triton-route kernels have no CPU
compilation. They skip elsewhere (the CPU suite covers the same kernels in
the Pallas interpreter) and run in chip_smoke.py's chip-test phase. The
`gpu` fixture decides at run time, never at import, whether a GPU is
present, so every worker collects the same tests.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

pytestmark = pytest.mark.chip


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: Triton-route kernels compile only there")


def _fields(kind, prm):
    from mitsubaer_tpu.models import eikonal as ek

    rif = ek.RifField(kind=jnp.asarray(kind, jnp.int32),
                      params=jnp.asarray(prm, jnp.float32),
                      coeff=jnp.zeros(()), aabb_min=jnp.zeros(3),
                      aabb_max=jnp.ones(3))
    sdf = ek.SdfField(kind=jnp.asarray(ek.SDF_SPHERE, jnp.int32),
                      params=jnp.asarray([0, 0, 0, 1, 0, 0, 0, 0],
                                         jnp.float32),
                      coeff=jnp.zeros(()), aabb_min=jnp.zeros(3),
                      aabb_max=jnp.ones(3))
    return rif, sdf


def test_selector_picks_triton_on_gpu(gpu):
    from mitsubaer_tpu.core import kernels

    assert kernels.route() == kernels.TRITON


@pytest.mark.parametrize("kind,prm", [
    (1, (1.3, 0.15, 0.05, -0.1, 0, 0, 0, 0)),
    (2, (1.2, 0.4, 0.6, 0.1, -0.1, 0.0, 0, 0)),
])
def test_ermarch_trace_compiled_matches_xla(gpu, kind, prm):
    from mitsubaer_tpu.models import eikonal as ek
    from mitsubaer_tpu.models import ermarch

    rng = np.random.default_rng(0)
    n = 1000
    rif, sdf = _fields(kind, prm)
    p = jnp.asarray(rng.uniform(-0.5, 0.5, (n, 3)), jnp.float32)
    v = rng.standard_normal((n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v = jnp.asarray(v * np.asarray(ek.rif_value(rif, p))[:, None])
    dist = jnp.asarray(rng.uniform(0.3, 1.5, (n,)), jnp.float32)
    act = jnp.ones((n,), bool)
    ra = jax.jit(ek._trace_curved_xla, static_argnums=(6,))(
        rif, sdf, p, v, dist, 0.01, 300, act)
    rb = ermarch.trace(rif, sdf, p, v, dist, 0.01, 300, act)
    # 300 dependent steps accumulate a different rounding (FMA contraction)
    for i in range(4):
        np.testing.assert_allclose(np.asarray(rb[i]), np.asarray(ra[i]),
                                   atol=1e-4, rtol=1e-4)
    assert (np.asarray(ra[4]) == np.asarray(rb[4])).mean() >= 0.999


def test_boxwalk_compiled_matches_plain_body(gpu):
    from mitsubaer_tpu.integrators import boxwalk
    from mitsubaer_tpu.scene import presets

    scene, cfg = presets.volumetric_box(res=32, spp=1, heterogeneous=True,
                                        density_res=16, max_depth=6)
    cfg = cfg._replace(filter="box", engine="wavefront")
    La, sa = boxwalk.render_boxwalk(scene, cfg, 4, jnp.uint32(1),
                                    jnp.uint32(0), route="xla")
    Lb, sb = boxwalk.render_boxwalk(scene, cfg, 4, jnp.uint32(1),
                                    jnp.uint32(0), route="triton")
    La, Lb = np.asarray(La), np.asarray(Lb)
    assert np.isfinite(Lb).all() and int(sb[3]) == 0
    # FMA contraction can flip a few `u < p` branches: per-pixel agreement
    # on >= 99% of pixels, image means within 1e-3 relative
    close = np.isclose(Lb, La, rtol=1e-4, atol=1e-7).all(-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(Lb.mean() - La.mean()) <= 1e-3 * abs(La.mean())
