"""The kernel selector (core/kernels.py): plain XLA off the GPU, the
Triton-route kernels on it, and an error where a forced kernel cannot run."""
import numpy as np
import pytest
import jax.numpy as jnp

from mitsubaer_tpu.core import kernels


@pytest.mark.parametrize("policy,backend,expect", [
    ("auto", "cpu", "xla"),
    ("xla", "cpu", "xla"),
    ("auto", "gpu", "triton"),
    ("triton", "gpu", "triton"),
    ("xla", "gpu", "xla"),
])
def test_route_table(policy, backend, expect):
    assert kernels.route(policy, backend=backend) == expect


def test_route_picks_xla_on_this_backend():
    # the test suite runs on the CPU backend (conftest.py)
    assert kernels.route() == kernels.XLA
    assert kernels.route("auto") == kernels.XLA


def test_forced_kernel_off_gpu_raises():
    with pytest.raises(ValueError, match="needs a GPU"):
        kernels.route("triton")
    with pytest.raises(ValueError, match="expected one of"):
        kernels.route("tpu")


def test_forced_kernel_raises_through_render():
    from mitsubaer_tpu.integrators import render as rm
    from mitsubaer_tpu.scene import presets

    scene, cfg = presets.volumetric_box(res=4, spp=1, heterogeneous=True,
                                        density_res=8, max_depth=2)
    cfg = cfg._replace(filter="box", engine="wavefront", kernels="triton")
    with pytest.raises(ValueError, match="needs a GPU"):
        rm.render(scene, cfg)


def test_forced_kernel_raises_through_eikonal_march():
    from mitsubaer_tpu.models import eikonal as ek

    rif = ek.RifField(kind=jnp.asarray(ek.RIF_LINEAR, jnp.int32),
                      params=jnp.asarray([1.3, 0.1, 0, 0, 0, 0, 0, 0],
                                         jnp.float32),
                      coeff=jnp.zeros(()), aabb_min=jnp.zeros(3),
                      aabb_max=jnp.ones(3))
    sdf = ek.SdfField(kind=jnp.asarray(ek.SDF_SPHERE, jnp.int32),
                      params=jnp.asarray([0, 0, 0, 1, 0, 0, 0, 0],
                                         jnp.float32),
                      coeff=jnp.zeros(()), aabb_min=jnp.zeros(3),
                      aabb_max=jnp.ones(3))
    p = jnp.zeros((4, 3), jnp.float32)
    v = jnp.tile(jnp.asarray([[1.3, 0.0, 0.0]], jnp.float32), (4, 1))
    act = jnp.ones((4,), bool)
    out = ek.trace_curved(rif, sdf, p, v, jnp.full((4,), 0.5), 0.01, 100,
                          act)                       # auto: XLA here
    np.testing.assert_allclose(np.asarray(out[3]), 0.5, rtol=1e-4)
    with pytest.raises(ValueError, match="needs a GPU"):
        ek.trace_curved(rif, sdf, p, v, jnp.full((4,), 0.5), 0.01, 100,
                        act, kernels="triton")
