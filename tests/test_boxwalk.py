"""Whole-path renderer (integrators/boxwalk.py) correctness.

The Pallas kernel (run here in the Pallas interpreter) must reproduce the
plain-JAX run of the same per-trip body. The per-lane tracking step is
checked against closed-form free-flight / transmittance results, driven
through the real state machine as plain JAX.

The beam-lit volumetric scene's MEAN is dominated by a near-beam 1/h
spike that finite-spp estimators rarely sample, so the (slow) parity
checks use the MEDIAN per-pixel ratio against the deterministic
double-scatter beam quadrature (utils/validate.py) and the wavefront
engine.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from mitsubaer_tpu.integrators import boxwalk
from mitsubaer_tpu.scene import presets


def _scene(res=12, density_res=16, max_depth=2):
    scene, cfg = presets.volumetric_box(
        res=res, spp=1, heterogeneous=True, density_res=density_res,
        max_depth=max_depth)
    return scene, cfg._replace(filter="box", engine="wavefront")


def test_supported_gate():
    scene, cfg = _scene()
    assert boxwalk.supported(scene, cfg)
    assert not boxwalk.supported(scene, cfg._replace(filter="gaussian"))
    assert not boxwalk.supported(scene, cfg._replace(engine="loop"))
    cb, cbc = presets.cornell_box(res=8)
    assert not boxwalk.supported(cb, cbc._replace(filter="box",
                                                  engine="wavefront"))


def test_kernel_matches_plain_body():
    """Pallas kernel (interpreter, 4 blocks of 16 lanes) == the plain
    while_loop over the same per-trip body, lane for lane."""
    scene, cfg = _scene(res=8, max_depth=4)
    La, sa = boxwalk.render_boxwalk(scene, cfg, 2, jnp.uint32(1),
                                    jnp.uint32(0), route="xla")
    Lb, sb = boxwalk.render_boxwalk(scene, cfg, 2, jnp.uint32(1),
                                    jnp.uint32(0), route="triton", B=16,
                                    interpret=True)
    La, Lb = np.asarray(La), np.asarray(Lb)
    assert La.shape == (64, 3) and np.isfinite(La).all() and La.mean() > 0
    np.testing.assert_allclose(Lb, La, rtol=1e-6, atol=1e-9)
    assert [int(x) for x in sa] == [int(x) for x in sb]
    assert int(sa[3]) == 0                     # every sample completed


# ---------------------------------------------------------------------------
# The per-lane tracking step, driven through boxwalk._trip as plain JAX.
# Density grid in voxel units: aabb_min = 0, inv_h = 1.
# ---------------------------------------------------------------------------
def _track(d, o, dirs, tlim, maj, sig, w_real, shadow, seed=7,
           max_trips=2048):
    """Run lanes that start in TRACK (or SHADOW) mode until each has left
    it once. Returns (t, tp, L_out, taps) per lane. depth = max_depth, so
    a real collision ends the sample at its collision point; shadow lanes
    carry sh_val = 1 and no continuation, so they emit their ratio-tracking
    transmittance as L."""
    nz, ny, nx = d.shape
    n = o.shape[0]
    S = boxwalk._Static(sppc=1, max_depth=1, rr_depth=1 << 20, width=1,
                        height=1, npix=n, stride=0, res=(nx, ny, nz))
    prm = np.zeros(boxwalk._P_NP, np.float32)
    prm[boxwalk._P_STMS] = sig
    prm[boxwalk._P_STCS:boxwalk._P_STCS + 3] = sig
    prm[boxwalk._P_MAJ] = maj
    prm[boxwalk._P_INVH:boxwalk._P_INVH + 3] = 1.0
    prm[boxwalk._P_WR:boxwalk._P_WR + 3] = w_real
    prm[boxwalk._P_EPS] = 1e-4
    prm[boxwalk._P_BS1] = 1.0
    prm[boxwalk._P_BEAMD + 2] = 1.0            # beam power 0: no NEE value
    params = jnp.asarray(prm)
    dens = jnp.asarray(d.reshape(-1))
    beam = jnp.zeros((boxwalk.BEAM_N * boxwalk.BEAM_W,), jnp.float32)
    f = lambda a: jnp.asarray(a, jnp.float32)
    o3 = tuple(f(o[:, a]) for a in range(3))
    d3 = tuple(f(dirs[:, a]) for a in range(3))
    one3 = (f(np.ones(n)),) * 3
    st = boxwalk._init_lanes((n,))._replace(
        m=jnp.full((n,), boxwalk._SHADOW if shadow else boxwalk._TRACK,
                   jnp.int32),
        idx=jnp.zeros((n,), jnp.int32), depth=jnp.ones((n,), jnp.int32),
        t_end=f(tlim), p=o3, d=d3, tp=one3,
        sh_seg=f(tlim), sh_o=o3, sh_d=d3, sh_tr=one3, sh_val=one3)
    lane = jnp.arange(n, dtype=jnp.int32)

    @jax.jit
    def run(st):
        def cond(c):
            return (c[0] < max_trips) & jnp.any(
                (c[1].m == boxwalk._TRACK) | (c[1].m == boxwalk._SHADOW))

        def body(c):
            it, s, acc = c
            s, fin, _, L = boxwalk._trip(
                s, lambda i: params[i], lambda i: dens[i],
                lambda i: beam[i], lane, jnp.uint32(seed), S)
            return it + 1, s, acc + jnp.where(fin, L[0], 0.0)

        return jax.lax.while_loop(cond, body, (0, st, jnp.zeros((n,))))

    _, st, L = run(st)
    assert int(jnp.sum((st.m == boxwalk._TRACK)
                       | (st.m == boxwalk._SHADOW))) == 0
    return (np.asarray(st.t), np.asarray(st.tp[0]), np.asarray(L),
            np.asarray(st.taps))


def test_track_zero_density_escapes_with_unit_weight():
    n = 512
    rng = np.random.default_rng(0)
    d = np.zeros((8, 8, 8), np.float32)
    o = rng.random((n, 3)).astype(np.float32) * 7
    dirs = rng.standard_normal((n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    tlim = (rng.random(n) * 2 + 0.5).astype(np.float32)
    t, tp, L, taps = _track(d, o, dirs, tlim, maj=4.0, sig=1.0,
                            w_real=1.0, shadow=False)
    np.testing.assert_allclose(t, tlim, rtol=1e-6)    # every lane escapes
    np.testing.assert_allclose(tp, 1.0, rtol=1e-6)    # null weight = 1
    assert (taps >= 1).all()
    np.testing.assert_array_equal(L, 0.0)             # no light source


def test_track_constant_density_collision_rate():
    """Free flight through constant sigma_t: P(scatter before tlim) =
    1 - exp(-sigma * tlim); grey medium -> null weight 1, real weight =
    w_real; collision distances are truncated-exponential."""
    n = 4096
    d = np.full((8, 8, 8), 0.5, np.float32)
    sig = 2.0
    o = np.tile(np.array([[0.5, 3.5, 3.5]], np.float32), (n, 1))
    dirs = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (n, 1))
    tlim = np.full(n, 4.0, np.float32)
    t, tp, _, _ = _track(d, o, dirs, tlim, maj=0.5 * sig, sig=sig,
                         w_real=0.9, shadow=False, seed=1)
    scat = t < tlim - 1e-6
    p_true = 1 - np.exp(-0.5 * sig * 4.0)
    assert abs(scat.mean() - p_true) < 0.03, (scat.mean(), p_true)
    np.testing.assert_allclose(tp[~scat], 1.0, rtol=1e-5)
    np.testing.assert_allclose(tp[scat], 0.9, rtol=1e-5)
    lam = 0.5 * sig
    m_true = 1 / lam - 4.0 * np.exp(-lam * 4.0) / (1 - np.exp(-lam * 4.0))
    assert abs(t[scat].mean() - m_true) < 0.08, (t[scat].mean(), m_true)


def test_track_shadow_ratio_tracking_transmittance():
    """Ratio tracking through a linear-ramp density: E[Tr] = exp(-tau)."""
    n = 8192
    d = np.zeros((8, 8, 16), np.float32)
    d[:] = np.linspace(0.0, 1.0, 16)[None, None, :]   # ramp along x
    sig = 1.5
    o = np.tile(np.array([[0.0, 3.5, 3.5]], np.float32), (n, 1))
    dirs = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (n, 1))
    tlim = np.full(n, 15.0, np.float32)
    _, _, tr, _ = _track(d, o, dirs, tlim, maj=1.0 * sig, sig=sig,
                         w_real=1.0, shadow=True, seed=3)
    # tau = sig * integral of the trilinear ramp over [0,15] = sig * 7.5
    tr_true = np.exp(-sig * 7.5)
    se = tr.std() / np.sqrt(n)
    assert abs(tr.mean() - tr_true) < max(4 * se, 0.05 * tr_true), \
        (tr.mean(), tr_true, se)


@pytest.mark.slow
def test_boxwalk_matches_beam_quadrature_median():
    from mitsubaer_tpu.utils.validate import beam_double_scatter_quadrature

    res = 12
    scene, cfg = _scene(res=res)
    truth = beam_double_scatter_quadrature(scene, cfg).mean(-1).ravel()
    npix = res * res
    sppc = 64
    acc = np.zeros(npix)
    P = 4
    for s in range(P):
        L, stats = boxwalk.render_boxwalk(
            scene, cfg, sppc, jnp.uint32(s + 1), jnp.uint32(s), route="xla")
        acc += np.asarray(L).mean(-1) / sppc
        assert int(stats[3]) == 0          # all samples completed
    acc /= P
    assert np.isfinite(acc).all()
    sel = truth > np.percentile(truth, 30)
    ratio = np.median(acc[sel] / truth[sel])
    assert 0.85 < ratio < 1.2, ratio


@pytest.mark.slow
def test_boxwalk_matches_wavefront_pixelwise():
    from mitsubaer_tpu.integrators.render import render_pass_wavefront

    res = 12
    scene, cfg = _scene(res=res, max_depth=6)
    npix = res * res
    sppc = 64
    acc_b = np.zeros(npix)
    acc_w = np.zeros(npix)
    for s in range(3):
        L, _ = boxwalk.render_boxwalk(scene, cfg, sppc, jnp.uint32(s + 1),
                                      jnp.uint32(s), route="xla")
        acc_b += np.asarray(L).mean(-1) / sppc
        Lw, _ = render_pass_wavefront(
            scene, jnp.zeros((npix, 3)), cfg, sppc, jnp.uint32(s + 1),
            jnp.uint32(s), has_direct=False, any_het=True)
        acc_w += np.asarray(Lw).mean(-1) / sppc
    sel = acc_w > np.percentile(acc_w, 30)
    ratio = np.median(acc_b[sel] / np.maximum(acc_w[sel], 1e-12))
    assert 0.8 < ratio < 1.25, ratio
