"""Smoke test of the renderer's main path on NVIDIA GPUs.

    python chip_smoke.py           # one GPU: every phase below
    python chip_smoke.py --four    # four GPUs: the sharded paths only

One GPU, in order:

  chip tests  the `chip`-marked tests (kernels as compiled for the card)
              run by pytest in a child process that ends before this
              process first touches the card;
  flagship    the heterogeneous volumetric scene (512^2, spp 32, depth 12,
              64^3 density, box filter, collimated beam) through
              render.render, with traced segments per second;
  eikonal     the linear-RIF eikonal (curved-ray) render at 96^2 spp 2
              through render.render;
  gradients   a radial-RIF parameter gradient (32^2) and one
              inverse-rendering step on the heterogeneous scene (128^2,
              sppc 4, 64^3 grid) through diff.render plus an optax update;
  kernels     each hand-written kernel against its plain-JAX reference at
              the phase's widths, with times for both.

Every phase prints its first-call seconds (compile + one run) and, where
timed, the median of 3 further runs ended by block_until_ready. The last
line is one JSON object {"ok": true, "device": {...}}. The script exits
non-zero, without that line, when JAX finds no GPU or any phase fails.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
REPS = 3


def _run_chip_tests():
    """pytest -m chip in a child process; it must finish before this
    process opens the card (a JAX process reserves most of its memory)."""
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "chip", "-rs",
         "-p", "no:cacheprovider", os.path.join(ROOT, "tests",
                                                "test_chip.py")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    tail = r.stdout.strip().splitlines()[-1:] or [r.stderr[-2000:]]
    print(f"[chip-tests] {tail[0]} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    if r.returncode != 0 or "skipped" in r.stdout or "passed" not in r.stdout:
        print(r.stdout[-6000:], r.stderr[-6000:], sep="\n")
        raise SystemExit("chip tests failed")


def timed(fn, reps=REPS):
    """(result, first-call seconds, median steady seconds)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return out, first, statistics.median(ts) if ts else float("nan")


def _check(cond, what):
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# Scenes
# ---------------------------------------------------------------------------
def flagship_scene(res=512, spp=32, density_res=64, max_depth=12):
    """The heterogeneous volumetric scene as bench.py builds it."""
    from mitsubaer_tpu.scene import presets

    scene, cfg = presets.volumetric_box(
        res=res, spp=spp, heterogeneous=True, density_res=density_res,
        max_depth=max_depth)
    return scene, cfg._replace(filter="box", engine="wavefront",
                               wf_track_iters=3, wf_mini_passes=2)


def eikonal_scene(res=96, spp=2, max_steps=256):
    """bench.py's linear-RIF eikonal forward config."""
    from mitsubaer_tpu.models import eikonal as ek
    from mitsubaer_tpu.scene import presets

    scene, cfg = presets.refractive_sphere(
        res=res, spp=spp, max_depth=6, rif_kind=ek.RIF_LINEAR,
        rif_params=(1.3, 0.15, 0.0, 0.0), er_stepsize=1e-2,
        emitter="point", filter="box")
    return scene, cfg._replace(er_maxsteps=max_steps, bvp_restarts=8,
                               er_bvp_hscale=4.0)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------
def phase_flagship(**size):
    import jax
    import numpy as np

    from mitsubaer_tpu.integrators import render as rm
    from mitsubaer_tpu.utils import stats

    scene, cfg = flagship_scene(**size)
    scene = jax.device_put(scene)

    def run():
        stats.reset()
        return rm.render(scene, cfg, seed=0)

    img, first, steady = timed(run)
    segs = stats.snapshot()["render.segments"]
    img = np.asarray(img)
    _check(img.shape == (cfg.height, cfg.width, 3), f"shape {img.shape}")
    _check(np.isfinite(img).all() and img.mean() > 0, "image not finite/>0")
    print(f"[flagship] {cfg.width}x{cfg.height} spp{cfg.spp} "
          f"depth{cfg.max_depth} density{scene.media.density.data.shape[0]}^3"
          f" | first call {first:.2f} s, steady {steady:.4f} s | "
          f"{segs:.0f} segments, {segs / steady / 1e6:.2f} M segments/s | "
          f"mean {img.mean():.6f}", flush=True)
    return scene, cfg


def phase_eikonal(**size):
    import jax
    import numpy as np

    from mitsubaer_tpu.integrators import render as rm

    scene, cfg = eikonal_scene(**size)
    scene = jax.device_put(scene)
    img, first, steady = timed(lambda: rm.render(scene, cfg, seed=1))
    img = np.asarray(img)
    _check(np.isfinite(img).all() and img.mean() > 0, "ER image not finite")
    n = cfg.width * cfg.height * cfg.spp
    print(f"[eikonal] {cfg.width}x{cfg.height} spp{cfg.spp} "
          f"er_maxsteps{cfg.er_maxsteps} | first call {first:.2f} s, "
          f"steady {steady:.4f} s | {n / steady / 1e6:.4f} M samples/s | "
          f"mean {img.mean():.6f}", flush=True)
    return scene, cfg


def phase_rif_gradient(res=32, spp=2):
    """d(mean radiance)/d(RIF params), radial RIF (bench.py config 5)."""
    import functools

    import jax
    import jax.numpy as jnp
    import numpy as np

    from mitsubaer_tpu.core import rng
    from mitsubaer_tpu.integrators import volpath_er
    from mitsubaer_tpu.models import eikonal as ek
    from mitsubaer_tpu.models import sensor as sensor_m
    from mitsubaer_tpu.scene import presets

    scene, cfg = presets.refractive_sphere(
        res=res, spp=spp, max_depth=4, rif_kind=ek.RIF_RADIAL,
        rif_params=(1.33, 0.1, 0.5, 0.0, 0.0, 0.0), er_stepsize=1e-2,
        emitter="point", filter="box")
    cfg = cfg._replace(er_maxsteps=192, bvp_restarts=8)
    scene = jax.device_put(scene)
    npix = res * res

    @functools.partial(jax.jit, static_argnames=("cfg", "sppc"))
    def grad_fn(scene, cfg, sppc, seed):
        def loss(params):
            sc = scene._replace(
                media=scene.media._replace(rif_params=params))
            pixel = jnp.tile(jnp.arange(npix, dtype=jnp.uint32), (sppc,))
            sidx = jnp.repeat(jnp.arange(sppc, dtype=jnp.uint32), npix)
            smp = rng.make_sampler(seed, pixel, sidx)
            jit2, smp = rng.next_2d(smp)
            px = (pixel % res).astype(jnp.float32) + jit2[:, 0]
            py = (pixel // res).astype(jnp.float32) + jit2[:, 1]
            rays = sensor_m.sample_rays(sc.sensor, px, py, res, res)
            sink, _ = volpath_er.li(sc, cfg, rays.o, rays.d, smp,
                                    pixel=pixel, differentiable=True)
            return jnp.mean(sink.steady)

        return jax.grad(loss)(scene.media.rif_params)

    g, first, steady = timed(lambda: grad_fn(scene, cfg, spp, jnp.uint32(1)))
    g = np.asarray(g)
    _check(np.isfinite(g).all() and np.any(g != 0), f"RIF grad {g}")
    print(f"[gradient/rif] radial RIF {res}x{res} spp{spp} | first call "
          f"{first:.2f} s, steady {steady:.4f} s | grad {np.round(g, 6)}",
          flush=True)


def phase_inverse_step(res=128, sppc=4, density_res=64, max_depth=12):
    """One inverse-rendering step: loss_and_grad + an optax Adam update."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from mitsubaer_tpu.diff import render as diff_render

    scene, cfg = flagship_scene(res=res, spp=sppc, density_res=density_res,
                                max_depth=max_depth)
    cfg = cfg._replace(engine="loop")
    scene = jax.device_put(scene)
    params = diff_render.get_params(scene)
    # a black target: the step's work does not depend on the target image
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    opt = optax.adam(1e-2)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state):
        loss, g = diff_render.loss_and_grad(scene, params, cfg, sppc,
                                            jnp.uint32(0), jnp.uint32(0),
                                            target)
        upd, opt_state = opt.update(g, opt_state, params)
        return optax.apply_updates(params, upd), opt_state, loss, g

    (p2, _, loss, g), first, steady = timed(lambda: step(params, opt_state))
    leaves = jax.tree.leaves(g)
    _check(all(np.isfinite(np.asarray(x)).all() for x in leaves),
           "inverse-step gradient not finite")
    _check(float(jnp.abs(g.sigma_s).max()) > 0
           and float(jnp.abs(g.density).max()) > 0,
           "inverse-step gradient is zero")
    _check(np.isfinite(float(loss)), "loss not finite")
    moved = float(jnp.abs(p2.density - params.density).max())
    print(f"[gradient/inverse] {res}x{res} sppc{sppc} density"
          f"{density_res}^3 depth{max_depth} | first call {first:.2f} s, "
          f"steady {steady:.4f} s | loss {float(loss):.6g} | "
          f"|dL/dsigma_s| {float(jnp.abs(g.sigma_s).max()):.4g} "
          f"|dL/ddensity|max {float(jnp.abs(g.density).max()):.4g} | "
          f"density moved {moved:.3g}", flush=True)


def kernel_boxwalk(scene, cfg, interpret=False, B=128, sweep=(128, 256)):
    """boxwalk (Triton) vs its plain body under jit vs the XLA wavefront
    engine, each rendering one whole flagship pass."""
    import jax.numpy as jnp
    import numpy as np

    from mitsubaer_tpu.integrators import boxwalk
    from mitsubaer_tpu.integrators.render import render_pass_wavefront

    sppc = cfg.spp
    npix = cfg.width * cfg.height
    seed, pidx = jnp.uint32(0), jnp.uint32(0)
    rows = []
    out = {}
    for b in sweep:
        (L, st), first, steady = timed(lambda: boxwalk.render_boxwalk(
            scene, cfg, sppc, seed, pidx, route="triton", B=b,
            interpret=interpret))
        out[b] = np.asarray(L)
        rows.append((f"boxwalk triton B={b}", first, steady, int(st[0])))
    (Lx, stx), first, steady = timed(lambda: boxwalk.render_boxwalk(
        scene, cfg, sppc, seed, pidx, route="xla"))
    rows.append(("boxwalk plain body (XLA)", first, steady, int(stx[0])))
    (Lw, stw), first, steady = timed(lambda: render_pass_wavefront(
        scene, jnp.zeros((npix, 3), jnp.float32), cfg, sppc,
        jnp.uint32(1), pidx, has_direct=False, any_het=True))
    rows.append(("wavefront engine (XLA)", first, steady, int(stw[0])))
    for name, first, steady, segs in rows:
        print(f"[kernel/boxwalk] {name}: first call {first:.2f} s, steady "
              f"{steady:.4f} s, {segs / steady / 1e6:.2f} M segments/s",
              flush=True)

    Lk, Lx, Lw = out[B], np.asarray(Lx), np.asarray(Lw)
    # same RNG streams: FMA contraction can flip a few `u < p` branches, so
    # per-pixel agreement (rtol 1e-4) on >= 99% of pixels and an image mean
    # within 1e-3 (relative)
    close = np.isclose(Lk, Lx, rtol=1e-4, atol=1e-7).all(-1).mean()
    dmean = abs(Lk.mean() - Lx.mean()) / abs(Lx.mean())
    print(f"[kernel/boxwalk] vs plain body: {close:.5f} of pixels within "
          f"rtol 1e-4, mean rel diff {dmean:.2e}", flush=True)
    _check(close >= 0.99 and dmean <= 1e-3, "boxwalk != plain body")
    # other RNG streams: median per-pixel ratio over the brighter pixels,
    # selected on the sum of both images so the selection favours neither
    a, w = Lk.mean(-1), Lw.mean(-1)
    sel = (a + w) > np.percentile(a + w, 30)
    ratio = float(np.median(a[sel] / np.maximum(w[sel], 1e-12)))
    print(f"[kernel/boxwalk] vs wavefront engine: median pixel ratio "
          f"{ratio:.4f} over {int(sel.sum())} pixels", flush=True)
    _check(0.9 <= ratio <= 1.1, f"boxwalk/wavefront ratio {ratio}")


def kernel_ermarch(scene, cfg, interpret=False):
    """ermarch (Triton) vs the XLA loops at the eikonal phase's widths,
    then the whole eikonal render timed with and without the kernels."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mitsubaer_tpu.integrators import render as rm
    from mitsubaer_tpu.models import eikonal as ek
    from mitsubaer_tpu.models import ermarch

    rif = ek.rif_from_media(scene.media)
    sdf = ek.sdf_from_media(scene.media)
    n = cfg.width * cfg.height * cfg.spp
    rng = np.random.default_rng(0)
    f32 = jnp.float32
    # lanes inside the unit sphere, random directions, |v| = n(p)
    p = rng.standard_normal((n, 3))
    p *= (rng.random((n, 1)) ** (1 / 3) * 0.95) / np.linalg.norm(
        p, axis=1, keepdims=True)
    p = jnp.asarray(p, f32)
    d = rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    v = jnp.asarray(d, f32) * ek.rif_value(rif, p)[:, None]
    dist = jnp.asarray(rng.uniform(0.1, 2.0, n), f32)
    act = jnp.ones((n,), bool)
    h, steps = cfg.er_stepsize, cfg.er_maxsteps

    def tol_report(name, ref, got, flags_ref, flags_got):
        worst = 0.0
        for r_, g_ in zip(ref, got):
            r_, g_ = np.asarray(r_), np.asarray(g_)
            # 256 dependent steps accumulate a different rounding
            ok = np.abs(g_ - r_) <= 1e-4 + 1e-4 * np.abs(r_)
            _check(ok.all(), f"{name}: {(~ok).sum()} values off")
            worst = max(worst, float(np.max(np.abs(g_ - r_))))
        agree = float((np.asarray(flags_ref) == np.asarray(flags_got)).mean())
        print(f"[kernel/ermarch] {name}: {n} lanes, max abs diff "
              f"{worst:.2e}, exit flags agree on {agree:.5f}", flush=True)
        _check(agree >= 0.999, f"{name}: exit flags agree {agree}")

    xla_trace = jax.jit(ek._trace_curved_xla, static_argnums=(6,))
    ra, f_x, s_x = timed(lambda: xla_trace(rif, sdf, p, v, dist, h, steps,
                                           act))
    rb, f_k, s_k = timed(lambda: ermarch.trace(rif, sdf, p, v, dist, h,
                                               steps, act,
                                               interpret=interpret))
    tol_report("trace", ra[:4], rb[:4], ra[4], rb[4])
    print(f"[kernel/ermarch] trace alone: kernel steady {s_k:.5f} s "
          f"(first {f_k:.2f} s), XLA loop steady {s_x:.5f} s "
          f"(first {f_x:.2f} s)", flush=True)

    # sensitivity march at the BVP's widths: 2x lanes (batched restart
    # prefix), h * er_bvp_hscale, max(steps / hscale, 16) steps
    hb = h * cfg.er_bvp_hscale
    sb = max(int(steps / cfg.er_bvp_hscale), 16)
    p2 = jnp.asarray(rng.uniform(-2.0, 2.0, (n, 3)), f32)
    p1 = jnp.concatenate([p, p])
    p2 = jnp.concatenate([p2, p2[::-1]])
    v0 = p2 - p1
    act2 = jnp.ones((2 * n,), bool)

    def iws(kernels):
        return jax.jit(lambda a, b, c: ek.integrate_with_sensitivities(
            rif, sdf, a, b, c, hb, sb, act2, kernels=kernels))

    iws_x, iws_k = iws("xla"), iws("xla" if interpret else "triton")
    ka, f_x, s_x = timed(lambda: iws_x(p1, v0, p2))
    kb, f_k, s_k = timed(lambda: iws_k(p1, v0, p2))
    # err = endpoint - p2 (p), v_eff (v), optical length, inside arc
    tol_report("sens_march", (ka[0], ka[6], ka[3], ka[4]),
               (kb[0], kb[6], kb[3], kb[4]), ka[2], kb[2])
    jerr = float(np.max(np.abs(np.asarray(kb[1]) - np.asarray(ka[1]))))
    print(f"[kernel/ermarch] integrate_with_sensitivities: kernel steady "
          f"{s_k:.5f} s (first {f_k:.2f} s), XLA loop steady {s_x:.5f} s "
          f"(first {f_x:.2f} s); Jacobian max abs diff {jerr:.2e}",
          flush=True)

    for warps in (4, 8):
        _, first, steady = timed(lambda: ermarch.sens_march(
            rif, sdf, p1, v0, jnp.zeros((2 * n, 3, 3)),
            jnp.broadcast_to(jnp.eye(3), (2 * n, 3, 3)), p2, hb, sb,
            jnp.ones((2 * n,), bool), num_warps=warps, interpret=interpret))
        print(f"[kernel/ermarch] sens_march alone num_warps={warps}: first "
              f"call {first:.2f} s, steady {steady:.5f} s", flush=True)

    if interpret:
        return
    for policy in ("auto", "xla"):
        c = cfg._replace(kernels=policy)
        img, first, steady = timed(lambda: rm.render(scene, c, seed=1))
        _check(np.isfinite(np.asarray(img)).all(), "ER render not finite")
        print(f"[kernel/ermarch] eikonal render kernels={policy}: first call "
              f"{first:.2f} s, steady {steady:.4f} s", flush=True)


def matmul_precision():
    """Do batched 3x3 f32 dots (the BVP Jacobian / normal equations) lose
    accuracy at DEFAULT precision on this card? Max relative error against
    float64, DEFAULT vs HIGHEST."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    rng = np.random.default_rng(0)
    A = rng.standard_normal((65536, 3, 3)).astype(np.float32)
    Bm = rng.standard_normal((65536, 3, 3)).astype(np.float32)
    ref = np.einsum("nij,njk->nik", A.astype(np.float64),
                    Bm.astype(np.float64))
    for prec in ("default", "highest"):
        got = np.asarray(jax.jit(lambda a, b: jnp.einsum(
            "nij,njk->nik", a, b, precision=prec))(A, Bm))
        err = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
        print(f"[kernel/precision] batched 3x3 einsum precision={prec}: "
              f"max rel error {err:.2e}", flush=True)


# ---------------------------------------------------------------------------
# Four GPUs
# ---------------------------------------------------------------------------
def four_gpus(res=64, spp=8, density_res=32, max_depth=6):
    """Sharded render and training step on a (data=2, tile=2) mesh against
    the same work on a (1,1) mesh. `_pass_shard` and `_loss_shard` give the
    two meshes identical sample sets, so only summation order differs."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from mitsubaer_tpu.diff import render as diff_render
    from mitsubaer_tpu.parallel import driver

    scene, cfg = flagship_scene(res=res, spp=spp, density_res=density_res,
                                max_depth=max_depth)
    loop_cfg = cfg._replace(engine="loop")
    n_data, n_tile = 2, 2

    img4, first, steady = timed(lambda: driver.render_sharded(
        scene, loop_cfg, n_devices=4, tile=n_tile, seed=0))
    img1 = driver.render_sharded(scene, loop_cfg, n_devices=1, tile=1,
                                 seed=0)
    img4, img1 = np.asarray(img4), np.asarray(img1)
    err = float(np.max(np.abs(img4 - img1) / np.maximum(np.abs(img1),
                                                        1e-30)))
    print(f"[four/render] loop engine {res}x{res} spp{spp} on (2,2) vs (1,1)"
          f": max rel diff {err:.2e} | (2,2) first call {first:.2f} s, "
          f"steady {steady:.4f} s", flush=True)
    # summation order only
    np.testing.assert_allclose(img4, img1, rtol=1e-5, atol=1e-7)

    # the optimizer's state keeps the raw gradient, so it can be compared
    keep = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    params = diff_render.get_params(scene)
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    sppc = 2
    res_ = {}
    for shape, sp in (((n_data, n_tile), sppc), ((1, 1), sppc * n_data)):
        mesh = driver.make_mesh(shape[0] * shape[1], tile=shape[1])
        step = driver.make_train_step(loop_cfg, keep, mesh, sppc=sp)
        st = keep.init(params)
        (_, g, loss), first, steady = timed(lambda: step(
            scene, st, params, target, jnp.uint32(0)))
        res_[shape] = (float(loss), g)
        print(f"[four/train] mesh {shape} sppc{sp}: loss {float(loss):.8g} "
              f"| first call {first:.2f} s, steady {steady:.4f} s",
              flush=True)
    (l4, g4), (l1, g1) = res_[(n_data, n_tile)], res_[(1, 1)]
    np.testing.assert_allclose(l4, l1, rtol=1e-5)
    for a, b in zip(jax.tree.leaves(g4), jax.tree.leaves(g1)):
        a, b = np.asarray(a), np.asarray(b)
        scale = max(float(np.max(np.abs(b))), 1e-30)
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * scale)
    _check(any(float(np.max(np.abs(np.asarray(x)))) > 0
               for x in jax.tree.leaves(g4)), "zero training gradient")
    print("[four/train] loss and gradient match within rtol 1e-5",
          flush=True)

    wf, first, steady = timed(lambda: driver.render_sharded(
        scene, cfg, n_devices=4, tile=n_tile, seed=0))
    wf = np.asarray(wf)
    _check(np.isfinite(wf).all() and (wf >= 0).all(), "wavefront shards")
    print(f"[four/wavefront] sharded wavefront render: finite, >= 0, mean "
          f"{wf.mean():.6f} | first call {first:.2f} s, steady "
          f"{steady:.4f} s", flush=True)


# ---------------------------------------------------------------------------
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded render and training"
                         " step (needs 4 GPUs)")
    args = ap.parse_args(argv)

    if not args.four:
        _run_chip_tests()

    import jax

    devs = jax.devices()
    dev = devs[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke.py needs a GPU; JAX found "
                         f"{dev.platform}")
    want = 4 if args.four else 1
    if len(devs) < want:
        raise SystemExit(f"chip_smoke.py: {len(devs)} GPU(s), needs {want}")
    sys.path.insert(0, ROOT)
    from mitsubaer_tpu.utils import jaxcache

    cache = jaxcache.enable()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(f"[device] {dev.platform} {dev.device_kind} x{len(devs)} | "
          f"compile cache {cache}")
    for line in smi.stdout.strip().splitlines():
        print(f"[nvidia-smi] {line.strip()}", flush=True)

    t0 = time.perf_counter()
    if args.four:
        four_gpus()
    else:
        fscene, fcfg = phase_flagship()
        escene, ecfg = phase_eikonal()
        phase_rif_gradient()
        phase_inverse_step()
        kernel_boxwalk(fscene, fcfg)
        kernel_ermarch(escene, ecfg)
        matmul_precision()
    print(f"[done] phases took {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
