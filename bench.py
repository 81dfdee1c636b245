"""Benchmark: forward rays/s on the heterogeneous volumetric scene
(BASELINE.json metric) + the eikonal configs (BASELINE configs 4-5).
Prints ONE JSON line.

Metric: traced ray segments per second (extension segments + shadow-ray
segments, each requiring scene intersection + medium traversal) — the
standard renderer Mrays/s convention. The persistent-wavefront engine
and the whole-path kernel count their segments exactly. The ER configs
report camera samples/s (curved paths have no comparable segment count;
each sample is a full curved transport path with BVP connections).

Needs an accelerator: it exits non-zero when JAX finds only the CPU. The
device line (platform, kind, count, and nvidia-smi's name and power limit)
is printed before the JSON line.
"""
import json
import subprocess
import sys
import time


def bench_het(jax, jnp, np):
    from mitsubaer_tpu.core import kernels
    from mitsubaer_tpu.integrators import boxwalk
    from mitsubaer_tpu.integrators.render import render_pass_wavefront
    from mitsubaer_tpu.scene import presets

    res, sppc, max_depth = 512, 32, 12
    scene, cfg = presets.volumetric_box(
        res=res, spp=sppc, heterogeneous=True, density_res=64,
        max_depth=max_depth,
    )
    cfg = cfg._replace(filter="box", engine="wavefront", wf_track_iters=3,
                       wf_mini_passes=2)
    scene = jax.device_put(scene)
    npix = res * res
    L = jnp.zeros((npix, 3), jnp.float32)
    # the whole-path kernel (integrators/boxwalk.py) covers this scene
    # class end to end where core/kernels.py picks the kernel route
    use_bw = (kernels.route(cfg.kernels) == kernels.TRITON
              and boxwalk.supported(scene, cfg))

    def one_pass(L, pass_idx):
        if use_bw:
            Lb, stats = boxwalk.render_boxwalk(
                scene, cfg, sppc, jnp.asarray(0, jnp.uint32), pass_idx)
            return L + Lb, stats
        return render_pass_wavefront(
            scene, L, cfg, sppc, jnp.asarray(0, jnp.uint32), pass_idx,
            has_direct=False, any_het=True,
        )

    L, stats = one_pass(L, jnp.asarray(0, jnp.uint32))
    _ = float(L.sum()) + int(stats[0])
    n_iters = 3
    segs = 0
    t0 = time.perf_counter()
    for i in range(1, n_iters + 1):
        L, stats = one_pass(L, jnp.asarray(i, jnp.uint32))
        segs += int(stats[0])
    _ = float(L.sum())
    dt = time.perf_counter() - t0
    samples = npix * sppc * n_iters
    img = np.asarray(L / (sppc * (n_iters + 1)))
    return dict(
        mrays=segs / dt / 1e6,
        msamples=samples / dt / 1e6,
        segs_per_sample=segs / samples,
        valid=bool(np.isfinite(img).all() and img.mean() > 0),
        config=f"volumetric heterogeneous {res}x{res} spp{sppc} "
               f"depth{max_depth} "
               f"engine={'boxwalk' if use_bw else 'wavefront'}",
    )


def bench_er_forward(jax, jnp, np):
    """BASELINE config 4: linear-RIF eikonal forward render."""
    from mitsubaer_tpu.integrators import render as rm
    from mitsubaer_tpu.models import eikonal as ek
    from mitsubaer_tpu.scene import presets

    res, spp = 96, 2
    scene, cfg = presets.refractive_sphere(
        res=res, spp=spp, max_depth=6, rif_kind=ek.RIF_LINEAR,
        rif_params=(1.3, 0.15, 0.0, 0.0), er_stepsize=1e-2,
        emitter="point", filter="box")
    # The BVP Newton marches run at 4x h (er_bvp_hscale) to cut the
    # solver's sequential depth — accuracy: h=1e-2 endpoint error ~3e-4 on
    # a 3-unit arc (f32 floor ~1e-4); h=4e-2 ~1e-3 inside the solver only
    # (scripts/er_h_study.py); the reference's h=1e-3 default
    # (heterogeneousrefractive.cpp:208) only pays off in f64 (cfg.er_f64)
    cfg = cfg._replace(er_maxsteps=256, bvp_restarts=8, er_bvp_hscale=4.0)
    scene = jax.device_put(scene)
    img = rm.render(scene, cfg, seed=0)          # compile + warm
    _ = float(jnp.asarray(img).sum())
    t0 = time.perf_counter()
    img = rm.render(scene, cfg, seed=1)
    m = float(jnp.asarray(img).mean())
    dt = time.perf_counter() - t0
    return dict(msamples=res * res * spp / dt / 1e6,
                valid=bool(np.isfinite(m) and m > 0),
                er_h=1e-2, er_bvp_hscale=4.0,
                config=f"linear-RIF ER {res}x{res} spp{spp} h1e-2 "
                       f"bvp-h4x")


def bench_er_grad(jax, jnp, np):
    """BASELINE config 5: radial-RIF ultrasound lens + RIF-parameter
    gradient (fwd+bwd samples/s)."""
    import functools

    from mitsubaer_tpu.core import rng
    from mitsubaer_tpu.integrators import volpath_er
    from mitsubaer_tpu.models import eikonal as ek
    from mitsubaer_tpu.models import sensor as sensor_m
    from mitsubaer_tpu.scene import presets

    res, spp = 32, 2
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

    gv = np.asarray(grad_fn(scene, cfg, spp, jnp.uint32(0)))  # compile
    t0 = time.perf_counter()
    gv = np.asarray(grad_fn(scene, cfg, spp, jnp.uint32(1)))
    dt = time.perf_counter() - t0
    return dict(msamples=npix * spp / dt / 1e6,
                valid=bool(np.isfinite(gv).all() and np.any(gv != 0)),
                config=f"radial-RIF ER grad {res}x{res} spp{spp}")


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mitsubaer_tpu.utils import jaxcache

    jaxcache.enable()
    dev = jax.devices()[0]
    if dev.platform == "cpu":
        sys.exit("bench.py: JAX found no accelerator")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}"
          f" | {smi.stdout.strip()}")

    het = bench_het(jax, jnp, np)
    er_f = bench_er_forward(jax, jnp, np)
    er_g = bench_er_grad(jax, jnp, np)

    baseline = 100.0  # Mrays/s/chip target (BASELINE.json north star)
    print(json.dumps({
        "metric": "forward_Mrays_per_s_per_chip",
        "value": round(het["mrays"], 3),
        "unit": "Mrays/s",
        "vs_baseline": round(het["mrays"] / baseline, 4),
        "samples_per_s_M": round(het["msamples"], 4),
        "segments_per_sample": round(het["segs_per_sample"], 2),
        "valid_image": het["valid"],
        "config": het["config"],
        "er_forward_Msamples_per_s": round(er_f["msamples"], 4),
        "er_forward_valid": er_f["valid"],
        "er_forward_config": er_f["config"],
        "er_grad_Msamples_per_s": round(er_g["msamples"], 4),
        "er_grad_valid": er_g["valid"],
        "er_grad_config": er_g["config"],
    }))


if __name__ == "__main__":
    main()
