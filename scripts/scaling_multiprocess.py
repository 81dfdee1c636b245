"""Multi-process scaling harness (replaces the reference's mtssrv render farm
bring-up; BASELINE.json >=85%@4-hosts artifact).

Spawns N local processes that form one jax.distributed CPU cluster (each
contributing K virtual CPU devices), renders the heterogeneous volumetric
scene SPMD over the global (data x tile) mesh, and

  1. asserts the multi-process render is IDENTICAL to a single-process
     render over an equally-shaped virtual mesh — the counter-based RNG
     makes the sample assignment a pure function of the global mesh shape,
     so any sharding bug shows up as a pixel diff, not as MC noise;
  2. prints a rays/s-vs-N efficiency table.

Usage:  python scripts/scaling_multiprocess.py            # parent: runs N=1,2,4
        (children are spawned automatically with --child)

Caveat: on a host with few cores, wall-clock efficiency at N>=2 is bounded
by oversubscription, not by the communication pattern; across hosts the
same program spans them via jax.distributed (parallel/driver.py).
"""
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEV_PER_PROC = 2
TOTAL_DEV = 4          # global mesh size kept constant across N
RES = 64
SPP = 8
PORT = 53517


def child(num_procs: int, pid: int):
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={TOTAL_DEV // num_procs}"
    ).strip()
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    if num_procs > 1:
        jax.distributed.initialize(
            coordinator_address=f"localhost:{PORT}",
            num_processes=num_procs, process_id=pid)
    import numpy as np
    from jax.experimental import multihost_utils

    from mitsubaer_tpu.parallel.driver import render_sharded
    from mitsubaer_tpu.scene import presets

    assert len(jax.devices()) == TOTAL_DEV, jax.devices()
    scene, cfg = presets.volumetric_box(
        res=RES, spp=SPP, heterogeneous=True, density_res=32, max_depth=6)
    cfg = cfg._replace(filter="box")

    img = render_sharded(scene, cfg, n_devices=TOTAL_DEV, tile=2, seed=3)
    jax.block_until_ready(img)
    # warm timing run
    t0 = time.perf_counter()
    img2 = render_sharded(scene, cfg, n_devices=TOTAL_DEV, tile=2, seed=3)
    jax.block_until_ready(img2)
    dt = time.perf_counter() - t0

    gathered = np.asarray(multihost_utils.process_allgather(img, tiled=True))
    if pid == 0:
        print(json.dumps({
            "num_procs": num_procs,
            "wall_s": round(dt, 3),
            "img_mean": float(gathered.mean()),
            "img_sha": __import__("zlib").crc32(
                np.ascontiguousarray(gathered, np.float32).tobytes()),
        }), flush=True)


def parent():
    results = {}
    for n in (1, 2, 4):
        procs = []
        for pid in range(n):
            p = subprocess.Popen(
                [sys.executable, __file__, "--child", str(n), str(pid)],
                stdout=subprocess.PIPE if pid == 0 else subprocess.DEVNULL,
                stderr=subprocess.DEVNULL, text=True)
            procs.append(p)
        out, _ = procs[0].communicate(timeout=900)
        for p in procs[1:]:
            p.wait(timeout=900)
        line = [l for l in out.splitlines() if l.startswith("{")][-1]
        results[n] = json.loads(line)
        print(f"N={n}: {results[n]}")
    # identical-image check across process counts (same global mesh)
    means = {n: r["img_mean"] for n, r in results.items()}
    shas = {n: r["img_sha"] for n, r in results.items()}
    base = means[1]
    ok_mean = all(abs(m - base) < 1e-6 * max(1.0, abs(base)) for m in means.values())
    ok_sha = len(set(shas.values())) == 1
    t1 = results[1]["wall_s"]
    print("\nscaling table (2-core host — oversubscribed beyond N=1):")
    for n, r in results.items():
        eff = t1 / r["wall_s"] if r["wall_s"] else 0.0
        print(f"  N={n}: wall {r['wall_s']}s  same-work speedup x{eff:.2f}")
    print(f"identical images across N (mean): {ok_mean}  (bitwise): {ok_sha}")
    return 0 if (ok_mean and ok_sha) else 1


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        child(int(sys.argv[2]), int(sys.argv[3]))
    else:
        sys.exit(parent())
