"""Scaling-efficiency harness: rays/s at 1..N devices (BASELINE deliverable).

Shards the frame's row axis over a mesh of the first n devices for each n in a
doubling sweep and reports rays/s plus parallel efficiency vs n=1.  On real
multi-GPU hardware this measures NVLink scaling; on a CPU host it runs on the
virtual device mesh (XLA_FLAGS=--xla_force_host_platform_device_count=N) and
demonstrates the mechanism (CPU "efficiency" reflects host core contention,
not device links).

Usage:  python tools/bench_scaling.py [--config PATH] [--width W] [--height H]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

sys.path.insert(0, __import__("os").path.dirname(__import__("os").path.dirname(
    __import__("os").path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="cubes16")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from raytracer import dist, generate
    from raytracer.builder import scale_camera
    from raytracer.render.engine import default_engine
    from raytracer.scene import device_scene

    world = generate(args.config)
    scene = device_scene(world.scene)
    camera = scale_camera(world.camera, args.width, world.config.width)
    camera = jax.tree_util.tree_map(jnp.asarray, camera)

    devices = jax.devices()
    sizes = []
    n = 1
    while n <= len(devices):
        sizes.append(n)
        n *= 2

    results = []
    base = None
    for n in sizes:
        h = (args.height + 8 * n - 1) // (8 * n) * (8 * n)
        cfg = world.config.replace(
            width=args.width, height=h,
            engine=default_engine(),
            ray_chunk=min(32768, args.width * h),
        )
        mesh = dist.make_mesh(devices[:n])
        run = dist.make_sharded_render(scene, camera, cfg, mesh)
        out = run()
        jax.block_until_ready(out)
        times = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            jax.block_until_ready(run())
            times.append(time.perf_counter() - t0)
        dt = min(times)
        rays_per_s = args.width * h / dt
        if base is None:
            base = rays_per_s
        eff = rays_per_s / (base * n)
        results.append({"devices": n, "mrays_per_s": rays_per_s / 1e6,
                        "efficiency": eff})
        print(f"n={n}: {rays_per_s/1e6:.2f} Mrays/s  efficiency={eff:.2%}",
              file=sys.stderr)

    backend = jax.default_backend()
    print(json.dumps({
        "metric": "scaling", "config": args.config, "backend": backend,
        "note": ("virtual CPU device mesh: demonstrates the sharding "
                 "mechanism only — 'efficiency' here measures host-core "
                 "contention, not device-link scaling" if backend == "cpu" else
                 "real accelerator mesh"),
        "results": results}))


if __name__ == "__main__":
    main()
