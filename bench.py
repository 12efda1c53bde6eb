"""Benchmark driver: renders the headline config on the GPU and prints ONE
JSON line ``{"metric", "value", "unit", "device", ...extras}``.

Headline metric: frame time of the ``cubes8`` scene at 640x480.  Extras cover
the staged-config ladder of BASELINE.json on the in-repo scenes (``scenes/``):
the size family, the north-star 1080p fwd+bwd step, the heavy-spp gradient
scans, the mixed reflect+refract wavefront, an at-scale synthetic world and
on-device finite-difference checks of the vertex and camera gradients.
Detail lines go to stderr.

A GPU is required: without one every item fails, nothing runs on the CPU,
and the run exits nonzero.  Every item's error is reported in the final line,
and any failed item makes the exit code nonzero.

Every item runs in its OWN subprocess (``--item KEY``), one at a time, so one
item's device fault cannot poison the rest and only one process holds the
card; the parent never imports JAX.  ``BENCH_BUDGET_S`` (default 1350 s)
bounds the whole run: items execute in priority order, each subprocess gets
at most the remaining budget, and once the budget is spent the remaining
items are SKIPPED (listed in ``"skipped"``) — the final JSON line always
prints.  Items share the persistent compilation cache
(``raytracer.compile_cache``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))


def _require_gpu():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"bench.py needs a CUDA GPU; JAX found "
                           f"{dev.platform} ({dev.device_kind})")
    return dev


def _time_ms(fn, *args, repeats=10):
    """Best host-clock ms of ``fn(*args)`` ending in block_until_ready, on a
    warmed (compiled) shape."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return min(times) * 1e3


def _load(config_path, **cfg_over):
    import jax
    import jax.numpy as jnp

    from raytracer import generate
    from raytracer.scene import device_scene

    w = generate(config_path)
    cfg = w.config.replace(engine="pallas", **cfg_over)
    scene = device_scene(w.scene)
    camera = jax.tree_util.tree_map(jnp.asarray, w.camera)
    return w, scene, camera, cfg


def bench_world(config_path: str, width=640, height=480, iters=20,
                use_bvh=True, spp=1, scale_cam=False, auto_caps=False):
    """``auto_caps=True`` derives every tile cap from a probe render
    (render.auto_tile_caps) — no hand-tuned per-scene constants; residual
    drops are counted and reported."""
    import jax
    import jax.numpy as jnp

    from raytracer.render import auto_tile_caps, render_frame_with_stats

    w, scene, camera, cfg = _load(
        config_path, width=width, height=height, use_bvh=use_bvh, spp=spp,
    )
    if scale_cam:
        from raytracer.builder import scale_camera

        camera = jax.tree_util.tree_map(
            jnp.asarray, scale_camera(w.camera, width, w.config.width)
        )
    if auto_caps:
        cfg = cfg.replace(**auto_tile_caps(scene, camera, cfg))

    frame = jax.jit(lambda cam: render_frame_with_stats(scene, cam, cfg))
    ms = _time_ms(frame, camera, repeats=iters)
    dropped = int(frame(camera)[1]["dropped"])
    if dropped:
        print(f"WARNING {config_path} dropped={dropped}", file=sys.stderr)
    return ms


def bench_synth_big(n_instances=4096, iters=5):
    """At-scale traversal bench: n translated cube instances, primary+shadow
    frame at 640x480."""
    import jax
    import jax.numpy as jnp

    from raytracer.render import render_frame
    from raytracer.scene import device_scene
    from raytracer.synth import make_big_world

    scene, cam, cfg = make_big_world(n_instances)
    scene = device_scene(scene)
    camera = jax.tree_util.tree_map(jnp.asarray, cam)
    cfg = cfg.replace(width=640, height=480, engine="pallas")
    frame = jax.jit(lambda c: render_frame(scene, c, cfg))
    return _time_ms(frame, camera, repeats=iters)


def bench_mixed(iters=5, auto_caps=False):
    """The compacted 2x-stream wavefront (both child types live) at 640x480.

    ``auto_caps=True`` derives the child-queue tile cap from the probe
    render (tile-granular compaction, bit-identical images)."""
    import jax
    import jax.numpy as jnp

    from raytracer.builder import scale_camera
    from raytracer.render import auto_tile_caps, render_frame
    from raytracer.scene import device_scene
    from raytracer.synth import make_mixed_world

    scene, cam, cfg = make_mixed_world(depth=2)
    scene = device_scene(scene)
    camera = jax.tree_util.tree_map(
        jnp.asarray, scale_camera(cam, 640, cfg.width)
    )
    cfg = cfg.replace(width=640, height=480, engine="pallas")
    if auto_caps:
        caps = auto_tile_caps(scene, camera, cfg)
        cfg = cfg.replace(child_tile_cap=caps["child_tile_cap"])
    frame = jax.jit(lambda c: render_frame(scene, c, cfg))
    return _time_ms(frame, camera, repeats=iters)


def bench_fwd_bwd(config_path: str, width=1920, height=1080, iters=3, spp=1,
                  include_lights=True, include_camera=True):
    """fwd+bwd step time: one forward render + backward to materials (and
    optionally lights + camera pose).  The north-star metric uses cubes8
    1080p spp=1 with all params (BASELINE.json)."""
    import jax
    import jax.numpy as jnp

    from raytracer import diff
    from raytracer.builder import scale_camera

    w, scene, camera, cfg = _load(
        config_path, width=width, height=height, early_exit=False, spp=spp,
    )
    camera = jax.tree_util.tree_map(
        jnp.asarray, scale_camera(w.camera, width, w.config.width)
    )
    params = diff.trainable_params(scene, camera,
                                   include_lights=include_lights,
                                   include_camera=include_camera)
    target = jnp.zeros((height, width, 4), jnp.float32)

    @jax.jit
    def step(p):
        return jax.value_and_grad(lambda p_: diff.l2_image_loss(
            diff.render_with_params(scene, camera, cfg, p_), target))(p)

    ms = _time_ms(step, params, repeats=iters)
    mrays = width * height * spp / (ms * 1e-3) / 1e6
    return ms, mrays


def bench_fwd_bwd_spp(config_path: str, width=1920, height=1080, spp=64,
                      spp_chunk=None, repeats=2, include_lights=True,
                      include_camera=True, include_vertices=False,
                      edge_aware=False):
    """Heavy-spp fwd+bwd via diff.make_spp_grad_fn: the whole gradient
    accumulation runs as in-program lax.scan(s) with per-sample remat
    (spp_chunk=None -> one program; else a host loop of chunk programs).
    Tile caps come from the probe render (auto_tile_caps)."""
    import jax
    import jax.numpy as jnp

    from raytracer import diff
    from raytracer.builder import scale_camera
    from raytracer.render import auto_tile_caps

    w, scene, camera, cfg = _load(
        config_path, width=width, height=height, early_exit=False, spp=1,
        edge_aware_grads=edge_aware,
    )
    camera = jax.tree_util.tree_map(
        jnp.asarray, scale_camera(w.camera, width, w.config.width)
    )
    cfg = cfg.replace(
        static_tile_cap=auto_tile_caps(scene, camera, cfg)["static_tile_cap"]
    )
    params = diff.trainable_params(scene, camera,
                                   include_lights=include_lights,
                                   include_camera=include_camera,
                                   include_vertices=include_vertices)
    target = jnp.zeros((height, width, 4), jnp.float32)
    step = diff.make_spp_grad_fn(scene, camera, cfg, spp,
                                 spp_chunk=spp_chunk, with_stats=True)

    out = jax.block_until_ready(step(params, target))  # compile + warm
    dropped = int(out[2]["dropped"])
    if dropped:  # probe-derived cap must keep the gradient path lossless
        print(f"WARNING {config_path} spp={spp} dropped={dropped}",
              file=sys.stderr)
    ms = _time_ms(step, params, target, repeats=repeats)
    mrays = width * height * spp / (ms * 1e-3) / 1e6
    return ms, mrays


def vertex_fd_check(width=96, height=72, spp=8):
    """On-device finite-difference sanity for VERTEX gradients: the
    committed FD fixture
    (test_diff.test_edge_aware_vertex_gradient_matches_fd_engines) — cubes1's
    isolated cube column, close-up 35-degree camera, directional derivative
    along a global vertex scale.  On a lone column every silhouette borders
    the true background, so the one-sided mollifier's known bias is the only
    systematic term (expected AD/FD ratio ~0.5-1.6).  Returns
    ``(ad, fd, ratio)``."""
    import dataclasses

    import numpy as np

    import jax
    import jax.numpy as jnp

    from raytracer import raymath as rm
    from raytracer.builder import scale_camera
    from raytracer.render import render_frame
    from raytracer.render.geometry import expand_geometry

    w, scene, camera, cfg = _load(
        "cubes1", width=width, height=height, early_exit=False, spp=spp,
        edge_aware_grads=True, recurse_depth=0, edge_px=1.5,
    )
    geom = expand_geometry(scene)
    lo, hi = geom.aabb_min.min(0), geom.aabb_max.max(0)
    center = (lo + hi) / 2
    radius = float(jnp.max(hi - lo)) / 2
    qy = rm.quat_from_axis_angle(jnp.array([0.0, 1.0, 0.0]),
                                 jnp.float32(35 * np.pi / 180))
    rot = rm.quat_normalize(rm.quat_mul(qy, jnp.asarray(w.camera.rot)))
    fwd = rm.normalize(rm.quat_to_mat(rot)[:, 2])
    cam = dataclasses.replace(
        jax.tree_util.tree_map(jnp.asarray, w.camera),
        pos=center - fwd * (3.0 * radius), rot=rot,
    )
    camera = jax.tree_util.tree_map(
        jnp.asarray, scale_camera(cam, width, w.config.width))

    def loss_of(s):
        s2 = dataclasses.replace(scene, verts=scene.verts * (1.0 + s))
        img = render_frame(s2, camera, cfg)
        return jnp.mean(img[..., :3])  # RGB only: alpha sits on the clamp

    lossj = jax.jit(loss_of)
    ad = float(jax.jit(jax.grad(loss_of))(0.0))
    h = 0.03
    fd = (float(lossj(h)) - float(lossj(-h))) / (2 * h)
    ratio = ad / fd if abs(fd) > 1e-12 else float("nan")
    return ad, fd, ratio


def camera_fd_check(config_path="cubes8_stress", width=480, height=270,
                    spp=8):
    """On-device FD sanity for CAMERA-pose gradients on the stress scene:
    directional derivative of the spp-averaged image mean along a camera
    dolly.  Camera motion moves abutting-cube seams coherently (their
    opposing bands cancel), so AD should track FD closely.  Returns
    ``(ad, fd, ratio)``."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from raytracer import raymath as rm
    from raytracer.builder import scale_camera
    from raytracer.render import render_frame

    w, scene, camera, cfg = _load(
        config_path, width=width, height=height, early_exit=False, spp=spp,
        edge_aware_grads=True, recurse_depth=0,
    )
    camera = jax.tree_util.tree_map(
        jnp.asarray, scale_camera(w.camera, width, w.config.width)
    )
    fwd = rm.normalize(rm.quat_to_mat(camera.rot)[:, 2])

    def loss_of(s):
        c2 = dataclasses.replace(camera, pos=camera.pos + s * fwd)
        img = render_frame(scene, c2, cfg)
        return jnp.mean(img[..., :3])

    lossj = jax.jit(loss_of)
    ad = float(jax.jit(jax.grad(loss_of))(0.0))
    h = 0.05
    fd = (float(lossj(h)) - float(lossj(-h))) / (2 * h)
    ratio = ad / fd if abs(fd) > 1e-12 else float("nan")
    return ad, fd, ratio


# ---------------------------------------------------------------------------
# Item registry: each entry returns a dict of extras to merge.

def _item_cubes1():
    # Probe-derived tile caps (auto_tile_caps — cubes1's lone column
    # occupies a handful of tiles); the dense row is reported alongside.
    return {"cubes1_ms": bench_world("cubes1", auto_caps=True),
            "cubes1_dense_ms": bench_world("cubes1", iters=5)}


def _item_cubes8():
    return {"cubes8_ms": bench_world("cubes8")}


def _item_cubes16():
    return {"cubes16_ms": bench_world("cubes16")}


def _item_fwd_bwd_1080p():
    ms, mrays = bench_fwd_bwd("cubes8")
    return {"fwd_bwd_1080p_ms": ms, "fwd_bwd_1080p_mrays_per_s": mrays}


def _item_cubes4_512_spp4():
    return {"cubes4_512_spp4_ms": bench_world(
        "cubes4", width=512, height=512, spp=4, scale_cam=True, iters=5,
        auto_caps=True)}


def _item_cubes8_1024_spp16():
    return {"cubes8_1024_spp16_ms": bench_world(
        "cubes8", width=1024, height=1024, spp=16, scale_cam=True, iters=3,
        auto_caps=True)}


def _item_cubes16_1080p_spp64_bwd():
    # BASELINE configs[3]: backward to materials, one in-program scan with
    # per-sample remat.
    ms, mrays = bench_fwd_bwd_spp(
        "cubes16", spp=64, include_lights=False, include_camera=False,
    )
    return {"cubes16_1080p_spp64_bwd_ms": ms,
            "cubes16_1080p_spp64_bwd_mrays": mrays}


def _item_cubes8_stress_1080p_spp128():
    # materials + lights + camera gradients
    ms, mrays = bench_fwd_bwd_spp("cubes8_stress", spp=128)
    return {"cubes8_stress_1080p_spp128_fwdbwd_ms": ms,
            "cubes8_stress_1080p_spp128_mrays": mrays}


def _item_cubes8_stress_geomgrad():
    # BASELINE configs[4]: geometry+camera gradients (vertex positions via
    # the edge-aware band + analytic uv-VJP) at 1080p 128 spp.
    ms, mrays = bench_fwd_bwd_spp(
        "cubes8_stress", spp=128, include_vertices=True, edge_aware=True,
    )
    return {"cubes8_stress_geomgrad_ms": ms,
            "cubes8_stress_geomgrad_mrays": mrays}


def _item_fd_checks():
    # On-device central-difference sanity for the vertex + camera gradients.
    _, _, vratio = vertex_fd_check()
    _, _, cratio = camera_fd_check()
    return {"vertex_fd_ad_over_fd": vratio, "camera_fd_ad_over_fd": cratio}


def _item_synth4096():
    return {"synth4096_ms": bench_synth_big()}


def _item_mixed_world():
    # Tile-granular child compaction with a probe-derived cap.
    return {"mixed_world_ms": bench_mixed(auto_caps=True),
            "mixed_world_dense_ms": bench_mixed()}


# Priority order: the headline row and the cheap ladder rows run first so a
# cold-cache run inside a tight timeout still lands them; the heavy spp
# scans follow.
ITEMS = {
    "cubes8": _item_cubes8,
    "cubes1": _item_cubes1,
    "cubes16": _item_cubes16,
    "fwd_bwd_1080p": _item_fwd_bwd_1080p,
    "cubes4_512_spp4": _item_cubes4_512_spp4,
    "mixed_world": _item_mixed_world,
    "cubes16_1080p_spp64_bwd": _item_cubes16_1080p_spp64_bwd,
    "cubes8_stress_1080p_spp128": _item_cubes8_stress_1080p_spp128,
    "cubes8_stress_geomgrad": _item_cubes8_stress_geomgrad,
    "cubes8_1024_spp16": _item_cubes8_1024_spp16,
    "synth4096": _item_synth4096,
    "fd_checks": _item_fd_checks,
}

# Per-item ceilings (cold-cache compile included); the global budget caps
# each slice further at whatever remains.
ITEM_TIMEOUT_S = {
    "cubes8_1024_spp16": 2400,
    "cubes16_1080p_spp64_bwd": 3600,
    "cubes8_stress_1080p_spp128": 3600,
    "cubes8_stress_geomgrad": 3600,
}

# Warm-cache cost estimates.  Not measured on the GPU: a uniform placeholder
# until a measured run replaces it.  An item is attempted only when the
# remaining budget covers its estimate — otherwise it is skipped
# IMMEDIATELY and the next item that fits runs.
ITEM_EST_S = {key: 60 for key in ITEMS}

BENCH_BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", "1350"))
_RESERVE_S = 15  # headroom to print the final line
_MIN_SLICE_S = 45  # don't start an item with less than this remaining


def run_item(key: str) -> int:
    """Child-process entry: run one item, print its extras as one JSON line
    (an ``<item>_error`` entry when it failed) and exit nonzero on error."""
    from raytracer.compile_cache import setup_compile_cache

    try:
        setup_compile_cache()
        dev = _require_gpu()
        out = ITEMS[key]()
        out[key + "_device"] = dev.device_kind
    except Exception as e:
        print(json.dumps({key + "_error": f"{type(e).__name__}: {e}"[:300]}))
        return 1
    print(json.dumps(out))
    return 0


def run_probe() -> int:
    """Child-process entry: print the device as JAX reports it; nonzero
    when it is not a GPU."""
    import jax

    dev = jax.devices()[0]
    print(json.dumps({"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())}))
    return 0 if dev.platform == "gpu" else 1


def _run_schedule(keys, run_one, budget_s, est=None, timeouts=None,
                  now=time.perf_counter):
    """Budget-bounded item scheduler (unit-testable core of ``main``).

    Runs items in the given priority order; an item starts only when the
    remaining budget (minus the final-line reserve) covers its warm-cost
    estimate, otherwise it is skipped immediately — a too-big item never
    burns a doomed partial slice, and the caller always has budget left to
    print the final line.  ``run_one(key, timeout_s) -> dict`` does the
    work (subprocess in production, a stub in tests).

    Items whose first attempt ERRORS (timeout / crash / no output) get ONE
    retry each after the full pass, in priority order, inside whatever
    budget remains: a transient fault (a hung device init, a killed worker)
    should not report the whole row as missing when the very next
    subprocess would run normally."""
    est = ITEM_EST_S if est is None else est
    timeouts = ITEM_TIMEOUT_S if timeouts is None else timeouts
    deadline = now() + budget_s
    extras = {}
    skipped = []

    def attempt(key, label):
        remaining = deadline - now() - _RESERVE_S
        if remaining < max(_MIN_SLICE_S, est.get(key, _MIN_SLICE_S)):
            return None  # budget can't cover it
        # a started item is additionally capped at 3x its warm estimate
        # (floor 300 s, to cover cold-cache compiles), so one pathological
        # hang cannot starve every later item
        cap = max(3 * est.get(key, _MIN_SLICE_S), 300)
        t0 = now()
        try:
            out = run_one(key, min(timeouts.get(key, 1200), remaining, cap))
        except subprocess.TimeoutExpired:
            out = {key + "_error": "timeout"}
        except Exception as e:  # pragma: no cover
            out = {key + "_error": f"{type(e).__name__}: {e}"[:200]}
        dt = now() - t0
        print(f"{label}: {out} [{dt:.0f}s]", file=sys.stderr, flush=True)
        return out

    failed = []
    for key in keys:
        out = attempt(key, key)
        if out is None:
            skipped.append(key)
            continue
        extras.update(out)
        if key + "_error" in out:
            failed.append(key)
    for key in failed:
        out = attempt(key, f"{key} (retry)")
        if out is None or key + "_error" in out:
            continue
        extras.pop(key + "_error", None)
        extras.update(out)
    if skipped:
        extras["skipped"] = skipped
        print(f"budget exhausted ({budget_s:.0f}s): skipped {skipped}",
              file=sys.stderr, flush=True)
    return extras


def _child(args, timeout_s):
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), *args],
        capture_output=True, text=True, timeout=timeout_s, cwd=_HERE,
    )
    lines = proc.stdout.strip().splitlines()
    return proc, (json.loads(lines[-1]) if lines else None)


def _run_item_subprocess(key, timeout_s):
    """Production ``run_one``: crash-isolated child process per item."""
    proc, out = _child(["--item", key], timeout_s)
    return out if out is not None else {
        key + "_error": f"no output (rc={proc.returncode}): "
        + proc.stderr.strip()[-150:]
    }


def main():
    proc, device = _child(["--probe"], 300)
    if proc.returncode != 0 or device is None:
        print(json.dumps({"metric": "cubes8_frame_ms", "value": None,
                          "unit": "ms", "device": device,
                          "error": "no CUDA GPU: bench.py does not run on "
                                   "the CPU"}))
        return 1
    extras = _run_schedule(list(ITEMS), _run_item_subprocess, BENCH_BUDGET_S)
    print(json.dumps({
        "metric": "cubes8_frame_ms",
        "value": extras.get("cubes8_ms"),
        "unit": "ms",
        "device": device,
        **extras,
    }))
    failed = any(k.endswith("_error") for k in extras)
    return 1 if failed or extras.get("cubes8_ms") is None else 0


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--item":
        sys.exit(run_item(sys.argv[2]))
    if len(sys.argv) >= 2 and sys.argv[1] == "--probe":
        sys.exit(run_probe())
    sys.exit(main())
