"""Command-line interface mirroring the reference app (src/main.cc:31-79).

Reference flags -> ours:
  -c/--config   : world JSON config (same files, parsed bit-compatibly)
  -b/--bench    : one-shot benchmark of a full frame (prints ``Time: <ms>``
                  plus a machine-readable JSON line)
  -r/--no-bvh   : disable acceleration structures (brute-force fallback)
  -s/--reference-impl : use the pure-jnp oracle engine (the analog of the
                  reference's serial CPU path)
  -d/--dim      : kernel block knob (main.cc:38's d x d CUDA block): the
                  Triton walk casts d*d rays per program, rounded up to a
                  power of two and kept within 32..1024
                  (RenderConfig.ray_block; unset keeps its default)

The SDL window is replaced by a PNG framebuffer dump (``--out``); interactive
viewing on an accelerator host is out of scope (SURVEY.md §7.9).  ``--debug-pixel X Y``
is the analog of the reference's click-to-debug single-ray probe (main.cc:181-186).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="raytracer",
        description="A GPU-accelerated differentiable ray tracer.",
    )
    p.add_argument("-c", "--config", required=True, help="world config (json)")
    p.add_argument("-b", "--bench", action="store_true", help="benchmark mode")
    p.add_argument(
        "-r", "--no-bvh", action="store_true",
        help="disable optimizing data structures (brute force)",
    )
    p.add_argument(
        "-s", "--reference-impl", action="store_true",
        help="use the pure-jnp oracle engine",
    )
    p.add_argument(
        "-d", "--dim", type=int, default=None,
        help="kernel block edge (reference -d): the Triton walk casts d*d "
             "rays per program, rounded up to a power of two (32..1024)",
    )
    p.add_argument("-o", "--out", default=None, help="output PNG path")
    p.add_argument("--width", type=int, default=None, help="override canvas width")
    p.add_argument("--height", type=int, default=None, help="override canvas height")
    p.add_argument(
        "--debug-pixel", nargs=2, type=int, metavar=("X", "Y"),
        help="trace one pixel verbosely (single-ray probe)",
    )
    p.add_argument("--repeats", type=int, default=1, help="bench repetitions")
    p.add_argument(
        "--wavefront-cap", type=float, default=0.0, metavar="FRAC",
        help="tile-compacted queue discipline: run shading/shadow/bounce "
             "rounds on only the FRAC*T ray tiles containing hits (sparse-"
             "hit scenes like world1 render ~3x faster; hits beyond the cap "
             "are dropped and counted).  0 = dense rounds",
    )
    p.add_argument(
        "--orbit", type=int, default=0, metavar="N",
        help="render an N-frame turntable fly-through (headless analog of the "
             "reference's interactive window) to --out-dir, reporting FPS over "
             "5-frame samples like the reference overlay (main.cc:106-200)",
    )
    p.add_argument(
        "--interactive", action="store_true",
        help="stdin-driven camera loop: lines 'w|a|s|d', 'mouse DX DY', "
             "'click X Y' (debug probe), 'quit'; each command re-renders to "
             "--out (the reference SDL loop without the window)",
    )
    p.add_argument("--out-dir", default="frames", help="orbit frame directory")
    p.add_argument(
        "--train", type=int, default=0, metavar="N",
        help="run N differentiable-rendering optimization steps (fit the "
             "scene's materials/lights to --target-png, or to a perturbed "
             "self-render when no target is given); emits one JSON stats "
             "line per step and checkpoints to --checkpoint",
    )
    p.add_argument(
        "--train-until", type=int, default=0, metavar="TOTAL",
        help="train to ABSOLUTE step TOTAL (idempotent across restarts: a "
             "resumed run recomputes only the steps after its checkpoint; "
             "already-finished runs exit immediately).  Overrides --train's "
             "relative count",
    )
    p.add_argument(
        "--elastic", type=int, default=0, metavar="MAX_RESTARTS",
        help="run --train under the elastic supervisor: the loop runs in a "
             "worker subprocess whose train_step heartbeat is monitored; on "
             "a crash or a hang the worker is killed (by exact PID) and "
             "relaunched from the last checkpoint, up to MAX_RESTARTS times "
             "(use with --train-until for an absolute target)",
    )
    p.add_argument(
        "--hang-timeout", type=float, default=300.0, metavar="S",
        help="--elastic: restart the worker if no heartbeat for S seconds",
    )
    p.add_argument("--target-png", default=None,
                   help="target image for --train (RGBA PNG)")
    p.add_argument("--checkpoint", default="train_ckpt.npz",
                   help="checkpoint path for --train (resumed if it exists)")
    p.add_argument("--checkpoint-every", type=int, default=10,
                   help="save the --train checkpoint every K steps")
    p.add_argument("--lr", type=float, default=0.05, help="--train SGD rate")
    p.add_argument("--profile-dir", default=None,
                   help="capture a jax.profiler trace of the run to this dir")
    return p


SAMPLE_PERIOD = 5  # FPS sample window, frames (reference main.cc:21)


def _fps_loop(render_np, cameras, on_frame):
    """Drive ``render_np(camera) -> np image`` over ``cameras``, reporting FPS
    over SAMPLE_PERIOD-frame windows exactly like the reference overlay."""
    import time

    count, t0 = 0, time.perf_counter()
    fps = None
    for i, cam in enumerate(cameras):
        img = render_np(cam)
        on_frame(i, img)
        count += 1
        if count == SAMPLE_PERIOD:
            t1 = time.perf_counter()
            fps = count / (t1 - t0)
            print(f"FPS: {fps:.1f}")
            count, t0 = 0, t1
    return fps


def _train(args, scene, camera, cfg) -> int:
    """Differentiable-rendering optimization loop: fit trainable scene
    parameters (materials + lights) to a target image, emitting one
    ``tracing.FrameStats`` JSON line per step and checkpointing/resuming via
    ``checkpoint.save``/``load`` (new capability over the reference, which has
    neither autodiff nor persistence — SURVEY.md §5)."""
    import os

    import jax
    import jax.numpy as jnp
    import numpy as np

    from . import checkpoint, diff, tracing
    from .render import render_frame
    from .pngio import read_png

    cfg = cfg.replace(early_exit=False)  # reverse-differentiable control flow

    if args.target_png:
        rgb = read_png(args.target_png).astype(np.float32) / 255.0
        if rgb.shape[-1] == 3:
            rgb = np.concatenate(
                [rgb, np.ones(rgb.shape[:-1] + (1,), np.float32)], -1
            )
        target = jnp.asarray(rgb)
        assert target.shape == (cfg.height, cfg.width, 4), (
            f"target {target.shape} != frame {(cfg.height, cfg.width, 4)}"
        )
    else:
        # Self-supervised fixture: the same scene with brighter diffuse.
        import dataclasses

        mats = scene.materials
        bright = dataclasses.replace(mats, kd=mats.kd * 1.3)
        target = render_frame(
            dataclasses.replace(scene, materials=bright), camera, cfg
        )

    params = diff.trainable_params(scene, camera, include_camera=False)
    start = 0
    if os.path.exists(args.checkpoint):
        params, start = checkpoint.load(args.checkpoint, params)
        tracing.log("checkpoint_restored", path=args.checkpoint, step=start)
    end = args.train_until if args.train_until else start + args.train
    if start >= end:
        print(f"already trained to step {start} (target {end}); nothing to do")
        return 0

    # One-shot fault injection for the elastic-recovery tests: crash (or
    # hang) the worker once, right after reaching the given step, guarded by
    # a marker file so the restarted worker proceeds cleanly.
    fault_at = int(os.environ.get("RT_FAULT_AT_STEP", "0") or 0)
    hang_at = int(os.environ.get("RT_HANG_AT_STEP", "0") or 0)
    marker = os.environ.get("RT_FAULT_MARKER", "")

    @jax.jit
    def step_fn(params_):
        return diff.train_step(scene, camera, cfg, target, params_,
                               lr=args.lr)

    stats = tracing.FrameStats(width=cfg.width, height=cfg.height,
                               spp=cfg.spp)
    ctx = (tracing.profile_trace(args.profile_dir)
           if args.profile_dir else None)
    if ctx is not None:
        ctx.__enter__()
    try:
        for step in range(start, end):
            with stats:
                value, grads, params = step_fn(params)
                value = float(value)
            tracing.log("train_step", step=step, loss=value)
            if (step + 1) % args.checkpoint_every == 0 or step + 1 == end:
                checkpoint.save(args.checkpoint, params, step=step + 1)
            if marker and step + 1 in (fault_at, hang_at) and \
                    not os.path.exists(marker):
                open(marker, "w").close()
                if step + 1 == fault_at:
                    tracing.log("fault_injected", kind="crash", step=step + 1)
                    os._exit(13)  # simulated preemption/watchdog kill
                tracing.log("fault_injected", kind="hang", step=step + 1)
                time.sleep(3600)  # simulated wedged worker
    finally:
        if ctx is not None:
            ctx.__exit__(None, None, None)
    print(f"trained {end - start} steps; final loss {value:.6f}; "
          f"checkpoint -> {args.checkpoint}")
    return 0


def _strip_elastic_flags(argv):
    """Worker argv = the original argv minus the supervisor-only flags."""
    out = []
    skip = False
    for a in argv:
        if skip:
            skip = False
            continue
        if a in ("--elastic", "--hang-timeout"):
            skip = True
            continue
        if a.startswith("--elastic=") or a.startswith("--hang-timeout="):
            continue
        out.append(a)
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.elastic > 0 and (args.train or args.train_until):
        # failure detection + elastic recovery: supervise the training loop
        # in a worker subprocess (see elastic.py)
        from .elastic import run_supervised

        worker_argv = _strip_elastic_flags(
            list(argv) if argv is not None else sys.argv[1:])
        res = run_supervised(worker_argv, max_restarts=args.elastic,
                             hang_timeout_s=args.hang_timeout)
        return 0 if res.completed else 1

    import jax
    import jax.numpy as jnp
    import numpy as np

    from . import generate
    from .compile_cache import setup_compile_cache
    from .render import render_frame
    from .scene import device_scene
    from .pngio import write_png

    setup_compile_cache()
    world = generate(args.config)
    cfg = world.config
    camera = world.camera
    if args.width:
        # keep the full field of view when overriding the canvas size
        from .builder import scale_camera

        camera = scale_camera(camera, args.width, cfg.width)
        cfg = cfg.replace(width=args.width)
    if args.height:
        cfg = cfg.replace(height=args.height)
    # -s pins the pure-jnp oracle (the reference's serial path); default on
    # the GPU is the Pallas-Triton walk, on CPU the XLA culled path.
    from .render.engine import default_engine

    cfg = cfg.replace(
        use_bvh=not args.no_bvh and not args.reference_impl,
        engine="jnp" if args.reference_impl else default_engine(),
        wavefront_tile_cap=args.wavefront_cap,
    )
    if args.dim is not None:
        from .render.pallas_engine import ray_block_for_dim

        cfg = cfg.replace(ray_block=ray_block_for_dim(args.dim))
    scene = device_scene(world.scene)
    camera = jax.tree_util.tree_map(jnp.asarray, camera)
    print(f"Loaded scene: {args.config} ({cfg.width}x{cfg.height})")

    if args.debug_pixel:
        from .debug import debug_cast

        x, y = args.debug_pixel
        debug_cast(scene, camera, cfg, x, y)
        return 0

    if args.train or args.train_until:
        return _train(args, scene, camera, cfg)

    render = jax.jit(render_frame, static_argnames=("cfg",))

    if args.orbit or args.interactive:
        import os

        from . import camera_motion as cm
        from .render.engine import frame_to_u8

        def render_np(cam):
            img = render(scene, cam, cfg)
            return np.asarray(frame_to_u8(img))

        if args.orbit:
            os.makedirs(args.out_dir, exist_ok=True)

            def save(i, img):
                write_png(os.path.join(args.out_dir, f"frame_{i:04d}.png"),
                          img[..., :3])

            _fps_loop(render_np, cm.orbit_frames(camera, args.orbit), save)
            print(f"wrote {args.orbit} frames to {args.out_dir}/")
            return 0

        # --interactive: the reference's event loop, driven by stdin lines.
        out = args.out or "frame.png"
        cam = camera
        img = render_np(cam)
        write_png(out, img[..., :3])
        print(f"interactive: w/a/s/d, 'mouse DX DY', 'click X Y', 'quit'; "
              f"frame -> {out}", flush=True)
        for line in sys.stdin:
            parts = line.strip().split()
            if not parts:
                continue
            if parts[0] in ("quit", "q", "esc"):
                break
            if parts[0] in ("w", "a", "s", "d"):
                cam = cm.key_move(cam, parts[0])
            elif parts[0] == "mouse" and len(parts) == 3:
                cam = cm.mouse_look(cam, float(parts[1]), float(parts[2]))
            elif parts[0] == "click" and len(parts) == 3:
                from .debug import debug_cast

                debug_cast(scene, cam, cfg, int(parts[1]), int(parts[2]))
                continue
            else:
                print(f"? {line.strip()}", flush=True)
                continue
            t0 = time.perf_counter()
            img = render_np(cam)
            write_png(out, img[..., :3])
            dt = time.perf_counter() - t0
            print(f"frame: {dt * 1e3:.1f} ms ({1.0 / dt:.1f} FPS)", flush=True)
        print("Exiting...")  # main.cc:205
        return 0

    if args.bench:
        # Warm-up compile (excluded, like the reference's already-warm GPU ctx).
        img = render(scene, camera, cfg)
        jax.block_until_ready(img)
        times = []
        for _ in range(max(1, args.repeats)):
            t0 = time.perf_counter()
            img = render(scene, camera, cfg)
            jax.block_until_ready(img)
            times.append((time.perf_counter() - t0) * 1e3)
        ms = min(times)
        rays = cfg.width * cfg.height
        print(f"Time: {ms:.3f} ms")
        print(json.dumps({
            "metric": "frame_ms",
            "value": ms,
            "unit": "ms",
            "config": args.config,
            "width": cfg.width,
            "height": cfg.height,
            "primary_mrays_per_s": rays / ms / 1e3,
        }))
    else:
        img = np.asarray(render(scene, camera, cfg))
        out = args.out or "frame.png"
        write_png(out, img[..., :3])
        print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
