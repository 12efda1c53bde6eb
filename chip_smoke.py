"""Smoke run of the render and gradient path on one NVIDIA GPU.

    python chip_smoke.py          # one card: device, kernels, render, train
    python chip_smoke.py --four   # four cards: the sharded paths only

Drives the main path through the entry points a user calls, at full width:
the Pallas-Triton walk kernels compiled for the card and compared with the
brute-force oracle, the CLI's render and train modes on the ``cubes8``
scene, and one 1080p spp-16 vertex+camera gradient step on
``cubes8_stress``.  ``--four`` instead runs the 4-card shard_map train step
against the same step on one card, and the (rays x geom) sharded render
against the single-card frame.

Every phase raises on its first failed check; nothing falls back to the CPU
and no kernel runs in the interpreter.  The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``,
printed only when every phase passed.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time
from dataclasses import dataclass

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from raytracer import cli, diff, dist, generate  # noqa: E402
from raytracer.builder import scale_camera  # noqa: E402
from raytracer.compile_cache import setup_compile_cache  # noqa: E402
from raytracer.render import auto_tile_caps, render_frame  # noqa: E402
from raytracer.render import pallas_engine as pe  # noqa: E402
from raytracer.render.cast import make_brute_cast  # noqa: E402
from raytracer.render.engine import _frame_rays_blocked  # noqa: E402
from raytracer.render.geometry import expand_geometry  # noqa: E402
from raytracer.scene import device_scene  # noqa: E402

SCRATCH = os.path.join(REPO, ".smoke")  # checkpoints; removed at the end


@dataclass(frozen=True)
class Sizes:
    """Shapes of each phase; the defaults are the smoke run's real widths
    (tests rehearse the same phases at tiny ones)."""

    frame: tuple = (640, 480)  # kernels, render, (rays x geom) render
    incoherent: int = 65536  # extra random rays for the kernel comparison
    train: tuple = (1920, 1080)  # cli --train, spp step, 4-card step
    spp: int = 16  # the cubes8_stress gradient step
    grad_frame: tuple = (320, 240)  # engine-agreement gradients
    four_spp: int = 4  # the 4-card train step


class SmokeFailure(RuntimeError):
    pass


def check(ok, what):
    if not ok:
        raise SmokeFailure(what)
    print(f"  ok: {what}", flush=True)


def phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def done(t0):
    print(f"   ({time.perf_counter() - t0:.1f} s)", flush=True)


def load(name, size, interpret, **over):
    width, height = size
    w = generate(name)
    scene = device_scene(w.scene)
    cam = jax.tree_util.tree_map(
        jnp.asarray, scale_camera(w.camera, width, w.config.width))
    cfg = w.config.replace(width=width, height=height, engine="pallas",
                           interpret=interpret, **over)
    return scene, cam, cfg


def device_check(want_count):
    t0 = phase("device")
    devs = jax.devices()
    dev = devs[0]
    print(f"  jax {jax.__version__}: {dev.platform} {dev.device_kind} "
          f"x{len(devs)}", flush=True)
    check(dev.platform == "gpu", f"platform is gpu (got {dev.platform})")
    check(len(devs) >= want_count, f"{want_count} device(s) present")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    print(f"  compile cache: {setup_compile_cache()}", flush=True)
    done(t0)
    return dev, devs


def kernels(sz, interpret=False):
    """The kernels against the oracle at real width: cubes8 640x480 primary
    rays (block order, as the engine casts them) plus 64k incoherent
    rays."""
    t0 = phase("kernels: Triton cast / occlude / occlude2 vs oracle")
    scene, cam, cfg = load("cubes8", sz.frame, interpret)
    geom = expand_geometry(scene)
    ro_b, rd_b, _, _ = _frame_rays_blocked(cam, cfg, None)
    rng = np.random.RandomState(0)
    o = rng.uniform(-5, 5, (sz.incoherent, 3)).astype(np.float32)
    d = rng.randn(sz.incoherent, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ro = jnp.concatenate([ro_b, jnp.asarray(o)])
    rd = jnp.concatenate([rd_b, jnp.asarray(d)])
    max_t = jnp.asarray(rng.uniform(0.1, 20.0, ro.shape[0]).astype(np.float32))

    def walk():
        return pe.make_pallas_cast(scene, geom, cfg)

    cast = jax.jit(lambda a, b: walk()(a, b))
    occ = jax.jit(lambda a, b, m: walk().occlude(a, b, m))
    occ2 = jax.jit(lambda a, b, m: walk().occlude2(a, b, m, a, b, jnp.inf))
    hit = cast(ro, rd)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda a, b: make_brute_cast(geom)(a, b))(ro, rd)
    vp, vb = np.asarray(hit.valid), np.asarray(ref.valid)
    edge = vp != vb
    # Hit mask: grazing rays along box edges may resolve differently under
    # another float evaluation order; budget them as a fraction of rays.
    check(edge.mean() <= 1e-4, f"hit mask mismatch {edge.mean():.2e} <= 1e-4 "
          f"of {vp.size} rays ({vb.sum()} hits)")
    both = vp & vb
    tp, tb = np.asarray(hit.t)[both], np.asarray(ref.t)[both]
    # t: f32 slab/plane arithmetic of the same equations, off the edge set
    rel = np.abs(tp - tb) / np.abs(tb)
    check(rel.max() <= 1e-5, f"t rel err {rel.max():.2e} <= 1e-5")
    # face and instance: identical (box fast-path contract: the kernel
    # reports the hit face's first triangle)
    _, _, _, face_of, _ = pe._detect_box_meshes(scene)
    face_of = np.asarray(face_of)
    wtri_tri = np.asarray(scene.wtri_tri)
    inst = np.asarray(geom.inst)
    wp, wb = np.asarray(hit.wtri)[both], np.asarray(ref.wtri)[both]
    check((inst[wp] == inst[wb]).all()
          and (face_of[wtri_tri[wp]] == face_of[wtri_tri[wb]]).all(),
          "hit face and instance identical")
    # occlusion: exactly the oracle's `valid & t <= max_t` (on the edge set
    # the oracle's hit itself is what differs, budgeted above)
    want = vb & (np.where(vb, np.asarray(ref.t), np.inf) <= np.asarray(max_t))
    got = np.asarray(occ(ro, rd, max_t))
    check((got == want)[~edge].all(), "occlude == oracle valid & t <= max_t")
    g1, g2 = occ2(ro, rd, max_t)
    check((np.asarray(g1) == want)[~edge].all()
          and (np.asarray(g2) == vb)[~edge].all(),
          "occlude2 == two oracle queries")

    frame = jax.jit(lambda c: render_frame(scene, c, cfg))
    mem = frame.lower(cam).compile().memory_analysis()
    print(f"  frame program memory_analysis: {mem}", flush=True)
    done(t0)


def _captured_stderr(fn):
    """Run ``fn`` with stderr teed into a buffer; returns (result, text)."""
    buf = io.StringIO()

    class Tee(io.TextIOBase):
        def write(self, s):
            buf.write(s)
            return sys.__stderr__.write(s)

    with contextlib.redirect_stderr(Tee()):
        out = fn()
    return out, buf.getvalue()


def render(sz, interpret=False):
    t0 = phase("render: cli -b on cubes8, frame vs oracle")
    rc = cli.main(["-c", os.path.join(REPO, "scenes", "cubes8.json"), "-b",
                   "--repeats", "5", "--width", str(sz.frame[0]),
                   "--height", str(sz.frame[1])])
    check(rc == 0, "cli render bench exits 0")
    scene, cam, cfg = load("cubes8", sz.frame, interpret)
    img = np.asarray(jax.jit(lambda c: render_frame(scene, c, cfg))(cam))
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(lambda c: render_frame(
            scene, c, cfg.replace(engine="jnp", use_bvh=False)))(cam))
    check(img.shape == (sz.frame[1], sz.frame[0], 4)
          and np.isfinite(img).all(), f"frame finite, shape {img.shape}")
    err = np.abs(img - ref).max(-1)
    # 2/255 = two 8-bit steps; pixels over it are edge rays that resolve to
    # another surface, budgeted at 0.1% of the frame
    check((err > 2 / 255).mean() <= 1e-3,
          f"frame vs oracle: {(err > 2 / 255).mean():.2e} of pixels over "
          f"2/255 (max {err.max():.2e}) <= 0.1%")
    done(t0)


def train(sz, interpret=False):
    t0 = phase(f"train: cli --train 3 at {sz.train}, spp-{sz.spp} "
               "gradient step")
    shutil.rmtree(SCRATCH, ignore_errors=True)
    os.makedirs(SCRATCH)
    rc, log = _captured_stderr(lambda: cli.main([
        "-c", "cubes8", "--train", "3", "--width", str(sz.train[0]),
        "--height", str(sz.train[1]),
        "--checkpoint", os.path.join(SCRATCH, "ckpt.npz"),
        "--checkpoint-every", "3"]))
    losses = [json.loads(line)["loss"] for line in log.splitlines()
              if line.startswith("{") and '"train_step"' in line]
    check(rc == 0 and len(losses) == 3, f"cli trained 3 steps: {losses}")
    check(all(np.isfinite(losses)), "loss finite at every step")

    scene, cam, cfg = load("cubes8_stress", sz.train, interpret,
                           early_exit=False, edge_aware_grads=True)
    cfg = cfg.replace(
        static_tile_cap=auto_tile_caps(scene, cam, cfg)["static_tile_cap"])
    params = diff.trainable_params(scene, cam, include_vertices=True)
    target = jnp.zeros((sz.train[1], sz.train[0], 4), jnp.float32)
    step = diff.make_spp_grad_fn(scene, cam, cfg, spp=sz.spp,
                                 with_stats=True)
    loss, grads, stats = jax.block_until_ready(step(params, target))
    leaves = jax.tree_util.tree_leaves(grads)
    check(np.isfinite(float(loss))
          and all(np.isfinite(np.asarray(g)).all() for g in leaves),
          f"spp-{sz.spp} vertex+camera grads finite "
          f"(loss {float(loss):.6f})")
    check(float(jnp.abs(grads["verts"]).sum()) > 0
          and float(jnp.abs(grads["cam_pos"]).sum()) > 0,
          "vertex and camera grads nonzero")
    check(int(stats["dropped"]) == 0, "no radiance dropped")

    # GPU twin of test_diff's engine-agreement tests: material and camera
    # gradients of the Triton engine vs the jnp engine at 320x240; the two
    # engines differentiate the same hit equations, so only f32 rounding
    # separates them (rtol 1e-3).
    scene, cam, cfg = load("cubes8", sz.grad_frame, interpret,
                           early_exit=False)
    params = diff.trainable_params(scene, cam, include_lights=False)
    target = jnp.zeros((sz.grad_frame[1], sz.grad_frame[0], 4), jnp.float32)

    def grads_for(engine):
        c = cfg.replace(engine=engine, use_bvh=engine == "pallas")
        return jax.jit(jax.grad(diff.make_loss_fn(scene, cam, c, target)))(
            params)

    with jax.default_matmul_precision("highest"):
        g_w, g_j = grads_for("pallas"), grads_for("jnp")
    for key in ("materials", "cam_pos", "cam_rot"):
        for a, b in zip(jax.tree_util.tree_leaves(g_w[key]),
                        jax.tree_util.tree_leaves(g_j[key])):
            a, b = np.asarray(a), np.asarray(b)
            scale = np.abs(b).max()
            check(np.allclose(a, b, rtol=1e-3, atol=1e-6 * scale),
                  f"{key} grads agree with the jnp engine "
                  f"(max diff {np.abs(a - b).max():.2e}, scale {scale:.2e})")
    shutil.rmtree(SCRATCH, ignore_errors=True)
    done(t0)


def _spans_all(x, devices):
    """Every one of ``devices`` holds a shard of ``x`` (nothing is gathered
    onto device 0)."""
    return {s.device for s in x.addressable_shards} == set(devices)


def four(devs, sz, interpret=False):
    import __graft_entry__ as entry

    devs = devs[:4]
    t0 = phase(f"four cards: shard_map train step, {sz.train} "
               f"spp {sz.four_spp}")
    v4, g4, _ = entry.sharded_train_step(4, *sz.train, spp=sz.four_spp,
                                         interpret=interpret)
    check(all(_spans_all(x, devs) for x in jax.tree_util.tree_leaves(g4)),
          "train step grads live on all 4 devices")
    v1, g1, _ = entry.sharded_train_step(1, *sz.train, spp=sz.four_spp,
                                         interpret=interpret)
    check(np.isclose(float(v4), float(v1), rtol=1e-5),
          f"loss 4 cards {float(v4):.8f} == 1 card {float(v1):.8f} "
          f"(rtol 1e-5)")
    for a, b in zip(jax.tree_util.tree_leaves(g4),
                    jax.tree_util.tree_leaves(g1)):
        a, b = np.asarray(a), np.asarray(b)
        # psum over 4 ray shards sums in another order than one card; an
        # absolute floor at 1e-4 of the leaf's scale covers near-zero entries
        scale = np.abs(b).max()
        check(np.allclose(a, b, rtol=1e-4, atol=1e-4 * scale),
              f"grads {a.shape} agree (max diff {np.abs(a - b).max():.2e}, "
              f"scale {scale:.2e})")
    done(t0)

    t0 = phase("four cards: (rays x geom) 2x2 sharded render")
    scene, cam, cfg = load("cubes8", sz.frame, interpret)
    mesh = dist.make_mesh2d(2, 2, devs)
    check(set(mesh.devices.flat) == set(devs), "mesh spans 4 distinct cards")
    img4 = dist.make_geom_sharded_render(scene, cam, cfg, mesh)()
    check(_spans_all(img4, devs), "sharded frame lives on all 4 devices")
    img1 = jax.jit(lambda c: render_frame(scene, c, cfg))(cam)
    err = np.abs(np.asarray(img4) - np.asarray(img1)).max()
    check(err <= 1e-5, f"geom-sharded frame == single card (max {err:.2e})")
    done(t0)


def main(argv):
    want_four = "--four" in argv
    dev, devs = device_check(4 if want_four else 1)
    sz = Sizes()
    if want_four:
        four(devs, sz)
        count = 4
    else:
        kernels(sz)
        render(sz)
        train(sz)
        count = len(devs)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
