"""Differentiable rendering: autodiff gradients vs central finite differences.

The BASELINE acceptance is "image+grad allclose vs ref" — the reference has no
gradients, so the ground truth here is numerical differentiation of our own
(image-parity-validated) renderer.  Material/light-color parameters do not move
silhouettes, so autodiff should match finite differences tightly; silhouette
terms for vertex/camera parameters flow through edge_aware_grads (screen-space
interior hinge band), and the Pallas engine carries the analytic hit-time VJP
so its camera gradients match the jnp engine."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from raytracer import diff, generate
from raytracer.render.engine import render_frame
from raytracer.scene import device_scene


@pytest.fixture(scope="module")
def setup():
    from raytracer.builder import scale_camera

    w = generate("cubes1")
    scene = device_scene(w.scene)
    cam = scale_camera(w.camera, 64, w.config.width)  # full FOV at 64x48
    cam = jax.tree_util.tree_map(jnp.asarray, cam)
    # training path: no while_loops (reverse-mode differentiable)
    cfg = w.config.replace(width=64, height=48, use_bvh=False, early_exit=False,
                           shadow_steps=2)
    target = jnp.zeros((48, 64, 4), jnp.float32)
    return w, scene, cam, cfg, target


def test_grads_flow_and_are_finite(setup):
    w, scene, cam, cfg, target = setup
    params = diff.trainable_params(scene, cam)
    loss_fn = diff.make_loss_fn(scene, cam, cfg, target)
    value, grads = jax.value_and_grad(loss_fn)(params)
    assert np.isfinite(float(value))
    leaves = jax.tree_util.tree_leaves(grads)
    assert all(np.isfinite(np.asarray(g)).all() for g in leaves)
    # Some gradient must be nonzero (the scene is visible at this resolution).
    total = sum(float(jnp.sum(jnp.abs(g))) for g in leaves)
    assert total > 0.0


@pytest.mark.parametrize("field,idx", [
    ("kd", (1, 1)),       # green cube diffuse G
    ("ka", (1, 1)),       # ambient
    ("kt", (1, 0)),       # transmission (drives refraction attenuation)
])
def test_material_grad_matches_finite_difference(setup, field, idx):
    w, scene, cam, cfg, target = setup
    params = diff.trainable_params(scene, cam, include_lights=False,
                                   include_camera=False)
    loss_fn = diff.make_loss_fn(scene, cam, cfg, target)
    grads = jax.grad(loss_fn)(params)

    eps = 1e-3
    arr = np.asarray(getattr(params["materials"], field))

    def loss_with(v):
        p2 = jax.tree_util.tree_map(lambda x: x, params)
        a = arr.copy()
        a[idx] = v
        mats = p2["materials"]
        import dataclasses

        p2["materials"] = dataclasses.replace(mats, **{field: jnp.asarray(a)})
        return float(loss_fn(p2))

    v0 = arr[idx]
    fd = (loss_with(v0 + eps) - loss_with(v0 - eps)) / (2 * eps)
    ad = float(np.asarray(getattr(grads["materials"], field))[idx])
    assert np.isfinite(fd) and np.isfinite(ad)
    np.testing.assert_allclose(ad, fd, rtol=5e-2, atol=1e-5)


def _closeup_camera(w, scene, width):
    """A close-up, yawed view of the world1 cube column: the object fills a
    good fraction of the frame (the stock cube-world camera leaves it ~16 px
    wide — gradient estimates there are pure sampling noise), and the 35 deg
    yaw keeps every visible face away from edge-on (a silhouette whose
    interior face is seen edge-on cannot be sampled by any interior band —
    documented limitation of one-sided mollification; exact handling needs
    explicit edge sampling)."""
    import dataclasses

    from raytracer import raymath as rm
    from raytracer.builder import scale_camera
    from raytracer.render.geometry import expand_geometry

    geom = expand_geometry(scene)
    center = (geom.aabb_min.min(0) + geom.aabb_max.max(0)) / 2
    radius = float(jnp.max(geom.aabb_max.max(0) - geom.aabb_min.min(0))) / 2
    qy = rm.quat_from_axis_angle(jnp.array([0.0, 1.0, 0.0]),
                                 jnp.float32(35 * np.pi / 180))
    rot = rm.quat_normalize(rm.quat_mul(qy, jnp.asarray(w.camera.rot)))
    fwd = rm.normalize(rm.quat_to_mat(rot)[:, 2])
    cam = dataclasses.replace(
        jax.tree_util.tree_map(jnp.asarray, w.camera),
        pos=center - fwd * (3.0 * radius), rot=rot,
    )
    cam = scale_camera(cam, width, w.config.width)
    return jax.tree_util.tree_map(jnp.asarray, cam)


@pytest.mark.parametrize("engine", ["jnp", "pallas"])
def test_edge_aware_vertex_gradient_matches_fd_engines(setup, engine):
    """Silhouette gradients to vertex positions (edge_aware_grads).

    Uniformly scaling the cube vertices sweeps every silhouette outward — a
    strongly one-sided signal (translation nets to ~zero: the left-edge gain
    cancels the right-edge loss).  The loss is the mean over RGB only:
    the alpha channel saturates the canvas clamp at exactly 1.0, where the
    interior-band gradient dies against the clamp while FD still sees the
    0->1 coverage jump (inherent interior-vs-boundary mismatch at saturation,
    documented in engine.py).  Measured ratios on this setup are stable at
    ~0.78-0.80 across spp/h/dark-vs-lit variants (one-sided occlusion bias
    accounts for the remainder); the window pins sign and scale."""
    import dataclasses

    w, scene, cam_, _cfg, _ = setup
    W, H = 96, 72
    cam = _closeup_camera(w, scene, W)
    cfg = _cfg.replace(width=W, height=H, edge_aware_grads=True, spp=8,
                       recurse_depth=0, edge_px=1.5, engine=engine,
                       interpret=True)

    def loss_of(s):
        s2 = dataclasses.replace(scene, verts=scene.verts * (1.0 + s))
        img = render_frame(s2, cam, cfg)
        return jnp.mean(img[..., :3])

    ad = float(jax.grad(loss_of)(0.0))
    h = 0.03
    fd = (float(loss_of(h)) - float(loss_of(-h))) / (2 * h)
    assert np.isfinite(ad) and np.isfinite(fd)
    assert fd > 0.0, "scaling up must brighten coverage"
    ratio = ad / fd
    assert 0.5 < ratio < 1.6, (ad, fd, ratio)


def test_edge_aware_forward_is_unchanged(setup):
    w, scene, cam, _cfg, _ = setup
    cfg0 = _cfg.replace(recurse_depth=0)
    cfg1 = cfg0.replace(edge_aware_grads=True)
    img0 = render_frame(scene, cam, cfg0)
    img1 = render_frame(scene, cam, cfg1)
    np.testing.assert_array_equal(np.asarray(img0), np.asarray(img1))


def test_train_step_reduces_loss(setup):
    w, scene, cam, cfg, _ = setup
    # target: the render with brighter diffuse; optimize toward it
    import dataclasses

    mats = scene.materials
    bright = dataclasses.replace(mats, kd=mats.kd * 1.5)
    scene_t = dataclasses.replace(scene, materials=bright)
    target = render_frame(scene_t, cam, cfg)

    params = diff.trainable_params(scene, cam, include_lights=False,
                                   include_camera=False)
    v0, grads, params = diff.train_step(scene, cam, cfg, target, params, lr=0.05)
    v1, _, params = diff.train_step(scene, cam, cfg, target, params, lr=0.05)
    assert float(v1) < float(v0)


def test_pallas_camera_gradient_matches_jnp_engine():
    """The Pallas cast's analytic t-VJP (cast_vjp.pallas_cast_detached) must
    reproduce the jnp engine's camera-position gradient: on faceted box
    scenes the hit plane's normal fully determines dt/d(o, d), so the two
    engines' shading-path gradients agree to float precision (BASELINE stage
    5's camera grads on the production engine)."""
    import dataclasses

    w = generate("cubes8")
    scene = device_scene(w.scene)
    cam = jax.tree_util.tree_map(jnp.asarray, w.camera)
    target = jnp.zeros((48, 64, 4), jnp.float32)

    def grad_for(engine):
        cfg = w.config.replace(width=64, height=48, early_exit=False,
                               engine=engine, interpret=True)

        def loss(pos):
            c2 = dataclasses.replace(cam, pos=pos)
            return jnp.mean((render_frame(scene, c2, cfg) - target) ** 2)

        return np.asarray(jax.grad(loss)(cam.pos))

    g_jnp = grad_for("jnp")
    g_pal = grad_for("pallas")
    assert np.abs(g_jnp).sum() > 0.0
    np.testing.assert_allclose(g_pal, g_jnp, rtol=1e-4, atol=1e-8)


def test_pallas_vertex_gradient_matches_jnp_engine():
    """The full analytic (t, uv, normal)-VJP (cast_vjp.pallas_cast_reparam): with
    edge_aware_grads on, the production Pallas engine's gradient to VERTEX
    POSITIONS must match the jnp engine's autodiff-through-the-cast gradient
    — the reconstruction is definitionally the same hit equation, so the two
    agree to float precision wherever the hit is smooth (VERDICT r2 #1)."""
    import dataclasses

    w = generate("cubes8")
    scene = device_scene(w.scene)
    from raytracer.builder import scale_camera

    cam = jax.tree_util.tree_map(
        jnp.asarray, scale_camera(w.camera, 64, w.config.width)
    )
    target = jnp.zeros((48, 64, 4), jnp.float32)

    def grad_for(engine):
        cfg = w.config.replace(width=64, height=48, early_exit=False,
                               edge_aware_grads=True, engine=engine,
                               interpret=True, use_bvh=False)

        def loss(verts):
            s2 = dataclasses.replace(scene, verts=verts)
            return jnp.mean((render_frame(s2, cam, cfg) - target) ** 2)

        return np.asarray(jax.grad(loss)(scene.verts))

    g_jnp = grad_for("jnp")
    g_pal = grad_for("pallas")
    assert np.abs(g_jnp).sum() > 0.0
    scale = np.abs(g_jnp).max()
    np.testing.assert_allclose(g_pal, g_jnp, rtol=2e-3, atol=2e-4 * scale)
