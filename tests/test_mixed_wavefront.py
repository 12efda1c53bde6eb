"""The mixed reflect+refract compacted wavefront (VERDICT r2 missing #3).

Every JSON fixture world spawns at most ONE child type per bounce, so the
compacted 2x-stream branch of engine.radiance (children concatenate, actives
stable-sort to the front, contributions scatter-add by carried pixel id) was
previously dead code in the test suite.  The synthetic mixed world
(synth.make_mixed_world) keeps BOTH child streams live every round; the tests
pin it against an INDEPENDENT recursion (debug.debug_cast's explicit per-ray
tree walk — the analog of the reference's propagate_helper recursion,
src/rayenv/scene.cu:222-268) and cover queue-capacity drop accounting.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from raytracer.render.engine import render_frame
from raytracer.scene import device_scene
from raytracer.synth import make_mixed_world


@pytest.fixture(scope="module")
def mixed():
    scene, cam, cfg = make_mixed_world(depth=3)
    return (device_scene(scene), jax.tree_util.tree_map(jnp.asarray, cam),
            cfg)


def test_mixed_world_takes_compacted_branch(mixed):
    scene, cam, cfg = mixed
    assert cfg.any_reflective and cfg.any_refractive
    # the engine's static branch selector: aligned iff exactly one child type
    assert not (cfg.any_reflective != cfg.any_refractive)


def test_bounces_contribute(mixed):
    """Depth must matter: the mirror/glass cubes change pixels at depth>=1."""
    scene, cam, cfg = mixed
    img0 = np.asarray(render_frame(scene, cam, cfg.replace(recurse_depth=0)))
    img3 = np.asarray(render_frame(scene, cam, cfg))
    changed = np.abs(img3 - img0).max(axis=-1) > 1e-3
    assert changed.sum() > 50, f"only {changed.sum()} bounce-lit pixels"


def test_mixed_render_matches_independent_recursion(mixed, capsys):
    """Wavefront (compacted queue) == explicit recursion, pixel by pixel, at
    depth 3 — including pixels whose primary hit spawns BOTH children."""
    from raytracer.debug import debug_cast

    scene, cam, cfg = mixed
    img = np.asarray(render_frame(scene, cam, cfg))
    img0 = np.asarray(render_frame(scene, cam, cfg.replace(recurse_depth=0)))
    bounce_px = np.argwhere(np.abs(img - img0).max(axis=-1) > 1e-3)

    # a spread of bounce-affected pixels + a couple of plain ones
    sel = bounce_px[:: max(1, len(bounce_px) // 6)][:6].tolist()
    sel += [[0, 0], [cfg.height - 1, cfg.width // 2]]
    for (y, x) in sel:
        _, color = debug_cast(scene, cam, cfg, int(x), int(y))
        capsys.readouterr()  # swallow the narration
        np.testing.assert_allclose(
            color, img[y, x], rtol=1e-4, atol=1e-4,
            err_msg=f"pixel ({x}, {y})",
        )


def test_mixed_engines_match(mixed):
    """Engine parity under an edge-pixel budget: at cube-edge pixels both
    faces hit at float-identical t, and the box fast path's axis tie-break
    legitimately differs from the oracle's scene-order tie-break (measure-
    zero ambiguity — the golden-image tests budget the same way)."""
    scene, cam, cfg = mixed
    img_jnp = np.asarray(render_frame(scene, cam, cfg.replace(engine="jnp")))
    img_pal = np.asarray(
        render_frame(scene, cam, cfg.replace(engine="pallas",
                                             interpret=True))
    )
    d = np.abs(img_pal - img_jnp).max(axis=-1)
    frac_off = (d > 1e-3).mean()
    assert frac_off < 0.005, f"{frac_off:.4%} of pixels diverge"
    assert np.abs(img_pal - img_jnp).mean() < 2e-3


def test_mixed_drop_accounting(mixed):
    """Children beyond queue capacity are dropped AND counted; ample capacity
    drops nothing and capacity variations leave the image unchanged."""
    from raytracer.render.engine import make_cast, radiance
    from raytracer.render.geometry import camera_rays, expand_geometry

    scene, cam, cfg = mixed
    geom = expand_geometry(scene)
    ro, rd = camera_rays(cam, cfg.width, cfg.height)
    ro = ro.reshape(-1, 3)
    rd = rd.reshape(-1, 3)

    def run(qf):
        c = cfg.replace(queue_factor=qf)
        cast = make_cast(scene, geom, c)
        acc, dropped = radiance(scene, geom, cast, c, ro, rd)
        return np.asarray(acc), int(dropped)

    acc1, d1 = run(1.0)
    acc2, d2 = run(2.0)
    assert d1 == 0 and d2 == 0  # this scene fits a 1x queue
    np.testing.assert_allclose(acc1, acc2, rtol=1e-5, atol=1e-6)

    _, d_tiny = run(0.02)  # capacity 2% of the ray count must overflow
    assert d_tiny > 0


def test_mixed_grads_flow(mixed):
    """Reverse-mode through the compacted branch (argsort + gather +
    scatter-add): finite, nonzero gradients to the mirror's Kr and the
    glass's Kt."""
    scene, cam, cfg = mixed
    cfgd = cfg.replace(early_exit=False, recurse_depth=2, shadow_steps=1)
    target = jnp.zeros((cfg.height, cfg.width, 4), jnp.float32)

    def loss(mats):
        s2 = dataclasses.replace(scene, materials=mats)
        return jnp.mean((render_frame(s2, cam, cfgd) - target) ** 2)

    g = jax.grad(loss)(scene.materials)
    for leaf in jax.tree_util.tree_leaves(g):
        assert np.isfinite(np.asarray(leaf)).all()
    assert float(jnp.abs(g.kr).sum()) > 0.0
    assert float(jnp.abs(g.kt).sum()) > 0.0


def test_child_tile_cap_matches_dense_and_accounts_drops(mixed):
    """The tile-granular child-queue compaction (cfg.child_tile_cap) must
    reproduce the per-lane compacted queue bit-for-bit at ample capacity and
    count every dropped child when starved."""
    import numpy as np

    from raytracer.render.engine import (_to_blocks, make_cast, radiance,
                                             render_frame)
    from raytracer.render.geometry import camera_rays, expand_geometry

    scene, camera, cfg = mixed
    a = np.asarray(render_frame(scene, camera, cfg))
    b = np.asarray(render_frame(scene, camera,
                                cfg.replace(child_tile_cap=0.5)))
    np.testing.assert_array_equal(a, b)

    geom = expand_geometry(scene)
    cast = make_cast(scene, geom, cfg)
    ro, rd = camera_rays(camera, cfg.width, cfg.height)
    hp = -(-cfg.height // 32) * 32
    wp = -(-cfg.width // 32) * 32
    import jax.numpy as jnp

    ro = jnp.pad(ro, ((0, hp - cfg.height), (0, wp - cfg.width), (0, 0)))
    rd = jnp.pad(rd, ((0, hp - cfg.height), (0, wp - cfg.width), (0, 0)),
                 constant_values=1.0)
    ro_b = _to_blocks(ro, hp, wp).reshape(-1, 3)
    rd_b = _to_blocks(rd, hp, wp).reshape(-1, 3)
    _, d_ample = radiance(scene, geom, cast, cfg.replace(child_tile_cap=0.5),
                          ro_b, rd_b)
    _, d_starved = radiance(scene, geom, cast,
                            cfg.replace(child_tile_cap=1e-9), ro_b, rd_b)
    assert int(d_ample) == 0
    assert int(d_starved) > 0
