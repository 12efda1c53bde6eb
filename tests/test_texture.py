"""Texture mapping extension tests.

The reference loads a texture atlas but left sampling as a TODO
(src/rayprimitives/phong.cu:19-23); ``cfg.texture_mapping=True`` enables our
completed implementation (shading.sample_atlas).  These tests pin its
semantics (nearest texel inside the per-triangle atlas rect, barycentric-
interpolated) and the engine-parity requirement: the Pallas box fast path
reports fixed uv=(1/3,1/3), so textured box meshes must fall back to the
template scan (ADVICE r2 finding #1).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from raytracer.builder import (Material, SceneBuilder, TextureCoords,
                                   make_camera)
from raytracer.render.engine import render_frame
from raytracer.scene import device_scene


def _checker_atlas(n=8):
    """n x n RGBA atlas with a unique color per texel."""
    a = np.zeros((n, n, 4), np.float32)
    for y in range(n):
        for x in range(n):
            a[y, x] = [x / n, y / n, (x + y) / (2 * n), 1.0]
    return a


def test_sample_atlas_picks_expected_texel():
    from raytracer.render.cast import Hit
    from raytracer.render.geometry import expand_geometry
    from raytracer.render.shading import sample_atlas

    sb = SceneBuilder()
    mat = Material(kd=np.array([1, 1, 1, 1], np.float32))
    tc = TextureCoords(texture_x=2.0, texture_y=1.0, u=4.0, v=4.0,
                       degenerate=False)
    m = sb.create_mesh()
    mb = sb.get_mesh_builder(m)
    tri = [sb.add_vertex([0.0, 0.0, 0.0]), sb.add_vertex([1.0, 0.0, 0.0]),
           sb.add_vertex([0.0, 1.0, 0.0])]
    mb.add_triangle(tri, tc, mat)
    sb.add_trans(mb)
    scene = sb.finish()
    atlas = _checker_atlas(8)
    scene = device_scene(dataclasses.replace(scene, atlas=atlas))
    geom = expand_geometry(scene)

    # barycentric (u=0.5, v=0.25) -> texel (2 + 0.5*4, 1 + 0.25*4) = (4, 2)
    hit = Hit(valid=jnp.array([True]), t=jnp.array([1.0]),
              wtri=jnp.array([0], jnp.int32),
              uv=jnp.array([[0.5, 0.25]], jnp.float32))
    tex, degen = sample_atlas(scene, geom, hit)
    assert not bool(np.asarray(degen)[0])
    np.testing.assert_allclose(np.asarray(tex)[0], atlas[2, 4], atol=1e-6)


@pytest.fixture(scope="module")
def textured_cube():
    sb = SceneBuilder()
    mat = Material(kd=np.array([1.0, 1.0, 1.0, 1.0], np.float32))
    tc = TextureCoords(texture_x=0.0, texture_y=0.0, u=7.0, v=7.0,
                       degenerate=False)
    sb.add_trans(sb.get_mesh_builder(sb.build_cube(1.0, tc, mat)))
    sb.add_directional_light([0.3, -0.5, 1.0], [1.0, 1.0, 1.0, 1.0])
    scene = sb.finish()
    scene = dataclasses.replace(
        scene, atlas=_checker_atlas(8),
        ambience=np.array([0.2, 0.2, 0.2, 1.0], np.float32),
    )
    cam = make_camera(0.6, 48.0, 64, 64)
    cam = dataclasses.replace(cam, pos=np.array([0.0, 0.0, -3.0], np.float32))
    return device_scene(scene), jax.tree_util.tree_map(jnp.asarray, cam)


def test_textured_render_differs_from_flat(textured_cube):
    scene, cam = textured_cube
    from raytracer.scene import RenderConfig, scene_render_flags

    cfg_base = RenderConfig(width=64, height=64, recurse_depth=0,
                            **scene_render_flags(scene))
    img_flat = np.asarray(render_frame(scene, cam, cfg_base))
    img_tex = np.asarray(
        render_frame(scene, cam, cfg_base.replace(texture_mapping=True))
    )
    assert img_flat[..., :3].max() > 0.05  # the cube is visible
    assert np.abs(img_tex - img_flat).max() > 0.05  # texture changed pixels


def test_textured_render_pallas_matches_jnp(textured_cube):
    """With texture_mapping on, the Pallas cast must report REAL barycentric
    uv for the textured cube — the box fast path (fixed uv) must be disabled
    for it, or every face samples one texel (ADVICE r2 #1)."""
    scene, cam = textured_cube
    from raytracer.scene import RenderConfig, scene_render_flags

    cfg = RenderConfig(width=64, height=64, recurse_depth=0,
                       texture_mapping=True, **scene_render_flags(scene))
    img_jnp = np.asarray(render_frame(scene, cam, cfg.replace(engine="jnp")))
    img_pal = np.asarray(
        render_frame(scene, cam, cfg.replace(engine="pallas",
                                             interpret=True))
    )
    np.testing.assert_allclose(img_pal, img_jnp, rtol=1e-4, atol=1e-4)


def test_untextured_cube_keeps_box_fast_path():
    """texture_mapping=True must NOT disable the box path for meshes whose
    coords are degenerate (untextured) — only textured meshes pay the
    template scan."""
    from raytracer.render.geometry import expand_geometry
    from raytracer.render.pallas_engine import _II_IS_BOX, build_tables

    sb = SceneBuilder()
    mat = Material(kd=np.array([1.0, 0.0, 0.0, 1.0], np.float32))
    sb.add_trans(sb.get_mesh_builder(sb.build_cube(1.0, TextureCoords(), mat)))
    scene = device_scene(sb.finish())
    geom = expand_geometry(scene)
    t_plain = build_tables(scene, geom, texture_mapping=True)
    assert int(np.asarray(t_plain.inst_i32[:, _II_IS_BOX]).sum()) == 1
    t_exact = build_tables(scene, geom, exact_uv=True)
    assert int(np.asarray(t_exact.inst_i32[:, _II_IS_BOX]).sum()) == 0
