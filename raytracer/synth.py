"""Synthetic worlds for tests and benchmarks.

The reference's fixture family (world*.json) never exercises two behaviors the
engine must support (VERDICT r2):

* a scene containing BOTH reflective and refractive materials — the wavefront
  then spawns TWO child streams per bounce and takes the compacted queue
  discipline (engine.radiance's ``aligned=False`` branch: concatenate,
  stable-sort actives to the front, scatter-add contributions by carried
  pixel id) — reference analog: ``propagate_ray`` pushes reflect AND refract
  frames from one hit (src/rayenv/scene.cu:130-183);
* instance counts far beyond the fixtures' 1.5k, where the in-kernel LBVH
  walk (O(log N) per occluder) must beat the O(N) candidate cull.

``make_mixed_world`` and ``make_big_world`` build those scenes from the same
SceneBuilder API the JSON loader uses.
"""

from __future__ import annotations

import numpy as np

from .builder import Material, SceneBuilder, TextureCoords, make_camera
from .scene import RenderConfig, scene_render_flags

f32 = np.float32


def make_mixed_world(depth: int = 3):
    """A small scene with reflective AND refractive cubes over a diffuse
    floor — both wavefront child streams stay live every bounce round.

    Returns ``(scene, camera, cfg)`` with ``cfg.any_reflective`` and
    ``cfg.any_refractive`` both True (the compacted-queue discipline)."""
    sb = SceneBuilder()
    tc = TextureCoords()

    diffuse = Material(
        kd=np.array([0.1, 0.7, 0.2, 1.0], f32),
        ka=np.array([0.1, 0.2, 0.1, 1.0], f32),
    )
    mirror = Material(
        kd=np.array([0.05, 0.05, 0.1, 1.0], f32),
        ks=np.array([0.4, 0.4, 0.4, 1.0], f32),
        kr=np.array([0.7, 0.7, 0.8, 1.0], f32),
        alpha=16.0,
    )
    glass = Material(
        kd=np.array([0.05, 0.05, 0.05, 1.0], f32),
        kt=np.array([0.9, 0.9, 0.95, 1.0], f32),
        eta=0.9,  # same regime as world1.json's refractive cubes
    )

    m_diff = sb.build_cube(1.0, tc, diffuse)
    m_mirr = sb.build_cube(1.0, tc, mirror)
    m_glas = sb.build_cube(1.0, tc, glass)

    # 5x5 diffuse floor at y = -1
    for ix in range(-2, 3):
        for iz in range(-2, 3):
            t = sb.add_trans(sb.get_mesh_builder(m_diff))
            sb.get_transformation(t).set_position([float(ix), -1.0, float(iz)])
    # a mirror cube and a glass cube side by side above the floor
    t = sb.add_trans(sb.get_mesh_builder(m_mirr))
    sb.get_transformation(t).set_position([-0.8, 0.0, 0.5])
    t = sb.add_trans(sb.get_mesh_builder(m_glas))
    sb.get_transformation(t).set_position([0.8, 0.0, 0.5])

    sb.add_directional_light([0.3, -1.0, 0.4], [0.9, 0.9, 0.9, 1.0])
    sb.add_point_light([0.0, 3.0, -2.0], [0.6, 0.6, 0.6, 1.0])

    scene = sb.finish()
    import dataclasses

    scene = dataclasses.replace(
        scene,
        ambience=np.array([0.3, 0.3, 0.3, 1.0], f32),
        dist_atten=np.array([1.0, 0.0, 0.0], f32),
    )

    cam = make_camera(0.7853982, 64.0, 128, 96)  # 45 deg
    import dataclasses as dc

    cam = dc.replace(cam, pos=np.array([0.0, 0.6, -3.5], f32))
    cfg = RenderConfig(width=128, height=96, recurse_depth=depth,
                       **scene_render_flags(scene))
    assert cfg.any_reflective and cfg.any_refractive
    return scene, cam, cfg


def make_big_world(n_instances: int, seed: int = 7, spacing: float = 2.5):
    """``n_instances`` translated cube instances scattered in a cube volume —
    the at-scale fixture for the LBVH walk (O(log N)) vs the dense candidate
    cull (O(N)).  Returns ``(scene, camera, cfg)``."""
    sb = SceneBuilder()
    tc = TextureCoords()
    mat = Material(
        kd=np.array([0.6, 0.5, 0.3, 1.0], f32),
        ka=np.array([0.2, 0.2, 0.2, 1.0], f32),
    )
    mesh = sb.build_cube(1.0, tc, mat)

    side = int(np.ceil(n_instances ** (1.0 / 3.0)))
    rng = np.random.RandomState(seed)
    # jittered grid: dense enough that most primary rays hit, no overlaps
    cells = [(x, y, z) for x in range(side) for y in range(side)
             for z in range(side)]
    rng.shuffle(cells)
    half = 0.5 * (side - 1) * spacing
    for (cx, cy, cz) in cells[:n_instances]:
        t = sb.add_trans(sb.get_mesh_builder(mesh))
        jit = rng.uniform(-0.4, 0.4, 3)
        sb.get_transformation(t).set_position([
            cx * spacing - half + jit[0],
            cy * spacing - half + jit[1],
            cz * spacing - half + jit[2],
        ])

    sb.add_directional_light([0.3, -1.0, 0.5], [1.0, 1.0, 1.0, 1.0])
    scene = sb.finish()
    import dataclasses

    scene = dataclasses.replace(
        scene,
        ambience=np.array([0.25, 0.25, 0.25, 1.0], f32),
        dist_atten=np.array([1.0, 0.0, 0.0], f32),
    )

    cam = make_camera(0.7853982, 64.0, 128, 96)
    cam = dataclasses.replace(
        cam, pos=np.array([0.0, 0.0, -(half + side * spacing)], f32)
    )
    cfg = RenderConfig(width=128, height=96, recurse_depth=0,
                       **scene_render_flags(scene))
    return scene, cam, cfg


def _icosphere(subdiv: int = 1):
    """Icosphere triangle list (verts [V,3], tris [T,3]); subdiv=1 -> 80
    triangles — a general trimesh far from the box fast path's 12."""
    t = (1.0 + 5.0 ** 0.5) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], f32)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    tris = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int32)
    for _ in range(subdiv):
        cache = {}
        vlist = list(verts)

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = vlist[a] + vlist[b]
                m = m / np.linalg.norm(m)
                cache[key] = len(vlist)
                vlist.append(m.astype(f32))
            return cache[key]

        out = []
        for (a, b, c) in tris:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            out += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(vlist, f32)
        tris = np.asarray(out, np.int32)
    return verts, tris


def make_sphere_world(n_instances: int = 64, subdiv: int = 1, seed: int = 3,
                      spacing: float = 2.5):
    """General-trimesh fixture: ``n_instances`` icospheres (80 triangles per
    mesh at subdiv=1 — the box fast path is OFF, every hit takes the
    template triangle loop).  Returns ``(scene, camera, cfg)``."""
    sb = SceneBuilder()
    tc = TextureCoords()
    mat = Material(
        kd=np.array([0.55, 0.45, 0.75, 1.0], f32),
        ka=np.array([0.2, 0.2, 0.25, 1.0], f32),
        alpha=8.0,
    )
    verts, tris = _icosphere(subdiv)
    mesh = sb.create_mesh()
    mb = sb.get_mesh_builder(mesh)
    base = [sb.add_vertex(v) for v in verts]
    for (a, b, c) in tris:
        mb.add_triangle([base[a], base[b], base[c]], tc, mat)

    side = int(np.ceil(n_instances ** (1.0 / 3.0)))
    rng = np.random.RandomState(seed)
    cells = [(x, y, z) for x in range(side) for y in range(side)
             for z in range(side)]
    rng.shuffle(cells)
    half = 0.5 * (side - 1) * spacing
    for (cx, cy, cz) in cells[:n_instances]:
        t = sb.add_trans(mb)
        jit = rng.uniform(-0.3, 0.3, 3)
        sb.get_transformation(t).set_position([
            cx * spacing - half + jit[0],
            cy * spacing - half + jit[1],
            cz * spacing - half + jit[2],
        ])

    sb.add_directional_light([0.3, -1.0, 0.5], [1.0, 1.0, 1.0, 1.0])
    scene = sb.finish()
    import dataclasses

    scene = dataclasses.replace(
        scene,
        ambience=np.array([0.25, 0.25, 0.25, 1.0], f32),
        dist_atten=np.array([1.0, 0.0, 0.0], f32),
    )

    cam = make_camera(0.7853982, 64.0, 128, 96)
    cam = dataclasses.replace(
        cam, pos=np.array([0.0, 0.0, -(half + side * spacing)], f32)
    )
    cfg = RenderConfig(width=128, height=96, recurse_depth=0,
                       **scene_render_flags(scene))  # max_tris from the scene
    return scene, cam, cfg
