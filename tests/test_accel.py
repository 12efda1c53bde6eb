"""LBVH build + traversal reachability vs direct box tests."""

import numpy as np

import jax
import jax.numpy as jnp

from raytracer import generate, raymath as rm
from raytracer.accel import build_lbvh, leaf_instances, traverse_mask_reference
from raytracer.render.geometry import camera_rays, expand_geometry
from raytracer.scene import device_scene


def test_lbvh_layout_and_root():
    w = generate("cubes8")
    scene = device_scene(w.scene)
    geom = expand_geometry(scene)
    bvh = build_lbvh(geom.aabb_min, geom.aabb_max)
    n = bvh.n_leaves
    assert n >= scene.inst_pos.shape[0] and (n & (n - 1)) == 0
    assert bvh.box_min.shape[0] == 2 * n - 1
    # root (last box) bounds the whole scene
    root_min = np.asarray(bvh.box_min[-1])
    root_max = np.asarray(bvh.box_max[-1])
    assert (root_min <= np.asarray(geom.aabb_min).min(0) + 1e-5).all()
    assert (root_max >= np.asarray(geom.aabb_max).max(0) - 1e-5).all()
    # ordering is a permutation of instances (padding = -1)
    order = np.asarray(bvh.ordering)
    real = order[order >= 0]
    assert sorted(real.tolist()) == list(range(scene.inst_pos.shape[0]))


def test_lbvh_traversal_reaches_all_hit_instances():
    """Every instance whose AABB a ray hits must be reachable through the tree
    (ancestor boxes contain descendants, so the chain of box hits holds)."""
    w = generate("cubes8")
    scene = device_scene(w.scene)
    geom = expand_geometry(scene)
    bvh = build_lbvh(geom.aabb_min, geom.aabb_max)

    cam = jax.tree_util.tree_map(jnp.asarray, w.camera)
    ro, rd = camera_rays(cam, 64, 48)
    ro = ro.reshape(-1, 3)[::7]
    rd = rd.reshape(-1, 3)[::7]

    reach = traverse_mask_reference(bvh, ro, rd)  # [R, n_leaves]
    reached = leaf_instances(bvh, reach)  # [R, n] instance ids or -1

    direct, _ = rm.ray_aabb(
        ro[:, None, :], rd[:, None, :], geom.aabb_min[None], geom.aabb_max[None]
    )
    direct = np.asarray(direct)
    reached = np.asarray(reached)
    for r in range(direct.shape[0]):
        need = set(np.nonzero(direct[r])[0].tolist())
        got = set(x for x in reached[r].tolist() if x >= 0)
        assert need <= got, f"ray {r}: missing {need - got}"


def test_bvh_walk_scales_logarithmically():
    """The in-kernel LBVH walk (the Triton kernel) must visit O(log N)
    nodes per occluder: growing a cube grid 64x (256 -> 16384 instances) may
    only grow per-block node visits by a small constant factor, and hits must
    still match the brute oracle (production accel requirement; reference
    analog: warp-synchronous stackless iterator, src/rayopt/bvh.cu:99-122)."""
    import jax
    import jax.numpy as jnp

    from raytracer.builder import Material, SceneBuilder, TextureCoords
    from raytracer.render import pallas_engine as pe
    from raytracer.render.cast import make_brute_cast
    from raytracer.render.geometry import expand_geometry
    from raytracer.scene import RenderConfig, device_scene

    def grid_world(side):
        sb = SceneBuilder()
        mat = Material(kd=np.array([1, 0, 0, 1], np.float32))
        mesh = sb.build_cube(1.0, TextureCoords(), mat)
        mb = sb.get_mesh_builder(mesh)
        for gx in range(side):
            for gz in range(side):
                ti = sb.add_trans(mb)
                sb.get_transformation(ti).set_position(
                    [1.0 * gx, 0.0, 1.0 * gz])  # touching: fills the plane
        return device_scene(sb.finish())

    cfg = RenderConfig(max_tris_per_mesh=12, interpret=True)

    # one coherent 32x32 patch of rays looking down at the middle of the grid
    def rays_for(side):
        n = 1024
        span = 6.0
        mid = 0.5 * side
        xs = np.linspace(mid - span, mid + span, 32, dtype=np.float32)
        zs = np.linspace(mid - span, mid + span, 32, dtype=np.float32)
        gx, gz = np.meshgrid(xs, zs)
        ro = np.stack([gx.ravel(), np.full(n, 10.0, np.float32), gz.ravel()],
                      -1)
        rd = np.broadcast_to(np.array([0, -1, 0], np.float32), (n, 3)).copy()
        return jnp.asarray(ro), jnp.asarray(rd)

    visits = {}
    for side in (16, 128):  # 256 vs 16384 instances
        scene = grid_world(side)
        geom = expand_geometry(scene)
        cast = pe.make_pallas_cast(scene, geom, cfg)
        ro, rd = rays_for(side)
        hit = cast(ro, rd)
        if side == 16:
            brute = make_brute_cast(geom)(ro, rd)
            assert (np.asarray(hit.valid) == np.asarray(brute.valid)).all()
            both = np.asarray(hit.valid)
            np.testing.assert_allclose(
                np.asarray(hit.t)[both], np.asarray(brute.t)[both],
                rtol=1e-5, atol=1e-5)
        assert bool(np.asarray(hit.valid).all())  # grid fills the view
        visits[side] = float(np.mean(np.asarray(cast.visit_counts(ro, rd))))

    # 64x more instances must cost far less than 64x the nodes; the implicit
    # heap adds ~log2(64) = 6 levels, so allow a 4x envelope.
    assert visits[128] < 4.0 * visits[16], visits
