"""Pallas-Triton walk kernels vs the jnp oracle.

On the CPU the kernels run in the Pallas interpreter (``interpret=True``,
always asked for explicitly), and their lowering to Triton for the GPU is
checked without a card (``lowering_platforms=("cuda",)``).  Tests marked
``gpu`` run the compiled kernels and skip when no CUDA device is present.

The kernel's semantics must match the brute-force oracle: same hits, same
times, same faces and instances, same shading attributes — for coherent
primary blocks and for incoherent (shadow/bounce-like) ray batches."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from raytracer import generate
from raytracer.render.cast import make_brute_cast
from raytracer.render.geometry import camera_rays, expand_geometry
from raytracer.render import pallas_engine as pe
from raytracer.scene import RenderConfig, device_scene


@pytest.fixture(scope="module")
def world8():
    w = generate("cubes8")
    w.config = w.config.replace(interpret=True)
    scene = device_scene(w.scene)
    cam = jax.tree_util.tree_map(jnp.asarray, w.camera)
    geom = expand_geometry(scene)
    return w, scene, cam, geom


def _compare(hit_p, hit_b, scene, geom):
    """Box-fast-path contract: identical hit mask, times, and everything
    shading consumes (faceted normal, material, instance) — the reported
    triangle id is a representative of the hit FACE (either of the face's two
    coplanar triangles shades identically; pallas_engine._box_face_hit)."""
    from raytracer.render.cast import hit_shading_attrs

    vp = np.asarray(hit_p.valid)
    vb = np.asarray(hit_b.valid)
    assert (vp == vb).all()
    both = vp & vb
    np.testing.assert_allclose(
        np.asarray(hit_p.t)[both], np.asarray(hit_b.t)[both], rtol=1e-5, atol=1e-5
    )
    # same face + same instance (tri id at face granularity)
    _, _, _, face_of, _ = pe._detect_box_meshes(scene)
    face_of = np.asarray(face_of)
    wtri_tri = np.asarray(scene.wtri_tri)
    inst = np.asarray(geom.inst)
    wp = np.asarray(hit_p.wtri)[both]
    wb = np.asarray(hit_b.wtri)[both]
    assert (inst[wp] == inst[wb]).all()
    assert (face_of[wtri_tri[wp]] == face_of[wtri_tri[wb]]).all()
    # shading attributes are exact
    n_p, m_p, _ = hit_shading_attrs(geom, hit_p)
    n_b, m_b, _ = hit_shading_attrs(geom, hit_b)
    np.testing.assert_allclose(
        np.asarray(n_p)[both], np.asarray(n_b)[both], atol=1e-5
    )
    assert (np.asarray(m_p)[both] == np.asarray(m_b)[both]).all()


def _incoherent(seed, n, lo=-5.0, hi=5.0):
    rng = np.random.RandomState(seed)
    o = jnp.asarray(rng.uniform(lo, hi, (n, 3)).astype(np.float32))
    d = rng.randn(n, 3).astype(np.float32)
    d = jnp.asarray(d / np.linalg.norm(d, axis=-1, keepdims=True))
    return o, d, rng


def test_pallas_cast_matches_oracle_coherent(world8):
    w, scene, cam, geom = world8
    ro, rd = camera_rays(cam, 128, 96)
    ro = ro.reshape(-1, 3)
    rd = rd.reshape(-1, 3)
    hit_p = pe.make_pallas_cast(scene, geom, w.config)(ro, rd)
    hit_b = make_brute_cast(geom)(ro, rd)
    assert int(np.asarray(hit_b.valid).sum()) > 0
    _compare(hit_p, hit_b, scene, geom)


def test_pallas_cast_matches_oracle_incoherent(world8):
    w, scene, cam, geom = world8
    o, d, _ = _incoherent(0, 1024)
    hit_p = pe.make_pallas_cast(scene, geom, w.config)(o, d)
    hit_b = make_brute_cast(geom)(o, d)
    assert int(np.asarray(hit_b.valid).sum()) > 0
    _compare(hit_p, hit_b, scene, geom)


def test_occlude_matches_closest_hit(world8):
    """The walk's any-hit occlusion must agree with ``valid & t <= max_t`` of
    its closest-hit cast for every max_t (the closest hit is minimal), and
    the fused two-query walk must equal two single queries."""
    w, scene, cam, geom = world8
    cast = pe.make_pallas_cast(scene, geom, w.config)

    ro, rd = camera_rays(cam, 64, 64)
    ro = ro.reshape(-1, 3)
    rd = rd.reshape(-1, 3)
    hit = cast(ro, rd)
    t_fin = jnp.where(hit.valid, hit.t, jnp.inf)
    for max_t in (0.5, 2.0, jnp.inf):
        want = np.asarray(hit.valid & (t_fin <= max_t))
        got = np.asarray(cast.occlude(ro, rd, jnp.float32(max_t)))
        assert (want == got).all(), f"max_t={max_t}"

    o, d, rng = _incoherent(7, 512)
    mt = jnp.asarray(rng.uniform(0.1, 10.0, (512,)).astype(np.float32))
    hit = cast(o, d)
    t_fin = jnp.where(hit.valid, hit.t, jnp.inf)
    want = np.asarray(hit.valid & (t_fin <= mt))
    got = np.asarray(cast.occlude(o, d, mt))
    assert (want == got).all()
    b1, b2 = cast.occlude2(o, d, mt, ro[:512], rd[:512], jnp.inf)
    assert (np.asarray(b1) == want).all()
    assert (np.asarray(b2) == np.asarray(cast.occlude(ro[:512], rd[:512],
                                                      jnp.inf))).all()


def test_bvh_occlude_matches_closest_hit():
    """The walk's occlusion must agree with ``valid & t <= max_t`` of the
    closest-hit cast on a synthetic world large enough for a deep tree
    (300 instances), with random incoherent shadow-style rays."""
    from raytracer.synth import make_big_world

    scene, cam, cfg = make_big_world(300)
    scene = device_scene(scene)
    cfg = cfg.replace(interpret=True)
    geom = expand_geometry(scene)
    cast = pe.make_pallas_cast(scene, geom, cfg)

    cam = jax.tree_util.tree_map(jnp.asarray, cam)
    ro, rd = camera_rays(cam, 64, 64)
    ro = ro.reshape(-1, 3)
    rd = rd.reshape(-1, 3)
    hit = cast(ro, rd)
    t_fin = jnp.where(hit.valid, hit.t, jnp.inf)
    for max_t in (5.0, jnp.inf):
        want = np.asarray(hit.valid & (t_fin <= max_t))
        got = np.asarray(cast.occlude(ro, rd, jnp.float32(max_t)))
        assert (want == got).all(), f"max_t={max_t}"

    o, d, rng = _incoherent(11, 1024, -12.0, 12.0)
    mt = jnp.asarray(rng.uniform(0.5, 30.0, (1024,)).astype(np.float32))
    hit = cast(o, d)
    t_fin = jnp.where(hit.valid, hit.t, jnp.inf)
    want = np.asarray(hit.valid & (t_fin <= mt))
    got = np.asarray(cast.occlude(o, d, mt))
    assert (want == got).all()


def test_bvh_render_matches_cull_big_world():
    """End-to-end render of the at-scale synthetic world: the Triton walk
    (cast + occlusion walk, exercised via the shadow fast path) must
    reproduce the XLA culled-cast engine's image."""
    from raytracer.render.engine import render_frame
    from raytracer.synth import make_big_world

    scene, cam, cfg = make_big_world(300)
    scene = device_scene(scene)
    cam = jax.tree_util.tree_map(jnp.asarray, cam)
    cfg = cfg.replace(width=96, height=72)
    assert not cfg.any_refractive  # shadow march uses the occlude fast path
    img_cull = np.asarray(render_frame(scene, cam,
                                       cfg.replace(engine="jnp",
                                                   use_bvh=True)))
    img_walk = np.asarray(render_frame(scene, cam,
                                       cfg.replace(engine="pallas",
                                                   interpret=True)))
    np.testing.assert_allclose(img_walk, img_cull, rtol=1e-5, atol=1e-5)


def test_box_detection_world8(world8):
    """Both cube-world meshes must be detected as boxes (build_cube layout,
    scene_builder.cu:181-239); a perturbed copy must not."""
    import dataclasses

    w, scene, cam, geom = world8
    is_box, mat, face_tri, face_of, _ = pe._detect_box_meshes(scene)
    assert bool(np.asarray(is_box).all())
    # perturb one vertex off its corner -> not a box anymore
    verts = np.asarray(scene.verts).copy()
    verts[0] += 0.05
    scene2 = dataclasses.replace(scene, verts=jnp.asarray(verts))
    is_box2, _, _, _, _ = pe._detect_box_meshes(scene2)
    assert not bool(np.asarray(is_box2)[0])


def test_fused_dual_light_occlusion_matches():
    """cfg.fused_shadows merges a two-light round's shadow queries into one
    dual-query LBVH walk; frames must be bit-identical to the per-light
    occlusion path (cubes8: 1 point + 1 dir light, opaque)."""
    from raytracer.render import render_frame

    w = generate("cubes8")
    scene = device_scene(w.scene)
    cam = jax.tree_util.tree_map(jnp.asarray, w.camera)
    cfg = w.config.replace(width=160, height=96, engine="pallas",
                           interpret=True)
    base = np.asarray(render_frame(
        scene, cam, cfg.replace(fused_shadows=False)))
    fused = np.asarray(render_frame(
        scene, cam, cfg.replace(fused_shadows=True)))
    np.testing.assert_array_equal(base, fused)


def test_fused_dual_light_occlusion_gradients_match():
    """The fused dual-query shadow path must also agree in REVERSE mode: the
    gradient of the mean image wrt materials + light colors + camera pose is
    identical (to f32 tolerance) whether the two shadow queries run fused
    (pallas_occlude2_detached, with its scalar jnp.inf max_t cotangent) or
    per-light.  Guards the occlude2 custom_vjp zero-cotangent rule, which a
    forward bit-identity test cannot see."""
    from raytracer import diff

    w = generate("cubes8")
    scene = device_scene(w.scene)
    cam = jax.tree_util.tree_map(jnp.asarray, w.camera)
    cfg = w.config.replace(width=96, height=64, engine="pallas",
                           interpret=True)
    params = diff.trainable_params(scene, cam)
    target = jnp.zeros((cfg.height, cfg.width, 4), jnp.float32)

    def grads_for(c):
        loss_fn = diff.make_loss_fn(scene, cam, c, target)
        return jax.jit(jax.grad(loss_fn))(params)

    g_base = grads_for(cfg.replace(fused_shadows=False))
    g_fused = grads_for(cfg.replace(fused_shadows=True))
    for leaf_b, leaf_f in zip(jax.tree_util.tree_leaves(g_base),
                              jax.tree_util.tree_leaves(g_fused)):
        np.testing.assert_allclose(np.asarray(leaf_b), np.asarray(leaf_f),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("d,block", [
    (1, 32), (4, 32), (5, 32), (6, 64), (8, 64), (9, 128), (16, 256),
    (32, 1024), (64, 1024),
])
def test_ray_block_for_dim(d, block):
    """The CLI's -d (the reference's d x d CUDA block, src/main.cc:38) maps
    to a Triton block of d*d rays rounded up to a power of two, kept within
    one warp (32) and 1024 rays."""
    assert pe.ray_block_for_dim(d) == block


def test_dim_flag_sets_ray_block(monkeypatch):
    """cli -d reaches RenderConfig.ray_block."""
    from raytracer import cli
    import raytracer.render as render

    seen = {}

    def fake_render(scene, camera, cfg):
        seen["cfg"] = cfg
        return jnp.zeros((cfg.height, cfg.width, 4), jnp.float32)

    monkeypatch.setattr(render, "render_frame", fake_render)
    assert cli.main(["-c", "cubes1", "-d", "8", "-b", "--width", "32",
                     "--height", "32"]) == 0
    assert seen["cfg"].ray_block == 64


def test_num_warps_for_block():
    assert [pe.num_warps_for_block(b) for b in (16, 32, 64, 128, 1024)] == \
        [1, 1, 2, 4, 4]


def test_ray_block_must_be_power_of_two(world8):
    w, scene, cam, geom = world8
    with pytest.raises(ValueError, match="power of two"):
        pe.make_pallas_cast(scene, geom, w.config.replace(ray_block=48))


def test_block_rays_pads_with_parked_rays():
    """Rays pad to a whole number of blocks; pad rays park at 1e30 with a
    unit direction so their blocks fail every vote."""
    ro = jnp.ones((5, 7, 3))
    rd = jnp.full((5, 7, 3), 0.5)
    comps, r, rp = pe._block_rays(ro, rd, 32)
    assert (r, rp) == (35, 64)
    assert all(c.shape == (64,) for c in comps)
    assert float(comps[0][34]) == 1.0
    assert comps[0][35] == np.float32(1.0e30)
    assert [float(c[40]) for c in comps[3:]] == [0.0, 0.0, 1.0]


def test_walk_cast_output_shapes(world8):
    """Any leading batch shape (here not a multiple of the block) comes back
    unchanged, with normal and material filled in."""
    w, scene, cam, geom = world8
    ro, rd = camera_rays(cam, 10, 7)
    hit = pe.make_pallas_cast(scene, geom, w.config.replace(ray_block=32))(
        ro, rd)
    assert hit.t.shape == (7, 10) and hit.uv.shape == (7, 10, 2)
    assert hit.normal.shape == (7, 10, 3) and hit.mat.shape == (7, 10)
    brute = make_brute_cast(geom)(ro, rd)
    assert (np.asarray(hit.valid) == np.asarray(brute.valid)).all()


def _pallas_calls(jaxpr):
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call":
            out.append(eqn)
            continue
        for v in eqn.params.values():
            for sub in v if isinstance(v, (tuple, list)) else (v,):
                sub = getattr(sub, "jaxpr", sub)
                if hasattr(sub, "eqns"):
                    out += _pallas_calls(sub)
    return out


def test_gpu_engine_never_interprets_by_itself(world8):
    """The default RenderConfig runs the kernels compiled: nothing switches
    the interpreter on behind the caller's back (no backend probe, no
    environment variable) — only ``interpret=True`` does."""
    from raytracer.render.engine import default_engine

    w, scene, cam, geom = world8
    assert RenderConfig().interpret is False
    assert default_engine() == "jnp"  # the Triton walk only on a GPU
    ro, rd = camera_rays(cam, 8, 8)
    for interp in (False, True):
        cfg = w.config.replace(interpret=interp)
        jx = jax.make_jaxpr(
            lambda a, b: pe.make_pallas_cast(scene, geom, cfg)(a, b).t)(ro, rd)
        calls = _pallas_calls(jx.jaxpr)
        assert calls and all(bool(e.params["interpret"]) == interp
                             for e in calls)


_KERNELS = {
    "cast": lambda c: c,
    "cast_exact_uv": lambda c: c,
    "occlude": lambda c: functools.partial(c.occlude, max_t=3.0),
    "occlude2": lambda c: lambda ro, rd: c.occlude2(ro, rd, 3.0, ro, rd,
                                                     jnp.inf),
}


@pytest.mark.parametrize("kernel", sorted(_KERNELS))
def test_kernel_lowers_for_cuda(world8, kernel):
    """Each kernel lowers through Pallas->Triton for a CUDA target on this
    CPU-only host (what the GPU compiler would reject at the Triton level —
    unsupported primitives, non-power-of-two blocks — fails here)."""
    w, scene, cam, geom = world8
    cfg = w.config.replace(interpret=False,
                           edge_aware_grads=kernel == "cast_exact_uv")
    ro, rd = camera_rays(cam, 64, 48)

    def f(a, b):
        out = _KERNELS[kernel](pe.make_pallas_cast(scene, geom, cfg))(a, b)
        return jax.tree_util.tree_leaves(out)

    lowered = jax.jit(f).trace(ro, rd).lower(lowering_platforms=("cuda",))
    assert "triton" in lowered.as_text().lower()


@pytest.mark.gpu
def test_compiled_kernels_match_oracle_on_gpu(world8):
    """The compiled Triton kernels (no interpreter) against the oracle, on a
    CUDA device: the same contract as the interpret-mode tests above."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU")
    w, scene, cam, geom = world8
    cfg = w.config.replace(interpret=False)
    ro, rd = camera_rays(cam, 128, 96)
    ro = ro.reshape(-1, 3)
    rd = rd.reshape(-1, 3)
    cast = pe.make_pallas_cast(scene, geom, cfg)
    with jax.default_matmul_precision("highest"):
        hit_b = make_brute_cast(geom)(ro, rd)
    hit_p = cast(ro, rd)
    _compare(hit_p, hit_b, scene, geom)
    t_fin = jnp.where(hit_b.valid, hit_b.t, jnp.inf)
    want = np.asarray(hit_b.valid & (t_fin <= 2.0))
    assert (np.asarray(cast.occlude(ro, rd, 2.0)) == want).all()
    b1, _ = cast.occlude2(ro, rd, 2.0, ro, rd, jnp.inf)
    assert (np.asarray(b1) == want).all()
