"""Phong shading, lights, and the transmissive shadow march (pure jnp).

Behavior spec (reference: src/rayprimitives/phong.cu, src/rayprimitives/light.cu):

* ``illuminate = Ke + Ka*ambience + sum_lights phong(...)`` (phong.cu:36-53).
* ``phong``: diffuse ``max(dot(L, N), 0) * Kd``; specular
  ``max(dot(-reflect(-L, N), V), 0)^alpha * Ks`` (phong.cu:14-33).  NOTE the
  reference feeds the *raw* (possibly non-unit) ``dir_to_light`` of directional
  lights into these dot products (light.cu:74-77 sets ``dir_to_light = -dir``
  unnormalized) — preserved.
* Point lights scale by distance attenuation ``1/max(1, c + l*d + q*d^2)``
  (light.cu:11-17).
* Shadow march (light.cu:30-61): walk the shadow ray; opaque blocker kills the
  light; a refractive blocker multiplies by ``Kt^segment`` when the ray exits it
  (normal . dir > 0) and marching continues past it; a blocker beyond the light
  leaves it lit.  The reference loop is unbounded; ours runs ``shadow_steps``
  fixed iterations with an alive mask (documented deviation; each step can only
  trigger on a refractive blocker, so small bounds are exact for these scenes).

Everything is batched over rays and differentiable.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import raymath as rm
from ..scene import RenderConfig, Scene
from .cast import CastFn, Hit, hit_shading_attrs
from .geometry import WorldGeometry


def gather_material_rows(mats, mat_idx):
    """Per-ray material rows via ONE one-hot matmul instead of eight gathers.

    The material table is tiny (a handful of rows), so ``onehot @ table`` is
    a trivial matmul — and crucially its *transpose* (the backward pass's
    gradient-to-table reduction) is also a matmul, where a gather's transpose
    is a frame-sized scatter-add (its cost on the GPU is not measured).
    Returns a
    ``Materials`` whose leaves are per-ray rows ([R,4] / [R])."""
    import dataclasses

    k = mats.kd.shape[0]
    onehot = jax.nn.one_hot(mat_idx, k, dtype=jnp.float32)  # [R, K]
    table = jnp.concatenate(
        [mats.ke, mats.ka, mats.kd, mats.ks, mats.kt, mats.kr,
         mats.alpha[:, None], mats.eta[:, None]], axis=1,
    )  # [K, 26]
    # precision=HIGHEST: a DEFAULT-precision f32 matmul may round its inputs
    # (TF32 on the GPU's tensor cores, bf16 on some XLA:CPU builds), which
    # QUANTIZES the gathered material values — measured as ~4e-3-wide kt
    # plateaus that break finite-difference gradient checks.  The selection
    # matmul is tiny, so exact f32 costs nothing.
    rows = jnp.matmul(onehot, table,
                      precision=jax.lax.Precision.HIGHEST)  # [R, 26]
    return dataclasses.replace(
        mats,
        ke=rows[:, 0:4], ka=rows[:, 4:8], kd=rows[:, 8:12], ks=rows[:, 12:16],
        kt=rows[:, 16:20], kr=rows[:, 20:24], alpha=rows[:, 24],
        eta=rows[:, 25],
    )


def distance_attenuation(scene: Scene, dist):
    c = scene.dist_atten[0]
    l = scene.dist_atten[1]
    q = scene.dist_atten[2]
    quad = c + l * dist + q * dist * dist
    return jnp.where(quad < 1.0, 1.0, 1.0 / jnp.maximum(quad, 1.0))


def shadow_attenuation(kt, dist):
    """``Kt^dist`` per channel (light.cu:19-26); gradient-safe at kt == 0."""
    return rm.safe_pow(kt, dist[..., None])


def _march_shadow(scene: Scene, geom: WorldGeometry, cast_fn: CastFn,
                  origin, dir_unit, max_t, light_col, cfg: RenderConfig,
                  active):
    """Bounded transmissive shadow march; returns per-ray RGBA attenuated light."""
    mats = scene.materials
    dir_unit = jnp.broadcast_to(dir_unit, origin.shape)
    # Inactive lanes (primary miss / dead wavefront slots) still occupy cast
    # lanes; parking their origins far outside the scene makes every
    # instance/BVH vote fail so their tiles cost ~nothing.
    far = jnp.float32(1e30)
    origin = jnp.where(active[..., None], origin, far)

    if not cfg.any_refractive:
        # Static fast path: no material transmits, so the march degenerates to
        # one occlusion query — a blocker strictly before the light kills it
        # (light.cu:41-45), anything else leaves it lit.  Casts that provide
        # an any-hit kernel (Pallas) answer it without best-hit bookkeeping.
        o = origin + rm.THRESHOLD * dir_unit
        occ = getattr(cast_fn, "occlude", None)
        if occ is not None:
            blocked = active & occ(o, dir_unit, max_t)
        else:
            hit = cast_fn(o, dir_unit)
            t_fin = jnp.where(hit.valid, hit.t, 1.0)
            blocked = active & hit.valid & (t_fin <= max_t)
        # Named so the per-sample remat policy (engine._scan_samples) can SAVE
        # this boolean instead of re-walking the occlusion BVH in the
        # backward recompute: the mask is detached (piecewise-constant) and
        # 1 byte/ray, while the any-hit walk is ~as expensive as a full cast
        # — the shadow queries are ~40% of a stress-world sample's forward.
        from jax.ad_checkpoint import checkpoint_name

        blocked = checkpoint_name(blocked, "shadow_occl")
        lit = jnp.broadcast_to(light_col, origin.shape[:-1] + (4,))
        return jnp.where(blocked[..., None], 0.0, lit)

    def step(_, carry):
        rv, cur_o, remaining, alive = carry
        hit = cast_fn(cur_o, dir_unit)
        h_norm, h_mat, _ = hit_shading_attrs(geom, hit)
        step_hit = alive & hit.valid
        t_fin = jnp.where(hit.valid, hit.t, 1.0)  # keep masked lanes finite
        beyond = step_hit & (t_fin > remaining)
        # one-hot matmul instead of a gather: its transpose is a matmul, not
        # a scatter (see gather_material_rows); HIGHEST precision keeps the
        # selected kt exact f32 (DEFAULT may run it in TF32)
        kt = jnp.matmul(jax.nn.one_hot(h_mat, mats.kt.shape[0],
                                       dtype=jnp.float32), mats.kt,
                        precision=jax.lax.Precision.HIGHEST)
        refractive = jnp.any(kt > 0.0, axis=-1)
        opaque = step_hit & ~beyond & ~refractive
        continuing = step_hit & ~beyond & refractive

        rv = jnp.where(opaque[..., None], 0.0, rv)
        exiting = continuing & (rm.dot(h_norm, dir_unit) > 0.0)
        # Pre-mask the path length so inactive lanes (t == inf) cannot leak
        # NaNs through the pow gradient.
        t_m = jnp.where(continuing, t_fin, 1.0)
        atten = shadow_attenuation(kt, t_m)
        rv = jnp.where(exiting[..., None], rv * atten, rv)

        cur_o = jnp.where(
            continuing[..., None], cur_o + t_m[..., None] * dir_unit, cur_o
        )
        remaining = jnp.where(continuing, remaining - t_m, remaining)
        return rv, cur_o, remaining, continuing

    init = (
        jnp.broadcast_to(light_col, origin.shape[:-1] + (4,)),
        origin + rm.THRESHOLD * dir_unit,  # to_light.at(THRESHOLD), light.cu:32
        jnp.broadcast_to(max_t, origin.shape[:-1]),
        active,
    )
    if cfg.early_exit:
        # March only while any ray still walks a transmissive chain — on typical
        # scenes this executes 1 cast instead of shadow_steps.  (while_loop is
        # not reverse-differentiable; training uses early_exit=False.)
        def cond(carry):
            i, st = carry
            return (i < cfg.shadow_steps) & jnp.any(st[3])

        def body(carry):
            i, st = carry
            return i + 1, step(i, st)

        _, (rv, _, _, _) = jax.lax.while_loop(cond, body, (0, init))
    else:
        rv, _, _, _ = jax.lax.fori_loop(0, cfg.shadow_steps, step, init)
    return rv


def sample_atlas(scene: Scene, geom: WorldGeometry, hit: Hit):
    """Nearest-neighbor atlas sample for a hit (extension; the reference's
    texture objects use point filtering + clamp addressing, gputils/alloc.h:49-53).
    TextureCoords (texture_x, texture_y, u, v) define an atlas rect; the hit's
    barycentric uv interpolates inside it."""
    tri = scene.wtri_tri[hit.wtri]
    rect = scene.tri_coord_rect[tri]  # [.,4]
    degenerate = scene.tri_coord_degenerate[tri]
    h, w = scene.atlas.shape[0], scene.atlas.shape[1]
    px = jnp.clip((rect[..., 0] + hit.uv[..., 0] * rect[..., 2]).astype(jnp.int32),
                  0, w - 1)
    py = jnp.clip((rect[..., 1] + hit.uv[..., 1] * rect[..., 3]).astype(jnp.int32),
                  0, h - 1)
    return scene.atlas[py, px], degenerate


def phong_term(rmats, incoming, ray_dir, dir_to_light, normal,
               kd_override=None):
    """One light's Phong contribution (phong.cu:14-33).  ``rmats`` holds
    per-ray material rows (gather_material_rows)."""
    kd = rmats.kd if kd_override is None else kd_override
    ks = rmats.ks
    alpha = rmats.alpha
    norm_dot = jnp.maximum(rm.dot(dir_to_light, normal), 0.0)
    diffuse = norm_dot[..., None] * kd
    reflected = rm.reflect(-dir_to_light, normal)
    reflect_dot = rm.dot(-reflected, ray_dir)
    spec = rm.safe_pow(jnp.maximum(reflect_dot, 0.0), alpha)[..., None] * ks
    return (diffuse + spec) * incoming


def illuminate(scene: Scene, geom: WorldGeometry, cast_fn: CastFn, cfg: RenderConfig,
               ray_o, ray_d, hit: Hit, normal, rmats, active):
    """Full local shading at a hit point (phong.cu:40-67).  ``rmats`` holds
    per-ray material rows (gather_material_rows)."""
    hit_pos = ray_o + hit.t[..., None] * ray_d
    col = rmats.ke + rmats.ka * scene.ambience

    kd_override = None
    if cfg.texture_mapping:
        tex, degenerate = sample_atlas(scene, geom, hit)
        kd_override = jnp.where(degenerate[..., None], rmats.kd, tex)

    n_point = scene.lights.point_pos.shape[0]
    n_dir = scene.lights.dir_dir.shape[0]

    occ2 = getattr(cast_fn, "occlude2", None)
    if (cfg.fused_shadows and not cfg.any_refractive and n_point == 1
            and n_dir == 1 and occ2 is not None):
        # FUSED two-light round: one dual-query LBVH walk answers both
        # shadow queries (bit-identical to the per-light marches — the
        # opaque fast path is a single occlusion test per light).
        from jax.ad_checkpoint import checkpoint_name

        far = jnp.float32(1e30)
        o_park = jnp.where(active[..., None], hit_pos, far)
        lpos = scene.lights.point_pos[0]
        lcol1 = scene.lights.point_col[0]
        disp = lpos - hit_pos
        dist = rm.norm(disp)
        dir1 = rm.normalize(disp)
        ldir = scene.lights.dir_dir[0]
        dir_to_light2 = -ldir  # raw, possibly non-unit (light.cu:74-77)
        dir2 = jnp.broadcast_to(rm.normalize(dir_to_light2), hit_pos.shape)
        b1, b2 = occ2(o_park + rm.THRESHOLD * dir1, dir1, dist,
                      o_park + rm.THRESHOLD * dir2, dir2, jnp.inf)
        b1 = checkpoint_name(active & b1, "shadow_occl")
        b2 = checkpoint_name(active & b2, "shadow_occl")
        datten = distance_attenuation(scene, dist)
        incoming1 = datten[..., None] * jnp.where(
            b1[..., None], 0.0,
            jnp.broadcast_to(lcol1, hit_pos.shape[:-1] + (4,)))
        col = col + phong_term(rmats, incoming1, ray_d, dir1, normal,
                               kd_override)
        lcol2 = scene.lights.dir_col[0]
        incoming2 = jnp.where(
            b2[..., None], 0.0,
            jnp.broadcast_to(lcol2, hit_pos.shape[:-1] + (4,)))
        col = col + phong_term(rmats, incoming2, ray_d, dir_to_light2,
                               normal, kd_override)
        return col

    for i in range(n_point):
        lpos = scene.lights.point_pos[i]
        lcol = scene.lights.point_col[i]
        disp = lpos - hit_pos
        dist = rm.norm(disp)
        datten = distance_attenuation(scene, dist)
        dir_to_light = rm.normalize(disp)
        incoming = datten[..., None] * _march_shadow(
            scene, geom, cast_fn, hit_pos, dir_to_light, dist, lcol, cfg, active
        )
        col = col + phong_term(rmats, incoming, ray_d, dir_to_light,
                               normal, kd_override)

    for i in range(n_dir):
        ldir = scene.lights.dir_dir[i]
        lcol = scene.lights.dir_col[i]
        dir_to_light = -ldir  # raw, possibly non-unit (light.cu:74-77)
        march_dir = rm.normalize(dir_to_light)  # Ray ctor normalizes for the march
        incoming = _march_shadow(
            scene, geom, cast_fn, hit_pos, march_dir, jnp.inf, lcol, cfg, active
        )
        col = col + phong_term(rmats, incoming, ray_d, dir_to_light,
                               normal, kd_override)
    return col
