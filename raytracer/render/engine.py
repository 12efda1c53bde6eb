"""Top-level render engine: wavefront bounce propagation + frame assembly.

Replaces the reference's per-pixel recursion / explicit stack machine
(``propagate_ray``, src/rayenv/scene.cu:75-187 and the cleaner CPU recursion
scene.cu:222-268) with a **wavefront**: a fixed-capacity queue of ray items
(the SoA analog of ``RayFrame``), advanced one bounce round per loop step —
the array-shaped replacement for per-thread recursion stacks and the "sorted
stream/queue formulation" called for in BASELINE.json.

Two queue disciplines, chosen statically from scene facts:

* **pixel-aligned streams** (any world whose materials spawn only ONE child
  type — all fixture worlds): children inherit their parent's slot, so every
  round accumulates into the frame with a plain add and dead slots are merely
  parked (origins at 1e30 -> their cast blocks fail every vote).  No
  per-round compaction sort, no scatter.
* **compacted 2x streams** (scenes with both reflective AND refractive
  materials): reflect+refract children concatenate, actives sort to the
  front, and contributions scatter-add by carried pixel id.

Because round shapes are identical, the whole bounce loop compiles once
(a single cast + shade instance), instead of one copy per node of the
2^depth recursion tree.

Deviations from the reference's two (mutually inconsistent) recursion
implementations are documented in DEVIATIONS.md: each surface's own material
gates its reflect/refract spawning — equivalent to the CUDA path on every
fixture world (no fixture material has Kr and Kt simultaneously).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from .. import raymath as rm
from ..scene import Camera, RenderConfig, Scene
from .cast import CastFn, make_brute_cast, hit_shading_attrs
from .geometry import WorldGeometry, camera_rays, expand_geometry
from .shading import illuminate


def trans_attenuation(kt, time):
    """``time^Kt`` per channel (reference: src/rayenv/scene.cu:14-22).  Yes, the
    base is the *time*, not Kt — preserved verbatim.  Gradient-safe at 0."""
    from .. import raymath as _rm

    return _rm.safe_pow(jnp.maximum(time, 0.0)[..., None], kt)


# Rays per ENGINE screen tile (= BLOCK*BLOCK): the granularity of the
# wavefront queue and tile-compaction bookkeeping.  Distinct from the
# kernel's ray block (cfg.ray_block rays per Triton program), several of
# which make up one engine tile.
TILE_LANES = 1024


def radiance(scene: Scene, geom: WorldGeometry, cast_fn: CastFn, cfg: RenderConfig,
             ray_o, ray_d, pixel_angle=None):
    """Accumulated RGBA radiance for a flat batch of primary rays [R, 3].

    ``pixel_angle`` (optional scalar) is the angular size of one pixel; when
    given, the edge-aware gradient band is sized in *screen* pixels via the
    ray footprint (see the edge_aware block).

    Returns ``(acc [R,4], dropped)`` where ``dropped`` counts spawned children
    that exceeded queue capacity (0 for every fixture world; raise
    ``cfg.queue_factor`` if nonzero).

    ``cfg.wavefront_tile_cap`` > 0 selects the TILE-COMPACTED queue
    discipline (the "sorted stream" formulation): a visibility pre-cast finds
    the tiles containing any hit, the whole shading/shadow/bounce pipeline
    runs on only those tiles (capped at ``ceil(T * cap)``), and one hinted
    scatter-add maps contributions back.  Pays when the hit set is sparse —
    world1's single small cube occupies ~4 of 300 tiles, so every per-round
    full-frame pass (march glue, spawn math, parked casts) shrinks ~30x.
    Whole tiles keep their 1024 rays together, preserving the coherence the
    cast's tile votes rely on; hits in tiles beyond the cap are counted in
    ``dropped`` (0 on every tested world at the shipped caps)."""
    cap = cfg.wavefront_tile_cap
    if cap > 0.0 and ray_o.shape[0] % TILE_LANES == 0:
        T = ray_o.shape[0] // TILE_LANES
        Ct = max(1, int(-(-T * cap // 1)))  # ceil(T * cap)
        if Ct < T:
            return _radiance_tile_compacted(
                scene, geom, cast_fn, cfg, ray_o, ray_d, Ct, pixel_angle
            )
    return _radiance_dense(scene, geom, cast_fn, cfg, ray_o, ray_d,
                           pixel_angle)


def _radiance_tile_compacted(scene, geom, cast_fn, cfg, ray_o, ray_d, Ct,
                             pixel_angle):
    R = ray_o.shape[0]
    T = R // TILE_LANES
    # Visibility-only pre-cast: which tiles contain any hit.  stop_gradient —
    # the differentiable cast of the kept lanes happens inside the rounds.
    pre = cast_fn(jax.lax.stop_gradient(ray_o), jax.lax.stop_gradient(ray_d))
    valid_t = pre.valid.reshape(T, TILE_LANES)
    tile_hits = jnp.sum(valid_t, axis=-1)
    # Active tiles first (stable -> ascending ids within each group), then
    # re-sort the kept ids so gather/scatter run with sorted-unique hints.
    keep_t = jnp.sort(jnp.argsort(tile_hits == 0, stable=True)[:Ct])
    kept = jnp.zeros((T,), bool).at[keep_t].set(True)
    dropped_hits = jnp.sum(tile_hits) - jnp.sum(
        jnp.where(kept, tile_hits, 0)
    )

    # TILE-granular gather/scatter (whole 1024-lane rows): a few hundred
    # 16 KB rows instead of one row per ray.
    def take(x):
        xt = x.reshape(T, TILE_LANES, x.shape[-1])
        return jnp.take(xt, keep_t, axis=0, unique_indices=True,
                        indices_are_sorted=True,
                        mode='clip').reshape(-1, x.shape[-1])

    acc_c, dropped = _radiance_dense(
        scene, geom, cast_fn, cfg, take(ray_o), take(ray_d), pixel_angle
    )
    acc = jnp.zeros((T, TILE_LANES, 4), acc_c.dtype).at[keep_t].set(
        acc_c.reshape(-1, TILE_LANES, 4), unique_indices=True,
        indices_are_sorted=True, mode='drop',
    ).reshape(R, 4)
    return acc, dropped + dropped_hits.astype(jnp.int32)


def _radiance_dense(scene: Scene, geom: WorldGeometry, cast_fn: CastFn,
                    cfg: RenderConfig, ray_o, ray_d, pixel_angle=None):
    mats = scene.materials
    R = ray_o.shape[0]
    C = int(R * cfg.queue_factor)

    # Per-triangle band table for the edge-aware hinge: altitudes h_a/h_b/h_c
    # (b0/u/v -> opposite-edge world distance scales) and the inradius.  It
    # is STOP-GRADIENTED by design: at a silhouette e = bary x h -> 0, so the
    # product-rule term bary x dh/dtheta vanishes exactly where the band is
    # active — the boundary term flows entirely through the barycentrics'
    # analytic cast-VJP.  Practically this removes the band's [R]-row
    # gather transpose (a frame-sized scatter-add per round).
    band_tbl = None
    if cfg.edge_aware_grads:
        eab_t = geom.b - geom.a
        ebc_t = geom.c - geom.b
        eca_t = geom.a - geom.c
        n2_t = jnp.cross(eab_t, -eca_t)  # 2*area vector
        area2_t = rm.norm(n2_t)
        safe_t = jnp.maximum(area2_t, 1e-12)
        h_a_t = safe_t / jnp.maximum(rm.norm(ebc_t), 1e-12)
        h_b_t = safe_t / jnp.maximum(rm.norm(eca_t), 1e-12)
        h_c_t = safe_t / jnp.maximum(rm.norm(eab_t), 1e-12)
        r_in_t = safe_t / jnp.maximum(
            rm.norm(eab_t) + rm.norm(ebc_t) + rm.norm(eca_t), 1e-12
        )
        band_tbl = jax.lax.stop_gradient(
            jnp.stack([h_a_t, h_b_t, h_c_t, r_in_t], axis=-1)
        )

    # Static scene facts: when no material can reflect/refract, no child ray can
    # ever activate (material.h:104-112), so the whole bounce machinery drops
    # out of the compiled program.
    can_spawn = (cfg.any_reflective or cfg.any_refractive) and cfg.recurse_depth > 0

    def process_round(st, spawn_mask):
        """Cast + shade one wavefront round; returns (contrib [Cn,4], children)."""
        # Park dead slots' origins far outside the scene: compaction keeps
        # them contiguous at the back, so their cast tiles fail every vote
        # and cost ~nothing (dead lanes would otherwise re-trace from their
        # old hit points).
        o_cast = jnp.where(st["active"][:, None], st["o"], jnp.float32(1e30))
        hit = cast_fn(o_cast, st["d"])
        # Sanitize miss times (inf) immediately: downstream positions/lengths of
        # masked-out lanes must stay finite or reverse-mode NaN-poisons every
        # parameter gradient (the where-trap).
        from .cast import Hit as _Hit

        hit = _Hit(valid=hit.valid, t=jnp.where(hit.valid, hit.t, 1.0),
                   wtri=hit.wtri, uv=hit.uv, normal=hit.normal, mat=hit.mat)
        h_valid = st["active"] & hit.valid
        normal, mat_idx, _ = hit_shading_attrs(geom, hit)
        from .shading import gather_material_rows

        rmats = gather_material_rows(mats, mat_idx)
        kt = rmats.kt
        kr = rmats.kr

        # Transmission attenuation applies on every hit while inside a medium,
        # using the *hit* material's Kt and segment length (scene.cu:112-115).
        in_medium = st["in_obj"] & h_valid
        t_m = jnp.where(in_medium, hit.t, 1.0)  # mask inf t out of the pow grad
        atten_eff = jnp.where(
            in_medium[:, None],
            st["atten"] * trans_attenuation(kt, t_m),
            st["atten"],
        )

        lum = illuminate(scene, geom, cast_fn, cfg, st["o"], st["d"], hit,
                         normal, rmats, h_valid)
        vis = h_valid.astype(jnp.float32)
        if cfg.edge_aware_grads:
            # Edge-aware visibility (backward only): the hard hit mask is
            # piecewise-constant, so silhouette motion carries no autodiff
            # signal.  Replace its *gradient* with that of a mollified
            # interior indicator: a one-sided linear hinge clip(e/band, 0, 1)
            # on e = world-space distance from the hit point to the nearest
            # edge of the hit triangle (min barycentric times that edge's
            # altitude).  For a band of pixels straddling an edge, integrating
            # (1/band) * de/dtheta across it yields exactly the boundary
            # velocity term -L * dx_edge/dtheta, independent of the band width
            # — so the width is chosen purely for *sampling*: when the caller
            # supplies ``pixel_angle``, the band is sized to ``edge_px``
            # SCREEN pixels via the ray footprint t*alpha/|n.d| (foreshortened
            # silhouette faces would otherwise get sub-pixel bands that the
            # pixel grid never samples), clamped to stay inside the triangle
            # (<= 0.8 * inradius).  Forward value is unchanged (the correction
            # is self-subtracting), so images stay bit-identical; backward
            # gains the boundary term through the differentiable cast's uv and
            # the gathered vertex positions.  One-sided: occlusion boundaries
            # see L_front - 0 instead of L_front - L_back (documented bias;
            # exact vs background).  Interior (shared) triangle edges carry
            # bands on both sides with opposite-signed de/dtheta that cancel.
            u = hit.uv[..., 0]
            v = hit.uv[..., 1]
            b0 = 1.0 - u - v
            # Per-triangle altitudes/inradius from the stop-gradient band
            # table (see its construction above): gradients flow ONLY
            # through u/v — exactly the boundary velocity term, carried by
            # the cast's analytic uv-VJP.
            rows = band_tbl[hit.wtri]
            h_a = rows[..., 0]
            h_b = rows[..., 1]
            h_c = rows[..., 2]
            r_in = rows[..., 3]
            e_world = jnp.minimum(jnp.minimum(b0 * h_a, u * h_b), v * h_c)
            if pixel_angle is None:
                band = cfg.edge_eps * jnp.minimum(jnp.minimum(h_a, h_b), h_c)
            else:
                # foreshortening from the (faceted) shading normal — the
                # plane normal for box meshes; band width is stop-gradient
                # anyway, so only its value matters
                nd = jnp.abs(jnp.sum(
                    jax.lax.stop_gradient(normal) * st["d"], axis=-1))
                foot = hit.t * pixel_angle / jnp.maximum(nd, 0.05)
                band = jnp.minimum(cfg.edge_px * foot, 0.8 * r_in)
            band = jax.lax.stop_gradient(jnp.maximum(band, 1e-12))
            soft = jnp.clip(e_world / band, 0.0, 1.0)
            vis = jnp.where(
                h_valid, 1.0 + (soft - jax.lax.stop_gradient(soft)), 0.0
            )
        contrib = jnp.where(h_valid[:, None], vis[:, None] * atten_eff * lum, 0.0)

        if not can_spawn:
            return contrib, None

        spawn_ok = h_valid & spawn_mask
        hit_pt = st["o"] + hit.t[:, None] * st["d"]
        reflective = jnp.any(kr > 0.0, axis=-1)
        refractive = jnp.any(kt > 0.0, axis=-1)

        # Static scene facts prune whole child streams: a world with no
        # refractive (or no reflective) material spawns only ONE child per
        # ray, so children stay PIXEL-ALIGNED with their parents — later
        # rounds then accumulate with a plain add instead of a 12-ms scatter
        # and skip compaction entirely (see later_round).  Every fixture
        # world has at most one spawning type; mixed scenes keep the general
        # compacted 2x stream.
        parts = []
        if cfg.any_reflective:
            refl_d = rm.normalize(rm.reflect(st["d"], normal))
            parts.append(dict(
                o=hit_pt, d=refl_d, atten=atten_eff * kr,
                in_obj=st["in_obj"],
                active=spawn_ok & reflective, pixel=st["pixel"],
            ))
        if cfg.any_refractive:
            eta = rmats.eta
            n1 = jnp.where(st["in_obj"], eta, 1.0)
            n2 = jnp.where(st["in_obj"], 1.0, eta)
            refr_d, tir = rm.refract(st["d"], normal, n1, n2)
            refr_d = rm.normalize(refr_d)
            parts.append(dict(
                o=hit_pt, d=refr_d, atten=atten_eff,
                in_obj=~st["in_obj"],
                active=spawn_ok & refractive & ~tir, pixel=st["pixel"],
            ))
        if len(parts) == 1:
            children = parts[0]
        else:
            children = {
                k: jnp.concatenate([p[k] for p in parts]) for k in parts[0]
            }
        return contrib, children

    def compact(children, cap):
        """Sort actives to the front (stable — preserves spatial coherence),
        keep ``cap`` items; returns (state, n_dropped)."""
        order = jnp.argsort(jnp.logical_not(children["active"]), stable=True)
        keep = order[:cap]
        st = {k: v[keep] for k, v in children.items()}
        st["d"] = jnp.where(st["active"][:, None], st["d"],
                            jnp.array([0.0, 0.0, 1.0]))
        dropped = jnp.sum(children["active"]) - jnp.sum(st["active"])
        return st, dropped

    # ---- round 0: primary rays; pixel ids are the identity, so the frame
    # accumulation is a plain add (no scatter on the hot path).
    primary = dict(
        o=ray_o,
        d=ray_d,
        atten=jnp.ones((R, 4), dtype=jnp.float32),
        in_obj=jnp.zeros((R,), dtype=bool),
        active=jnp.ones((R,), dtype=bool),
        pixel=jnp.arange(R, dtype=jnp.int32),
    )
    spawn0 = jnp.asarray(cfg.recurse_depth > 0)
    contrib0, children0 = process_round(primary, spawn0)
    acc = contrib0
    dropped0 = jnp.zeros((), jnp.int32)

    if not can_spawn:
        return acc, dropped0

    # ``child_tile_cap`` > 0 compacts the child queue at TILE granularity
    # instead of the per-lane argsort: children inherit their parent's slot,
    # so child streams keep the parents' 1024-lane tile structure — keeping
    # whole tiles containing any active child costs one tiny tile-count sort
    # plus sorted-unique-hinted gathers, where the per-lane path pays a 2R
    # argsort + 8 full-length row gathers every round.  Same drop accounting; capacity = ceil(T * child_tile_cap)
    # tiles.  This applies to SINGLE-stream (aligned) worlds too: bounce
    # rounds then run on only the tiles that spawned children (e.g.
    # world8_stress's reflective cubes cover a fraction of the frame, so
    # rounds 1+ shrink by ~the compaction ratio) at the cost of one hinted
    # scatter-add per round.
    tile_children = cfg.child_tile_cap > 0.0 and R % TILE_LANES == 0
    if tile_children:
        T0 = R // TILE_LANES
        n_parts = int(bool(cfg.any_reflective)) + int(bool(cfg.any_refractive))
        Ct = min(max(1, int(-(-T0 * cfg.child_tile_cap // 1))),
                 n_parts * T0)

    # Single-stream worlds with no cap keep children pixel-aligned: no
    # compaction, no scatter (the cast parks inactive lanes, so dead tiles
    # stay cheap).
    aligned = (cfg.any_reflective != cfg.any_refractive) and not tile_children

    def compact_tiles(children):
        """Keep the first Ct whole tiles containing any active child
        (tile-granular gather instead of one row per ray)."""
        act = children["active"].reshape(-1, TILE_LANES)
        tile_any = jnp.any(act, axis=-1)
        keep_t = jnp.sort(jnp.argsort(~tile_any, stable=True)[:Ct])

        def take(x):
            xt = x.reshape((-1, TILE_LANES) + x.shape[1:])
            return jnp.take(xt, keep_t, axis=0, unique_indices=True,
                            indices_are_sorted=True, mode='clip'
                            ).reshape((Ct * TILE_LANES,) + x.shape[1:])

        st = {k: take(v) for k, v in children.items()}
        st["d"] = jnp.where(st["active"][:, None], st["d"],
                            jnp.array([0.0, 0.0, 1.0]))
        dropped = jnp.sum(children["active"]) - jnp.sum(st["active"])
        return st, dropped

    if aligned:
        state = dict(children0)
        state["d"] = jnp.where(state["active"][:, None], state["d"],
                               jnp.array([0.0, 0.0, 1.0]))
    elif tile_children:
        state, d0 = compact_tiles(children0)
        dropped0 = dropped0 + d0
    else:
        state, d0 = compact(children0, C)
        dropped0 = dropped0 + d0

    def tile_scatter_add(acc, pixel, contrib):
        """Accumulate kept-tile contributions by WHOLE tiles: compaction
        keeps whole tiles and children inherit parent slots, so each kept
        tile's 1024 pixel ids are one contiguous original tile (mixed
        streams can keep the same original tile twice — scatter-ADD sums
        duplicates)."""
        tid = pixel.reshape(-1, TILE_LANES)[:, 0] // TILE_LANES
        return acc.reshape(-1, TILE_LANES, 4).at[tid].add(
            contrib.reshape(-1, TILE_LANES, 4), mode="drop"
        ).reshape(acc.shape)

    def later_round(r, st, acc, dropped):
        spawn = r < cfg.recurse_depth  # rounds are 1..depth; the last spawns none
        contrib, children = process_round(st, spawn)
        if aligned:
            acc = acc + contrib  # pixel-aligned stream
            st2 = dict(children)
            st2["d"] = jnp.where(st2["active"][:, None], st2["d"],
                                 jnp.array([0.0, 0.0, 1.0]))
            dn = jnp.zeros((), jnp.int32)
        elif tile_children:
            acc = tile_scatter_add(acc, st["pixel"], contrib)
            st2, dn = compact_tiles(children)
        else:
            acc = acc.at[st["pixel"]].add(contrib, mode="drop")
            st2, dn = compact(children, C)
        return st2, acc, dropped + dn

    if cfg.early_exit:
        def cond(carry):
            r, st, acc, dropped = carry
            return (r <= cfg.recurse_depth) & jnp.any(st["active"])

        def body(carry):
            r, st, acc, dropped = carry
            st, acc, dropped = later_round(r, st, acc, dropped)
            return r + 1, st, acc, dropped

        _, state, acc, dropped = jax.lax.while_loop(
            cond, body, (jnp.int32(1), state, acc, dropped0)
        )
    else:
        def body(r, carry):
            st, acc, dropped = carry
            return later_round(r, st, acc, dropped)

        state, acc, dropped = jax.lax.fori_loop(
            1, cfg.recurse_depth + 1, body, (state, acc, dropped0)
        )
    return acc, dropped


def render_rays_stats(scene: Scene, geom: WorldGeometry, cast_fn: CastFn,
                      cfg: RenderConfig, ray_o, ray_d, pixel_angle=None):
    """Radiance for arbitrary ray batches (flattened), clamped like the
    canvas write (raytracer.cc:55-58).  Returns ``(img, dropped)`` — the
    wavefront drop counter is data, not noise: with tile caps set, a camera
    move can push hits past capacity and silently delete radiance unless the
    caller surfaces this (VERDICT r3 weak #6)."""
    acc, dropped = radiance(scene, geom, cast_fn, cfg, ray_o.reshape(-1, 3),
                            ray_d.reshape(-1, 3), pixel_angle=pixel_angle)
    return (jnp.minimum(acc, 1.0).reshape(ray_o.shape[:-1] + (4,)),
            dropped)


def render_rays(scene: Scene, geom: WorldGeometry, cast_fn: CastFn,
                cfg: RenderConfig, ray_o, ray_d, pixel_angle=None):
    """render_rays_stats without the drop counter (compatibility wrapper —
    prefer the stats variant anywhere caps are configured)."""
    img, _ = render_rays_stats(scene, geom, cast_fn, cfg, ray_o, ray_d,
                               pixel_angle=pixel_angle)
    return img


def default_engine() -> str:
    """The cast engine for the default backend: the Pallas-Triton walk on a
    GPU, the XLA casts anywhere else."""
    return "pallas" if jax.default_backend() == "gpu" else "jnp"


def prepare_cast(scene: Scene, geom: WorldGeometry, cfg: RenderConfig):
    """Build the cast's runtime data (kernel scene tables / LBVH) as an
    explicit pytree, hoisted out of per-sample bodies so a
    ``jax.checkpoint``-ed sample render stages closure-free (see
    pallas_engine.prepare_pallas_cast) and the tables are built once per
    frame, not once per spp sample.  Returns None for engines that need no
    preparation."""
    if cfg.engine == "pallas":
        from .pallas_engine import prepare_pallas_cast

        return prepare_pallas_cast(
            jax.lax.stop_gradient(scene), jax.lax.stop_gradient(geom), cfg
        )
    return None


def make_cast(scene: Scene, geom: WorldGeometry, cfg: RenderConfig,
              aux=None) -> CastFn:
    from .cast import make_culled_cast

    if cfg.engine == "pallas":
        # The kernel's tables must NOT be on the autodiff path: derivatives
        # are supplied analytically by the custom_vjp rules (cast_vjp), and
        # differentiable geometry re-enters explicitly through the reparam
        # rule's arguments.  The rules are MODULE-LEVEL and take the
        # prepare_pallas_cast aux pytree as an explicit argument (per-call
        # custom_vjp closures leak tracers under jax.checkpoint; see
        # cast_vjp.py).
        from .cast_vjp import (pack_reparam_geo, pallas_cast_detached,
                               pallas_cast_reparam, pallas_occlude2_detached,
                               pallas_occlude_detached)

        if aux is None:
            from .pallas_engine import prepare_pallas_cast

            aux = prepare_pallas_cast(jax.lax.stop_gradient(scene),
                                      jax.lax.stop_gradient(geom), cfg)
        if cfg.edge_aware_grads:
            # Vertex-gradient configuration: the hinge band consumes hit.uv
            # and gathered vertex positions, so the cast must carry the full
            # analytic (t, uv, normal)-VJP — including cotangents back to
            # the triangle arrays (and through them to scene.verts).  With
            # only the t-rule this combination would silently produce
            # corrupted vertex gradients.
            geo = pack_reparam_geo(geom)

            def wrapped(ro, rd, _aux=aux):
                return pallas_cast_reparam(cfg, ro, rd, _aux, geo)
        else:
            def wrapped(ro, rd, _aux=aux):
                return pallas_cast_detached(cfg, ro, rd, _aux)

        def occlude(ro, rd, max_t, _aux=aux):
            return pallas_occlude_detached(cfg, ro, rd, max_t, _aux)

        wrapped.occlude = occlude

        if cfg.fused_shadows:
            def occlude2(o1, d1, mt1, o2, d2, mt2, _aux=aux):
                return pallas_occlude2_detached(cfg, o1, d1, mt1, o2, d2,
                                                mt2, _aux)

            wrapped.occlude2 = occlude2
        return wrapped
    if cfg.use_bvh:
        return make_culled_cast(
            geom,
            max_candidates=cfg.max_candidates,
            max_tris_per_mesh=cfg.max_tris_per_mesh,
            ray_chunk=cfg.ray_chunk,
        )
    return make_brute_cast(geom, ray_chunk=cfg.ray_chunk)


BLOCK = 32  # screen-space tile edge: one 32x32 block == one 1024-ray cast tile


def _to_blocks(x, hp, wp):
    """[Hp, Wp, ...] -> block-major [Hp*Wp, ...] (cheap transposes, no gathers)."""
    lead = x.shape[2:]
    x = x.reshape(hp // BLOCK, BLOCK, wp // BLOCK, BLOCK, *lead)
    x = jnp.moveaxis(x, 1, 2)
    return x.reshape(hp * wp, *lead)


def _from_blocks(x, hp, wp):
    lead = x.shape[1:]
    x = x.reshape(hp // BLOCK, wp // BLOCK, BLOCK, BLOCK, *lead)
    x = jnp.moveaxis(x, 2, 1)
    return x.reshape(hp, wp, *lead)


def spp_jitter_grid(spp: int, width: int, height: int):
    """Sub-pixel sample pattern for spp > 1 renders.

    Returns ``(offs [spp, 2], shift [H, W, 2])``: per-sample R2
    low-discrepancy offsets, decorrelated across pixels with a per-pixel
    toroidal shift (without the shift, every pixel samples the SAME sub-pixel
    positions, so a straight silhouette edge aliases with the whole pixel grid
    at once — fatal for edge-aware gradients).  The per-sample jitter is
    ``(offs[s] + shift) % 1`` — shared by render_frame and the sharded render
    paths (dist.py) so their spp>1 images agree."""
    g = 1.32471795724474602596  # plastic constant
    a1, a2 = 1.0 / g, 1.0 / (g * g)
    s = jnp.arange(spp, dtype=jnp.float32)
    offs = jnp.stack([(0.5 + a1 * s) % 1.0, (0.5 + a2 * s) % 1.0], -1)
    xx = jnp.arange(width, dtype=jnp.float32)[None, :]
    yy = jnp.arange(height, dtype=jnp.float32)[:, None]
    shift = jnp.stack(
        [jnp.broadcast_to((a1 * xx + a2 * yy) % 1.0, (height, width)),
         jnp.broadcast_to((a2 * xx + a1 * yy) % 1.0, (height, width))], -1)
    return offs, shift


def _sample_frame(scene, geom, aux, camera, cfg, off, shift, lane=None):
    """One jittered sub-pixel sample frame.  EVERY traced value enters as an
    explicit argument (scene, geom, cast aux tables, camera, the [2] sample
    offset, the kept-tile lane set) and the cast is bound inside — this is
    what lets ``jax.checkpoint`` stage the body: a closed-over tracer
    becomes a jaxpr constant the while-loop lowering cannot materialize
    ("No constant handler for DynamicJaxprTracer").  ``shift``/``cfg`` are concrete/static."""
    if lane is not None:
        # the static kept-tile set already holds only occupied tiles; a
        # per-sample wavefront/child cap would re-apply its FULL-FRAME
        # fraction to the compacted queue and starve it (counted drops)
        cfg = cfg.replace(wavefront_tile_cap=0.0, child_tile_cap=0.0)
    cast_fn = make_cast(scene, geom, cfg, aux=aux)
    jitter = None if off is None else (off + shift) % 1.0
    return _render_one_stats(scene, geom, cast_fn, camera, cfg, jitter,
                             lane=lane)


def _scan_samples(scene, geom, aux, camera, cfg, offs, shift,
                  remat: bool = True, lane=None):
    """SUM of sample frames over the offset batch ``offs [k, 2]`` as ONE
    lax.scan (one compiled body regardless of k).

    ``remat=True`` checkpoints each sample: reverse mode then recomputes a
    sample's forward instead of storing its full wavefront residuals, making
    backward memory O(1) in spp (64 spp x 1080p otherwise blows HBM).  The
    per-step saved residuals are the [2] offset plus the named
    shadow-occlusion booleans."""

    def sample(scene_, geom_, aux_, camera_, off, lane_):
        return _sample_frame(scene_, geom_, aux_, camera_, cfg, off, shift,
                             lane=lane_)

    if remat:
        # Save the named shadow-occlusion booleans (1 byte/ray/query) so the
        # backward recompute skips the any-hit BVH walks — the most expensive
        # recomputed values with the smallest storage footprint.  Everything
        # else (casts, shading) is recomputed as usual.
        sample = jax.checkpoint(
            sample,
            policy=jax.checkpoint_policies.save_only_these_names(
                "shadow_occl"),
        )

    def body(carry, off):
        acc, drops = carry
        img, d = sample(scene, geom, aux, camera, off, lane)
        return (acc + img, drops + d), None

    (acc, drops), _ = jax.lax.scan(
        body,
        (jnp.zeros((cfg.height, cfg.width, 4), jnp.float32),
         jnp.zeros((), jnp.int32)),
        offs,
    )
    return acc, drops


def _spp_lane(scene, geom, aux, camera, cfg):
    """Kept-tile lane set for the spp sweep (None when disabled)."""
    if cfg.static_tile_cap <= 0.0:
        return None, jnp.zeros((), jnp.int32)
    cast_fn = make_cast(scene, geom, cfg, aux=aux)
    return _static_tile_lanes(scene, geom, cast_fn, camera, cfg)


def render_frame_with_stats(scene: Scene, camera: Camera, cfg: RenderConfig):
    """Like ``render_frame`` but also returns render statistics:
    ``{"dropped": i32}`` — wavefront/child-queue drops plus kept-tile-probe
    drops summed over all spp samples.  Nonzero means radiance was DELETED
    by a too-small tile cap (raise the cap or use auto_tile_caps); surface
    it, don't swallow it (VERDICT r3 weak #6)."""
    geom = expand_geometry(scene)

    if cfg.spp > 1:
        # Average spp jittered sub-pixel sample frames scanned in one body;
        # per-sample rematerialization keeps reverse-mode memory O(1) in spp.
        # (spp=1 renders the reference's exact integer pixel corners.)
        offs, shift = spp_jitter_grid(cfg.spp, cfg.width, cfg.height)
        aux = prepare_cast(scene, geom, cfg)
        lane, probe_drops = _spp_lane(scene, geom, aux, camera, cfg)
        acc, drops = _scan_samples(scene, geom, aux, camera, cfg, offs,
                                   shift, lane=lane)
        return acc / cfg.spp, {"dropped": drops + cfg.spp * probe_drops}
    cast_fn = make_cast(scene, geom, cfg)
    img, drops = _render_one_stats(scene, geom, cast_fn, camera, cfg, None)
    return img, {"dropped": drops}


def render_frame(scene: Scene, camera: Camera, cfg: RenderConfig):
    """Render one RGBA float frame [H, W, 4] (values clamped to <= 1 like the
    reference's canvas write).  Pure function of its inputs — jit/grad/shard
    friendly.

    Rays are reordered into 32x32 screen blocks before casting so each cast
    tile covers a tight frustum (the tile-vote and candidate cull depend on
    ray coherence); the reordering is pure reshape/transpose and is undone on
    the accumulated frame."""
    img, _ = render_frame_with_stats(scene, camera, cfg)
    return img


def render_frame_sum(scene: Scene, camera: Camera, cfg: RenderConfig, offs,
                     remat: bool = True, with_stats: bool = False):
    """SUM of jittered sample frames for an explicit offset batch [k, 2].

    The microbatch building block for spp gradient accumulation
    (diff.make_spp_grad_fn scans vjp chunks of this over the full jitter
    grid).  ``render_frame(cfg.spp=n)`` ==
    ``sum(render_frame_sum over spp_jitter_grid chunks) / n`` exactly —
    same per-sample clamp, same per-pixel decorrelation shift.

    ``remat=False`` skips the per-sample jax.checkpoint (callers that bound
    backward memory by the chunk size instead).

    ``with_stats=True`` also returns ``{"dropped": i32}`` — wavefront/child
    drops over the batch plus kept-tile-probe drops (counted once per
    sample, like render_frame_with_stats).  Nonzero means the static tile
    cap deleted radiance INSIDE the gradient path — training loops must
    surface it, not swallow it (ADVICE r4 medium)."""
    geom = expand_geometry(scene)
    aux = prepare_cast(scene, geom, cfg)
    _, shift = spp_jitter_grid(2, cfg.width, cfg.height)
    lane, probe_drops = _spp_lane(scene, geom, aux, camera, cfg)
    acc, drops = _scan_samples(scene, geom, aux, camera, cfg, offs, shift,
                               remat=remat, lane=lane)
    if with_stats:
        k = offs.shape[0]
        return acc, {"dropped": drops + k * probe_drops}
    return acc


def _frame_rays_blocked(camera, cfg, jitter):
    """Full-frame camera rays in block-major [R, 3] layout (padded)."""
    ray_o, ray_d = camera_rays(camera, cfg.width, cfg.height, jitter=jitter)

    hp = (cfg.height + BLOCK - 1) // BLOCK * BLOCK
    wp = (cfg.width + BLOCK - 1) // BLOCK * BLOCK
    pad_h = hp - cfg.height
    pad_w = wp - cfg.width
    # pad pixels keep origin 0 — the jnp oracle cast differentiates through
    # its rays and a 1e30 origin NaN-poisons its reverse pass; the pad here
    # is at most one tile row, so ghost-traversal cost is negligible
    ray_o = jnp.pad(ray_o, ((0, pad_h), (0, pad_w), (0, 0)))
    ray_d = jnp.pad(ray_d, ((0, pad_h), (0, pad_w), (0, 0)),
                    constant_values=0.0)
    if pad_h or pad_w:
        yy = jnp.arange(hp)[:, None]
        xx = jnp.arange(wp)[None, :]
        pad_mask = (yy >= cfg.height) | (xx >= cfg.width)
        ray_d = jnp.where(pad_mask[..., None], jnp.array([0.0, 0.0, 1.0]), ray_d)

    return _to_blocks(ray_o, hp, wp), _to_blocks(ray_d, hp, wp), hp, wp


def _probe_tile_occupancy(cast_fn, camera, cfg, scene=None, geom=None):
    """Per-tile occupancy of the center-jitter frame (stop-gradient probe).

    Returns ``(occ [T] bool, dil [T] bool, hits_t [T] i32, spawn [T] bool)``:
    tiles with any hit, their 3x3 screen-space dilation, per-tile hit
    counts, and — when ``scene``/``geom`` are given — tiles with any
    SPAWN-CAPABLE hit (reflective/refractive material: the only lanes that
    feed bounce-child queues, material.h:104-112)."""
    ro_b, rd_b, hp, wp = _frame_rays_blocked(
        camera, cfg, jnp.full((cfg.height, cfg.width, 2), 0.5)
    )
    pre = cast_fn(jax.lax.stop_gradient(ro_b), jax.lax.stop_gradient(rd_b))
    th = hp // BLOCK
    tw = wp // BLOCK
    occ = jnp.any(pre.valid.reshape(th * tw, TILE_LANES), axis=-1)
    hits_t = jnp.sum(pre.valid.reshape(th * tw, TILE_LANES), axis=-1)
    occ2 = occ.reshape(th, tw)
    # one-ring dilation: max over the 3x3 neighborhood
    p = jnp.pad(occ2, 1)
    dil = jnp.zeros_like(occ2)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            dil = dil | p[1 + dy: 1 + dy + th, 1 + dx: 1 + dx + tw]
    spawn = None
    if scene is not None:
        mat = pre.mat
        if mat is None and geom is not None:
            mat = geom.mat[pre.wtri]
        if mat is not None:
            spawnable = (jnp.any(scene.materials.kr > 0.0, axis=-1)
                         | jnp.any(scene.materials.kt > 0.0, axis=-1))
            lane_spawn = pre.valid & spawnable[mat]
            spawn = jnp.any(lane_spawn.reshape(th * tw, TILE_LANES), axis=-1)
    return occ, dil.reshape(-1), hits_t, spawn


def auto_tile_caps(scene, camera, cfg, margin: float = 2.0) -> dict:
    """Probe-derived tile caps replacing hand tuning (the reference's analog
    is the user-swept ``-d`` knob, src/main.cc:38; VERDICT r3 weak #7).

    One center-jitter probe render measures the occupied-tile fraction;
    returns cfg overrides:

    * ``wavefront_tile_cap`` — all-hit occupied fraction x ``margin``
      (headroom for camera motion).
    * ``child_tile_cap`` — SPAWN-CAPABLE occupied fraction x ``margin``:
      children only come from reflective/refractive hits and inherit their
      parents' tiles, so spawnable-hit occupancy (per child stream) bounds
      the child queue — all-hit occupancy would size it off the diffuse
      floor and disable the compaction exactly where it pays.
    * ``static_tile_cap`` — DILATED occupancy x 1.1 (the spp sweep's kept
      set; the one-ring dilation already absorbs sub-pixel motion).

    A cap of 0.0 disables the corresponding compaction (occupancy too high
    to pay).  Host-level helper: call once at setup and fold into the
    RenderConfig; any residual drops are counted and surfaced by
    render_frame_with_stats."""
    cfg1 = cfg.replace(spp=1, static_tile_cap=0.0, wavefront_tile_cap=0.0,
                       child_tile_cap=0.0)

    @jax.jit
    def probe():
        # geometry expansion + cast-table build live INSIDE the jit: eager
        # jnp prep would cost ~100 small dispatches
        geom = expand_geometry(scene)
        cast_fn = make_cast(scene, geom, cfg1)
        occ, dil, _, spawn = _probe_tile_occupancy(cast_fn, camera, cfg1,
                                                   scene=scene, geom=geom)
        n_spawn = jnp.sum(occ) if spawn is None else jnp.sum(spawn)
        return jnp.sum(occ), jnp.sum(dil), n_spawn

    n_occ, n_dil, n_spawn = probe()
    hp = (cfg.height + BLOCK - 1) // BLOCK * BLOCK
    wp = (cfg.width + BLOCK - 1) // BLOCK * BLOCK
    T = (hp // BLOCK) * (wp // BLOCK)

    def cap(frac, off_at=0.85):
        return 0.0 if frac >= off_at else max(frac, 1.0 / T)

    # The per-sample wavefront pre-cast costs one full visibility cast; it
    # only pays at strong sparsity (world1's lone-cube frames), so it turns
    # off above 40% kept — where the child-queue compaction (which costs
    # only a tile-count sort per round) takes over.
    wf = cap(float(n_occ) / T * margin, off_at=0.4)
    # child_tile_cap is a fraction of the queue the bounce rounds ACTUALLY
    # run on: with wavefront compaction active that queue is already just
    # the kept hit tiles, so a full-frame spawn fraction would starve it
    # (ceil(Ct_kept x frac) tiles) — and child compaction buys nothing on
    # top of the kept set anyway.  Only when the frame stays dense does the
    # spawn-occupancy fraction size the child queue.
    child = 0.0 if wf > 0.0 else cap(float(n_spawn) / T * margin)
    return {
        "wavefront_tile_cap": wf,
        "child_tile_cap": child,
        "static_tile_cap": cap(float(n_dil) / T * 1.1),
    }


def auto_static_tile_cap(scene, camera, cfg, margin: float = 1.1) -> float:
    """``auto_tile_caps`` restricted to the spp sweep's kept-tile cap."""
    del margin  # folded into auto_tile_caps' static rule
    return auto_tile_caps(scene, camera, cfg)["static_tile_cap"]


def _static_tile_lanes(scene, geom, cast_fn, camera, cfg):
    """Probe the center-jitter frame ONCE and pick the kept-tile set for the
    whole spp sweep (``cfg.static_tile_cap``).

    Occupancy is the per-tile any-hit of a stop-gradient cast, DILATED by one
    tile ring (3x3 max) in screen space: subpixel jitter moves silhouettes
    < 1 px << the 32-px tile edge, so every sample's hits stay inside the
    kept set.  Returns ``(keep_t [Ct] i32 sorted, dropped)`` where
    ``dropped`` counts probe hits in occupied tiles beyond the cap (0 unless
    the cap is set too small — surface it, don't swallow it)."""
    occ, dil, hits_t, _ = _probe_tile_occupancy(cast_fn, camera, cfg)
    T = occ.shape[0]
    Ct = min(max(1, int(-(-T * cfg.static_tile_cap // 1))), T)
    # Occupied tiles outrank dilation-ring tiles: if the cap binds, drop ring
    # tiles (possible sub-pixel silhouette motion) before tiles with actual
    # probe hits (certain radiance).
    prio = occ.astype(jnp.int32) * 2 + dil.astype(jnp.int32)
    keep_t = jnp.sort(jnp.argsort(-prio, stable=True)[:Ct])
    kept = jnp.zeros((T,), bool).at[keep_t].set(True)
    dropped = jnp.sum(hits_t) - jnp.sum(jnp.where(kept, hits_t, 0))
    return keep_t, dropped.astype(jnp.int32)


def _render_one_stats(scene, geom, cast_fn, camera, cfg, jitter, lane=None):
    """One sample frame; returns ``(img, dropped)``."""
    ro_b, rd_b, hp, wp = _frame_rays_blocked(camera, cfg, jitter)
    # Angular size of one pixel at the image center (camera.cu:33-42 maps one
    # pixel step to 1/unit_to_pixels on the near plane at depth global_near).
    pixel_angle = None
    if cfg.edge_aware_grads:
        pixel_angle = jax.lax.stop_gradient(
            1.0 / (camera.unit_to_pixels * camera.global_near)
        )
    if lane is not None:
        # Static kept-tile compaction: render only the probe-selected tiles;
        # excluded tiles hold no hits and therefore render to exactly 0.
        # Gather/scatter run at TILE granularity — whole 1024-lane rows —
        # so a ~600-row scatter of 16 KB rows replaces a per-ray scatter.
        T = ro_b.shape[0] // TILE_LANES
        keep_t = lane

        def take(x):
            xt = x.reshape(T, TILE_LANES, x.shape[-1])
            return jnp.take(
                xt, keep_t, axis=0, unique_indices=True,
                indices_are_sorted=True, mode='clip',
            ).reshape(-1, x.shape[-1])

        img_c, dropped = render_rays_stats(
            scene, geom, cast_fn, cfg, take(ro_b), take(rd_b),
            pixel_angle=pixel_angle)
        img_b = jnp.zeros((T, TILE_LANES, 4), img_c.dtype).at[keep_t].set(
            img_c.reshape(-1, TILE_LANES, 4), unique_indices=True,
            indices_are_sorted=True, mode='drop',
        ).reshape(hp * wp, 4)
    else:
        img_b, dropped = render_rays_stats(scene, geom, cast_fn, cfg, ro_b,
                                           rd_b, pixel_angle=pixel_angle)
    img = _from_blocks(img_b, hp, wp)
    return img[: cfg.height, : cfg.width], dropped.astype(jnp.int32)


def frame_to_u8(img) -> "jnp.ndarray":
    """Float RGBA -> RGBA8 with the reference's cast semantics: ``(u8)(255 * c)``
    truncation, no rounding (rayenv/color.h:38-46)."""
    return (jnp.clip(img, 0.0, 1.0) * 255.0).astype(jnp.uint8)
