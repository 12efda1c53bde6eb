"""Distribution layer: device meshes, ray/tile sharding, and multi-host setup.

The reference is single-GPU with no distribution (SURVEY.md §2.3); this module is
the designed-fresh multi-device equivalent.  The parallel decomposition follows the
renderer's natural axes:

* **rays/tiles (data parallel)** — the image's ray array is sharded over all
  chips via ``NamedSharding``; rendering is embarrassingly parallel over rays, so
  XLA inserts no communication in the forward pass.
* **scene (replicated)** — geometry/BVH/materials are small (≤ a few MB for the
  fixture worlds) and fully replicated; partitioning geometry with ray all-to-all
  is the documented scale-out path if scenes outgrow device memory (SURVEY.md §5).
* **gradients (psum)** — parameter gradients from sharded ray batches are
  all-reduced over the mesh (see diff.render_loss_and_grad / dryrun_multichip).

Multi-host: call ``initialize_distributed()`` once per process (standard
``jax.distributed.initialize``), then ``make_mesh()`` builds a global mesh over
all devices; the runtime handles the links within a host (NVLink) and across hosts.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

RAY_AXIS = "rays"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Multi-host bring-up (no-op on a single process)."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_mesh(devices: Optional[Sequence] = None, axis: str = RAY_AXIS) -> Mesh:
    devices = list(devices) if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def replicated(mesh: Mesh):
    return NamedSharding(mesh, P())


def ray_sharded(mesh: Mesh):
    return NamedSharding(mesh, P(RAY_AXIS))


def shard_scene(scene, mesh: Mesh):
    """Replicate the scene pytree on every device of the mesh."""
    sharding = replicated(mesh)
    return jax.tree_util.tree_map(lambda x: jax.device_put(jnp.asarray(x), sharding), scene)


def pad_to_multiple(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def make_sharded_render(scene, camera, cfg, mesh: Mesh,
                        balance: str = "contiguous"):
    """Return a jitted render over the mesh: rows of the image are sharded across
    chips, the scene is replicated, and the output image is row-sharded.

    The height need not divide the mesh size: the RAY GRID is padded with
    dummy rows up to the next multiple (the camera mapping itself is computed
    at the true height, so framing is unchanged) and the padded rows are
    cropped off the result.

    ``balance="cyclic"`` over-decomposes the screen into row bands assigned
    round-robin across devices (band b -> device b mod D) instead of one
    contiguous stripe per device: scenes whose expensive pixels cluster in one
    region (terrain at the frame's bottom, reflective pools) then spread their
    work evenly — the tile-over-decomposition load-balancing strategy of
    SURVEY.md §2.3 row 2.  The permutation and its inverse are static
    row gathers; results are bit-identical to contiguous sharding."""
    from .render.engine import make_cast, render_rays
    from .render.geometry import camera_rays, expand_geometry

    n_dev = mesh.devices.size
    band = 8  # rows per band; small enough to split hotspot regions finely
    hp = pad_to_multiple(cfg.height, n_dev * band)
    scene_r = shard_scene(scene, mesh)
    camera_r = jax.tree_util.tree_map(
        lambda x: jax.device_put(jnp.asarray(x), replicated(mesh)), camera
    )

    perm = None
    if balance == "cyclic":
        n_bands = hp // band
        order = np.arange(n_bands).reshape(-1, n_dev).T.reshape(-1)
        perm = (order[:, None] * band + np.arange(band)[None, :]).reshape(-1)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(hp)
        perm = jnp.asarray(perm)
        inv = jnp.asarray(inv)

    out_sharding = NamedSharding(mesh, P(RAY_AXIS, None, None))

    @partial(jax.jit, static_argnames=("cfg_",), out_shardings=out_sharding)
    def run(scene_, camera_, cfg_):
        geom = expand_geometry(scene_)
        cast = make_cast(scene_, geom, cfg_)

        def one(jitter):
            ro, rd = camera_rays(camera_, cfg_.width, cfg_.height,
                                 jitter=jitter)
            pad = hp - cfg_.height
            ro = jnp.pad(ro, ((0, pad), (0, 0), (0, 0)))
            rd = jnp.pad(rd, ((0, pad), (0, 0), (0, 0)), constant_values=0.0)
            if pad:
                mask = jnp.arange(hp) >= cfg_.height
                rd = jnp.where(mask[:, None, None],
                               jnp.array([0.0, 0.0, 1.0]), rd)
            if perm is not None:
                ro, rd = ro[perm], rd[perm]
            img = render_rays(scene_, geom, cast, cfg_, ro, rd)
            if perm is not None:
                img = img[inv]
            return img

        if cfg_.spp > 1:
            # Same jitter sweep as render_frame (engine.spp_jitter_grid), so
            # the sharded spp>1 image matches the single-device render.
            from .render.engine import spp_jitter_grid

            offs, shift = spp_jitter_grid(cfg_.spp, cfg_.width, cfg_.height)
            acc, _ = jax.lax.scan(
                jax.checkpoint(  # O(1) memory in spp under reverse mode
                    lambda a, off: (a + one((off + shift) % 1.0), None)
                ),
                jnp.zeros((hp, cfg_.width, 4), jnp.float32), offs,
            )
            return acc / cfg_.spp
        return one(None)

    return lambda: run(scene_r, camera_r, cfg)[: cfg.height]


# ---------------------------------------------------------------------------
# Geometry partitioning ("tensor parallel" over instances)
# ---------------------------------------------------------------------------
#
# For scenes that outgrow one chip's memory (or instance budget), instances
# are partitioned into contiguous shards over a second mesh axis.  Each device
# casts rays against ONLY its geometry shard (its own LBVH / candidate
# tables), then the per-shard closest hits are merged with one all_gather +
# argmin over the geom axis; occlusion queries reduce with a psum-OR.  Rays
# stay resident per device (the stationary-queries / partitioned-scene layout
# — the ray-tracing analog of megatron-style sharding, designed fresh per
# SURVEY.md §2.3 row 3).

GEOM_AXIS = "geom"


def make_mesh2d(n_ray: int, n_geom: int, devices: Optional[Sequence] = None
                ) -> Mesh:
    """A (rays x geom) mesh over the first n_ray*n_geom devices."""
    devices = list(devices) if devices is not None else jax.devices()
    devices = np.asarray(devices[: n_ray * n_geom]).reshape(n_ray, n_geom)
    return Mesh(devices, (RAY_AXIS, GEOM_AXIS))


def split_scene_by_instances(scene, n_shards: int):
    """Host-side partition of a Scene's instances into ``n_shards`` contiguous
    chunks, padded to equal size (pad instances sit at 1e30 so they can never
    be hit).  Returns a pytree of stacked per-shard arrays with leading axis
    ``n_shards`` — feed through shard_map with in_spec P(GEOM_AXIS).

    Per-shard leaves: inst_pos/rot/mesh [S, Np, ...], wtri_inst (LOCAL ids) /
    wtri_tri [S, Wp], wtri_base [S] (global world-tri offset of the shard)."""
    import numpy as onp

    n = int(onp.asarray(scene.inst_pos).shape[0])
    per = pad_to_multiple(n, n_shards) // n_shards + 1  # +1: dedicated pad
    #   instance at index per-1 of every shard (always present, parked at
    #   1e30) so padded world-tri rows never alias real geometry

    inst_pos = onp.asarray(scene.inst_pos)
    inst_rot = onp.asarray(scene.inst_rot)
    inst_mesh = onp.asarray(scene.inst_mesh)
    wtri_inst = onp.asarray(scene.wtri_inst)
    wtri_tri = onp.asarray(scene.wtri_tri)

    pos_s, rot_s, mesh_s = [], [], []
    winst_s, wtri_s, wbase_s = [], [], []
    # world tris are contiguous per instance (expand_geometry layout)
    inst_starts = onp.searchsorted(wtri_inst, onp.arange(n))
    inst_ends = onp.searchsorted(wtri_inst, onp.arange(n), side="right")
    w_max = 0
    chunks = []
    for s in range(n_shards):
        lo = min(s * (per - 1), n)
        hi = min(lo + per - 1, n)
        w_lo = int(inst_starts[lo]) if lo < n else len(wtri_inst)
        w_hi = int(inst_starts[hi]) if hi < n else len(wtri_inst)
        chunks.append((lo, hi, w_lo, w_hi))
        w_max = max(w_max, w_hi - w_lo)

    for lo, hi, w_lo, w_hi in chunks:
        k = hi - lo
        assert k < per  # index per-1 is reserved for the pad instance
        p = onp.full((per, 3), 1.0e30, onp.float32)
        r = onp.tile(onp.array([0, 0, 0, 1], onp.float32), (per, 1))
        m = onp.zeros((per,), onp.int32)
        p[:k] = inst_pos[lo:hi]
        r[:k] = inst_rot[lo:hi]
        m[:k] = inst_mesh[lo:hi]
        wi = onp.full((w_max,), per - 1, onp.int32)  # pad rows -> pad instance
        wt = onp.zeros((w_max,), onp.int32)
        wi[: w_hi - w_lo] = wtri_inst[w_lo:w_hi] - lo  # LOCAL instance ids
        wt[: w_hi - w_lo] = wtri_tri[w_lo:w_hi]
        pos_s.append(p)
        rot_s.append(r)
        mesh_s.append(m)
        winst_s.append(wi)
        wtri_s.append(wt)
        wbase_s.append(w_lo)

    stack = lambda xs: jnp.asarray(onp.stack(xs))
    return {
        "inst_pos": stack(pos_s),
        "inst_rot": stack(rot_s),
        "inst_mesh": stack(mesh_s),
        "wtri_inst": stack(winst_s),
        "wtri_tri": stack(wtri_s),
        "wtri_base": jnp.asarray(onp.asarray(wbase_s, onp.int32)),
    }


def _local_scene(scene, shard):
    """Rebuild a Scene whose instance tables are one geometry shard."""
    import dataclasses

    return dataclasses.replace(
        scene,
        inst_pos=shard["inst_pos"],
        inst_rot=shard["inst_rot"],
        inst_mesh=shard["inst_mesh"],
        wtri_inst=shard["wtri_inst"],
        wtri_tri=shard["wtri_tri"],
    )


def make_geom_sharded_cast(scene, cfg, shard):
    """Build the per-shard cast + hit-merge collective (call inside shard_map
    over a mesh with GEOM_AXIS).  Returns a CastFn with ``.occlude`` whose
    results equal a single-device cast of the full scene."""
    from .render.cast import Hit
    from .render.engine import make_cast
    from .render.geometry import expand_geometry

    local = _local_scene(scene, shard)
    geom = expand_geometry(local)
    inner = make_cast(local, geom, cfg)
    wtri_base = shard["wtri_base"]

    def cast(o, d):
        h = inner(o, d)
        has_attrs = h.normal is not None and h.mat is not None
        fields = (
            h.valid, jnp.where(h.valid, h.t, jnp.inf),
            h.wtri + wtri_base, h.uv,
            h.normal if has_attrs else jnp.zeros_like(o),
            h.mat if has_attrs else jnp.zeros(o.shape[:-1], jnp.int32),
        )
        g = jax.lax.all_gather(fields, GEOM_AXIS)  # leading axis = shards
        valid, t, wtri, uv, normal, mat = g
        arg = jnp.argmin(t, axis=0)

        def pick(x):
            idx = arg.reshape((1,) + arg.shape + (1,) * (x.ndim - 1 - arg.ndim))
            return jnp.take_along_axis(x, idx, axis=0)[0]

        best_t = pick(t)
        return Hit(
            valid=jnp.isfinite(best_t),
            t=best_t,
            wtri=pick(wtri),
            uv=pick(uv),
            normal=pick(normal) if has_attrs else None,
            mat=pick(mat) if has_attrs else None,
        )

    occ = getattr(inner, "occlude", None)
    if occ is not None:
        def occlude(o, d, max_t):
            blk = occ(o, d, max_t)
            return jax.lax.psum(blk.astype(jnp.int32), GEOM_AXIS) > 0

        cast.occlude = occlude
    return cast


def geom_sharded_render_rays(scene, cfg, shard, ro_b, rd_b,
                             pixel_angle=None):
    """Shading over the geometry-sharded merged cast — call inside shard_map
    over a mesh with GEOM_AXIS.

    The CAST runs against the device's LOCAL geometry shard (merged with one
    all_gather+argmin); SHADING runs against the FULL (replicated) geometry,
    because merged hits carry GLOBAL wtri ids — the edge-aware band's
    ``band_tbl[hit.wtri]`` and any attribute gathers index the full tables
    (small: per-world-triangle rows, KBs for the fixture worlds, vs the
    instance tables/BVH the sharding actually partitions).

    Fully differentiable: the merged pick is a gather whose backward routes
    each hit's cotangents through the all_gather transpose to the OWNING
    shard's cast, whose analytic VJP (reparam under edge_aware) scatters
    vertex cotangents into its local triangle rows — and expand_geometry's
    backward folds those into the SHARED ``scene.verts``, which the caller
    psums over the mesh (VERDICT r3 next #4)."""
    from .render.engine import render_rays_stats
    from .render.geometry import expand_geometry

    cast = make_geom_sharded_cast(scene, cfg, shard)
    geom_full = expand_geometry(scene)
    img, _ = render_rays_stats(scene, geom_full, cast, cfg, ro_b, rd_b,
                               pixel_angle=pixel_angle)
    return img


def make_geom_sharded_render(scene, camera, cfg, mesh: Mesh):
    """Render with BOTH ray rows and scene instances partitioned over a 2-D
    (rays x geom) mesh: each device casts its ray block against its geometry
    shard; per-shard hits merge with one all_gather+argmin on the geom
    axis, shading runs on the merged hits against the replicated small
    per-triangle tables (geom_sharded_render_rays).

    Requires the Pallas engine (the merged Hit must carry normal+material;
    the jnp oracle's candidate cull would re-derive them from full
    geometry)."""
    assert cfg.engine == "pallas", "geometry sharding needs the Pallas cast"
    from .render.geometry import camera_rays

    n_geom = mesh.shape[GEOM_AXIS]
    n_ray = mesh.shape[RAY_AXIS]
    shards = split_scene_by_instances(scene, n_geom)
    scene_r = shard_scene(scene, mesh)
    hp = pad_to_multiple(cfg.height, n_ray)

    @partial(jax.jit, static_argnames=("cfg_",))
    def run(scene_, shards_, cfg_):
        ro, rd = camera_rays(
            jax.tree_util.tree_map(jnp.asarray, camera), cfg_.width,
            cfg_.height,
        )
        pad = hp - cfg_.height
        ro = jnp.pad(ro, ((0, pad), (0, 0), (0, 0)))
        rd = jnp.pad(rd, ((0, pad), (0, 0), (0, 0)), constant_values=0.0)
        if pad:
            mask = jnp.arange(hp) >= cfg_.height
            rd = jnp.where(mask[:, None, None], jnp.array([0.0, 0.0, 1.0]),
                           rd)

        def body(shard, ro_b, rd_b):
            # P(GEOM_AXIS) splits the stacked shard arrays to a size-1
            # leading axis per device; drop it.
            shard = jax.tree_util.tree_map(lambda x: x[0], shard)
            return geom_sharded_render_rays(scene_, cfg_, shard, ro_b, rd_b)

        return jax.shard_map(
            body, mesh=mesh,
            in_specs=(P(GEOM_AXIS), P(RAY_AXIS), P(RAY_AXIS)),
            out_specs=P(RAY_AXIS, None, None),
            check_vma=False,
        )(shards_, ro, rd)

    return lambda: run(scene_r, shards, cfg)[: cfg.height]


def make_ring_geom_cast(scene, cfg, shard):
    """Ring-streaming variant of geometry partitioning: instead of gathering
    per-shard hits, the GEOMETRY SHARD rotates around the geom-axis ring
    (ppermute) while rays stay resident; each of the G steps casts against the
    visiting shard and folds the closest hit.  Communication per step is one
    instance-table shard (~KB) instead of per-ray hit payloads — the
    ray-tracing analog of ring attention (stationary queries, rotating KV;
    SURVEY.md §5 long-context requirement).  Call inside shard_map over a
    mesh with GEOM_AXIS."""
    import dataclasses

    from .render.cast import Hit
    from .render.engine import make_cast
    from .render.geometry import expand_geometry

    axis_size = jax.lax.axis_size(GEOM_AXIS)
    perm = [(i, (i + 1) % axis_size) for i in range(axis_size)]

    def cast(o, d):
        def fold(best, sh):
            local = _local_scene(scene, sh)
            geom = expand_geometry(local)
            h = make_cast(local, geom, cfg)(o, d)
            t = jnp.where(h.valid, h.t, jnp.inf)
            better = t < best[0]
            has_attrs = h.normal is not None and h.mat is not None
            return (
                jnp.where(better, t, best[0]),
                jnp.where(better, h.wtri + sh["wtri_base"], best[1]),
                jnp.where(better[..., None], h.uv, best[2]),
                jnp.where(better[..., None],
                          h.normal if has_attrs else 0.0, best[3]),
                jnp.where(better, h.mat if has_attrs else 0, best[4]),
            )

        best = (
            jnp.full(o.shape[:-1], jnp.inf, jnp.float32),
            jnp.zeros(o.shape[:-1], jnp.int32),
            jnp.zeros(o.shape[:-1] + (2,), jnp.float32),
            jnp.zeros_like(o),
            jnp.zeros(o.shape[:-1], jnp.int32),
        )

        def body(i, carry):
            best, sh = carry
            best = fold(best, sh)
            sh = jax.tree_util.tree_map(
                lambda x: jax.lax.ppermute(x, GEOM_AXIS, perm), sh
            )
            return best, sh

        best, _ = jax.lax.fori_loop(0, axis_size, body, (best, shard))
        t, wtri, uv, normal, mat = best
        valid = jnp.isfinite(t)
        has_attrs = cfg.engine == "pallas"  # Pallas casts emit normal+mat
        return Hit(valid=valid, t=t, wtri=wtri, uv=uv,
                   normal=normal if has_attrs else None,
                   mat=mat if has_attrs else None)

    return cast
