"""Scene data model: a pytree of flat SoA arrays.

This is the array-native replacement for the reference's object-graph scene
(``renv::gpu::Scene`` with device-heap ``Hitable*``/``Light*`` vtables,
reference: include/rayenv/gpu/scene.h:32-110, src/scene_builder.cu:83-179).
The reference already flattens meshes to SoA arrays before building device
objects (src/scene_builder.cu:87-123); here the flat arrays *are* the scene,
and rendering is a pure function of this pytree — which is what makes the
whole pipeline jit-able, differentiable, and shardable.

Conventions
-----------
* Quaternions are stored ``[x, y, z, w]`` (the reference's ``(i, j, k, r)``,
  include/raymath/geometry.h:99-116).
* Entity frames follow the reference convention (src/rayprimitives/entity.cu:5-23):
  ``to_local(v) = rot(q, v - p)`` and ``from_local(v) = rot(q^-1, v) + p``;
  i.e. the stored quaternion maps *global to local*.
* Instances ("Transformations", include/rayenv/transformation.h:13-23) reference a
  mesh by index; a mesh is itself an entity (``Trimesh`` extends ``Entity``), so a
  vertex's world position is ``inst.from_local(mesh.from_local(v))``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

import jax
import numpy as np


def _pytree_dataclass(cls):
    """Register a dataclass as a JAX pytree (all fields are data leaves)."""
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])
    return cls


@_pytree_dataclass
@dataclass
class Materials:
    """Deduplicated Phong material table (reference: include/rayprimitives/material.h).

    Each field is ``[K, 4]`` RGBA (or ``[K]`` for scalars); triangles index into it.
    ``reflective`` iff any Kr channel > 0, ``refractive`` iff any Kt channel > 0
    (material.h:104-112).
    """

    ke: Any  # [K,4] emission
    ka: Any  # [K,4] ambient
    kd: Any  # [K,4] diffuse
    ks: Any  # [K,4] specular
    kt: Any  # [K,4] transmission
    kr: Any  # [K,4] reflection
    alpha: Any  # [K] shininess exponent
    eta: Any  # [K] refraction index


@_pytree_dataclass
@dataclass
class Lights:
    """Point + directional lights (reference: include/rayprimitives/{cpu,gpu}/light*).

    Kept as two dense arrays; either may be empty (shape [0, ...])."""

    point_pos: Any  # [Lp,3]
    point_col: Any  # [Lp,4]
    dir_dir: Any  # [Ld,3] direction the light SHINES (rays go toward -dir)
    dir_col: Any  # [Ld,4]


@_pytree_dataclass
@dataclass
class Camera:
    """Pinhole camera entity (reference: src/rayenv/camera.cu:6-42).

    ``global_near = 0.5 * width / unit_to_pixels / tan(fov)``; pixel (x, y) maps to a
    ray through ``near*f + gx*r + gy*u`` where (r, u, f) are the columns of the
    orientation's rotation matrix.  NOTE: unlike instances, the camera treats its
    quaternion as local->global (the reference reads basis vectors straight out of
    ``o.to_Mat3()`` columns, camera.cu:33-42)."""

    pos: Any  # [3]
    rot: Any  # [4] quaternion [x,y,z,w]
    global_near: Any  # scalar
    unit_to_pixels: Any  # scalar


@_pytree_dataclass
@dataclass
class Scene:
    """The full flattened scene. Every leaf is an array; shapes are static."""

    # --- shared vertex pools (reference: rayprimitives/vertex_buffer) ---
    verts: Any  # [V,3] mesh-local positions
    norms: Any  # [V,3] mesh-local unit vertex normals (area-accumulated, faceted
    #            for the duplicated-vertex cube meshes; src/scene_builder.cc:11-29)

    # --- triangle table (reference: TriInner, rayprimitives/trimesh) ---
    tri_v: Any  # [T,3] i32 vertex indices
    tri_mat: Any  # [T] i32 material table index
    tri_coord_rect: Any  # [T,4] f32 texture atlas rect (texture_x, texture_y, u, v)
    tri_coord_degenerate: Any  # [T] bool; True => untextured, use Kd
    #            (reference: include/rayprimitives/texture_coords.h:12-29)

    # --- meshes (each an entity frame; CSR over triangle table) ---
    mesh_pos: Any  # [M,3]
    mesh_rot: Any  # [M,4]
    mesh_tri_start: Any  # [M] i32
    mesh_tri_count: Any  # [M] i32
    mesh_aabb_min: Any  # [M,3] mesh-local AABB over verts
    mesh_aabb_max: Any  # [M,3]

    # --- material table ---
    materials: Materials

    # --- instances (reference: renv::Transformation) ---
    inst_pos: Any  # [N,3]
    inst_rot: Any  # [N,4]
    inst_mesh: Any  # [N] i32

    # --- world-triangle expansion maps (host-built, static data) ---
    wtri_inst: Any  # [W] i32 instance index per world triangle
    wtri_tri: Any  # [W] i32 triangle-table index per world triangle

    # --- lights ---
    lights: Lights

    # --- environment globals (reference: include/rayenv/environment.h:19-93) ---
    ambience: Any  # [4]
    dist_atten: Any  # [3] constant/linear/quadratic terms

    # --- texture atlas, RGBA f32 in [0,1] ---
    atlas: Any  # [Ha,Wa,4]

    @property
    def n_instances(self) -> int:
        return self.inst_pos.shape[0]

    @property
    def n_world_tris(self) -> int:
        return self.wtri_tri.shape[0]


@dataclass(frozen=True)
class RenderConfig:
    """Static (hashable) render settings — the analog of the reference CLI flags
    ``-d/-r/-s`` (src/main.cc:32-38) plus config-file globals that gate control flow.
    """

    width: int = 640
    height: int = 480
    recurse_depth: int = 2  # "depth" in world*.json (cube_world.cc:181-183)
    shadow_steps: int = 4  # bounded version of the unbounded shadow march
    #                        (src/rayprimitives/light.cu:34-60); documented deviation
    engine: str = "jnp"  # "jnp" XLA casts (the oracle path) | "pallas" the
    #               Pallas-Triton LBVH walk (render/pallas_engine.py), the
    #               GPU path
    use_bvh: bool = True  # False == reference's -r brute-force fallback
    ray_chunk: int = 16384  # rays per jnp cast chunk (memory bound)
    ray_block: int = 64  # rays per Triton program of the "pallas" engine (a
    #               power of two): one packet of screen neighbours sharing
    #               one LBVH walk; the analog of the reference's -d kernel
    #               block (src/main.cc:38, d x d threads per block), which
    #               the CLI's -d maps onto
    interpret: bool = False  # run the Pallas kernels in the interpreter
    #               (CPU tests); never switched on implicitly
    queue_factor: float = 1.0  # wavefront queue capacity as a multiple of the
    #                            primary ray count (children beyond it are dropped
    #                            and counted; fixtures never spawn both child types)
    max_candidates: int = 64  # top-K instances per ray in the culled cast
    max_tris_per_mesh: int = 16  # static upper bound on one mesh's triangle count
    #                              (cube meshes have 12); set by the scene loader
    spp: int = 1  # samples per pixel; > 1 averages low-discrepancy subpixel
    #               samples (extension over the reference's fixed 1 spp —
    #               BASELINE configs call for 4..128 spp)
    texture_mapping: bool = False  # sample the atlas for non-degenerate
    #               TextureCoords (the reference loads the atlas but left
    #               sampling as a TODO, phong.cu:19-23; off = parity)
    early_exit: bool = True  # skip empty bounce rounds / shadow steps with
    #                          while_loops (not reverse-differentiable; the
    #                          training path sets False to keep fori/scan)
    any_reflective: bool = True  # static scene facts set by the loader: does any
    any_refractive: bool = True  # material have Kr > 0 / Kt > 0?  False lets the
    #                              engine drop bounce spawning / the transmissive
    #                              shadow march at trace time (material.h:104-112
    #                              gates the same spawns dynamically per hit)
    edge_aware_grads: bool = False  # backward-only mollified silhouette
    #               visibility: forward images are bit-identical, but autodiff
    #               additionally carries boundary terms so gradients flow to
    #               vertex positions / camera pose through silhouettes.  Works
    #               on both engines: jnp differentiates the cast directly;
    #               pallas uses the analytic (t, uv, normal)-VJP
    #               (cast_vjp.reparam_cast) with the box fast path disabled
    #               (real barycentrics required)
    edge_eps: float = 0.05  # mollifier width in barycentric units (fallback
    #               used when no pixel footprint is available, e.g. raw
    #               render_rays batches)
    edge_px: float = 1.5  # mollifier band width in SCREEN pixels when the
    #               pixel footprint is known (render_frame passes the camera's
    #               pixel angle); keeps foreshortened silhouette faces'
    #               bands resolvable by the sample grid
    fused_shadows: bool = True  # fuse a two-light round's shadow queries
    #               into ONE dual-query LBVH walk ("pallas" engine, opaque
    #               scenes with exactly 1 point + 1 dir light — every
    #               scene in scenes/; self-gating, other configurations
    #               fall back to per-light queries).  Bit-identical results;
    #               saves the shared node stepping.
    wavefront_tile_cap: float = 0.0  # > 0 selects the tile-compacted queue
    #               discipline: shading/shadow/bounce rounds run on only the
    #               ceil(T * cap) ray tiles containing hits (engine.py
    #               _radiance_tile_compacted).  Pays when the hit set is
    #               sparse (world1's lone cube: ~4/300 tiles); hits beyond
    #               the cap are dropped AND counted.  0 = dense rounds.
    child_tile_cap: float = 0.0  # > 0: the mixed-stream (reflect AND refract)
    #               child queue compacts at TILE granularity — keep the first
    #               ceil(T * cap) whole 1024-lane tiles containing any active
    #               child — instead of the per-lane argsort compaction.
    #               Children inherit parent slots, so tiles stay coherent;
    #               overflowing children are dropped AND counted.  0 = the
    #               per-lane compacted queue (exact capacity R*queue_factor).
    static_tile_cap: float = 0.0  # > 0 (spp > 1 paths): ONE center-jitter
    #               probe cast per frame picks the ceil(T * cap) tiles whose
    #               3x3-dilated occupancy contains any hit; EVERY sample then
    #               renders only those tiles (gather rays -> render -> hinted
    #               scatter).  Unlike wavefront_tile_cap this amortizes the
    #               probe over the whole spp sweep — the big lever for
    #               mostly-empty frames (mostly-sky frames).
    #               Subpixel jitter moves silhouettes < 1 px, far inside the
    #               32-px dilation ring, so kept-tile coverage is exact for
    #               the fixture worlds; probe hits beyond the cap are counted
    #               as drops (engine._static_tile_lanes).

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


def scene_render_flags(scene: Scene) -> dict:
    """Static scene facts for RenderConfig — what the cube-world loader sets
    for fixture scenes (cube_world.py), exposed for hand-built scenes:
    ``RenderConfig(**scene_render_flags(scene), ...)``."""
    counts = np.asarray(scene.mesh_tri_count)
    return dict(
        any_reflective=bool(np.any(np.asarray(scene.materials.kr) > 0.0)),
        any_refractive=bool(np.any(np.asarray(scene.materials.kt) > 0.0)),
        max_tris_per_mesh=int(counts.max()) if counts.size else 1,
    )


def device_scene(scene: Scene) -> Scene:
    """Move every leaf to the default device as jnp arrays."""
    import jax.numpy as jnp

    return jax.tree_util.tree_map(jnp.asarray, scene)


def scene_summary(scene: Scene) -> str:
    v = scene.verts.shape[0]
    t = scene.tri_v.shape[0]
    n = scene.inst_pos.shape[0]
    w = scene.wtri_tri.shape[0]
    lp = scene.lights.point_pos.shape[0]
    ld = scene.lights.dir_dir.shape[0]
    return (
        f"Scene(verts={v}, tris={t}, meshes={scene.mesh_pos.shape[0]}, "
        f"instances={n}, world_tris={w}, lights={lp}+{ld})"
    )


def tree_f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)
