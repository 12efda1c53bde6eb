"""Pallas-Triton cast kernels: a packet-synchronous stackless LBVH walk.

The GPU replacement for the reference's per-pixel megakernel
(src/raytracer.cu:17-43) and warp-synchronous BVH walk (src/rayenv/scene.cu:54-70,
src/rayopt/bvh.cu:99-122).  Design notes:

* **Template instancing.** Instances of a mesh share identical mesh-local
  triangles, so the kernels read one small *template table* (triangle
  vertices, precomputed plane normals/areas, vertex normals — a few KB) plus a
  per-instance table (frame, triangle range, box faces — 168 B/instance).
  Rays are transformed into instance-local space per candidate (exactly the
  reference's ``cast_local`` structure, scene.cu:28-40) — no per-triangle
  world arrays.  Every table is a whole-array kernel input read by scalar
  index; the tables are small and stay in L2.
* **Packet-synchronous walk.** One Triton program owns a 1-D block of
  ``cfg.ray_block`` rays that are screen neighbours (the engine casts in
  32x32 block-major order).  A single cursor walks the implicit-heap LBVH in
  preorder for the whole block; a block-wide vote
  (``max(hit) > 0`` — the ``__ballot_sync`` analog of scene.cu:65-69) decides
  descend vs skip, and leaves run the instance intersector.  The running best
  hit lives in registers as loop-carried values.
* **Closest hit semantics** match the oracle: the reference's plane +
  barycentric-area test (geometry.h:275-290) with THRESHOLD epsilons and
  strict ``t < best`` updates.  Axis-aligned box meshes take an exact slab
  fast path (see ``_box_face_hit``).

The kernels implement the shared CastFn interface, so the whole wavefront
engine (bounces, shadows, shading) runs unchanged on top of them.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from .. import raymath as rm
from ..scene import RenderConfig, Scene
from .cast import CastFn, Hit
from .geometry import WorldGeometry

F32_NEG_BIG = -3.0e38
F32_BIG = 3.0e38

# inst_f32 row layout
_IF_POS = 0    # 0:3 frame position
_IF_QUAT = 3   # 3:7 frame quaternion [x,y,z,w] (global->local, entity.cu:5-9)
_IF_FNRM = 7   # 7:25 six world-space face normals, 3 floats per face
#                faces ordered f = axis*2 + side (x-,x+,y-,y+,z-,z+)
_IF_WIDTH = 25

# inst_i32 row layout
_II_TMPL_START = 0  # first row in the template table
_II_TRI_COUNT = 1   # triangle count
_II_WTRI_START = 2  # global world-triangle index of this instance's first tri
_II_IS_BOX = 3      # 1 when the mesh is a detected axis-aligned box (the slab
#                     entry/exit IS the closest triangle hit; no tri loop)
_II_MAT = 4         # material id (box meshes are single-material by detection)
_II_FACE_WTRI = 5   # 5:11 first world-tri id per face (f = axis*2 + side)
_II_FACE_WTRI2 = 11  # 11:17 second world-tri id per face (box_exact_uv: the
#                      box fast path picks whichever of the face's two
#                      triangles contains the hit and emits its true uv)
_II_WIDTH = 17

# template row layout (per mesh-local triangle)
_TF_A = 0      # 0:3 vertex a
_TF_B = 3      # 3:6 vertex b
_TF_C = 6      # 6:9 vertex c
_TF_PNU = 9    # 9:12 unit plane normal (normalize(cross(b-a, c-a)))
_TF_AREA = 12  # |cross(b-a, c-a)| (twice the area)
_TF_MAT = 13   # material id as f32 (exact for ids < 2^24)
_TF_NA = 16    # 16:19 vertex normal a (mesh-local)
_TF_NB = 19    # 19:22 vertex normal b
_TF_NC = 22    # 22:25 vertex normal c
_TF_WIDTH = 32

# LBVH node row layout: 0:3 box min, 3:6 box max, 6 valid flag
_ND_VALID = 6
_ND_WIDTH = 8


def ray_block_for_dim(d: int) -> int:
    """The reference's ``-d`` block edge (src/main.cc:38: d x d threads per
    block) as a kernel ray block: ``d*d`` rays rounded up to a power of two
    (Triton block shapes are powers of two), at least one 32-lane warp and at
    most 1024 rays."""
    n = max(1, d * d)
    return min(max(1 << (n - 1).bit_length(), 32), 1024)


def num_warps_for_block(block: int) -> int:
    """Warps per program: one warp per 32 rays, between 1 and 4."""
    return min(max(block // 32, 1), 4)


def _pytree_dataclass(cls):
    import dataclasses as _dc

    fields = [f.name for f in _dc.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])
    return cls


@_pytree_dataclass
@dataclass
class PallasSceneTables:
    inst_f32: Any  # [N, _IF_WIDTH]
    inst_i32: Any  # [N, _II_WIDTH]
    tmpl: Any  # [T, _TF_WIDTH]


def _detect_box_meshes(scene: Scene):
    """Per-mesh axis-aligned-box detection (trace-safe jnp; values may be
    traced, so the result is runtime data the kernel branches on).  A mesh
    is a "box" when its closest-hit is exactly the local-AABB slab
    entry/exit — i.e. 12 triangles, every vertex on an AABB corner, each AABB
    face carrying exactly 2 coplanar triangles, one material, and faceted
    per-face vertex normals.  ``build_cube`` meshes
    (scene_builder.cu:181-239) satisfy all of it; hand-built trimeshes fall
    back to the template triangle loop.

    Returns ``(is_box [M] bool, mat [M] i32, face_tri [M, 6] i32,
    face_of [T] i32, face_tri2 [M, 6] i32)`` where ``face_tri[m, f]`` is the
    mesh-local triangle-table row of face f's first triangle (f = axis*2 +
    side), ``face_tri2`` its second, and ``face_of[t]`` the face id each
    triangle lies on (meaningful only for box meshes; tests use it to
    compare hits at face granularity).
    """
    T = scene.tri_v.shape[0]
    M = scene.mesh_pos.shape[0]
    tol = 1e-5

    va = scene.verts[scene.tri_v[:, 0]]
    vb = scene.verts[scene.tri_v[:, 1]]
    vc = scene.verts[scene.tri_v[:, 2]]
    tri_rows = jnp.arange(T, dtype=jnp.int32)
    # mesh id per triangle row
    starts = scene.mesh_tri_start
    ends = starts + scene.mesh_tri_count
    in_mesh = (tri_rows[None, :] >= starts[:, None]) & (
        tri_rows[None, :] < ends[:, None]
    )  # [M, T]
    mesh_of = jnp.argmax(in_mesh, axis=0).astype(jnp.int32)  # [T]

    bmin = scene.mesh_aabb_min[mesh_of]  # [T,3]
    bmax = scene.mesh_aabb_max[mesh_of]
    scale = jnp.maximum(jnp.max(bmax - bmin, axis=-1, keepdims=True), 1e-8)

    def on_corner(v):
        lo = jnp.abs(v - bmin) <= tol * scale
        hi = jnp.abs(v - bmax) <= tol * scale
        return jnp.all(lo | hi, axis=-1)

    corners_ok = on_corner(va) & on_corner(vb) & on_corner(vc)  # [T]

    # face of each tri: the axis+side all 3 verts share (if any)
    def plane_flags(plane):  # [T,3] per-axis "all three verts on this plane"
        return (
            (jnp.abs(va - plane) <= tol * scale)
            & (jnp.abs(vb - plane) <= tol * scale)
            & (jnp.abs(vc - plane) <= tol * scale)
        )

    lo_f = plane_flags(bmin)  # [T,3]
    hi_f = plane_flags(bmax)
    flags = jnp.stack(
        [lo_f[:, 0], hi_f[:, 0], lo_f[:, 1], hi_f[:, 1], lo_f[:, 2],
         hi_f[:, 2]], -1,
    )  # [T, 6]
    one_face = jnp.sum(flags, axis=-1) == 1
    face_of = jnp.argmax(flags, axis=-1).astype(jnp.int32)  # [T]

    # faceted normals: all three vertex normals equal
    na = scene.norms[scene.tri_v[:, 0]]
    nb = scene.norms[scene.tri_v[:, 1]]
    nc = scene.norms[scene.tri_v[:, 2]]
    faceted = (
        jnp.all(jnp.abs(na - nb) <= 1e-5, axis=-1)
        & jnp.all(jnp.abs(na - nc) <= 1e-5, axis=-1)
    )

    tri_ok = corners_ok & one_face & faceted  # [T]

    # per (mesh, face) triangle counts and first row
    mf = mesh_of * 6 + face_of  # [T]
    counts = jnp.zeros((M * 6,), jnp.int32).at[mf].add(
        jnp.where(tri_ok, 1, 0)
    )
    first = jnp.full((M * 6,), T, jnp.int32).at[mf].min(
        jnp.where(tri_ok, tri_rows, T)
    )
    second = jnp.full((M * 6,), -1, jnp.int32).at[mf].max(
        jnp.where(tri_ok, tri_rows, -1)
    )
    counts = counts.reshape(M, 6)
    face_tri = jnp.clip(first.reshape(M, 6), 0, max(T - 1, 0))
    face_tri2 = jnp.clip(second.reshape(M, 6), 0, max(T - 1, 0))

    # both triangles of a face must agree on the (faceted) normal: the sum of
    # two equal unit normals has length 2, opposed windings give ~0.
    nsum = jnp.zeros((M * 6, 3), jnp.float32).at[mf].add(
        jnp.where(tri_ok[:, None], na, 0.0)
    )
    normals_agree = jnp.all(
        jnp.abs(jnp.sum(nsum * nsum, -1).reshape(M, 6) - 4.0) < 1e-3, axis=-1
    )

    # one material per mesh
    ref_mat = scene.tri_mat[jnp.clip(starts, 0, max(T - 1, 0))]
    same_mat = jnp.zeros((M,), jnp.int32).at[mesh_of].add(
        jnp.where(scene.tri_mat == ref_mat[mesh_of], 0, 1)
    ) == 0

    all_ok = jnp.zeros((M,), jnp.int32).at[mesh_of].add(
        jnp.where(tri_ok, 0, 1)
    ) == 0
    is_box = (
        (scene.mesh_tri_count == 12)
        & all_ok
        & jnp.all(counts == 2, axis=-1)
        & normals_agree
        & same_mat
    )
    return is_box, ref_mat.astype(jnp.int32), face_tri, face_of, face_tri2


def build_tables(scene: Scene, geom: WorldGeometry, *, exact_uv: bool = False,
                 texture_mapping: bool = False,
                 box_exact_uv: bool = False) -> PallasSceneTables:
    """Build the kernels' scene tables from the scene (trace-safe jnp ops).

    ``exact_uv=True`` disables the box fast path entirely: the plain fast
    path reports a fixed uv=(1/3, 1/3) and a per-face representative
    triangle, which is fine for faceted Phong shading but wrong for any
    consumer of the true barycentric coordinates (texture sampling, the
    edge-aware silhouette band, the analytic uv-VJP).

    ``box_exact_uv=True`` (the edge-aware configuration) KEEPS the box fast
    path and instead fills the per-face second-triangle columns
    (_II_FACE_WTRI2) so the kernel resolves the true containing triangle and
    its signed barycentrics at box cost instead of demoting the mesh to the
    12-triangle template loop.

    ``texture_mapping=True`` keeps the fast path only for meshes whose
    triangles are all texture-degenerate (untextured), since textured meshes
    need interpolated coordinates."""
    n = scene.inst_pos.shape[0]

    # Effective instance frame: the reference applies inst then mesh
    # (hitable.cu:30-38):
    #   v_local = mesh.to_local(inst.to_local(v)) = q_m (q_i (v - p_i) - p_m)
    # Composed: q = q_m q_i and p = p_i + q_i^-1 p_m, so v_local = q (v - p).
    mesh = scene.inst_mesh
    q_i = scene.inst_rot
    q_m = scene.mesh_rot[mesh]
    p_i = scene.inst_pos
    p_m = scene.mesh_pos[mesh]
    q = rm.quat_mul(q_m, q_i)
    p = p_i + rm.quat_rotate_inv(q_i, p_m)

    inst_f32 = jnp.zeros((n, _IF_WIDTH), jnp.float32)
    inst_f32 = inst_f32.at[:, _IF_POS:_IF_POS + 3].set(p)
    inst_f32 = inst_f32.at[:, _IF_QUAT:_IF_QUAT + 4].set(q)

    counts = scene.mesh_tri_count[mesh]
    tmpl_start = scene.mesh_tri_start[mesh]
    wtri_start = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(counts)[:-1]]
    )
    inst_i32 = jnp.zeros((n, _II_WIDTH), jnp.int32)
    inst_i32 = inst_i32.at[:, _II_TMPL_START].set(tmpl_start)
    inst_i32 = inst_i32.at[:, _II_TRI_COUNT].set(counts)
    inst_i32 = inst_i32.at[:, _II_WTRI_START].set(wtri_start)

    # Box fast path metadata: detection + per-face representative world tri +
    # its faceted world normal (taken from geom so orientation matches the
    # reference winding bit-for-bit).  The fast path additionally requires an
    # identity composed rotation (cube-world instances are pure translations,
    # cube_world.cc:163) so the world-AABB slab IS the local box test;
    # rotated instances fall back to the template scan.
    is_box_m, mat_m, face_tri_m, _, face_tri2_m = _detect_box_meshes(scene)
    if exact_uv and not box_exact_uv:
        is_box_m = jnp.zeros_like(is_box_m)
    elif texture_mapping:
        # a textured box mesh must take the template path for real uv
        T = scene.tri_v.shape[0]
        tri_rows = jnp.arange(T, dtype=jnp.int32)
        starts_m = scene.mesh_tri_start
        in_mesh = (
            (tri_rows[None, :] >= starts_m[:, None])
            & (tri_rows[None, :] < (starts_m + scene.mesh_tri_count)[:, None])
        )
        any_tex = jnp.any(
            in_mesh & ~scene.tri_coord_degenerate[None, :], axis=1
        )
        is_box_m = is_box_m & ~any_tex
    ident_rot = (
        (jnp.abs(q[:, 0]) < 1e-6)
        & (jnp.abs(q[:, 1]) < 1e-6)
        & (jnp.abs(q[:, 2]) < 1e-6)
    )
    inst_i32 = inst_i32.at[:, _II_IS_BOX].set(
        (is_box_m[mesh] & ident_rot).astype(jnp.int32)
    )
    inst_i32 = inst_i32.at[:, _II_MAT].set(mat_m[mesh])
    # face triangle row (mesh-local) -> world tri id for this instance
    face_wtri = wtri_start[:, None] + (
        face_tri_m[mesh] - tmpl_start[:, None]
    )  # [n, 6]
    face_wtri = jnp.clip(face_wtri, 0, max(geom.a.shape[0] - 1, 0))
    inst_i32 = inst_i32.at[:, _II_FACE_WTRI:_II_FACE_WTRI + 6].set(face_wtri)
    face_wtri2 = wtri_start[:, None] + (
        face_tri2_m[mesh] - tmpl_start[:, None]
    )
    face_wtri2 = jnp.clip(face_wtri2, 0, max(geom.a.shape[0] - 1, 0))
    inst_i32 = inst_i32.at[:, _II_FACE_WTRI2:_II_FACE_WTRI2 + 6].set(
        face_wtri2
    )
    fnrm = geom.na[face_wtri]  # [n, 6, 3] world faceted face normals
    inst_f32 = inst_f32.at[:, _IF_FNRM:_IF_FNRM + 18].set(
        fnrm.reshape(n, 18)
    )

    # Template triangles in mesh-local space.
    va = scene.verts[scene.tri_v[:, 0]]
    vb = scene.verts[scene.tri_v[:, 1]]
    vc = scene.verts[scene.tri_v[:, 2]]
    pn = jnp.cross(vb - va, vc - va)
    area = jnp.sqrt(jnp.sum(pn * pn, axis=-1))
    pnu = rm.normalize(pn)
    t = scene.tri_v.shape[0]
    tmpl = jnp.zeros((t, _TF_WIDTH), jnp.float32)
    tmpl = tmpl.at[:, _TF_A:_TF_A + 3].set(va)
    tmpl = tmpl.at[:, _TF_B:_TF_B + 3].set(vb)
    tmpl = tmpl.at[:, _TF_C:_TF_C + 3].set(vc)
    tmpl = tmpl.at[:, _TF_PNU:_TF_PNU + 3].set(pnu)
    tmpl = tmpl.at[:, _TF_AREA].set(area)
    tmpl = tmpl.at[:, _TF_MAT].set(scene.tri_mat.astype(jnp.float32))
    tmpl = tmpl.at[:, _TF_NA:_TF_NA + 3].set(scene.norms[scene.tri_v[:, 0]])
    tmpl = tmpl.at[:, _TF_NB:_TF_NB + 3].set(scene.norms[scene.tri_v[:, 1]])
    tmpl = tmpl.at[:, _TF_NC:_TF_NC + 3].set(scene.norms[scene.tri_v[:, 2]])
    return PallasSceneTables(inst_f32=inst_f32, inst_i32=inst_i32, tmpl=tmpl)


# ---------------------------------------------------------------------------
# Kernel building blocks.  Everything below runs inside a Triton program on a
# block of rays: ray quantities are [B] vectors, table reads are scalars.
# ---------------------------------------------------------------------------


def _any(mask):
    """Block-wide vote (Triton lowers no boolean reduction; max of i32 does)."""
    return jnp.max(mask.astype(jnp.int32)) > 0


def _quat_rotate(qx, qy, qz, qw, vx, vy, vz):
    """Rotate ray vectors (vx,vy,vz) by the scalar quaternion (qx..qw)."""
    n2 = qx * qx + qy * qy + qz * qz + qw * qw
    s = jnp.where(n2 > 1e-12, 1.0 / n2, 0.0)
    xx, yy, zz = 2 * qx * qx * s, 2 * qy * qy * s, 2 * qz * qz * s
    wx, wy, wz = 2 * qw * qx * s, 2 * qw * qy * s, 2 * qw * qz * s
    xy, xz, yz = 2 * qx * qy * s, 2 * qx * qz * s, 2 * qy * qz * s
    rx = (1 - (yy + zz)) * vx + (xy - wz) * vy + (xz + wy) * vz
    ry = (xy + wz) * vx + (1 - (xx + zz)) * vy + (yz - wx) * vz
    rz = (xz - wy) * vx + (yz + wx) * vy + (1 - (xx + yy)) * vz
    return rx, ry, rz


def _ray_recips(dx, dy, dz):
    # Safe reciprocal directions with the reference's skip-parallel semantics:
    # only EXACT zeros count as parallel (bounding_box.cu:75's ``d == 0``
    # continue) — matching the jnp oracle's ray_aabb — so near-axis-parallel
    # rays (0 < |d| < eps) keep their true slab arithmetic.  Axis-aligned
    # shadow and camera rays have exact zero components and take the
    # containment test instead.
    par_x = dx == 0.0
    par_y = dy == 0.0
    par_z = dz == 0.0
    ix = 1.0 / jnp.where(par_x, 1.0, dx)
    iy = 1.0 / jnp.where(par_y, 1.0, dy)
    iz = 1.0 / jnp.where(par_z, 1.0, dz)
    return (par_x, par_y, par_z), (ix, iy, iz)


def _slab_terms(tab_ref, i, ox, oy, oz, ix, iy, iz, par_x, par_y, par_z,
                base: int):
    """Per-axis Kay/Kajiya slab times against the row-``i`` AABB stored at
    columns [base, base+6) (bounding_box.cu:63-104); parallel axes are
    unconstrained (the reference skips plane-parallel triangles)."""
    bx0 = tab_ref[i, base + 0]
    by0 = tab_ref[i, base + 1]
    bz0 = tab_ref[i, base + 2]
    bx1 = tab_ref[i, base + 3]
    by1 = tab_ref[i, base + 4]
    bz1 = tab_ref[i, base + 5]
    t1x = (bx0 - ox) * ix
    t2x = (bx1 - ox) * ix
    tnx = jnp.where(par_x, F32_NEG_BIG, jnp.minimum(t1x, t2x))
    tfx = jnp.where(par_x, F32_BIG, jnp.maximum(t1x, t2x))
    t1y = (by0 - oy) * iy
    t2y = (by1 - oy) * iy
    tny = jnp.where(par_y, F32_NEG_BIG, jnp.minimum(t1y, t2y))
    tfy = jnp.where(par_y, F32_BIG, jnp.maximum(t1y, t2y))
    t1z = (bz0 - oz) * iz
    t2z = (bz1 - oz) * iz
    tnz = jnp.where(par_z, F32_NEG_BIG, jnp.minimum(t1z, t2z))
    tfz = jnp.where(par_z, F32_BIG, jnp.maximum(t1z, t2z))
    # parallel-axis containment: a ray parallel to an axis whose origin lies
    # outside that slab can never hit a face of the box (the reference's
    # per-triangle bary test rejects it; the slab alone would not).
    inside = (
        (~par_x | ((ox >= bx0) & (ox <= bx1)))
        & (~par_y | ((oy >= by0) & (oy <= by1)))
        & (~par_z | ((oz >= bz0) & (oz <= bz1)))
    )
    return (tnx, tny, tnz), (tfx, tfy, tfz), inside


def _entry_exit(tns, tfs):
    tmin = jnp.maximum(jnp.maximum(tns[0], tns[1]), tns[2])
    tmax = jnp.minimum(jnp.minimum(tfs[0], tfs[1]), tfs[2])
    return tmin, tmax


def _box_face_hit(tns, tfs, inside, dx, dy, dz, inst_f_ref, inst_i_ref, i):
    """Closest-hit of a ray against an axis-aligned box from its slab times.

    For a closed box, the slab entry time IS the closest triangle hit (the
    entry face), and when the origin is inside (entry < THRESHOLD) the exit
    face is hit from within — exactly what the reference's 12-triangle scan
    computes (trimesh.cu:47-68), at ~1/15 the arithmetic.  Returns
    ``(ok, t, wtri, nx, ny, nz, face)`` vectors; ``wtri`` is the face's first
    triangle (either of the face's two coplanar triangles shades
    identically)."""
    t_entry, t_exit = _entry_exit(tns, tfs)
    tnx, tny, _ = tns
    tfx, tfy, _ = tfs
    hit_box = (t_entry <= t_exit) & inside
    is_entry = t_entry >= rm.THRESHOLD
    t_hit = jnp.where(is_entry, t_entry, t_exit)
    ok = hit_box & (t_hit >= rm.THRESHOLD)

    tx = jnp.where(is_entry, tnx, tfx)
    ty = jnp.where(is_entry, tny, tfy)
    ax_x = tx == t_hit
    ax_y = ~ax_x & (ty == t_hit)
    dsel = jnp.where(ax_x, dx, jnp.where(ax_y, dy, dz))
    # entry through the low face iff the ray moves up-axis; exit mirrors it
    side_hi = (dsel >= 0.0) ^ is_entry
    axis = jnp.where(ax_x, 0, jnp.where(ax_y, 1, 2))
    face = axis * 2 + side_hi.astype(jnp.int32)

    wtri = jnp.zeros_like(face)
    nx = jnp.zeros_like(dx)
    ny = jnp.zeros_like(dx)
    nz = jnp.zeros_like(dx)
    for f in range(6):
        sel = face == f
        wtri = jnp.where(sel, inst_i_ref[i, _II_FACE_WTRI + f], wtri)
        nx = jnp.where(sel, inst_f_ref[i, _IF_FNRM + 3 * f + 0], nx)
        ny = jnp.where(sel, inst_f_ref[i, _IF_FNRM + 3 * f + 1], ny)
        nz = jnp.where(sel, inst_f_ref[i, _IF_FNRM + 3 * f + 2], nz)
    return ok, t_hit, wtri, nx, ny, nz, face


def _tmpl_tri(tmpl_ref, row):
    """Template triangle ``row``: vertices, unit plane normal, area."""
    a = tuple(tmpl_ref[row, _TF_A + k] for k in range(3))
    b = tuple(tmpl_ref[row, _TF_B + k] for k in range(3))
    c = tuple(tmpl_ref[row, _TF_C + k] for k in range(3))
    pn = tuple(tmpl_ref[row, _TF_PNU + k] for k in range(3))
    return a, b, c, pn, tmpl_ref[row, _TF_AREA]


def _tri_hit(tri, lo, ld):
    """The reference's plane + barycentric-area test (geometry.h:254-290) of
    local rays ``lo + t ld`` against one template triangle: returns
    ``(ok, t, b0, b1, b2)`` with ``ok`` excluding ``t < THRESHOLD``."""
    (ax, ay, az), (bx, by, bz), (cx, cy, cz), (nx, ny, nz), area = tri
    lox, loy, loz = lo
    ldx, ldy, ldz = ld
    denom = ldx * nx + ldy * ny + ldz * nz
    plane_ok = jnp.abs(denom) >= rm.THRESHOLD
    tt = ((ax - lox) * nx + (ay - loy) * ny + (az - loz) * nz) / \
        jnp.where(plane_ok, denom, 1.0)
    hx = lox + tt * ldx
    hy = loy + tt * ldy
    hz = loz + tt * ldz
    inv_area = 1.0 / jnp.where(area > 0.0, area, 1.0)

    def edge_area(p0x, p0y, p0z, p1x, p1y, p1z):
        ex = p0y * p1z - p0z * p1y
        ey = p0z * p1x - p0x * p1z
        ez = p0x * p1y - p0y * p1x
        return jnp.sqrt(ex * ex + ey * ey + ez * ez)

    b0 = edge_area(cx - hx, cy - hy, cz - hz, bx - hx, by - hy, bz - hz) \
        * inv_area
    b1 = edge_area(cx - hx, cy - hy, cz - hz, ax - hx, ay - hy, az - hz) \
        * inv_area
    b2 = edge_area(ax - hx, ay - hy, az - hz, bx - hx, by - hy, bz - hz) \
        * inv_area
    inside_t = jnp.abs(b0 + b1 + b2 - 1.0) <= rm.THRESHOLD
    ok = plane_ok & inside_t & (area > 0.0) & (tt >= rm.THRESHOLD)
    return ok, tt, b0, b1, b2


def _local_rays(inst_f_ref, i, rays):
    """Rays in instance ``i``'s local frame: o' = q (o - p); d' = q d
    (entity.cu:5-9; rotations preserve |d| so no time rescale,
    hitable.cu:16-25).  Also returns the quaternion."""
    ox, oy, oz, dx, dy, dz = rays
    px, py, pz = (inst_f_ref[i, _IF_POS + k] for k in range(3))
    q = tuple(inst_f_ref[i, _IF_QUAT + k] for k in range(4))
    lo = _quat_rotate(*q, ox - px, oy - py, oz - pz)
    ld = _quat_rotate(*q, dx, dy, dz)
    return lo, ld, q


def _box_bary(tmpl_ref, row, hx, hy, hz):
    """Signed barycentrics (u = b-weight, v = c-weight) of the local hit
    point vs template triangle ``row`` — matches the analytic VJP
    reconstruction (cast_vjp._recon_plane_hit)."""
    (ax, ay, az), (bx, by, bz), (cx, cy, cz), (pnx, pny, pnz), area = \
        _tmpl_tri(tmpl_ref, row)
    inv = 1.0 / jnp.maximum(area, 1e-20)
    pax, pay, paz = hx - ax, hy - ay, hz - az
    cax, cay, caz = cx - ax, cy - ay, cz - az
    bax, bay, baz = bx - ax, by - ay, bz - az
    # u = ((p-a) x (c-a)) . n_hat / |n_raw|
    u = ((pay * caz - paz * cay) * pnx
         + (paz * cax - pax * caz) * pny
         + (pax * cay - pay * cax) * pnz) * inv
    # v = ((b-a) x (p-a)) . n_hat / |n_raw|
    v = ((bay * paz - baz * pay) * pnx
         + (baz * pax - bax * paz) * pny
         + (bax * pay - bay * pax) * pnz) * inv
    return u, v


def _intersect_instance(i, tns, tfs, inside, rays, refs, best,
                        exact_uv: bool):
    """Closest-hit update of instance ``i`` against the ray block: returns
    the new ``best`` tuple ``(t, tri, u, v, nx, ny, nz, mat)``.  ``tns/tfs/
    inside`` are the instance's world slab terms (the LBVH leaf box is the
    instance box).

    ``exact_uv`` (static): the box fast path additionally resolves the TRUE
    containing triangle of the hit face and its signed barycentrics — a
    per-face gated pair of bary evaluations instead of the 12-triangle
    template loop.  Requires tables built with ``box_exact_uv=True``."""
    ox, oy, oz, dx, dy, dz = rays
    inst_f_ref, inst_i_ref, tmpl_ref = refs

    def box_path(best):
        bt, btri, bu, bv, bnx, bny, bnz, bmat = best
        ok, t_hit, wtri, nx, ny, nz, face = _box_face_hit(
            tns, tfs, inside, dx, dy, dz, inst_f_ref, inst_i_ref, i)
        ok = ok & (t_hit < bt)
        bt = jnp.where(ok, t_hit, bt)
        btri = jnp.where(ok, wtri, btri)
        bu = jnp.where(ok, 1.0 / 3.0, bu)
        bv = jnp.where(ok, 1.0 / 3.0, bv)
        bnx = jnp.where(ok, nx, bnx)
        bny = jnp.where(ok, ny, bny)
        bnz = jnp.where(ok, nz, bnz)
        bmat = jnp.where(ok, inst_i_ref[i, _II_MAT], bmat)
        if exact_uv:
            # Mesh-local hit point (identity composed rotation by the box
            # path's precondition): p = o + t d - pos.
            hx = ox + t_hit * dx - inst_f_ref[i, _IF_POS + 0]
            hy = oy + t_hit * dy - inst_f_ref[i, _IF_POS + 1]
            hz = oz + t_hit * dz - inst_f_ref[i, _IF_POS + 2]
            tmpl_start = inst_i_ref[i, _II_TMPL_START]
            wtri_start = inst_i_ref[i, _II_WTRI_START]
            eps_b = 1e-5
            for f in range(6):
                sel = ok & (face == f)

                def resolve(c, f=f, sel=sel):
                    bu, bv, btri = c
                    w1 = inst_i_ref[i, _II_FACE_WTRI + f]
                    w2 = inst_i_ref[i, _II_FACE_WTRI2 + f]
                    u1, v1 = _box_bary(tmpl_ref, w1 - wtri_start + tmpl_start,
                                       hx, hy, hz)
                    u2, v2 = _box_bary(tmpl_ref, w2 - wtri_start + tmpl_start,
                                       hx, hy, hz)
                    in1 = ((u1 >= -eps_b) & (v1 >= -eps_b)
                           & (u1 + v1 <= 1.0 + eps_b))
                    in2 = ((u2 >= -eps_b) & (v2 >= -eps_b)
                           & (u2 + v2 <= 1.0 + eps_b))
                    use2 = ~in1 & in2
                    return (jnp.where(sel, jnp.where(use2, u2, u1), bu),
                            jnp.where(sel, jnp.where(use2, v2, v1), bv),
                            jnp.where(sel, jnp.where(use2, w2, w1), btri))

                bu, bv, btri = jax.lax.cond(_any(sel), resolve, lambda c: c,
                                            (bu, bv, btri))
        return bt, btri, bu, bv, bnx, bny, bnz, bmat

    def template_path(best):
        # per-triangle scan in the instance-local frame (cast_local,
        # scene.cu:28-40)
        lo, ld, (qx, qy, qz, qw) = _local_rays(inst_f_ref, i, rays)
        tmpl_start = inst_i_ref[i, _II_TMPL_START]
        wtri_start = inst_i_ref[i, _II_WTRI_START]

        def tri_body(j, best):
            bt, btri, bu, bv, bnx, bny, bnz, bmat = best
            row = tmpl_start + j
            ok, tt, b0, b1, b2 = _tri_hit(_tmpl_tri(tmpl_ref, row), lo, ld)
            ok = ok & (tt < bt)
            # interpolated mesh-local shading normal, rotated back to world
            # by the inverse (conjugate) instance quat (trimesh.cu:59-63 +
            # hitable.cu fix_isect)
            sn = [b0 * tmpl_ref[row, _TF_NA + k]
                  + b1 * tmpl_ref[row, _TF_NB + k]
                  + b2 * tmpl_ref[row, _TF_NC + k] for k in range(3)]
            wnx, wny, wnz = _quat_rotate(-qx, -qy, -qz, qw, *sn)
            return (jnp.where(ok, tt, bt),
                    jnp.where(ok, wtri_start + j, btri),
                    jnp.where(ok, b1, bu),
                    jnp.where(ok, b2, bv),
                    jnp.where(ok, wnx, bnx),
                    jnp.where(ok, wny, bny),
                    jnp.where(ok, wnz, bnz),
                    jnp.where(ok, tmpl_ref[row, _TF_MAT].astype(jnp.int32),
                              bmat))

        return jax.lax.fori_loop(0, inst_i_ref[i, _II_TRI_COUNT], tri_body,
                                 best)

    return jax.lax.cond(inst_i_ref[i, _II_IS_BOX] > 0, box_path,
                        template_path, best)


def _occlude_instance(i, tns, tfs, inside, rays, max_t, refs, blk):
    """Any-hit update of instance ``i`` against the ray block: returns the
    new blocked mask (i32).  ``tns/tfs/inside`` are the instance's world
    slab terms; callers only invoke it for a voting leaf."""
    inst_f_ref, inst_i_ref, tmpl_ref = refs

    def box_path(blk):
        # blocked iff the slab hit time lands within [THRESHOLD, max_t]
        tmin, tmax = _entry_exit(tns, tfs)
        t_hit = jnp.where(tmin >= rm.THRESHOLD, tmin, tmax)
        hit = ((tmin <= tmax) & inside & (t_hit >= rm.THRESHOLD)
               & (t_hit <= max_t))
        return jnp.maximum(blk, hit.astype(jnp.int32))

    def template_path(blk):
        lo, ld, _ = _local_rays(inst_f_ref, i, rays)
        tmpl_start = inst_i_ref[i, _II_TMPL_START]

        def tri_body(j, blk):
            ok, tt, _, _, _ = _tri_hit(_tmpl_tri(tmpl_ref, tmpl_start + j),
                                       lo, ld)
            return jnp.maximum(blk, (ok & (tt <= max_t)).astype(jnp.int32))

        return jax.lax.fori_loop(0, inst_i_ref[i, _II_TRI_COUNT], tri_body,
                                 blk)

    return jax.lax.cond(inst_i_ref[i, _II_IS_BOX] > 0, box_path,
                        template_path, blk)


def _skip_next(v):
    """Next preorder node after skipping v's subtree (bvh.cu:99-112): climb
    while v is a right child (odd), then step to the sibling; reaching the
    root ends the walk (0 == done sentinel)."""
    w = jax.lax.while_loop(
        lambda u: (u > 1) & (u % 2 == 1), lambda u: u // 2, v
    )
    return jnp.where(w == 1, jnp.int32(0), w + 1)


def _ray_query(o_refs, d_refs):
    o = tuple(r[...] for r in o_refs)
    d = tuple(r[...] for r in d_refs)
    par, inv = _ray_recips(*d)
    return o, d, par, inv


def _walk_step(v, n_leaves, node_votes):
    """Preorder successor: descend on a voting inner node, else skip."""
    is_leaf = v >= n_leaves
    return jnp.where(node_votes & ~is_leaf, 2 * v, _skip_next(v))


def _cast_kernel(order_ref, nodes_ref, inst_f_ref, inst_i_ref, tmpl_ref,
                 ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref,
                 t_out, tri_out, u_out, v_out, nx_out, ny_out, nz_out,
                 mat_out, visits_out, *, n_leaves: int, exact_uv: bool):
    """Closest hit by the packet-synchronous stackless LBVH walk.

    Virtual heap index v starts at 1 (root); children are 2v, 2v+1; leaves
    are v in [n, 2n); flat array index is (2n-1) - v (cpu/bvh.cc:48-50
    layout).  A node is descended (or a leaf intersected) iff any ray of the
    block enters its box nearer than its current best hit.  Nodes visited
    are O(log N) per occluder (asserted by test_accel's visit-count test);
    ``visits_out`` reports the block's node-visit count."""
    total = 2 * n_leaves - 1
    (ox, oy, oz), (dx, dy, dz), par, inv = _ray_query(
        (ox_ref, oy_ref, oz_ref), (dx_ref, dy_ref, dz_ref))
    rays = (ox, oy, oz, dx, dy, dz)
    refs = (inst_f_ref, inst_i_ref, tmpl_ref)
    zi = jnp.zeros(ox.shape, jnp.int32)
    zf = jnp.zeros_like(ox)
    best0 = (jnp.full_like(ox, jnp.inf), zi, zf, zf, zf, zf, zf + 1.0, zi)

    def body(carry):
        v, cnt, best = carry
        flat = total - v
        tns, tfs, inside = _slab_terms(nodes_ref, flat, ox, oy, oz, *inv,
                                       *par, 0)
        tmin, tmax = _entry_exit(tns, tfs)
        box_hit = ((tmin <= tmax) & (tmax >= rm.THRESHOLD)
                   & (tmin < best[0]) & inside)
        vote = _any(box_hit) & (nodes_ref[flat, _ND_VALID] > 0.0)
        inst = order_ref[jnp.minimum(flat, n_leaves - 1)]
        best = jax.lax.cond(
            vote & (v >= n_leaves) & (inst >= 0),
            lambda b: _intersect_instance(jnp.maximum(inst, 0), tns, tfs,
                                          inside, rays, refs, b, exact_uv),
            lambda b: b, best)
        return _walk_step(v, n_leaves, vote), cnt + 1, best

    _, visits, best = jax.lax.while_loop(
        lambda c: c[0] > 0, body, (jnp.int32(1), jnp.int32(0), best0))
    bt, btri, bu, bv, bnx, bny, bnz, bmat = best
    t_out[...] = bt
    tri_out[...] = btri
    u_out[...] = bu
    v_out[...] = bv
    # re-normalize the interpolated normal once (the reference normalizes
    # per hit, hitable.cu fix_isect)
    inv_len = 1.0 / jnp.maximum(jnp.sqrt(bnx * bnx + bny * bny + bnz * bnz),
                                rm.THRESHOLD)
    nx_out[...] = bnx * inv_len
    ny_out[...] = bny * inv_len
    nz_out[...] = bnz * inv_len
    mat_out[...] = bmat
    visits_out[...] = zi + visits


def _occlude_kernel(order_ref, nodes_ref, inst_f_ref, inst_i_ref, tmpl_ref,
                    *refs, n_leaves: int, n_queries: int):
    """Any-hit occlusion for ``n_queries`` independent queries that share one
    LBVH walk (1 = plain shadow query, 2 = a two-light round's fused shadow
    queries).  A subtree is pruned when, for every query, every still
    unblocked ray misses its box or enters it beyond ``max_t``; the walk ends
    once every ray of every query is blocked.  Each query's leaf update is
    gated by its own vote, so results equal independent walks.

    ``refs`` = per query (ox, oy, oz, dx, dy, dz, max_t) refs, then one
    blocked-mask output per query."""
    total = 2 * n_leaves - 1
    tables = (inst_f_ref, inst_i_ref, tmpl_ref)
    queries = []
    for k in range(n_queries):
        qr = refs[7 * k: 7 * k + 7]
        o, d, par, inv = _ray_query(qr[0:3], qr[3:6])
        queries.append((o + d, par, inv, qr[6][...]))
    outs = refs[7 * n_queries:]

    def body(carry):
        v, blks = carry
        flat = total - v
        node_ok = nodes_ref[flat, _ND_VALID] > 0.0
        inst = order_ref[jnp.minimum(flat, n_leaves - 1)]
        leaf_ok = (v >= n_leaves) & (inst >= 0)
        new_blks = []
        any_vote = jnp.bool_(False)
        for (rays, par, inv, max_t), blk in zip(queries, blks):
            tns, tfs, inside = _slab_terms(nodes_ref, flat, *rays[:3], *inv,
                                           *par, 0)
            tmin, tmax = _entry_exit(tns, tfs)
            box_hit = ((tmin <= tmax) & (tmax >= rm.THRESHOLD) & (blk == 0)
                       & (tmin <= max_t) & inside)
            vote = _any(box_hit) & node_ok
            blk = jax.lax.cond(
                vote & leaf_ok,
                lambda b, tns=tns, tfs=tfs, inside=inside, rays=rays,
                max_t=max_t: _occlude_instance(jnp.maximum(inst, 0), tns, tfs,
                                               inside, rays, max_t, tables,
                                               b),
                lambda b: b, blk)
            new_blks.append(blk)
            any_vote = any_vote | vote
        return _walk_step(v, n_leaves, any_vote), tuple(new_blks)

    def cond(carry):
        v, blks = carry
        open_ = jnp.bool_(False)
        for blk in blks:
            open_ = open_ | _any(blk == 0)
        return (v > 0) & open_

    blk0 = jnp.zeros(outs[0].shape, jnp.int32)
    _, blks = jax.lax.while_loop(cond, body,
                                 (jnp.int32(1), (blk0,) * n_queries))
    for out, blk in zip(outs, blks):
        out[...] = blk


# ---------------------------------------------------------------------------
# Host-side wrappers
# ---------------------------------------------------------------------------


def _block_rays(ro, rd, block: int):
    """Flatten rays to six [Rp] component vectors, Rp a multiple of
    ``block``.  Pad rays park far outside the scene (origin 1e30) so their
    blocks fail every vote — origin-0 ghosts could sit inside the scene and
    pay full traversals."""
    ro_f = ro.reshape(-1, 3)
    rd_f = rd.reshape(-1, 3)
    r = ro_f.shape[0]
    rp = max(-(-r // block), 1) * block
    pad = rp - r
    ro_f = jnp.pad(ro_f, ((0, pad), (0, 0)), constant_values=1.0e30)
    rd_f = jnp.pad(rd_f, ((0, pad), (0, 0)))
    rd_f = jnp.where((jnp.arange(rp) >= r)[:, None],
                     jnp.array([0.0, 0.0, 1.0]), rd_f)
    comps = [ro_f[:, 0], ro_f[:, 1], ro_f[:, 2],
             rd_f[:, 0], rd_f[:, 1], rd_f[:, 2]]
    return comps, r, rp


def prepare_pallas_cast(scene: Scene, geom: WorldGeometry, cfg: RenderConfig):
    """Build the cast's runtime data (scene tables + LBVH nodes) as an
    explicit PYTREE, separate from kernel binding.

    When these arrays are *closed over* by the cast (and its custom_vjp
    wrappers) instead of being function arguments, any traced value among
    them (e.g. tables derived from a scene whose materials are being
    differentiated) becomes a tracer constant inside the staged jaxpr, which
    ``jax.checkpoint`` of the per-sample render body fails to lower ("No
    constant handler for DynamicJaxprTracer").  Threading this pytree through
    explicit arguments (engine._sample_frame) keeps every staged jaxpr
    closure-free."""
    from ..accel import build_lbvh

    tables = build_tables(
        scene, geom,
        exact_uv=cfg.edge_aware_grads,
        box_exact_uv=cfg.edge_aware_grads,
        texture_mapping=cfg.texture_mapping,
    )
    lbvh = build_lbvh(geom.aabb_min, geom.aabb_max)
    total = 2 * lbvh.n_leaves - 1
    nodes = jnp.zeros((total, _ND_WIDTH), jnp.float32)
    nodes = nodes.at[:, 0:3].set(lbvh.box_min)
    nodes = nodes.at[:, 3:6].set(lbvh.box_max)
    nodes = nodes.at[:, _ND_VALID].set(lbvh.valid.astype(jnp.float32))
    return {"tables": tables, "nodes": nodes, "ordering": lbvh.ordering}


def make_pallas_cast(scene: Scene, geom: WorldGeometry, cfg: RenderConfig,
                     aux=None) -> CastFn:
    """Build the Triton-walk cast; tables are computed from (scene, geom) at
    trace time or taken from a ``prepare_pallas_cast`` pytree.

    Rays are cast in blocks of ``cfg.ray_block`` (a power of two); each
    block is one Triton program with one warp per 32 rays (1 to 4 warps).
    ``cfg.interpret`` runs the kernels in the Pallas interpreter — for CPU
    tests only; it is never switched on implicitly.

    The returned cast carries ``occlude(ro, rd, max_t) -> bool`` (any-hit),
    ``occlude2(o1, d1, mt1, o2, d2, mt2)`` (two queries on one walk) and
    ``visit_counts(ro, rd)`` (per-block node visits, used by the O(log N)
    scaling test)."""
    if aux is None:
        aux = prepare_pallas_cast(scene, geom, cfg)
    block = int(cfg.ray_block)
    if block < 1 or block & (block - 1):
        raise ValueError(f"ray_block must be a power of two, got {block}")
    num_warps = num_warps_for_block(block)
    tables = aux["tables"]
    nodes = aux["nodes"]
    ordering = aux["ordering"]
    n_leaves = ordering.shape[0]
    table_args = (ordering, nodes, tables.inst_f32, tables.inst_i32,
                  tables.tmpl)

    def call(kernel, n_ray_args, out_dtypes, rp, args):
        ray_spec = pl.BlockSpec((block,), lambda b: (b,))
        return pl.pallas_call(
            kernel,
            grid=(rp // block,),
            in_specs=[pl.BlockSpec()] * len(table_args)
            + [ray_spec] * n_ray_args,
            out_specs=[ray_spec] * len(out_dtypes),
            out_shape=[jax.ShapeDtypeStruct((rp,), dt) for dt in out_dtypes],
            compiler_params=pltriton.CompilerParams(num_warps=num_warps,
                                                    num_stages=1),
            interpret=cfg.interpret,
            backend="triton",
            name=kernel.func.__name__.strip("_"),
        )(*table_args, *args)

    cast_kernel = functools.partial(_cast_kernel, n_leaves=n_leaves,
                                    exact_uv=cfg.edge_aware_grads)
    f32, i32 = jnp.float32, jnp.int32

    def run_cast(ro, rd):
        batch_shape = ro.shape[:-1]
        comps, r, rp = _block_rays(ro, rd, block)
        t, tri, u, v, nx, ny, nz, mat, visits = call(
            cast_kernel, 6, (f32, i32, f32, f32, f32, f32, f32, i32, i32),
            rp, comps)

        def unpack(x):
            return x[:r].reshape(batch_shape)

        t_u = unpack(t)
        hit = Hit(
            valid=jnp.isfinite(t_u),
            t=t_u,
            wtri=unpack(tri),
            uv=jnp.stack([unpack(u), unpack(v)], axis=-1),
            normal=jnp.stack([unpack(nx), unpack(ny), unpack(nz)], axis=-1),
            mat=unpack(mat),
        )
        return hit, visits.reshape(-1, block)[:, 0]

    def cast(ro, rd):
        return run_cast(ro, rd)[0]

    def occlude_n(queries):
        """queries: tuple of (ro, rd, max_t); returns a bool mask each."""
        batch_shape = queries[0][0].shape[:-1]
        args = []
        for ro, rd, max_t in queries:
            comps, r, rp = _block_rays(ro, rd, block)
            mt = jnp.broadcast_to(max_t, batch_shape).reshape(-1)
            args += comps + [jnp.pad(mt, (0, rp - r))]
        kernel = functools.partial(_occlude_kernel, n_leaves=n_leaves,
                                   n_queries=len(queries))
        blks = call(kernel, 7 * len(queries), (i32,) * len(queries), rp,
                    args)
        return tuple((b[:r] > 0).reshape(batch_shape) for b in blks)

    cast.visit_counts = lambda ro, rd: run_cast(ro, rd)[1]
    cast.occlude = lambda ro, rd, max_t: occlude_n(((ro, rd, max_t),))[0]
    cast.occlude2 = lambda o1, d1, mt1, o2, d2, mt2: occlude_n(
        ((o1, d1, mt1), (o2, d2, mt2)))
    return cast
