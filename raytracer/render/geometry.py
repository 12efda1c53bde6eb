"""Per-frame geometry expansion: instances -> world-space triangle soup + AABBs.

The reference re-transforms the ray into every instance's local frame at traversal
time (src/rayenv/scene.cu:28-40, src/rayprimitives/hitable.cu:7-51).  The jnp casts
invert that: all instance transforms are rigid, so we push vertices to world space
once per frame as one batched quaternion-rotate (a few fused einsums) and intersect
directly in world coordinates.  For unit ray directions and rigid frames the hit
times and normals are identical (the reference's ``dir_len`` rescale is a no-op),
and the per-ray transform work disappears from the hot loop entirely.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import jax
import jax.numpy as jnp

from .. import raymath as rm
from ..scene import Camera, Scene


def _pytree_dataclass(cls):
    import dataclasses as _dc

    fields = [f.name for f in _dc.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])
    return cls


@_pytree_dataclass
@dataclass
class WorldGeometry:
    """World-space triangle soup, grouped contiguously by instance."""

    a: Any  # [W,3] triangle vertex 0
    b: Any  # [W,3]
    c: Any  # [W,3]
    na: Any  # [W,3] world-space unit vertex normals
    nb: Any  # [W,3]
    nc: Any  # [W,3]
    mat: Any  # [W] i32 material index
    inst: Any  # [W] i32 owning instance
    aabb_min: Any  # [N,3] per-instance world AABB
    aabb_max: Any  # [N,3]


def expand_geometry(scene: Scene) -> WorldGeometry:
    """Flatten (instance x mesh-triangle) into world-space arrays.

    World position of a mesh-local vertex v:
        ``inst.from_local(mesh.from_local(v))``
    with ``from_local(v) = rot(q^-1, v) + p`` (reference: entity.cu:11-13; the
    nested frames come from Transformation wrapping a Trimesh entity,
    scene.cu:28-40 + hitable.cu:30-38)."""
    tri = scene.tri_v[scene.wtri_tri]  # [W,3]
    mesh = scene.inst_mesh[scene.wtri_inst]  # [W]
    m_pos = scene.mesh_pos[mesh]
    m_rot = scene.mesh_rot[mesh]
    i_pos = scene.inst_pos[scene.wtri_inst]
    i_rot = scene.inst_rot[scene.wtri_inst]

    def to_world_point(v):
        v1 = rm.quat_rotate_inv(m_rot, v) + m_pos
        return rm.quat_rotate_inv(i_rot, v1) + i_pos

    def to_world_vec(v):
        return rm.quat_rotate_inv(i_rot, rm.quat_rotate_inv(m_rot, v))

    va, vb, vc = (scene.verts[tri[:, k]] for k in range(3))
    na, nb, nc = (scene.norms[tri[:, k]] for k in range(3))

    # Per-instance world AABBs: fit all 8 transformed corners of the mesh-local box.
    # (The reference fits only the 2 min/max corners, bounding_box.cu:52-60 — an
    # under-covering approximation for rotated instances; fitting 8 corners is the
    # correct generalization and identical for the axis-aligned cube worlds.)
    imesh = scene.inst_mesh
    bmin = scene.mesh_aabb_min[imesh]  # [N,3]
    bmax = scene.mesh_aabb_max[imesh]
    corners = []
    for sx in (0, 1):
        for sy in (0, 1):
            for sz in (0, 1):
                sel = jnp.array([sx, sy, sz], dtype=bmin.dtype)
                corners.append(bmin * (1 - sel) + bmax * sel)
    corners = jnp.stack(corners, axis=1)  # [N,8,3]
    mq = scene.mesh_rot[imesh][:, None, :]
    mp = scene.mesh_pos[imesh][:, None, :]
    iq = scene.inst_rot[:, None, :]
    ip = scene.inst_pos[:, None, :]
    wc = rm.quat_rotate_inv(iq, rm.quat_rotate_inv(mq, corners) + mp) + ip
    aabb_min = wc.min(axis=1)
    aabb_max = wc.max(axis=1)

    return WorldGeometry(
        a=to_world_point(va),
        b=to_world_point(vb),
        c=to_world_point(vc),
        na=to_world_vec(na),
        nb=to_world_vec(nb),
        nc=to_world_vec(nc),
        mat=scene.tri_mat[scene.wtri_tri],
        inst=scene.wtri_inst,
        aabb_min=aabb_min,
        aabb_max=aabb_max,
    )


def camera_rays(cam: Camera, width: int, height: int, jitter=None):
    """Primary rays through every pixel (reference: src/rayenv/camera.cu:33-42).

    The reference casts through integer pixel *corners* ``cam.at(x, y)`` with
    x in [0, W), y in [0, H) and y down (raytracer.cc:49-59).  Returns
    ``(origins [H,W,3], dirs [H,W,3])`` with unit dirs.  ``jitter`` (optional
    [H,W,2] in [0,1)) enables subpixel sampling for spp > 1 (extension)."""
    m = rm.quat_to_mat(cam.rot)
    r = rm.normalize(m[:, 0])
    u = rm.normalize(m[:, 1])
    f = rm.normalize(m[:, 2])
    xs = jnp.arange(width, dtype=jnp.float32)
    ys = jnp.arange(height, dtype=jnp.float32)
    if jitter is not None:
        gx = (xs[None, :] + jitter[..., 0] - 0.5 * width) / cam.unit_to_pixels
        gy = (0.5 * height - (ys[:, None] + jitter[..., 1])) / cam.unit_to_pixels
    else:
        gx = jnp.broadcast_to((xs - 0.5 * width) / cam.unit_to_pixels, (height, width))
        gy = jnp.broadcast_to(
            ((0.5 * height - ys) / cam.unit_to_pixels)[:, None], (height, width)
        )
    d = (
        cam.global_near * f
        + gx[..., None] * r
        + gy[..., None] * u
    )
    d = rm.normalize(d)
    o = jnp.broadcast_to(cam.pos, d.shape)
    return o, d
