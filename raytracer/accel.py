"""Acceleration structures: instance AABBs + LBVH over instances (pure JAX build).

Array-native redesign of the reference's ``ropt`` layer:

* Build (reference: src/rayopt/bvh.cu:20-91): Morton codes over box centers,
  device sort, then a level-by-level pairwise AABB reduction producing the
  implicit-heap flat array (leaves first, root last; ``2n-1`` boxes for a
  power-of-two-padded leaf count, matching cpu/bvh.cc:12-46's layout).
  ``jax.lax.sort_key_val`` replaces ``thrust::sort_by_key``; the reduction is a
  static unrolled log-depth loop of reshapes+min/max (XLA fuses it; the build is
  tiny — it runs over instances, not triangles).
* Morton codes use fixed-point quantized centers (``z_order_quantized``) instead
  of the reference's raw-float-bit interleave (z_order.cu:5-36) — monotone per
  axis, no sign-bit pathology; a documented deviation (DEVIATIONS.md).  Codes
  only affect traversal order, never hit results.
* Query: the implicit heap enables a stackless traversal (step_next/step_up,
  bvh.cu:98-122); the Pallas engine walks it packet-synchronously.  A masked
  breadth-first jnp reference traversal is provided for tests.

Degenerate (padding) leaves get code ULONG_MAX so they sort last, like
gen_morton (bvh.cu:25-31).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from . import raymath as rm


def _pytree_dataclass(cls):
    import dataclasses as _dc

    fields = [f.name for f in _dc.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])
    return cls


@_pytree_dataclass
@dataclass
class LBVH:
    """Implicit complete-binary-tree BVH over instances.

    ``n_leaves`` is a power of two.  ``box_min/box_max`` hold ``2*n_leaves - 1``
    nodes: leaves at [0, n), internal levels appended pairwise, root last —
    identical layout to the reference (cpu/bvh.cc:35-45).  Virtual heap index 1 is
    the root; flat index of virtual v is ``(2n - 1) - v`` (bvh.cc:48-50).
    ``ordering[i]`` maps sorted leaf i -> original instance id (or -1 padding).
    ``valid[i]`` marks non-degenerate nodes."""

    box_min: Any  # [2n-1, 3]
    box_max: Any  # [2n-1, 3]
    valid: Any  # [2n-1] bool
    ordering: Any  # [n] i32

    @property
    def n_leaves(self) -> int:
        return self.ordering.shape[0]


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def build_lbvh(aabb_min, aabb_max) -> LBVH:
    """Build the LBVH from per-instance world AABBs ([N,3] each)."""
    n_real = aabb_min.shape[0]
    n = next_pow2(max(n_real, 1))
    pad = n - n_real

    bmin = jnp.pad(aabb_min, ((0, pad), (0, 0)))
    bmax = jnp.pad(aabb_max, ((0, pad), (0, 0)))
    leaf_valid = jnp.arange(n) < n_real

    center = 0.5 * (bmin + bmax)
    scene_min = jnp.min(jnp.where(leaf_valid[:, None], bmin, jnp.inf), axis=0)
    scene_max = jnp.max(jnp.where(leaf_valid[:, None], bmax, -jnp.inf), axis=0)
    codes = rm.z_order_quantized(center, scene_min, scene_max)
    codes = jnp.where(leaf_valid, codes, jnp.uint32(0xFFFFFFFF))

    order = jnp.arange(n, dtype=jnp.int32)
    _, ordering = jax.lax.sort_key_val(codes, order)

    bmin = bmin[ordering]
    bmax = bmax[ordering]
    valid = leaf_valid[ordering]

    mins = [bmin]
    maxs = [bmax]
    vals = [valid]
    level = n
    while level >= 2:
        lo = mins[-1].reshape(-1, 2, 3)
        hi = maxs[-1].reshape(-1, 2, 3)
        va = vals[-1].reshape(-1, 2)
        both = va[:, 0] & va[:, 1]
        either = va[:, 0] | va[:, 1]
        # merge semantics (bounding_box.cu:25-49): degenerate operand is ignored.
        big = jnp.float32(3.4e38)
        m_lo = jnp.min(jnp.where(va[..., None], lo, big), axis=1)
        m_hi = jnp.max(jnp.where(va[..., None], hi, -big), axis=1)
        mins.append(jnp.where(either[:, None], m_lo, 0.0))
        maxs.append(jnp.where(either[:, None], m_hi, 0.0))
        vals.append(either)
        level >>= 1

    return LBVH(
        box_min=jnp.concatenate(mins, axis=0),
        box_max=jnp.concatenate(maxs, axis=0),
        valid=jnp.concatenate(vals, axis=0),
        ordering=jnp.where(valid, ordering, -1).astype(jnp.int32),
    )


def traverse_mask_reference(bvh: LBVH, ro, rd):
    """Reference BVH query: per-ray boolean mask [n_leaves] of leaves whose
    subtree was reached (box-hit chain from the root), matching what the
    stackless iterator visits.  Masked breadth-first over the dense levels —
    O(n) like a linear scan, for testing only."""
    n = bvh.n_leaves
    total = 2 * n - 1

    def flat_index(vidx):
        return total - vidx

    # level by level: virtual indices at level d are [2^d, 2^{d+1})
    reach = None
    batch = ro.shape[:-1]
    levels = int(np.log2(n)) + 1
    for d in range(levels):
        vidx = jnp.arange(2**d, 2 ** (d + 1))
        fidx = total - vidx
        bmin = bvh.box_min[fidx]
        bmax = bvh.box_max[fidx]
        val = bvh.valid[fidx]
        hit, _ = rm.ray_aabb(
            ro[..., None, :], rd[..., None, :], bmin, bmax, val
        )  # [..., 2^d]
        if reach is None:
            reach = hit
        else:
            parent_reach = jnp.repeat(reach, 2, axis=-1)
            reach = parent_reach & hit
    # The walk runs in virtual-index order (vidx n..2n-1); flat leaf order is
    # its mirror (flat = (2n-1) - vidx, bvh.cc:48-50) — flip to align with
    # ``ordering``/``box_min`` leaf indexing.
    return reach[..., ::-1]  # [..., n] leaf reachability (flat order)


def leaf_instances(bvh: LBVH, leaf_mask):
    """Map a leaf reachability mask to original instance ids (−1 = none)."""
    return jnp.where(leaf_mask, bvh.ordering, -1)
