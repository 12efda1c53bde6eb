"""Batched ray-tracing math as pure jnp functions.

Array-native replacement for the reference's ``rmath`` layer
(reference: include/raymath/linear.h, include/raymath/geometry.h).  Everything is
shape-polymorphic over leading batch axes and safe under ``vmap``/``jit``/``grad``:
no data-dependent Python control flow, all branches are ``jnp.where`` selects.

Numerical conventions preserved from the reference:

* ``THRESHOLD = 1e-5`` is the universal epsilon (linear.h:15): normalization cutoff,
  plane-parallel cutoff, barycentric tolerance, self-hit offset, AABB t_max culling.
* ``normalize`` returns the zero vector below the cutoff (linear.h:160-167).
* ``reflect`` re-normalizes its output and rescales by the input length
  (linear.h:213-223); ``refract`` returns the total-internal-reflection flag and
  falls back to reflection in that case (linear.h:225-242).
* Triangle intersection uses the reference's plane-then-barycentric-areas test
  (geometry.h:275-290) so the jnp oracle and the CUDA behavior spec agree on accept
  boundaries.  A Moller-Trumbore variant is provided for the fast path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

THRESHOLD = 1e-5


# ---------------------------------------------------------------------------
# vectors
# ---------------------------------------------------------------------------

def dot(a, b, keepdims=False):
    return jnp.sum(a * b, axis=-1, keepdims=keepdims)


def norm(v):
    """Euclidean length with a gradient-safe zero: sqrt has an infinite
    derivative at 0, and reverse-mode through masked-out lanes would turn that
    into NaNs (the where-grad trap); the double-where keeps d|v|/dv = 0 at v=0."""
    s = jnp.sum(v * v, axis=-1)
    pos = s > 0
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, s, 1.0)), 0.0)


def safe_sqrt(x):
    """sqrt clamped at 0 with zero gradient there (not +inf)."""
    pos = x > 0
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, x, 1.0)), 0.0)


def safe_pow(base, exponent):
    """``base ** exponent`` for base >= 0 with finite gradients at base == 0.

    Matches C ``powf`` on the forward values used here: pow(0, 0) == 1,
    pow(0, e>0) == 0; gradients at base == 0 are defined as 0 instead of the
    true +/-inf (subgradient choice for optimization)."""
    pos = base > 0
    safe_base = jnp.where(pos, base, 1.0)
    val = jnp.power(safe_base, exponent)
    zero_case = jnp.where(exponent == 0.0, 1.0, 0.0)
    return jnp.where(pos, val, zero_case)


def normalize(v, eps=THRESHOLD):
    """Reference-faithful normalize: zero vector if length <= eps (linear.h:160-167)."""
    ln = norm(v)[..., None]
    return jnp.where(ln > eps, v / jnp.where(ln > eps, ln, 1.0), 0.0)


def cross(a, b):
    return jnp.cross(a, b)


def reflect(d, n):
    """Mirror reflection (linear.h:213-223): normalize inputs, reflect, re-normalize,
    rescale by |d|."""
    d_len = norm(d)[..., None]
    dn = normalize(d)
    nn = normalize(n)
    r = dn - 2.0 * dot(dn, nn, keepdims=True) * nn
    return d_len * normalize(r)


def refract(d, n, n1, n2):
    """Snell refraction (linear.h:225-242).

    Returns ``(dir, tir)`` where ``tir`` flags total internal reflection; in that case
    ``dir`` is the reflection of the normalized ray (scaled by |d|), matching the
    reference fallback.  ``n1``/``n2`` broadcast against the batch."""
    d_len = norm(d)[..., None]
    dn = normalize(d)
    nn = normalize(n)
    ratio = jnp.asarray(n1 / n2)[..., None] if jnp.ndim(n1) else jnp.float32(n1 / n2)
    if jnp.ndim(ratio) == 0:
        ratio = jnp.broadcast_to(ratio, dn.shape[:-1])[..., None]
    cosi = dot(dn, nn, keepdims=True)
    sint2 = ratio * ratio * (1.0 - cosi * cosi)
    tir = (sint2 > 1.0)[..., 0]
    refracted = ratio * dn + (ratio * cosi - safe_sqrt(1.0 - sint2)) * nn
    reflected = dn - 2.0 * cosi * nn
    out = jnp.where(tir[..., None], normalize(reflected), refracted)
    return d_len * out, tir


# ---------------------------------------------------------------------------
# quaternions ([x, y, z, w] == reference (i, j, k, r))
# ---------------------------------------------------------------------------

IDENTITY_QUAT = jnp.array([0.0, 0.0, 0.0, 1.0], dtype=jnp.float32)


def quat_mul(a, b):
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            ax * bw + aw * bx + ay * bz - az * by,
            ay * bw + aw * by + az * bx - ax * bz,
            az * bw + aw * bz + ax * by - ay * bx,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        axis=-1,
    )


def quat_conj(q):
    return q * jnp.array([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype)


def quat_normalize(q, eps=THRESHOLD):
    ln = norm(q)[..., None]
    return jnp.where(ln > eps, q / jnp.where(ln > eps, ln, 1.0), 0.0)


def quat_to_mat(q):
    """Rotation matrix of a (normalized-on-the-fly) quaternion (geometry.h:184-198)."""
    qn = q / norm(q)[..., None]
    x, y, z, w = qn[..., 0], qn[..., 1], qn[..., 2], qn[..., 3]
    xx, yy, zz = 2 * x * x, 2 * y * y, 2 * z * z
    wx, wy, wz = 2 * w * x, 2 * w * y, 2 * w * z
    xy, xz, yz = 2 * x * y, 2 * x * z, 2 * y * z
    row0 = jnp.stack([1 - (yy + zz), xy - wz, xz + wy], axis=-1)
    row1 = jnp.stack([xy + wz, 1 - (xx + zz), yz - wx], axis=-1)
    row2 = jnp.stack([xz - wy, yz + wx, 1 - (xx + yy)], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def quat_rotate(q, v):
    """Rotate ``v`` by quaternion ``q``.

    The reference computes ``|v| * normalize(im(q v q^-1))`` with a normalized ``q``
    (geometry.h:177-181); for unit quaternions this equals applying the rotation
    matrix, which is what we do (documented deviation: no output re-normalization,
    exact for the rigid frames used everywhere in the pipeline)."""
    m = quat_to_mat(q)
    # HIGHEST precision: at DEFAULT precision XLA may run this tiny
    # contraction in reduced precision (TF32 on the GPU's tensor cores,
    # bf16 on some CPU builds) — geometry must stay exact f32 (cf.
    # shading.gather_material_rows)
    return jnp.einsum("...ij,...j->...i", m, v,
                      precision=jax.lax.Precision.HIGHEST)


def quat_rotate_inv(q, v):
    return quat_rotate(quat_conj(q), v)


def quat_from_axis_angle(axis, theta):
    axis = jnp.asarray(axis, dtype=jnp.float32)
    hc = jnp.cos(0.5 * theta)
    hs = jnp.sin(0.5 * theta)
    return jnp.concatenate([axis * hs, jnp.asarray(hc)[None]], axis=-1)


# ---------------------------------------------------------------------------
# entity frames (reference: src/rayprimitives/entity.cu:5-23)
# ---------------------------------------------------------------------------

def point_to_local(q, p, v):
    return quat_rotate(q, v - p)


def point_from_local(q, p, v):
    return quat_rotate_inv(q, v) + p


def vec_to_local(q, v):
    return quat_rotate(q, v)


def vec_from_local(q, v):
    return quat_rotate_inv(q, v)


# ---------------------------------------------------------------------------
# intersection tests
# ---------------------------------------------------------------------------

def ray_plane(ro, rd, po, pn):
    """Ray/plane (geometry.h:254-261).  ``pn`` must be unit.  Returns (ok, t)."""
    denom = dot(rd, pn)
    ok = jnp.abs(denom) >= THRESHOLD
    t = dot(po - ro, pn) / jnp.where(ok, denom, 1.0)
    return ok, t


def ray_triangle_areas(ro, rd, a, b, c):
    """Reference triangle test (geometry.h:275-290): hit the containing plane, then
    accept iff the three sub-triangle barycentric areas sum to ~1 (tol 1e-5).

    Returns ``(hit, t, uv)`` with ``uv = (bary_b, bary_c)`` matching the reference's
    ``(bary1, bary2)``.  All inputs broadcast; ``rd`` should be unit length."""
    pn_raw = cross(b - a, c - a)
    tri_area = norm(pn_raw)
    pn = normalize(pn_raw)
    ok, t = ray_plane(ro, rd, a, pn)
    p = ro + t[..., None] * rd
    inv_area = 1.0 / jnp.where(tri_area > 0, tri_area, 1.0)
    bary0 = norm(cross(c - p, b - p)) * inv_area
    bary1 = norm(cross(c - p, a - p)) * inv_area
    bary2 = norm(cross(a - p, b - p)) * inv_area
    inside = jnp.abs(bary0 + bary1 + bary2 - 1.0) <= THRESHOLD
    hit = ok & inside & (tri_area > 0)
    uv = jnp.stack([bary1, bary2], axis=-1)
    return hit, t, uv


def ray_triangle_mt(ro, rd, a, b, c, tol=THRESHOLD):
    """Moller-Trumbore triangle test (fast-path alternative; no square roots).

    Accept semantics are aligned with :func:`ray_triangle_areas` via an edge
    tolerance: ``u, v, 1-u-v >= -tol``.  Returns ``(hit, t, uv)``."""
    e1 = b - a
    e2 = c - a
    pvec = cross(rd, e2)
    det = dot(e1, pvec)
    ok = jnp.abs(det) >= 1e-12
    inv_det = 1.0 / jnp.where(ok, det, 1.0)
    tvec = ro - a
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(rd, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    hit = ok & (u >= -tol) & (v >= -tol) & (u + v <= 1.0 + tol)
    uv = jnp.stack([u, v], axis=-1)
    return hit, t, uv


def ray_aabb(ro, rd, bmin, bmax, nondegenerate=True):
    """Kay/Kajiya slab test (reference: src/rayopt/bounding_box.cu:63-104).

    Axes with ``rd == 0`` are skipped (treated as always-inside, as the reference's
    ``continue`` does).  Returns ``(hit, t_entry)`` where ``t_entry`` follows the
    reference's ``time_min if time_min >= 0 else time_max``; the hit additionally
    requires ``t_max >= THRESHOLD``."""
    inv = 1.0 / jnp.where(rd == 0.0, 1.0, rd)
    t1 = (bmin - ro) * inv
    t2 = (bmax - ro) * inv
    tn = jnp.minimum(t1, t2)
    tf = jnp.maximum(t1, t2)
    par = rd == 0.0
    tn = jnp.where(par, -jnp.inf, tn)
    tf = jnp.where(par, jnp.inf, tf)
    tmin = jnp.max(tn, axis=-1)
    tmax = jnp.min(tf, axis=-1)
    # The reference also rejects parallel rays whose origin lies outside the slab?
    # No: it skips the axis entirely (bounding_box.cu:74-77) — preserved above.
    hit = (tmin <= tmax) & (tmax >= THRESHOLD) & nondegenerate
    t_entry = jnp.where(tmin >= 0, tmin, tmax)
    return hit, t_entry


# ---------------------------------------------------------------------------
# Morton / Z-order codes
# ---------------------------------------------------------------------------

def z_order_f32bits_np(center):
    """Reference Morton code (src/rayopt/z_order.cu:5-36), host-side numpy:
    bit-interleave the raw IEEE-754 bit patterns of the *negated* center, x/y/z
    round-robin from bit 31 down, 64 output bits (x contributes 22 bits, y and z
    21).  Interleaving sign-bit floats is ordering-fragile — kept only as the
    documented parity artifact; the LBVH uses :func:`z_order_quantized`."""
    import numpy as np

    inv = (-np.asarray(center, dtype=np.float32))
    bits = inv.view(np.uint32).astype(np.uint64)
    x, y, z = bits[..., 0], bits[..., 1], bits[..., 2]
    code = np.zeros(x.shape, dtype=np.uint64)
    offs = [31, 31, 31]
    srcs = [x, y, z]
    for i in range(64):
        code = code << np.uint64(1)
        sel = i % 3
        code = code | ((srcs[sel] >> np.uint64(offs[sel])) & np.uint64(1))
        offs[sel] -= 1
    return code


def z_order_quantized(center, scene_min, scene_max, bits=10):
    """Branch-free Morton code over fixed-point quantized centers (the deviation
    recommended in SURVEY.md §7.5: monotone in each axis, no sign-bit pathology).

    Returns uint32 codes (3 x ``bits`` interleaved, bits <= 10) so it works under
    JAX's default 32-bit mode; 10 bits/axis = 1024 buckets, ample ordering
    resolution for instance-level BVHs."""
    assert bits <= 10
    scale = (2.0**bits - 1.0) / jnp.maximum(scene_max - scene_min, 1e-30)
    q = jnp.clip((center - scene_min) * scale, 0, 2.0**bits - 1).astype(jnp.uint32)
    x, y, z = q[..., 0], q[..., 1], q[..., 2]

    def spread(v):
        v = v & jnp.uint32(0x3FF)
        v = (v | (v << jnp.uint32(16))) & jnp.uint32(0x030000FF)
        v = (v | (v << jnp.uint32(8))) & jnp.uint32(0x0300F00F)
        v = (v | (v << jnp.uint32(4))) & jnp.uint32(0x030C30C3)
        v = (v | (v << jnp.uint32(2))) & jnp.uint32(0x09249249)
        return v

    return (spread(x) << jnp.uint32(2)) | (spread(y) << jnp.uint32(1)) | spread(z)
