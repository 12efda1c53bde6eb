import numpy as np
import pytest

import jax.numpy as jnp

from raytracer import raymath as rm


def test_normalize_zero_below_threshold():
    v = jnp.array([1e-6, 0.0, 0.0])
    assert np.allclose(np.asarray(rm.normalize(v)), 0.0)
    v = jnp.array([3.0, 4.0, 0.0])
    assert np.allclose(np.asarray(rm.normalize(v)), [0.6, 0.8, 0.0], atol=1e-6)


def test_reflect_basic():
    d = jnp.array([1.0, -1.0, 0.0])
    n = jnp.array([0.0, 1.0, 0.0])
    r = np.asarray(rm.reflect(d, n))
    # length preserved, direction mirrored about the normal
    assert np.allclose(np.linalg.norm(r), np.sqrt(2.0), atol=1e-5)
    assert np.allclose(r / np.linalg.norm(r), [np.sqrt(0.5), np.sqrt(0.5), 0.0], atol=1e-5)


def test_refract_straight_through_matched_index():
    # Head-on with matched indices: the (quirky) reference formula yields a vector
    # collinear with d; after the Ray-constructor normalization it is d itself.
    d = jnp.array([0.0, -1.0, 0.0])
    n = jnp.array([0.0, 1.0, 0.0])
    out, tir = rm.refract(d, n, 1.0, 1.0)
    assert not bool(tir)
    assert np.allclose(np.asarray(rm.normalize(out)), [0.0, -1.0, 0.0], atol=1e-6)


def test_refract_total_internal_reflection():
    # Dense -> sparse at a grazing angle: TIR.
    d = rm.normalize(jnp.array([0.9, -0.1, 0.0]))
    n = jnp.array([0.0, 1.0, 0.0])
    out, tir = rm.refract(d, n, 1.5, 1.0)
    assert bool(tir)
    # TIR fallback is the reflection
    ref = np.asarray(rm.reflect(d, n))
    assert np.allclose(np.asarray(out), ref, atol=1e-5)


def test_refract_matches_reference_formula():
    # The reference computes ``eta*d + (eta*dot(d,n) - sqrt(1-sint2))*n`` with the
    # RAW (negative) incident cosine (linear.h:225-242) — NOT the textbook Snell
    # vector form.  Preserved verbatim for image parity; this pins the formula.
    theta_i = 0.4
    d = np.array([np.sin(theta_i), -np.cos(theta_i), 0.0], dtype=np.float32)
    n = np.array([0.0, 1.0, 0.0], dtype=np.float32)
    n1, n2 = 1.0, 1.5
    eta = n1 / n2
    cosi = float(np.dot(d, n))
    sint2 = eta * eta * (1 - cosi * cosi)
    expect = eta * d + (eta * cosi - np.sqrt(1 - sint2)) * n
    out, tir = rm.refract(jnp.asarray(d), jnp.asarray(n), n1, n2)
    assert not bool(tir)
    assert np.allclose(np.asarray(out), expect, atol=1e-6)


def test_quat_rotate_axis_angle():
    q = rm.quat_from_axis_angle(jnp.array([0.0, 0.0, 1.0]), jnp.float32(np.pi / 2))
    v = jnp.array([1.0, 0.0, 0.0])
    out = np.asarray(rm.quat_rotate(q, v))
    assert np.allclose(out, [0.0, 1.0, 0.0], atol=1e-6)


def test_quat_inverse_roundtrip():
    q = rm.quat_from_axis_angle(rm.normalize(jnp.array([1.0, 2.0, 3.0])), 0.7)
    v = jnp.array([0.3, -1.2, 2.0])
    out = rm.quat_rotate_inv(q, rm.quat_rotate(q, v))
    assert np.allclose(np.asarray(out), np.asarray(v), atol=1e-5)


def test_ray_triangle_hit_and_uv():
    a = jnp.array([0.0, 0.0, 0.0])
    b = jnp.array([1.0, 0.0, 0.0])
    c = jnp.array([0.0, 1.0, 0.0])
    ro = jnp.array([0.25, 0.25, 1.0])
    rd = jnp.array([0.0, 0.0, -1.0])
    hit, t, uv = rm.ray_triangle_areas(ro, rd, a, b, c)
    assert bool(hit)
    assert np.allclose(float(t), 1.0, atol=1e-5)
    # uv = (bary_b, bary_c) per reference convention
    assert np.allclose(np.asarray(uv), [0.25, 0.25], atol=1e-4)


def test_ray_triangle_miss_outside():
    a = jnp.array([0.0, 0.0, 0.0])
    b = jnp.array([1.0, 0.0, 0.0])
    c = jnp.array([0.0, 1.0, 0.0])
    ro = jnp.array([0.8, 0.8, 1.0])
    rd = jnp.array([0.0, 0.0, -1.0])
    hit, t, uv = rm.ray_triangle_areas(ro, rd, a, b, c)
    assert not bool(hit)


def test_ray_triangle_parallel_miss():
    a = jnp.array([0.0, 0.0, 0.0])
    b = jnp.array([1.0, 0.0, 0.0])
    c = jnp.array([0.0, 1.0, 0.0])
    ro = jnp.array([0.0, 0.0, 1.0])
    rd = jnp.array([1.0, 0.0, 0.0])  # parallel to the plane
    hit, _, _ = rm.ray_triangle_areas(ro, rd, a, b, c)
    assert not bool(hit)


def test_mt_agrees_with_areas_formulation():
    rng = np.random.RandomState(0)
    n = 512
    a = jnp.asarray(rng.randn(n, 3).astype(np.float32))
    b = jnp.asarray(rng.randn(n, 3).astype(np.float32))
    c = jnp.asarray(rng.randn(n, 3).astype(np.float32))
    ro = jnp.asarray(rng.randn(n, 3).astype(np.float32) * 3)
    rd = rm.normalize(jnp.asarray(rng.randn(n, 3).astype(np.float32)))
    h1, t1, uv1 = rm.ray_triangle_areas(ro, rd, a, b, c)
    h2, t2, uv2 = rm.ray_triangle_mt(ro, rd, a, b, c)
    h1, h2 = np.asarray(h1), np.asarray(h2)
    # Allow a tiny disagreement rate at edges/near-parallel configurations.
    assert (h1 != h2).mean() < 0.01
    both = h1 & h2
    assert np.allclose(np.asarray(t1)[both], np.asarray(t2)[both], rtol=1e-3, atol=1e-4)


def test_ray_aabb():
    bmin = jnp.array([0.0, 0.0, 0.0])
    bmax = jnp.array([1.0, 1.0, 1.0])
    ro = jnp.array([0.5, 0.5, 2.0])
    rd = jnp.array([0.0, 0.0, -1.0])
    hit, t = rm.ray_aabb(ro, rd, bmin, bmax)
    assert bool(hit)
    assert np.allclose(float(t), 1.0, atol=1e-5)
    # behind the box
    rd2 = jnp.array([0.0, 0.0, 1.0])
    hit2, _ = rm.ray_aabb(ro, rd2, bmin, bmax)
    assert not bool(hit2)
    # Axis-parallel ray OUTSIDE the slab: the reference SKIPS parallel axes
    # entirely (bounding_box.cu:74-77), so this is (quirkily) a hit — the cull
    # is over-permissive, never over-restrictive.  Preserved.
    ro3 = jnp.array([0.5, 0.5, 2.0])
    rd3 = jnp.array([0.0, -1.0, 0.0])
    hit3, _ = rm.ray_aabb(ro3, rd3, bmin, bmax)
    assert bool(hit3)


def test_ray_aabb_parallel_inside():
    bmin = jnp.array([0.0, 0.0, 0.0])
    bmax = jnp.array([1.0, 1.0, 1.0])
    ro = jnp.array([0.5, 2.0, 0.5])
    rd = jnp.array([0.0, -1.0, 0.0])
    hit, t = rm.ray_aabb(ro, rd, bmin, bmax)
    assert bool(hit)
    assert np.allclose(float(t), 1.0, atol=1e-5)


def test_z_order_reference_bit_interleave():
    # Against a direct Python reimplementation of z_order.cu:5-36.
    def py_z(vec):
        import struct

        bits = [struct.unpack("<I", struct.pack("<f", float(-v)))[0] for v in vec]
        x, y, z = bits
        offs = [31, 31, 31]
        t = 0
        for i in range(64):
            t = (t << 1) & 0xFFFFFFFFFFFFFFFF
            sel = i % 3
            src = [x, y, z][sel]
            t |= (src >> offs[sel]) & 1
            offs[sel] -= 1
        return t

    pts = np.array([[1.5, -2.25, 0.75], [0.0, 3.0, -1.0]], dtype=np.float32)
    codes = rm.z_order_f32bits_np(pts)
    for p, c in zip(pts, codes):
        assert int(c) == py_z(p)


def test_z_order_quantized_monotone():
    # The quantized Morton code (used by the LBVH) must order a 1-D sweep of
    # centers monotonically along each axis.
    for axis in range(3):
        pts = np.zeros((16, 3), np.float32)
        pts[:, axis] = np.linspace(-5.0, 5.0, 16)
        lo = jnp.asarray(pts.min(0))
        hi = jnp.asarray(pts.max(0))
        codes = np.asarray(rm.z_order_quantized(jnp.asarray(pts), lo, hi))
        assert (np.diff(codes.astype(np.int64)) > 0).all()
