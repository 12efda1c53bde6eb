"""Native runtime library vs pure-Python fallbacks (bit-identical contracts)."""

import math
import os
import subprocess

import numpy as np
import pytest

from raytracer import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def built_lib():
    if not native.available():
        build = os.path.join(ROOT, "native", "build.sh")
        try:
            subprocess.run([build], check=True, capture_output=True)
        except Exception:
            pytest.skip("native toolchain unavailable")
        native._lib = None
    if not native.available():
        pytest.skip("native library failed to build")


def test_png_unfilter_matches_python():
    from raytracer.pngio import read_png
    import raytracer.native as nat

    img = read_png("/root/reference/assets/sus.png")
    orig = nat.png_unfilter
    nat.png_unfilter = lambda *a, **k: None
    try:
        img_py = read_png("/root/reference/assets/sus.png")
    finally:
        nat.png_unfilter = orig
    assert np.array_equal(img, img_py)


def test_perlin_grid_matches_python():
    from raytracer.perlin import Perlin

    f32 = np.float32
    p = Perlin(42, 2)
    p.set_amplitude(4.0)
    p.set_period(8.0)
    out = native.perlin_grid_yoff(p.sample_vecs, np.asarray(p.permutation),
                                  4.0, 8.0, 8)
    expect = np.array(
        [math.floor(f32(0.5) * (p.sample(f32(i), f32(j), f32(0.0)) + f32(4.0))) + 1
         for i in range(8) for j in range(8)], dtype=np.float32)
    assert np.array_equal(out, expect)


def test_z_order_matches_numpy():
    from raytracer import raymath as rm

    pts = np.random.RandomState(3).randn(256, 3).astype(np.float32)
    zn = native.z_order_batch(pts)
    zp = rm.z_order_f32bits_np(pts)
    assert np.array_equal(zn, zp)
