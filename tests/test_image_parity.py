"""Image parity against the reference renderer's own output.

Golden PNGs in tests/golden/images were produced by compiling the reference's
CUDA code paths as C++ (tools/reforacle) and rendering each world*.json:

* ``*_gpu_ref.png`` — the reference GPU stack-machine semantics (the target).
* ``*_cpu_ref.png`` — the reference serial path (has divergent recursion quirks,
  kept for documentation; see DEVIATIONS.md).

The acceptance bar mirrors BASELINE.json's "image allclose vs ref": u8 images
must match within 2/255 on ≥ 99.9% of pixels, with zero pixels differing by
more than 8/255 (float-order slack on recursive paths)."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from raytracer import generate
from raytracer.pngio import read_png
from raytracer.render import render_frame
from raytracer.scene import device_scene

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden", "images")


def _render(world_name, use_bvh):
    w = generate(f"/root/reference/{world_name}.json")
    scene = device_scene(w.scene)
    cam = jax.tree_util.tree_map(jnp.asarray, w.camera)
    cfg = w.config.replace(use_bvh=use_bvh, ray_chunk=32768)
    rf = jax.jit(render_frame, static_argnames=("cfg",))
    img = np.asarray(rf(scene, cam, cfg))
    return (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)[..., :3]


def _check(world_name, use_bvh):
    golden = read_png(os.path.join(GOLDEN_DIR, f"{world_name}_gpu_ref.png"))[..., :3]
    mine = _render(world_name, use_bvh)
    diff = np.abs(mine.astype(int) - golden.astype(int)).max(-1)
    frac_close = (diff <= 2).mean()
    assert frac_close >= 0.999, f"{world_name}: only {frac_close:.5f} pixels within 2"
    assert diff.max() <= 8, f"{world_name}: max diff {diff.max()}"


def test_world1_brute_parity():
    _check("world1", use_bvh=False)


def test_world1_culled_parity():
    _check("world1", use_bvh=True)


@pytest.mark.slow
def test_world2_parity():
    _check("world2", use_bvh=True)


@pytest.mark.slow
def test_world4_parity():
    _check("world4", use_bvh=True)


@pytest.mark.slow
def test_world8_parity():
    _check("world8", use_bvh=True)


@pytest.mark.slow
def test_world16_parity():
    _check("world16", use_bvh=True)


@pytest.mark.slow
def test_world8_stress_parity():
    _check("world8_stress", use_bvh=True)
