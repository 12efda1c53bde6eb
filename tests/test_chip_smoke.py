"""chip_smoke.py's phases rehearsed on the CPU at tiny sizes, kernels in the
interpreter: the same control flow, comparisons and sharding rules the GPU
run uses (the 4-card phase on 4 of the virtual CPU devices).  The script
itself must refuse to run without a GPU."""

import os
import subprocess
import sys

import jax
import pytest

import chip_smoke

TINY = chip_smoke.Sizes(frame=(64, 48), incoherent=512, train=(64, 32),
                        spp=2, grad_frame=(48, 32), four_spp=2)


def test_smoke_kernels_phase():
    chip_smoke.kernels(TINY, interpret=True)


def test_smoke_render_phase():
    chip_smoke.render(TINY, interpret=True)


def test_smoke_train_phase():
    chip_smoke.train(TINY, interpret=True)
    assert not os.path.exists(chip_smoke.SCRATCH)


def test_smoke_four_phase():
    assert len(jax.devices()) >= 4
    chip_smoke.four(jax.devices(), TINY, interpret=True)


def test_smoke_check_raises():
    with pytest.raises(chip_smoke.SmokeFailure, match="nope"):
        chip_smoke.check(False, "nope")


def test_smoke_refuses_cpu():
    """Without a GPU the script fails at the device check: nonzero exit and
    no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, chip_smoke.__file__],
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=os.path.dirname(chip_smoke.__file__))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "platform is gpu" in proc.stderr
