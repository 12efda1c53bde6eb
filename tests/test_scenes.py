"""The in-repo scenes (scenes/*.json) and the name resolver: every scene
loads by bare name, and keeps the features the fixture family is defined by
(seed 42, grid sizes 1..16, one point + one directional light, refraction
with eta < 1 in the grid-1 scene, a third reflective cube type at 5x
unit_length in the stress scene)."""

import json
import os

import numpy as np
import pytest

from raytracer import generate
from raytracer.cube_world import SCENES_DIR, resolve_config

GRIDS = {"cubes1": 1, "cubes2": 2, "cubes4": 4, "cubes8": 8, "cubes16": 16,
         "cubes8_stress": 8}


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_scene_loads_by_bare_name(name):
    path = os.path.join(SCENES_DIR, name + ".json")
    assert resolve_config(name) == path
    assert resolve_config(name + ".json") == path
    doc = json.load(open(path))
    assert doc["seed"] == 42 and doc["grid_size"] == GRIDS[name]
    w = generate(name)
    assert w.grid_size == GRIDS[name]
    lights = w.scene.lights
    assert lights.point_pos.shape[0] == 1 and lights.dir_dir.shape[0] == 1
    assert w.scene.inst_pos.shape[0] >= GRIDS[name] ** 2


def test_scene_features():
    c1 = generate("cubes1")
    kt = np.asarray(c1.scene.materials.kt)
    eta = np.asarray(c1.scene.materials.eta)
    refractive = (kt > 0).any(-1)
    assert refractive.any() and (eta[refractive] < 1.0).all()
    assert c1.config.any_refractive and c1.config.recurse_depth > 0

    base = json.load(open(resolve_config("cubes8")))
    stress = json.load(open(resolve_config("cubes8_stress")))
    assert len(stress["cubes"]) == len(base["cubes"]) + 1
    assert "Kr" in stress["cubes"][-1]
    assert stress["unit_length"] == 5 * base["unit_length"]
    assert generate("cubes8_stress").config.any_reflective


def test_resolve_config_missing():
    with pytest.raises(FileNotFoundError, match="bare names"):
        resolve_config("no_such_scene")
    with pytest.raises(FileNotFoundError):
        resolve_config(os.path.join("no", "such.json"))
