import numpy as np

from raytracer.mt19937 import MT19937


def test_known_first_output_default_seed():
    # Classic MT19937 reference value: seed 5489 -> first output 3499211612.
    g = MT19937(5489)
    assert g.next_u32() == 3499211612


def test_known_outputs_seed_1():
    # init_genrand(1) first outputs (authoritative MT19937 vector).
    g = MT19937(1)
    vals = [g.next_u32() for _ in range(5)]
    assert vals[0] == 1791095845


def test_uniform_real_matches_float_division():
    g1 = MT19937(42)
    g2 = MT19937(42)
    for _ in range(100):
        u = g1.uniform_real_f32()
        raw = g2.next_u32()
        expect = np.float32(np.float32(raw) / np.float32(2.0**32))
        if expect >= np.float32(1.0):
            expect = np.nextafter(np.float32(1.0), np.float32(0.0))
        assert u == expect
        assert 0.0 <= float(u) < 1.0


def test_uniform_uint_passthrough():
    g1 = MT19937(7)
    g2 = MT19937(7)
    for _ in range(10):
        assert g1.uniform_uint() == g2.next_u32()
