"""Tests that need the card: chip_smoke.py's checks at small sizes on the
GPU. They skip elsewhere; run them on the GPU machine with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/ -p no:xdist
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

pytestmark = pytest.mark.gpu


def test_goldens_on_card(gpu):
    import chip_smoke

    chip_smoke.phase_goldens()


def test_shadow_vs_oracle_on_card(gpu):
    import chip_smoke

    chip_smoke.phase_shadow(size=256, crop=64)


def test_nif_mlp_vs_numpy_on_card(gpu):
    import chip_smoke

    chip_smoke.phase_nif(size=128, spp=4, n_dirs=16384)


def test_stress_bvh_vs_oracle_on_card(gpu):
    import chip_smoke

    chip_smoke.phase_stress(grid=256, size=256, spp=2, crop=64)


def test_cornell_dense_vs_bvh_on_card(gpu):
    import chip_smoke

    chip_smoke.phase_cornell(size=256, spp=4, mean_band=(0.05, 0.08))
