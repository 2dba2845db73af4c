"""chip_smoke.py's phases, rehearsed on the CPU at tiny sizes.

The script itself refuses to run without a GPU (tests/test_runtime.py);
its phase functions take their sizes as arguments, so the same code
paths, checks and references run here on small frames. Tolerances that
only hold at the full frame (the Cornell image-mean band, the four-card
1% mean match) are widened for these sizes by argument.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def test_phase_cornell_small():
    times = chip_smoke.phase_cornell(size=32, spp=4, mean_band=(0.0, 1.0))
    assert set(times) == {"dense", "bvh"}


def test_phase_goldens():
    chip_smoke.phase_goldens()


def test_phase_shadow_small():
    chip_smoke.phase_shadow(size=64, crop=32)


def test_phase_nif_small():
    chip_smoke.phase_nif(size=32, spp=2, n_dirs=4096)


def test_phase_stress_small():
    # 2 * 89^2 = 15,842 triangles: past auto's dense threshold. (At grid
    # 47 or 65 the centred crop's rays run along the grid's own edge
    # lines, and ties between the two triangles of an edge pick either.)
    chip_smoke.phase_stress(grid=90, size=64, spp=1, crop=32)


def test_phase_four_cards_small():
    chip_smoke.phase_four_cards(size=32, spp=8, n_cards=4, mean_tol=0.3)


def test_check_raises_on_failure():
    chip_smoke.check(True, "passes")
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check(False, "fails")
