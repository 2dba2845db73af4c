"""CLI integration tests: trace.py end-to-end on tiny renders (CPU)."""

import os

import numpy as np
import pytest


def _run(tmp_path, *argv):
    import trace as cli

    out = str(tmp_path / "out")
    rc = cli.main(list(argv) + ["-o", out, "--log-level", "warn"])
    assert rc == 0
    return out


def test_cli_shadow_trace_box(tmp_path):
    out = _run(
        tmp_path,
        "--scene", "box-simple", "-w", "24", "-H", "24",
        "--render-mode", "shadow-trace", "--visualise", "normal",
        "--chunk-size", "576", "--intersector", "dense",
    )
    from ipu_ray_lib_tpu.utils.exr import read_exr

    dev = read_exr(out + "_normal_device.exr")
    oracle = read_exr(out + "_normal_oracle.exr")
    assert dev.shape == (24, 24, 3)
    d = (dev - oracle) ** 2
    assert d.mean() < 1e-3


def test_cli_path_trace_crop(tmp_path):
    out = _run(
        tmp_path,
        "--scene", "box-simple", "-w", "32", "-H", "32",
        "--crop", "8x8+12+12", "--samples", "4", "--chunk-size", "64",
        "--device-only", "--intersector", "dense",
    )
    from ipu_ray_lib_tpu.utils.exr import read_exr

    img = read_exr(out + "_rgb_device.exr")
    assert img.shape == (8, 8, 3)
    assert np.isfinite(img).all()


def test_cli_collada_scene(tmp_path):
    out = _run(
        tmp_path,
        "--mesh-file", "assets/hdri_test.dae", "-w", "16", "-H", "16",
        "--render-mode", "shadow-trace", "--visualise", "id",
        "--chunk-size", "256", "--device-only", "--intersector", "dense",
    )
    from ipu_ray_lib_tpu.utils.exr import read_exr

    img = read_exr(out + "_id_device.exr")
    assert img.max() > 0  # some geometry visible


def test_cli_scene_cache_round_trip(tmp_path):
    """--scene-cache DIR: first run saves the compiled-scene bundle,
    second run loads it and renders the identical image (the user-facing
    twin of the reference's saveExe/loadExe flow, ipu_utils.hpp:51-76)."""
    from ipu_ray_lib_tpu.utils.exr import read_exr

    cache = str(tmp_path / "cache")
    args = ["--scene", "box-simple", "-w", "24", "-H", "24",
            "--samples", "2", "--chunk-size", "576", "--device-only",
            "--intersector", "dense", "--scene-cache", cache]
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    out1 = _run(tmp_path / "a", *args)
    bundles = [f for f in os.listdir(cache) if f.endswith(".tprs")]
    assert len(bundles) == 1
    out2 = _run(tmp_path / "b", *args)
    assert len(os.listdir(cache)) == 1  # second run hit the cache
    a = read_exr(out1 + "_rgb_device.exr")
    b = read_exr(out2 + "_rgb_device.exr")
    np.testing.assert_array_equal(a, b)


def test_cli_rejects_bad_args(tmp_path):
    import trace as cli

    with pytest.raises(SystemExit):
        cli.main(["--visualise", "nonsense"])
    with pytest.raises(RuntimeError):
        cli.main(["--render-mode", "path-trace", "--visualise", "normal"])


@pytest.mark.parametrize("name", ["pallas", "pallas-hbm", "nonsense"])
def test_cli_rejects_unknown_intersector(name):
    """The CLI offers auto, bvh and dense only."""
    import trace as cli

    with pytest.raises(SystemExit):
        cli.main(["--intersector", name])


@pytest.mark.parametrize("name", ["pallas", "pallas-hbm"])
def test_build_scene_rejects_unknown_intersector(name):
    from ipu_ray_lib_tpu.scene.build import build_scene
    from ipu_ray_lib_tpu.scene.builtin import make_cornell_box_scene

    with pytest.raises(ValueError, match="unknown intersector"):
        build_scene(make_cornell_box_scene(mesh_file=None, box_only=True),
                    image_width=8, image_height=8, intersector=name)


def test_cli_stops_without_gpu(tmp_path, monkeypatch):
    """With no GPU and no explicit request for the CPU, trace.py renders
    nothing and exits with an error instead of falling back."""
    import trace as cli

    from ipu_ray_lib_tpu.runtime import config

    monkeypatch.setattr(config, "_cpu_requested", lambda: False)
    out = str(tmp_path / "out")
    rc = cli.main(["--scene", "box-simple", "-w", "8", "-H", "8",
                   "--samples", "1", "--device-only", "-o", out,
                   "--log-level", "off"])
    assert rc == 2
    assert not list(tmp_path.iterdir())
