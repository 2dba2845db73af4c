"""Test configuration: by default JAX runs on a virtual 8-device CPU mesh.

This mirrors the reference's hardware-free testing strategy (the Poplar
IPUModel simulator + compileOnly, ref include/ipu_utils.hpp:98-106): the
default suite runs on the CPU backend, with 8 virtual devices so
multi-device sharding paths are exercised without a multi-GPU host.

``JAX_PLATFORMS`` defaults to ``cpu`` but a value already set wins, so
the tests marked ``gpu`` run on the card with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/ -p no:xdist

Whether a card is present is decided inside the ``gpu`` fixture, never
at import or collection time, so every xdist worker collects the same
tests.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: run with JAX_PLATFORMS=cuda "
                    "python -m pytest -m gpu tests/ -p no:xdist")
    return jax.devices()[0]


@pytest.fixture(scope="session")
def cornell_scene():
    from ipu_ray_lib_tpu.scene.builtin import make_cornell_box_scene

    return make_cornell_box_scene(mesh_file=None, box_only=False)


@pytest.fixture(scope="session")
def cornell_built(cornell_scene):
    from ipu_ray_lib_tpu.scene.build import build_scene

    return build_scene(cornell_scene, image_width=128, image_height=128)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1442)
