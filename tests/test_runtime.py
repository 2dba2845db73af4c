"""Runtime rules: where the compile cache lives, which backend renders,
the entry points that refuse to run without a GPU, and ``auto``'s
intersector table."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_COMPILE = (
    "import sys; sys.path.insert(0, {root!r})\n"
    "import jax, jax.numpy as jnp\n"
    "from ipu_ray_lib_tpu.runtime.config import setup_compilation_cache\n"
    "d = setup_compilation_cache()\n"
    "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
    "jax.jit(lambda x: jnp.sin(x) * {salt})(jnp.ones(7)).block_until_ready()\n"
    "print(d)\n"
    "print(jax.config.jax_compilation_cache_dir)\n"
)


def _run_compile(env, salt):
    env = dict(env, JAX_PLATFORMS="cpu",
               JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES="0")
    out = subprocess.run(
        [sys.executable, "-c", _COMPILE.format(root=ROOT, salt=salt)],
        env=env, capture_output=True, text=True, timeout=300, check=True)
    return out.stdout.split()


def _entries(d):
    return set(os.listdir(d)) if os.path.isdir(d) else set()


def test_cache_dir_from_env(tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: the cache lands there, and the
    default directory gets nothing."""
    from ipu_ray_lib_tpu.runtime.config import DEFAULT_CACHE_DIR

    cache = str(tmp_path / "cache")
    before = _entries(DEFAULT_CACHE_DIR)
    used, configured = _run_compile(
        dict(os.environ, JAX_COMPILATION_CACHE_DIR=cache), 3.25)
    assert used == configured == cache
    assert _entries(cache)
    assert _entries(DEFAULT_CACHE_DIR) == before


def test_cache_dir_default_is_checkout():
    """JAX_COMPILATION_CACHE_DIR unset: <checkout>/.jax_cache."""
    from ipu_ray_lib_tpu.runtime.config import DEFAULT_CACHE_DIR

    assert DEFAULT_CACHE_DIR == os.path.join(ROOT, ".jax_cache")
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    before = _entries(DEFAULT_CACHE_DIR)
    used, configured = _run_compile(env, os.getpid() + 0.5)
    assert used == configured == DEFAULT_CACHE_DIR
    assert _entries(DEFAULT_CACHE_DIR) - before


def test_compilation_cache_dir_rule(monkeypatch, tmp_path):
    from ipu_ray_lib_tpu.runtime import config

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert config.compilation_cache_dir() == str(tmp_path)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert config.compilation_cache_dir() == config.DEFAULT_CACHE_DIR


@pytest.mark.parametrize("entry", ["trace", "bench", "chip_smoke"])
def test_entry_points_set_up_the_cache(entry, monkeypatch, tmp_path):
    sys.path.insert(0, ROOT)
    from ipu_ray_lib_tpu.runtime import config

    calls = []
    monkeypatch.setattr(config, "setup_compilation_cache",
                        lambda: calls.append(1) or str(tmp_path))
    if entry == "trace":
        import trace as cli

        assert cli.main(["--scene", "box-simple", "-w", "8", "-H", "8",
                         "--samples", "1", "--max-path-length", "2",
                         "--device-only", "--intersector", "dense",
                         "-o", str(tmp_path / "o"), "--log-level", "off"]) == 0
    elif entry == "bench":
        import bench

        assert bench.main() == 1      # no GPU here: stops after the set-up
    else:
        import chip_smoke

        monkeypatch.setattr(chip_smoke, "card_info", lambda: "test card, 0 W")
        chip_smoke.phase_device(1)
    assert calls == [1]


def test_bench_refuses_cpu(capsys):
    sys.path.insert(0, ROOT)
    import bench

    assert bench.main() == 1
    out = capsys.readouterr()
    assert out.out == ""
    assert "no GPU" in out.err


def test_chip_smoke_refuses_cpu(capsys):
    sys.path.insert(0, ROOT)
    import chip_smoke

    assert chip_smoke.main([]) == 1
    out = capsys.readouterr()
    assert out.out == ""
    assert "no GPU" in out.err


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the
    repo, the script fails and prints no result."""
    import shutil

    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("use_cpu", [True, False])
def test_select_backend(use_cpu, monkeypatch):
    """The CPU renders only when asked for; otherwise no GPU is an error."""
    from ipu_ray_lib_tpu.runtime import config

    monkeypatch.setattr(config, "_cpu_requested", lambda: use_cpu)
    if use_cpu:
        assert config.select_backend() == "cpu"
    else:
        with pytest.raises(config.NoGpuError):
            config.select_backend()


@pytest.mark.parametrize("requested,prims,want", [
    ("auto", 1, "dense"),
    ("auto", 4035, "dense"),                # Cornell box + monkey plinth
    ("auto", "threshold", "dense"),
    ("auto", "threshold+1", "bvh"),
    ("auto", 2093058, "bvh"),               # make_stress_scene(1024)
    ("bvh", 10, "bvh"),
    ("dense", 10 ** 6, "dense"),
])
def test_auto_intersector_table(requested, prims, want):
    from ipu_ray_lib_tpu.scene.build import (AUTO_DENSE_MAX_PRIMS,
                                             resolve_intersector)

    if prims == "threshold":
        prims = AUTO_DENSE_MAX_PRIMS
    elif prims == "threshold+1":
        prims = AUTO_DENSE_MAX_PRIMS + 1
    assert resolve_intersector(requested, prims) == want
