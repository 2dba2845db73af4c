"""Compile-progress observability (ref CallbackFilter, ipu_utils.hpp:476-518)
and the compile-only AOT mode (ref RuntimeConfig::compileOnly, :581-584).
"""

import logging
import time

import pytest


def test_compile_progress_heartbeat_and_summary(caplog):
    from ipu_ray_lib_tpu.runtime.config import CompileProgress

    with caplog.at_level(logging.INFO, logger="ipu_ray_lib_tpu"):
        with CompileProgress("unit-test", interval=0.02):
            time.sleep(0.12)
    beats = [r for r in caplog.records if "elapsed" in r.getMessage()]
    summaries = [r for r in caplog.records if r.getMessage().startswith("Compiled unit-test")]
    assert len(beats) >= 2          # throttled heartbeats while "compiling"
    assert len(summaries) == 1      # one final duration line


def test_compile_progress_no_summary_on_error(caplog):
    from ipu_ray_lib_tpu.runtime.config import CompileProgress

    with caplog.at_level(logging.INFO, logger="ipu_ray_lib_tpu"):
        with pytest.raises(ValueError):
            with CompileProgress("boom", interval=60.0):
                raise ValueError("compile failed")
    assert not [r for r in caplog.records if "Compiled boom" in r.getMessage()]


def test_compile_event_listener_fires(caplog):
    """The jax.monitoring listener reports finished XLA compilations."""
    import jax
    import jax.numpy as jnp

    from ipu_ray_lib_tpu.runtime.config import install_compile_event_logging

    install_compile_event_logging()
    install_compile_event_logging()  # idempotent

    salt = float(int(time.time() * 997) % 100003)  # fresh HLO every run

    @jax.jit
    def _fresh(x):
        return jnp.sin(x) * salt   # unique constant => never cache-warm

    with caplog.at_level(logging.DEBUG, logger="ipu_ray_lib_tpu"):
        _fresh(jnp.ones((8,))).block_until_ready()
    assert [r for r in caplog.records if r.getMessage().startswith("XLA ")]


def test_cli_compile_only_path_trace(tmp_path):
    """--compile-only AOT-compiles the streaming program and exits 0
    without writing any image."""
    import trace as cli

    out = str(tmp_path / "out")
    rc = cli.main([
        "--scene", "box-simple", "-w", "16", "-H", "16",
        "--samples", "2", "--max-path-length", "2", "--chunk-size", "256",
        "--device-only", "--intersector", "dense", "--compile-only",
        "-o", out, "--log-level", "warn",
    ])
    assert rc == 0
    assert not list(tmp_path.iterdir())  # nothing executed, nothing written


def test_cli_compile_only_shadow_trace(tmp_path):
    import trace as cli

    out = str(tmp_path / "out")
    rc = cli.main([
        "--scene", "box-simple", "-w", "16", "-H", "16",
        "--render-mode", "shadow-trace", "--visualise", "normal",
        "--chunk-size", "256", "--device-only", "--intersector", "dense",
        "--compile-only", "-o", out, "--log-level", "warn",
    ])
    assert rc == 0
    assert not list(tmp_path.iterdir())
