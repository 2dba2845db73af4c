"""Runtime configuration and device/session management.

The equivalent of the reference's runtime framework
(ref: include/ipu_utils.hpp — RuntimeConfig:174-183, DeferredDevice:79-172,
GraphManager:523-610, executable caching:51-76):

* device acquisition: enumerate devices and require a GPU, or the CPU
  when it is asked for explicitly (the reference's IPUModel-simulator
  analogue) — never a silent fallback;
* executable caching: the JAX persistent compilation cache replaces
  saveExe/loadExe + the program-name registry (compiled executables are
  keyed by HLO, so "re-run by name" is automatic);
* compile-only mode: AOT lowering/compilation without execution.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass

from ..utils.log import logger


@dataclass
class RuntimeConfig:
    """Run-level knobs (role of ref RuntimeConfig, ipu_utils.hpp:174-183)."""

    num_devices: int = 0          # 0 = all available (ref: numIpus)
    use_cpu: bool = False         # CPU backend (ref: useIpuModel simulator)
    compile_only: bool = False    # AOT compile without running


# <checkout>/.jax_cache: the cache directory when JAX_COMPILATION_CACHE_DIR
# is not set (listed in .gitignore):
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def compilation_cache_dir() -> str:
    """Where the persistent compilation cache lives:
    ``JAX_COMPILATION_CACHE_DIR`` when set, else :data:`DEFAULT_CACHE_DIR`."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def setup_compilation_cache() -> str:
    """Enable the persistent compilation cache (ref saveExe/loadExe role)
    in :func:`compilation_cache_dir`; returns that directory."""
    import jax

    cache_dir = compilation_cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    logger().debug("Compilation cache at %s", cache_dir)
    return cache_dir


class NoGpuError(RuntimeError):
    """No GPU is visible to JAX and the CPU was not asked for."""


def require_gpu() -> None:
    """Raise :class:`NoGpuError` unless JAX's default backend is a GPU.
    Measurement entry points call this first: a number taken on the CPU
    must never pass for one taken on the card."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise NoGpuError(
            f"no GPU found (JAX backend is '{backend}'); this entry point "
            "measures the card and does not fall back to the CPU")


def _cpu_requested() -> bool:
    """Whether JAX was told to use the CPU alone (``JAX_PLATFORMS=cpu``
    or ``jax.config.update("jax_platforms", "cpu")``)."""
    import jax

    return (jax.config.jax_platforms or "").strip() == "cpu"


def select_backend(use_cpu: bool = False) -> str:
    """The backend a render runs on: the GPU, or the CPU only when asked
    for (``use_cpu`` or ``JAX_PLATFORMS=cpu``). Raises
    :class:`NoGpuError` when there is no GPU and the CPU was not asked
    for. Returns JAX's platform name."""
    import jax

    if use_cpu:
        jax.config.update("jax_platforms", "cpu")
    backend = jax.default_backend()
    if backend == "gpu":
        return backend
    if backend == "cpu" and _cpu_requested():
        return backend
    raise NoGpuError(
        f"no GPU found (JAX backend is '{backend}'); set JAX_PLATFORMS=cpu "
        "to render on the CPU")


def acquire_devices(config: RuntimeConfig):
    """Device acquisition (role of ref DeferredDevice).

    Returns the list of devices to use: GPUs, or CPU devices when
    ``config.use_cpu`` or ``JAX_PLATFORMS=cpu`` asks for them. Raises
    :class:`NoGpuError` otherwise when no GPU is usable (the reference
    exhausts attach attempts similarly, ipu_utils.hpp:143-159).
    """
    import jax

    log = logger()
    t0 = time.time()
    select_backend(config.use_cpu)
    devices = jax.devices()
    log.info(
        "Acquired %d device(s) on platform '%s' (%s) in %.1fs",
        len(devices), devices[0].platform, devices[0].device_kind,
        time.time() - t0,
    )
    if config.num_devices > 0:
        if len(devices) < config.num_devices:
            log.warning(
                "Requested %d devices, only %d available",
                config.num_devices, len(devices),
            )
        devices = devices[: config.num_devices]
    return devices


class CompileProgress:
    """Compile-progress observability (role of the reference's
    CallbackFilter, ipu_utils.hpp:476-518).

    The reference intercepts poplar's compile-progress callbacks and
    throttles them into readable log lines. XLA exposes no percentage
    callback, so the analogue here has two halves:

    * this context manager — a heartbeat thread that logs elapsed time
      at a throttled cadence while a (possibly multi-minute) lowering/
      compilation runs, so long compiles show liveness instead of
      silence; and
    * :func:`install_compile_event_logging` — a ``jax.monitoring``
      listener that reports each finished backend compilation with its
      duration (filtered: slow compiles at info, the rest at debug —
      the same noise-throttling job CallbackFilter does).
    """

    def __init__(self, name: str, interval: float = 15.0):
        self.name = name
        self.interval = interval
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.t0 = 0.0

    def __enter__(self):
        self.t0 = time.time()
        self._thread = threading.Thread(target=self._beat, daemon=True)
        self._thread.start()
        return self

    def _beat(self):
        while not self._stop.wait(self.interval):
            logger().info(
                "Compiling %s ... %.0fs elapsed", self.name, time.time() - self.t0
            )

    def __exit__(self, exc_type, exc, tb):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
        if exc_type is None:
            logger().info(
                "Compiled %s in %.1fs", self.name, time.time() - self.t0
            )
        return False


_compile_listener_installed = False


def install_compile_event_logging(info_threshold_secs: float = 5.0) -> None:
    """Log XLA backend compilations as they finish (CallbackFilter role,
    ref ipu_utils.hpp:476-518). Compiles longer than
    ``info_threshold_secs`` log at info, the rest at debug — the filter
    half of the contract (poplar fires thousands of progress callbacks;
    jax.monitoring fires one duration event per compile stage, so
    throttling here is by significance rather than cadence).

    Idempotent; safe to call from the CLI and library entry points.
    """
    global _compile_listener_installed
    if _compile_listener_installed:
        return
    import jax.monitoring

    def _on_duration(event: str, duration: float, **kwargs) -> None:
        if "compile" not in event:
            return
        log = logger()
        msg = "XLA %s: %.1fs"
        if duration >= info_threshold_secs:
            log.info(msg, event.strip("/"), duration)
        else:
            log.debug(msg, event.strip("/"), duration)

    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    _compile_listener_installed = True


def compile_only(fn, *example_args, _name: str | None = None, **jit_kwargs):
    """AOT-compile a jittable function without executing it
    (ref compileOnly, ipu_utils.hpp:581-584). Returns the compiled object.

    The compile runs under a :class:`CompileProgress` heartbeat and lands
    in the persistent compilation cache (when enabled), so a later real
    run loads the executable instead of recompiling — the reference's
    compile-then-saveExe workflow."""
    import jax

    name = _name or getattr(fn, "__name__", "fn")
    with CompileProgress(name):
        lowered = jax.jit(fn, **jit_kwargs).lower(*example_args)
        compiled = lowered.compile()
    logger().info("Compiled %s: %s", name, compiled.memory_analysis())
    return compiled
