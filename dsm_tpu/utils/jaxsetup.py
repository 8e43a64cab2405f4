"""Process-wide JAX configuration for dsm-tpu entry points.

The mining episode compiles one level body per frontier-capacity bucket
(mining/engine_device.py), so a cold run can spend much of its time in
XLA.  A persistent compilation cache lets a second process reuse the
first one's programs.  Called by the dsm CLI, bench.py and
chip_smoke.py; library imports never mutate global config.
"""

from __future__ import annotations

import os
import sys


def _checkout_cache() -> str | None:
    """`.cache` at the root of the checkout the package runs from (listed
    in .gitignore; one fixed path, so a second process finds the first
    one's entries), or None for an installed copy, which keeps none."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    if os.path.exists(os.path.join(root, "pyproject.toml")):
        return os.path.join(root, ".cache")
    return None


CHECKOUT_CACHE = _checkout_cache()

_done = False


def cache_dir() -> str | None:
    """Where compiled programs persist: JAX_COMPILATION_CACHE_DIR when
    set, else the checkout's `.cache/jax`, else nowhere (None)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    return None if CHECKOUT_CACHE is None else os.path.join(
        CHECKOUT_CACHE, "jax")


def setup_jax() -> None:
    """Point JAX's persistent compilation cache at cache_dir().  A
    directory that cannot be created leaves the cache off, with a note on
    stderr: caching saves compile time and is never required."""
    global _done
    if _done:
        return
    _done = True
    import jax

    cache = cache_dir()
    if cache is None:
        return
    try:
        os.makedirs(cache, exist_ok=True)
    except OSError as e:
        print(f"dsm: no compilation cache ({e})", file=sys.stderr)
        return
    jax.config.update("jax_compilation_cache_dir", cache)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def require_gpu():
    """The first JAX device, which must be a GPU: measurement and
    smoke-test entry points never fall back to the CPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {dev.platform} "
                         f"({dev.device_kind})")
    return dev


def gpu_name_power() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for every card, one per
    line (the card's name and its power limit travel with every number
    measured on it)."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        raise SystemExit(f"no GPU: nvidia-smi failed ({e})") from e
