"""Device checks and the persistent compile cache for scripts run on the GPU.

Every script that measures or smoke-tests on the card calls
:func:`setup_compile_cache` before its first compile and :func:`require_gpu`
before its first device computation: a measurement that finds no GPU
fails, it never falls back to the CPU.
"""
from __future__ import annotations

import os
import subprocess
import sys

#: repository root (the directory holding the package)
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir(environ=os.environ) -> str:
    """Where the persistent compile cache lives: ``JAX_COMPILATION_CACHE_DIR``
    when set, else the fixed ``<repo>/.jax_cache`` (listed in .gitignore;
    a fixed path, since the path is part of the cache key)."""
    return environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        REPO_ROOT, ".jax_cache")


def setup_compile_cache() -> str:
    """Point JAX's persistent compile cache at :func:`compile_cache_dir`.

    When ``JAX_COMPILATION_CACHE_DIR`` is set JAX already reads it, and
    this sets no other directory."""
    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        import jax
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def card_name_and_power() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` lines, one per card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    return out.strip()


def device_summary() -> dict:
    """The device as JAX reports it: platform, device_kind and count."""
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu(min_count: int = 1) -> dict:
    """Exit 1 unless JAX's devices are at least ``min_count`` GPUs; print
    the device summary and the cards' name and power limit to stderr."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < min_count:
        print(f"error: need {min_count} GPU device(s), JAX has "
              f"{len(devs)} {devs[0].platform} device(s)", file=sys.stderr)
        sys.exit(1)
    summary = device_summary()
    print(f"device: {summary}", file=sys.stderr)
    print(f"card: {card_name_and_power()}", file=sys.stderr)
    return summary


def time_ms(fn, reps: int) -> list:
    """Host-clock milliseconds of ``reps`` calls of ``fn()``, each ended by
    ``jax.block_until_ready`` (after one untimed warm-up call)."""
    import time
    import jax
    jax.block_until_ready(fn())
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        out.append((time.perf_counter() - t0) * 1e3)
    return out
