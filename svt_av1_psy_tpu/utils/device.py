"""Device platform choice and the persistent compilation cache.

The encoder's device programs run on a GPU in production and on the CPU
in tests. The platform is chosen once, plainly: a platform that was asked
for and is missing is an error, never a silent switch to another one.
"""

from __future__ import annotations

import os
import pathlib
import shutil
import subprocess

# the repository checkout: <checkout>/svt_av1_psy_tpu/utils/device.py
CHECKOUT = pathlib.Path(__file__).resolve().parents[2]

PLATFORMS = ("gpu", "cpu")


def default_platform() -> str:
    """The platform JAX_PLATFORMS names first ('cpu' stays cpu, any
    accelerator name means the GPU), or 'gpu' where it is unset."""
    first = os.environ.get("JAX_PLATFORMS", "").split(",")[0].strip()
    return "cpu" if first == "cpu" else "gpu"


def select_platform(preferred: str | None = None) -> str:
    """Pin the JAX platform for this process and return it.

    preferred: 'gpu' or 'cpu'; None takes default_platform(). Call it
    before the first JAX computation. Raises RuntimeError where the
    platform has no device, or where JAX already runs on another one."""
    if preferred is None:
        preferred = default_platform()
    if preferred not in PLATFORMS:
        raise ValueError(f"platform must be one of {PLATFORMS}, "
                         f"got {preferred!r}")
    import jax
    if preferred == "cpu":
        # before backend initialization this keeps the GPU untouched
        jax.config.update("jax_platforms", "cpu")
    try:
        jax.devices(preferred)
    except RuntimeError as e:
        raise RuntimeError(
            f"no {preferred} device for the encoder's device programs "
            f"({e})") from None
    if jax.default_backend() != preferred:
        raise RuntimeError(
            f"{preferred} requested, but JAX already runs on "
            f"{jax.default_backend()}")
    return preferred


def configure_compile_cache() -> str:
    """Place JAX's persistent compilation cache and return its directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX's own setting stands and
    no directory is set here; otherwise the cache goes to
    <checkout>/.jax_cache. Idempotent."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    path = str(CHECKOUT / ".jax_cache")
    if jax.config.jax_compilation_cache_dir != path:
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def gpu_name_and_power_limit() -> str | None:
    """The first card's 'name, power limit' as nvidia-smi prints them,
    or None where nvidia-smi is missing or fails. Stays off JAX."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    try:
        r = subprocess.run([exe, "--query-gpu=name,power.limit",
                            "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = r.stdout.strip().splitlines()
    return lines[0].strip() if r.returncode == 0 and lines else None
