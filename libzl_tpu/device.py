"""Where the engine runs: the backend decision and the compile cache.

One function decides whether the engine renders with jax on an
accelerator or with the numpy host mirror, from the device JAX finds.
The numpy backend is the host-only deployment the reference itself
targets (a Raspberry Pi-class unit with no accelerator); anywhere JAX
has an accelerator the engine renders there. Nothing falls back
silently: an explicit request is honoured as given, and the device the
engine chose is logged once and reported by `AudioEngine.stats()`.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path

BACKENDS = ("jax", "numpy")

# the persistent XLA compile cache when JAX_COMPILATION_CACHE_DIR is unset:
# one fixed directory inside the checkout (listed in .gitignore)
CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"

log = logging.getLogger("libzl_tpu")


def resolve_backend(requested: str = "auto") -> str:
    """"jax" or "numpy" for a requested backend ("auto", "jax", "numpy").

    "auto" picks "jax" whenever JAX's default backend is an accelerator
    (the GPU) and "numpy" only when it is the host CPU."""
    if requested in BACKENDS:
        return requested
    if requested != "auto":
        raise ValueError(
            f"backend must be auto|jax|numpy, got {requested!r}")
    import jax

    return "numpy" if jax.default_backend() == "cpu" else "jax"


def device_info(backend: str, mesh=None) -> dict:
    """Platform, device kind and count the engine renders on."""
    if backend == "numpy":
        return {"platform": "cpu", "device_kind": "numpy host mirror",
                "device_count": 0}
    import jax

    # without a mesh the engine renders on the default device alone
    devices = (list(mesh.devices.flat) if mesh is not None
               else jax.devices()[:1])
    return {"platform": devices[0].platform,
            "device_kind": devices[0].device_kind,
            "device_count": len(devices)}


def compile_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else the checkout's CACHE_DIR."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(CACHE_DIR)


def use_compile_cache() -> str:
    """Point JAX's persistent compile cache at `compile_cache_dir()` unless
    a directory is already configured (JAX reads JAX_COMPILATION_CACHE_DIR
    itself; an explicit jax.config setting wins). Returns the directory in
    use."""
    import jax

    current = jax.config.jax_compilation_cache_dir
    if current:
        return current
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
