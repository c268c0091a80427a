"""Shared loader for the on-demand-built native libraries (native/*.cpp).

One implementation of the build-with-g++ + dlopen + ABI-check pattern used
by the host core (engine/hostcore.py), the WSOLA stretcher
(ops/stretch_native.py) and the FLAC decoder (io/flac.py). Each library is
built lazily the first time it is requested, cached per process, and
degrades to None (callers gate on availability) when no compiler exists.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"

_cache: dict[str, Optional[ctypes.CDLL]] = {}
_lock = threading.Lock()


def _build(stem: str, opt: str) -> Optional[Path]:
    src = NATIVE_DIR / f"{stem}.cpp"
    so = NATIVE_DIR / f"{stem}.so"
    if not src.exists():
        return None
    if so.exists() and so.stat().st_mtime >= src.stat().st_mtime:
        return so
    # build to a private name, then rename: several processes (test
    # workers) may build at once, and none may load a half-written file
    tmp = so.with_name(f".{so.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(
            ["g++", opt, "-fPIC", "-shared", "-std=c++17",
             "-o", str(tmp), str(src)],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, so)
        return so
    except Exception:
        tmp.unlink(missing_ok=True)
        return None


def load_native(
    stem: str, abi_symbol: str, abi_version: int, opt: str = "-O2"
) -> Optional[ctypes.CDLL]:
    """Build (if stale/missing) and load native/<stem>.so; verify its
    `<abi_symbol>()` returns `abi_version`. Returns None when the library
    cannot be built or fails the check; the result (including failure) is
    cached for the process."""
    if stem in _cache:
        return _cache[stem]
    with _lock:
        if stem in _cache:
            return _cache[stem]
        lib = None
        so = _build(stem, opt)
        if so is not None:
            try:
                candidate = ctypes.CDLL(str(so))
                if getattr(candidate, abi_symbol)() == abi_version:
                    lib = candidate
            except (OSError, AttributeError):
                lib = None
        _cache[stem] = lib
        return lib
