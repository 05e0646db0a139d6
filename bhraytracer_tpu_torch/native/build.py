"""Build and load the host-side native helper (g++ -> .so, loaded with ctypes).

The library is built at first use from `bhrt_native.cpp` into the
checkout's git-ignored `build/` directory, under a name keyed by a hash of
the source, so an edited source is rebuilt and a stale library is never
loaded. Every native entry point has a pure-Python fallback (`get_lib()`
returns None when no compiler is present).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_SRC = os.path.join(os.path.dirname(__file__), "bhrt_native.cpp")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build")
_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]


def library_path() -> str:
    with open(_SRC, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"bhrt_native_{h[:16]}.so")


def _build(so_path: str) -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *_FLAGS, "-o", tmp, _SRC], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so_path)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def get_lib():
    """Returns the loaded ctypes library, or None."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        so_path = library_path()
        if not os.path.exists(so_path) and not _build(so_path):
            return None
        try:
            lib = ctypes.CDLL(so_path)
        except OSError:
            return None
        lib.bhrt_png_unfilter.restype = ctypes.c_int
        lib.bhrt_png_unfilter.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ]
        lib.bhrt_bvh_build.restype = ctypes.c_int64
        lib.bhrt_bvh_build.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.bhrt_obj_load.restype = ctypes.c_void_p
        lib.bhrt_obj_load.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
        lib.bhrt_obj_fill.restype = ctypes.c_int
        lib.bhrt_obj_fill.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 9
        lib.bhrt_obj_free.restype = None
        lib.bhrt_obj_free.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return _LIB


def have_native() -> bool:
    return get_lib() is not None
