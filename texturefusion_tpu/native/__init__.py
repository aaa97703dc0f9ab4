"""Native (C++) host-runtime components, built lazily with g++ + ctypes.

The reference's host runtime is all C++ (SURVEY.md); this framework
keeps its *hot host paths* native too: the chunk-slot allocator /
candidate-ID deduplicator (chunk_alloc.cpp) and PNG scanline
unfiltering for the image reader (png_unfilter.cpp). Python fallbacks
exist for environments without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_DIR, "_build", "libtfnative.so")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Optional[str]:
    srcs = [os.path.join(_DIR, f) for f in ("chunk_alloc.cpp",
                                            "png_unfilter.cpp")]
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    if (os.path.exists(_LIB_PATH) and os.path.getmtime(_LIB_PATH)
            >= max(os.path.getmtime(s) for s in srcs)):
        return _LIB_PATH
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
           *srcs, "-o", _LIB_PATH]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return _LIB_PATH
    except (subprocess.CalledProcessError, FileNotFoundError,
            subprocess.TimeoutExpired):
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, building it on first use; None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = _build()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    i64 = ctypes.c_int64
    p = ctypes.c_void_p
    lib.ca_create.restype = p
    lib.ca_create.argtypes = [i64]
    lib.ca_destroy.argtypes = [p]
    lib.ca_count.restype = i64
    lib.ca_count.argtypes = [p]
    lib.ca_touch.restype = i64
    lib.ca_touch.argtypes = [p, ctypes.c_void_p, i64, ctypes.c_int32,
                             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.ca_lookup.argtypes = [p, ctypes.c_void_p, i64, ctypes.c_void_p]
    lib.ca_release.argtypes = [p, ctypes.c_void_p, i64]
    lib.ca_export.argtypes = [p, ctypes.c_void_p, ctypes.c_void_p]
    lib.ca_import.argtypes = [p, ctypes.c_void_p, ctypes.c_void_p, i64]
    lib.png_unfilter.restype = ctypes.c_int32
    lib.png_unfilter.argtypes = [p, i64, i64, i64, p]
    _lib = lib
    return _lib
