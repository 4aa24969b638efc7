"""Native (C++) runtime components, loaded via ctypes.

The compute path of srt is JAX/XLA/Pallas on the GPU; this package
holds the host-runtime pieces that are hot *outside* XLA — currently the
binned-SAH BVH builder (``bvh_builder.cpp``), the srt analogue of the
reference's ``bvh_node`` constructor chain (``Raytracing_n/bvh.h:21-55``).

The shared library is compiled on first use with the system ``g++`` and
cached next to the sources; set ``SRT_NO_NATIVE=1`` to force the pure
numpy fallbacks (used by the fallback-equivalence tests).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "_srt_native.so")
_SRC = [os.path.join(_DIR, "bvh_builder.cpp")]
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_failed = False


def _compile() -> bool:
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
           "-o", _SO] + _SRC
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except (subprocess.SubprocessError, FileNotFoundError):
        return False


def get_lib() -> ctypes.CDLL | None:
    """The native library, or None (=> callers use the numpy fallback)."""
    global _lib, _failed
    if os.environ.get("SRT_NO_NATIVE"):
        return None
    if _lib is not None or _failed:
        return _lib
    with _lock:
        if _lib is not None or _failed:
            return _lib
        newest_src = max(os.path.getmtime(s) for s in _SRC)
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < newest_src:
            if not _compile():
                _failed = True
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            _failed = True
            return None
        lib.srt_build_bvh.restype = ctypes.c_int64
        lib.srt_build_bvh.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)]
        _lib = lib
        return _lib
