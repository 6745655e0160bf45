"""Native (C++) host-side runtime components, loaded via ctypes.

The reference's runtime is entirely native (NDK C++ — SURVEY.md §2.1); this
framework keeps its *device* path in JAX/XLA and implements the genuinely
host-bound runtime pieces in C++: the DBoW2 vocabulary text parser (~1M-line
files) and the dataset image decoder (PNG/PGM). Both degrade gracefully to
Python fallbacks when the shared library cannot be built.

The library is not committed: it is built from the sources here on first
use (needs g++ and zlib), into this directory:
    g++ -O2 -shared -fPIC -o libwsnative.so voc_loader.cpp image_io.cpp -lz
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_DIR, "libwsnative.so")
_lock = threading.Lock()
_lib = None
_build_failed = False


class _VocData(ctypes.Structure):
    _fields_ = [
        ("k", ctypes.c_int32),
        ("L", ctypes.c_int32),
        ("n_nodes", ctypes.c_int64),
        ("parents", ctypes.POINTER(ctypes.c_int64)),
        ("is_leaf", ctypes.POINTER(ctypes.c_uint8)),
        ("descs", ctypes.POINTER(ctypes.c_uint8)),
        ("weights", ctypes.POINTER(ctypes.c_double)),
    ]


def _build() -> bool:
    sources = [os.path.join(_DIR, "voc_loader.cpp"), os.path.join(_DIR, "image_io.cpp")]
    # build under a private name, then rename: concurrent processes never
    # load a half-written library
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, *sources, "-lz"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB_PATH)
        return True
    except Exception:
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def get_lib():
    """The loaded shared library, building it on first use; None if
    unavailable (callers fall back to Python)."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        if not os.path.exists(_LIB_PATH) and not _build():
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            _build_failed = True
            return None
        lib.voc_load_text.restype = ctypes.POINTER(_VocData)
        lib.voc_load_text.argtypes = [ctypes.c_char_p]
        lib.voc_free.argtypes = [ctypes.POINTER(_VocData)]
        lib.image_load_gray.restype = ctypes.c_int
        lib.image_load_gray.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.image_load_depth16.restype = ctypes.c_int
        lib.image_load_depth16.argtypes = lib.image_load_gray.argtypes
        lib.image_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        _lib = lib
        return _lib


def load_dbow2_text_native(path: str):
    """Parse a DBoW2 text vocabulary with the C++ parser.

    Returns (k, L, dict(parent, is_leaf, desc, weight)) or None if the
    native library is unavailable (use bow.vocabulary.load_dbow2_text then).
    """
    lib = get_lib()
    if lib is None:
        return None
    vp = lib.voc_load_text(path.encode())
    if not vp:
        return None
    v = vp.contents
    n = v.n_nodes
    out = (
        int(v.k),
        int(v.L),
        {
            "parent": np.ctypeslib.as_array(v.parents, (n,)).copy(),
            "is_leaf": np.ctypeslib.as_array(v.is_leaf, (n,)).copy().astype(bool),
            "desc": np.ctypeslib.as_array(v.descs, (n, 32)).copy(),
            "weight": np.ctypeslib.as_array(v.weights, (n,)).copy(),
        },
    )
    lib.voc_free(vp)
    return out


def load_image_gray_native(path: str) -> np.ndarray | None:
    """Decode a grayscale PNG/PGM with the C++ decoder; None on fallback."""
    lib = get_lib()
    if lib is None:
        return None
    buf = ctypes.POINTER(ctypes.c_float)()
    w = ctypes.c_int()
    h = ctypes.c_int()
    ret = lib.image_load_gray(path.encode(), ctypes.byref(buf), ctypes.byref(w), ctypes.byref(h))
    if ret != 0:
        return None
    img = np.ctypeslib.as_array(buf, (h.value, w.value)).copy()
    lib.image_free(buf)
    return img
