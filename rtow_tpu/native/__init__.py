"""ctypes bindings for the native host runtime (rtow_native.cpp).

The reference's runtime is pure C++ (OBJ ingestion src/main.cpp:109-131,
PPM output src/render.cpp:11-20, BVH build src/render.cpp:73-110).  This
package gives this framework the same native-speed host path: the
shared library is compiled on first use with g++ (no pip deps, plain C
ABI, ctypes binding) and every entry point has a pure-Python fallback in
``rtow_tpu.utils`` / ``rtow_tpu.ops.bvh``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(__file__)
_SRC = os.path.join(_HERE, "src", "rtow_native.cpp")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _lib_path() -> str:
    """Per-source-content cache path for the compiled library.

    Keyed on a hash of the source (not mtime — git checkouts reset
    mtimes) and built with -march=native into ``_build`` beside the
    source (git-ignored), so a binary can never be stale."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_HERE, "_build", f"librtow_native-{digest}.so")


def _compile(lib_path: str) -> bool:
    try:
        os.makedirs(os.path.dirname(lib_path), exist_ok=True)
        tmp = lib_path + f".tmp{os.getpid()}"
        subprocess.run(
            ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
             _SRC, "-o", tmp],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, lib_path)  # atomic under concurrent builds
        return True
    except Exception:
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, compiling it on first use; None if the
    toolchain is unavailable (callers fall back to Python)."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        lib_path = _lib_path()
        if not os.path.exists(lib_path):
            if not _compile(lib_path):
                _load_failed = True
                return None
        try:
            lib = ctypes.CDLL(lib_path)
        except OSError:
            _load_failed = True
            return None
        lib.rtow_free.argtypes = [ctypes.c_void_p]
        lib.rtow_load_obj.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.rtow_load_obj.restype = ctypes.c_int
        lib.rtow_write_ppm.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_char)),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.rtow_write_ppm.restype = ctypes.c_int
        lib.rtow_build_bvh.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.rtow_build_bvh.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def load_obj(path: str) -> np.ndarray:
    """Native OBJ loader -> (M, 3, 3) float64. Raises on malformed files
    with the same contract as utils.obj.load_obj (triangles only)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    tris = ctypes.POINTER(ctypes.c_double)()
    n = ctypes.c_int64()
    err_line = ctypes.c_int64()
    rc = lib.rtow_load_obj(path.encode(), ctypes.byref(tris),
                           ctypes.byref(n), ctypes.byref(err_line))
    if rc != 0:
        from ..utils.obj import ObjError
        msgs = {1: "cannot open", 2: "found a face that isn't a triangle",
                3: "malformed face index", 4: "no triangular faces found",
                5: "out of memory", 6: "face index out of range"}
        raise ObjError(f"{path}:{err_line.value}: {msgs.get(rc, rc)}")
    try:
        out = np.ctypeslib.as_array(tris, shape=(n.value, 3, 3)).copy()
    finally:
        lib.rtow_free(tris)
    return out


def ppm_string(mean_image: np.ndarray) -> str:
    """Native P3 serialisation of an (H, W, 3) mean-radiance image."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    img = np.ascontiguousarray(mean_image, dtype=np.float64)
    h, w, _ = img.shape
    buf = ctypes.POINTER(ctypes.c_char)()
    length = ctypes.c_int64()
    rc = lib.rtow_write_ppm(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), w, h,
        ctypes.byref(buf), ctypes.byref(length),
    )
    if rc != 0:
        raise RuntimeError(f"rtow_write_ppm failed ({rc})")
    try:
        out = ctypes.string_at(buf, length.value).decode()
    finally:
        lib.rtow_free(buf)
    return out


def build_bvh_arrays(
    pmin: np.ndarray, pmax: np.ndarray, leaf_size: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Native flattened-BVH build -> (bbox_min, bbox_max, first, count,
    skip, prim_ids) numpy arrays in the ops/bvh.py layout."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    pmin = np.ascontiguousarray(pmin, dtype=np.float64)
    pmax = np.ascontiguousarray(pmax, dtype=np.float64)
    n = pmin.shape[0]
    dptr = ctypes.POINTER(ctypes.c_double)
    iptr = ctypes.POINTER(ctypes.c_int32)
    obmin, obmax = dptr(), dptr()
    ofirst, ocount, oskip, oids = iptr(), iptr(), iptr(), iptr()
    n_nodes = ctypes.c_int64()
    n_ids = ctypes.c_int64()
    rc = lib.rtow_build_bvh(
        pmin.ctypes.data_as(dptr), pmax.ctypes.data_as(dptr), n, leaf_size,
        ctypes.byref(obmin), ctypes.byref(obmax), ctypes.byref(ofirst),
        ctypes.byref(ocount), ctypes.byref(oskip), ctypes.byref(oids),
        ctypes.byref(n_nodes), ctypes.byref(n_ids),
    )
    if rc != 0:
        raise RuntimeError(f"rtow_build_bvh failed ({rc})")
    nn, ni = n_nodes.value, n_ids.value
    try:
        out = (
            np.ctypeslib.as_array(obmin, shape=(nn, 3)).copy(),
            np.ctypeslib.as_array(obmax, shape=(nn, 3)).copy(),
            np.ctypeslib.as_array(ofirst, shape=(nn,)).copy(),
            np.ctypeslib.as_array(ocount, shape=(nn,)).copy(),
            np.ctypeslib.as_array(oskip, shape=(nn,)).copy(),
            np.ctypeslib.as_array(oids, shape=(ni,)).copy(),
        )
    finally:
        for p in (obmin, obmax, ofirst, ocount, oskip, oids):
            lib.rtow_free(p)
    return out
