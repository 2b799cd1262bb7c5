"""ctypes bindings of the native C++ meshing library (port of
`smvs_tpu/native/__init__.py`, the same interface).

The port keeps its own copy of the JAX package's C++ sources in this
directory: incremental Delaunay (reference `lib/delaunay_2d.cc`), greedy
depth-map triangulation (`lib/depth_triangulator.cc`) and QEM mesh
simplification (`lib/mesh_simplifier.cc`), host-side geometry that the
reference also keeps in C++. At first use `g++` builds them, with the
JAX package's flags, into ``smvs_tpu_torch/_build/libsmvs_native_<hash>.so``
(keyed by the sources' content); a failed build raises, and nothing
stands in for the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
SOURCES = tuple(os.path.join(_DIR, s) for s in
                ("delaunay.cpp", "triangulate.cpp", "simplify.cpp",
                 "api.cpp"))
HEADERS = (os.path.join(_DIR, "delaunay.hpp"),)
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra")
_lib = None


def library_path() -> str:
    """Where the built library lives, keyed by the sources' content."""
    h = hashlib.sha256()
    for path in SOURCES + HEADERS:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libsmvs_native_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the sources with g++ (once per source version) and return
    the library path."""
    out = library_path()
    if os.path.exists(out):
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found; the native meshing library is "
                           f"built from {_DIR} with it")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXXFLAGS, "-shared", "-o", tmp,
                               *SOURCES], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    c_int_p = ctypes.POINTER(ctypes.c_int)
    lib.smvs_approx_triangulate.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        c_int_p, ctypes.c_int, c_int_p, c_int_p,
    ]
    lib.smvs_simplify_mesh.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, c_int_p, ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, c_int_p, ctypes.c_int,
        c_int_p, c_int_p,
    ]
    lib.smvs_delaunay.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        c_int_p, ctypes.c_int, c_int_p,
    ]
    _lib = lib
    return lib


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def approximate_triangulation(depth: np.ndarray, max_vertex_fraction=0.025,
                              error_fraction=0.0005):
    """Greedy triangulation of a z-depth map.

    Defaults mirror the reference (`lib/depth_triangulator.h:34-49`):
    at most 2.5% of pixels become vertices; stop when the max error drops
    below 0.05% of the depth range. Returns (xy_depth [V, 3], faces [F, 3]).
    """
    lib = _load()
    depth = np.ascontiguousarray(depth, np.float32)
    h, w = depth.shape
    valid = depth[depth > 0]
    if valid.size == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int32)
    max_v = max(int(w * h * max_vertex_fraction), 16)
    err_thresh = float((valid.max() - valid.min()) * error_fraction)
    cap_v = max_v + 8
    cap_f = 4 * cap_v
    out_xyz = np.zeros(cap_v * 3, np.float64)
    out_faces = np.zeros(cap_f * 3, np.int32)
    nv = ctypes.c_int()
    nf = ctypes.c_int()
    ret = lib.smvs_approx_triangulate(
        _fptr(depth), w, h, max_v, err_thresh,
        _dptr(out_xyz), cap_v, _iptr(out_faces), cap_f,
        ctypes.byref(nv), ctypes.byref(nf))
    if ret != 0:
        raise RuntimeError("triangulation output overflow")
    return (out_xyz[: nv.value * 3].reshape(-1, 3),
            out_faces[: nf.value * 3].reshape(-1, 3))


def simplify_mesh(verts: np.ndarray, faces: np.ndarray, target_ratio=0.25):
    """QEM decimation to ``target_ratio`` of the input face count."""
    lib = _load()
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    target = max(int(len(faces) * target_ratio), 4)
    cap_v = len(verts) + 8
    cap_f = len(faces) + 8
    out_v = np.zeros(cap_v * 3, np.float32)
    out_f = np.zeros(cap_f * 3, np.int32)
    nv = ctypes.c_int()
    nf = ctypes.c_int()
    ret = lib.smvs_simplify_mesh(
        _fptr(verts), len(verts), _iptr(faces), len(faces), target,
        _fptr(out_v), cap_v, _iptr(out_f), cap_f,
        ctypes.byref(nv), ctypes.byref(nf))
    if ret != 0:
        raise RuntimeError("simplify output overflow")
    return (out_v[: nv.value * 3].reshape(-1, 3),
            out_f[: nf.value * 3].reshape(-1, 3))


def delaunay(points_xy: np.ndarray, bbox=None):
    """Delaunay triangulation of 2D points (plus 4 bbox corner points)."""
    lib = _load()
    pts = np.ascontiguousarray(points_xy, np.float64)
    if bbox is None:
        lo = pts.min(0) - 1.0
        hi = pts.max(0) + 1.0
        bbox = (lo[0], lo[1], hi[0], hi[1])
    cap_f = (len(pts) + 4) * 3
    out_f = np.zeros(cap_f * 3, np.int32)
    nf = ctypes.c_int()
    ret = lib.smvs_delaunay(_dptr(pts), len(pts), bbox[0], bbox[1], bbox[2],
                            bbox[3], _iptr(out_f), cap_f, ctypes.byref(nf))
    if ret != 0:
        raise RuntimeError("delaunay output overflow")
    return out_f[: nf.value * 3].reshape(-1, 3)
