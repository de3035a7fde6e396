"""Native (C++) host-runtime components, loaded via ctypes.

A copy of the JAX package's host tracker, NMS and semantic uniformisation
(`lanemapping_tpu/native`): the sequential host-side stages run as a small
C++ shared library compiled on first use with g++ from this package's own
``postproc.cpp`` (plain C ABI + ctypes) into ``lanemapping_tpu_torch/_build``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time
from typing import Optional

import numpy as np

from ..utils.logger import record_build

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "postproc.cpp")
_LIB = os.path.join(os.path.dirname(_HERE), "_build", "libpostproc.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed: Optional[BaseException] = None  # why the library is unavailable


def build_library(force: bool = False) -> str:
    if os.path.exists(_LIB) and not force and \
            os.path.getmtime(_LIB) >= os.path.getmtime(_SRC):
        return _LIB
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           _SRC, "-o", tmp]
    t0 = time.perf_counter()
    subprocess.run(cmd, check=True, capture_output=True)
    record_build("g++", "postproc", t0, time.perf_counter())
    os.replace(tmp, _LIB)  # atomic: concurrent processes never see half a file
    return _LIB


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, building it on first use; None if unavailable."""
    global _lib, _failed
    if _lib is not None or _failed is not None:
        return _lib
    with _lock:
        if _lib is not None or _failed is not None:
            return _lib
        try:
            path = build_library()
            lib = ctypes.CDLL(path)
            dp = ctypes.POINTER(ctypes.c_double)
            fp = ctypes.POINTER(ctypes.c_float)
            ip = ctypes.POINTER(ctypes.c_int32)
            up = ctypes.POINTER(ctypes.c_uint8)
            lib.lm_smooth_lanes.argtypes = [dp, ip, fp, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_int, dp]
            lib.lm_smooth_lanes.restype = None
            lib.lm_polyline_nms.argtypes = [dp, fp, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_int]
            lib.lm_polyline_nms.restype = None
            lib.lm_uniform_semantics.argtypes = [dp, dp, ctypes.c_int,
                                                 ctypes.c_int, ctypes.c_int,
                                                 dp, ctypes.c_int, up,
                                                 ctypes.c_int]
            lib.lm_uniform_semantics.restype = None
            _lib = lib
        except Exception as e:
            _failed = e
    return _lib


def load_error() -> Optional[BaseException]:
    """Why ``get_lib`` found no library (None while it has one or has not
    tried)."""
    return _failed


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def smooth_lanes_native(out_cls: np.ndarray, orient: np.ndarray,
                        seg_conf: Optional[np.ndarray],
                        complete_inner_nodes: bool = True,
                        img: int = 1152,
                        occ_first_row_only: bool = False
                        ) -> Optional[np.ndarray]:
    """Native tracker; ``seg_conf`` is the [S, img] anchor-row confidence
    matrix.  Returns None when the library is unavailable.
    ``occ_first_row_only`` reproduces the reference occupancy_filter bug
    (cfg ``ref_exact_occupancy_filter``)."""
    lib = get_lib()
    if lib is None:
        return None
    out_cls = np.ascontiguousarray(out_cls, np.float64)
    orient_i = np.ascontiguousarray(orient, np.int32)
    n_line, n_v = out_cls.shape
    result = np.empty_like(out_cls)
    conf_ptr = None
    if seg_conf is not None:
        seg_conf = np.ascontiguousarray(seg_conf, np.float32)
        conf_ptr = _fp(seg_conf)
    lib.lm_smooth_lanes(
        _dp(out_cls),
        orient_i.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        conf_ptr, n_line, n_v, img, int(complete_inner_nodes),
        int(occ_first_row_only), _dp(result))
    return result


def polyline_nms_native(lines: np.ndarray, sem_map: np.ndarray,
                        img: int = 1152) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    lines = np.ascontiguousarray(lines, np.float64)
    sem_map = np.ascontiguousarray(sem_map, np.float32)
    n_line, n_v = lines.shape
    lib.lm_polyline_nms(_dp(lines), _fp(sem_map), n_line, n_v, img)
    return lines


def uniform_semantics_native(ply: np.ndarray, ep: np.ndarray,
                             r_buff: int = 20,
                             keep_line_ends: bool = False):
    """Native run-length semantic uniformisation + endpoint pruning.

    ``ply``: [N,S,2] (col, semantic) modified in place semantically;
    ``ep``: [M,2] endpoint candidates.  ``keep_line_ends``: exempt a line's
    terminal zone from the interior-endpoint prune (cfg
    ``endp_keep_line_ends``; False = reference behaviour).  Returns
    (ply, keep_mask) or None when the library is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    n_line, n_v, _ = ply.shape
    cols = np.ascontiguousarray(ply[:, :, 0], np.float64)
    sem = np.ascontiguousarray(ply[:, :, 1], np.float64)
    ep64 = np.ascontiguousarray(ep.reshape(-1, 2), np.float64)
    keep = np.ones((len(ep64),), np.uint8)
    lib.lm_uniform_semantics(
        _dp(cols), _dp(sem), n_line, n_v, int(r_buff), _dp(ep64),
        len(ep64), keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        int(keep_line_ends))
    ply[:, :, 1] = sem
    return ply, keep.astype(bool)
