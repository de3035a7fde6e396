"""Build and load the hand-written CUDA kernels of ``lanemapping_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` holds a plain C entry point.  It is compiled at
first use with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``lanemapping_tpu_torch/_build/`` and loaded with ``ctypes``; no PyTorch
headers are involved, so a build takes seconds.  Nothing is compiled when a
module is imported: the CPU tests import every module on a machine with no
``nvcc``.  A kernel that cannot be built raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-I", CSRC_DIR]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels of "
                       "lanemapping_tpu_torch are built from source at first "
                       "use")


def _paths(name: str):
    return (os.path.join(CSRC_DIR, f"{name}.cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"))


def _fresh(name: str) -> bool:
    """The library is newer than its source and every shared header."""
    src, lib = _paths(name)
    if not os.path.exists(lib):
        return False
    deps = [src, *glob.glob(os.path.join(CSRC_DIR, "*.cuh"))]
    return os.path.getmtime(lib) >= max(os.path.getmtime(d) for d in deps)


def build_all(names: Iterable[str], force: bool = False) -> Dict[str, Dict]:
    """Compile every stale library of ``names`` (every one with ``force``),
    one ``nvcc`` per source, all started together.  Returns
    {name: {"seconds", "ptxas"}} for the libraries it built; raises on a
    failed build."""
    names = [n for n in names if force or not _fresh(n)]
    built: Dict[str, Dict] = {}
    if not names:
        return built
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n in names:
        src, lib = _paths(n)
        tmp = f"{lib}.{os.getpid()}.tmp"
        procs[n] = (subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp, src],
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, lib, time.perf_counter())
    failed = []
    for n, (proc, tmp, lib, t0) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exit {proc.returncode}\n{out}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half
        built[n] = {"seconds": time.perf_counter() - t0, "ptxas": out}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return built


def load_library(name: str, signatures: Optional[Dict] = None) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``, built first if stale.  ``signatures``:
    {function: (argtypes, restype)} declared on first load."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            build_all([name])
            lib = ctypes.CDLL(_paths(name)[1])
            for fn, (argtypes, restype) in (signatures or {}).items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[name] = lib
    return _libs[name]
