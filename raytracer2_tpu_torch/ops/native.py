"""ctypes bindings for the native (C++) scene-build runtime.

The port's own copy of raytracer2_tpu/ops/native.py. The source is
raytracer2_tpu_torch/csrc/cluster_builder.cpp (a copy of the JAX package's
csrc/cluster_builder.cpp); the host C++ compiler builds it at first use
into build/native/ at the repository root, under a name that carries a
hash of the source and flags, so an edited source never loads a stale
library. When no compiler or library is at hand the callers fall back to
a Morton-order build; available() says which builder runs.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "cluster_builder.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
# the JAX package's csrc/Makefile flags, so both builds order triangles alike
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-shared")


def _build() -> Path | None:
    cxx = (os.environ.get("CXX") or shutil.which("c++")
           or shutil.which("g++"))
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    out = BUILD_DIR / f"libraytracer2_native_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    if cxx is None:
        logger.info("native build unavailable: no C++ compiler")
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        logger.info("native build failed: %s", e)
        return None
    tmp.replace(out)
    return out


@functools.cache
def _load():
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        logger.info("native library load failed: %s", e)
        return None
    lib.rt2_native_abi_version.restype = ctypes.c_int
    if lib.rt2_native_abi_version() != 1:
        logger.warning("native ABI mismatch; ignoring %s", path)
        return None
    lib.rt2_build_sah_clusters.restype = ctypes.c_int
    lib.rt2_build_sah_clusters.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
    ]
    return lib


def available() -> bool:
    return _load() is not None


def build_sah_clusters(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                       cluster_size: int
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Binned-SAH clustering. Returns (order [n], offsets [c], counts [c])
    or None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = int(v0.shape[0])
    if n == 0:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                np.zeros(0, np.int32))
    v0 = np.ascontiguousarray(v0, np.float32)
    e1 = np.ascontiguousarray(e1, np.float32)
    e2 = np.ascontiguousarray(e2, np.float32)
    order = np.empty(n, np.int32)
    max_clusters = 2 * (n // max(cluster_size, 1) + 2)
    offsets = np.empty(max_clusters, np.int32)
    counts = np.empty(max_clusters, np.int32)

    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    c = lib.rt2_build_sah_clusters(
        v0.ctypes.data_as(fp), e1.ctypes.data_as(fp), e2.ctypes.data_as(fp),
        n, cluster_size, order.ctypes.data_as(ip),
        offsets.ctypes.data_as(ip), counts.ctypes.data_as(ip), max_clusters)
    if c < 0:
        logger.warning("native cluster build overflow; falling back")
        return None
    return order, offsets[:c], counts[:c]
