"""ctypes bindings for the port's native host kernels
(ops/csrc/fasttrack_native.cpp).

Port of fasttrack_tpu/native.py: the CPU sides of the offload toggles
(popcount Hamming matrix, FAST-9 score) plus the quadtree keypoint
distribution kept on the host as the reference does. The library is built
from the port's own copy of the source with g++ at first use into
`fasttrack_tpu_torch/_build/`, keyed by a hash of the source, the flags and
the host, written under a temporary name and moved into place with
`os.replace`, so a process never loads a half-written file. A failed build
raises with g++'s messages; nothing falls back. `available()` says whether
the library builds and loads, for the one caller with a NumPy branch of its
own, as in the JAX package: the tree vocabulary's host Hamming matrix
(bow/vocabulary.py).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "ops" / "csrc" / "fasttrack_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")


def library_path() -> Path:
    """Keyed by the source, the flags and the host: -march=native builds
    for this machine's CPU, so a build directory copied to another machine
    is not reused there."""
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()
                         + f"{platform.node()} {platform.machine()}".encode()).hexdigest()
    return BUILD_DIR / f"{SOURCE.stem}-{key[:16]}.so"


def build() -> Path:
    """The compiled library, built now if it is not there yet."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the port's host kernels need a C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: another process never loads a partial file
    return out


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.hamming_matrix_u8.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.hamming_matrix_u8.restype = None
    lib.fast_score_f32.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.fast_score_f32.restype = None
    lib.distribute_octree.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int),
    ]
    lib.distribute_octree.restype = ctypes.c_int
    return lib


def available() -> bool:
    """True where the library builds and loads (fasttrack_tpu/native.py's
    `available`)."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _packed(a) -> np.ndarray:
    a = np.ascontiguousarray(a, np.uint8)
    if a.ndim != 2 or a.shape[1] != 32:
        raise ValueError(f"packed descriptors must be (n, 32) uint8, got {a.shape}")
    return a


def hamming_matrix_packed(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 32) x (M, 32) packed uint8 -> (N, M) int32 Hamming."""
    lib = _load()
    a, b = _packed(a), _packed(b)
    out = np.empty((len(a), len(b)), np.int32)
    lib.hamming_matrix_u8(_ptr(a, ctypes.c_uint8), len(a), _ptr(b, ctypes.c_uint8), len(b),
                          _ptr(out, ctypes.c_int32))
    return out


def fast_score(img: np.ndarray) -> np.ndarray:
    """(H, W) float32 -> FAST-9 score map."""
    lib = _load()
    img = np.ascontiguousarray(img, np.float32)
    if img.ndim != 2:
        raise ValueError(f"fast_score takes one (H, W) image, got {img.shape}")
    h, w = img.shape
    out = np.empty((h, w), np.float32)
    lib.fast_score_f32(_ptr(img, ctypes.c_float), h, w, _ptr(out, ctypes.c_float))
    return out


def distribute_octree(x: np.ndarray, y: np.ndarray, score: np.ndarray,
                      bounds: tuple, n_target: int) -> np.ndarray:
    """Quadtree keypoint balancing (DistributeOctTree): the selected indices
    (at most n_target), spread spatially, the best score of each cell."""
    lib = _load()
    x = np.ascontiguousarray(x, np.float32)
    y = np.ascontiguousarray(y, np.float32)
    score = np.ascontiguousarray(score, np.float32)
    if not x.ndim == y.ndim == score.ndim == 1 or not len(x) == len(y) == len(score):
        raise ValueError(f"x, y, score must be three 1-D arrays of one length, got "
                         f"{x.shape}, {y.shape}, {score.shape}")
    out = np.empty(max(int(n_target), 0), np.int32)
    cnt = lib.distribute_octree(
        _ptr(x, ctypes.c_float), _ptr(y, ctypes.c_float), _ptr(score, ctypes.c_float),
        len(x), int(bounds[0]), int(bounds[1]), int(bounds[2]), int(bounds[3]),
        int(n_target), _ptr(out, ctypes.c_int),
    )
    return out[:cnt].copy()
