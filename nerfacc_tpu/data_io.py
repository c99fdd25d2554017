"""ctypes bridge to the native host data pipeline (csrc/raygen.cpp).

Builds the shared library on first use (g++ -O3 -fopenmp) into ``build/``
at the root of the checkout, named by a hash of the source and the
flags, analogous to the reference's JIT cpp_extension fallback
(``nerfacc/cuda/_backend.py:48-84``) but with zero torch dependency.
Falls back cleanly (``lib() is None``) if no compiler is available.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).parent / "csrc" / "raygen.cpp"
_BUILD = Path(__file__).resolve().parent.parent / "build"
# the portable second set is tried when the first does not build
_FLAGS = (
    ["-O3", "-fopenmp", "-shared", "-fPIC"],
    ["-O3", "-shared", "-fPIC"],
)
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build() -> Optional[ctypes.CDLL]:
    src = _SRC.read_bytes()
    so = None
    for flags in _FLAGS:
        tag = hashlib.sha1(src + " ".join(flags).encode()).hexdigest()[:12]
        so = _BUILD / f"raygen_{tag}.so"
        if so.exists():
            break
        _BUILD.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        try:
            subprocess.run(
                ["g++", *flags, str(_SRC), "-o", str(tmp)],
                check=True, capture_output=True,
            )
        except (OSError, subprocess.CalledProcessError):
            so = None
            continue
        tmp.replace(so)  # atomic: no reader ever sees a partial library
        break
    if so is None:
        return None
    lib = ctypes.CDLL(str(so))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.sample_ray_batch.argtypes = [
        f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        f32p, f32p, ctypes.c_int, f32p, ctypes.c_uint64, ctypes.c_int64,
        f32p, f32p, f32p,
    ]
    lib.rays_for_pose.argtypes = [
        ctypes.c_int64, ctypes.c_int64, f32p, f32p, ctypes.c_int, f32p, f32p,
    ]
    return lib


def lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if not _TRIED:
        _TRIED = True
        _LIB = _build()
    return _LIB


def sample_ray_batch(
    images: np.ndarray,  # (n, h, w, c) float32, c in {3, 4}
    poses: np.ndarray,  # (n, 3, 4) float32
    intrin: np.ndarray,  # (4,) fx, fy, cx, cy
    bkgd: np.ndarray,  # (3,)
    seed: int,
    num_rays: int,
    opengl: bool = True,
):
    """Native random-pixel batch; returns (origins, dirs, pixels) float32."""
    L = lib()
    assert L is not None, "native raygen unavailable (no g++)"
    n, h, w, c = images.shape
    origins = np.empty((num_rays, 3), np.float32)
    dirs = np.empty((num_rays, 3), np.float32)
    pixels = np.empty((num_rays, 3), np.float32)
    L.sample_ray_batch(
        np.ascontiguousarray(images, np.float32), n, h, w, c,
        np.ascontiguousarray(poses, np.float32),
        np.ascontiguousarray(intrin, np.float32), int(opengl),
        np.ascontiguousarray(bkgd, np.float32),
        ctypes.c_uint64(seed & 0xFFFFFFFFFFFFFFFF), num_rays,
        origins, dirs, pixels,
    )
    return origins, dirs, pixels


def rays_for_pose(
    h: int, w: int, pose: np.ndarray, intrin: np.ndarray, opengl: bool = True
):
    L = lib()
    assert L is not None, "native raygen unavailable (no g++)"
    origins = np.empty((h * w, 3), np.float32)
    dirs = np.empty((h * w, 3), np.float32)
    L.rays_for_pose(
        h, w, np.ascontiguousarray(pose, np.float32),
        np.ascontiguousarray(intrin, np.float32), int(opengl), origins, dirs,
    )
    return origins, dirs
