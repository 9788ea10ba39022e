"""The native (C++) image transform of the host data path, built on demand
and loaded through ctypes.

Counterpart of ``bndm_tpu/native/__init__.py``, with its own byte-for-byte
copy of ``fastimage.cpp``: one g++ call with the JAX package's flags builds
``bndm_tpu_torch/_build/fastimage.so`` at first use. A host without g++
decodes through PIL instead (``data/imagefolder.py``); a failed build is
logged once with g++'s output, and :data:`PATH_COUNTS` records which path
each image took, so that a run can check it used the native one.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "fastimage.cpp")
# beside the kernels' builds, outside the package's namespace (a .so inside
# it would be picked up as a broken extension module)
_LIB_PATH = os.path.join(os.path.dirname(_HERE), "_build", "fastimage.so")

# images decoded by each path since the process started (or the caller set
# them to 0): "native" or "pil"
PATH_COUNTS = {"native": 0, "pil": 0}
_count_lock = threading.Lock()
_load_lock = threading.Lock()
_lib = None
_tried = False


def count_path(path):
    with _count_lock:
        PATH_COUNTS[path] += 1


def reset_counts():
    with _count_lock:
        for k in PATH_COUNTS:
            PATH_COUNTS[k] = 0


def _build():
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    with tempfile.TemporaryDirectory() as td:
        tmp_out = os.path.join(td, "_fastimage.so")
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             _SRC, "-o", tmp_out],
            check=True, capture_output=True, text=True,
        )
        os.replace(tmp_out, _LIB_PATH)


def get_fastimage():
    """The loaded ctypes library, or None where it cannot be built (logged
    once, with the compiler's output)."""
    global _lib, _tried
    with _load_lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if (not os.path.exists(_LIB_PATH)
                    or os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC)):
                _build()
            lib = ctypes.CDLL(_LIB_PATH)
        except subprocess.CalledProcessError as e:
            print(f"native image transform: g++ failed (exit {e.returncode}); decoding "
                  f"through PIL. g++ said:\n{e.stderr}", file=sys.stderr, flush=True)
            return None
        except OSError as e:  # no g++, or the library does not load
            print(f"native image transform unavailable ({e}); decoding through PIL",
                  file=sys.stderr, flush=True)
            return None
        lib.transform_u8_to_chw_f32.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.transform_u8_to_chw_f32.restype = None
        lib.transform_u8_to_chw_f32_v2.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ]
        lib.transform_u8_to_chw_f32_v2.restype = None
        _lib = lib
        return _lib


def fast_transform(img_u8_hwc, res, hflip=False, crop_top=-1, crop_left=-1):
    """uint8 HWC image -> float32 CHW in [0, 1] through the native kernel:
    the shorter side resized to ``res`` (bilinear), the crop at
    (crop_top, crop_left) (-1/-1: centered), an optional horizontal flip.
    Returns None when the library is unavailable."""
    lib = get_fastimage()
    if lib is None:
        return None
    img = np.ascontiguousarray(img_u8_hwc, dtype=np.uint8)
    if img.ndim != 3:
        raise ValueError(f"expected an HWC image, got shape {img.shape}")
    h, w, c = img.shape
    out = np.empty((c, res, res), np.float32)
    lib.transform_u8_to_chw_f32_v2(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h, w, c, res, int(bool(hflip)), int(crop_top), int(crop_left),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out
