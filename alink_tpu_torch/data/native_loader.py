"""ctypes binding of the JAX package's native batched image loader
(counterpart of ``alink_tpu/data/native_loader.py``).

``native/loader.cc`` decodes JPEG/PNG with libjpeg/libpng on a C++ thread
pool and resizes with cv2's ``INTER_LINEAR`` (half-pixel grid, no
antialias) straight into a float32 (N, H, W, 3) buffer: the reference's
decode and resize (``readDFW.py:82``).  The port compiles that file as it
stands, with the flags of ``native/Makefile``, through
``_build.build_host`` into ``build/alink_tpu_torch/`` (never into
``native/``), at first use; it then computes bit for bit what the JAX
package's ``liballoader.so`` computes.  ``available()`` is False when the
build fails (no ``g++``, or no libjpeg/libpng headers), and
``build_error()`` returns the compiler's reason; ``data.loader`` then
decodes with PIL.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path
from typing import Sequence

import numpy as np

from alink_tpu_torch import _build

SOURCE = Path(__file__).resolve().parents[2] / "native" / "loader.cc"
FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall")      # native/Makefile:3
LIBS = ("-ljpeg", "-lpng", "-lpthread")              # native/Makefile:4

_ARGS = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_error: str | None = None


def get_lib() -> ctypes.CDLL | None:
    """The loaded library (built at first call); None if it cannot be
    built or loaded, with the reason in ``build_error()``."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                lib = ctypes.CDLL(str(_build.build_host(
                    "alloader", [SOURCE], FLAGS, LIBS)))
            except (RuntimeError, OSError) as exc:
                _error = str(exc)
                return None
            lib.alink_decode_resize_batch.argtypes = _ARGS
            lib.alink_decode_resize_batch.restype = ctypes.c_int
            lib.alink_decode_resize_batch_v2.argtypes = _ARGS + [ctypes.c_int]
            lib.alink_decode_resize_batch_v2.restype = ctypes.c_int
            _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def build_error() -> str | None:
    """Why the library is unavailable (the compiler's output), or None."""
    get_lib()
    return _error


def decode_resize_batch(
    paths: Sequence[str],
    image_res: tuple[int, int],
    threads: int | None = None,
    dct_scale: bool = False,
) -> tuple[np.ndarray, int]:
    """Decode and resize a path list -> ((N, H, W, 3) float32, n_failures).

    ``image_res`` is (width, height), the reference's cv2 dsize convention.
    Failed slots are zero-filled.  ``threads`` defaults to
    ``min(16, os.cpu_count())``.  ``dct_scale=True`` lets libjpeg decode at
    the largest 1/2^k scale that still covers the target before the
    resize: faster on sources 2x the target or more, approximate pixels
    (a box-filtered DCT downscale); PNGs and smaller sources are unchanged.
    """
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_error}")
    w, h = image_res
    n = len(paths)
    out = np.zeros((n, h, w, 3), np.float32)
    if n == 0:
        return out, 0
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    if threads is None:
        threads = min(16, os.cpu_count() or 1)
    buf = out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    if dct_scale:
        failures = lib.alink_decode_resize_batch_v2(arr, n, h, w, buf,
                                                    threads, 1)
    else:
        failures = lib.alink_decode_resize_batch(arr, n, h, w, buf, threads)
    return out, int(failures)
