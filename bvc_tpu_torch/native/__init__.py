"""ctypes bindings for the native decode core (see ``decode.cpp``; a copy of
:mod:`bvc_tpu.native` with the same C ABI).

``decode_frames(paths, image_size)`` fuses JPEG decode + shorter-side
bilinear resize + center crop + (x/255 - 0.5)/0.25 normalize for a list
of frames in one call with an internal thread pool.  This is a host path,
not a device kernel.  It builds at first use into ``bvc_tpu_torch/_build/``
(:mod:`bvc_tpu_torch.native.build`); without a compiler or libjpeg the
build fails, :func:`available` is False, and callers take the Python path
(``bvc_tpu_torch.data.transforms``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_lib = None
_load_failed = False
_load_lock = threading.Lock()


def _load():
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _load_lock:
        return _load_locked()


def _load_locked():
    # serialized: the loader maps dataset reads over a thread pool, and two
    # threads racing the lazy build would both compile
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    from bvc_tpu_torch.native.build import build

    try:
        lib = ctypes.CDLL(str(build(verbose=False)))
    except (OSError, subprocess.CalledProcessError):
        _load_failed = True
        return None
    for name, out_type in (("bvc_decode_frames", ctypes.c_float),
                           ("bvc_decode_frames_u8", ctypes.c_uint8)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(out_type), ctypes.c_int, ctypes.c_int]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def decode_frames(
    paths: list[str], image_size: int, n_threads: int | None = None,
    uint8: bool = False, dct_scale: bool = True,
) -> np.ndarray:
    """``[len(paths), image_size, image_size, 3]`` — normalized float32,
    or raw resized/cropped uint8 with ``uint8=True``.

    ``dct_scale`` decodes at a reduced DCT scale when downscaling anyway
    (big IDCT saving on natural images; slightly different resampling
    than decode-then-resize — disable for strict pixel parity with the
    cv2 path).

    Raises ``IOError`` naming the first undecodable path.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native decode core unavailable")
    n = len(paths)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    if n_threads is None:
        n_threads = min(n, os.cpu_count() or 1)
    if uint8:
        out = np.empty((n, image_size, image_size, 3), np.uint8)
        rc = lib.bvc_decode_frames_u8(
            arr, n, image_size,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n_threads,
            int(dct_scale),
        )
    else:
        out = np.empty((n, image_size, image_size, 3), np.float32)
        rc = lib.bvc_decode_frames(
            arr, n, image_size,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_threads,
            int(dct_scale),
        )
    if rc != 0:
        raise IOError(f"failed to decode {paths[rc - 1]}")
    return out
