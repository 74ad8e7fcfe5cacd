"""ctypes bindings for the native threaded frame loader (native/loader.cpp).

Counterpart of ``stereovision_tpu/io/native_loader.py``: a C++ worker pool
decodes JPEG/PNG/PNM on the host ahead of the consumer into a bounded
window. The library is the port's own build of ``native/loader.cpp``
(``ops.native``, "loader"), which needs libjpeg's and libpng's headers;
``available()`` says whether it built here (``ops.native.why_unavailable``
says why not), and the loaders raise where it did not.
"""

from __future__ import annotations

import ctypes

import numpy as np

from stereovision_tpu_torch.ops import native as _native

_MAX_BYTES = 3 * 4096 * 4096 * 4  # 16 MP RGB float32 cap


def _lib():
    lib = _native.load("loader")
    if not hasattr(lib.decode_image, "_configured"):
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.decode_image.restype = ctypes.c_int
        lib.decode_image.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, i32p, i32p, i32p,
        ]
        lib.loader_create.restype = ctypes.c_void_p
        lib.loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
        ]
        lib.loader_fetch.restype = ctypes.c_int
        lib.loader_fetch.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, i32p, i32p, i32p,
        ]
        lib.loader_destroy.restype = None
        lib.loader_destroy.argtypes = [ctypes.c_void_p]
        lib.decode_image._configured = True
    return lib


def available() -> bool:
    return _native.available("loader")


def decode(path, gray: bool = True) -> np.ndarray:
    """Decode one image to float32 (H, W) or (H, W, 3)."""
    lib = _lib()
    buf = np.empty(_MAX_BYTES // 4, np.float32)
    w = ctypes.c_int32()
    h = ctypes.c_int32()
    ch = ctypes.c_int32()
    ok = lib.decode_image(
        str(path).encode(), int(gray),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), buf.nbytes,
        ctypes.byref(w), ctypes.byref(h), ctypes.byref(ch),
    )
    if not ok:
        raise IOError(f"native decode failed: {path}")
    n = w.value * h.value * ch.value
    out = buf[:n].reshape(h.value, w.value, ch.value).copy()
    return out[..., 0] if ch.value == 1 else out


class PrefetchingLoader:
    """Ordered frame iterator with a C++ decode pool running ahead.

    >>> with PrefetchingLoader(paths, gray=True) as ld:
    ...     for frame in ld: ...
    """

    def __init__(self, paths, gray: bool = True, window: int = 8, threads: int = 4):
        self._lib = _lib()
        self.paths = [str(p) for p in paths]
        self.gray = gray
        arr = (ctypes.c_char_p * len(self.paths))(*[p.encode() for p in self.paths])
        self._handle = self._lib.loader_create(
            arr, len(self.paths), int(gray), window, threads
        )
        self._buf = np.empty(_MAX_BYTES // 4, np.float32)

    def __len__(self):
        return len(self.paths)

    def __iter__(self):
        for i in range(len(self.paths)):
            yield self.fetch(i)

    def fetch(self, idx: int) -> np.ndarray:
        w = ctypes.c_int32()
        h = ctypes.c_int32()
        ch = ctypes.c_int32()
        ok = self._lib.loader_fetch(
            self._handle, idx,
            self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._buf.nbytes, ctypes.byref(w), ctypes.byref(h), ctypes.byref(ch),
        )
        if not ok:
            raise IOError(f"native decode failed: {self.paths[idx]}")
        n = w.value * h.value * ch.value
        out = self._buf[:n].reshape(h.value, w.value, ch.value).copy()
        return out[..., 0] if ch.value == 1 else out

    def close(self):
        if self._handle:
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
