"""The port's binding of the host C++ code in ``native/``.

Counterpart of ``stereovision_tpu/ops/native.py``. The sources of
``native/`` are compiled with ``g++`` into two libraries of their own under
``build/native/`` at the root of the checkout (gitignored), named by a hash
of the source, the flags and the compiler's version:

- ``speckle``: ``native/speckle.cpp``, the exact flood-fill speckle filter,
  which needs nothing but the C++ runtime;
- ``loader``: ``native/loader.cpp``, the threaded JPEG/PNG/PNM decoder,
  linked with ``-ljpeg -lpng`` (``io.native_loader``).

``native/libsvnative.so`` is the reference's library and is never rebuilt
or loaded here. Nothing is built when the module is imported. Where the
reference returns its input unfiltered without a compiler, this binding
raises with the compiler's message.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
NATIVE_DIR = ROOT / "native"
BUILD_DIR = ROOT / "build" / "native"
# library → (sources in native/, link flags)
LIBRARIES = {
    "speckle": (("speckle.cpp",), ()),
    "loader": (("loader.cpp",), ("-ljpeg", "-lpng", "-lpthread")),
}
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_loaded: dict[str, ctypes.CDLL] = {}
_failed: dict[str, str] = {}


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++) found: the native library cannot be built")
    return cxx


@functools.lru_cache(maxsize=None)
def _cxx_version(cxx: str) -> str:
    return subprocess.run([cxx, "--version"], capture_output=True, text=True,
                          timeout=60).stdout


def library_path(name: str) -> Path:
    sources, link = LIBRARIES[name]
    cxx = _cxx()
    version = _cxx_version(cxx)
    digest = hashlib.sha256()
    for src in sources:
        digest.update((NATIVE_DIR / src).read_bytes())
    digest.update(" ".join((cxx, version, *CXX_FLAGS, *link)).encode())
    return BUILD_DIR / f"libsv{name}-{digest.hexdigest()[:16]}.so"


def _build(name: str) -> Path:
    out = library_path(name)
    if out.exists():
        return out
    sources, link = LIBRARIES[name]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_cxx(), *CXX_FLAGS, "-o", str(tmp), *(str(NATIVE_DIR / s) for s in sources), *link]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native {name} library failed "
                           f"(exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The native library ``name`` ("speckle" or "loader"), built first if
    needed; raises ``RuntimeError`` with the reason where it cannot be
    built or loaded."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    if name in _failed:
        raise RuntimeError(_failed[name])
    try:
        lib = ctypes.CDLL(str(_build(name)))
    except (RuntimeError, OSError, subprocess.SubprocessError) as err:
        _failed[name] = f"native {name} library unavailable: {err}"
        raise RuntimeError(_failed[name]) from err
    if name == "speckle":
        lib.filter_speckles.restype = ctypes.c_int64
        lib.filter_speckles.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int32, ctypes.c_int32,
            ctypes.c_float, ctypes.c_int32, ctypes.c_float,
        ]
    _loaded[name] = lib
    return lib


def available(name: str = "speckle") -> bool:
    """Whether library ``name`` builds and loads here (:func:`why_unavailable`
    says why not)."""
    try:
        load(name)
    except RuntimeError:
        return False
    return True


def why_unavailable(name: str = "speckle") -> str | None:
    return None if available(name) else _failed[name]


def filter_speckles(disp, new_val: float, max_speckle_size: int,
                    max_diff: float) -> tuple[np.ndarray, int]:
    """Exact cv2.filterSpeckles semantics on the host (4-connected flood
    fill; components of at most ``max_speckle_size`` pixels set to
    ``new_val``). Returns (filtered float32 copy, pixels removed)."""
    lib = load("speckle")
    out = np.ascontiguousarray(disp, dtype=np.float32).copy()
    h, w = out.shape
    removed = lib.filter_speckles(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        np.int32(h), np.int32(w),
        np.float32(new_val), np.int32(max_speckle_size), np.float32(max_diff),
    )
    return out, int(removed)
