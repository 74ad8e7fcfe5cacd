"""Build and load the CUDA kernels of ``ops/csrc``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes``. Nothing is built when a module is
imported: the first call of a kernel on a CUDA tensor builds its library, or
:func:`build` builds several at once, one ``nvcc`` process per source, all
started together. Libraries go into ``build/cuda/`` at the root of the
checkout, named by a hash of the source and the flags, so an edited source
is rebuilt and an unchanged one is loaded as it is.

Three shipping sources (``aggregate``, ``wta_stats``, ``right_disparity``)
are built a second time with ``-DSVT_VARIANTS`` into libraries of their own
(:data:`VARIANTS`), which add the ports of the measurement scripts'
variants (``ops.bench_cuda``); the shipping libraries stay as they were and
the two builds run side by side.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cuda"
KERNELS = ("census", "cost", "aggregate", "wta_stats", "right_disparity", "shift_gather",
           "speckle", "nearest_lohi", "aggregate_dir", "wta", "sum_wta", "median")
# variant library → the shipping source it is built from, with -DSVT_VARIANTS
VARIANTS = {"aggregate_variants": "aggregate", "wta_stats_variants": "wta_stats",
            "right_disparity_variants": "right_disparity"}
LIBRARIES = KERNELS + tuple(VARIANTS)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def source(name: str) -> Path:
    return CSRC / f"{VARIANTS.get(name, name)}.cu"


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + (("-DSVT_VARIANTS",) if name in VARIANTS else ())


def library_path(name: str) -> Path:
    digest = hashlib.sha256(source(name).read_bytes() + " ".join(_flags(name)).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names=LIBRARIES) -> dict[str, str]:
    """Build the libraries of ``names`` that are not built yet, one ``nvcc``
    per source, all at once. Returns the compiler's messages (register and
    shared-memory use from ``-Xptxas -v``) by kernel name; raises with the
    compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(name), "-o", str(tmp), str(source(name))]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    messages, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        messages[name] = text
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name} (exit {proc.returncode}):\n{text}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return messages


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
