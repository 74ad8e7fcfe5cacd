"""The seam between the kernel wrappers and the CUDA sources, read as text
(no ``nvcc`` needed): every C entry a wrapper binds through
``sgm_cuda._SIGNATURES`` (the engine's, and the measurement variants'
that ``ops.bench_cuda`` registers) is defined in its library's source with
the parameters ``ctypes`` passes it, in the build that holds it; and every
C entry of a shipping source is bound by some wrapper.
"""

import re

import pytest

from stereovision_tpu_torch.ops import _build, sgm_cuda
from stereovision_tpu_torch.ops import bench_cuda  # noqa: F401 (registers the variant entries)

_VARIANT_BLOCK = re.compile(r"#ifdef SVT_VARIANTS\n.*?#endif  // SVT_VARIANTS", re.S)
# the C type of each ctypes argument type of a signature
_C_TYPES = {sgm_cuda._P: "pointer", sgm_cuda._I: "int", sgm_cuda._L: "long long",
            sgm_cuda._F: "float"}
# entries called through sgm_cuda._entry directly, not launched on a stream
_NO_STREAM = {"speckle_columns"}


def _library(kernel: str) -> str:
    _, _, *library = sgm_cuda._SIGNATURES[kernel]
    return library[0] if library else kernel


def _c_type(param: str) -> str:
    """``const void* img`` → pointer; ``long long npix`` → long long."""
    if "*" in param:
        return "pointer"
    return " ".join(param.split()[:-1])


def _entries(text: str) -> dict:
    """{symbol: (its parameters, the offset of its definition)} of every
    ``extern "C" int`` entry of a source."""
    found = {}
    for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
        params = [" ".join(p.split()) for p in m.group(2).split(",") if p.strip()]
        found[m.group(1)] = (params, m.start())
    return found


@pytest.mark.parametrize("kernel", sorted(sgm_cuda._SIGNATURES))
def test_each_signature_names_an_entry_of_its_source(kernel):
    symbol, argtypes, *_ = sgm_cuda._SIGNATURES[kernel]
    library = _library(kernel)
    text = _build.source(library).read_text()
    entries = _entries(text)
    assert symbol in entries, f"{symbol} is not defined in {_build.source(library).name}"
    params, at = entries[symbol]
    assert [_c_type(p) for p in params] == [_C_TYPES[t] for t in argtypes], params
    assert (params[-1] == "void* stream") == (kernel not in _NO_STREAM), params
    # a variant library's entry exists only in the -DSVT_VARIANTS build
    inside = any(b.start() < at < b.end() for b in _VARIANT_BLOCK.finditer(text))
    assert inside == (library in _build.VARIANTS)


@pytest.mark.parametrize("source", _build.KERNELS)
def test_every_entry_of_a_source_has_a_caller(source):
    text = (_build.CSRC / f"{source}.cu").read_text()
    bound = {symbol for kernel, (symbol, *_) in sgm_cuda._SIGNATURES.items()
             if _build.source(_library(kernel)).name == f"{source}.cu"}
    assert set(_entries(text)) <= bound, set(_entries(text)) - bound
