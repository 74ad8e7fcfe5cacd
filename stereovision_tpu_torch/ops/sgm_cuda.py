"""CUDA kernels of the SGM engine, each beside its plain version.

Counterpart of ``stereovision_tpu/ops/sgm_pallas.py``. Twelve kernels,
written by hand for Hopper (``csrc/*.cu``, built by :mod:`._build`):

- :func:`census_words`         ← ``sgm_pallas.census_words``
- :func:`cost_volume`          ← ``sgm_pallas.cost_volume_planes``
- :func:`aggregate_dir`        ← ``sgm_pallas.aggregate_dir``
- :func:`aggregate_dual`       ← ``sgm_pallas.aggregate_dual`` (chain mode too)
- :func:`wta_stats_from_duals` ← ``sgm_pallas.wta_stats_from_duals``
- :func:`right_disparity`      ← ``sgm_pallas.right_disparity``
- :func:`shift_gather`         ← ``sgm_pallas.shift_gather``
- :func:`speckle_counts`       ← ``sgm_pallas.speckle_counts``
- :func:`nearest_valid_lohi`   ← ``sgm_pallas.nearest_valid_lohi``
- :func:`wta`                  ← ``sgm_pallas.wta``
- :func:`sum_wta_fused`        ← ``scripts/bench_sumwta.py:110``
  (``make_pallas``): the four path volumes of a full search summed, their
  winner statistics and the int16 sum, in one read of each volume; counted
  as ``sum_wta``
- :func:`median_blur`          ← no ``pallas_call``: ``core.image.median_blur``'s
  network (the JAX package's median is plain ``jnp``, which XLA fuses on a
  TPU), as one launch in place of a 25-view stack and 226 ``minimum``/
  ``maximum`` launches; bound by bytes (7.4 MB, ~2.2 µs at 720p), its
  network's 0.21 G min/max above that; counted as ``median``

``sum_wta`` and ``st_from_duals`` are XLA code in the reference and plain
PyTorch here: the engine calls ``sum_wta`` only for the horizontal pair
under ``stats_impl="xla"``, the formulation that option names.

Each wrapper sends a CPU tensor to its plain PyTorch version (``*_plain``)
and launches its kernel on a CUDA tensor, on the current stream; there is no
fallback from one to the other. A wrapper adds one to its count in
:func:`launch_counts` each time it launches its kernel (a replayed CUDA
graph adds its captured launches, :func:`add_launch_counts`);
``aggregate_dual`` counts its chain-mode launches apart, under
``aggregate_dual_chain``. The ports of the measurement scripts' variants
(:mod:`.bench_cuda`: the ``aggregate_dual``, ``wta_stats_from_duals`` and
``right_disparity`` families) add their counts to the same dict
(:func:`register`).

The kernels that keep a pixel's or a line's disparities in registers
(``aggregate_dir``, ``aggregate_dual``, ``wta_stats_from_duals``, ``wta``,
``sum_wta_fused``) take at most 32 a lane: D ≤ 1024 on a card.

Layouts are the GPU's own, not the TPU kernels': census words are
(nw, H, W) int32 and every volume is (H, W, D) with exactly D planes — no
128-lane padding, no lane packing, no mirrored census, no transposed copy
(each step of a horizontal or a vertical scan line reads D contiguous
bytes, and the LR check reads the summed volume's diagonal in place).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from stereovision_tpu_torch.core import image as im
from stereovision_tpu_torch.ops import _build

_BIG = 1e9
_BIGI = 1 << 29  # int "no competitor" sentinel (sum_wta on integer volumes)
_MASKED = _BIGI >> 8  # summed cost of a disparity plane at or past d_valid
MAX_PLANES = 1024  # disparities a register-resident kernel takes on a card

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "census": ("svt_census_words", (_P, _P) + (_I,) * 5 + (_P,)),
    "cost": ("svt_cost_volume", (_P, _P, _P) + (_I,) * 9 + (_P,)),
    "aggregate_dir": ("svt_aggregate_dir",
                      (_P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _P, _P, _P, _P, _P, _P)),
    "aggregate": ("svt_aggregate_dual",
                  (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _I, _P)),
    "speckle": ("svt_speckle_counts", (_P, _P, _I, _I, _I, _F, _I, _P)),
    "speckle_columns": ("svt_speckle_columns", (_I, _I), "speckle"),
    "wta_stats": ("svt_wta_stats_from_duals", (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P)),
    "right_disparity": ("svt_right_disparity", (_P, _P) + (_I,) * 6 + (_P,)),
    "shift_gather": ("svt_shift_gather", (_P, _P, _P, _I, _I, _I, _I, _P)),
    "nearest_lohi": ("svt_nearest_valid_lohi", (_P,) * 5 + (_I,) * 4 + (_P,)),
    "wta": ("svt_wta", (_P, _P, _P, _P, _P, _P, _L, _I, _P)),
    "sum_wta": ("svt_sum_wta", (_P,) * 10 + (_L,) + (_I,) * 6 + (_P,)),
    "median": ("svt_median_blur", (_P, _P, _I, _I, _I, _P)),
}
_fns: dict = {}
_launches: dict[str, int] = {}
# (current device index, raw handle of a device's current stream), read
# through PyTorch's C bindings where it has them (as Triton's launcher
# does): no torch.cuda.Stream object is built for a launch
_current: list = []


def _entry(kernel: str):
    fn = _fns.get(kernel)
    if fn is None:
        # (symbol, argument types[, library]): the library is the kernel's
        # own name unless the entry names another
        symbol, argtypes, *library = _SIGNATURES[kernel]
        fn = getattr(_build.load(library[0] if library else kernel), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[kernel] = fn
        if not _current:
            _current[:] = [
                getattr(torch._C, "_cuda_getDevice", torch.cuda.current_device),
                getattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: torch.cuda.current_stream(index).cuda_stream)]
    return fn


def _launch(kernel: str, device: torch.device, *args) -> None:
    """Call kernel ``kernel``'s C entry on ``device``'s current stream, with
    ``device`` the current device (the runtime launches on the calling
    thread's current device; a mesh may hold several cards, and only then
    is the current device switched); raise on the error code it returns
    (``cudaGetLastError`` after the launch)."""
    fn = _entry(kernel)
    index = device.index
    current_device, raw_stream = _current
    if index == current_device():
        err = fn(*args, raw_stream(index))
    else:
        with torch.cuda.device(device):
            err = fn(*args, raw_stream(index))
    if err != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: cudaError {err}")


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if t.is_cuda and t.dtype == dtype and t.dim() == ndim and t.is_contiguous():
        return
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stat_maps(H: int, W: int, device) -> tuple:
    """((best, idx, cm, cp, competitor), their five data pointers): four
    float32 (H, W) maps and an int32 one, views of one allocation, made by
    one allocator call and one ``unbind`` (the pointers are the
    allocation's, stepped)."""
    maps = torch.empty((5, H, W), dtype=torch.float32, device=device)
    best, idx, cm, cp, comp = maps.unbind(0)
    p, step = maps.data_ptr(), 4 * H * W
    return ((best, idx.view(torch.int32), cm, cp, comp),
            (p, p + step, p + 2 * step, p + 3 * step, p + 4 * step))


def _check_planes(name: str, D: int) -> None:
    """A kernel that keeps D values in a warp's registers takes at most 32
    a lane."""
    if D > MAX_PLANES:
        raise NotImplementedError(
            f"{name} on a card takes at most {MAX_PLANES} disparities (32 a lane in "
            f"registers), got {D}")


def launch_counts() -> dict[str, int]:
    """Launches of each kernel wrapper since the last reset, by name."""
    return dict(_launches)


def reset_launch_counts() -> None:
    _launches.update({name: 0 for name in (*COUNTS, *_launches)})


def add_launch_counts(counts: dict[str, int]) -> None:
    """Add launches made without a wrapper call: a CUDA graph's replay of
    the ``counts`` its captured call made."""
    for name, n in counts.items():
        _launches[name] += n


def register(signatures: dict, counts) -> None:
    """Add kernels beside the engine's (``ops.bench_cuda``'s ports of the
    measurement scripts' variants): their C entries, as in ``_SIGNATURES``,
    and their launch-count names, set to 0."""
    _SIGNATURES.update(signatures)
    _launches.update({name: 0 for name in counts})


# ---------------------------------------------------------------------------
# Census words
# ---------------------------------------------------------------------------


def census_words_plain(img: torch.Tensor, ksize: int = 5, wsize: int = 5) -> torch.Tensor:
    """(H, W) image → (nw, H, W) int32 census words (census_transform's bit
    order, words leading)."""
    return im.census_transform(img.to(torch.float32), ksize, wsize).permute(2, 0, 1).contiguous()


# census window (ksize, wsize) → the census kernel's templated instance
CENSUS_FORMS = {(3, 3): 1, (5, 5): 2, (7, 5): 3, (7, 7): 4, (9, 7): 5}


def census_design(ksize: int, wsize: int) -> int:
    """The instance :func:`census_words` launches on a card for a ksize-wide,
    wsize-high window: one of ``CENSUS_FORMS``' values (compares unrolled
    with constant bit positions), or 0, the same staged kernel with runtime
    window loops."""
    return CENSUS_FORMS.get((ksize, wsize), 0)


def census_words(img: torch.Tensor, ksize: int = 5, wsize: int = 5) -> torch.Tensor:
    """(H, W) float32 image → (nw, H, W) int32 census words; ``ksize`` is the
    window width, ``wsize`` its height (see :func:`census_design` for the
    kernel's instances)."""
    if img.device.type == "cpu":
        return census_words_plain(img, ksize, wsize)
    _check(img, "img", torch.float32, 2)
    H, W = img.shape
    nw = (ksize * wsize - 1 + 31) // 32
    out = torch.empty((nw, H, W), dtype=torch.int32, device=img.device)
    _launch("census", img.device, img.data_ptr(), out.data_ptr(), H, W, ksize, wsize,
            census_design(ksize, wsize))
    _launches["census_words"] += 1
    return out


# ---------------------------------------------------------------------------
# Hamming cost volume
# ---------------------------------------------------------------------------


def cost_volume_plain(cl: torch.Tensor, cr: torch.Tensor, num_disparities: int,
                      min_d: int, max_cost: int) -> torch.Tensor:
    """(nw, H, W) census pair → (H, W, D) int8 with
    cost[y, x, d] = popcount(cl[:, y, x] ^ cr[:, y, x − min_d − d]), and
    ``max_cost`` where that column leaves the image."""
    _, H, W = cl.shape
    out = torch.empty((H, W, num_disparities), dtype=torch.int8, device=cl.device)
    x = torch.arange(W, device=cl.device)
    for d in range(num_disparities):
        src = x - min_d - d
        valid = (src >= 0) & (src <= W - 1)
        shifted = cr[:, :, src.clamp(0, W - 1)]
        cost = im.popcount32(cl ^ shifted).sum(dim=0, dtype=torch.int32)
        out[:, :, d] = torch.where(valid[None, :], cost, max_cost).to(torch.int8)
    return out


_COST_THREADS = 256
_COST_SPAN = 49152  # bytes of a block's output span, where TX = 32 allows it


def _bank_ways(words, sh: int) -> int:
    """The most distinct shared-memory words that 32 lanes' accesses to
    logical ``words`` put on one bank, with a pad word every 2^sh words."""
    ways = [set() for _ in range(32)]
    for q in words:
        p = q + (q >> sh)
        ways[p % 32].add(p)
    return max(len(w) for w in ways)


@functools.lru_cache(maxsize=None)
def cost_design(D: int, nw: int) -> tuple[int, int, int]:
    """(instance, TX, sh) that :func:`cost_volume` launches on a card for D
    disparities and nw census words a pixel: the instance is nw (1 or 2,
    popcounts unrolled) or 0 (any nw, a runtime loop); a block owns TX
    columns of a row, the largest power of two from 32 to 256 whose output
    span TX*D stays within 48 KB (32 past that); and the staged span has a
    pad word every 2^sh words, sh in 2..7 the one that puts the fewest
    accesses on one bank, summed over the lanes' 4-byte stores (32 pixels,
    D bytes apart) and the copy-out's loads (32 consecutive 16-byte chunks);
    ties to the larger sh (less padding)."""
    tx = _COST_THREADS
    while tx > 32 and tx * D > _COST_SPAN:
        tx //= 2

    def ways(sh):
        store = max(_bank_ways([(lane * D) // 4 + k for lane in range(32)], sh)
                    for k in range(4))
        copy = max(_bank_ways([4 * c + k for c in range(c0, c0 + 32)], sh)
                   for k in range(4) for c0 in (0, 7))
        return store + copy, -sh

    return (nw if nw in (1, 2) else 0), tx, min(range(2, 8), key=ways)


def cost_volume(cl: torch.Tensor, cr: torch.Tensor, num_disparities: int,
                min_d: int, max_cost: int) -> torch.Tensor:
    """(nw, H, W) int32 census of the left and the right image → (H, W, D)
    int8 Hamming costs (see :func:`cost_volume_plain`, and
    :func:`cost_design` for the kernel's instances)."""
    if cl.device.type == "cpu":
        return cost_volume_plain(cl, cr, num_disparities, min_d, max_cost)
    _check(cl, "cl", torch.int32, 3)
    _check(cr, "cr", torch.int32, 3)
    if cl.shape != cr.shape:
        raise ValueError(f"census shapes differ: {tuple(cl.shape)} vs {tuple(cr.shape)}")
    if not 0 <= max_cost <= 127:
        raise ValueError(f"max_cost {max_cost} does not fit int8")
    nw, H, W = cl.shape
    out = torch.empty((H, W, num_disparities), dtype=torch.int8, device=cl.device)
    form, tx, sh = cost_design(num_disparities, nw)
    _launch("cost", cl.device, cl.data_ptr(), cr.data_ptr(), out.data_ptr(), H, W,
            num_disparities, nw, min_d, int(max_cost), form, tx.bit_length() - 1, sh)
    _launches["cost_volume"] += 1
    return out


# ---------------------------------------------------------------------------
# SGM path aggregation
# ---------------------------------------------------------------------------


def _sgm_step_norm(n_prev: torch.Tensor, c: torch.Tensor, p1: float, p2: float) -> torch.Tensor:
    """One SGM step over (…, D) with a min-normalized carry
    ``n_prev = L_prev − min(L_prev)``: L = c + min(n, P2, n[d±1] + P1), with
    n[−1] and n[D] at +BIG. The kernel computes exactly these float32 sums."""
    big = torch.full_like(n_prev[..., :1], _BIG)
    shift_m = torch.cat([big, n_prev[..., :-1]], dim=-1)
    shift_p = torch.cat([n_prev[..., 1:], big], dim=-1)
    best = torch.minimum(n_prev.clamp(max=p2), torch.minimum(shift_m, shift_p) + p1)
    return c + best


def _renorm(l: torch.Tensor) -> torch.Tensor:
    """L → next normalized carry (min-zero over the disparity axis)."""
    return l - l.amin(dim=-1, keepdim=True)


def _scan(cost: torch.Tensor, p1: float, p2: float, axis: int, reverse: bool,
          seed: torch.Tensor | None = None):
    """One SGM path direction along ``axis`` → (float32 path costs of the
    shape of ``cost``, the normalised carry after the last step). Without
    ``seed`` the first step is L = c; with it every step, the first
    included, starts from the carry (a zero seed is a fresh start). A
    Python loop over the scan axis of vectorised steps."""
    S = cost.shape[axis]
    out = torch.empty(cost.shape, dtype=torch.float32, device=cost.device)
    n = seed
    for i in (range(S - 1, -1, -1) if reverse else range(S)):
        c = cost.select(axis, i).to(torch.float32)
        l = c if n is None else _sgm_step_norm(n, c, p1, p2)
        n = _renorm(l)
        out.select(axis, i).copy_(l)
    return out, n


def aggregate_dir_plain(cost: torch.Tensor, p1: float, p2: float, axis: int = 0,
                        reverse: bool = False, acc: torch.Tensor | None = None) -> torch.Tensor:
    """One SGM path direction along ``axis`` (0 or 1) of an (H, W, D) cost
    volume → float32 path costs of the same shape; ``reverse`` scans from the
    far end. With ``acc`` the path costs are added onto it in place and
    ``acc`` is returned."""
    l, _ = _scan(cost, p1, p2, axis, reverse)
    return l if acc is None else acc.add_(l)


def aggregate_dir_wta_plain(cost: torch.Tensor, p1: float, p2: float, axis: int = 0,
                            reverse: bool = False, acc: torch.Tensor | None = None):
    """:func:`aggregate_dir_plain`, then the :func:`wta_plain` statistics of
    the volume it returns: (out, best, idx, cm, cp, competitor)."""
    out = aggregate_dir_plain(cost, p1, p2, axis, reverse, acc)
    return (out, *wta_plain(out))


def aggregate_dir(cost: torch.Tensor, p1: float, p2: float, axis: int = 0,
                  reverse: bool = False, acc: torch.Tensor | None = None,
                  wta_out: bool = False):
    """(H, W, D) float32 cost → float32 path costs of one direction along
    ``axis`` (0: down the columns, 1: along the rows; ``reverse`` from the far
    end). With ``acc``, an (H, W, D) float32 running sum, the path costs are
    added onto ``acc`` in place and ``acc`` is returned: the port updates it
    where the reference aliases its input and output.

    ``wta_out`` (axis 0 only, as the reference asserts) also returns the
    :func:`wta` statistics of the volume written: (out, best, idx, cm, cp,
    competitor), which the kernel takes from each row as it stores it."""
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    if wta_out and axis != 0:
        raise ValueError("wta_out needs an axis-0 pass (the reference's final pass)")
    if acc is not None and acc.shape != cost.shape:
        raise ValueError(f"acc {tuple(acc.shape)} does not match cost {tuple(cost.shape)}")
    if cost.device.type == "cpu":
        if wta_out:
            return aggregate_dir_wta_plain(cost, p1, p2, axis, reverse, acc)
        return aggregate_dir_plain(cost, p1, p2, axis, reverse, acc)
    _check_planes("aggregate_dir", cost.shape[-1])
    _check(cost, "cost", torch.float32, 3)
    if acc is not None:
        _check(acc, "acc", torch.float32, 3)
    H, W, D = cost.shape
    out = torch.empty_like(cost) if acc is None else acc
    stats, ptrs = _stat_maps(H, W, cost.device) if wta_out else ((), (None,) * 5)
    _launch("aggregate_dir", cost.device, cost.data_ptr(), out.data_ptr(), H, W, D, axis,
            int(reverse), float(p1), float(p2), int(acc is not None), *ptrs)
    _launches["aggregate_dir"] += 1
    return (out, *stats) if wta_out else out


def _store(l: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    # float → int8 does not saturate: clamp explicitly, as the TPU store did
    if out_dtype == torch.int8:
        l = l.clamp(max=127.0)
    return l.to(out_dtype)


def _chain_args(cost, axis, boundary, return_final, cost_b):
    """Validate chain mode's arguments as the reference does
    (``sgm_pallas.py:914-920``): axis 0, and a boundary with
    ``return_final``; returns whether chain mode is on."""
    chain = boundary is not None or return_final or cost_b is not None
    if not chain:
        return False
    if axis != 0:
        raise ValueError(f"chain mode (boundary, return_final, cost_b) needs axis 0, got {axis}")
    if boundary is None or not return_final:
        raise ValueError("chain mode takes a boundary and returns the final carries together")
    H, W, D = cost.shape
    for b in boundary:
        if tuple(b.shape) != (W, D):
            raise ValueError(f"boundary rows must be (W, D) = {(W, D)}, got {tuple(b.shape)}")
    if cost_b is not None and cost_b.shape != cost.shape:
        raise ValueError(f"cost_b {tuple(cost_b.shape)} does not match cost {tuple(cost.shape)}")
    if any(t.device != cost.device for t in (*boundary, cost if cost_b is None else cost_b)):
        raise ValueError("chain mode's boundary rows and cost_b must lie on cost's device")
    return True


def aggregate_dual_plain(cost: torch.Tensor, p1: float, p2: float, axis: int = 0,
                         out_dtype: torch.dtype = torch.int16, boundary=None,
                         return_final: bool = False, cost_b: torch.Tensor | None = None):
    """Both path directions along ``axis`` → (L_fwd, L_bwd) in ``out_dtype``
    (int8 stores clamp at 127; the carries never do); in chain mode (see
    :func:`aggregate_dual`) also the two final normalised carries."""
    if not _chain_args(cost, axis, boundary, return_final, cost_b):
        return tuple(_store(_scan(cost, p1, p2, axis, reverse)[0], out_dtype)
                     for reverse in (False, True))
    lf, ff = _scan(cost, p1, p2, 0, False, boundary[0].to(torch.float32))
    lb, fb = _scan(cost if cost_b is None else cost_b, p1, p2, 0, True,
                   boundary[1].to(torch.float32))
    return _store(lf, out_dtype), _store(lb, out_dtype), ff, fb


def aggregate_dual(cost: torch.Tensor, p1: float, p2: float, axis: int = 0,
                   out_dtype: torch.dtype = torch.int16, boundary=None,
                   return_final: bool = False, cost_b: torch.Tensor | None = None):
    """(H, W, D) int8 cost → (L_fwd, L_bwd) path costs along ``axis``: 0 scans
    down the columns (vertical paths), 1 along the rows (horizontal paths).
    ``out_dtype`` is int8 (stores clamp at 127) or int16.

    Chain mode (the cross-tile vertical chain of ``parallel.disparity_exact``;
    axis 0 only, ``boundary`` and ``return_final`` together): ``boundary`` is
    a pair (bf, bb) of (W, D) float32 min-normalised carry rows from which
    the forward and the backward scan start (every row, the first included,
    takes the step from its carry; zeros are a fresh start), ``cost_b`` an
    optional volume for the backward scan (default ``cost``), and the result
    is (L_fwd, L_bwd, ff, fb) with ff the normalised carry after row H−1 and
    fb the one after row 0: what the next tile's boundary expects."""
    if out_dtype not in (torch.int8, torch.int16):
        raise TypeError(f"out_dtype must be int8 or int16, got {out_dtype}")
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    chain = _chain_args(cost, axis, boundary, return_final, cost_b)
    if cost.device.type == "cpu":
        return aggregate_dual_plain(cost, p1, p2, axis, out_dtype, boundary, return_final,
                                    cost_b)
    _check_planes("aggregate_dual", cost.shape[-1])
    _check(cost, "cost", torch.int8, 3)
    H, W, D = cost.shape
    lf, lb = torch.empty((2, H, W, D), dtype=out_dtype, device=cost.device)
    cost_b = cost if cost_b is None else cost_b
    ptrs = [None] * 4  # seed_f, seed_b, final_f, final_b
    if chain:
        _check(cost_b, "cost_b", torch.int8, 3)
        for b, name in zip(boundary, ("bf", "bb")):
            _check(b, name, torch.float32, 2)
        ff, fb = torch.empty((2, W, D), dtype=torch.float32, device=cost.device)
        ptrs = [boundary[0].data_ptr(), boundary[1].data_ptr(), ff.data_ptr(), fb.data_ptr()]
    _launch("aggregate", cost.device, cost.data_ptr(), cost_b.data_ptr(), ptrs[0], ptrs[1],
            lf.data_ptr(), lb.data_ptr(), ptrs[2], ptrs[3], H, W, D, axis, float(p1),
            float(p2), lf.element_size())
    if chain:
        _launches["aggregate_dual_chain"] += 1
        return lf, lb, ff, fb
    _launches["aggregate_dual"] += 1
    return lf, lb


# ---------------------------------------------------------------------------
# Winner statistics
# ---------------------------------------------------------------------------


def _wta_stats(s: torch.Tensor):
    """Winner statistics over the last (disparity) axis of s (…, D): (best,
    idx, cost[idx−1], cost[idx+1], best competitor with |d−idx| > 1). Ties go
    to the smallest d; neighbours outside [0, D) and a missing competitor
    come back as BIG."""
    D = s.shape[-1]
    big = _BIG if s.is_floating_point() else _BIGI
    best, idx = torch.min(s, dim=-1)
    cm = s.gather(-1, (idx - 1).clamp(min=0)[..., None])[..., 0]
    cp = s.gather(-1, (idx + 1).clamp(max=D - 1)[..., None])[..., 0]
    cm = torch.where(idx > 0, cm, big)
    cp = torch.where(idx < D - 1, cp, big)
    d = torch.arange(D, device=s.device)
    comp = torch.where((d - idx[..., None]).abs() > 1, s, big).amin(dim=-1)
    return best, idx, cm, cp, comp


def _float_stats(best, idx, cm, cp, comp):
    return best.float(), idx.to(torch.int32), cm.float(), cp.float(), comp.float()


def _lr_volume(s: torch.Tensor, two_int8: bool) -> torch.Tensor:
    """The int32 summed volume → the form the LR check reads (the
    reference's s_t values, kept in the (H, W, D) layout): the sum of two
    int8 path volumes (≤ 254) offset by −128 as int8, else int16 clamped at
    30000. Both keep the argmin order of the sum."""
    if two_int8:
        return (s - 128).to(torch.int8)
    return s.clamp(max=30000).to(torch.int16)


def sum_wta(vols, emit_sum: bool = False):
    """Two (horizontal pair) or four per-direction path volumes (H, W, D) →
    (s, best, idx, cm, cp, competitor): the winner statistics of their int32
    sum as float32 (idx int32), and with ``emit_sum`` the summed volume for
    :func:`right_disparity` (see :func:`_lr_volume`; None without). The
    counterpart of ``sgm_pallas.sum_wta``, plain PyTorch, as the
    reference's is plain XLA."""
    s = vols[0].to(torch.int32)
    for v in vols[1:]:
        s = s + v
    stats = _float_stats(*_wta_stats(s))
    lr = None
    if emit_sum:
        lr = _lr_volume(s, len(vols) == 2 and vols[0].dtype == torch.int8)
    return (lr, *stats)


def st_from_duals(hf: torch.Tensor, hb: torch.Tensor) -> torch.Tensor:
    """Just the summed volume of the horizontal pair for
    :func:`right_disparity` (``sgm_pallas.st_from_duals`` without its
    transpose): int8 offset by −128 for int8 duals, int16 otherwise."""
    return _lr_volume(hf.to(torch.int32) + hb, hf.dtype == torch.int8)


# ---------------------------------------------------------------------------
# Sum of four path volumes + winner statistics, fused
# ---------------------------------------------------------------------------

SUM_EMITS = {"none": 0, "hwd": 1, "dhw": 2}
_S_CLAMP = 30000
_SUM_THREADS = 256  # a block of csrc/sum_wta.cu


def _check_d_valid(D: int, d_valid):
    d_valid = D if d_valid is None else d_valid
    if not 0 < d_valid <= D:
        raise ValueError(f"d_valid must be in (0, {D}], got {d_valid}")
    return d_valid


def sum_wta_fused_plain(hf, hb, vf, vb, d_valid: int | None = None, emit: str = "hwd"):
    """The int32 sum of four (H, W, D) path volumes, planes ≥ ``d_valid``
    at 2²¹ → (s, best, idx, cm, cp, competitor): the script's key
    min(s, 2³⁰/dp − 1)·dp + d (dp the next power of two ≥ D) gives best and
    idx, cm, cp and the competitor are 2²⁹ where no such plane exists, all
    float32 but idx (int32); s is min(sum, 30000) as int16 in (H, W, D)
    (``emit="hwd"``) or (D, H, W) (``"dhw"``), or None (``"none"``). At
    d_valid = D, :func:`sum_wta` of the four volumes computes the same."""
    s = hf.to(torch.int32) + hb + vf + vb
    D = s.shape[-1]
    d_valid = _check_d_valid(D, d_valid)
    d = torch.arange(D, device=s.device)
    if d_valid < D:
        s = torch.where(d >= d_valid, _MASKED, s)
    dp = 1 << (D - 1).bit_length()
    kmin = (s.clamp(max=(1 << 30) // dp - 1) * dp + d).amin(dim=-1)
    best, idx = kmin // dp, kmin % dp
    cm = torch.where(d == idx[..., None] - 1, s, _BIGI).amin(dim=-1)
    cp = torch.where(d == idx[..., None] + 1, s, _BIGI).amin(dim=-1)
    comp = torch.where((d - idx[..., None]).abs() > 1, s, _BIGI).amin(dim=-1)
    vol = None
    if emit != "none":
        vol = s.clamp(max=_S_CLAMP).to(torch.int16)
        if emit == "dhw":
            vol = vol.permute(2, 0, 1).contiguous()
    return (vol, *_float_stats(best, idx, cm, cp, comp))


class SumWtaDesign(NamedTuple):
    g: int  # lanes a pixel, a power of two
    p: int  # pixels a block
    q: int  # contiguous planes a lane, a multiple of 4
    vec: bool  # a lane's runs load as 16-byte vectors (16-byte aligned volumes)
    words: bool  # every lane's run of the hwd sum stores as whole words


@functools.lru_cache(maxsize=None)
def sum_wta_design(D: int, itemsize: int) -> SumWtaDesign:
    """The instance :func:`sum_wta_fused` launches on a card for D planes of
    ``itemsize``-byte volumes: G, the least power of two that leaves at most
    32 planes a lane, lanes share a pixel; a block of 256 threads takes
    P = 256 / G pixels; a lane holds Q planes, the least multiple of 4 ≥
    D / G. A lane's runs load as 16-byte vectors where each pixel's and each
    run's bytes are multiples of 16 (else as funnel-shifted words), and its
    run of the int16 sum stores as whole words where D is even (an odd D
    puts every other pixel's runs two bytes off a word: a half, words, a
    half). See ``csrc/sum_wta.cu``."""
    g = 1
    while -(-D // g) > 32:
        g *= 2
    q = (-(-D // g) + 3) // 4 * 4
    vec = D * itemsize % 16 == 0 and q * itemsize % 16 == 0
    return SumWtaDesign(g, _SUM_THREADS // g, q, vec, D % 2 == 0)


def _sum_wta_check(vols, d_valid, emit: str) -> int:
    """Check four volumes' emit, shapes and d_valid on any device → d_valid."""
    if emit not in SUM_EMITS:
        raise ValueError(f"emit must be one of {tuple(SUM_EMITS)}, got {emit!r}")
    if any(v.shape != vols[0].shape for v in vols):
        raise ValueError(f"volume shapes differ: {[tuple(v.shape) for v in vols]}")
    return _check_d_valid(vols[0].shape[-1], d_valid)


def _sum_wta_outputs(name: str, vols, d_valid: int, emit: str):
    """Check four volumes for a launch of ``csrc/sum_wta.cu`` (``name``'s
    entry) and allocate its outputs → (the volume or None, the five maps,
    the C arguments up to d_valid)."""
    hf = vols[0]
    H, W, D = hf.shape
    _check_planes(name, D)
    if hf.dtype not in (torch.int8, torch.int16):
        raise TypeError(f"hf must be int8 or int16, got {hf.dtype}")
    for v, vname in zip(vols, ("hf", "hb", "vf", "vb")):
        _check(v, vname, hf.dtype, 3)
    vol = None
    if emit != "none":
        vol = torch.empty((D, H, W) if emit == "dhw" else (H, W, D), dtype=torch.int16,
                          device=hf.device)
    stats, ptrs = _stat_maps(H, W, hf.device)
    args = (*(v.data_ptr() for v in vols), None if vol is None else vol.data_ptr(), *ptrs,
            H * W, D, d_valid)
    return vol, stats, args


def sum_wta_fused(hf, hb, vf, vb, d_valid: int | None = None, emit: str = "hwd"):
    """Four (H, W, D) int8 or int16 path volumes (the horizontal and the
    vertical pair) → (s, best, idx, cm, cp, competitor), see
    :func:`sum_wta_fused_plain`; one read of each volume (see
    :func:`sum_wta_design` for the kernel's instances)."""
    vols = (hf, hb, vf, vb)
    d_valid = _sum_wta_check(vols, d_valid, emit)
    if hf.device.type == "cpu":
        return sum_wta_fused_plain(hf, hb, vf, vb, d_valid, emit)
    vol, stats, args = _sum_wta_outputs("sum_wta", vols, d_valid, emit)
    g, _, q, _, _ = sum_wta_design(hf.shape[-1], hf.element_size())
    _launch("sum_wta", hf.device, *args, SUM_EMITS[emit], hf.element_size(),
            g.bit_length() - 1, q)
    _launches["sum_wta"] += 1
    return (vol, *stats)


# ---------------------------------------------------------------------------
# Winner statistics of two dual volumes
# ---------------------------------------------------------------------------


def wta_stats_from_duals_plain(hf: torch.Tensor, hb: torch.Tensor, d_valid: int | None = None):
    """The :func:`_wta_stats` of hf + hb with planes ≥ ``d_valid`` at
    2²¹ (the reference's masked lanes), as float32 maps and an int32 idx."""
    s = hf.to(torch.int32) + hb
    D = s.shape[-1]
    if d_valid is not None and d_valid < D:
        s = torch.where(torch.arange(D, device=s.device) >= d_valid, _MASKED, s)
    return _float_stats(*_wta_stats(s))


def wta_stats_from_duals(hf: torch.Tensor, hb: torch.Tensor, d_valid: int | None = None):
    """(H, W, D) int8 or int16 dual path volumes → (best, idx, cm, cp,
    competitor) of their sum, planes ≥ ``d_valid`` (default D) masked: four
    float32 (H, W) maps and an int32 idx, one read of each volume."""
    D = hf.shape[-1]
    d_valid = D if d_valid is None else d_valid
    if not 0 < d_valid <= D:
        raise ValueError(f"d_valid must be in (0, {D}], got {d_valid}")
    dev = hf.device
    if dev.type == "cpu":
        return wta_stats_from_duals_plain(hf, hb, d_valid)
    _check_planes("wta_stats_from_duals", D)
    dtype = hf.dtype
    if dtype not in (torch.int8, torch.int16):
        raise TypeError(f"hf must be int8 or int16, got {dtype}")
    _check(hf, "hf", dtype, 3)
    _check(hb, "hb", dtype, 3)
    shape = hf.shape
    if shape != hb.shape:
        raise ValueError(f"volume shapes differ: {tuple(shape)} vs {tuple(hb.shape)}")
    stats, ptrs = _stat_maps(shape[0], shape[1], dev)
    _launch("wta_stats", dev, hf.data_ptr(), hb.data_ptr(), *ptrs, shape[0] * shape[1], D,
            d_valid, hf.element_size())
    _launches["wta_stats_from_duals"] += 1
    return stats


# ---------------------------------------------------------------------------
# Right-view disparity (the LR check's second view)
# ---------------------------------------------------------------------------


def right_disparity_plain(s: torch.Tensor, d_valid: int | None = None) -> torch.Tensor:
    """dR[y, u] = argmin over d < d_valid with u + d < W of s[y, u + d, d]
    (strict <: ties to the smallest d), as int32: one pass over the
    diagonal per d."""
    H, W, D = s.shape
    d_valid = D if d_valid is None else d_valid
    best = torch.full((H, W), _BIG, dtype=torch.float32, device=s.device)
    idx = torch.zeros((H, W), dtype=torch.int32, device=s.device)
    for d in range(min(d_valid, W)):
        v = s[:, d:, d].to(torch.float32)
        take = v < best[:, :W - d]
        best[:, :W - d] = torch.where(take, v, best[:, :W - d])
        idx[:, :W - d] = torch.where(take, d, idx[:, :W - d])
    return idx


_RDISP_U = 128  # right pixels a block, a thread each
_RDISP_SPAN = 48 * 1024  # shared bytes of a block that stages its whole span, at most


def _span_ways(D: int, itemsize: int) -> int:
    """The most distinct words that 32 threads on consecutive right pixels
    put on one shared-memory bank when each reads its diagonal in a span
    whose image columns are D elements apart, whatever the span's start."""
    return max(_bank_ways([(o + j * D * itemsize) // 4 for j in range(32)], 30)
               for o in range(4))


def right_disparity_design(W: int, D: int, itemsize: int, d_valid: int) -> str:
    """How :func:`right_disparity`'s kernel stages the volume on a card. A
    block owns 128 right pixels of a row, a thread each, and walks the
    planes in tiles of 32. It stages either its whole span (``"span"``:
    every plane of the 128 + min(d_valid, W) − 1 image columns its pixels
    reach, where that fits 48 KB of shared memory and the D-element pitch
    puts at most 2 of a warp's reads on a bank, :func:`_span_ways`) or the
    rectangles of 32 planes one after the other (``"tiles"``, each lane
    walking its row's words from its own start: a warp's reads on 32
    banks). See ``csrc/right_disparity.cu``."""
    cols = min(W, _RDISP_U + min(d_valid, W) - 1)
    span = (cols * D * itemsize + 31) // 16 * 16
    fits = span <= _RDISP_SPAN and _span_ways(D, itemsize) <= 2
    return "span" if fits else "tiles"


@functools.lru_cache(maxsize=None)
def _rdisp_args(H: int, W: int, D: int, d_valid: int, itemsize: int) -> tuple:
    """The arguments of ``csrc/right_disparity.cu``'s entries after the two
    pointers: the shape, ``itemsize`` and 1 for tiles or 0 for the span
    (:func:`right_disparity_design`), made once a shape."""
    return H, W, D, d_valid, itemsize, int(
        right_disparity_design(W, D, itemsize, d_valid) == "tiles")


def right_disparity(s: torch.Tensor, d_valid: int | None = None) -> torch.Tensor:
    """(H, W, D) summed volume (int8 or int16, see :func:`sum_wta`) → (H, W)
    int32 right-view disparity indices (see :func:`right_disparity_plain`,
    and :func:`right_disparity_design` for the kernel's blocks)."""
    shape, dev = s.shape, s.device
    D = shape[-1]
    d_valid = D if d_valid is None else d_valid
    if not 0 < d_valid <= D:
        raise ValueError(f"d_valid must be in (0, {D}], got {d_valid}")
    if dev.type == "cpu":
        return right_disparity_plain(s, d_valid)
    if s.dtype not in (torch.int8, torch.int16):
        raise TypeError(f"s must be int8 or int16, got {s.dtype}")
    _check(s, "s", s.dtype, 3)
    H, W, _ = shape
    out = torch.empty((H, W), dtype=torch.int32, device=dev)
    _launch("right_disparity", dev, s.data_ptr(), out.data_ptr(),
            *_rdisp_args(H, W, D, d_valid, s.element_size()))
    _launches["right_disparity"] += 1
    return out


# ---------------------------------------------------------------------------
# Bounded horizontal gather
# ---------------------------------------------------------------------------


def shift_gather_plain(src: torch.Tensor, offsets: torch.Tensor, max_offset: int) -> torch.Tensor:
    """out[..., y, x] = src[..., y, x − off[y, x]], and 0 where the offset
    is outside [0, max_offset) or reaches left of the image (off > x)."""
    W = src.shape[-1]
    x = torch.arange(W, device=src.device)
    off = offsets.to(torch.int64)
    ok = (off >= 0) & (off < max_offset) & (off <= x)
    idx = torch.where(ok, x - off, 0).expand(src.shape)
    return torch.where(ok, src.gather(-1, idx), torch.zeros((), dtype=src.dtype, device=src.device))


def shift_gather(src: torch.Tensor, offsets: torch.Tensor, max_offset: int) -> torch.Tensor:
    """(H, W) or (B, H, W) float32 or int32 ``src`` and (H, W) int32
    offsets → out[..., y, x] = src[..., y, x − off[y, x]], 0 where the
    offset is outside [0, max_offset) or off > x; the B maps share the
    offsets. The reference's ``assume_clipped`` (its callers' promise that
    off ≤ x, which drops a compare from its roll loop) has no counterpart:
    the test costs one compare per pixel here."""
    if src.shape[-2:] != offsets.shape:
        raise ValueError(f"offsets {tuple(offsets.shape)} do not match src {tuple(src.shape)}")
    if src.device.type == "cpu":
        return shift_gather_plain(src, offsets, max_offset)
    if src.dtype not in (torch.float32, torch.int32):
        raise TypeError(f"src must be float32 or int32, got {src.dtype}")
    if src.ndim not in (2, 3):
        raise ValueError(f"src must be (H, W) or (B, H, W), got {tuple(src.shape)}")
    _check(src, "src", src.dtype, src.ndim)
    _check(offsets, "offsets", torch.int32, 2)
    H, W = offsets.shape
    B = src.shape[0] if src.ndim == 3 else 1
    out = torch.empty_like(src)
    _launch("shift_gather", src.device, src.data_ptr(), offsets.data_ptr(), out.data_ptr(),
            B, H, W, int(max_offset))
    _launches["shift_gather"] += 1
    return out


# ---------------------------------------------------------------------------
# Speckle window counts
# ---------------------------------------------------------------------------


def speckle_counts_plain(dv: torch.Tensor, k: int, r: float, nbins: int) -> torch.Tensor:
    """Per-bin k×k window sums of the two half-offset binnings, each masked by
    the centre's own bin, maxed over the binnings (exact in float32)."""
    count = torch.zeros_like(dv)
    for offset in (0.0, 0.5):
        b = torch.floor(dv / r + offset)
        c = torch.zeros_like(dv)
        for bi in range(nbins):
            ind = (b == bi).to(torch.float32)
            c = c + im.window_sum(ind, k) * ind
        count = torch.maximum(count, c)
    return count


def speckle_design(k: int, nbins: int) -> str:
    """The form :func:`speckle_counts` launches on a card for ``k`` and
    ``nbins``, as its C entry picks it up front: ``"columns"`` (running
    column counts) or ``"direct"`` (the k×k form, where k > 31 or
    nbins > 16). Loads the kernel's library."""
    return "columns" if _entry("speckle_columns")(k, nbins) else "direct"


def speckle_counts(dv: torch.Tensor, k: int, r: float, nbins: int) -> torch.Tensor:
    """(H, W) float32 field (invalid pixels at −2r) → (H, W) float32 count of
    same-bin pixels in the k×k replicate-padded window, maxed over the
    binnings floor(dv/r) and floor(dv/r + 0.5) (see :func:`speckle_design`
    for the kernel's two forms)."""
    if dv.device.type == "cpu":
        return speckle_counts_plain(dv, k, r, nbins)
    _check(dv, "dv", torch.float32, 2)
    H, W = dv.shape
    out = torch.empty_like(dv)
    _launch("speckle", dv.device, dv.data_ptr(), out.data_ptr(), H, W, k, float(r), nbins)
    _launches["speckle_counts"] += 1
    return out


# ---------------------------------------------------------------------------
# Nearest valid value along a line, both sides
# ---------------------------------------------------------------------------


def nearest_valid(values: torch.Tensor, valid: torch.Tensor, axis: int, reverse: bool = False):
    """Along ``axis``: the nearest valid value at or before each position
    (at or after, with ``reverse``), whether there is one, and its index
    (meaningless where there is none, where the value is 0). A running max
    of the valid indices, then a gather."""
    n = values.shape[axis]
    if reverse:
        values, valid = values.flip(axis), valid.flip(axis)
    shape = [1] * values.ndim
    shape[axis] = n
    idx = torch.arange(n, device=values.device).reshape(shape).expand(values.shape)
    src = torch.where(valid, idx, -1).cummax(dim=axis).values
    has = src >= 0
    val = torch.where(has, values.gather(axis, src.clamp(min=0)), 0.0)
    if reverse:
        val, has, src = val.flip(axis), has.flip(axis), n - 1 - src.flip(axis)
    return val, has, src


def nearest_valid_lohi_plain(disp: torch.Tensor, valid: torch.Tensor, d_up: torch.Tensor,
                             axis: int = 1):
    """Along ``axis``: the min and the max of the nearest valid value on
    either side, ``d_up`` standing in for a side that has none."""
    lv, lhas, _ = nearest_valid(disp, valid, axis)
    rv, rhas, _ = nearest_valid(disp, valid, axis, reverse=True)
    lv = torch.where(lhas, lv, d_up)
    rv = torch.where(rhas, rv, d_up)
    return torch.minimum(lv, rv), torch.maximum(lv, rv)


_LOHI_THREADS = 512  # axis 1: a block at most
_LOHI_COL_THREADS = 256  # axis 0: a block of 32 columns, 8 warps of 8 rows: 64 rows a tile


def nearest_lohi_design(H: int, W: int, axis: int) -> int:
    """The threads of a block that :func:`nearest_valid_lohi` launches on a
    card for an (H, W) map along ``axis`` (a multiple of 32). Axis 1: a
    block a row, 4 consecutive positions a thread, up to 512 threads: the
    whole row a tile up to 2048 positions; longer rows loop over tiles.
    Axis 0: 32 columns a block (a lane each), 8 rows a thread, up to 256
    threads: tiles of 64 rows, the grid over the rows too."""
    if axis == 1:
        return min(_LOHI_THREADS, -(-W // 128) * 32)
    return min(_LOHI_COL_THREADS, -(-H // 8) * 32)


@functools.lru_cache(maxsize=None)
def _lohi_args(H: int, W: int, axis: int) -> tuple:
    """``csrc/nearest_lohi.cu``'s arguments after the five pointers (the
    shape, the axis, :func:`nearest_lohi_design`), made once a shape."""
    return H, W, axis, nearest_lohi_design(H, W, axis)


def nearest_valid_lohi(disp: torch.Tensor, valid: torch.Tensor, d_up: torch.Tensor,
                       axis: int = 1):
    """(H, W) float32 disparity, bool validity and float32 fallback →
    (lo, hi) float32 along the rows (``axis=1``, the reference's call) or
    the columns (``axis=0``, the reference's call on the transpose); see
    :func:`nearest_valid_lohi_plain`, and :func:`nearest_lohi_design` for
    the kernel's blocks."""
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    dev = disp.device
    if dev.type == "cpu":
        return nearest_valid_lohi_plain(disp, valid, d_up, axis)
    _check(disp, "disp", torch.float32, 2)
    _check(valid, "valid", torch.bool, 2)
    _check(d_up, "d_up", torch.float32, 2)
    shape = disp.shape
    if not shape == valid.shape == d_up.shape:
        raise ValueError("disp, valid and d_up must have one shape")
    lo, hi = torch.empty_like(disp), torch.empty_like(disp)
    _launch("nearest_lohi", dev, disp.data_ptr(), valid.data_ptr(), d_up.data_ptr(),
            lo.data_ptr(), hi.data_ptr(), *_lohi_args(*shape, axis))
    _launches["nearest_valid_lohi"] += 1
    return lo, hi


# ---------------------------------------------------------------------------
# Winner statistics of one volume
# ---------------------------------------------------------------------------


def wta_plain(agg: torch.Tensor):
    """The :func:`_wta_stats` of an (H, W, D) volume as float32 maps and an
    int32 idx."""
    return _float_stats(*_wta_stats(agg))


def wta(agg: torch.Tensor):
    """(H, W, D) float32 aggregated costs → (best, idx, cm, cp, competitor):
    four float32 (H, W) maps and an int32 idx, ties to the smallest d, a
    neighbour outside [0, D) and a missing competitor at BIG (1e9); one read
    of the volume."""
    if agg.device.type == "cpu":
        return wta_plain(agg)
    _check_planes("wta", agg.shape[-1])
    _check(agg, "agg", torch.float32, 3)
    H, W, D = agg.shape
    stats, ptrs = _stat_maps(H, W, agg.device)
    _launch("wta", agg.device, agg.data_ptr(), *ptrs, H * W, D)
    _launches["wta"] += 1
    return stats


# ---------------------------------------------------------------------------
# Median filter
# ---------------------------------------------------------------------------

MEDIAN_SIZES = (3, 5)  # the windows csrc/median.cu takes


def median_blur_plain(img: torch.Tensor, ksize: int = 5) -> torch.Tensor:
    """The k×k median with replicate borders: :func:`core.image.median_blur`,
    the pruned Batcher network of ``minimum``/``maximum`` over the k² shifted
    views."""
    return im.median_blur(img, ksize)


def median_blur(img: torch.Tensor, ksize: int = 5) -> torch.Tensor:
    """(H, W) float32 map → its k×k median with replicate borders, k in
    :data:`MEDIAN_SIZES`: :func:`median_blur_plain`'s network in one launch,
    equal to it bit for bit (NaN, ±inf and ±0 included)."""
    if img.device.type == "cpu":
        return median_blur_plain(img, ksize)
    if ksize not in MEDIAN_SIZES:
        raise ValueError(f"ksize must be one of {MEDIAN_SIZES} on a card, got {ksize}")
    _check(img, "img", torch.float32, 2)
    H, W = img.shape
    out = torch.empty_like(img)
    _launch("median", img.device, img.data_ptr(), out.data_ptr(), H, W, ksize)
    _launches["median"] += 1
    return out


KERNEL_WRAPPERS = (census_words, cost_volume, aggregate_dir, aggregate_dual,
                   wta_stats_from_duals, right_disparity, shift_gather, speckle_counts,
                   nearest_valid_lohi, wta, sum_wta_fused, median_blur)
# launch counts: one per wrapper, by its name but sum_wta_fused's and
# median_blur's, which count as their kernels (csrc/sum_wta.cu,
# csrc/median.cu); aggregate_dual's chain mode apart
_COUNTED_AS = {"sum_wta_fused": "sum_wta", "median_blur": "median"}
COUNTS = tuple(_COUNTED_AS.get(f.__name__, f.__name__) for f in KERNEL_WRAPPERS) + (
    "aggregate_dual_chain",)
reset_launch_counts()
