"""Exact tile-parallel disparity: vertical SGM chained across mesh positions.

Counterpart of ``stereovision_tpu/parallel/disparity_exact.py``.
``parallel.disparity.sharded_disparity`` restarts the vertical paths at tile
boundaries; this module computes the single-device result exactly under
row tiling:

- census, cost and the two horizontal paths are row-local, so exact per
  tile (the cost rows read census halo rows from the neighbours);
- the two vertical paths cross tiles: tile k's first row needs tile k−1's
  last carry. The chain is evaluated with ``ntiles`` sweeps; at sweep t the
  boundary from the tile at scan position t−1 is final, so after ``ntiles``
  sweeps every tile has aggregated from its true predecessor (each sweep
  ships one (W, D) boundary row per direction with :func:`.mesh.ppermute`);
- winner selection, uniqueness and the LR check are row-local; speckle and
  median see halo rows.

Two strategies:

- :func:`sharded_disparity_exact`: ``ntiles`` sweeps per frame;
- :func:`sharded_disparity_exact_pipelined`: the chain software-pipelined
  over each frame group's batch: at step t, tile k aggregates frame t−k down
  and frame t−(T−1−k) up, B+T−1 steps for B frames instead of B·T sweeps.

Both run on either implementation, through one chain loop: ``impl="xla"``
the plain PyTorch scans (the chain mode's plain version, float32 path
costs), a kernel impl the CUDA kernels (census, cost and horizontal duals
per tile, the vertical chains through :func:`ops.sgm_cuda.aggregate_dual`'s
chain mode; on CPU tensors their plain versions). Both ship min-normalised
carries; the reference's plain path ships raw L rows, which give the same
L. Results equal the single-device engine of the same impl bit for bit.

Like the reference, the exact engine is a full search over the four paths,
without lane packing.
"""

from __future__ import annotations

import torch

from stereovision_tpu_torch.core import image as im
from stereovision_tpu_torch.ops import sgm_cuda
from stereovision_tpu_torch.parallel.disparity import _gather, _scatter, _speckle_radius
from stereovision_tpu_torch.parallel.mesh import Mesh, halo_exchange, ppermute
from stereovision_tpu_torch.stereo import sgm


def _chain_perm(ntiles: int, reverse: bool):
    """Where each tile's boundary goes: down the image, or up it."""
    if reverse:
        return [(i, i - 1) for i in range(1, ntiles)]
    return [(i, i + 1) for i in range(ntiles - 1)]


def _exact_halo(p: sgm.SGMParams) -> int:
    """The reference's halo (census and median radii, at least 8), widened
    to the speckle window's radius when that is larger (7 at the defaults;
    the reference's halo omits it, ROADMAP.md §3)."""
    return max(p.census_wsize // 2, p.census_ksize // 2, p.median_ksize // 2,
               _speckle_radius(p), 8)


def _one_process(mesh: Mesh) -> None:
    if mesh.spans_processes:
        raise NotImplementedError(
            "the exact tile-parallel engine runs on a one-process mesh; its vertical chains "
            "across processes are ROADMAP.md queue 1 item 12 (the exact engine across "
            "processes)")


def _exact_params(params: sgm.SGMParams) -> sgm.SGMParams:
    p = sgm.check_params(params)
    if p.mode != "full" or p.pack != 1 or p.paths != 4 or p.fill_invalid:
        raise ValueError(
            "the exact tile-parallel engine runs the full search over four paths, without "
            f"lane packing or fill (got mode={p.mode!r}, pack={p.pack}, paths={p.paths}, "
            f"fill_invalid={p.fill_invalid})")
    return p


# ---------------------------------------------------------------------------
# Per-tile stages
# ---------------------------------------------------------------------------


def _tile_costs(lefts, rights, p: sgm.SGMParams, halo: int, impl: str):
    """One frame's row tiles → (their (S, W, D) costs, their horizontal path
    volumes): float32 costs and the plain sum of the horizontal pair, or the
    kernels' int8 costs and dual volumes (``sgm._kernel_costs``). The halo
    rows only feed the census windows: the cost rows are cropped."""
    pairs = zip(halo_exchange(lefts, halo), halo_exchange(rights, halo))
    if impl != "xla":
        out = [sgm._kernel_costs(lh, rh, p, crop=halo) for lh, rh in pairs]
        return [c for c, _ in out], [h for _, h in out]
    costs, horiz = [], []
    for lh, rh in pairs:
        cost = sgm.census_cost_volume(lh, rh, p)[halo:-halo]
        costs.append(cost)
        horiz.append((sgm_cuda.aggregate_dir_plain(cost, p.p1, p.p2, axis=1)
                      + sgm_cuda.aggregate_dir_plain(cost, p.p1, p.p2, axis=1, reverse=True),))
    return costs, horiz


def _chain_step(p: sgm.SGMParams, impl: str):
    """One tile's seeded scans along axis 0, ``step(cost, (bf, bb),
    cost_b=None) → (lf, lb, ff, fb)``: the chain-mode kernel (int8 or int16
    path volumes), or on the plain path its plain version's scans (float32
    path costs, unclamped)."""
    if impl == "xla":
        def step(cost, boundary, cost_b=None):
            lf, ff = sgm_cuda._scan(cost, p.p1, p.p2, 0, False, boundary[0])
            lb, fb = sgm_cuda._scan(cost if cost_b is None else cost_b, p.p1, p.p2, 0, True,
                                    boundary[1])
            return lf, lb, ff, fb
        return step
    vol_dt = sgm._vol_dtype(p)

    def step(cost, boundary, cost_b=None):
        return sgm_cuda.aggregate_dual(cost, p.p1, p.p2, axis=0, out_dtype=vol_dt,
                                       boundary=boundary, return_final=True, cost_b=cost_b)
    return step


def _zero_carries(costs):
    """Zero (W, D) float32 boundary rows, forward and backward, one pair per
    tile: a fresh start."""
    bf = [torch.zeros(c.shape[1:], dtype=torch.float32, device=c.device) for c in costs]
    return bf, [b.clone() for b in bf]


def _select(horiz, vert, p: sgm.SGMParams, impl: str):
    """A tile's horizontal and vertical path volumes → (disp, valid): WTA
    and the LR check on their sum."""
    if impl == "xla":
        disp, valid, _ = sgm._plain_select(horiz[0] + vert[0] + vert[1], p)
    else:
        disp, valid, _ = sgm._kernel_select(horiz + vert, p)
    return disp, valid


def _finish(selected, p: sgm.SGMParams, halo: int, impl: str):
    """One frame's per-tile (disp, valid) → speckle and median over haloed
    rows, cropped: the windows see what the single-device engine's see."""
    disps = halo_exchange([d for d, _ in selected], halo)
    valids = halo_exchange([v for _, v in selected], halo)
    out = []
    for disp, valid in zip(disps, valids):
        valid = sgm._speckle_suppress(disp, valid, p, impl)
        if p.median_ksize > 1:
            disp = im.median_blur(disp, p.median_ksize)
        disp = torch.where(valid, disp, float(p.min_disparity) - 1.0)
        out.append((disp[halo:-halo], valid[halo:-halo]))
    return out


# ---------------------------------------------------------------------------
# Sweep strategy
# ---------------------------------------------------------------------------


def _chain_sweeps(costs, step):
    """The vertical chains of one frame: ``ntiles`` seeded sweeps of every
    tile, each shipping its final carries; the last sweep's volumes are
    final for every tile. Returns [(vf, vb)] per tile."""
    nt = len(costs)
    bf, bb = _zero_carries(costs)
    for t in range(nt):
        res = [step(c, (f, b)) for c, f, b in zip(costs, bf, bb)]
        if t < nt - 1:
            bf = ppermute([r[2] for r in res], _chain_perm(nt, False))
            bb = ppermute([r[3] for r in res], _chain_perm(nt, True))
    return [(r[0], r[1]) for r in res]


def _frame_exact(lefts, rights, p: sgm.SGMParams, halo: int, impl: str):
    """One frame's row tiles → per-tile (disp, valid), sweep strategy."""
    costs, horiz = _tile_costs(lefts, rights, p, halo, impl)
    verts = _chain_sweeps(costs, _chain_step(p, impl))
    return _finish([_select(h, v, p, impl) for h, v in zip(horiz, verts)], p, halo, impl)


def sharded_disparity_exact(left, right, params: sgm.SGMParams, mesh: Mesh):
    """(B, H, W) pairs (numpy arrays or tensors) → the single-device
    disparity exactly, as (disp, valid), each (B, H, W) on the mesh's first
    device: row-tiled over the mesh's tile axis, frames over its frame
    axis. ``ntiles`` chain sweeps per frame."""
    _one_process(mesh)
    p = _exact_params(params)
    halo = _exact_halo(p)
    impl = sgm._resolve_impl(p.impl)
    lefts, rights = _scatter(left, mesh), _scatter(right, mesh)
    parts = [[_frame_exact(lf, rf, p, halo, impl) for lf, rf in zip(lg, rg)]
             for lg, rg in zip(lefts, rights)]
    return _gather(parts, mesh)


# ---------------------------------------------------------------------------
# Pipelined strategy
# ---------------------------------------------------------------------------


def _chain_pipelined(costs, step):
    """Software-pipelined vertical chains of a frame group's batch
    (``costs[k][b]``): one step per tile per pipeline step runs both
    directions, the forward carry on frame t − k and the backward carry on
    frame t − (T−1−k) (``cost_b``). One (W, D) float32 boundary row per
    direction ships per step; B + T − 1 steps; out-of-range steps run on a
    clamped frame and their volumes are dropped. Returns ``vf[k][b]``,
    ``vb[k][b]``."""
    nt, nb = len(costs), len(costs[0])
    bf, bb = _zero_carries([c[0] for c in costs])
    vf = [[None] * nb for _ in range(nt)]
    vb = [[None] * nb for _ in range(nt)]
    for t in range(nb + nt - 1):
        ff, fb = [], []
        for k in range(nt):
            f_f, f_b = t - k, t - (nt - 1 - k)
            lf, lb, a, b = step(costs[k][min(max(f_f, 0), nb - 1)], (bf[k], bb[k]),
                                costs[k][min(max(f_b, 0), nb - 1)])
            if 0 <= f_f < nb:
                vf[k][f_f] = lf
            if 0 <= f_b < nb:
                vb[k][f_b] = lb
            ff.append(a)
            fb.append(b)
        # the scan's first tile gets zeros back: a fresh start for the next frame
        bf = ppermute(ff, _chain_perm(nt, False))
        bb = ppermute(fb, _chain_perm(nt, True))
    return vf, vb


def _group_pipelined(lefts, rights, p: sgm.SGMParams, halo: int, impl: str):
    """A frame group (``lefts[b][k]``) → per frame, per-tile (disp, valid)."""
    nb, nt = len(lefts), len(lefts[0])
    per_frame = [_tile_costs(lf, rf, p, halo, impl) for lf, rf in zip(lefts, rights)]
    costs = [[per_frame[b][0][k] for b in range(nb)] for k in range(nt)]
    vf, vb = _chain_pipelined(costs, _chain_step(p, impl))
    return [_finish([_select(per_frame[b][1][k], (vf[k][b], vb[k][b]), p, impl)
                     for k in range(nt)], p, halo, impl) for b in range(nb)]


def sharded_disparity_exact_pipelined(left, right, params: sgm.SGMParams, mesh: Mesh):
    """(B, H, W) pairs → the single-device disparity exactly, as
    :func:`sharded_disparity_exact`, with the cross-tile vertical chains
    software-pipelined over each frame group's batch (see the module
    docstring). The group's cost volumes are all made before the chain (as
    the reference does: (B/frame)·T slabs of int8 on the kernel path)."""
    _one_process(mesh)
    p = _exact_params(params)
    halo = _exact_halo(p)
    impl = sgm._resolve_impl(p.impl)
    lefts, rights = _scatter(left, mesh), _scatter(right, mesh)
    parts = [_group_pipelined(lg, rg, p, halo, impl) for lg, rg in zip(lefts, rights)]
    return _gather(parts, mesh)
