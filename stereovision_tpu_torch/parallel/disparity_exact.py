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
without lane packing. It runs on any mesh, one that spans processes
(:func:`.mesh.initialize_multihost`) too: each process solves the tiles it
owns (lists carry ``None`` at the others'), takes part in every exchange
of their frame group's tile axis, and gets the whole result.
"""

from __future__ import annotations

import torch

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


def _tile_cost(lh, rh, p: sgm.SGMParams, halo: int, impl: str):
    """One haloed tile → (its (S, W, D) cost, its horizontal path volumes):
    float32 costs and the plain sum of the horizontal pair, or the kernels'
    int8 costs and dual volumes (``sgm._kernel_costs``). The halo rows only
    feed the census windows: the cost rows are cropped."""
    if impl != "xla":
        return sgm._kernel_costs(lh, rh, p, crop=halo)
    cost = sgm.census_cost_volume(lh, rh, p)[halo:-halo]
    return cost, (sgm_cuda.aggregate_dir_plain(cost, p.p1, p.p2, axis=1)
                  + sgm_cuda.aggregate_dir_plain(cost, p.p1, p.p2, axis=1, reverse=True),)


def _tile_costs(lefts, rights, p: sgm.SGMParams, halo: int, impl: str, axis=None):
    """One frame's row tiles → (their costs, their horizontal path volumes),
    ``None`` at the tiles of other processes."""
    out = [None if lh is None else _tile_cost(lh, rh, p, halo, impl)
           for lh, rh in zip(halo_exchange(lefts, halo, axis), halo_exchange(rights, halo, axis))]
    return ([None if o is None else o[0] for o in out],
            [None if o is None else o[1] for o in out])


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
    tile this process holds (``None`` at the others'): a fresh start."""
    bf = [None if c is None else torch.zeros(c.shape[1:], dtype=torch.float32, device=c.device)
          for c in costs]
    return bf, [None if b is None else b.clone() for b in bf]


def _select(horiz, vert, p: sgm.SGMParams, impl: str):
    """A tile's horizontal and vertical path volumes → (disp, valid): WTA
    and the LR check on their sum."""
    if impl == "xla":
        disp, valid, _ = sgm._plain_select(horiz[0] + vert[0] + vert[1], p)
    else:
        disp, valid, _ = sgm._kernel_select(horiz + vert, p)
    return disp, valid


def _finish(selected, p: sgm.SGMParams, halo: int, impl: str, axis=None):
    """One frame's per-tile (disp, valid) (``None`` at other processes'
    tiles) → speckle and median over haloed rows, cropped: the windows see
    what the single-device engine's see."""
    disps = halo_exchange([None if s is None else s[0] for s in selected], halo, axis)
    valids = halo_exchange([None if s is None else s[1] for s in selected], halo, axis)
    out = []
    for disp, valid in zip(disps, valids):
        if disp is None:
            out.append(None)
            continue
        valid = sgm._speckle_suppress(disp, valid, p, impl)
        if p.median_ksize > 1:
            disp = sgm._median(disp, p.median_ksize, impl)
        disp = torch.where(valid, disp, float(p.min_disparity) - 1.0)
        out.append((disp[halo:-halo], valid[halo:-halo]))
    return out


def _selected(horiz, verts, p: sgm.SGMParams, impl: str):
    """:func:`_select` on the tiles this process holds."""
    return [None if h is None else _select(h, v, p, impl) for h, v in zip(horiz, verts)]


def _prepared(left, right, params: sgm.SGMParams, mesh: Mesh):
    """(params, halo, impl, the left tiles, the right tiles) of a call."""
    p = _exact_params(params)
    lefts, rights = _scatter(left, mesh), _scatter(right, mesh)
    return p, _exact_halo(p), sgm._resolve_impl(p.impl), lefts, rights


# ---------------------------------------------------------------------------
# Sweep strategy
# ---------------------------------------------------------------------------


def _chain_sweeps(costs, step, axis=None):
    """The vertical chains of one frame: ``ntiles`` seeded sweeps of every
    tile this process holds, each shipping its final carries; the last
    sweep's volumes are final for every tile. Returns [(vf, vb)] per tile
    (``None`` at other processes' tiles)."""
    nt = len(costs)
    bf, bb = _zero_carries(costs)
    for t in range(nt):
        res = [None if c is None else step(c, (f, b)) for c, f, b in zip(costs, bf, bb)]
        if t < nt - 1:
            bf = ppermute([None if r is None else r[2] for r in res], _chain_perm(nt, False),
                          axis)
            bb = ppermute([None if r is None else r[3] for r in res], _chain_perm(nt, True),
                          axis)
    return [None if r is None else (r[0], r[1]) for r in res]


def _frame_exact(lefts, rights, p: sgm.SGMParams, halo: int, impl: str, axis=None):
    """One frame's row tiles → per-tile (disp, valid), sweep strategy."""
    costs, horiz = _tile_costs(lefts, rights, p, halo, impl, axis)
    verts = _chain_sweeps(costs, _chain_step(p, impl), axis)
    return _finish(_selected(horiz, verts, p, impl), p, halo, impl, axis)


def sharded_disparity_exact(left, right, params: sgm.SGMParams, mesh: Mesh):
    """(B, H, W) pairs (numpy arrays or tensors) → the single-device
    disparity exactly, as (disp, valid), each (B, H, W) on the mesh's home
    device: row-tiled over the mesh's tile axis, frames over its frame
    axis. ``ntiles`` chain sweeps per frame. Across processes every process
    passes the whole batch, solves the positions it owns, and gets the
    whole result."""
    p, halo, impl, lefts, rights = _prepared(left, right, params, mesh)
    parts = [[_frame_exact(lf, rf, p, halo, impl, mesh.tile_axis(g)) for lf, rf in zip(lg, rg)]
             for g, (lg, rg) in enumerate(zip(lefts, rights))]
    return _gather(parts, mesh)


# ---------------------------------------------------------------------------
# Pipelined strategy
# ---------------------------------------------------------------------------


def _chain_pipelined(costs, step, axis=None):
    """Software-pipelined vertical chains of a frame group's batch
    (``costs[k][b]``; ``None`` at other processes' tiles): one step per
    tile per pipeline step runs both directions, the forward carry on frame
    t − k and the backward carry on frame t − (T−1−k) (``cost_b``). One
    (W, D) float32 boundary row per direction ships per step; B + T − 1
    steps; out-of-range steps run on a clamped frame and their volumes are
    dropped. A process steps only its own tiles but takes part in every
    step's exchange. Returns ``vf[k][b]``, ``vb[k][b]``."""
    nt, nb = len(costs), len(costs[0])
    bf, bb = _zero_carries([c[0] for c in costs])
    vf = [[None] * nb for _ in range(nt)]
    vb = [[None] * nb for _ in range(nt)]
    for t in range(nb + nt - 1):
        ff, fb = [None] * nt, [None] * nt
        for k in range(nt):
            if costs[k][0] is None:
                continue
            f_f, f_b = t - k, t - (nt - 1 - k)
            lf, lb, ff[k], fb[k] = step(costs[k][min(max(f_f, 0), nb - 1)], (bf[k], bb[k]),
                                        costs[k][min(max(f_b, 0), nb - 1)])
            if 0 <= f_f < nb:
                vf[k][f_f] = lf
            if 0 <= f_b < nb:
                vb[k][f_b] = lb
        # the scan's first tile gets zeros back: a fresh start for the next frame
        bf = ppermute(ff, _chain_perm(nt, False), axis)
        bb = ppermute(fb, _chain_perm(nt, True), axis)
    return vf, vb


def _group_pipelined(lefts, rights, p: sgm.SGMParams, halo: int, impl: str, axis=None):
    """A frame group (``lefts[b][k]``) → per frame, per-tile (disp, valid)."""
    nb, nt = len(lefts), len(lefts[0])
    per_frame = [_tile_costs(lf, rf, p, halo, impl, axis) for lf, rf in zip(lefts, rights)]
    costs = [[per_frame[b][0][k] for b in range(nb)] for k in range(nt)]
    vf, vb = _chain_pipelined(costs, _chain_step(p, impl), axis)
    return [_finish(_selected(per_frame[b][1], [(vf[k][b], vb[k][b]) for k in range(nt)], p,
                              impl), p, halo, impl, axis) for b in range(nb)]


def sharded_disparity_exact_pipelined(left, right, params: sgm.SGMParams, mesh: Mesh):
    """(B, H, W) pairs → the single-device disparity exactly, as
    :func:`sharded_disparity_exact` (across processes too), with the
    cross-tile vertical chains software-pipelined over each frame group's
    batch (see the module docstring). The group's cost volumes are all made
    before the chain (as the reference does: (B/frame)·T slabs of int8 on
    the kernel path)."""
    p, halo, impl, lefts, rights = _prepared(left, right, params, mesh)
    parts = [_group_pipelined(lg, rg, p, halo, impl, mesh.tile_axis(g))
             for g, (lg, rg) in enumerate(zip(lefts, rights))]
    return _gather(parts, mesh)
