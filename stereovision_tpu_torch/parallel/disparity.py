"""Multi-device disparity: frame parallelism + row-tile parallelism.

Counterpart of ``stereovision_tpu/parallel/disparity.py``. Frame axis: each
mesh position of a frame group gets whole frames. Tile axis: the rows of an
image are split; each tile solves its slab extended by halo rows from its
neighbours (:func:`.mesh.halo_exchange`), so census windows and post-filters
see real context. Vertical SGM paths restart at the halo boundary, a tiled
SGM approximation whose error decays within a few rows (the halo absorbs
the warm-up); ``parallel.disparity_exact`` has the exact form.
"""

from __future__ import annotations

import torch

from stereovision_tpu_torch.parallel.mesh import Mesh, halo_exchange
from stereovision_tpu_torch.stereo import sgm


def _scatter(x, mesh: Mesh) -> list[list[list[torch.Tensor]]]:
    """(B, H, W) frames → ``parts[g][b][k]``: row tile k of frame b of frame
    group g, float32 on ``mesh.devices[g][k]`` (``None`` where another
    process owns the position). B must divide into the frame groups and H
    into the tiles."""
    x = torch.as_tensor(x, dtype=torch.float32)
    nf, nt = mesh.shape["frame"], mesh.shape["tile"]
    if x.ndim != 3 or x.shape[0] % nf or x.shape[1] % nt:
        raise ValueError(f"frames {tuple(x.shape)} do not split over a {nf}×{nt} mesh "
                         "(B by frame, H by tile)")
    bl, sl = x.shape[0] // nf, x.shape[1] // nt
    return [[[x[g * bl + b, k * sl:(k + 1) * sl].to(mesh.devices[g][k]).contiguous()
              if mesh.owns(g, k) else None for k in range(nt)] for b in range(bl)]
            for g in range(nf)]


def _gather(parts, mesh: Mesh):
    """``parts[g][b]``, a list of (disp, valid) row tiles (``None`` where
    another process owns the position) → (B, H, W) disp and valid on the
    mesh's home device, on every process."""
    nf, nt, bl = mesh.shape["frame"], mesh.shape["tile"], len(parts[0])
    if mesh.ranks is None:
        frames = [tiles for group in parts for tiles in group]
        disp = torch.stack([torch.cat([d.to(mesh.home) for d, _ in t]) for t in frames])
        valid = torch.stack([torch.cat([v.to(mesh.home) for _, v in t]) for t in frames])
        return disp, valid
    out = []
    for j, dtype in enumerate((torch.float32, torch.bool)):
        local = {(g, k): torch.stack([parts[g][b][k][j] for b in range(bl)])
                 if mesh.owns(g, k) else None for g in range(nf) for k in range(nt)}
        shape = next(t for t in local.values() if t is not None).shape
        got = mesh.share(local, shape, dtype)
        out.append(torch.cat([torch.cat([got[(g, k)] for k in range(nt)], dim=1)
                              for g in range(nf)]))
    return tuple(out)


def _speckle_radius(p: sgm.SGMParams) -> int:
    """The radius of the speckle filter's k×k window (0 when it is off)."""
    if p.speckle_window_size <= 0:
        return 0
    return max(3, int((2 * p.speckle_window_size) ** 0.5) | 1) // 2


def _halo_rows(p: sgm.SGMParams) -> int:
    warmup = 16  # rows for vertical-path warm-up
    return max(p.census_wsize // 2, p.median_ksize // 2, _speckle_radius(p)) + warmup


def _tile_disparity(lefts, rights, p: sgm.SGMParams, halo: int, axis=None):
    """One frame's row tiles → their (disp, valid): exchange halos, solve
    each haloed slab this process owns on its device, crop."""
    if len(lefts) == 1:
        return [None if lefts[0] is None else sgm._compute_disparity(lefts[0], rights[0], p)]
    out = [None if lh is None else sgm._compute_disparity(lh, rh, p)
           for lh, rh in zip(halo_exchange(lefts, halo, axis), halo_exchange(rights, halo, axis))]
    return [None if o is None else (o[0][halo:-halo], o[1][halo:-halo]) for o in out]


def sharded_disparity(left, right, params: sgm.SGMParams, mesh: Mesh):
    """(B, H, W) pairs (numpy arrays or tensors) → (disp, valid), each
    (B, H, W) on the mesh's home device (its first, or across processes
    this process's own): frames over the mesh's frame axis, row tiles over
    its tile axis, any mode of the engine (``production_preset()``
    included). B must divide by the frame axis and H by the tile axis.
    Across processes every process passes the whole batch, solves the
    positions it owns, and gets the whole result."""
    p = sgm.check_params(params)
    halo = _halo_rows(p)
    lefts, rights = _scatter(left, mesh), _scatter(right, mesh)
    parts = [[_tile_disparity(lf, rf, p, halo, mesh.tile_axis(g)) for lf, rf in zip(lg, rg)]
             for g, (lg, rg) in enumerate(zip(lefts, rights))]
    return _gather(parts, mesh)
