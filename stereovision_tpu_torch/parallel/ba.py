"""Distributed bundle adjustment of a calibration: the Schur-complement
reduced camera system over the mesh.

Counterpart of ``stereovision_tpu/parallel/ba.py``, the mesh form of
``calib.ba.calibrate_camera`` with the same residual model. The global
parameters g (shared intrinsics) couple the per-view poses p_v; the normal
equations are arrow-shaped [A B; Bᵀ C] with C block-diagonal per view.
Each frame group owns a shard of views and reduces the Schur complement
onto the global block over the mesh:

    S   = A − Σ_v B_v C_v⁻¹ B_vᵀ           (psum over the 'frame' axis)
    rhs = g_A − Σ_v B_v C_v⁻¹ r_v          (psum)
    Δg  = S⁻¹ rhs                          (replicated small solve)
    Δp_v = C_v⁻¹ (r_v − B_vᵀ Δg)           (local back-substitution)

An LM iteration makes two reductions: the packed blocks for six damping
candidates (λ·10^k, k < 6) at once, then the six candidates' costs; the
first candidate that lowers the cost wins. Everything runs in float64 on
the devices, with no read back to the host (``inv_ex``, ``solve_ex``,
``torch.where``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jacfwd, vmap

from stereovision_tpu_torch.core import geometry as geom
from stereovision_tpu_torch.parallel.ba_landmarks import frame_shards
from stereovision_tpu_torch.parallel.mesh import Mesh, psum
from stereovision_tpu_torch.utils.backend import upload

_NG = 9  # global params: fx fy cx cy k1 k2 p1 p2 k3
_NL = 6  # damping candidates an iteration


def _residual_one(g, pose, obj, img):
    zero, one = torch.zeros_like(g[0]), torch.ones_like(g[0])
    K = torch.stack([torch.stack([g[0], zero, g[2]]), torch.stack([zero, g[1], g[3]]),
                     torch.stack([zero, zero, one])])
    return (geom.project_points(obj, pose[:3], pose[3:], K, g[4:9]) - img).reshape(-1)


def distributed_mono_ba(obj_pts, img_pts, intrinsics0, poses0, mesh: Mesh, iters: int = 20,
                        optimize_intrinsics: bool = True):
    """obj_pts (N, 3) board points (shared), img_pts (V, N, 2) observations,
    intrinsics0 (9,), poses0 (V, 6): arrays or tensors.

    Returns (intrinsics (9,), poses (V, 6), rms) as float64 tensors on the
    mesh's :attr:`~.mesh.Mesh.home` device. V must be divisible by the frame
    axis. On a mesh that spans processes each process computes only the
    shards it owns and every process gets the whole result."""
    f64 = torch.float64
    V = img_pts.shape[0]
    N = img_pts.shape[1]
    devs, Vl, shards = frame_shards(mesh, V)
    axis = mesh.frame_axis()
    img_h, poses_h = torch.as_tensor(img_pts).to(f64), torch.as_tensor(poses0).to(f64)
    imgs = {i: upload(img_h[i * Vl:(i + 1) * Vl], devs[i]) for i in shards}
    poses = {i: upload(poses_h[i * Vl:(i + 1) * Vl], devs[i]) for i in shards}
    objs = {i: upload(torch.as_tensor(obj_pts).to(f64), devs[i]) for i in shards}
    gs = {i: upload(torch.as_tensor(intrinsics0).to(f64).reshape(_NG), devs[i]) for i in shards}
    eye6 = {i: torch.eye(6, dtype=f64, device=devs[i]) for i in shards}
    eyeg = {i: torch.eye(_NG, dtype=f64, device=devs[i]) for i in shards}
    tens = {i: 10.0 ** torch.arange(_NL, dtype=f64, device=devs[i]) for i in shards}

    def residuals(i, g, poses_l):  # (Vl, 2N)
        return vmap(_residual_one, in_dims=(None, 0, None, 0))(g, poses_l, objs[i], imgs[i])

    lam = {i: torch.full((), 1e-3, dtype=f64, device=devs[i]) for i in shards}
    cost = psum({i: (residuals(i, gs[i], poses[i]) ** 2).sum() for i in shards}, axis)
    for _ in range(iters if shards else 0):
        parts, local = {}, {}
        for i in shards:
            r = residuals(i, gs[i], poses[i])
            Jg, Jp = vmap(jacfwd(_residual_one, argnums=(0, 1)), in_dims=(None, 0, None, 0))(
                gs[i], poses[i], objs[i], imgs[i])                # (Vl, R, 9), (Vl, R, 6)
            A_l = torch.einsum("vri,vrj->ij", Jg, Jg)
            gA_l = torch.einsum("vri,vr->i", Jg, r)
            C = torch.einsum("vri,vrj->vij", Jp, Jp)                # (Vl, 6, 6)
            B = torch.einsum("vri,vrj->vij", Jg, Jp)                # (Vl, 9, 6)
            gP = torch.einsum("vri,vr->vi", Jp, r)                  # (Vl, 6)
            lams = lam[i] * tens[i]
            Cdiag = torch.diagonal(C, dim1=-2, dim2=-1).clamp(min=1e-8)
            Cd = (C + (lams[:, None, None] * Cdiag)[..., None] * eye6[i]
                  + 1e-10 * eye6[i])                                 # (6 λ, Vl, 6, 6)
            Cinv = torch.linalg.inv_ex(Cd)[0]
            BCB = torch.einsum("vij,cvjk,vlk->cil", B, Cinv, B)     # (6 λ, 9, 9)
            Bcr = torch.einsum("vij,cvjk,vk->ci", B, Cinv, gP)      # (6 λ, 9)
            parts[i] = torch.cat([A_l.reshape(-1), gA_l, BCB.reshape(-1), Bcr.reshape(-1)])
            local[i] = (B, gP, Cinv, lams)
        packed = psum(parts, axis)
        cands = {}
        for i in shards:
            B, gP, Cinv, lams = local[i]
            p = packed[i]
            A = p[:_NG * _NG].reshape(_NG, _NG)
            gA = p[_NG * _NG:_NG * _NG + _NG]
            BCB = p[_NG * _NG + _NG:_NG * _NG + _NG + _NL * _NG * _NG].reshape(_NL, _NG, _NG)
            Bcr = p[_NG * _NG + _NG + _NL * _NG * _NG:].reshape(_NL, _NG)
            if optimize_intrinsics:
                Adiag = torch.diag(torch.diagonal(A).clamp(min=1e-8))
                Ad = A + lams[:, None, None] * Adiag + 1e-10 * eyeg[i]
                dg = torch.linalg.solve_ex(Ad - BCB + 1e-10 * eyeg[i], gA - Bcr)[0]   # (6 λ, 9)
            else:
                dg = torch.zeros((_NL, _NG), dtype=f64, device=devs[i])
            rhs = gP[None] - torch.einsum("vji,cj->cvi", B, dg)
            dp = torch.einsum("cvij,cvj->cvi", Cinv, rhs)                   # (6 λ, Vl, 6)
            g_c, p_c = gs[i] - dg, poses[i] - dp
            cost_l = torch.stack([(residuals(i, g_c[c], p_c[c]) ** 2).sum() for c in range(_NL)])
            cands[i] = (g_c, p_c, cost_l)
        costs = psum({i: c[2] for i, c in cands.items()}, axis)
        for i in shards:
            g_c, p_c, _ = cands[i]
            ok = (costs[i] < cost[i]) & torch.isfinite(costs[i])
            k = ok.to(torch.int8).argmax().reshape(1)   # the first candidate accepted
            any_ok = ok.any()
            gs[i] = torch.where(any_ok, g_c.index_select(0, k)[0], gs[i])
            poses[i] = torch.where(any_ok, p_c.index_select(0, k)[0], poses[i])
            cost[i] = torch.where(any_ok, costs[i].index_select(0, k)[0], cost[i])
            lam[i] = torch.where(any_ok, (local[i][3].index_select(0, k)[0] * 0.3).clamp(min=1e-10),
                                 lam[i] * 10.0 ** _NL)
    nf = len(devs)
    rms = {i: torch.sqrt(cost[i] / (V * N)) for i in shards}
    poses_all = mesh.share({(i, 0): poses.get(i) for i in range(nf)}, (Vl, 6), f64)
    g0 = mesh.share({(0, 0): gs.get(0)}, (_NG,), f64)[(0, 0)]
    rms0 = mesh.share({(0, 0): rms.get(0)}, (), f64)[(0, 0)]
    return g0, torch.cat([poses_all[(i, 0)] for i in range(nf)]), rms0


def mono_ba_init(obj_pts, img_pts, image_size):
    """Zhang's initialisation on the host (shared with ``calib.ba``): returns
    (intrinsics (9,), poses (V, 6)) as numpy float64."""
    from stereovision_tpu_torch.calib import ba as cba

    obj = np.asarray(obj_pts, np.float64)
    Hs = cba._homographies(obj[:, :2], np.asarray(img_pts, np.float64))
    K0 = cba._zhang_intrinsics(Hs, image_size)
    poses = np.asarray([np.concatenate(cba._pose_from_homography(H, K0)) for H in Hs])
    intr = np.array([K0[0, 0], K0[1, 1], K0[0, 2], K0[1, 2], 0, 0, 0, 0, 0])
    return intr, poses
