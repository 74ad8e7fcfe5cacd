"""Distributed structure-from-motion bundle adjustment (poses + landmarks).

Counterpart of ``stereovision_tpu/parallel/ba_landmarks.py``: keyframes
sharded over the mesh's ``frame`` axis, landmarks eliminated by the Schur
complement, and the reduced camera system solved by Jacobi-preconditioned
conjugate gradients whose reductions cross the mesh through
``parallel.mesh.psum``.

Problem:  min Σ_{(f,l) ∈ obs} ‖ π(K, T_f, X_l) − uv_{f,l} ‖²

The normal equations have the arrow structure [U W; Wᵀ V] with U
block-diagonal per pose (6×6), V per landmark (3×3) and W the pose–landmark
coupling. Landmarks are eliminated:

    S Δp = b_p − W V⁻¹ b_l        (reduced camera system)
    Δx_l = V_l⁻¹ (b_l − Wᵀ Δp)    (back-substitution)

S is never formed: CG evaluates S·x = U·x − W V⁻¹ Wᵀ x with one reduction
of an (L, 3) array a matrix-vector product. Pose 0 of frame group 0 is
frozen (the gauge).

Each frame group's shard lives on its position's device (the first of its
tile row); the landmarks are replicated, one copy a position, updated alike
from the reduced sums. Everything runs in float64. Accept and reject stay
on the device (``torch.where``), so an LM iteration reads nothing back to
the host; the inverses are ``inv_ex``, which checks no error code there.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd, vmap

from stereovision_tpu_torch.core import geometry as geom
from stereovision_tpu_torch.parallel.mesh import Mesh, psum
from stereovision_tpu_torch.utils.backend import upload


def _project(intr, pose, X):
    """intr (4,) fx fy cx cy (no distortion for the SfM stage); pose (6,);
    X (…, 3)."""
    R = geom.rodrigues(pose[:3])
    cam = X @ R.T + pose[3:]
    z_raw = cam[..., 2:3]
    # sign-preserving clamp: a point just behind the plane must not project
    # as if in front (flipped residual signs would push LM the wrong way)
    z = torch.sign(torch.where(z_raw == 0, 1.0, z_raw)) * z_raw.abs().clamp(min=1e-9)
    return cam[..., :2] / z * intr[:2] + intr[2:]


def _frame_residual(intr, pose, landmarks, uv, lid, mask):
    proj = _project(intr, pose, landmarks[lid])            # (M, 2)
    return torch.where(mask[:, None], proj - uv, 0.0)


def frame_shards(mesh: Mesh, F: int):
    """The frame axis' devices, the frames each shard holds (contiguous,
    F / n a position, as ``P("frame")`` lays them) and the shards this
    process owns (all of them on a one-process mesh)."""
    devs = [row[0] for row in mesh.devices]
    n = len(devs)
    if F % n:
        raise ValueError(f"{F} frames do not split over a frame axis of {n}")
    return devs, F // n, [i for i in range(n) if mesh.owns(i)]


def distributed_slam_ba(obs_uv, obs_lid, obs_mask, intr, poses0, landmarks0, mesh: Mesh,
                        iters: int = 10, cg_iters: int = 24, lam: float = 1e-3):
    """obs_uv (F, M, 2), obs_lid (F, M) int, obs_mask (F, M) bool, intr (4,)
    fx fy cx cy, poses0 (F, 6), landmarks0 (L, 3): arrays or tensors.

    Returns (poses (F, 6), landmarks (L, 3), rms) as float64 tensors on the
    mesh's :attr:`~.mesh.Mesh.home` device. F must be divisible by the frame
    axis. On a mesh that spans processes each process computes only the
    shards it owns and every process gets the whole result."""
    f64 = torch.float64
    F = obs_uv.shape[0]
    devs, Fl, shards = frame_shards(mesh, F)
    axis = mesh.frame_axis()

    def shard(x, dtype):  # pinned, asynchronous copies: no host wait
        x = torch.as_tensor(x).to(dtype)
        return {i: upload(x[i * Fl:(i + 1) * Fl], devs[i]) for i in shards}

    uvs, lids, masks = shard(obs_uv, f64), shard(obs_lid, torch.int64), shard(obs_mask, torch.bool)
    poses = shard(poses0, f64)
    lm = {i: upload(torch.as_tensor(landmarks0).to(f64), devs[i]) for i in shards}
    intrs = {i: upload(torch.as_tensor(intr).to(f64), devs[i]) for i in shards}
    L = landmarks0.shape[0]
    # gauge: pose 0 of frame group 0 frozen
    frozen = {i: ((torch.arange(Fl, device=devs[i]) == 0) & (i == 0))[:, None] for i in shards}
    eye3 = {i: torch.eye(3, dtype=f64, device=devs[i]) for i in shards}
    eye6 = {i: torch.eye(6, dtype=f64, device=devs[i]) for i in shards}

    def residual_all(i, poses_l, lmk):
        return vmap(_frame_residual, in_dims=(None, 0, None, 0, 0, 0))(
            intrs[i], poses_l, lmk, uvs[i], lids[i], masks[i])         # (Fl, M, 2)

    def cost_of(poses_s, lms):
        return psum({i: (residual_all(i, poses_s[i], lms[i]) ** 2).sum() for i in shards}, axis)

    def blocks(i, poses_l, lmk):
        intr_i = intrs[i]
        r = residual_all(i, poses_l, lmk)
        Jp = vmap(jacfwd(_frame_residual, argnums=1), in_dims=(None, 0, None, 0, 0, 0))(
            intr_i, poses_l, lmk, uvs[i], lids[i], masks[i])          # (Fl, M, 2, 6)

        def per_obs(X, p, u, valid):
            return torch.where(valid, _project(intr_i, p, X[None])[0] - u, 0.0)

        Jl = vmap(vmap(jacfwd(per_obs), in_dims=(0, None, 0, 0)))(
            lmk[lids[i]], poses_l, uvs[i], masks[i])                   # (Fl, M, 2, 3)
        return r, Jp, Jl

    def scatter(i, vals, width):
        """Σ over observations of ``vals`` (Fl, M, width) by landmark → (L, width)."""
        out = torch.zeros((L, width), dtype=f64, device=devs[i])
        return out.index_add_(0, lids[i].reshape(-1), vals.reshape(-1, width))

    lam_c = {i: torch.full((), lam, dtype=f64, device=devs[i]) for i in shards}
    cost_c = cost_of(poses, lm)
    for _ in range(iters if shards else 0):
        blk = {i: blocks(i, poses[i], lm[i]) for i in shards}
        r, Jp, Jl = ({i: b[j] for i, b in blk.items()} for j in range(3))
        U = {i: torch.einsum("fmri,fmrj->fij", Jp[i], Jp[i]) for i in shards}
        b_p = {i: torch.einsum("fmri,fmr->fi", Jp[i], r[i]) for i in shards}
        # one reduction of the landmark blocks (V | b_l)
        Vb = psum({i: torch.cat([scatter(i, torch.einsum("fmri,fmrj->fmij", Jl[i], Jl[i]), 9),
                                 scatter(i, torch.einsum("fmri,fmr->fmi", Jl[i], r[i]), 3)], dim=1)
                   for i in shards}, axis)
        V = {i: v[:, :9].reshape(L, 3, 3) for i, v in Vb.items()}
        b_l = {i: v[:, 9:] for i, v in Vb.items()}
        W = {i: torch.einsum("fmri,fmrj->fmij", Jp[i], Jl[i]) for i in shards}   # (Fl, M, 6, 3)

        def damped(M, lam_i, eye, eps):
            diag = torch.diagonal(M, dim1=-2, dim2=-1).clamp(min=1e-8)
            return M + (lam_i * diag)[..., None] * eye + eps * eye

        Ud = {i: damped(U[i], lam_c[i], eye6[i], 1e-9) for i in shards}
        Vinv = {i: torch.linalg.inv_ex(damped(V[i], lam_c[i], eye3[i], 1e-9))[0] for i in shards}
        Minv = {i: torch.linalg.inv_ex(Ud[i])[0] for i in shards}  # the Jacobi preconditioner

        def wt_x(xs):  # Wᵀ x, reduced over frames → (L, 3) at each position
            return psum({i: scatter(i, torch.einsum("fmij,fi->fmj", W[i], xs[i]), 3)
                         for i in shards}, axis)

        def w_z(i, z):  # W z (z per landmark) → (Fl, 6)
            return torch.einsum("fmij,fmj->fi", W[i], z[lids[i]])

        def gauge(i, y):
            return torch.where(frozen[i], 0.0, y)

        def matvec(xs):
            t = wt_x(xs)
            return {i: gauge(i, torch.einsum("fij,fj->fi", Ud[i], xs[i])
                             - w_z(i, torch.einsum("lij,lj->li", Vinv[i], t[i])))
                    for i in shards}

        def precond(vs):
            return {i: torch.einsum("fij,fj->fi", Minv[i], vs[i]) for i in shards}

        def dot(a, b):
            return psum({i: (a[i] * b[i]).sum() for i in shards}, axis)

        def guard(v):
            return torch.where(v.abs() < 1e-20, 1e-20, v)

        rhs = {i: gauge(i, b_p[i] - w_z(i, torch.einsum("lij,lj->li", Vinv[i], b_l[i])))
               for i in shards}
        x = {i: torch.zeros_like(v) for i, v in rhs.items()}
        res = rhs
        p_dir = precond(rhs)
        rz = dot(rhs, p_dir)
        for _ in range(cg_iters):
            Ap = matvec(p_dir)
            d = dot(p_dir, Ap)
            alpha = {i: rz[i] / guard(d[i]) for i in shards}
            x = {i: x[i] + alpha[i] * p_dir[i] for i in shards}
            res = {i: res[i] - alpha[i] * Ap[i] for i in shards}
            z = precond(res)
            rz_new = dot(res, z)
            p_dir = {i: z[i] + rz_new[i] / guard(rz[i]) * p_dir[i] for i in shards}
            rz = rz_new
        # back-substitute the landmarks
        wx = wt_x(x)
        dl = {i: torch.einsum("lij,lj->li", Vinv[i], b_l[i] - wx[i]) for i in shards}
        poses_n = {i: poses[i] - x[i] for i in shards}
        lm_n = {i: lm[i] - dl[i] for i in shards}
        cost_n = cost_of(poses_n, lm_n)
        ok = {i: (cost_n[i] < cost_c[i]) & torch.isfinite(cost_n[i]) for i in shards}
        poses = {i: torch.where(ok[i], poses_n[i], poses[i]) for i in shards}
        lm = {i: torch.where(ok[i], lm_n[i], lm[i]) for i in shards}
        cost_c = {i: torch.where(ok[i], cost_n[i], cost_c[i]) for i in shards}
        lam_c = {i: torch.where(ok[i], (lam_c[i] * 0.5).clamp(min=1e-9), lam_c[i] * 4.0)
                 for i in shards}
    n_obs = psum({i: m.sum() for i, m in masks.items()}, axis)
    rms = {i: torch.sqrt(cost_c[i] / n_obs[i].clamp(min=1)) for i in shards}
    nf = len(devs)
    poses_all = mesh.share({(i, 0): poses.get(i) for i in range(nf)}, (Fl, 6), f64)
    first = mesh.share({(0, 0): lm.get(0)}, (L, 3), f64)[(0, 0)]
    rms0 = mesh.share({(0, 0): rms.get(0)}, (), f64)[(0, 0)]
    return torch.cat([poses_all[(i, 0)] for i in range(nf)]), first, rms0
