"""Calibration as batched Levenberg–Marquardt bundle adjustment.

Counterpart of ``stereovision_tpu/calib/ba.py`` (the replacement of
``cv2.calibrateCamera`` and ``cv2.stereoCalibrate``). The residual model is
``core.geometry.project_points`` (pinhole + Brown–Conrady), so the
parameters are those of the reference's pkl files.

The residual and its Jacobian (``torch.func.jacfwd`` over the ~100-parameter
vector) run in float64 on the device; the damping schedule is a host loop,
as in the reference: one read of the candidate's cost a damped solve. The
solve is ``torch.linalg.solve_ex``, whose nonzero ``info`` counts as the
reference's non-finite cost (λ ×10). Zhang's initialisation runs on the
host. OpenCV's flags map to freeze masks and parameter ties.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from stereovision_tpu_torch.core import geometry as geom
from stereovision_tpu_torch.utils.backend import resolve_device


@dataclasses.dataclass(frozen=True)
class CalibrationFlags:
    """OpenCV-equivalent calibration constraints."""

    fix_intrinsic: bool = False      # CALIB_FIX_INTRINSIC (stereo)
    fix_aspect_ratio: bool = False   # fy/fx kept at its initial ratio
    same_focal_length: bool = False  # stereo: both cameras share fx, fy
    fix_principal_point: bool = False
    zero_tangent_dist: bool = False  # p1 = p2 = 0
    fix_k: tuple = (False, False, False)  # freeze k1/k2/k3 at init (usually 0)

    UNIVERSAL = None  # set below


CalibrationFlags.UNIVERSAL = CalibrationFlags(
    fix_aspect_ratio=True,
    same_focal_length=True,
    zero_tangent_dist=True,
    fix_k=(False, False, True),  # FIX_K3 (K4/K5 absent from the 5-coef model)
)

# intrinsics vector layout per camera: [fx, fy, cx, cy, k1, k2, p1, p2, k3]
_NI = 9


def _intrinsics_mask(flags: CalibrationFlags) -> np.ndarray:
    m = np.ones(_NI)
    if flags.fix_intrinsic:
        m[:] = 0
    if flags.fix_aspect_ratio:
        m[1] = 0  # fy derived from fx
    if flags.fix_principal_point:
        m[2:4] = 0
    if flags.zero_tangent_dist:
        m[6:8] = 0
    for i, fk in enumerate(flags.fix_k):
        if fk:
            m[(4, 5, 8)[i]] = 0
    return m


def _unpack_K_dist(v):
    zero, one = torch.zeros_like(v[0]), torch.ones_like(v[0])
    K = torch.stack([torch.stack([v[0], zero, v[2]]), torch.stack([zero, v[1], v[3]]),
                     torch.stack([zero, zero, one])])
    return K, v[4:9]


def _tied_aspect(intr, aspect):
    """intr with fy = fx·aspect (CALIB_FIX_ASPECT_RATIO)."""
    return torch.cat([intr[:1], intr[:1] * aspect, intr[2:]])


# ---------------------------------------------------------------------------
# Levenberg–Marquardt core
# ---------------------------------------------------------------------------


def _lm(residual_fn, theta0: torch.Tensor, free_mask, iters=50, tol=1e-10, trace=None):
    """Masked dense LM. residual_fn: θ → (R,); returns (θ*, cost = ‖r‖²).

    Each damped solve costs one host read (its cost and ``solve_ex``'s
    info together). ``trace``, where given, gets one entry per iteration:
    the damped solves it took."""
    jac = torch.func.jacfwd(residual_fn)
    theta = theta0
    mask = torch.as_tensor(free_mask, dtype=theta.dtype, device=theta.device)
    r = residual_fn(theta)
    cost = float(r @ r)
    lam = 1e-3
    n = theta.shape[0]
    eye = torch.eye(n, dtype=theta.dtype, device=theta.device)
    frozen = (1.0 - mask) * eye  # frozen parameters keep the system nonsingular
    for _ in range(iters):
        J = jac(theta) * mask[None, :]
        JtJ = J.T @ J
        g = J.T @ r
        diag = torch.diag(torch.diagonal(JtJ).clamp(min=1e-8))
        accepted = False
        for tries in range(1, 13):
            delta, info = torch.linalg.solve_ex(JtJ + lam * diag + 1e-12 * eye + frozen, g)
            theta_new = theta - delta * mask
            r_new = residual_fn(theta_new)
            cost_new, failed = torch.stack(
                [r_new @ r_new, (info != 0).to(theta.dtype)]).tolist()
            if not failed and np.isfinite(cost_new) and cost_new < cost:
                rel = (cost - cost_new) / max(cost, 1e-30)
                theta, r, cost = theta_new, r_new, cost_new
                lam = max(lam * 0.3, 1e-12)
                accepted = True
                break
            lam *= 10
        if trace is not None:
            trace.append(tries)
        if not accepted or rel < tol:
            break
    return theta, cost


# ---------------------------------------------------------------------------
# Zhang initialization (host, float64; feeds the LM)
# ---------------------------------------------------------------------------


def _homographies(obj_xy, img_pts) -> np.ndarray:
    """One DLT homography a view: board plane (N, 2) → image (V, N, 2)."""
    obj = torch.as_tensor(np.asarray(obj_xy, np.float64))
    img = torch.as_tensor(np.asarray(img_pts, np.float64))
    return geom.homography_dlt(obj.expand(img.shape[0], -1, -1), img).numpy()


def _zhang_intrinsics(Hs, size):
    def vij(H, i, j):
        return np.array([
            H[0, i] * H[0, j],
            H[0, i] * H[1, j] + H[1, i] * H[0, j],
            H[1, i] * H[1, j],
            H[2, i] * H[0, j] + H[0, i] * H[2, j],
            H[2, i] * H[1, j] + H[1, i] * H[2, j],
            H[2, i] * H[2, j],
        ])

    rows = []
    for H in Hs:
        rows.append(vij(H, 0, 1))
        rows.append(vij(H, 0, 0) - vij(H, 1, 1))
    w, h = size
    try:
        _, _, vt = np.linalg.svd(np.asarray(rows))
        B11, B12, B22, B13, B23, B33 = vt[-1]
        v0 = (B12 * B13 - B11 * B23) / (B11 * B22 - B12**2)
        lam = B33 - (B13**2 + v0 * (B12 * B13 - B11 * B23)) / B11
        alpha2 = lam / B11
        beta2 = lam * B11 / (B11 * B22 - B12**2)
        if alpha2 <= 0 or beta2 <= 0:
            raise np.linalg.LinAlgError
        alpha, beta = np.sqrt(alpha2), np.sqrt(beta2)
        gamma = -B12 * alpha2 * beta / lam
        u0 = gamma * v0 / beta - B13 * alpha2 / lam
        if not (0 < u0 < w and 0 < v0 < h and 0.2 * w < alpha < 10 * w):
            raise np.linalg.LinAlgError
        return np.array([[alpha, 0.0, u0], [0.0, beta, v0], [0.0, 0.0, 1.0]])
    except np.linalg.LinAlgError:
        f = 1.2 * max(w, h)
        return np.array([[f, 0.0, (w - 1) / 2], [0.0, f, (h - 1) / 2], [0.0, 0.0, 1.0]])


def _pose_from_homography(H, K):
    Kinv = np.linalg.inv(K)
    h1, h2, h3 = H[:, 0], H[:, 1], H[:, 2]
    lam = 1.0 / np.linalg.norm(Kinv @ h1)
    r1 = lam * (Kinv @ h1)
    r2 = lam * (Kinv @ h2)
    t = lam * (Kinv @ h3)
    R = np.stack([r1, r2, np.cross(r1, r2)], axis=1)
    u, _, vt = np.linalg.svd(R)
    R = u @ vt
    if np.linalg.det(R) < 0:
        R = -R
    if t[2] < 0:  # board must be in front of the camera
        R[:, 0] *= -1
        R[:, 1] *= -1
        t = -t
    return geom.inverse_rodrigues(torch.as_tensor(R)).numpy(), t


def _rodrigues_np(rvec) -> np.ndarray:
    return geom.rodrigues(torch.as_tensor(np.asarray(rvec, np.float64))).numpy()


def _inverse_rodrigues_np(R) -> np.ndarray:
    return geom.inverse_rodrigues(torch.as_tensor(np.asarray(R, np.float64))).numpy()


# ---------------------------------------------------------------------------
# Mono calibration
# ---------------------------------------------------------------------------


def calibrate_camera(obj_pts, img_pts, image_size,
                     flags: CalibrationFlags = CalibrationFlags(), iters: int = 50,
                     device="cuda", trace=None):
    """cv2.calibrateCamera equivalent.

    obj_pts: (N, 3) board points (z=0 plane, the same for every view) or
    (V, N, 3); img_pts: (V, N, 2) detected corners; image_size: (w, h).
    Returns dict(camera_matrix, distortion_coefficients, rotation_vectors,
    translation_vectors, reprojection_error) of numpy float64, the
    reference pkl's schema. ``trace``: see :func:`_lm`."""
    dev = resolve_device(device)
    obj = np.asarray(obj_pts, np.float64)
    obj = obj if obj.ndim == 2 else obj[0]
    img = np.asarray(img_pts, np.float64)
    V, N = img.shape[0], img.shape[1]

    Hs = _homographies(obj[:, :2], img)
    K0 = _zhang_intrinsics(Hs, image_size)
    poses = np.asarray([np.concatenate(_pose_from_homography(H, K0)) for H in Hs])
    intr0 = np.array([K0[0, 0], K0[1, 1], K0[0, 2], K0[1, 2], 0, 0, 0, 0, 0], np.float64)
    theta0 = np.concatenate([intr0, poses.reshape(-1)])
    mask = np.concatenate([_intrinsics_mask(flags), np.ones(6 * V)])
    aspect = intr0[1] / intr0[0]

    obj_t = torch.as_tensor(obj, device=dev)
    img_t = torch.as_tensor(img, device=dev)

    def residual(theta):
        intr = theta[:_NI]
        if flags.fix_aspect_ratio:
            intr = _tied_aspect(intr, aspect)
        K, dist = _unpack_K_dist(intr)
        pv = theta[_NI:].reshape(V, 6)
        proj = geom.project_points(obj_t[None], pv[:, :3], pv[:, 3:], K[None], dist)
        return (proj - img_t).reshape(-1)

    theta, cost = _lm(residual, torch.as_tensor(theta0, device=dev), mask, iters=iters,
                      trace=trace)
    theta = theta.cpu().numpy()
    intr = theta[:_NI].copy()
    if flags.fix_aspect_ratio:
        intr[1] = intr[0] * aspect
    K = np.array([[intr[0], 0, intr[2]], [0, intr[1], intr[3]], [0, 0, 1]])
    poses = theta[_NI:].reshape(V, 6)
    return {
        "camera_matrix": K,
        "distortion_coefficients": intr[4:9],
        "rotation_vectors": poses[:, :3],
        "translation_vectors": poses[:, 3:],
        "reprojection_error": float(np.sqrt(cost / (V * N))),
    }


# ---------------------------------------------------------------------------
# Stereo calibration
# ---------------------------------------------------------------------------


def stereo_calibrate(obj_pts, img_pts_left, img_pts_right, image_size,
                     K1=None, d1=None, K2=None, d2=None,
                     flags: CalibrationFlags = CalibrationFlags(fix_intrinsic=True),
                     iters: int = 60, device="cuda", trace=None):
    """cv2.stereoCalibrate equivalent: the FIX_INTRINSIC mode (the default)
    and the joint "universal" mode (``CalibrationFlags.UNIVERSAL``, no
    prior intrinsics).

    Returns dict(ret=rms, R, T, E, F, mtx_left, dist_left, mtx_right,
    dist_right, num_valid_pairs) of numpy float64, the reference's stereo
    pkl field names. ``trace``: see :func:`_lm`."""
    dev = resolve_device(device)
    obj = np.asarray(obj_pts, np.float64)
    obj = obj if obj.ndim == 2 else obj[0]
    imL = np.asarray(img_pts_left, np.float64)
    imR = np.asarray(img_pts_right, np.float64)
    V, N = imL.shape[0], imL.shape[1]

    HsL = _homographies(obj[:, :2], imL)
    HsR = _homographies(obj[:, :2], imR)
    if K1 is None:
        K1 = _zhang_intrinsics(HsL, image_size)
        d1 = np.zeros(5)
    if K2 is None:
        K2 = _zhang_intrinsics(HsR, image_size) if not flags.same_focal_length else K1.copy()
        d2 = np.zeros(5)
    K1, K2 = np.asarray(K1, np.float64), np.asarray(K2, np.float64)
    d1 = np.ravel(np.asarray(d1, np.float64))[:5]
    d2 = np.ravel(np.asarray(d2, np.float64))[:5]
    d1 = np.pad(d1, (0, 5 - len(d1)))
    d2 = np.pad(d2, (0, 5 - len(d2)))

    posesL = np.asarray([np.concatenate(_pose_from_homography(H, K1)) for H in HsL])
    posesR = np.asarray([np.concatenate(_pose_from_homography(H, K2)) for H in HsR])
    # the stereo transform's start: the median of the per-view relative ones
    Rl, Rr = _rodrigues_np(posesL[:, :3]), _rodrigues_np(posesR[:, :3])
    R_rel = Rr @ Rl.transpose(0, 2, 1)
    T_rel = posesR[:, 3:] - np.einsum("vij,vj->vi", R_rel, posesL[:, 3:])
    r_st = np.median(_inverse_rodrigues_np(R_rel), axis=0)
    t_st = np.median(T_rel, axis=0)

    intr1 = np.concatenate([[K1[0, 0], K1[1, 1], K1[0, 2], K1[1, 2]], d1])
    intr2 = np.concatenate([[K2[0, 0], K2[1, 1], K2[0, 2], K2[1, 2]], d2])
    theta0 = np.concatenate([r_st, t_st, intr1, intr2, posesL.reshape(-1)])
    im_mask = _intrinsics_mask(flags)
    mask = np.concatenate([np.ones(6), im_mask, im_mask, np.ones(6 * V)])
    aspect1 = intr1[1] / intr1[0]
    aspect2 = intr2[1] / intr2[0]

    obj_t = torch.as_tensor(obj, device=dev)
    imL_t = torch.as_tensor(imL, device=dev)
    imR_t = torch.as_tensor(imR, device=dev)

    def residual(theta):
        r_s, t_s = theta[0:3], theta[3:6]
        i1 = theta[6:6 + _NI]
        i2 = theta[6 + _NI:6 + 2 * _NI]
        if flags.fix_aspect_ratio:
            i1 = _tied_aspect(i1, aspect1)
            i2 = _tied_aspect(i2, aspect2)
        if flags.same_focal_length:
            i2 = torch.cat([i1[:2], i2[2:]])
        Ka, da = _unpack_K_dist(i1)
        Kb, db = _unpack_K_dist(i2)
        pv = theta[6 + 2 * _NI:].reshape(V, 6)
        projL = geom.project_points(obj_t[None], pv[:, :3], pv[:, 3:], Ka[None], da)
        rR, tR = geom.se3_compose(pv[:, :3], pv[:, 3:], r_s, t_s)
        projR = geom.project_points(obj_t[None], rR, tR, Kb[None], db)
        return torch.cat([(projL - imL_t).reshape(-1), (projR - imR_t).reshape(-1)])

    theta, cost = _lm(residual, torch.as_tensor(theta0, device=dev), mask, iters=iters,
                      trace=trace)
    theta = theta.cpu().numpy()
    r_s, t_s = theta[0:3], theta[3:6]
    i1 = theta[6:6 + _NI].copy()
    i2 = theta[6 + _NI:6 + 2 * _NI].copy()
    if flags.fix_aspect_ratio:
        i1[1] = i1[0] * aspect1
        i2[1] = i2[0] * aspect2
    if flags.same_focal_length:
        i2[0], i2[1] = i1[0], i1[1]
    K1f = np.array([[i1[0], 0, i1[2]], [0, i1[1], i1[3]], [0, 0, 1]])
    K2f = np.array([[i2[0], 0, i2[2]], [0, i2[1], i2[3]], [0, 0, 1]])
    R = _rodrigues_np(r_s)
    R_t, T_t = torch.as_tensor(R), torch.as_tensor(t_s)
    return {
        "ret": float(np.sqrt(cost / (2 * V * N))),
        "R": R,
        "T": t_s.reshape(3, 1),
        "E": geom.essential_from_rt(R_t, T_t).numpy(),
        "F": geom.fundamental_from_krt(torch.as_tensor(K1f), torch.as_tensor(K2f), R_t,
                                       T_t).numpy(),
        "mtx_left": K1f,
        "dist_left": i1[4:9].reshape(1, -1),
        "mtx_right": K2f,
        "dist_right": i2[4:9].reshape(1, -1),
        "num_valid_pairs": V,
    }


def reprojection_rms(obj_pts, img_pts, K, dist, rvecs, tvecs, device="cuda"):
    """Per-view and overall reprojection RMS (the audit the reference
    defines, camera_calibration.py:180-216). Returns (per_view numpy,
    overall float)."""
    dev = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float64), device=dev)

    obj = t(obj_pts)
    obj = obj[None] if obj.ndim == 2 else obj
    err = geom.project_points(obj, t(rvecs), t(tvecs), t(K)[None], t(dist)) - t(img_pts)
    sq = (err ** 2).sum(dim=-1)
    return torch.sqrt(sq.mean(dim=-1)).cpu().numpy(), float(torch.sqrt(sq.mean()))
