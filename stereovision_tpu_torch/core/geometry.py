"""Camera geometry of the disparity path, as plain PyTorch ops.

Counterpart of the pieces of ``stereovision_tpu/core/geometry.py`` that
``DepthPipeline`` runs: axis-angle rotations, undistortion, Bouguet stereo
rectification (``stereo_rectify``, which ``proc_scale`` re-runs at the
processing size) and the free-scaling camera matrix, the rectification
maps, metric depth and the point cloud; and the homography fit and its
application that the fused path's ego-motion runs (:func:`homography_dlt`,
:func:`apply_homography`); and the residual model and two-view geometry of
calibration and SfM (:func:`project_points`, :func:`se3_compose`,
:func:`essential_from_rt`, :func:`triangulate`). Calibration data is float64; the
maps are computed in float64 and stored as float32, as in the reference.
OpenCV's conventions: ``K = [[fx, 0, cx], [0, fy, cy], [0, 0, 1]]``,
distortion ``(k1, k2, p1, p2, k3[, k4, k5, k6])`` zero-padded, and ``R, T``
map points from the left camera's frame into the right's.
"""

from __future__ import annotations

import torch


def _f64(x, like=None) -> torch.Tensor:
    """``x`` as a tensor of ``like``'s dtype and device; without ``like``,
    a tensor as it is and anything else as float64 on the CPU."""
    if like is None:
        return x if torch.is_tensor(x) else torch.as_tensor(x, dtype=torch.float64)
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------


def rodrigues(rvec) -> torch.Tensor:
    """Axis-angle vector (…, 3) → rotation matrix (…, 3, 3), with series
    forms of sin(θ)/θ and (1 − cos θ)/θ² near θ = 0."""
    rvec = _f64(rvec)
    theta2 = (rvec * rvec).sum(dim=-1, keepdim=True)[..., None]  # (…, 1, 1)
    theta = torch.sqrt(theta2)
    small = theta2 < 1e-12
    s = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / torch.where(small, 1.0, theta))
    c = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, 1.0, theta2))
    x, y, z = rvec.unbind(-1)
    zeros = torch.zeros_like(x)
    K = torch.stack([torch.stack([zeros, -z, y], dim=-1),
                     torch.stack([z, zeros, -x], dim=-1),
                     torch.stack([-y, x, zeros], dim=-1)], dim=-2)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    return eye + s * K + c * (K @ K)


def inverse_rodrigues(R) -> torch.Tensor:
    """Rotation matrix (…, 3, 3) → axis-angle vector (…, 3); near θ = π,
    where the skew part vanishes, the axis comes from the symmetric part
    (its largest component taken positive, the others signed by the
    symmetric part's row of that component)."""
    R = _f64(R)
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = ((trace - 1.0) * 0.5).clamp(-1.0, 1.0)
    theta = torch.arccos(cos_t)
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    sin_t = torch.sin(theta)
    generic = v * (theta / torch.where(sin_t.abs() < 1e-7, 1.0, 2.0 * sin_t))[..., None]
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis2 = ((diag + 1.0) * 0.5).clamp(min=0.0)
    axis = torch.sqrt(axis2)
    imax = torch.argmax(axis2, dim=-1)
    sym = R + R.transpose(-1, -2)
    row = torch.gather(sym, -2, imax[..., None, None].expand(*sym.shape[:-2], 1, 3))[..., 0, :]
    signs = torch.where(row < 0, -1.0, 1.0).to(R.dtype)
    dominant_pos = torch.gather(signs, -1, imax[..., None]) > 0
    signs = torch.where(dominant_pos, signs, -signs)
    near_pi = axis * signs * theta[..., None]
    use_near_pi = (sin_t.abs() < 1e-7)[..., None] & (cos_t < 0)[..., None]
    return torch.where(use_near_pi, near_pi, generic)


def se3_compose(r1, t1, r2, t2):
    """Compose two rigid transforms given as (rvec, tvec): x → R2(R1 x + t1)
    + t2. Returns (rvec, tvec)."""
    R1, R2 = rodrigues(r1), rodrigues(r2)
    t = (R2 @ _f64(t1)[..., None])[..., 0] + _f64(t2)
    return inverse_rodrigues(R2 @ R1), t


def se3_inverse(rvec, tvec):
    """(rvec, tvec) of the inverse transform."""
    Rt = rodrigues(rvec).transpose(-1, -2)
    return inverse_rodrigues(Rt), -(Rt @ _f64(tvec)[..., None])[..., 0]


def pad_dist(dist: torch.Tensor, n: int = 8) -> torch.Tensor:
    """Zero-pad a distortion vector to ``n`` coefficients (k1 k2 p1 p2 k3 k4 k5 k6)."""
    dist = torch.ravel(dist)
    pad = dist.new_zeros(max(0, n - dist.shape[0]))
    return torch.cat([dist, pad])[:n]


def distort(xy: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Apply Brown–Conrady (+rational) distortion to normalized coords (…, 2)."""
    k1, k2, p1, p2, k3, k4, k5, k6 = pad_dist(dist).unbind()
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    r4 = r2 * r2
    r6 = r4 * r2
    radial = (1.0 + k1 * r2 + k2 * r4 + k3 * r6) / (1.0 + k4 * r2 + k5 * r4 + k6 * r6)
    xy2 = 2.0 * x * y
    xd = x * radial + p1 * xy2 + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + p2 * xy2
    return torch.stack([xd, yd], dim=-1)


def project_points(obj_pts, rvec, tvec, K, dist) -> torch.Tensor:
    """World points (…, N, 3) → pixel coords (…, N, 2), cv2.projectPoints:
    the residual model of the calibration solvers. ``rvec``/``tvec`` (…, 3)
    and ``K`` (…, 3, 3) broadcast over the leading dims."""
    R = rodrigues(rvec)
    cam = obj_pts @ R.transpose(-1, -2) + tvec[..., None, :]
    z = cam[..., 2:3]
    xy = cam[..., :2] / torch.where(z.abs() < 1e-12, 1e-12, z)
    xyd = distort(xy, dist)
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    u = xyd[..., 0] * fx[..., None] + cx[..., None]
    v = xyd[..., 1] * fy[..., None] + cy[..., None]
    return torch.stack([u, v], dim=-1)


def undistort_normalized(xy_d: torch.Tensor, dist, iters: int = 8) -> torch.Tensor:
    """Invert :func:`distort` by ``iters`` fixed-point steps of the
    residual form cv2.undistortPoints uses: x = (x_d − tangential) / radial."""
    k1, k2, p1, p2, k3, k4, k5, k6 = pad_dist(_f64(dist, xy_d)).unbind()
    xy = xy_d
    for _ in range(iters):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        r4, r6 = r2 * r2, r2 * r2 * r2
        inv_radial = (1.0 + k4 * r2 + k5 * r4 + k6 * r6) / (1.0 + k1 * r2 + k2 * r4 + k3 * r6)
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        xy = torch.stack([(xy_d[..., 0] - dx) * inv_radial, (xy_d[..., 1] - dy) * inv_radial],
                         dim=-1)
    return xy


def undistort_points(pts, K, dist, R=None, P=None) -> torch.Tensor:
    """Pixel coords (…, 2) → undistorted coords, normalized or (with ``P``)
    in pixels; ``cv2.undistortPoints(pts, K, dist, R=R, P=P)``."""
    K = _f64(K)
    pts = _f64(pts, K)
    xy_d = torch.stack([(pts[..., 0] - K[0, 2]) * (1.0 / K[0, 0]),
                        (pts[..., 1] - K[1, 2]) * (1.0 / K[1, 1])], dim=-1)
    xy = undistort_normalized(xy_d, dist)
    if R is not None:
        v = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1) @ _f64(R, K).T
        xy = v[..., :2] / v[..., 2:3]
    if P is not None:
        P = _f64(P, K)
        xy = torch.stack([xy[..., 0] * P[0, 0] + P[0, 2], xy[..., 1] * P[1, 1] + P[1, 2]], dim=-1)
    return xy


# ---------------------------------------------------------------------------
# Two-view geometry
# ---------------------------------------------------------------------------


def skew(t) -> torch.Tensor:
    """(…, 3) → the cross-product matrices (…, 3, 3)."""
    x, y, z = t.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], dim=-1), torch.stack([z, o, -x], dim=-1),
                        torch.stack([-y, x, o], dim=-1)], dim=-2)


def essential_from_rt(R, T) -> torch.Tensor:
    """E = [T]x R (cv2.stereoCalibrate's convention: x_r = R x_l + T)."""
    R = _f64(R)
    return skew(_f64(T, R)) @ R


def fundamental_from_krt(K1, K2, R, T) -> torch.Tensor:
    """F = K2⁻ᵀ E K1⁻¹."""
    K1 = _f64(K1)
    E = essential_from_rt(_f64(R, K1), _f64(T, K1))
    return torch.linalg.inv(_f64(K2, K1)).T @ E @ torch.linalg.inv(K1)


def triangulate(P1, P2, pts1, pts2) -> torch.Tensor:
    """Linear (DLT) triangulation. P1, P2: (…, 3, 4) projections; pts (…, 2)
    pixels. Returns (…, 3) points in the frame the projections map from:
    the eigenvector of the 4×4 AᵀA for its smallest eigenvalue (one batched
    ``eigh``), dehomogenised (its sign cancels)."""
    rows = []
    for P, pts in ((P1, pts1), (P2, pts2)):
        u, v = pts[..., 0:1], pts[..., 1:2]
        rows.append(u * P[..., 2, :] - P[..., 0, :])
        rows.append(v * P[..., 2, :] - P[..., 1, :])
    A = torch.stack(torch.broadcast_tensors(*rows), dim=-2)   # (…, 4, 4)
    _, V = torch.linalg.eigh(_matmul(A.transpose(-1, -2), A))
    X = V[..., :, 0]
    w = X[..., 3:]
    return X[..., :3] / torch.where(w.abs() < 1e-12, 1e-12, w)


# ---------------------------------------------------------------------------
# Rectification (cv2.stereoRectify, getOptimalNewCameraMatrix,
# initUndistortRectifyMap)
# ---------------------------------------------------------------------------


def _undistorted_border_extents(K, dist, size, R=None, P=None, n: int = 9):
    """Undistort an n×n grid of pixels spanning the image; return its inner
    and outer rectangles (x0, y0, x1, y1) as cv2's icvGetRectangles does."""
    w, h = size
    K = _f64(K)
    xs = torch.linspace(0.0, w - 1.0, n, dtype=K.dtype, device=K.device)
    ys = torch.linspace(0.0, h - 1.0, n, dtype=K.dtype, device=K.device)
    gx, gy = torch.meshgrid(xs, ys, indexing="xy")
    pts = torch.stack([gx, gy], dim=-1).reshape(-1, 2)
    und = undistort_points(pts, K, dist, R=R, P=P).reshape(n, n, 2)
    x, y = und[..., 0], und[..., 1]
    outer = (x.min(), y.min(), x.max(), y.max())
    inner = (x.min(dim=1).values.max(),  # the left edge of every row
             y.min(dim=0).values.max(),
             x.max(dim=1).values.min(),
             y.max(dim=0).values.min())
    return inner, outer


def get_optimal_new_camera_matrix(K, dist, size, alpha: float, new_size=None):
    """Free-scaling new camera matrix, cv2.getOptimalNewCameraMatrix:
    ``alpha=0`` keeps only valid pixels, ``alpha=1`` every source pixel.
    Returns (newK, roi (x, y, w, h))."""
    K = _f64(K)
    nw, nh = new_size if new_size is not None else size
    (ix0, iy0, ix1, iy1), (ox0, oy0, ox1, oy1) = _undistorted_border_extents(K, dist, size)
    # the focal lengths and centre that map the inner rectangle onto the new
    # image, then those that map the outer one
    fx0, fy0 = (nw - 1) / (ix1 - ix0), (nh - 1) / (iy1 - iy0)
    cx0, cy0 = -fx0 * ix0, -fy0 * iy0
    fx1, fy1 = (nw - 1) / (ox1 - ox0), (nh - 1) / (oy1 - oy0)
    cx1, cy1 = -fx1 * ox0, -fy1 * oy0
    a = torch.as_tensor(alpha, dtype=K.dtype, device=K.device)
    fx = fx0 * (1 - a) + fx1 * a
    fy = fy0 * (1 - a) + fy1 * a
    cx = cx0 * (1 - a) + cx1 * a
    cy = cy0 * (1 - a) + cy1 * a
    zero, one = torch.zeros_like(fx), torch.ones_like(fx)
    newK = torch.stack([torch.stack([fx, zero, cx]), torch.stack([zero, fy, cy]),
                        torch.stack([zero, zero, one])])
    # the valid pixels' ROI: the inner rectangle under the new K
    rx0 = torch.ceil(ix0 * fx + cx).clamp(0, nw - 1)
    ry0 = torch.ceil(iy0 * fy + cy).clamp(0, nh - 1)
    rx1 = torch.floor(ix1 * fx + cx)
    ry1 = torch.floor(iy1 * fy + cy)
    roi = torch.stack([rx0, ry0, (rx1 - rx0).clamp(0, nw), (ry1 - ry0).clamp(0, nh)])
    return newK, roi


def stereo_rectify(K1, d1, K2, d2, size, R, T, alpha: float = -1.0, new_size=None):
    """Bouguet rectification for horizontal stereo, cv2.stereoRectify with
    CALIB_ZERO_DISPARITY: the relative rotation is split between the
    cameras, the baseline turned onto the x axis, one focal length shared
    (cut where k1 < 0, as cv2 does for barrel distortion) and the principal
    point centred on the undistorted corners' mean. ``alpha`` in [0, 1]
    scales between the valid pixels only and every source pixel (values
    outside clamp); ``alpha < 0`` (cv2's default −1) leaves the focal length
    as it is. A zero baseline gives an infinite ``Q[3, 2]``. Computes in
    ``K1``'s dtype (float64 for calibration data). Returns (R1, R2, P1, P2,
    Q)."""
    K1 = _f64(K1)
    K2, R = _f64(K2, K1), _f64(R, K1)
    d1, d2 = _f64(d1, K1).ravel(), _f64(d2, K1).ravel()
    T = _f64(T, K1).ravel()
    dtype, device = K1.dtype, K1.device
    w, h = size
    nw, nh = new_size if new_size is not None else size

    # 1. half the relative rotation to each camera
    om = inverse_rodrigues(R)
    r_half = rodrigues(-0.5 * om)
    t = r_half @ T
    # 2. the rotation that turns the baseline onto the x axis
    uu = torch.tensor([1.0, 0.0, 0.0], dtype=dtype, device=device) * torch.where(
        t[0] > 0, 1.0, -1.0).to(dtype)
    ww = torch.linalg.cross(t, uu)
    nw_norm = torch.linalg.norm(ww)
    nt = torch.linalg.norm(t)
    angle = torch.arccos((t[0].abs() / (nt + 1e-12)).clamp(-1.0, 1.0))
    ww = ww * torch.where(nw_norm > 1e-12, angle / (nw_norm + 1e-12), 0.0)
    wR = rodrigues(ww)
    R1 = wR @ r_half.transpose(-1, -2)
    R2 = wR @ r_half
    baseline = (R2 @ T)[0]

    # 3. one focal length for both cameras
    def fc_est(K, d):
        k1 = pad_dist(d)[0]
        fc = K[1, 1]
        return torch.where(k1 < 0, fc * (1 + k1 * (w * w + h * h) / (4 * fc * fc)), fc)

    fc_new = torch.minimum(fc_est(K1, d1), fc_est(K2, d2))

    # 4. principal points: the undistorted corners through the rectifying
    #    rotation at (fc_new, cc = 0), their mean centred
    corners = torch.tensor([[0.0, 0.0], [w - 1.0, 0.0], [0.0, h - 1.0], [w - 1.0, h - 1.0]],
                           dtype=dtype, device=device)
    centre = torch.tensor([(nw - 1) * 0.5, (nh - 1) * 0.5], dtype=dtype, device=device)

    def cc_for(K, d, Rrect):
        und = undistort_points(corners, K, d)
        v = torch.cat([und, torch.ones_like(und[..., :1])], dim=-1) @ Rrect.T
        proj = v[..., :2] / v[..., 2:3] * fc_new
        return centre - proj.mean(dim=0)

    # CALIB_ZERO_DISPARITY: one principal point for both cameras
    cc = 0.5 * (cc_for(K1, d1, R1) + cc_for(K2, d2, R2))
    cx, cy = cc[0], cc[1]

    if alpha is not None and alpha >= 0:
        # free scaling: fit the inner (alpha=0) or outer (alpha=1)
        # undistorted rectangle around the fixed principal point
        zero, one = torch.zeros_like(fc_new), torch.ones_like(fc_new)
        newP = torch.stack([torch.stack([fc_new, zero, cx]), torch.stack([zero, fc_new, cy]),
                            torch.stack([zero, zero, one])])
        in1, out1 = _undistorted_border_extents(K1, d1, (w, h), R=R1, P=newP)
        in2, out2 = _undistorted_border_extents(K2, d2, (w, h), R=R2, P=newP)

        def s_terms(rect):
            x0, y0, x1, y1 = rect
            return torch.stack([cx / (cx - x0), cy / (cy - y0), (nw - cx) / (x1 - cx),
                                (nh - cy) / (y1 - cy)])

        s0 = torch.maximum(s_terms(in1).max(), s_terms(in2).max())
        s1 = torch.minimum(s_terms(out1).min(), s_terms(out2).min())
        a = torch.as_tensor(alpha, dtype=dtype, device=device).clamp(0.0, 1.0)
        fc_new = fc_new * (s0 * (1 - a) + s1 * a)

    P1 = torch.zeros((3, 4), dtype=dtype, device=device)
    P1[0, 0] = P1[1, 1] = fc_new
    P1[0, 2], P1[1, 2], P1[2, 2] = cx, cy, 1.0
    P2 = P1.clone()
    P2[0, 3] = baseline * fc_new
    Q = torch.zeros((4, 4), dtype=dtype, device=device)
    Q[0, 0] = Q[1, 1] = 1.0
    Q[0, 3], Q[1, 3], Q[2, 3] = -cx, -cy, fc_new
    Q[3, 2] = -1.0 / baseline
    return R1, R2, P1, P2, Q


def init_undistort_rectify_map(K, dist, R, newP, size):
    """(map_x, map_y) float32 remap grids, mirroring
    cv2.initUndistortRectifyMap: for each rectified pixel, the source pixel
    in the original distorted image. Computes in ``K``'s dtype (float64 for
    calibration data). Feed the result to ``core.image.remap``."""
    w, h = size
    fx, fy = newP[0, 0], newP[1, 1]
    cx, cy = newP[0, 2], newP[1, 2]
    dtype, device = K.dtype, K.device
    u = (torch.arange(w, dtype=dtype, device=device) - cx) / fx
    v = (torch.arange(h, dtype=dtype, device=device) - cy) / fy
    gx, gy = torch.meshgrid(u, v, indexing="xy")  # (h, w)
    rays = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    Rinv = torch.linalg.inv(R.to(dtype))
    pts = rays @ Rinv.T
    z = pts[..., 2:]
    xy = pts[..., :2] / torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)
    xyd = distort(xy, dist)
    map_x = xyd[..., 0] * K[0, 0] + K[0, 2]
    map_y = xyd[..., 1] * K[1, 1] + K[1, 2]
    return map_x.to(torch.float32), map_y.to(torch.float32)


def disparity_to_depth(disparity: torch.Tensor, focal_px: float, baseline: float) -> torch.Tensor:
    """depth = f·B / d (with the reference's eps guard)."""
    return focal_px * baseline / (disparity + 1e-6)


def reproject_image_to_3d(disparity: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """Disparity (H, W) + rectification Q (4, 4) → point cloud (H, W, 3),
    cv2.reprojectImageTo3D semantics ([x y d 1]ᵀ → Q·, dehomogenized)."""
    H, W = disparity.shape
    dev = disparity.device
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    vec = torch.stack([xs, ys, disparity.to(torch.float32), torch.ones_like(xs)], -1)
    out = vec @ Q.to(torch.float32).T
    w = out[..., 3:4]
    return out[..., :3] / torch.where(w.abs() < 1e-9, torch.full_like(w, 1e-9), w)


# ---------------------------------------------------------------------------
# Homographies
# ---------------------------------------------------------------------------


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as products and a sum: full float32 whatever
    ``torch.backends.cuda.matmul.allow_tf32`` says (a TF32 product of pixel
    coordinates would move a point by tenths of a pixel)."""
    return (a.unsqueeze(-1) * b.unsqueeze(-3)).sum(dim=-2)


def homography_dlt(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Direct linear transform homography from ≥ 4 correspondences.

    src, dst: (…, N, 2). Returns (…, 3, 3) with H[2, 2] = 1. Hartley
    normalization, then the eigenvector of AᵀA for its smallest eigenvalue
    (``eigh`` batches, so the RANSAC hypotheses of ``mono.ego`` solve as one
    call with N = 4). Where that eigenvalue is not simple (a degenerate
    sample, three points on a line) any vector of its space is a solution,
    and two libraries need not pick the same one."""
    def normalize(p):
        mean = p.mean(dim=-2, keepdim=True)
        d = torch.sqrt(((p - mean) ** 2).sum(dim=-1, keepdim=True) + 1e-12)
        scale = (2.0 ** 0.5) / (d.mean(dim=-2, keepdim=True) + 1e-12)
        pn = (p - mean) * scale
        s = scale[..., 0, 0]
        mx, my = mean[..., 0, 0], mean[..., 0, 1]
        one, zero = torch.ones_like(s), torch.zeros_like(s)
        T = torch.stack([torch.stack([s, zero, -s * mx], dim=-1),
                         torch.stack([zero, s, -s * my], dim=-1),
                         torch.stack([zero, zero, one], dim=-1)], dim=-2)
        return pn, T

    sn, Ts = normalize(src)
    dn, Td = normalize(dst)
    x, y = sn[..., 0], sn[..., 1]
    u, v = dn[..., 0], dn[..., 1]
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    r1 = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y, -u], dim=-1)
    r2 = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y, -v], dim=-1)
    A = torch.cat([r1, r2], dim=-2)  # (…, 2N, 9)
    _, V = torch.linalg.eigh(_matmul(A.transpose(-1, -2), A))
    Hn = V[..., :, 0].reshape(*V.shape[:-2], 3, 3)
    # inv_ex: no check of the LU's info, which reads it back to the host
    H = _matmul(_matmul(torch.linalg.inv_ex(Td)[0], Hn), Ts)
    h22 = H[..., 2:3, 2:3]
    return H / torch.where(h22.abs() < 1e-12, 1e-12, h22)


def apply_homography(H: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """pts (…, N, 2) → H·pts (…, N, 2), the perspective division guarded
    (cv2.perspectiveTransform)."""
    v = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    w = _matmul(v, H.transpose(-1, -2))
    return w[..., :2] / torch.where(w[..., 2:3].abs() < 1e-12, 1e-12, w[..., 2:3])
