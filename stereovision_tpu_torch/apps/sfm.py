"""Sequence SfM CLI: multi-frame pose refinement over an image sequence.

Counterpart of ``stereovision_tpu/apps/sfm.py``, with its flags plus
``--device`` (default ``cuda``; ``cpu`` runs on the CPU):

    python -m stereovision_tpu_torch.apps.sfm --images frames/ --fx 700 --fy 700 \\
        --cx 640 --cy 360 --out sfm_out

Harris+HOG tracks across consecutive frames (one batched call over the
frame stack) → two-view essential-matrix poses chained frame to frame →
tracks linked into landmarks → one batched triangulation → the
Schur+CG bundle adjustment over the mesh (the largest divisor of the
frame count among the visible cards), in chunks that each leave a resume
point (``ba_checkpoint.npz``) → ``sfm_result.npz``. Frames are read with
``imageio``. The RANSAC draws come from a ``torch.Generator`` seeded with
1 (the reference draws from ``PRNGKey(1)``).
"""

from __future__ import annotations

import argparse
import fnmatch
import json
import sys
from pathlib import Path

import numpy as np
import torch


def build_tracks(frames, K, max_corners=512, seed=0, device="cuda"):
    """Match consecutive frames; link the matches into tracks (landmark ids).

    Corner detection and description run as one batched device call over
    the frame stack, matching as one over the (F−1) consecutive pairs; the
    link stage is O(F) numpy vector steps on the host (mutual-nearest
    matches are injective).

    Returns (kp (F, C, 2) numpy, track_of (F, C) numpy int64 with −1 = no
    track, n_tracks, matches [(idx2_for_1, valid)] a consecutive pair)."""
    from stereovision_tpu_torch.mono.features import (
        harris_corners, hog_descriptors, match_descriptors,
    )
    from stereovision_tpu_torch.utils.backend import resolve_device, upload

    dev = resolve_device(device)
    stack = upload(np.stack([np.asarray(f, np.float32) for f in frames]), dev)
    pts, scores = harris_corners(stack, max_corners)
    descs = hog_descriptors(stack, pts)
    idx_all, valid_all = match_descriptors(descs[:-1], descs[1:], scores[:-1], scores[1:])
    kp = pts.cpu().numpy()
    idx_all = idx_all.cpu().numpy()
    valid_all = valid_all.cpu().numpy()

    F = len(frames)
    track_of = np.full((F, max_corners), -1, np.int64)
    n_tracks = 0
    for f in range(F - 1):
        idx, valid = idx_all[f], valid_all[f]
        new = valid & (track_of[f] < 0)
        n_new = int(new.sum())
        # new ids in ascending corner order
        track_of[f][new] = n_tracks + np.arange(n_new)
        n_tracks += n_new
        track_of[f + 1][idx[valid]] = track_of[f][valid]
    return kp, track_of, n_tracks, [(idx_all[f], valid_all[f]) for f in range(F - 1)]


def chain_poses(kp, matches, K, generator: torch.Generator, device="cuda"):
    """Relative poses from each consecutive pair's essential matrix
    (RANSAC on its mutual matches), chained onto the previous absolute
    pose; a pair of fewer than 16 matches repeats the previous pose.
    Returns poses (F, 6) numpy float64 (rvec, tvec per frame)."""
    from stereovision_tpu_torch.core import geometry as geom
    from stereovision_tpu_torch.mono.features import (
        ransac_essential, recover_pose_and_triangulate,
    )
    from stereovision_tpu_torch.utils.backend import resolve_device, upload

    dev = resolve_device(device)
    F = kp.shape[0]
    poses = np.zeros((F, 6))
    c, fl = np.array([K[0, 2], K[1, 2]]), np.array([K[0, 0], K[1, 1]])
    for f in range(F - 1):
        idx, valid = matches[f]
        m1, m2 = kp[f][valid], kp[f + 1][idx[valid]]
        if len(m1) < 16:
            poses[f + 1] = poses[f]
            continue
        x1n, x2n = upload((m1 - c) / fl, dev), upload((m2 - c) / fl, dev)
        E, inl = ransac_essential(x1n, x2n, torch.ones(len(m1), dtype=torch.bool, device=dev),
                                  generator)
        R_rel, t_rel, _, _ = recover_pose_and_triangulate(E, x1n, x2n, inl)
        pose = upload(poses[f], dev)
        rf, tf = geom.se3_compose(pose[:3], pose[3:], geom.inverse_rodrigues(R_rel), t_rel)
        poses[f + 1] = torch.cat([rf, tf]).cpu().numpy()
    return poses


def observations(kp, track_of, n_tracks, min_track_length):
    """Tracks of at least ``min_track_length`` frames as fixed-slot
    observation arrays: (L, obs_uv (F, M, 2), obs_lid (F, M) int32,
    obs_mask (F, M) bool), the kept corners of a frame in ascending corner
    order."""
    F = kp.shape[0]
    counts = np.bincount(track_of[track_of >= 0], minlength=max(n_tracks, 1))
    keep = np.nonzero(counts >= min_track_length)[0]
    remap_arr = np.full(max(n_tracks, 1), -1, np.int64)
    remap_arr[keep] = np.arange(len(keep))
    lid_of = np.where(track_of >= 0, remap_arr[np.clip(track_of, 0, None)], -1)
    sel = lid_of >= 0
    M = max(int(sel.sum(axis=1).max()), 8)
    obs_uv = np.zeros((F, M, 2))
    obs_lid = np.zeros((F, M), np.int32)
    obs_mask = np.zeros((F, M), bool)
    for f in range(F):
        ii = np.nonzero(sel[f])[0]
        obs_uv[f, :len(ii)] = kp[f][ii]
        obs_lid[f, :len(ii)] = lid_of[f][ii]
        obs_mask[f, :len(ii)] = True
    return len(keep), obs_uv, obs_lid, obs_mask


def init_landmarks(poses, K, L, obs_uv, obs_lid, obs_mask, device="cuda"):
    """Each landmark triangulated from its first and last observation, all
    in one batched call; a landmark seen once starts at (0, 0, 10).
    Returns (L, 3) numpy float64."""
    from stereovision_tpu_torch.core import geometry as geom
    from stereovision_tpu_torch.utils.backend import resolve_device

    dev = resolve_device(device)
    F, M = obs_lid.shape
    fgrid = np.broadcast_to(np.arange(F)[:, None], (F, M))
    mm = obs_mask.reshape(-1)
    lids = obs_lid.reshape(-1)[mm]
    fs_m = fgrid.reshape(-1)[mm]
    flat_uv = obs_uv.reshape(-1, 2)[mm]
    order = np.argsort(fs_m, kind="stable")
    first_f = np.full(L, -1, np.int64)
    first_uv = np.zeros((L, 2))
    last_f = np.full(L, -1, np.int64)
    last_uv = np.zeros((L, 2))
    # fancy assignment keeps the LAST write per landmark: descending frame
    # order makes the smallest frame win for "first", ascending for "last"
    o = order[::-1]
    first_f[lids[o]] = fs_m[o]
    first_uv[lids[o]] = flat_uv[o]
    last_f[lids[order]] = fs_m[order]
    last_uv[lids[order]] = flat_uv[order]
    two_obs = (first_f >= 0) & (last_f > first_f)
    p = torch.as_tensor(poses, device=dev)
    Kt = torch.as_tensor(K, dtype=torch.float64, device=dev)
    pmats = Kt @ torch.cat([geom.rodrigues(p[:, :3]), p[:, 3:, None]], dim=2)   # (F, 3, 4)
    f1 = torch.as_tensor(np.clip(first_f, 0, None), device=dev)
    f2 = torch.as_tensor(np.clip(last_f, 0, None), device=dev)
    X = geom.triangulate(pmats[f1], pmats[f2], torch.as_tensor(first_uv, device=dev),
                         torch.as_tensor(last_uv, device=dev)).cpu().numpy()
    return np.where(two_obs[:, None], np.clip(X, -100, 100), np.array([0.0, 0.0, 10.0]))


def sfm_mesh(F: int, device="cuda"):
    """The BA's mesh: on the CPU one position; on cards, the largest
    divisor of F among the visible devices."""
    from stereovision_tpu_torch.parallel import make_mesh
    from stereovision_tpu_torch.utils.backend import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu":
        return make_mesh(frame=1, devices=["cpu"])
    n_dev = torch.cuda.device_count()
    frame_axis = next(n for n in range(min(n_dev, F), 0, -1) if F % n == 0)
    return make_mesh(frame=frame_axis, devices=[f"cuda:{i}" for i in range(frame_axis)])


def main(argv=None):
    ap = argparse.ArgumentParser(prog="stereovision_tpu_torch.apps.sfm")
    ap.add_argument("--images", required=True)
    ap.add_argument("--glob", default="*.jpg")
    ap.add_argument("--fx", type=float, required=True)
    ap.add_argument("--fy", type=float, required=True)
    ap.add_argument("--cx", type=float, required=True)
    ap.add_argument("--cy", type=float, required=True)
    ap.add_argument("--out", default="sfm_out")
    ap.add_argument("--max-frames", type=int, default=64)
    ap.add_argument("--ba-iters", type=int, default=10)
    ap.add_argument("--ba-checkpoint-every", type=int, default=5,
                    help="save BA state every N LM iterations (resume point)")
    ap.add_argument("--resume", action="store_true",
                    help="resume the BA from <out>/ba_checkpoint.npz")
    ap.add_argument("--min-track-length", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from stereovision_tpu_torch.apps import require

    require("stereovision_tpu_torch.apps.sfm", "imageio")
    from stereovision_tpu_torch.io.frames import _imread_gray
    from stereovision_tpu_torch.parallel.ba_landmarks import distributed_slam_ba
    from stereovision_tpu_torch.utils.backend import resolve_device

    dev = resolve_device(args.device)
    files = sorted(p for p in Path(args.images).iterdir()
                   if fnmatch.fnmatch(p.name, args.glob))[:args.max_frames]
    if len(files) < 3:
        raise SystemExit("need at least 3 frames")
    frames = [_imread_gray(p) for p in files]
    K = np.array([[args.fx, 0, args.cx], [0, args.fy, args.cy], [0, 0, 1]])
    print(f"[sfm] {len(frames)} frames; tracking…")
    kp, track_of, n_tracks, matches = build_tracks(frames, K, device=dev)
    L, obs_uv, obs_lid, obs_mask = observations(kp, track_of, n_tracks, args.min_track_length)
    print(f"[sfm] {n_tracks} raw tracks → {L} with length ≥ {args.min_track_length}")
    if L < 20:
        raise SystemExit("too few stable tracks — more texture or frames needed")
    F = len(frames)
    poses = chain_poses(kp, matches, K, torch.Generator(device=dev).manual_seed(1), device=dev)
    landmarks = init_landmarks(poses, K, L, obs_uv, obs_lid, obs_mask, device=dev)

    mesh = sfm_mesh(F, dev)
    print(f"[sfm] BA over {mesh.shape['frame']}-device mesh: {F} poses, {L} landmarks…")
    intr = np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]])
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    ckpt = out_dir / "ba_checkpoint.npz"
    done = 0
    if args.resume and ckpt.exists():
        z = np.load(ckpt)
        poses, landmarks, done = z["poses"], z["landmarks"], int(z["iters_done"])
        print(f"[sfm] resumed BA checkpoint at iteration {done}")
    # the LM loop in chunks; each chunk boundary is a resume point
    p_out, l_out, rms = poses, landmarks, np.inf
    while done < args.ba_iters:
        chunk = min(args.ba_checkpoint_every, args.ba_iters - done)
        p_out, l_out, rms = distributed_slam_ba(obs_uv, obs_lid, obs_mask, intr, p_out, l_out,
                                                mesh, iters=chunk)
        p_out, l_out, rms = p_out.cpu().numpy(), l_out.cpu().numpy(), float(rms)
        done += chunk
        np.savez(ckpt, poses=p_out, landmarks=l_out, iters_done=done)
        print(f"[sfm] BA {done}/{args.ba_iters} iterations, rms={rms:.3f}")
    np.savez(out_dir / "sfm_result.npz", poses=np.asarray(p_out), landmarks=np.asarray(l_out),
             rms=float(rms), files=[f.name for f in files])
    print(json.dumps({"frames": F, "landmarks": L, "ba_rms_px": round(float(rms), 3)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
