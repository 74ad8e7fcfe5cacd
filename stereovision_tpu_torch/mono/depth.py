"""Motion-parallax depth from optical flow and ego-motion.

Counterpart of ``stereovision_tpu/mono/depth.py``: the state is explicit
(previous frame, EMA depth, last-motion time, the hypotheses' generator)
and one function advances it a frame:

- depth = 1 / (|flow − ego_flow| + 0.5);
- EMA α = 0.9 while moving, 0.99 static;
- bilateral 9/75/75 smoothing;
- the camera counts as moving for ``motion_timeout`` seconds after the last
  valid ego-motion;
- returns (depth, has_depth); has_depth False on the first frame and on a
  static scene with no accumulated depth.

Every flag stays a tensor on the device, so a frame never waits for the host.
"""

from __future__ import annotations

import dataclasses

import torch

from stereovision_tpu_torch.core import image as im
from stereovision_tpu_torch.mono.ego import estimate_ego_motion
from stereovision_tpu_torch.mono.flow import _resolve_warp, dense_flow
from stereovision_tpu_torch.utils.backend import resolve_device


@dataclasses.dataclass(frozen=True)
class FlowDepthParams:
    min_inliers: int = 15
    motion_timeout: float = 1.5
    flow_levels: int = 3
    flow_win: int = 15
    flow_iters: int = 3
    grid_step: int = 16
    ransac_threshold: float = 3.0
    alpha_moving: float = 0.9
    alpha_static: float = 0.99
    warp_impl: str = "auto"  # dense_flow's warp: auto/gather/shift

    def __post_init__(self):
        _resolve_warp(self.warp_impl)


@dataclasses.dataclass
class FlowDepthState:
    prev_gray: torch.Tensor       # (H, W)
    stable_depth: torch.Tensor    # (H, W)
    has_prev: torch.Tensor        # bool scalar
    has_stable: torch.Tensor      # bool scalar
    last_move_time: torch.Tensor  # float32 scalar (seconds)
    rng: torch.Generator          # RANSAC's hypotheses, on the state's device


def flow_depth_init(shape, seed: int = 0, device="cuda") -> FlowDepthState:
    dev = resolve_device(device)
    h, w = shape
    return FlowDepthState(
        prev_gray=torch.zeros((h, w), dtype=torch.float32, device=dev),
        stable_depth=torch.zeros((h, w), dtype=torch.float32, device=dev),
        has_prev=torch.zeros((), dtype=torch.bool, device=dev),
        has_stable=torch.zeros((), dtype=torch.bool, device=dev),
        last_move_time=torch.full((), -1e9, dtype=torch.float32, device=dev),
        rng=torch.Generator(device=dev).manual_seed(seed),
    )


def flow_depth_step(state: FlowDepthState, gray, t_now: float,
                    params: FlowDepthParams = FlowDepthParams(), device="cuda"):
    """One frame. gray: (H, W); t_now: seconds (a float, taken in float32).

    Returns (new_state, depth (H, W), has_depth, camera_moving), the flags
    bool tensors. The generator advances in place and is carried over."""
    dev = resolve_device(device)
    gray = torch.as_tensor(gray, dtype=torch.float32, device=dev)
    p = params
    t_now = float(torch.tensor(t_now, dtype=torch.float32))  # float32, as the reference

    flow = dense_flow(state.prev_gray, gray, p.flow_levels, p.flow_win, p.flow_iters,
                      warp_impl=p.warp_impl, device=dev)
    ego_valid, expected = estimate_ego_motion(flow, state.rng, step=p.grid_step,
                                              threshold=p.ransac_threshold,
                                              min_inliers=p.min_inliers, device=dev)
    ego_valid = ego_valid & state.has_prev

    residual = torch.hypot(flow[..., 0] - expected[..., 0], flow[..., 1] - expected[..., 1])
    current_depth = 1.0 / (residual + 0.5)

    camera_moving = ego_valid | ((t_now - state.last_move_time) < p.motion_timeout)
    alpha = torch.where(camera_moving, p.alpha_moving, p.alpha_static)
    stable = torch.where(state.has_stable,
                         alpha * state.stable_depth + (1 - alpha) * current_depth,
                         current_depth)
    # where ego-motion fails, the EMA holds its previous value
    stable = torch.where(ego_valid, stable, state.stable_depth)

    # select, then filter: the 81-tap bilateral runs once
    depth_out = im.bilateral_filter(torch.where(ego_valid, current_depth, state.stable_depth),
                                    9, 75.0, 75.0)
    has_depth = ego_valid | (camera_moving & state.has_stable)
    new_state = FlowDepthState(
        prev_gray=gray,
        stable_depth=stable,
        has_prev=torch.ones((), dtype=torch.bool, device=dev),
        has_stable=state.has_stable | ego_valid,
        last_move_time=torch.where(ego_valid, t_now, state.last_move_time),
        rng=state.rng,
    )
    return new_state, depth_out, has_depth, camera_moving
