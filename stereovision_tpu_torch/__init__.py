"""stereovision_tpu_torch — the PyTorch/CUDA port of ``stereovision_tpu``.

A second package beside the JAX one, mirroring its layout and names:

- ``core``    image and geometry operations as plain PyTorch ops
- ``calib``   chessboard detection and Levenberg–Marquardt calibration
              (mono, stereo, universal), and the rectification check
- ``ops``     hand-written CUDA kernels (``ops/csrc``), each beside its plain
              PyTorch version
- ``stereo``  the disparity engine (census cost + semi-global aggregation),
              the exact speckle filter, evaluation and the session autotune
- ``io``      the calibration store, frame sources, validators, PLY export
              and the native frame loader
- ``parallel`` the (frame, tile) device mesh, the sharded disparity
              engines, approximate and exact, and the distributed
              Schur-complement bundle adjusters
- ``fusion``  camera-occlusion detection, range calibration, the
              confidence-weighted fusion and its metric depth
- ``mono``    dense LK optical flow, RANSAC ego-motion, motion-parallax
              depth, the neural mono-depth estimator, and the sparse
              Harris/HOG features with two-view SfM
- ``models``  the MidasSmall network and a reader of flax checkpoints
- ``pipeline`` rectification + disparity + metric depth (``DepthPipeline``)
              and the three-method fusion engine (``FusedPipeline``)
- ``apps``    the calibration, depth, disparity-evaluation, fused-depth,
              mono-depth and sequence-SfM command lines

The JAX package stays the reference: every part of the port is tested
against it on the CPU. ROADMAP.md lists what is still to port.
"""

__version__ = "0.1.0"

from stereovision_tpu_torch.stereo import (  # noqa: E402,F401
    SGMParams,
    compute_disparity,
    compute_disparity_batch,
    disparity_with_confidence,
    reference_preset,
)


def __getattr__(name):
    if name in ("DepthPipeline", "DepthResult", "FusedPipeline"):
        from stereovision_tpu_torch import pipeline

        return getattr(pipeline, name)
    raise AttributeError(name)
