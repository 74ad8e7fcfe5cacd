"""stereovision_tpu_torch — the PyTorch/CUDA port of ``stereovision_tpu``.

A second package beside the JAX one, mirroring its layout and names:

- ``core``    image and geometry operations as plain PyTorch ops
- ``ops``     hand-written CUDA kernels (``ops/csrc``), each beside its plain
              PyTorch version
- ``stereo``  the disparity engine (census cost + semi-global aggregation),
              the exact speckle filter, evaluation and the session autotune
- ``io``      the calibration store, frame sources, validators, PLY export
              and the native frame loader
- ``parallel`` the (frame, tile) device mesh and the sharded disparity
              engines, approximate and exact
- ``fusion``  camera-occlusion detection, range calibration, the
              confidence-weighted fusion and its metric depth
- ``mono``    dense LK optical flow, RANSAC ego-motion, motion-parallax
              depth, and the neural mono-depth estimator
- ``models``  the MidasSmall network and a reader of flax checkpoints
- ``pipeline`` rectification + disparity + metric depth (``DepthPipeline``)
              and the three-method fusion engine (``FusedPipeline``)
- ``apps``    the depth, disparity-evaluation and fused-depth command lines

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
