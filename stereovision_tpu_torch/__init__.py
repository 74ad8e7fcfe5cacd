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
- ``pipeline`` rectification + disparity + metric depth
- ``apps``    the depth and disparity-evaluation command lines

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
    if name in ("DepthPipeline", "DepthResult"):
        from stereovision_tpu_torch import pipeline

        return getattr(pipeline, name)
    if name == "FusedPipeline":
        raise AttributeError(
            "FusedPipeline is not ported yet (ROADMAP.md queue 1 item 7)")
    raise AttributeError(name)
