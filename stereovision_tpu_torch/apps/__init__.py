"""Command-line entry points of the port, the counterparts of
``stereovision_tpu/apps``:

    python -m stereovision_tpu_torch.apps.calibrate mono|stereo|universal …
    python -m stereovision_tpu_torch.apps.depth …
    python -m stereovision_tpu_torch.apps.eval_disparity …
    python -m stereovision_tpu_torch.apps.fused …
    python -m stereovision_tpu_torch.apps.mono_ai …
    python -m stereovision_tpu_torch.apps.mono_motion …
    python -m stereovision_tpu_torch.apps.sfm …
    python -m stereovision_tpu_torch.apps.serve …

Each takes the reference's flags plus ``--device`` (default ``cuda``).
Image files are read and written with ``imageio`` (and ``cv2`` for PNG
ground truth), the colormaps come from ``matplotlib``, the fused app's
text overlay from ``PIL``: an app whose
packages are missing stops at start with an ``ImportError`` that names them.
``serve`` reads its frames through ``io.frames.imread_gray`` (binary
PGM/PPM without any of them) and asks for ``imageio`` and ``matplotlib``
only with ``--save-png``.
"""

from __future__ import annotations

import importlib.util


def require(app: str, *modules: str) -> None:
    """Raise ``ImportError`` naming every module of ``modules`` that is not
    installed."""
    missing = [m for m in modules if importlib.util.find_spec(m) is None]
    if missing:
        raise ImportError(f"{app} needs {', '.join(missing)}, which "
                          f"{'is' if len(missing) == 1 else 'are'} not installed here")
