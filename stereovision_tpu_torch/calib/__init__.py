from stereovision_tpu_torch.calib.board import (  # noqa: F401
    detect_chessboard,
    corner_response,
    refine_corners_subpix,
)
from stereovision_tpu_torch.calib.ba import (  # noqa: F401
    CalibrationFlags,
    calibrate_camera,
    stereo_calibrate,
    reprojection_rms,
)
