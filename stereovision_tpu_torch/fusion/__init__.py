from stereovision_tpu_torch.fusion.occlusion import (  # noqa: F401
    occlusion_scores,
    classify_occlusion,
    classify_occlusion_code,
    hysteresis_init,
    hysteresis_update,
    OCCLUSION_CODES,
    OcclusionHysteresis,
)
from stereovision_tpu_torch.fusion.calibrate import (  # noqa: F401
    calibrate_midas_to_stereo,
    normalize_to_stereo_range,
)
from stereovision_tpu_torch.fusion.fuse import FusionParams, fuse_depth_maps  # noqa: F401
from stereovision_tpu_torch.fusion.legend import fused_to_meters  # noqa: F401
