from stereovision_tpu_torch.mono.flow import dense_flow  # noqa: F401
from stereovision_tpu_torch.mono.ego import ransac_homography, estimate_ego_motion  # noqa: F401
from stereovision_tpu_torch.mono.depth import (  # noqa: F401
    FlowDepthState,
    FlowDepthParams,
    flow_depth_init,
    flow_depth_step,
)
from stereovision_tpu_torch.mono.features import (  # noqa: F401
    harris_corners,
    hog_descriptors,
    match_descriptors,
    ransac_essential,
    recover_pose_and_triangulate,
    sparse_motion_depth,
)
