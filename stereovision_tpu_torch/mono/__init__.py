from stereovision_tpu_torch.mono.flow import dense_flow  # noqa: F401
from stereovision_tpu_torch.mono.ego import ransac_homography, estimate_ego_motion  # noqa: F401
from stereovision_tpu_torch.mono.depth import (  # noqa: F401
    FlowDepthState,
    FlowDepthParams,
    flow_depth_init,
    flow_depth_step,
)
