from stereovision_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from stereovision_tpu_torch.parallel.disparity import sharded_disparity  # noqa: F401
from stereovision_tpu_torch.parallel.disparity_exact import (  # noqa: F401
    sharded_disparity_exact,
    sharded_disparity_exact_pipelined,
)
from stereovision_tpu_torch.parallel.ba import distributed_mono_ba, mono_ba_init  # noqa: F401
from stereovision_tpu_torch.parallel.ba_landmarks import distributed_slam_ba  # noqa: F401
