from stereovision_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from stereovision_tpu_torch.parallel.disparity import sharded_disparity  # noqa: F401
from stereovision_tpu_torch.parallel.disparity_exact import (  # noqa: F401
    sharded_disparity_exact,
    sharded_disparity_exact_pipelined,
)
