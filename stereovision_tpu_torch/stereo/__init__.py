from stereovision_tpu_torch.stereo.autotune import tune_stats_impl  # noqa: F401
from stereovision_tpu_torch.stereo.sgm import (  # noqa: F401
    SGMParams,
    compute_disparity,
    compute_disparity_batch,
    disparity_with_confidence,
    production_preset,
    reference_preset,
)
