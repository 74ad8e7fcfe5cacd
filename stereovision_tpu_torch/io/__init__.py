from stereovision_tpu_torch.io.store import CalibrationStore  # noqa: F401
from stereovision_tpu_torch.io.frames import (  # noqa: F401
    PairedImageSource,
    SyntheticStereoSource,
    VideoSource,
)
