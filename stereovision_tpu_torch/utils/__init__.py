from stereovision_tpu_torch.utils.logging import get_logger, StageTimer  # noqa: F401
