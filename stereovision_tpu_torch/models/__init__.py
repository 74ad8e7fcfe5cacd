from stereovision_tpu_torch.models.midas import MidasSmall  # noqa: F401
