"""The benchmark of ``stereovision_tpu_torch`` on an NVIDIA card: the
harness (``run.py``), its configurations, traffic mixes, metric readers,
the plain reference and the comparison that decides ``correct``. It
imports nothing of JAX or of the JAX package."""
