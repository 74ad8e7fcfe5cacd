"""Measurement scripts of the port: the counterparts of the JAX package's
TPU measurement scripts of the same names under ``scripts/``.

Each runs its variants through the kernels of ``ops.bench_cuda`` on the
card, holds every variant against its plain version (exact), times it with
CUDA events beside its bound, and prints one line a variant::

    python -m stereovision_tpu_torch.scripts.bench_agg_step [variant ...]
    python -m stereovision_tpu_torch.scripts.bench_wta_variants [variant ...]
    python -m stereovision_tpu_torch.scripts.bench_rdisp [D ...]
    python -m stereovision_tpu_torch.scripts.bench_sumwta [D ...]

``run(device="cpu")`` drives the same path through the plain versions and
times nothing.
"""
