"""The modules a run may not load: JAX, its libraries and the JAX package
of this repository. Names are compared by their top-level part (before the
first dot) whole, so ``stereovision_tpu_torch`` is not ``stereovision_tpu``."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "stereovision_tpu"})


def forbidden_loaded(modules=None) -> list[str]:
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
