"""The device mesh: a (frame, tile) grid of ``torch.device``\\ s.

Counterpart of ``stereovision_tpu/parallel/mesh.py``. The reference is
single-controller SPMD: one process runs ``shard_map`` over a
``jax.sharding.Mesh``. Its direct counterpart here is one process that holds
a grid of devices and runs each mesh position's work on its device; PyTorch
queues work per device without waiting, so launches on distinct devices
overlap by themselves. Axes, as in the reference:

- ``frame``: data parallelism over frames;
- ``tile``: row tiles of one disparity solve, with halo rows from the
  neighbouring tiles.

Data moves between mesh positions only through :func:`ppermute`,
:func:`halo_exchange` and :func:`psum`.
"""

from __future__ import annotations

import dataclasses

import torch

from stereovision_tpu_torch.utils.backend import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices[f][t]`` is the device of frame group ``f``, row tile ``t``."""

    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict[str, int]:
        return {"frame": len(self.devices), "tile": len(self.devices[0])}

    @property
    def first(self) -> torch.device:
        return self.devices[0][0]


def make_mesh(frame: int | None = None, tile: int = 1, devices=None) -> Mesh:
    """Build a (frame, tile) mesh over ``devices`` (default: every visible
    CUDA device, which raises without a card, as ``resolve_device`` does),
    all on the frame axis unless ``frame`` says otherwise. A device may
    appear more than once: ``devices=["cpu"] * 8`` is the counterpart of the
    reference tests' eight virtual CPU devices, and ``["cuda:0"] * 4`` runs
    four row tiles on one card, one after another."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass devices=['cpu'] * n to build a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    n = len(devices)
    if frame is None:
        frame = n // tile
    if frame * tile != n or n == 0:
        raise ValueError(f"{frame}×{tile} mesh positions != {n} devices")
    return Mesh(tuple(tuple(devices[f * tile:(f + 1) * tile]) for f in range(frame)))


def ppermute(rows: list[torch.Tensor], perm) -> list[torch.Tensor]:
    """``jax.lax.ppermute`` over one mesh axis: ``rows[i]`` lives on position
    i's device; each (src, dst) pair of ``perm`` sends ``rows[src]`` to
    position dst's device. A position that no pair sends to gets zeros."""
    sent = {dst: rows[src].to(rows[dst].device) for src, dst in perm}
    return [sent[i] if i in sent else torch.zeros_like(r) for i, r in enumerate(rows)]


def psum(parts: list[torch.Tensor]) -> list[torch.Tensor]:
    """``jax.lax.psum`` over one mesh axis: ``parts[i]`` lives on position
    i's device; their sum, taken on the first position's device in position
    order, is sent back to every position."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device)
    return [total.to(p.device) for p in parts]


def halo_exchange(slabs: list[torch.Tensor], halo: int) -> list[torch.Tensor]:
    """Row slabs of the tile axis (in order, each on its device) → each slab
    with ``halo`` rows of its upper and lower neighbour above and below it;
    the image's first and last tile replicate their own edge row instead
    (the single-device engine's replicate borders)."""
    n = len(slabs)
    if any(s.shape[0] < halo for s in slabs):
        raise ValueError(f"every tile needs at least halo = {halo} rows")
    top = ppermute([s[-halo:] for s in slabs], [(i, (i + 1) % n) for i in range(n)])
    bottom = ppermute([s[:halo] for s in slabs], [(i, (i - 1) % n) for i in range(n)])
    top[0] = slabs[0][:1].expand(halo, *slabs[0].shape[1:])
    bottom[-1] = slabs[-1][-1:].expand(halo, *slabs[-1].shape[1:])
    return [torch.cat([t, s, b]) for t, s, b in zip(top, slabs, bottom)]


def initialize_multihost(coordinator: str | None = None, num_processes: int | None = None,
                         process_id: int | None = None) -> None:
    """The reference's multi-host bootstrap (``jax.distributed.initialize``).
    Process groups across hosts come with serving (ROADMAP.md queue 1
    item 9, serving and multi-host)."""
    raise NotImplementedError(
        "initialize_multihost is not ported yet: the mesh is one process's device grid; "
        "torch.distributed process groups across hosts come with serving "
        "(ROADMAP.md queue 1 item 9, serving and multi-host)")
