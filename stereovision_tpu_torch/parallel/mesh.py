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

Across processes (:func:`initialize_multihost`, the counterpart of
``jax.distributed.initialize``), :func:`make_mesh` with no devices spans
every process of the ``torch.distributed`` group, one position a process
(its card), in rank order. Each process then holds only its own positions'
tensors (lists carry ``None`` at the others'); :func:`psum` all-gathers an
axis' parts and sums them in position order (the one-process sum, bit for
bit), :func:`ppermute` and :func:`halo_exchange` send and receive point to
point, and :meth:`Mesh.share` hands every process each position's result.
Over gloo, tensors on a card travel through the host.
"""

from __future__ import annotations

import dataclasses

import torch

from stereovision_tpu_torch.utils.backend import resolve_device


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis of a mesh that spans processes: the process (rank) of
    each of its positions, this process's rank, and the process group of
    the axis' processes (``psum``'s all-gather)."""

    owners: tuple[int, ...]
    rank: int
    group: object = dataclasses.field(compare=False, default=None)

    def owns(self, i: int) -> bool:
        return self.owners[i] == self.rank


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices[f][t]`` is the device of frame group ``f``, row tile ``t``;
    ``ranks[f][t]``, on a mesh that spans processes, the process that owns
    that position (``None``: this process owns every position)."""

    devices: tuple[tuple[torch.device, ...], ...]
    ranks: tuple[tuple[int, ...], ...] | None = None
    rank: int = 0
    frame_group: object = dataclasses.field(compare=False, default=None, repr=False)

    @property
    def shape(self) -> dict[str, int]:
        return {"frame": len(self.devices), "tile": len(self.devices[0])}

    @property
    def first(self) -> torch.device:
        return self.devices[0][0]

    @property
    def spans_processes(self) -> bool:
        return self.ranks is not None and len({r for row in self.ranks for r in row}) > 1

    @property
    def home(self) -> torch.device:
        """Where results are gathered: the first position's device, or on a
        mesh that spans processes this process's own."""
        if self.ranks is None:
            return self.first
        return next(d for drow, rrow in zip(self.devices, self.ranks)
                    for d, r in zip(drow, rrow) if r == self.rank)

    def owns(self, f: int, t: int = 0) -> bool:
        return self.ranks is None or self.ranks[f][t] == self.rank

    def frame_axis(self) -> Axis | None:
        """The frame axis (each frame group's first tile), or None on a
        one-process mesh."""
        if self.ranks is None:
            return None
        return Axis(tuple(row[0] for row in self.ranks), self.rank, self.frame_group)

    def tile_axis(self, f: int) -> Axis | None:
        """Frame group ``f``'s row tiles, or None on a one-process mesh."""
        return None if self.ranks is None else Axis(self.ranks[f], self.rank)

    def share(self, parts: dict, shape, dtype) -> dict:
        """``parts``: position (f, t) → tensor, this process's where it owns
        the position and ``None`` elsewhere, every tensor of ``shape`` and
        ``dtype`` → the same dict with every position's tensor on
        :attr:`home`, each owner broadcasting its own in turn."""
        if self.ranks is None:
            return {pos: t.to(self.home) for pos, t in parts.items()}
        import torch.distributed as dist

        out = {}
        for (f, t), part in parts.items():
            if self.owns(f, t):
                if tuple(part.shape) != tuple(shape) or part.dtype != dtype:
                    raise ValueError(f"position {(f, t)} holds {tuple(part.shape)} {part.dtype}, "
                                     f"not the {tuple(shape)} {dtype} every process expects")
                buf = _wire(part.contiguous())
            else:
                buf = torch.empty(shape, dtype=dtype, device=_wire_device(self.home))
            dist.broadcast(buf, src=self.ranks[f][t])
            out[(f, t)] = buf.to(self.home)
        return out


# this process's place in a torch.distributed group (initialize_multihost)
_PROCESS: dict = {}


def _wire_device(device: torch.device) -> torch.device:
    """Where a tensor of ``device`` travels: gloo moves host memory only."""
    return torch.device("cpu") if _PROCESS.get("backend") == "gloo" else device


def _wire(t: torch.Tensor) -> torch.Tensor:
    return t.to(_wire_device(t.device))


def make_mesh(frame: int | None = None, tile: int = 1, devices=None) -> Mesh:
    """Build a (frame, tile) mesh over ``devices`` (default: every visible
    CUDA device, which raises without a card, as ``resolve_device`` does;
    after :func:`initialize_multihost`, every process's device, one
    position a process in rank order), all on the frame axis unless
    ``frame`` says otherwise. A device may appear more than once:
    ``devices=["cpu"] * 8`` is the counterpart of the reference tests'
    eight virtual CPU devices, and ``["cuda:0"] * 4`` runs four row tiles
    on one card, one after another. Across processes every process must
    call it, with the same arguments."""
    if devices is None and _PROCESS:
        return _process_mesh(frame, tile)
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


def _process_mesh(frame: int | None, tile: int) -> Mesh:
    """The mesh over every process of the group: position r is rank r's
    device; the frame axis' processes get a group of their own."""
    import torch.distributed as dist

    n, rank = dist.get_world_size(), dist.get_rank()
    names = [None] * n
    dist.all_gather_object(names, str(_PROCESS["device"]))
    if frame is None:
        frame = n // tile
    if frame * tile != n:
        raise ValueError(f"{frame}×{tile} mesh positions != {n} processes")
    devices = [torch.device(d) for d in names]
    grid = [tuple(devices[f * tile:(f + 1) * tile]) for f in range(frame)]
    ranks = tuple(tuple(range(f * tile, (f + 1) * tile)) for f in range(frame))
    group = dist.new_group([row[0] for row in ranks])  # every process takes part
    return Mesh(tuple(grid), ranks, rank, group)


def _gather_axis(parts: dict, axis: Axis) -> dict:
    """Every position's part of ``axis`` on this process (the device of its
    own first part): an all-gather over the axis' processes, one position
    a process."""
    import torch.distributed as dist

    mine = [i for i in range(len(axis.owners)) if axis.owns(i)]
    if len(mine) != 1 or len(set(axis.owners)) != len(axis.owners):
        raise ValueError("across processes each process owns one position of an axis")
    if axis.group is None:
        raise ValueError("psum across processes runs over the frame axis only")
    local = parts[mine[0]]
    sent = _wire(local.contiguous())
    got = [torch.empty_like(sent) for _ in axis.owners]
    dist.all_gather(got, sent, group=axis.group)
    # the group's members in rank order; position i is owned by owners[i]
    by_rank = dict(zip(sorted(axis.owners), got))
    return {i: by_rank[r].to(local.device) for i, r in enumerate(axis.owners)}


def ppermute(rows: list, perm, axis: Axis | None = None) -> list:
    """``jax.lax.ppermute`` over one mesh axis: ``rows[i]`` lives on position
    i's device; each (src, dst) pair of ``perm`` sends ``rows[src]`` to
    position dst's device. A position that no pair sends to gets zeros.
    Across processes (``axis``), ``rows`` holds ``None`` at the positions
    of other processes, each process sends and receives its own positions'
    rows point to point, and every position's rows share one shape and
    dtype."""
    if axis is None:
        sent = {dst: rows[src].to(rows[dst].device) for src, dst in perm}
        return [sent[i] if i in sent else torch.zeros_like(r) for i, r in enumerate(rows)]
    import torch.distributed as dist

    sent, ops, landing = {}, [], {}
    for src, dst in perm:
        if axis.owns(src) and axis.owns(dst):
            sent[dst] = rows[src].to(rows[dst].device)
        elif axis.owns(src):
            ops.append(dist.P2POp(dist.isend, _wire(rows[src].contiguous()), axis.owners[dst]))
        elif axis.owns(dst):
            landing[dst] = torch.empty(rows[dst].shape, dtype=rows[dst].dtype,
                                       device=_wire_device(rows[dst].device))
            ops.append(dist.P2POp(dist.irecv, landing[dst], axis.owners[src]))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    sent.update({dst: buf.to(rows[dst].device) for dst, buf in landing.items()})
    return [None if r is None else sent[i] if i in sent else torch.zeros_like(r)
            for i, r in enumerate(rows)]


def psum(parts, axis: Axis | None = None):
    """``jax.lax.psum`` over one mesh axis: ``parts`` holds one tensor a
    position, as a list (every position this process's) or as a dict
    position → tensor (this process's positions); their sum, taken in
    position order on the first part's device, is sent back to each of
    them, in the same container. Across processes (``axis``) the parts of
    the other processes come by an all-gather first, so every process sums
    the same tensors in the same order: the one-process sum, bit for bit."""
    keyed = dict(enumerate(parts)) if isinstance(parts, list) else dict(parts)
    if not keyed:  # a process with no position on the axis takes no part
        return parts
    full = _gather_axis(keyed, axis) if axis is not None else keyed
    total = None
    for i in sorted(full):
        total = full[i] if total is None else total + full[i].to(total.device)
    out = {i: total.to(p.device) for i, p in keyed.items()}
    return [out[i] for i in range(len(parts))] if isinstance(parts, list) else out


def halo_exchange(slabs: list, halo: int, axis: Axis | None = None) -> list:
    """Row slabs of the tile axis (in order, each on its device) → each slab
    with ``halo`` rows of its upper and lower neighbour above and below it;
    the image's first and last tile replicate their own edge row instead
    (the single-device engine's replicate borders). Across processes
    (``axis``) ``slabs`` holds ``None`` at other processes' positions."""
    n = len(slabs)
    if any(s is not None and s.shape[0] < halo for s in slabs):
        raise ValueError(f"every tile needs at least halo = {halo} rows")
    top = ppermute([None if s is None else s[-halo:] for s in slabs],
                   [(i, (i + 1) % n) for i in range(n)], axis)
    bottom = ppermute([None if s is None else s[:halo] for s in slabs],
                      [(i, (i - 1) % n) for i in range(n)], axis)
    if slabs[0] is not None:
        top[0] = slabs[0][:1].expand(halo, *slabs[0].shape[1:])
    if slabs[-1] is not None:
        bottom[-1] = slabs[-1][-1:].expand(halo, *slabs[-1].shape[1:])
    return [None if s is None else torch.cat([t, s, b]) for t, s, b in zip(top, slabs, bottom)]


def initialize_multihost(coordinator: str | None = None, num_processes: int | None = None,
                         process_id: int | None = None, backend: str | None = None,
                         device="cuda") -> None:
    """Multi-process bootstrap: call once per process before building meshes.

    Joins the ``torch.distributed`` group: at ``tcp://{coordinator}``
    ("host:port") with ``num_processes`` and ``process_id`` when a
    coordinator is given, else by ``env://`` (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``, as ``torchrun`` sets
    them; the counterpart of JAX's auto-discovery). The backend is NCCL on
    cards and gloo on the CPU (``device="cpu"``); NCCL takes one card a
    process, so processes that share a card name ``backend="gloo"``. On
    cards the process is pinned to the card of its local rank
    (``LOCAL_RANK``, as ``torchrun`` sets it, else its rank) modulo the
    cards present, and NCCL raises where two processes would share one.
    The group is the process's own (``torch.distributed``'s), so this
    module keeps the process's device and backend beside it. After this,
    :func:`make_mesh` with no devices spans every process."""
    import os

    import torch.distributed as dist

    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo") or (backend == "nccl" and dev.type != "cuda"):
        raise ValueError(f"backend {backend!r} on {dev.type}: NCCL needs cards, gloo runs on both")
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and process_id")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id)
    else:
        kw = {} if num_processes is None else {"world_size": num_processes}
        if process_id is not None:
            kw["rank"] = process_id
        dist.init_process_group(backend, init_method="env://", **kw)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        cards = torch.cuda.device_count()
        if backend == "nccl" and local >= cards:
            raise RuntimeError(f"process {dist.get_rank()} would be the second on card "
                               f"{local % cards}: NCCL takes one card a process; pass "
                               "backend='gloo' to share a card")
        dev = torch.device("cuda", local % cards)
        torch.cuda.set_device(dev)
    _PROCESS.update(device=dev, backend=backend)


def shutdown_multihost() -> None:
    """Leave the group :func:`initialize_multihost` joined (meshes built
    since then span processes no more)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _PROCESS.clear()
