"""``parallel.mesh.initialize_multihost`` and a mesh that spans processes,
on the CPU: two gloo processes (``tests/_multihost_worker.py``), each on a
free port of this host and under a time limit; a process that fails or
runs out of time fails the test.

Each process holds its cross-process results against the same calls on a
one-process mesh of as many CPU positions, bit for bit (``torch.equal``):
``psum`` (an all-gather, then the sum in position order), ``ppermute`` and
``halo_exchange`` (point to point), ``sharded_disparity`` and the exact
engine's two strategies (each under the plain and the kernel impl) with
row tiles and with frames across the processes, ``distributed_slam_ba`` on
the frame axis and on a tile axis (one process owns no frame position) and
``distributed_mono_ba``.
"""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from stereovision_tpu_torch import parallel
from stereovision_tpu_torch.parallel import mesh as pmesh

REPO = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "_multihost_worker.py"
TIMEOUT_S = 150
EVERY_CHECK = ["psum", "ppermute", "halo_exchange", "sharded_disparity_tiles",
               "sharded_disparity_frames", "sharded_disparity_exact_tiles",
               "sharded_disparity_exact_pipelined_tiles", "sharded_disparity_exact_frames",
               "sharded_disparity_exact_pipelined_frames", "distributed_slam_ba_frames",
               "distributed_slam_ba_tiles", "distributed_mono_ba"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_group(mode: str, world: int = 2):
    """Start ``world`` workers, wait for all (TIMEOUT_S in all), return each
    one's JSON line; a non-zero exit or the time limit fails the test."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, str(WORKER), mode, str(r), str(world), str(port)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    deadline = time.monotonic() + TIMEOUT_S
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic())))
    except subprocess.TimeoutExpired:
        pytest.fail(f"a {mode} worker ran past {TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited with {p.returncode}:\n{err[-3000:]}"
    return [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]


def test_two_processes_with_a_coordinator():
    for r, line in enumerate(_run_group("explicit")):
        assert line == {"rank": r, "checked": EVERY_CHECK}


def test_two_processes_by_env():
    for r, line in enumerate(_run_group("env")):
        assert line == {"rank": r, "checked": ["psum"]}


def test_initialize_multihost_refuses_what_it_cannot_run():
    with pytest.raises(ValueError, match="NCCL needs cards"):
        pmesh.initialize_multihost("127.0.0.1:1", 2, 0, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="needs num_processes and process_id"):
        pmesh.initialize_multihost("127.0.0.1:1", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pmesh.initialize_multihost("127.0.0.1:1", 2, 0)
    assert not pmesh._PROCESS


def test_a_one_process_mesh_owns_every_position():
    mesh = parallel.make_mesh(frame=2, tile=2, devices=["cpu"] * 4)
    assert mesh.ranks is None and not mesh.spans_processes and mesh.home == mesh.first
    assert all(mesh.owns(f, t) for f in range(2) for t in range(2))
    assert mesh.frame_axis() is None and mesh.tile_axis(1) is None
    parts = {0: torch.ones(3), 1: torch.full((3,), 2.0)}
    assert torch.equal(pmesh.psum(parts)[1], torch.full((3,), 3.0))
    shared = mesh.share({(0, 1): torch.arange(4)}, (4,), torch.int64)
    assert torch.equal(shared[(0, 1)], torch.arange(4))
