"""Meshes as the sharding rules see them, and meshes of ranks: the port's
counterpart of the reference package's ``launch/mesh.py``.

The production meshes keep the reference's axes and sizes — single pod
16x16 = 256 chips, axes (data, model); multi-pod 2x16x16 = 512 chips, axes
(pod, data, model) — for ``sharding.rules`` and the dry-run that lowers
against them.  A ``Mesh`` is named axes and their sizes with no device
behind it; its positions are numbered in row-major order over the axes,
as ``jax.make_mesh`` lays out its devices.  The port's one card is the
1x1 ``make_host_mesh()``.

``make_rank_mesh(model)`` is the counterpart of the reference's
``make_host_mesh(model)``: a (data, model) mesh over the ranks of the
initialised ``torch.distributed`` world, with the process groups of each
axis behind it (``RankMesh``).  The MoE layer's multi-rank paths and the
sharded train step (``train.train_loop.jit_train_step``) run on it; a
``Mesh`` has no group behind it, and a layer under it runs on one rank.
"""
from __future__ import annotations

import itertools
import math
import os
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple


class Mesh:
    """Named mesh axes and their sizes (``axis_names``, ``shape``): all
    that ``sharding.rules`` reads."""

    def __init__(self, shape: Dict[str, int]):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def coords_of(self, rank: int) -> Dict[str, int]:
        """The coordinates of position ``rank`` (row-major over the
        axes)."""
        out = {}
        for name in reversed(self.axis_names):
            rank, out[name] = divmod(rank, self.shape[name])
        return {name: out[name] for name in self.axis_names}

    def rank_of(self, coords: Dict[str, int]) -> int:
        rank = 0
        for name in self.axis_names:
            rank = rank * self.shape[name] + coords[name]
        return rank


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh({"pod": 2, "data": 16, "model": 16})
    return Mesh({"data": 16, "model": 16})


def make_host_mesh() -> Mesh:
    """The mesh of the one card the port runs on: ``{"data": 1, "model":
    1}``."""
    return Mesh({"data": 1, "model": 1})


def mesh_axis_sizes(mesh) -> list:
    return [(name, int(mesh.shape[name])) for name in mesh.axis_names]


class RankMesh(Mesh):
    """A ``Mesh`` whose devices are the ranks of the ``torch.distributed``
    world, laid out in row-major order over the axes (rank ``d * model +
    m`` sits at ``data`` ``d``, ``model`` ``m``, as ``jax.make_mesh``
    lays out its devices).  ``group(axes)`` is the process group of the
    ranks that share this rank's coordinates on every other axis; the
    groups of every axis subset are made when the mesh is, by every rank
    in the same order, as ``torch.distributed.new_group`` requires."""

    def __init__(self, shape: Dict[str, int]):
        import torch.distributed as dist
        super().__init__(shape)
        if not dist.is_initialized():
            raise RuntimeError("a RankMesh needs an initialised "
                               "torch.distributed process group")
        size = self.size
        if dist.get_world_size() != size:
            raise ValueError(f"mesh {self.shape} has {size} ranks, the "
                             f"world {dist.get_world_size()}")
        self.rank = dist.get_rank()
        self.coords = self.coords_of(self.rank)
        self._groups: Dict[Tuple[str, ...], tuple] = {}
        names = self.axis_names
        for n in range(1, len(names) + 1):
            for axes in itertools.combinations(names, n):
                for ranks in self._partition(axes):
                    group = dist.new_group(list(ranks))
                    if self.rank in ranks:
                        self._groups[axes] = (group, ranks)

    def _partition(self, axes: Sequence[str]):
        """The rank sets that vary over ``axes`` only, in a fixed order."""
        rest = [a for a in self.axis_names if a not in axes]
        for fixed in itertools.product(*(range(self.shape[a])
                                         for a in rest)):
            base = dict(zip(rest, fixed))
            yield tuple(sorted(self.rank_of({**base, **dict(zip(axes, c))})
                               for c in itertools.product(
                                   *(range(self.shape[a]) for a in axes))))

    def group(self, axes: Sequence[str]):
        """(process group, its ranks in group-rank order) of the ranks that
        share this rank's coordinates off ``axes``."""
        key = tuple(a for a in self.axis_names if a in axes)
        return self._groups[key]


def make_rank_mesh(model: int = 1) -> RankMesh:
    """``{"data": world // model, "model": model}`` over the initialised
    ``torch.distributed`` world (``model`` clamped to [1, world], as the
    reference's ``make_host_mesh`` clamps it to its devices)."""
    import torch.distributed as dist
    n = dist.get_world_size()
    model = max(1, min(model, n))
    if n % model:
        raise ValueError(f"model={model} does not divide {n} ranks")
    return RankMesh({"data": n // model, "model": model})


# ------------------------------------------------------ ranks as processes

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(module: str, argv: list, world: int,
                timeout: float = 900.0) -> list:
    """Run ``python -m module *argv --rank r --port P`` for each rank ``r``
    of a world of ``world`` processes on this host; return their exit
    codes.  Every rank still running at ``timeout`` seconds is killed."""
    port = free_port()
    src = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ)
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, *argv, "--rank", str(r),
         "--port", str(port)], env=env) for r in range(world)]
    deadline = time.monotonic() + timeout
    rcs = []
    try:
        for p in procs:
            rcs.append(p.wait(timeout=max(deadline - time.monotonic(), 1)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return rcs


def init_rank(rank: int, world: int, port: int, device: str,
              model: int) -> RankMesh:
    """Join the ``gloo`` world on ``localhost:port`` as ``rank`` and return
    ``make_rank_mesh(model)``.  NCCL refuses two ranks on one GPU, so the
    ranks use gloo, which takes CUDA tensors itself; on the card every
    rank uses device 0, on the host the ranks share the cores."""
    import torch
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    if device == "cuda":
        torch.cuda.set_device(0)
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    return make_rank_mesh(model)


def close_ranks() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
