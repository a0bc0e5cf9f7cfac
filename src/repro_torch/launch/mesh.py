"""Meshes as the sharding rules see them: named axes and their sizes, with
no device behind them, the port's counterpart of the reference package's
``launch/mesh.py``.

The production meshes keep the reference's axes and sizes — single pod
16x16 = 256 chips, axes (data, model); multi-pod 2x16x16 = 512 chips, axes
(pod, data, model) — for ``sharding.rules`` and the dry-run that lowers
against them.  The port runs on one card, so its host mesh is 1x1.
"""
from __future__ import annotations

from typing import Dict


class Mesh:
    """Named mesh axes and their sizes (``axis_names``, ``shape``): all
    that ``sharding.rules`` reads."""

    def __init__(self, shape: Dict[str, int]):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)


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
