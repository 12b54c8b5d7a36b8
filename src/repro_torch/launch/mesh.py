"""Training meshes (port of ``repro/launch/mesh.py``).

A ``TrainMesh`` is a grid of ``torch.device``s with named axes, ``("data",
"model")`` or ``("pod", "data", "model")``, stored row-major as the
reference's ``Mesh.devices`` array is.  One process drives the whole grid,
as the reference's single controller does: there is no
``torch.distributed``.  A device list may repeat a device, so every
coordinate of a mesh can sit on one card (or on the CPU in the tests).
Building a mesh touches no device state.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class TrainMesh:
    """``axis_names`` over a grid of ``grid`` devices, row-major:
    coordinate ``c`` is ``devices[rank(c)]``."""
    axis_names: tuple
    grid: tuple
    devices: tuple

    def __post_init__(self):
        if len(self.axis_names) != len(self.grid):
            raise ValueError(f"axes {self.axis_names} do not name the grid {self.grid}")
        if len(self.devices) != math.prod(self.grid):
            raise ValueError(f"a {self.grid} mesh needs {math.prod(self.grid)} "
                             f"devices, got {len(self.devices)}")

    @property
    def shape(self) -> dict:
        """{axis name: size}, as the reference's ``Mesh.shape``."""
        return dict(zip(self.axis_names, self.grid))

    @property
    def size(self) -> int:
        return len(self.devices)

    def coords(self) -> list:
        """Every coordinate in rank (row-major) order."""
        return list(itertools.product(*(range(n) for n in self.grid)))

    def rank(self, coord) -> int:
        r = 0
        for c, n in zip(coord, self.grid):
            r = r * n + c
        return r

    def device(self, coord) -> torch.device:
        return self.devices[self.rank(coord)]

    def coord(self, **at) -> tuple:
        """The coordinate with the named axes at the given indices and
        every other axis at 0."""
        return tuple(at.get(a, 0) for a in self.axis_names)


def make_mesh(shape: Sequence[int], axes: Sequence[str], devices=None, *,
              platform: str = "cuda") -> TrainMesh:
    """A ``shape`` mesh over ``axes`` on the first ``prod(shape)`` of
    ``devices``.  With ``devices`` None: the visible CUDA devices, or with
    ``platform="cpu"`` that many CPU shards (the counterpart of the
    reference's forced host-device count).  An explicit list may repeat a
    device."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    need = math.prod(shape)
    if devices is None:
        devices = ([torch.device("cpu")] * need if platform == "cpu" else
                   [torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    devices = [torch.device(d) for d in devices]
    if len(devices) < need:
        raise ValueError(f"mesh {shape} needs {need} devices, have {len(devices)}")
    return TrainMesh(axes, shape, tuple(devices[:need]))


def make_local_mesh(devices: Optional[Sequence] = None, *,
                    platform: str = "cuda") -> TrainMesh:
    """Every device given (default: every visible card) as a ``(n, 1)``
    mesh over ``("data", "model")``."""
    if devices is None:
        devices = ([torch.device("cpu")] if platform == "cpu" else
                   [torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    return make_mesh((len(devices), 1), ("data", "model"), devices)


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> TrainMesh:
    """16 x 16 = 256 chips a pod; multi-pod adds a leading 2-pod axis.
    Over the first of ``devices``, or by default over ``meta`` devices: the
    grid then carries shapes and layouts for a dry run and allocates
    nothing."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if devices is None:
        devices = [torch.device("meta")] * math.prod(shape)
    return make_mesh(shape, axes, devices)


def make_train_mesh(devices) -> TrainMesh:
    """The train CLI's mesh over ``devices``, as the reference picks it:
    ``(n, 1)`` below 256 devices, else the production grid (with the pod
    axis from 512)."""
    n = len(devices)
    if n < 256:
        return make_local_mesh(devices)
    return make_production_mesh(multi_pod=n >= 512, devices=devices)
