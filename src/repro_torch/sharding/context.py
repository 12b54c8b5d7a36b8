"""Sharding contexts of the model code (port of
``repro/sharding/context.py``, plus the data-parallel loss context).

``use(cfg, mesh)`` makes ``(logical rules, mesh)`` current while a block
runs; ``current()`` returns it (None outside).  Inside it,
``models/moe.py`` runs its expert-parallel branch, as the reference's
does.  ``constrain(x, axes)`` marks the points where the reference pins an
activation's sharding by logical axes; the port's placement is explicit, so
it returns ``x`` unchanged.

``data_parallel(n_shards, mask_total, moe_aux)`` is the port's own: the
mesh train step runs one forward per data shard, where the reference runs
one forward over the global batch.  Inside it the losses that are means
over the global batch stay so: ``common.cross_entropy`` divides a shard's
sum by the global count (``n_shards`` times the shard's element count, or
``mask_total`` unmasked positions), and ``moe.apply`` hands its
load-balance term to ``moe_aux`` (a ``moe.GlobalAux``), which combines the
shards' expert statistics before the product.

``model_parallel(mesh, coord)`` is the port's tensor-parallel context:
the mesh train step enters it for each data shard (``coord``: the shard's
model-0 coordinate), forward and backward.  Inside it, with a model axis
of ``tp > 1``, ``sharding.arrays.materialize`` leaves a parameter's
model-axis blocks as blocks (``arrays.ModelShards``), and the model code
computes each block on its own model shard's device
(``ModelParallel.devices``), joined by the collectives of
``sharding/arrays.py`` (``to_model_shards``, ``reduce_from_model_shards``).

``at(coord)`` names the mesh coordinate the ops in its block run for;
``coordinate()`` reads it (else the model-parallel shard's model-0
coordinate, else None).  Only the dry run's counter reads it
(``launch/cost_analysis.py``).

The state is the process's, not a thread's: on the card autograd runs the
backward, and with it each recomputed (``remat``) layer, on a thread of its
own, which must take the same branches as the forward did.
"""
from __future__ import annotations

import contextlib
import dataclasses
import types
from typing import Any, Optional

from repro_torch.sharding import rules as rules_lib

_STATE = types.SimpleNamespace(ctx=None, dp=None, mp=None, coord=None)


@contextlib.contextmanager
def use(cfg, mesh):
    rules = rules_lib.logical_rules(cfg, mesh)
    prev = _STATE.ctx
    _STATE.ctx = (rules, mesh)
    try:
        yield
    finally:
        _STATE.ctx = prev


def current():
    """(rules, mesh) inside a ``use`` block, else None."""
    return _STATE.ctx


def constrain(x, axes: tuple):
    """The reference pins ``x``'s sharding to ``axes`` here; the port
    places every tensor explicitly, so ``x`` is returned as is."""
    return x


@dataclasses.dataclass
class DataParallel:
    n_shards: int
    mask_total: Any = None          # unmasked positions of the global batch
    moe_aux: Optional[Any] = None   # a moe.GlobalAux, or None


@contextlib.contextmanager
def data_parallel(n_shards: int, mask_total=None, moe_aux=None):
    prev = _STATE.dp
    _STATE.dp = DataParallel(n_shards, mask_total, moe_aux)
    try:
        yield
    finally:
        _STATE.dp = prev


def data_parallel_state() -> Optional[DataParallel]:
    return _STATE.dp


@dataclasses.dataclass(frozen=True)
class ModelParallel:
    """One data shard's model shards: shard ``t`` is mesh coordinate
    ``coords[t]`` on ``devices[t]`` (``t`` = 0 is the shard's lead, which
    holds the residual stream)."""
    mesh: Any
    coords: tuple
    devices: tuple

    @property
    def tp(self) -> int:
        return len(self.coords)

    @contextlib.contextmanager
    def on(self, t: int):
        """Model shard ``t``'s ops (``at`` its coordinate)."""
        with at(self.coords[t]):
            yield


def model_shards_of(mesh, coord) -> ModelParallel:
    """The model shards of the data shard whose model-0 coordinate is
    ``coord``."""
    m = mesh.axis_names.index("model")
    coords = tuple(coord[:m] + (t,) + coord[m + 1:] for t in range(mesh.shape["model"]))
    return ModelParallel(mesh, coords, tuple(mesh.device(c) for c in coords))


@contextlib.contextmanager
def model_parallel(mesh, coord):
    """Tensor-parallel compute over the model shards of the data shard at
    ``coord`` (the mesh train step enters it only at a model axis above
    1)."""
    prev = _STATE.mp
    _STATE.mp = model_shards_of(mesh, coord)
    try:
        yield _STATE.mp
    finally:
        _STATE.mp = prev


def model_parallel_state() -> Optional[ModelParallel]:
    return _STATE.mp


@contextlib.contextmanager
def at(coord):
    """The ops in this block run for mesh coordinate ``coord``."""
    prev = _STATE.coord
    _STATE.coord = coord
    try:
        yield
    finally:
        _STATE.coord = prev


def coordinate():
    """The coordinate of ``at``, else the model-parallel data shard's lead,
    else None."""
    if _STATE.coord is not None:
        return _STATE.coord
    return _STATE.mp.coords[0] if _STATE.mp is not None else None


def explicit_coordinate():
    """The coordinate of the innermost ``at`` block, or None."""
    return _STATE.coord
