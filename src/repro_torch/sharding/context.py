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

_STATE = types.SimpleNamespace(ctx=None, dp=None)


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
