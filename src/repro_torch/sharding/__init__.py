"""Sharding of the port: the logical-axis rules (``rules.py``), the model
code's contexts (``context.py``), arrays in blocks over a training mesh
(``arrays.py``), and mesh-sharded serving (``serving.py``); ports of
``repro/sharding/``.  The package exports the rules' five functions, as
the reference's does."""
from repro_torch.sharding.rules import (
    batch_sharding,
    cache_shardings,
    logical_rules,
    param_shardings,
    spec_for,
)

__all__ = [
    "logical_rules",
    "spec_for",
    "param_shardings",
    "batch_sharding",
    "cache_shardings",
]
