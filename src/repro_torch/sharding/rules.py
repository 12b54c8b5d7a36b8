"""Logical-axis sharding rules (port of ``repro/sharding/rules.py``).

Every parameter carries a tuple of logical axis names (``models/common.py``
``Initializer``).  ``logical_rules`` maps logical axes to mesh axes for an
arch and a mesh; ``spec_for`` resolves a concrete shape to a spec, dropping
any mesh axis that does not divide the dimension.  A spec is the port's
``PartitionSpec``: a tuple with one entry a dimension (``None``, a mesh axis
name, or a tuple of names), trailing ``None``s dropped.  ``NamedSharding``
pairs a spec with a ``launch.mesh.TrainMesh``; its ``indices(shape)`` is the
reference's ``NamedSharding.devices_indices_map`` keyed by mesh coordinate.

Parallelism mapping (as the reference's):
  pod   — data parallelism across pods
  data  — data parallelism + FSDP weight sharding (``fsdp_weights`` archs)
  model — tensor parallelism: heads / mlp / vocab / experts / rnn channels
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import math

from repro_torch.configs.base import ArchConfig


def _mesh_size(mesh, names) -> int:
    return math.prod(mesh.shape[n] for n in names)


def _names(entry) -> tuple:
    return () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))


def data_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def data_coords(mesh) -> list:
    """The data shards' coordinates (every other axis at 0), in rank order
    over the data axes: the blocks of a ``batch``-sharded array."""
    axes = data_axes(mesh)
    return [mesh.coord(**dict(zip(axes, c)))
            for c in itertools.product(*(range(mesh.shape[a]) for a in axes))]


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh."""
    mesh: object
    spec: tuple

    def indices(self, shape) -> dict:
        """{coordinate: tuple of slices}: the block of a ``shape`` array
        each coordinate holds (``slice(None)`` for an unsplit dimension), in
        rank order."""
        return _indices(self, tuple(shape))


@functools.lru_cache(maxsize=None)
def _indices(sharding: NamedSharding, shape: tuple) -> dict:
    """``NamedSharding.indices``, computed once a (sharding, shape): the
    train step asks for it at every gather.  Callers only read it."""
    mesh = sharding.mesh
    spec = tuple(sharding.spec) + (None,) * (len(shape) - len(sharding.spec))
    axis = {a: i for i, a in enumerate(mesh.axis_names)}
    out = {}
    for coord in mesh.coords():
        idx = []
        for dim, entry in zip(shape, spec):
            names = _names(entry)
            if not names:
                idx.append(slice(None))
                continue
            part = 0
            for n in names:             # the first name is the major one
                part = part * mesh.shape[n] + coord[axis[n]]
            step = dim // _mesh_size(mesh, names)
            idx.append(slice(part * step, (part + 1) * step))
        out[coord] = tuple(idx)
    return out


def logical_rules(cfg: ArchConfig, mesh) -> dict:
    """logical axis -> mesh axes (a tuple; () replicates)."""
    rules = {
        "vocab": ("model",),
        "mlp": ("model",),
        "experts": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "rnn": ("model",),
        "rnn_in": (),       # the gate weights' contraction dim (rglru.init)
        "expert_mlp": (),
        "embed": (),
        "head_dim": (),
        "q_lora": (),
        "kv_lora": (),
        "conv": (),
        "layers": (),
        "batch": data_axes(mesh),
        "seq": (),
        "kv_seq": ("model",),   # cache fallback: shard the cache length over TP
        "frames": (),
        "expert_capacity": (),
    }
    if cfg.fsdp_weights:
        # ZeRO-3 style: the big replicated weight dim is also split over data
        rules["embed"] = ("data",)
        rules["expert_mlp"] = ("data",) if cfg.moe else ()
    return rules


def spec_for(shape, axes, rules: dict, mesh) -> tuple:
    """The spec of a ``shape`` array with logical ``axes``: each dim takes
    its rule's mesh axes not used by an earlier dim, if they divide it."""
    if axes is None:
        return ()
    entries, used = [], set()
    for dim, name in zip(shape, axes):
        if name is None:
            entries.append(None)
            continue
        names = tuple(m for m in rules.get(name, ()) if m not in used)
        if names and dim % _mesh_size(mesh, names) == 0:
            entries.append(names if len(names) > 1 else names[0])
            used.update(names)
        else:
            entries.append(None)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def is_axes(t) -> bool:
    """A logical-axes leaf: a tuple of names / None."""
    return isinstance(t, tuple) and not hasattr(t, "_fields") and all(
        isinstance(e, (str, type(None))) for e in t)


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of ``tree`` (dicts, lists, tuples and
    NamedTuples of leaves) and the matching leaves of ``rest``."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def param_shardings(cfg: ArchConfig, mesh, values_tree, axes_tree):
    """A ``NamedSharding`` tree matching a values tree (tensors, ``meta`` or
    not) and its logical-axes tree."""
    rules = logical_rules(cfg, mesh)
    return tree_map(lambda axes, v: NamedSharding(
        mesh, spec_for(tuple(v.shape), axes, rules, mesh)),
        axes_tree, values_tree, is_leaf=is_axes)


def zero1_shardings(cfg: ArchConfig, mesh, values_tree, base_shardings):
    """ZeRO-1: the optimizer-state tree additionally split over the data
    (and pod) axes, each on the largest dim it divides.  Parameters stay
    data-replicated for the forward; gradients reduce-scatter into these
    shards."""
    extra = [a for a in ("pod", "data") if a in mesh.axis_names]

    def upgrade(v, sh):
        shape = tuple(v.shape)
        spec = list(sh.spec) + [None] * (len(shape) - len(sh.spec))
        used = {n for e in spec for n in _names(e)}
        for ax in extra:
            if ax in used:
                continue
            for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
                names = _names(spec[i])
                cur = _mesh_size(mesh, names) if names else 1
                if shape[i] % (cur * mesh.shape[ax]) == 0:
                    spec[i] = (ax,) + names if names else ax
                    used.add(ax)
                    break
        while spec and spec[-1] is None:
            spec.pop()
        return NamedSharding(mesh, tuple(spec))

    return tree_map(upgrade, values_tree, base_shardings)


def batch_sharding(cfg: ArchConfig, mesh, spec_tree):
    """Shardings of a batch dict of (b, ...) arrays: the batch dim over the
    data axes, everything else replicated."""
    rules = logical_rules(cfg, mesh)
    return tree_map(lambda v: NamedSharding(mesh, spec_for(
        tuple(v.shape), ("batch",) + (None,) * (len(v.shape) - 1), rules, mesh)),
        spec_tree)


def cache_shardings(cfg: ArchConfig, mesh, cache_tree):
    """Shardings of serve-step caches, by leaf shape (every leaf has a
    leading stacked-layers dim):
      (L, b, hk, S, dh)  attention KV -> batch data, heads model; when the
                         KV heads do not divide the model axis, the cache
                         length S shards over model instead
      (L, b, S, r)       MLA latent / rope -> batch data, S model
      (L, b, w)          RG-LRU state -> width model
      (L, b, cw, w)      conv tails -> width model
      (L, b, h, p, N)    SSD state -> heads model
      (L,) / scalar      positions -> replicated"""
    rules = logical_rules(cfg, mesh)

    def one(v):
        shp = tuple(v.shape)
        nd = len(shp)
        if nd == 5:
            axes = (None, "batch", "kv_heads", "kv_seq", None)
            if cfg.ssd is not None:
                axes = (None, "batch", "heads", None, None)
        elif nd == 4:
            axes = ((None, "batch", "kv_seq", None) if cfg.mla is not None
                    else (None, "batch", None, "rnn"))
        elif nd == 3:
            axes = ((None, "batch", "rnn") if (cfg.rglru or cfg.ssd)
                    else (None, "batch", "kv_seq"))
        else:
            axes = (None,) * nd
        return NamedSharding(mesh, spec_for(shp, axes[:nd], rules, mesh))

    return tree_map(one, cache_tree)
