"""Mesh-sharded serving: tensor-parallel page pools and data-parallel slot
groups (port of ``repro/sharding/serving.py``).

The serving mesh is ``(dp, tp)``, as in the reference:

* **tp** splits every ``PagePool`` leaf over the KV-head axis.  Stem
  selection is per KV head, so scoring, selection and attention run
  shard-local on ``hk / tp`` heads.  The projections are computed once for
  the group; each shard takes its contiguous block of query heads (``hq /
  tp``, so a GQA group stays on one shard) and KV heads, and the only
  collective is the gather of the per-head attention outputs, in rank
  order, before ``wo``: bitwise the single-device step.
* **dp** adds slot groups.  Each group has its own slots, pages and
  ``PageAllocator``, and the host scheduler partitions its grants by group.

One process drives the whole mesh, as the reference's single controller
does: a ``ServingMesh`` is a ``(dp, tp)`` grid of ``torch.device``s, and
the engine loops over the groups and, inside each attention layer, over
the group's tp shards.  Page tables, selections and live counts stay host
state of that one scheduler.  The reference's all-gather is
``torch.cat`` of each shard's head block moved to the group's lead device
``(g, 0)`` (``gather_heads``), the exact inverse of the head slicing
(``local_heads``).  On a machine with several cards the shards sit on
distinct cards and their launches overlap, because they are asynchronous;
a device list may also repeat a device, so every shard of a mesh can share
one card.  The shards are passed in explicitly (``HeadShards``): there is
no thread-local context.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ServingMesh:
    """A ``(dp, tp)`` grid of devices, row-major: shard ``(g, t)`` is
    ``devices[g * tp + t]``."""
    dp: int
    tp: int
    devices: tuple

    @property
    def n_devices(self) -> int:
        return self.dp * self.tp

    def device(self, g: int, t: int) -> torch.device:
        return self.devices[g * self.tp + t]


class HeadShards(list):
    """One slot group's pools (a pool tree, or one layer's ``PagePool``)
    over the tp ranks, in rank order.  Each entry lives on its rank's
    device and holds that rank's contiguous block of KV heads."""


def make_serving_mesh(dp: int, tp: int, devices=None, *,
                      platform: str = "cuda") -> ServingMesh:
    """A ``(dp, tp)`` mesh over the first ``dp * tp`` of ``devices``
    (ref ``src/repro/sharding/serving.py:71-86``).

    With ``devices`` None: the first ``dp * tp`` CUDA devices, or, with
    ``platform="cpu"``, ``dp * tp`` CPU shards (the counterpart of the
    reference's forced host-device count).  An explicit list may repeat a
    device."""
    if dp < 1 or tp < 1:
        raise ValueError(f"mesh axes must be >= 1, got dp={dp}, tp={tp}")
    need = dp * tp
    if devices is None:
        if platform == "cpu":
            devices = [torch.device("cpu")] * need
        else:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if len(devices) < need:
        raise ValueError(
            f"mesh ({dp},{tp}) needs {need} devices, have {len(devices)}")
    return ServingMesh(dp=dp, tp=tp, devices=tuple(devices[:need]))


def validate_serving(cfg, executor: Optional[str], smesh: ServingMesh) -> None:
    """The model and paged executor against the mesh's sharding contract
    (ref ``:89-104``): tp divides both head counts, and at tp > 1 the
    executor declares ``"kv-head"``."""
    if smesh.tp > 1 and cfg.num_kv_heads % smesh.tp != 0:
        raise ValueError(
            f"tp={smesh.tp} must divide num_kv_heads={cfg.num_kv_heads}")
    if smesh.tp > 1 and cfg.num_heads % smesh.tp != 0:
        raise ValueError(
            f"tp={smesh.tp} must divide num_heads={cfg.num_heads}")
    if smesh.tp > 1 and executor is not None:
        from repro_torch.core import policy as policy_lib
        spec = policy_lib.get_paged_executor(executor)
        if spec.sharding != "kv-head":
            raise ValueError(
                f"executor {executor!r} declares sharding="
                f"{spec.sharding!r}; tp>1 requires 'kv-head'")


def shard_pools(pools, smesh: ServingMesh) -> list:
    """Place a pristine pool tree (``PagePool`` leaves stacked ``(n_layers,
    hk, P, ...)``) on the mesh (ref ``:118-130``): group ``g`` gets a
    ``HeadShards`` whose rank ``t`` holds KV heads ``[t * hk / tp, (t + 1)
    * hk / tp)`` of every leaf, copied into its own tensors on device
    ``(g, t)``.  Every group starts from the same pristine pool, so group 0
    of a dp > 1 engine is the single-device pool restricted to the
    shard's heads."""
    def place(leaf, t, dev):
        block = leaf.narrow(1, t * (leaf.shape[1] // smesh.tp),
                            leaf.shape[1] // smesh.tp)
        return torch.empty(block.shape, dtype=block.dtype,
                           device=dev).copy_(block)

    def shard(tree, t, dev):
        return [{name: type(pool)(*(place(leaf, t, dev) for leaf in pool))
                 for name, pool in seg.items()} for seg in tree]

    return [HeadShards(shard(pools, t, smesh.device(g, t))
                       for t in range(smesh.tp))
            for g in range(smesh.dp)]


def replicate_params(params, smesh: ServingMesh) -> dict:
    """The parameter tree on every distinct device of the mesh: ``{device:
    tree}``.  The params' own device shares their tensors (nothing is
    copied); any other device gets one copy, made here once."""
    def leaves(node):
        if isinstance(node, dict):
            return [x for v in node.values() for x in leaves(v)]
        return [node]

    def move(node, dev):
        if isinstance(node, dict):
            return {k: move(v, dev) for k, v in node.items()}
        return node.to(dev)

    home = leaves(params)[0].device
    out = {}
    for dev in smesh.devices:
        if dev not in out:
            out[dev] = params if dev == home else move(params, dev)
    return out


def local_heads(x: torch.Tensor, rank: int, tp: int, axis: int = 1) -> torch.Tensor:
    """Rank ``rank``'s contiguous block of ``x``'s head axis: heads
    ``[rank * h / tp, (rank + 1) * h / tp)`` (ref ``:160-170``).  Whole
    blocks of query heads keep each GQA group on one shard.  A
    contiguous copy."""
    h_loc = x.shape[axis] // tp
    return x.narrow(axis, rank * h_loc, h_loc).contiguous()


def gather_heads(blocks, device: torch.device, axis: int = 1) -> torch.Tensor:
    """The per-rank head blocks back into the full head axis on ``device``,
    concatenated in rank order: the exact inverse of ``local_heads`` (ref
    ``:173-181``, the all-gather)."""
    return torch.cat([b.to(device) for b in blocks], dim=axis)
