"""Arrays stored in blocks over a training mesh: the port's counterpart of
a ``jax.Array`` with a ``NamedSharding``.

A ``ShardedArray`` holds, for every mesh coordinate, the block its
sharding gives that coordinate, on the coordinate's device.  Coordinates
that hold the same block on the same device share one tensor (a device
list may repeat a device, so on one card a replicated array is stored
once).  The reference's collectives become copies in a fixed order:

* ``place`` is ``jax.device_put``: each coordinate's block of a tensor;
* ``gather`` is an all-gather: the blocks covering a region, each taken
  once in rank order and copied into one tensor on the consumer's device
  (a block that already is the region, on that device, is returned as is);
* ``reduce_into`` is the sum a reduce-scatter makes: every contribution's
  part of a block, added in rank order in fp32 on the block's device.

Gathers are differentiable, so a forward that gathers the blocks of its
parameters gives each block its gradient.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.sharding.rules import NamedSharding


def _norm(idx, shape) -> tuple:
    """Slices as (start, stop) pairs over ``shape``."""
    return tuple(s.indices(n)[:2] for s, n in zip(idx, shape))


class ShardedArray:
    """A logical ``shape`` / ``dtype`` array as blocks over
    ``sharding.mesh``: ``blocks`` maps every coordinate to its tensor."""

    def __init__(self, sharding: NamedSharding, shape, dtype, blocks: dict):
        self.sharding = sharding
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.blocks = blocks        # never changed after construction
        self._distinct = None

    def __repr__(self) -> str:
        return (f"ShardedArray(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"spec={self.sharding.spec})")

    @property
    def mesh(self):
        return self.sharding.mesh

    def index(self, coord) -> tuple:
        """The (start, stop) bounds of ``coord``'s block, one pair a dim."""
        return _norm(self.sharding.indices(self.shape)[coord], self.shape)

    def distinct(self) -> list:
        """[(coordinate, bounds, tensor)]: each stored tensor once, in rank
        order of the first coordinate holding it."""
        if self._distinct is None:
            seen, out = set(), []
            for coord, idx in self.sharding.indices(self.shape).items():
                t = self.blocks[coord]
                if id(t) not in seen:
                    seen.add(id(t))
                    out.append((coord, _norm(idx, self.shape), t))
            self._distinct = out
        return self._distinct

    def unique_blocks(self) -> list:
        """[(bounds, tensor)]: each block of the array once (replicas on
        other devices left out), in rank order."""
        seen, out = set(), []
        for _, bounds, t in self.distinct():
            if bounds not in seen:
                seen.add(bounds)
                out.append((bounds, t))
        return out

    def __getitem__(self, i: int) -> "ShardedArray":
        """Layer ``i`` of a stacked array (its leading dim unsplit): each
        block's row ``i``, still in blocks."""
        if not isinstance(i, int):
            raise TypeError("a ShardedArray is indexed by one layer at a time")
        if self.sharding.spec and self.sharding.spec[0] is not None:
            raise ValueError(f"the layer dim of {self!r} is split")
        rows = {}
        blocks = {c: rows.setdefault(id(t), t[i]) for c, t in self.blocks.items()}
        return ShardedArray(NamedSharding(self.mesh, tuple(self.sharding.spec[1:])),
                            self.shape[1:], self.dtype, blocks)

    def to(self, dtype) -> "ShardedArray":
        """Every block cast to ``dtype`` (as ``Tensor.to``, so tree code
        such as ``optim.adamw.compress_grads`` takes either)."""
        return self.map_blocks(lambda t: t.to(dtype), dtype)

    def map_blocks(self, fn, dtype=None) -> "ShardedArray":
        """``fn`` of each stored tensor (shared tensors stay shared)."""
        done = {}
        blocks = {c: done[id(t)] if id(t) in done else done.setdefault(id(t), fn(t))
                  for c, t in self.blocks.items()}
        return ShardedArray(self.sharding, self.shape, dtype or self.dtype, blocks)

    def gather(self, device, dtype=None, region: Optional[tuple] = None) -> torch.Tensor:
        """The ``region`` ((start, stop) a dim; default all) on ``device``
        in ``dtype``: the all-gather of the blocks it overlaps."""
        device = torch.device(device)
        dtype = dtype or self.dtype
        region = region or tuple((0, n) for n in self.shape)
        parts = []
        for bounds, t in self._blocks_on(device):
            lo = [max(a, r0) for (a, _), (r0, _) in zip(bounds, region)]
            hi = [min(b, r1) for (_, b), (_, r1) in zip(bounds, region)]
            if all(l < h for l, h in zip(lo, hi)):
                parts.append((bounds, t, lo, hi))
        if len(parts) == 1:
            bounds, t, lo, hi = parts[0]
            if list(zip(lo, hi)) == list(region):
                src = tuple(slice(l - a, h - a) for l, h, (a, _) in zip(lo, hi, bounds))
                part = t[src] if any(s != slice(0, n) for s, n in zip(src, t.shape)) else t
                return part.to(device=device, dtype=dtype)
        out = torch.empty(tuple(r1 - r0 for r0, r1 in region), dtype=dtype, device=device)
        for bounds, t, lo, hi in parts:
            src = tuple(slice(l - a, h - a) for l, h, (a, _) in zip(lo, hi, bounds))
            dst = tuple(slice(l - r0, h - r0) for l, h, (r0, _) in zip(lo, hi, region))
            out[dst] = t[src].to(device=device, dtype=dtype)
        return out

    def _blocks_on(self, device) -> list:
        """Each block once, in rank order, preferring the copy on
        ``device``."""
        pick: dict = {}
        for _, bounds, t in self.distinct():
            if bounds not in pick or (t.device == device and pick[bounds].device != device):
                pick[bounds] = t
        return list(pick.items())


def place(t: torch.Tensor, sharding: NamedSharding, dtype=None, *,
          copy: bool = True) -> ShardedArray:
    """``t`` split into ``sharding``'s blocks, each on its coordinate's
    device in ``dtype`` (default ``t``'s), each contiguous (the optimizer
    updates blocks in place).  With ``copy`` every block is a tensor of its
    own; without, a contiguous block on ``t``'s device in ``t``'s dtype is
    a view of it (so placing a state the caller drops costs no copy)."""
    dtype = dtype or t.dtype
    made, blocks = {}, {}
    for coord, idx in sharding.indices(t.shape).items():
        dev = sharding.mesh.device(coord)
        key = (dev, _norm(idx, t.shape))
        if key not in made:
            made[key] = t[idx].to(device=dev, dtype=dtype, copy=copy).contiguous()
        blocks[coord] = made[key]
    return ShardedArray(sharding, t.shape, dtype, blocks)


def relayout(arr: ShardedArray, sharding: NamedSharding, dtype=None) -> ShardedArray:
    """``arr`` in ``sharding``'s blocks: each block gathered from the blocks
    of ``arr`` it overlaps (no copy where a block already is one of them,
    on its device, in ``dtype``)."""
    dtype = dtype or arr.dtype
    made, blocks = {}, {}
    for coord, idx in sharding.indices(arr.shape).items():
        dev = sharding.mesh.device(coord)
        key = (dev, _norm(idx, arr.shape))
        if key not in made:
            made[key] = arr.gather(dev, dtype, key[1])
        blocks[coord] = made[key]
    return ShardedArray(sharding, arr.shape, dtype, blocks)


def reduce_into(target: ShardedArray, contributions: list) -> ShardedArray:
    """``target``'s blocks filled with the sum, in rank order and fp32 on
    each block's device, of every contribution's part of the block (a
    contribution: one data shard's gradient, a ShardedArray in any
    layout).  Replicas of a block on other devices get a copy of it."""
    sums: dict = {}
    blocks = {}
    for coord, bounds, t in target.distinct():
        if bounds in sums:
            blocks[id(t)] = sums[bounds].to(t.device)
            continue
        total = None
        for g in contributions:
            part = g.gather(t.device, torch.float32, bounds)
            total = part if total is None else total + part
        sums[bounds] = blocks[id(t)] = total
    return ShardedArray(target.sharding, target.shape, torch.float32,
                        {c: blocks[id(t)] for c, t in target.blocks.items()})


def materialize(tree, device):
    """``tree`` with every ShardedArray gathered onto ``device`` (tensors
    pass through), but a MoE FFN's expert tables (a dict with a
    ``router``): ``models/moe.py`` gathers them itself, each model shard
    its own under expert parallelism."""
    if isinstance(tree, dict):
        moe = "router" in tree
        return {k: (v if moe and k in ("w_gate", "w_up", "w_down")
                    else materialize(v, device))
                for k, v in tree.items()}
    if isinstance(tree, ShardedArray):
        return tree.gather(device)
    return tree
