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

Tensor parallelism (inside ``sharding.context.model_parallel``, model
axis ``tp > 1``): ``materialize`` gives a parameter split over the model
axis as ``ModelShards``, each model shard's block on its own device (for
FSDP leaves first gathered over the data axis), and the model code joins
the shards' work with differentiable collectives, Megatron's f / g pair
and a regrouping built on the f, every sum in rank order in fp32:

* ``to_model_shards``: forward, one tensor (or each shard's slice of it)
  copied to every model shard's device; backward, the shards' gradients
  summed onto the source;
* ``reduce_from_model_shards``: forward, the shards' partial products
  summed on the lead shard's device; backward, the gradient copied to
  every shard;
* ``take``: each shard's column ranges of a tensor whose blocks do not
  line up with them (the SSD's packed projections; an all-gather of the
  shards' activations), the pieces other shards hold sent as
  ``to_model_shards`` sends, from the holder's device.

Every gather, reduce, broadcast and sum reports its bytes to the dry run's
counter (``kernels.cost.note_collective``) at the coordinate that moves
them; a block that already is the region needed moves nothing.  On
``meta`` devices (the dry run's production grid) every coordinate holds
tensors of its own, so each coordinate's work and memory are its own.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import cost as cost_lib
from repro_torch.sharding import context as shctx
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
        blocks = {}
        for c, t in self.blocks.items():
            if id(t) not in rows:
                rows[id(t)] = t[i]
            blocks[c] = rows[id(t)]
        return ShardedArray(NamedSharding(self.mesh, tuple(self.sharding.spec[1:])),
                            self.shape[1:], self.dtype, blocks)

    def to(self, dtype) -> "ShardedArray":
        """Every block cast to ``dtype`` (as ``Tensor.to``, so tree code
        such as ``optim.adamw.compress_grads`` takes either)."""
        return self.map_blocks(lambda t: t.to(dtype), dtype)

    def map_blocks(self, fn, dtype=None) -> "ShardedArray":
        """``fn`` of each stored tensor (shared tensors stay shared), run
        for the first coordinate holding it."""
        done, blocks = {}, {}
        for c, t in self.blocks.items():
            if id(t) not in done:
                with shctx.at(c):
                    done[id(t)] = fn(t)
            blocks[c] = done[id(t)]
        return ShardedArray(self.sharding, self.shape, dtype or self.dtype, blocks)

    def gather(self, device, dtype=None, region: Optional[tuple] = None,
               coord=None) -> torch.Tensor:
        """The ``region`` ((start, stop) a dim; default all) on ``device``
        in ``dtype``: the all-gather of the blocks it overlaps, for mesh
        coordinate ``coord`` (default ``sharding.context.coordinate()``),
        whose own copy of a block is read first."""
        device = torch.device(device)
        dtype = dtype or self.dtype
        region = tuple(region or ((0, n) for n in self.shape))
        coord = coord if coord is not None else shctx.coordinate()
        if coord is None:
            return self._gather(device, dtype, region, None)
        if cost_lib.tally() is not None and not _within(region, self.index(coord)):
            cost_lib.note_collective("all-gather", _nbytes(region, dtype), coord)
        with shctx.at(coord):
            return self._gather(device, dtype, region, coord)

    def _gather(self, device, dtype, region, coord) -> torch.Tensor:
        own = self.blocks.get(coord) if coord is not None else None
        if own is not None:
            bounds = self.index(coord)
            if _within(region, bounds):         # coord's own block holds it
                src = tuple(slice(r0 - b0, r1 - b0) for (r0, r1), (b0, _) in zip(region, bounds))
                part = own[src] if any(s != slice(0, n) for s, n in zip(src, own.shape)) else own
                return part.to(device=device, dtype=dtype)
        parts = []
        for bounds, t in self._blocks_on(device, coord):
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

    def _blocks_on(self, device, coord=None) -> list:
        """Each block once, in rank order, preferring the copy ``coord``
        holds, then a copy on ``device``."""
        own = self.blocks.get(coord) if coord is not None else None
        pick: dict = {}
        for _, bounds, t in self.distinct():
            cur = pick.get(bounds)
            if cur is None or t is own or (
                    cur is not own and t.device == device and cur.device != device):
                pick[bounds] = t
        return list(pick.items())


def _within(region, bounds) -> bool:
    return all(b0 <= r0 and r1 <= b1 for (r0, r1), (b0, b1) in zip(region, bounds))


def _nbytes(region, dtype) -> int:
    return math.prod(r1 - r0 for r0, r1 in region) * torch.empty((), dtype=dtype).element_size()


def _key(coord, device, bounds) -> tuple:
    """Which coordinates share one tensor: those holding the same block on
    the same device, but on ``meta`` devices none (the dry run's)."""
    return (coord if device.type == "meta" else device, bounds)


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
        key = _key(coord, dev, _norm(idx, t.shape))
        if key not in made:
            with shctx.at(coord):
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
        key = _key(coord, dev, _norm(idx, arr.shape))
        if key not in made:
            made[key] = arr.gather(dev, dtype, key[1], coord=coord)
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
        cost_lib.note_collective("reduce-scatter", _nbytes(bounds, torch.float32), coord)
        with shctx.at(coord):
            if bounds in sums:
                blocks[id(t)] = sums[bounds].to(t.device)
                continue
            total = None
            for g in contributions:
                part = g._gather(t.device, torch.float32, bounds, coord)
                total = part if total is None else total + part
            sums[bounds] = blocks[id(t)] = total
    return ShardedArray(target.sharding, target.shape, torch.float32,
                        {c: blocks[id(t)] for c, t in target.blocks.items()})


def materialize(tree, device, whole: bool = False):
    """``tree`` with every ShardedArray gathered onto ``device`` (tensors
    pass through), but a MoE FFN's expert tables (a dict with a
    ``router``): ``models/moe.py`` gathers them itself, each model shard
    its own under expert parallelism.  Inside
    ``sharding.context.model_parallel`` (and unless ``whole``) a leaf split
    over the model axis becomes its ``ModelShards`` instead; a MoE router
    is always gathered whole."""
    if isinstance(tree, dict):
        moe = "router" in tree
        return {k: (v if moe and k in ("w_gate", "w_up", "w_down")
                    else materialize(v, device, whole or (moe and k == "router")))
                for k, v in tree.items()}
    if isinstance(tree, ShardedArray):
        mp = shctx.model_parallel_state()
        if mp is not None and not whole:
            return model_view(tree, mp)
        return tree.gather(device)
    return tree


# ---------------------------------------------------------------------------
# Tensor parallelism
# ---------------------------------------------------------------------------

class ModelShards:
    """A parameter's model-axis blocks as one data shard's model shards
    read them: ``parts[t]`` is the block of shard ``t`` (the whole of every
    other dim), on that shard's device; ``dim`` is the split dim and
    ``bounds[t]`` the block's (start, stop) along it.

    A serve-step cache leaf is held the same way (its blocks updated in
    place), and may be whole on every shard: ``dim`` and ``bounds`` None."""

    def __init__(self, parts: list, dim: Optional[int], bounds: Optional[list], shape):
        self.parts, self.dim, self.bounds = parts, dim, bounds
        self.shape = torch.Size(shape)

    def __repr__(self) -> str:
        return f"ModelShards(shape={tuple(self.shape)}, dim={self.dim}, tp={len(self.parts)})"

    def __getitem__(self, i: int) -> "ModelShards":
        """Layer ``i`` of a stacked leaf (its leading dim unsplit): views."""
        return ModelShards([p[i] for p in self.parts],
                           None if self.dim is None else self.dim - 1, self.bounds,
                           self.shape[1:])

    def seq_bounds(self, dim: int) -> list:
        """Each shard's (start, stop) along ``dim``: its block's, or the
        whole dim where the leaf is not split along it."""
        if self.dim == dim:
            return list(self.bounds)
        return [(0, self.shape[dim])] * len(self.parts)


def stack_shards(items: list) -> ModelShards:
    """Per-layer ``ModelShards`` of one layout stacked along a new leading
    dim, each shard's blocks on its own device."""
    first = items[0]
    return ModelShards([torch.stack([it.parts[t] for it in items])
                        for t in range(len(first.parts))],
                       None if first.dim is None else first.dim + 1, first.bounds,
                       (len(items),) + tuple(first.shape))


def even_bounds(n: int, tp: int) -> list:
    return [(t * n // tp, (t + 1) * n // tp) for t in range(tp)]


def cache_blocks(x: torch.Tensor, mp, dims: tuple = ()) -> ModelShards:
    """A cache leaf computed whole on the lead model shard as the model
    shards of ``mp`` hold it (``rules.cache_shardings``): split evenly
    along the first of ``dims`` the model axis divides, each shard's block
    a tensor of its own on its device, else whole on every shard."""
    for dim in dims:
        if x.shape[dim] % mp.tp == 0:
            bounds = even_bounds(x.shape[dim], mp.tp)
            parts = to_model_shards(x, mp, dim, bounds)
            own = []
            for t, p in enumerate(parts):
                with mp.on(t):
                    own.append(p.clone(memory_format=torch.contiguous_format))
            return ModelShards(own, dim, bounds, x.shape)
    return ModelShards(to_model_shards(x, mp), None, None, x.shape)


def model_dim(sharding: NamedSharding) -> Optional[int]:
    """The dim a sharding splits over the model axis alone, or None."""
    for i, e in enumerate(sharding.spec):
        if e == "model" or e == ("model",):
            return i
    return None


def model_view(arr: ShardedArray, mp):
    """``arr`` as the model shards of ``mp`` (a
    ``sharding.context.ModelParallel``) read it: ``ModelShards`` when its
    spec splits a dim over the model axis alone, else the whole array on
    the lead shard's device.  Each block is gathered over the other axes
    (FSDP's data axis) onto its shard's device; differentiable."""
    dim = model_dim(arr.sharding)
    if dim is None:
        return arr.gather(mp.devices[0], coord=mp.coords[0])
    parts, bounds = [], []
    for c, dev in zip(mp.coords, mp.devices):
        own = arr.index(c)
        region = tuple(own[i] if i == dim else (0, n) for i, n in enumerate(arr.shape))
        parts.append(arr.gather(dev, region=region, coord=c))
        bounds.append(own[dim])
    return ModelShards(parts, dim, bounds, arr.shape)


def lead_whole(ms: ModelShards, mp) -> torch.Tensor:
    """A cache leaf's ``ModelShards`` whole on the lead model shard (its
    blocks gathered there in rank order; the lead's own where it is whole
    on every shard)."""
    if ms.dim is None:
        return ms.parts[0]
    return take(ms, mp, [[(0, ms.shape[ms.dim])]] + [[]] * (mp.tp - 1))[0]


def write_back(ms: ModelShards, whole: torch.Tensor, mp) -> None:
    """``whole`` (on the lead model shard) copied into a cache leaf's
    blocks, in place: each shard its block of it, or all of it where the
    leaf is whole on every shard."""
    parts = to_model_shards(whole, mp, ms.dim, ms.bounds)
    for t, (dst, src) in enumerate(zip(ms.parts, parts)):
        if dst.data_ptr() != src.data_ptr():
            with mp.on(t):
                dst.copy_(src)


def _acc(dtype) -> torch.dtype:
    """The dtype the collectives sum in: fp32, or the parts' if wider."""
    return torch.promote_types(dtype, torch.float32)


def _part_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _ranges(b) -> list:
    """A shard's ``bounds`` entry as a list of (start, stop) ranges: one
    pair, or a list of them."""
    return [b] if isinstance(b, tuple) and b and isinstance(b[0], int) else list(b)


def _cut(x, dim: int, ranges: list):
    """The ``ranges`` of ``x`` along ``dim``, concatenated in order."""
    parts = [x.narrow(dim, a, b - a) for a, b in ranges]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def _merged(ranges: list) -> list:
    """Sorted (start, stop) ranges with adjacent ones joined."""
    out: list = []
    for a, b in ranges:
        if out and out[-1][1] == a:
            out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class _ToShards(torch.autograd.Function):
    """``to_model_shards``: the f of Megatron's f / g pair, from model shard
    ``src``'s device (the lead's, unless ``take`` sends another shard's
    block)."""

    @staticmethod
    def forward(ctx, x, mp, dim, bounds, src=0):
        ctx.mp, ctx.dim, ctx.bounds, ctx.src = mp, dim, bounds, src
        ctx.shape, ctx.dtype, ctx.device = x.shape, x.dtype, x.device
        outs = []
        for t, (c, dev) in enumerate(zip(mp.coords, mp.devices)):
            with shctx.at(c):
                part = x if bounds is None else _cut(x, dim, _ranges(bounds[t]) or [(0, 0)])
                out = part.to(dev)
                # a shard on the source's device reads an alias, so each
                # shard's tensors are its own (the dry run's counter
                # attributes the backward's ops by them)
                outs.append(out.view_as(out))
                if out.numel():
                    cost_lib.note_collective("broadcast", _part_bytes(out), c)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        mp, dim, bounds = ctx.mp, ctx.dim, ctx.bounds
        total = None
        with shctx.at(mp.coords[ctx.src]):
            for t, g in enumerate(grads):
                if g is None or not g.numel():
                    continue
                cost_lib.note_collective("reduce", _part_bytes(g), mp.coords[t])
                g = g.to(device=ctx.device, dtype=_acc(ctx.dtype))
                if bounds is None:
                    total = g if total is None else total + g
                    continue
                if total is None:
                    total = torch.zeros(ctx.shape, dtype=_acc(ctx.dtype), device=ctx.device)
                off = 0
                for a, b in _ranges(bounds[t]):
                    total.narrow(dim, a, b - a).add_(g.narrow(dim, off, b - a))
                    off += b - a
            if total is not None:
                total = total.to(ctx.dtype)
        return total, None, None, None, None


def to_model_shards(x: torch.Tensor, mp, dim: Optional[int] = None,
                    bounds: Optional[list] = None) -> list:
    """``x`` (on the lead shard's device) copied to every model shard of
    ``mp`` (a ``sharding.context.ModelParallel``), or with ``bounds`` each
    shard's slice [start, stop) along ``dim`` (or its list of such ranges,
    concatenated in order).  Backward: the shards' gradients summed onto
    ``x``'s device in rank order in fp32 (in fp64 for fp64; slices that
    overlap add)."""
    return list(_ToShards.apply(x, mp, dim, bounds))


def take(src, mp, ranges: list, dim: Optional[int] = None) -> list:
    """Each model shard ``t`` of ``mp`` gets ``ranges[t]`` (sorted, disjoint
    (start, stop) pairs along the split dim), concatenated in order on its
    own device, of ``src``: ``ModelShards`` (parameter blocks, or the
    shards' activations) whose blocks need not line up with the ranges, or
    a whole tensor on the lead shard's device (split along ``dim``).  A
    shard with no ranges gets None.

    A shard's pieces of its own block are slices of it; the pieces other
    shards hold come through ``to_model_shards``' mechanism from the
    holder's device, so the backward sends each piece's gradient to the
    block it was cut from (summed there in rank order in fp32)."""
    if isinstance(src, ModelShards):
        parts, bounds, dim = src.parts, src.bounds, src.dim
    else:
        parts, bounds = [src], [(0, src.shape[dim])]
    ranges = [_merged(r) for r in ranges]
    pieces = [[] for _ in range(mp.tp)]
    for s, (part, (b0, b1)) in enumerate(zip(parts, bounds)):
        want = [[(max(a, b0) - b0, min(b, b1) - b0) for a, b in ranges[t]
                 if max(a, b0) < min(b, b1)] for t in range(mp.tp)]
        local = want[s]
        want[s] = []
        sent = _ToShards.apply(part, mp, dim, want, s) if any(want) else None
        for t in range(mp.tp):
            if t == s and local:
                with mp.on(t):
                    pieces[t].append(part if local == [(0, part.shape[dim])]
                                     else _cut(part, dim, local))
            elif want[t]:
                pieces[t].append(sent[t])
    out = []
    for t, p in enumerate(pieces):
        with mp.on(t):
            out.append(None if not p else p[0] if len(p) == 1 else torch.cat(p, dim=dim))
    return out


class _SumShards(torch.autograd.Function):
    """``reduce_from_model_shards``: the g of Megatron's f / g pair."""

    @staticmethod
    def forward(ctx, mp, dtype, *parts):
        ctx.mp = mp
        ctx.meta = [(p.device, p.dtype) for p in parts]
        lead = mp.devices[0]
        total = None
        with shctx.at(mp.coords[0]):
            for t, p in enumerate(parts):
                cost_lib.note_collective("reduce", _part_bytes(p), mp.coords[t])
                p = p.to(device=lead, dtype=_acc(p.dtype))
                total = p if total is None else total + p
            return total.to(dtype)

    @staticmethod
    def backward(ctx, grad):
        mp = ctx.mp
        out = []
        for t, (dev, dtype) in enumerate(ctx.meta):
            with shctx.at(mp.coords[t]):
                g = grad.to(device=dev, dtype=dtype)
                out.append(g.view_as(g))
                cost_lib.note_collective("broadcast", _part_bytes(g), mp.coords[t])
        return (None, None, *out)


def reduce_from_model_shards(parts: list, mp, dtype=None) -> torch.Tensor:
    """The sum of the model shards' ``parts`` (one a shard of ``mp``, equal
    shapes), in rank order in fp32 (fp64 for fp64) on the lead shard's
    device, cast to
    ``dtype`` (default the parts').  Backward: the gradient copied to every
    shard."""
    return _SumShards.apply(mp, dtype or parts[0].dtype, *parts)
