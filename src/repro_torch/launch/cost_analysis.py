"""Per-device cost of the port's steps on a mesh (the counterpart of
``repro/launch/hlo_analysis.py``).

The reference lowers its partitioned step to HLO and walks the text; the
port runs eagerly, so ``CostMode`` (a ``TorchDispatchMode``) counts every
operator as it runs, usually over ``meta`` tensors (the dry run: shapes
only, nothing allocated), and charges it to the mesh coordinate it runs
for.  That coordinate is the innermost ``sharding.context.at`` (the mesh
step and the tensor-parallel model code set it for each model shard's
work, each gather and reduce); in autograd's backward, the coordinate of
the forward operator whose gradient runs (each autograd node is tagged
with it when its output is first read); else that of the operator's first
input that has one (every tensor is tagged with the coordinate of the
operator that made it: the optimizer's blocks); failing all, the
model-parallel lead, else ``default``.

A coordinate's ``Cost`` has the reference's fields:

* ``flops``: 2 M N K a matrix product (``flops_by_op["dot"]``), one a
  result element of every other operator that computes
  (``["elementwise"]``, reductions included, as the reference counts
  them), and a kernel's by the formulas its bound uses
  (``kernels/cost.py``; ``["kernel"]``, with its calls and the query heads
  each was given in ``kernel_calls`` / ``kernel_heads``, and a
  block-sparse call's causal pairs by the rule that counted them in
  ``kernel_pairs``);
* ``bytes``: operands + results of every operator (the no-fusion bound);
  ``bytes_min``: only matrix products, index gathers / scatters, sorts,
  reductions, kernels and collectives (the fusion-ideal count);
* ``coll_counts`` / ``coll_by_op`` / ``coll_bytes``: every collective the
  port's arrays report (``kernels.cost.note_collective``: a
  ``ShardedArray`` all-gather, a reduce-scatter of ``reduce_into``, the
  tensor-parallel broadcast and reduce), each at the bytes that
  coordinate moves times ``COLLECTIVE_MULT``.  The port's tensor-parallel
  sum is a reduce onto the lead shard followed, where the next layer reads
  it, by a broadcast: together the ring all-reduce's 2x;
* ``live`` / ``peak``: bytes of the tensors operators made on it that are
  still alive, and their peak.  A tensor is freed when Python collects its
  last reference (a ``weakref.finalize`` on it; a view holds its base, and
  a tensor saved for the backward lives until the backward frees it).
  Views and in-place results allocate nothing; arguments made before the
  mode was entered are not counted.

Remat's recompute is counted as it runs (the reference's HLO carries it).
"""
from __future__ import annotations

import collections
import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakTensorKeyDictionary

from repro_torch.sharding import context as shctx

COLLECTIVE_MULT = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                   "all-to-all": 1.0, "collective-permute": 1.0,
                   "broadcast": 1.0, "reduce": 1.0}

_NODE_KEY = "mesh_coordinate"      # an autograd node's tag
aten = torch.ops.aten
_MATMULS = {aten.mm.default, aten.bmm.default, aten.addmm.default,
            aten.baddbmm.default}
_INDEXING = {"index", "index_put", "index_put_", "gather", "scatter", "scatter_add",
             "scatter_add_", "index_select", "index_add", "index_add_", "index_copy",
             "index_copy_", "embedding", "embedding_dense_backward", "sort", "topk",
             "argsort", "cummax", "cumsum", "_unsafe_index", "_unsafe_index_put",
             "index_reduce"}
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "logsumexp", "_softmax",
               "_log_softmax", "var", "var_mean", "std", "prod", "all", "any",
               "linalg_vector_norm", "norm", "_softmax_backward_data",
               "_log_softmax_backward_data", "argmax", "argmin"}
_FACTORIES = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
              "zeros", "zeros_like", "ones", "ones_like", "full", "full_like",
              "new_zeros", "new_ones", "new_full", "scalar_tensor", "arange"}
_COPIES = {"clone", "copy_", "copy", "detach", "lift_fresh", "lift_fresh_copy",
           "_to_copy", "alias", "_local_scalar_dense", "contiguous"}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    bytes_min: float = 0.0
    coll_bytes: float = 0.0
    coll_by_op: dict = dataclasses.field(default_factory=dict)
    coll_counts: dict = dataclasses.field(default_factory=dict)
    flops_by_op: dict = dataclasses.field(default_factory=dict)
    bytes_by_opcode: dict = dataclasses.field(default_factory=dict)
    kernel_calls: dict = dataclasses.field(default_factory=dict)
    kernel_heads: dict = dataclasses.field(default_factory=dict)
    kernel_pairs: dict = dataclasses.field(default_factory=dict)
    live: int = 0
    peak: int = 0

    def _add(self, field: str, key: str, v: float) -> None:
        d = getattr(self, field)
        d[key] = d.get(key, 0) + v


def _tensors(tree) -> list:
    out = []
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            out.extend(_tensors(t))
    elif isinstance(tree, dict):
        for t in tree.values():
            out.extend(_tensors(t))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _matmul_flops(func, args) -> float:
    if func in (aten.mm.default, aten.bmm.default):
        a, b = args[0], args[1]
    else:                                   # addmm / baddbmm: (bias, a, b)
        a, b = args[1], args[2]
    return 2.0 * a.numel() * b.shape[-1]


class CostMode(TorchDispatchMode):
    """Counts every operator (and the kernels and collectives
    ``kernels.cost`` reports: enter ``kernels.cost.counting(mode)`` too)
    per mesh coordinate: ``costs[coord]`` is a ``Cost``."""

    def __init__(self, default=None):
        super().__init__()
        self.default = default
        self.costs: dict = collections.defaultdict(Cost)
        self._tag = WeakTensorKeyDictionary()

    # -- attribution ---------------------------------------------------------

    def coord_of(self, tensors) -> tuple:
        c = shctx.explicit_coordinate()
        if c is not None:
            return c
        node = torch._C._current_autograd_node()
        if node is not None:
            c = node.metadata.get(_NODE_KEY)
            if c is not None:
                return c
        for t in tensors:
            c = self._tag.get(t)
            if c is not None:
                return c
        c = shctx.coordinate()
        return c if c is not None else self.default

    def _alloc(self, t: torch.Tensor, c) -> None:
        n = _nbytes(t)
        cost = self.costs[c]
        cost.live += n
        cost.peak = max(cost.peak, cost.live)
        weakref.finalize(t, self._free, c, n)

    def _free(self, c, n: int) -> None:
        self.costs[c].live -= n

    # -- reports of kernels.cost ---------------------------------------------

    def kernel(self, name: str, flops: float, nbytes: float, heads, like) -> None:
        cost = self.costs[self.coord_of([like])]
        cost.flops += flops
        cost._add("flops_by_op", "kernel", flops)
        cost.bytes += nbytes
        cost.bytes_min += nbytes
        cost._add("bytes_by_opcode", "kernel", nbytes)
        cost._add("kernel_calls", name, 1)
        cost.kernel_heads.setdefault(name, []).append(heads)

    def kernel_pairs(self, rule: str, pairs: float, like) -> None:
        """A block-sparse call's causal pairs, by the rule that counted
        them ("budgets": exact; "bound": every slot live)."""
        self.costs[self.coord_of([like])]._add("kernel_pairs", rule, pairs)

    def collective(self, kind: str, nbytes: float, coord) -> None:
        cost = self.costs[coord if coord is not None else self.coord_of([])]
        moved = nbytes * COLLECTIVE_MULT[kind]
        cost.coll_bytes += moved
        cost._add("coll_by_op", kind, moved)
        cost._add("coll_counts", kind, 1)
        cost.bytes += nbytes
        cost.bytes_min += nbytes
        cost._add("bytes_by_opcode", kind, nbytes)

    # -- operators -----------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors(args) + _tensors(kwargs)
        outs = _tensors(out)
        c = self.coord_of(ins)
        for t in ins:
            fn = t.grad_fn
            if fn is not None and _NODE_KEY not in fn.metadata:
                fn.metadata[_NODE_KEY] = self._tag.get(t)
        for t in outs:
            if t not in self._tag:
                self._tag[t] = c
        if func.is_view:
            return out
        name = func.overloadpacket.__name__
        aliased = [r.alias_info is not None for r in func._schema.returns]
        for t, a in zip(outs, aliased):
            if not a:
                self._alloc(t, c)
        if name in _FACTORIES:
            return out
        cost = self.costs[c]
        nbytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        cost.bytes += nbytes
        if func in _MATMULS:
            f = _matmul_flops(func, args)
            cost.flops += f
            cost._add("flops_by_op", "dot", f)
            cost.bytes_min += nbytes
            cost._add("bytes_by_opcode", "dot", nbytes)
            return out
        if name in _COPIES and not (name == "_to_copy" and "dtype" in kwargs
                                    and kwargs["dtype"] != args[0].dtype):
            return out
        elems = sum(t.numel() for t in outs)
        cost.flops += elems
        cost._add("flops_by_op", "elementwise", elems)
        kind = "gather" if name in _INDEXING else "reduce" if name in _REDUCTIONS else None
        if kind is not None:
            cost.bytes_min += nbytes
            cost._add("bytes_by_opcode", kind, nbytes)
        return out
