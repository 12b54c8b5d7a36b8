"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``): the local
path, where one device holds every expert, and the expert-parallel branch.

Routing: fp32 router logits, softmax gates, top-k with the lower expert
first on ties (``jax.lax.top_k``'s order), weights renormalized.  Capacity
is per batch row, ``max(1, int(capacity_factor * s * K / E))`` for a row of
``s`` tokens; a (token, k) slot's position in its expert is its rank among
the row's slots of that expert in slot-major order, from a stable sort of
the expert ids (no ``(s * K, E)`` one-hot), and slots past the capacity
drop.  The experts run over a static ``(b, E, capacity, d)`` buffer as
three batched products, so every shape is fixed by ``(b, s)`` and nothing
reads a count back to the host.

Expert parallelism (ref ``src/repro/models/moe.py:127-166``): inside
``sharding.context.use(cfg, mesh)`` with a model axis of ``n > 1`` that
divides ``E``, every (data, model) coordinate takes its data shard's batch
rows and runs ``E / n`` experts (``e_offset = shard * E / n``) on its own
device with the expert weights it holds: the blocks of a ``ShardedArray``
expert table (for ``fsdp_weights`` archs first gathered over the data axis,
the reference's all-gather), or its slice of a plain table.  Tokens routed
to another shard's experts add nothing there, and the shards' outputs are
summed in rank order on the data shard's model-0 device: the reference's
``psum``.  Routing and capacity are the local path's.

In the mesh train step's tensor-parallel compute (inside
``sharding.context.model_parallel``, whose model axis divides ``E``) the
same split runs for one data shard: its model shards' experts each on its
own device, x and the routing copied to them (``to_model_shards``), the
outputs summed (``reduce_from_model_shards``).  The router is gathered
whole and runs once on the lead shard; the dense parts (the shared expert,
the residual MLP) run tensor-parallel in ``models/mlp.py``.

Covers plain top-k routed experts, a shared expert (deepseek) and the
parallel dense residual FFN (arctic), and the Switch load-balance aux
loss.  Inside ``sharding.context.data_parallel`` with a ``GlobalAux`` the
aux loss is that of the global batch (``GlobalAux``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.core.selection import stable_topk
from repro_torch.models import mlp
from repro_torch.models.common import Initializer
from repro_torch.sharding import arrays
from repro_torch.sharding import context as shctx
from repro_torch.sharding import rules as rules_lib


def init(ini: Initializer, d_model: int, moe: MoEConfig, activation: str) -> dict:
    e, f = moe.num_experts, moe.expert_d_ff
    p = {
        "router": ini.normal((d_model, e), ("embed", "experts"),
                             dtype=torch.float32),
        "w_gate": ini.normal((e, d_model, f), ("experts", "embed", "expert_mlp")),
        "w_up": ini.normal((e, d_model, f), ("experts", "embed", "expert_mlp")),
        "w_down": ini.normal((e, f, d_model), ("experts", "expert_mlp", "embed")),
    }
    if moe.shared_experts:
        p["shared"] = mlp.init(ini, d_model, moe.shared_d_ff * moe.shared_experts,
                               activation)
    if moe.residual_dense:
        p["residual"] = mlp.init(ini, d_model, moe.residual_d_ff, activation)
    return p


def capacity(moe: MoEConfig, s: int) -> int:
    """Slots per expert in one batch row of ``s`` tokens."""
    return max(1, int(moe.capacity_factor * s * moe.top_k / moe.num_experts))


def route(params, x: torch.Tensor, moe: MoEConfig):
    """Top-k routing and per-row positions.  x: (b, s, d).

    Returns (gates (b, s, E) fp32, weights (b, s, K) fp32, experts (b, s, K)
    int64, pos (b, s, K) int32, keep (b, s, K) bool, capacity)."""
    b, s, _ = x.shape
    K = moe.top_k
    cap = capacity(moe, s)
    logits = torch.einsum("bsd,de->bse", x.float(), params["router"].float())
    gates = torch.softmax(logits, dim=-1)
    weights, experts = stable_topk(gates, K)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)

    flat_e = experts.reshape(b, s * K)                          # slot-major
    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = torch.take_along_dim(flat_e, order, dim=1)
    idx = torch.arange(s * K, device=x.device).expand(b, -1)
    is_start = torch.ones_like(sorted_e, dtype=torch.bool)
    is_start[:, 1:] = sorted_e[:, 1:] != sorted_e[:, :-1]
    start_idx = torch.cummax(torch.where(is_start, idx, 0), dim=1).values
    pos_sorted = idx - start_idx                                # rank in group
    pos = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)
    pos = pos.reshape(b, s, K).to(torch.int32)
    return gates, weights, experts, pos, pos < cap, cap


def _activation(name: str):
    return F.silu if name == "silu" else (
        lambda t: F.gelu(t, approximate="tanh"))


def expert_ffn(x, experts, pos, keep, weights, wg, wu, wd, *, capacity: int,
               activation: str, e_offset=None) -> torch.Tensor:
    """Dispatch into the ``(b, E, capacity, d)`` buffer, the expert FFN over
    every expert, and the weighted combine in ``x.dtype``, k by k.

    A kept slot's (row, expert, position) is unique in the buffer; a
    dropped slot writes to one trash row past its end, which the products
    never read.  With ``e_offset`` the tables hold the experts ``[e_offset,
    e_offset + E)`` only (one expert-parallel shard): a slot routed to any
    other expert is dropped here."""
    b, s, d = x.shape
    E = wg.shape[0]
    K = experts.shape[-1]
    if e_offset is not None:
        keep = keep & (experts >= e_offset) & (experts < e_offset + E)
        experts = experts - e_offset
    rows = torch.arange(b, device=x.device)[:, None] * (E * capacity)
    trash = b * E * capacity
    flat = [torch.where(keep[..., k], rows + experts[..., k] * capacity
                        + pos[..., k], trash).reshape(-1) for k in range(K)]
    buf = torch.zeros((trash + 1, d), dtype=x.dtype, device=x.device)
    xs = x.reshape(b * s, d)
    for k in range(K):
        buf.index_copy_(0, flat[k], xs)
    buf = buf[:trash].reshape(b, E, capacity, d)

    act = _activation(activation)
    g = act(torch.einsum("becd,edf->becf", buf, wg))
    u = torch.einsum("becd,edf->becf", buf, wu)
    out = torch.einsum("becf,efd->becd", g * u, wd).reshape(trash, d)

    y = torch.zeros_like(x)
    for k in range(K):
        got = out.index_select(0, torch.clamp(flat[k], max=trash - 1))
        w_k = (weights[..., k] * keep[..., k]).to(x.dtype)
        y = y + got.reshape(b, s, d) * w_k[..., None]
    return y


def _expert_parallel(params, x, experts, pos, keep, weights, cap: int,
                     activation: str, mesh) -> torch.Tensor:
    """The expert-parallel branch: every (data, model) coordinate's experts
    on its own device, each data shard's model shards' outputs summed in
    rank order (``_expert_model_shards``)."""
    coords = rules_lib.data_coords(mesh)
    b = x.shape[0]
    if b % len(coords):
        raise ValueError(f"expert parallelism splits {b} rows over {len(coords)} "
                         "data shards")
    rows = b // len(coords)
    ys = []
    for di, coord in enumerate(coords):
        sl = slice(di * rows, (di + 1) * rows)
        mp = shctx.model_shards_of(mesh, coord)
        ys.append(_expert_model_shards(
            params, x[sl].to(mp.devices[0]), experts[sl], pos[sl], keep[sl], weights[sl],
            cap, activation, mp).to(x.device))
    return torch.cat(ys) if len(ys) > 1 else ys[0]


def _expert_block(table, block: tuple, device, coord=None) -> torch.Tensor:
    """Experts ``[block[0], block[1])`` of an expert table on ``device``:
    the blocks of a ShardedArray that hold them, gathered over every other
    axis (the FSDP all-gather over data) for mesh coordinate ``coord``, or
    a slice of a tensor."""
    if isinstance(table, arrays.ShardedArray):
        return table.gather(device, region=(block,) + tuple(
            (0, n) for n in table.shape[1:]), coord=coord)
    return table[block[0]:block[1]].to(device)


def _expert_model_shards(params, x, experts, pos, keep, weights, cap: int,
                         activation: str, mp) -> torch.Tensor:
    """The expert-parallel branch over one data shard's model shards
    (``mp``): each shard's ``E / tp`` experts on its own device, the
    outputs summed in rank order."""
    e_local = params["w_gate"].shape[0] // mp.tp
    xs, ws, es, ps, ks = (arrays.to_model_shards(t.to(mp.devices[0]), mp)
                          for t in (x, weights, experts, pos, keep))
    parts = []
    for t in range(mp.tp):
        with mp.on(t):
            block = (t * e_local, (t + 1) * e_local)
            wg, wu, wd = (_expert_block(params[k], block, mp.devices[t], mp.coords[t])
                          for k in ("w_gate", "w_up", "w_down"))
            parts.append(expert_ffn(xs[t], es[t], ps[t], ks[t], ws[t], wg, wu, wd,
                                    capacity=cap, activation=activation,
                                    e_offset=t * e_local))
    return arrays.reduce_from_model_shards(parts, mp, x.dtype)


class _DeferredAux(torch.autograd.Function):
    """The load-balance term of one data shard: 0 in the forward (the
    global value is the step's), ``coef`` (filled in once every shard's
    forward has run) times the incoming gradient for the gate sums in the
    backward."""

    @staticmethod
    def forward(ctx, gate_sums, holder):
        ctx.holder = holder
        return gate_sums.new_zeros(())

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.holder["coef"], None


class GlobalAux:
    """The aux loss of the global batch under data parallelism.

    The aux loss ``E * w * sum_e me_e * ce_e`` takes its gate means ``me``
    and routed fractions ``ce`` over the global batch, so it is no sum of
    per-shard terms.  Each data shard's forward records, layer by layer,
    its gate sums and expert counts (``begin_shard``, then ``term``, which
    the MoE layer calls); ``finish`` combines them over the shards in rank
    order, returns the global aux (summed over layers, as the forward
    sums it) and gives each shard's term its gradient,
    ``d aux / d gate_sum_e = E * w * ce_e / tokens``.  A recomputed layer
    (``remat``) in the backward records nothing."""

    def __init__(self, moe: MoEConfig):
        self.moe = moe
        self.shards: list = []
        self.recording = False

    def begin_shard(self) -> None:
        self.shards.append([])
        self.recording = True

    def term(self, gate_sums: torch.Tensor, counts: torch.Tensor, tokens: int):
        holder: dict = {}
        if self.recording:
            self.shards[-1].append((gate_sums.detach(), counts, tokens, holder))
        return _DeferredAux.apply(gate_sums, holder)

    def finish(self) -> torch.Tensor:
        self.recording = False
        E, w = self.moe.num_experts, self.moe.router_aux_weight
        dev = self.shards[0][0][1].device if self.shards[0] else None
        aux = torch.zeros((), dtype=torch.float32, device=dev)
        for layer in zip(*self.shards):
            tokens = sum(t for _, _, t, _ in layer)
            gsum = counts = None
            for g, c, _, _ in layer:
                gsum = g.to(dev) if gsum is None else gsum + g.to(dev)
                counts = c.to(dev) if counts is None else counts + c.to(dev)
            ce = counts / tokens
            aux = aux + ((gsum / tokens) * ce).sum() * E * w
            coef = ce * (E * w / tokens)
            for g, _, _, holder in layer:
                holder["coef"] = coef.to(g.device)
        return aux


def apply(params: dict, x: torch.Tensor, moe: MoEConfig,
          activation: str) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, d).  Returns (output (b, s, d), aux loss fp32 scalar)."""
    E = moe.num_experts
    params = arrays.materialize(params, x.device)
    gates, weights, experts, pos, keep, cap = route(params, x, moe)
    ctx, mp = shctx.current(), shctx.model_parallel_state()
    if mp is not None and E % mp.tp == 0:
        y = _expert_model_shards(params, x, experts, pos, keep, weights, cap,
                                 activation, mp)
    elif ctx is not None and ctx[1].shape.get("model", 1) > 1 \
            and E % ctx[1].shape["model"] == 0:
        y = _expert_parallel(params, x, experts, pos, keep, weights, cap,
                             activation, ctx[1])
    else:
        y = expert_ffn(x, experts, pos, keep, weights,
                       *(_full(params[k], x.device) for k in ("w_gate", "w_up", "w_down")),
                       capacity=cap, activation=activation)
    if moe.shared_experts:
        y = y + mlp.apply(params["shared"], x, activation)
    if moe.residual_dense:
        y = y + mlp.apply(params["residual"], x, activation)

    # Switch-style load-balance aux loss: E * sum_e f_e * p_e, f_e counting
    # every top-k choice (dropped slots included) with a scatter-add.
    b, s = x.shape[0], x.shape[1]
    ce = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
        0, experts.reshape(-1),
        torch.ones(experts.numel(), dtype=torch.float32, device=x.device))
    dp = shctx.data_parallel_state()
    if dp is not None and dp.moe_aux is not None:
        return y, dp.moe_aux.term(gates.sum(dim=(0, 1)), ce, b * s)
    me = gates.mean(dim=(0, 1))                                 # (E,)
    aux = (me * (ce / (b * s))).sum() * E * moe.router_aux_weight
    return y, aux


def _full(table, device) -> torch.Tensor:
    return table.gather(device) if isinstance(table, arrays.ShardedArray) else table


def expert_flops_per_token(d_model: int, moe: MoEConfig) -> float:
    """Active FLOPs per token for MODEL_FLOPS accounting."""
    per_expert = 3 * 2 * d_model * moe.expert_d_ff
    total = moe.top_k * per_expert
    if moe.shared_experts:
        total += 3 * 2 * d_model * moe.shared_d_ff * moe.shared_experts
    if moe.residual_dense:
        total += 3 * 2 * d_model * moe.residual_d_ff
    return total
