"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``, the local path:
one device holds every expert).  The reference's expert-parallel
``shard_map`` branch runs only inside ``sharding.context.use``, which only
its XLA dry run enters; under the serving mesh its MoE FFN runs
replicated, as this one does on each slot group's lead device.

Routing: fp32 router logits, softmax gates, top-k with the lower expert
first on ties (``jax.lax.top_k``'s order), weights renormalized.  Capacity
is per batch row, ``max(1, int(capacity_factor * s * K / E))`` for a row of
``s`` tokens; a (token, k) slot's position in its expert is its rank among
the row's slots of that expert in slot-major order, from a stable sort of
the expert ids (no ``(s * K, E)`` one-hot), and slots past the capacity
drop.  The experts run over a static ``(b, E, capacity, d)`` buffer as
three batched products, so every shape is fixed by ``(b, s)`` and nothing
reads a count back to the host.

Covers plain top-k routed experts, a shared expert (deepseek) and the
parallel dense residual FFN (arctic), and the Switch load-balance aux
loss.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.core.selection import stable_topk
from repro_torch.models import mlp
from repro_torch.models.common import Initializer


def init(ini: Initializer, d_model: int, moe: MoEConfig, activation: str) -> dict:
    e, f = moe.num_experts, moe.expert_d_ff
    p = {
        "router": ini.normal((d_model, e), dtype=torch.float32),
        "w_gate": ini.normal((e, d_model, f)),
        "w_up": ini.normal((e, d_model, f)),
        "w_down": ini.normal((e, f, d_model)),
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
               activation: str) -> torch.Tensor:
    """Dispatch into the ``(b, E, capacity, d)`` buffer, the expert FFN over
    every expert, and the weighted combine in ``x.dtype``, k by k.

    A kept slot's (row, expert, position) is unique in the buffer; a
    dropped slot writes to one trash row past its end, which the products
    never read."""
    b, s, d = x.shape
    E = wg.shape[0]
    K = experts.shape[-1]
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


def apply(params: dict, x: torch.Tensor, moe: MoEConfig,
          activation: str) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, d).  Returns (output (b, s, d), aux loss fp32 scalar)."""
    E = moe.num_experts
    gates, weights, experts, pos, keep, cap = route(params, x, moe)
    y = expert_ffn(x, experts, pos, keep, weights, params["w_gate"],
                   params["w_up"], params["w_down"], capacity=cap,
                   activation=activation)
    if moe.shared_experts:
        y = y + mlp.apply(params["shared"], x, activation)
    if moe.residual_dense:
        y = y + mlp.apply(params["residual"], x, activation)

    # Switch-style load-balance aux loss: E * sum_e f_e * p_e, f_e counting
    # every top-k choice (dropped slots included) with a scatter-add.
    me = gates.mean(dim=(0, 1))                                 # (E,)
    b, s = x.shape[0], x.shape[1]
    ce = torch.zeros(E, dtype=torch.float32, device=x.device).index_add_(
        0, experts.reshape(-1),
        torch.ones(experts.numel(), dtype=torch.float32, device=x.device))
    aux = (me * (ce / (b * s))).sum() * E * moe.router_aux_weight
    return y, aux


def expert_flops_per_token(d_model: int, moe: MoEConfig) -> float:
    """Active FLOPs per token for MODEL_FLOPS accounting."""
    per_expert = 3 * 2 * d_model * moe.expert_d_ff
    total = moe.top_k * per_expert
    if moe.shared_experts:
        total += 3 * 2 * d_model * moe.shared_d_ff * moe.shared_experts
    if moe.residual_dense:
        total += 3 * 2 * d_model * moe.residual_d_ff
    return total
