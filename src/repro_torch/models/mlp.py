"""Feed-forward variants (port of ``repro/models/mlp.py``): SwiGLU, GeGLU
(tanh-approximate GELU, as ``jax.nn.gelu``), plain GELU MLP.

With its ``mlp`` dim split over the model axis (``sharding.arrays.
ModelShards``, inside ``sharding.context.model_parallel``) each model shard
computes its columns of ``w_gate`` / ``w_up`` (``w_in`` + ``b_in``) and its
row block of ``w_down`` (``w_out``) on its own device; the partial products
are summed (``reduce_from_model_shards``) and ``b_out`` added once, after
the sum."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import Initializer
from repro_torch.sharding import arrays
from repro_torch.sharding import context as shctx


def init(ini: Initializer, d_model: int, d_ff: int, activation: str) -> dict:
    if activation in ("silu", "gelu"):
        return {
            "w_gate": ini.normal((d_model, d_ff), ("embed", "mlp")),
            "w_up": ini.normal((d_model, d_ff), ("embed", "mlp")),
            "w_down": ini.normal((d_ff, d_model), ("mlp", "embed")),
        }
    if activation == "gelu_mlp":
        return {
            "w_in": ini.normal((d_model, d_ff), ("embed", "mlp")),
            "b_in": ini.zeros((d_ff,), ("mlp",)),
            "w_out": ini.normal((d_ff, d_model), ("mlp", "embed")),
            "b_out": ini.zeros((d_model,), ("embed",)),
        }
    raise ValueError(f"unknown activation {activation!r}")


def apply(params: dict, x: torch.Tensor, activation: str) -> torch.Tensor:
    if isinstance(params.get("w_down", params.get("w_out")), arrays.ModelShards):
        return _apply_tp(params, x, activation, shctx.model_parallel_state())
    if activation in ("silu", "gelu"):
        return _hidden(params, x, activation) @ params["w_down"]
    return _hidden(params, x, activation) @ params["w_out"] + params["b_out"]


def _hidden(params: dict, x: torch.Tensor, activation: str) -> torch.Tensor:
    """The activations before the down projection."""
    if activation in ("silu", "gelu"):
        act = F.silu if activation == "silu" else (
            lambda t: F.gelu(t, approximate="tanh"))
        return act(x @ params["w_gate"]) * (x @ params["w_up"])
    return F.gelu(x @ params["w_in"] + params["b_in"], approximate="tanh")


def _apply_tp(params: dict, x: torch.Tensor, activation: str, mp) -> torch.Tensor:
    """``apply`` over the model shards of ``mp``: x (on the lead shard)
    copied to each, each shard's columns and rows, the partial products
    summed in rank order."""
    down = "w_down" if activation in ("silu", "gelu") else "w_out"
    xs = arrays.to_model_shards(x, mp)
    parts = []
    for t in range(mp.tp):
        with mp.on(t):
            shard = {k: v.parts[t] for k, v in params.items()
                     if isinstance(v, arrays.ModelShards)}
            parts.append(_hidden(shard, xs[t], activation) @ shard[down])
    y = arrays.reduce_from_model_shards(parts, mp, x.dtype)
    return y if down == "w_down" else y + params["b_out"]
