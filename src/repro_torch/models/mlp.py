"""Feed-forward variants (port of ``repro/models/mlp.py``): SwiGLU, GeGLU
(tanh-approximate GELU, as ``jax.nn.gelu``), plain GELU MLP."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import Initializer


def init(ini: Initializer, d_model: int, d_ff: int, activation: str) -> dict:
    if activation in ("silu", "gelu"):
        return {
            "w_gate": ini.normal((d_model, d_ff)),
            "w_up": ini.normal((d_model, d_ff)),
            "w_down": ini.normal((d_ff, d_model)),
        }
    if activation == "gelu_mlp":
        return {
            "w_in": ini.normal((d_model, d_ff)),
            "b_in": ini.zeros((d_ff,)),
            "w_out": ini.normal((d_ff, d_model)),
            "b_out": ini.zeros((d_model,)),
        }
    raise ValueError(f"unknown activation {activation!r}")


def apply(params: dict, x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation in ("silu", "gelu"):
        act = F.silu if activation == "silu" else (
            lambda t: F.gelu(t, approximate="tanh"))
        g = act(x @ params["w_gate"])
        u = x @ params["w_up"]
        return (g * u) @ params["w_down"]
    h = F.gelu(x @ params["w_in"] + params["b_in"], approximate="tanh")
    return h @ params["w_out"] + params["b_out"]
