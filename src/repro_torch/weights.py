"""Carry parameters from the reference's tree into the port.

``from_jax_params`` takes the JAX ``init_params`` values tree with every
leaf already converted to numpy (the caller does the conversion, so this
module needs no JAX) and returns the port's tree: the same nesting, the
stacked ``segment{si}`` layer axis kept as the leading dimension, the fp32
embedding table kept fp32, every other leaf in ``cfg``'s dtype.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


def _to_tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":            # ml_dtypes: reinterpret the bits
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))     # a writable copy
    return t.to(device=device, dtype=dtype)


def from_jax_params(tree, cfg: ArchConfig, device="cuda") -> dict:
    """numpy tree of the reference's parameters -> the port's parameters."""
    def convert(node, path):
        if isinstance(node, dict):
            return {k: convert(v, path + (k,)) for k, v in node.items()}
        dtype = torch.float32 if path == ("embed",) else cfg.torch_dtype
        return _to_tensor(node, dtype, device)

    expected = {"embed", "final_norm"} | {
        k for k in tree if k.startswith("segment")}
    if set(tree) != expected:
        raise ValueError(
            f"unsupported parameter tree keys {sorted(set(tree) - expected)} "
            "(the port serves tied-embedding dense models)")
    return convert(dict(tree), ())
