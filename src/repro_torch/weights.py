"""Carry parameters from the reference's tree into the port.

``from_jax_params`` takes the JAX ``init_params`` values tree with every
leaf already converted to numpy (the caller does the conversion, so this
module needs no JAX) and returns the port's tree: the same nesting, the
stacked ``segment{si}`` layer axis kept as the leading dimension, the fp32
embedding table and the fp32 untied LM head kept fp32, every other leaf in
``cfg``'s dtype.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer


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
        fp32 = path in (("embed",), ("head",))
        return _to_tensor(node, torch.float32 if fp32 else cfg.torch_dtype,
                          device)

    expected = {"embed", "final_norm"} | {
        f"segment{si}" for si, _ in enumerate(transformer.layer_program(cfg))}
    if not cfg.tie_embeddings:
        expected.add("head")
    if set(tree) != expected:
        raise ValueError(
            f"parameter tree keys {sorted(tree)} are not the dense "
            f"{'tied' if cfg.tie_embeddings else 'untied'}-head set "
            f"{sorted(expected)}")
    return convert(dict(tree), ())
