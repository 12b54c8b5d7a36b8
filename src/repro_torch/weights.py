"""Carry parameters from the reference's tree into the port.

``from_jax_params`` takes the JAX ``init_params`` values tree with every
leaf already converted to numpy (the caller does the conversion, so this
module needs no JAX) and returns the port's tree: the same nesting, every
stacked layer axis kept as the leading dimension (the decoder-only
families' ``segment{si}`` with their ``attn`` / ``mixer`` / ``ffn``
subtrees, MoE ``shared`` / ``residual`` subtrees and with ``cfg.mtp`` the
MTP head's ``mtp_proj``, ``mtp_norm`` and one-layer ``mtp_layer``; the
encoder-decoder's ``embed``, ``dec_pos``, ``enc_layers``, ``enc_norm``,
``dec_layers`` and ``final_norm``).  Each leaf keeps the dtype the
reference gives it: fp32 for the embedding table, the untied LM head,
every MoE ``router``, the SSD block's ``a_log`` / ``dt_bias`` / ``d_skip``
and the RG-LRU's ``lam``; ``cfg``'s dtype for every other leaf.

``to_shards`` splits such a numpy tree into the blocks of a mesh's
shardings (the reference's ZeRO-1 optimizer state, carried shard for
shard).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer
from repro_torch.sharding import arrays
from repro_torch.sharding import rules as rules_lib

# Leaves the reference keeps in fp32 under any config dtype.
FP32_LEAVES = ("router", "a_log", "dt_bias", "d_skip", "lam")


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
        fp32 = path in (("embed",), ("head",)) or path[-1] in FP32_LEAVES
        return _to_tensor(node, torch.float32 if fp32 else cfg.torch_dtype,
                          device)

    if cfg.family == "encdec":
        expected = {"embed", "dec_pos", "enc_layers", "enc_norm", "dec_layers",
                    "final_norm"}
    else:
        expected = {"embed", "final_norm"} | {
            f"segment{si}" for si, _ in enumerate(transformer.layer_program(cfg))}
    if not cfg.tie_embeddings:
        expected.add("head")
    if cfg.mtp:
        expected |= {"mtp_proj", "mtp_norm", "mtp_layer"}
    if set(tree) != expected:
        raise ValueError(
            f"parameter tree keys {sorted(tree)} are not the {cfg.family} "
            f"{'tied' if cfg.tie_embeddings else 'untied'}-head"
            f"{' MTP' if cfg.mtp else ''} set {sorted(expected)}")
    return convert(dict(tree), ())


def to_shards(tree, shardings, dtype=None):
    """A numpy tree (full arrays: the reference's values, its optimizer
    state's master / mu / nu) split into the port's blocks: a tree of
    ``sharding.arrays.ShardedArray`` in the matching ``NamedSharding``
    tree's layout, on its mesh's devices.  Each leaf keeps its dtype (bf16
    reinterpreted, as ``from_jax_params`` does) unless ``dtype`` is
    given."""
    def one(a, sh):
        a = np.asarray(a)
        dt = dtype or (torch.bfloat16 if a.dtype.name == "bfloat16"
                       else torch.from_numpy(np.empty(0, a.dtype)).dtype)
        return arrays.place(_to_tensor(a, dt, "cpu"), sh)
    return rules_lib.tree_map(one, tree, shardings)

