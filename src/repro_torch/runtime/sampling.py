"""Token sampling for the serving engine (port of
``repro/runtime/sampling.py``: ``GreedySampler`` and the registry)."""
from __future__ import annotations

import torch


class GreedySampler:
    """argmax over the vocab axis with numpy's tie rule: the FIRST maximal
    index (max, then the smallest index holding it)."""

    def __call__(self, logits: torch.Tensor) -> torch.Tensor:
        m = logits.amax(dim=-1, keepdim=True)
        vocab = logits.shape[-1]
        iota = torch.arange(vocab, dtype=torch.int32, device=logits.device)
        return torch.where(logits == m, iota, vocab).amin(dim=-1).to(torch.int32)


_SAMPLERS = {}


def register_sampler(name: str, factory) -> None:
    """Register a sampler factory (``() -> Sampler``) under ``name``."""
    if name in _SAMPLERS:
        raise ValueError(f"sampler {name!r} already registered")
    _SAMPLERS[name] = factory


def get_sampler(name: str):
    try:
        return _SAMPLERS[name]()
    except KeyError:
        raise ValueError(
            f"unknown sampler {name!r} (registered: {sorted(_SAMPLERS)})")


register_sampler("greedy", GreedySampler)
