"""Token sampling for the serving engine (port of
``repro/runtime/sampling.py``: ``GreedySampler``, ``TemperatureSampler`` and
the registry).

A sampler maps logits ``(..., vocab)`` to int32 ids ``(...)`` on the device,
so the engine fetches ids, never logits rows.  Only ``"greedy"`` is
registered, as in the reference: it is the one stream-deterministic choice,
and the async == sync differentials hold against it.  ``TemperatureSampler``
is the op-level version of the stochastic extension; the engine threads no
generator yet.
"""
from __future__ import annotations

import torch


class GreedySampler:
    """argmax over the vocab axis with numpy's tie rule: ``torch.argmax``
    returns the first maximal index."""

    deterministic = True

    def __call__(self, logits: torch.Tensor) -> torch.Tensor:
        return torch.argmax(logits, dim=-1).to(torch.int32)


class TemperatureSampler:
    """Categorical sampling at ``temperature`` (Gumbel-max over
    ``logits / temperature`` in fp32).  Needs an explicit
    ``torch.Generator`` per call; torch's and ``jax.random``'s streams
    differ, so it matches the reference in distribution, not in draws."""

    deterministic = False

    def __init__(self, temperature: float = 1.0):
        if temperature <= 0:
            raise ValueError(f"temperature must be > 0, got {temperature}")
        self.temperature = temperature

    def __call__(self, logits: torch.Tensor, *, generator=None) -> torch.Tensor:
        if generator is None:
            raise ValueError("TemperatureSampler needs an explicit "
                             "torch.Generator")
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device, dtype=torch.float32)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
        return torch.argmax(logits.float() / self.temperature + gumbel,
                            dim=-1).to(torch.int32)


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
