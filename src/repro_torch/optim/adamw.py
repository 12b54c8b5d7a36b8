"""AdamW with warmup-cosine schedule, global-norm clipping, fp32 master
weights and optional bf16 gradient compression (port of
``repro/optim/adamw.py``).

Parameters and optimizer state are plain trees of tensors (nested dicts, as
``weights.py`` and ``init_params`` build them).  The schedule, the bias
corrections ``b1 ** step``, the clip scale and the update are computed in
fp32 tensors on the parameters' device, as the reference computes them
(never in Python floats).  ``grad_dtype = "bfloat16"`` casts the gradients
with round-to-nearest-even before the update, as the reference does before
its data-parallel all-reduce; ``moment_dtype = "bfloat16"`` stores mu and
nu in bf16.  Weight decay applies to every leaf, as in the reference.

On a mesh (``launch/steps.py``) the update runs on the ZeRO-1 blocks: the
leaves are the blocks, on their own devices, the global norm is the sum of
the blocks' squared norms in order (``global_norm``; the caller passes it
in when replicated blocks must count once), and the schedule's scalars are
copied to each block's device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    grad_dtype: Optional[str] = "bfloat16"   # gradient-compression cast
    moment_dtype: str = "float32"            # "bfloat16" halves mu/nu memory


class OptState(NamedTuple):
    step: torch.Tensor   # int32 scalar
    master: Any          # fp32 master weights (the parameters' tree)
    mu: Any
    nu: Any


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (nested dicts / lists / tuples of
    tensors) and the matching leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _moment_dtype(cfg: Optional[AdamWConfig]) -> torch.dtype:
    return torch.bfloat16 if (cfg and cfg.moment_dtype == "bfloat16") else torch.float32


def init_state(params, cfg: Optional[AdamWConfig] = None) -> OptState:
    mdt = _moment_dtype(cfg)
    dev = tree_leaves(params)[0].device
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        master=tree_map(lambda p: p.detach().to(torch.float32, copy=True), params),
        mu=tree_map(lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device), params),
        nu=tree_map(lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device), params))


def lr_at(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    decayed = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.peak_lr * torch.where(step < cfg.warmup_steps, warm, decayed)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the leaves' summed squares, added in leaf order on the first
    leaf's device."""
    leaves = tree_leaves(tree)
    dev = leaves[0].device
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32))).to(dev)
                          for g in leaves))


def compress_grads(grads, cfg: AdamWConfig):
    """The gradient-compression cast (round to nearest even for bf16)."""
    if cfg.grad_dtype is None:
        return grads
    dt = torch.bfloat16 if cfg.grad_dtype == "bfloat16" else torch.float32
    return tree_map(lambda g: g.to(dt), grads)


_CHUNK = 1 << 26


@torch.no_grad()
def update(grads, state: OptState, cfg: AdamWConfig, gnorm=None):
    """One AdamW step on the fp32 master, in place: the master, mu and nu
    tensors of ``state`` take their new values and the returned state holds
    them (a caller that needs the state from before the step clones it).
    Returns (new state, {"lr", "grad_norm"}).  No second copy of the
    optimizer state is ever alive, and each leaf is updated in slices of
    2^26 elements, so its temporaries stay at a few of those: at gemma-2b's
    and deepseek-v3-671b's 2.5-3.1 B parameters, two fp32 copies of master,
    mu and nu, or eight fp32 temporaries of a 0.9 B-element embedding, do
    not fit beside the gradient on an 80 GB card.  ``gnorm`` (default:
    ``global_norm(grads)``) is the norm the gradients are clipped by."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    lr = lr_at(step, cfg)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(b1, stepf)
    c2 = 1.0 - torch.pow(b2, stepf)

    scalars = {}

    def on(dev):
        """(scale, lr, c1, c2) on ``dev`` (copied once a device)."""
        if dev not in scalars:
            scalars[dev] = tuple(t.to(dev) for t in (scale, lr, c1, c2))
        return scalars[dev]

    def step_of(g, m, v, p):
        scale, lr, c1, c2 = on(p.device)
        g = g.to(torch.float32) * scale
        m_new = b1 * m.to(torch.float32) + (1.0 - b1) * g
        v_new = b2 * v.to(torch.float32) + (1.0 - b2) * g * g
        mh = m_new / c1
        vh = v_new / c2
        p_new = p - lr * (mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p)
        return m_new, v_new, p_new

    def upd(g, m, v, p):
        # elementwise, so slices give the same bits with a bounded set of
        # temporaries; view (not reshape) raises on a written leaf that is
        # not contiguous instead of updating a copy
        flat = [g.reshape(-1)] + [x.view(-1) for x in (m, v, p)]
        for i in range(0, p.numel(), _CHUNK):
            part = [x[i:i + _CHUNK] for x in flat]
            for dst, new in zip(part[1:], step_of(*part)):
                dst.copy_(new)      # mu / nu round to their dtype here
        return m, v, p

    flat = tree_map(upd, grads, state.mu, state.nu, state.master)
    new_state = OptState(step=step, master=_pick(flat, 2), mu=_pick(flat, 0),
                         nu=_pick(flat, 1))
    return new_state, {"lr": lr, "grad_norm": gnorm}


def _pick(flat, i: int):
    """Field ``i`` of every (mu, nu, master) triple of ``flat``."""
    if isinstance(flat, dict):
        return {k: _pick(v, i) for k, v in flat.items()}
    if isinstance(flat, list):
        return [_pick(v, i) for v in flat]
    return flat[i]


def cast_params(state: OptState, like) -> Any:
    """Master fp32 -> the dtypes of the reference tree ``like``."""
    return tree_map(lambda m, p: m.to(p.dtype), state.master, like)
