"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427; port
of ``repro/models/rglru.py``).

Hawk-style temporal-mixing block:
  x -> {branch1: linear -> conv1d(w=4) -> RG-LRU, branch2: linear -> GeLU}
  out = proj(branch1 * branch2)

RG-LRU recurrence (per channel):
  r_t = sigmoid(W_a x_t + b_a)                         (recurrence gate)
  i_t = sigmoid(W_x x_t + b_x)                         (input gate)
  log a_t = -c * softplus(Lambda) * r_t                (c = 8)
  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill and the evaluation passes solve the linear recurrence h = a h + b
in fp32 with a chunked scan (``linear_scan``): within a chunk the pairwise
decays exp(sum of log a between s and t) (masked before exp), across
chunks a sequential carry.  The reference's ``associative_scan`` sums in
another order, so the two agree to rounding, not bitwise.  Decode is the
O(1) recurrence; it writes the new state into the state's tensors in
place, as attention decode writes its cache.

Tensor-parallel ``apply_full`` (its ``rnn`` leaves in ``sharding.arrays.
ModelShards``, inside ``sharding.context.model_parallel``): each model
shard computes its channels' columns of ``w_in`` and ``w_gate_branch`` and
the conv on them.  The gates contract over the full width (``w_a`` /
``w_x`` are ``("rnn_in", "rnn")``), so the conv output is all-gathered once
(``arrays.take``) and each shard applies its output columns of ``w_a`` /
``w_x``; ``b_a``, ``b_x``, ``lam`` and the scan run per channel, and
``w_out``'s row blocks give partial products, summed
(``reduce_from_model_shards``).  Where the model axis does not divide the
width, the rules leave every ``rnn`` leaf whole and the block computes
whole on the lead shard, as the reference does.  In a mesh serve step the
state and the conv tail are ``ModelShards`` of the same channels
(``rules.cache_shardings``): the prefill keeps each shard's, and the
decode steps each shard's channels, the conv output all-gathered for the
gates as in ``apply_full``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, RGLRUConfig
from repro_torch.models import common
from repro_torch.sharding import arrays
from repro_torch.sharding import context as shctx

_C = 8.0
SCAN_CHUNK = 64


class RGLRUState(NamedTuple):
    h: torch.Tensor           # (b, width) fp32 recurrent state
    conv: torch.Tensor        # (b, conv_width - 1, width) conv tail
    pos: torch.Tensor


def init(ini: common.Initializer, cfg: ArchConfig) -> dict:
    """The reference's leaves; ``lam`` is fp32 under any config dtype."""
    r: RGLRUConfig = cfg.rglru
    d, w = cfg.d_model, r.lru_width
    return {
        "w_in": ini.normal((d, w), ("embed", "rnn")),
        "w_gate_branch": ini.normal((d, w), ("embed", "rnn")),
        "conv_w": ini.normal((r.conv_width, w), ("conv", "rnn"), scale=0.1),
        "conv_b": ini.zeros((w,), ("rnn",)),
        "w_a": ini.normal((w, w), ("rnn_in", "rnn")),
        "b_a": ini.zeros((w,), ("rnn",)),
        "w_x": ini.normal((w, w), ("rnn_in", "rnn")),
        "b_x": ini.zeros((w,), ("rnn",)),
        # Lambda parameterized so a ~ U(0.9, 0.999) at init (paper appendix).
        "lam": ini.value(torch.linspace(2.0, 6.0, w, dtype=torch.float32), ("rnn",)),
        "w_out": ini.normal((w, d), ("rnn", "embed")),
    }


def _conv1d(x, w, b):
    """Causal depthwise conv along time: x (b, s, w); w (cw, w)."""
    cw = w.shape[0]
    pads = F.pad(x, (0, 0, cw - 1, 0))
    n = x.shape[1]
    return sum(pads[:, i:i + n, :] * w[i] for i in range(cw)) + b


def _gates(params, xc, xc_own=None):
    """(log a, b) of the linear recurrence h = a h + b, both fp32.  The gates
    contract over ``xc``'s full width; ``xc_own`` (default ``xc``) is the
    conv output at the gates' own channels."""
    xc_own = xc if xc_own is None else xc_own
    # a decode from fresh caches (fp32 conv tails) promotes as the
    # reference's einsum does; equal dtypes are left as they are
    dt = torch.promote_types(xc.dtype, params["w_a"].dtype)
    r = torch.sigmoid(torch.einsum("bsw,wu->bsu", xc.to(dt), params["w_a"].to(dt))
                      + params["b_a"])
    i = torch.sigmoid(torch.einsum("bsw,wu->bsu", xc.to(dt), params["w_x"].to(dt))
                      + params["b_x"])
    log_a = -_C * F.softplus(params["lam"].float()) * r.float()
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return log_a, mult * (i.float() * xc_own.float())


def linear_scan(log_a, b, chunk: int = SCAN_CHUNK):
    """h_t = exp(log_a_t) h_{t-1} + b_t from h_{-1} = 0, along axis 1, in
    fp32: log_a, b (batch, n, width) -> h (batch, n, width).

    Within a chunk of ``chunk`` steps, h_t = sum_{s <= t} exp(D_ts) b_s +
    exp(cum_t) h_in, where D_ts = sum_{s < u <= t} log_a_u is summed term by
    term (a running sum over t of the log decays past s), not taken as a
    difference of two running sums, which would cancel to a large sum's
    rounding under fast decay; the pairwise exponent is -inf above the
    diagonal before exp, and no running product of a is ever divided by.
    The carry h_in passes from chunk to chunk sequentially."""
    bsz, n, w = b.shape
    q = min(chunk, n)
    pad = (-n) % q
    if pad:   # log_a = 0, b = 0: the padding carries h unchanged
        log_a, b = F.pad(log_a, (0, 0, 0, pad)), F.pad(b, (0, 0, 0, pad))
    nc = (n + pad) // q
    la = log_a.float().reshape(bsz, nc, q, w)
    bc = b.float().reshape(bsz, nc, q, w)
    cum = torch.cumsum(la, dim=2)                                # (bsz, nc, q, w)
    after = torch.tril(torch.ones((q, q), dtype=torch.bool, device=b.device), -1)
    upper = ~torch.tril(torch.ones((q, q), dtype=torch.bool, device=b.device))
    hs = []
    h = torch.zeros((bsz, w), dtype=torch.float32, device=b.device)
    for c in range(nc):
        # D[t, s] = sum over u in (s, t] of log_a_u
        terms = torch.where(after[None, :, :, None], la[:, c, :, None, :], 0.0)
        D = torch.cumsum(terms, dim=1)                           # (bsz, t, s, w)
        wts = torch.exp(D.masked_fill_(upper[None, :, :, None], -torch.inf))
        hc = (wts * bc[:, c, None, :, :]).sum(dim=2) + torch.exp(cum[:, c]) * h[:, None]
        hs.append(hc)
        h = hc[:, -1]
    return torch.cat(hs, dim=1)[:, :n]


def _branches(params, x):
    """(conv input xb, gate branch, conv output xc) of x (b, s, d)."""
    xb = torch.einsum("bsd,dw->bsw", x, params["w_in"])
    gate = F.gelu(torch.einsum("bsd,dw->bsw", x, params["w_gate_branch"]),
                  approximate="tanh")
    return xb, gate, _conv1d(xb, params["conv_w"], params["conv_b"])


def _forward(params, x):
    """Returns (out, h (b, s, w) fp32, xb)."""
    xb, gate, xc = _branches(params, x)
    h = linear_scan(*_gates(params, xc))
    out = torch.einsum("bsw,wd->bsd", h.to(x.dtype) * gate, params["w_out"])
    return out, h, xb


def _apply_full_tp(params, x, mp):
    """``apply_full`` over the model shards of ``mp`` (the module
    docstring): (out, each shard's h (b, s, w / tp) fp32, each shard's
    conv input xb)."""
    shard = lambda t: {k: v.parts[t] for k, v in params.items()}
    xs = arrays.to_model_shards(x, mp)
    gates, xcs, xbs = [], [], []
    for t in range(mp.tp):
        with mp.on(t):
            xb, gate, xc = _branches(shard(t), xs[t])
            gates.append(gate)
            xcs.append(xc)
            xbs.append(xb)
    w = params["w_out"]
    full = arrays.take(arrays.ModelShards(xcs, 2, w.bounds, xcs[0].shape[:2] + w.shape[:1]),
                       mp, [[(0, w.shape[0])]] * mp.tp)
    outs, hs = [], []
    for t in range(mp.tp):
        with mp.on(t):
            h = linear_scan(*_gates(shard(t), full[t], xcs[t]))
            hs.append(h)
            outs.append(torch.einsum("bsw,wd->bsd", h.to(x.dtype) * gates[t],
                                     shard(t)["w_out"]))
    return arrays.reduce_from_model_shards(outs, mp, x.dtype), hs, xbs


def apply_full(params, x, cfg: ArchConfig):
    """Training / prefill over the full sequence: x (b, n, d).  With its
    leaves in ``ModelShards`` it runs tensor-parallel (the module
    docstring)."""
    if isinstance(params["w_out"], arrays.ModelShards):
        return _apply_full_tp(params, x, shctx.model_parallel_state())[0]
    return _forward(params, x)[0]


def init_state(cfg: ArchConfig, batch: int, dtype=torch.float32,
               device="cuda") -> RGLRUState:
    r = cfg.rglru
    return RGLRUState(
        h=torch.zeros((batch, r.lru_width), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, r.conv_width - 1, r.lru_width), dtype=dtype,
                         device=device),
        pos=torch.zeros((), dtype=torch.int32, device=device))


def prefill_into_state(params, x, cfg: ArchConfig):
    """Full-sequence output and the final recurrent state for decode.
    With its leaves in ``ModelShards`` the state's ``h`` and ``conv`` are
    ``ModelShards`` of each model shard's channels (whole on every shard
    where the rules leave the width whole)."""
    cw = cfg.rglru.conv_width
    pos = torch.tensor(x.shape[1], dtype=torch.int32, device=x.device)
    mp = shctx.model_parallel_state()
    if isinstance(params["w_out"], arrays.ModelShards):
        out, hs, xbs = _apply_full_tp(params, x, mp)
        w, bounds = params["w_out"].shape[0], params["w_out"].bounds
        b = x.shape[0]
        h = arrays.ModelShards([t[:, -1].contiguous() for t in hs], 1, bounds, (b, w))
        conv = arrays.ModelShards([t[:, -(cw - 1):].to(x.dtype).contiguous() for t in xbs], 2,
                                  bounds, (b, cw - 1, w))
        return out, RGLRUState(h=h, conv=conv, pos=pos)
    out, h, xb = _forward(params, x)
    h, conv = h[:, -1].contiguous(), xb[:, -(cw - 1):].to(x.dtype).contiguous()
    if mp is not None:          # the width whole: the state on every shard
        h, conv = arrays.cache_blocks(h, mp), arrays.cache_blocks(conv, mp)
    return out, RGLRUState(h=h, conv=conv, pos=pos)


def apply_decode(params, x, cfg: ArchConfig, state: RGLRUState):
    """One step: x (b, 1, d).  Writes the new ``h`` and conv tail into
    ``state``'s tensors in place; returns (out, state with ``pos``
    advanced).  With the state in ``ModelShards`` each model shard steps
    its channels (``_apply_decode_tp``)."""
    if isinstance(state.h, arrays.ModelShards):
        return _apply_decode_tp(params, x, cfg, state, shctx.model_parallel_state())
    xb = torch.einsum("bsd,dw->bsw", x, params["w_in"])[:, 0]          # (b, w)
    gate = F.gelu(torch.einsum("bsd,dw->bsw", x, params["w_gate_branch"]),
                  approximate="tanh")[:, 0]
    hist = torch.cat([state.conv, xb[:, None]], dim=1)                 # (b, cw, w)
    xc = (hist * params["conv_w"][None]).sum(dim=1) + params["conv_b"]
    log_a, b = _gates(params, xc[:, None])
    h_new = torch.exp(log_a[:, 0]) * state.h + b[:, 0]
    y = (h_new.to(x.dtype) * gate)[:, None]
    out = torch.einsum("bsw,wd->bsd", y, params["w_out"])
    state.h.copy_(h_new)
    state.conv.copy_(hist[:, 1:])
    return out, state._replace(pos=state.pos + 1)


def _apply_decode_tp(params, x, cfg: ArchConfig, state: RGLRUState, mp):
    """``apply_decode`` over the model shards of ``mp``: each shard's
    channels of the conv and the recurrence, the conv output all-gathered
    for the gates, ``w_out``'s row blocks summed; or, where the rules leave
    the width whole, the step on the lead shard, its state copied to every
    shard."""
    if state.h.dim is None:
        whole = {k: arrays.lead_whole(v, mp) if isinstance(v, arrays.ModelShards) else v
                 for k, v in params.items()}
        h, conv = state.h.parts[0], state.conv.parts[0]
        out, _ = apply_decode(whole, x, cfg, RGLRUState(h=h, conv=conv, pos=state.pos))
        arrays.write_back(state.h, h, mp)
        arrays.write_back(state.conv, conv, mp)
        return out, state._replace(pos=state.pos + 1)
    shard = lambda t: {k: v.parts[t] for k, v in params.items()}
    xs = arrays.to_model_shards(x, mp)
    gates, xcs, hists = [], [], []
    for t in range(mp.tp):
        with mp.on(t):
            p = shard(t)
            xb = torch.einsum("bsd,dw->bsw", xs[t], p["w_in"])[:, 0]
            gates.append(F.gelu(torch.einsum("bsd,dw->bsw", xs[t], p["w_gate_branch"]),
                                approximate="tanh")[:, 0])
            hist = torch.cat([state.conv.parts[t], xb[:, None]], dim=1)
            hists.append(hist)
            xcs.append((hist * p["conv_w"][None]).sum(dim=1) + p["conv_b"])
    w = params["w_out"]
    full = arrays.take(arrays.ModelShards(xcs, 1, w.bounds, (x.shape[0], w.shape[0])),
                       mp, [[(0, w.shape[0])]] * mp.tp)
    outs = []
    for t in range(mp.tp):
        with mp.on(t):
            log_a, b = _gates(shard(t), full[t][:, None], xcs[t][:, None])
            h_new = torch.exp(log_a[:, 0]) * state.h.parts[t] + b[:, 0]
            y = (h_new.to(x.dtype) * gates[t])[:, None]
            outs.append(torch.einsum("bsw,wd->bsd", y, shard(t)["w_out"]))
            state.h.parts[t].copy_(h_new)
            state.conv.parts[t].copy_(hists[t][:, 1:])
    return arrays.reduce_from_model_shards(outs, mp, x.dtype), state._replace(pos=state.pos + 1)
