"""Mamba-2 SSD block (state-space duality, arXiv:2405.21060; port of
``repro/models/ssd.py``).

Selective state space with a scalar-identity A per head:
  h_t = exp(A dt_t) h_{t-1} + dt_t B_t x_t^T     (state: headdim x N)
  y_t = C_t . h_t + D x_t

Prefill and the evaluation passes run the chunked SSD algorithm: quadratic
attention-like einsums within chunks of ``chunk_size`` tokens and a
sequential pass over chunks for the carried state (O(N Q d) work, N / Q
sequential steps).  Decode is the O(1) recurrence; it writes the new state
into the state's tensors in place, as attention decode writes its cache.

Tensor-parallel ``apply_full`` (its ``rnn`` / ``heads`` leaves in
``sharding.arrays.ModelShards``, inside ``sharding.context.
model_parallel``): each model shard takes its heads' columns of the packed
``w_in`` (``z | x | B | C | dt``) and of the conv (``x | B | C``), with
``B`` and ``C`` whole (the state is shared by every head), from whichever
shards hold them (``arrays.take``: the blocks are cut evenly over the
packed dim, not at the segments).  It runs the conv on its channels, the
chunked scan on its heads and ``y * silu(z)`` on its channels; the gated
RMSNorm over ``d_inner`` sums the shards' squares in rank order before
the scale, and ``w_out``'s row blocks give partial products, summed
(``reduce_from_model_shards``).  Where the rules leave ``heads`` whole
(the model axis does not divide them) the block computes whole on the lead
shard, as the reference does.

In a mesh serve step (``rules.cache_shardings``) the state ``h`` is split
by heads and the conv tail evenly over its packed ``x | B | C`` columns:
the prefill keeps each shard's heads' final state and regroups the shards'
conv inputs into the tail's blocks (``arrays.take``); the decode takes
each shard's heads' columns of the tail (with B and C whole), steps its
heads, sums the gated RMSNorm's squares across the shards as
``apply_full`` does, and regroups the new tail back into its blocks.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, SSDConfig
from repro_torch.models import common
from repro_torch.sharding import arrays
from repro_torch.sharding import context as shctx


class SSDState(NamedTuple):
    h: torch.Tensor        # (b, heads, headdim, state) fp32
    conv: torch.Tensor     # (b, conv_width - 1, conv_dim) raw conv inputs
    pos: torch.Tensor


def _dims(cfg: ArchConfig):
    s: SSDConfig = cfg.ssd
    d_inner = s.expand * cfg.d_model
    heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.state_dim     # x, B, C go through the conv
    return s, d_inner, heads, conv_dim


def init(ini: common.Initializer, cfg: ArchConfig) -> dict:
    """The reference's leaves; ``a_log``, ``dt_bias`` and ``d_skip`` are
    fp32 under any config dtype, as the reference makes them."""
    s, d_inner, heads, conv_dim = _dims(cfg)
    d = cfg.d_model
    return {
        "w_in": ini.normal((d, 2 * d_inner + 2 * s.state_dim + heads),
                           ("embed", "rnn")),
        "conv_w": ini.normal((s.conv_width, conv_dim), ("conv", "rnn"), scale=0.1),
        "conv_b": ini.zeros((conv_dim,), ("rnn",)),
        "a_log": ini.value(torch.log(torch.linspace(1.0, 16.0, heads)), ("heads",)),
        "dt_bias": ini.value(torch.log(torch.expm1(torch.full((heads,), 0.01))),
                             ("heads",)),
        "d_skip": ini.ones((heads,), ("heads",), dtype=torch.float32),
        "norm": ini.zeros((d_inner,), ("rnn",)),
        "w_out": ini.normal((d_inner, d), ("rnn", "embed")),
    }


def _split_proj(params, x, cfg: ArchConfig):
    s, d_inner, heads, conv_dim = _dims(cfg)
    zxbcdt = torch.einsum("bsd,de->bse", x, params["w_in"])
    return torch.split(zxbcdt, [d_inner, conv_dim, heads], dim=-1)


def _conv_silu(xbc, params):
    """Causal depthwise conv along time, then SiLU: xbc (b, s, conv_dim)."""
    cw = params["conv_w"].shape[0]
    pads = F.pad(xbc, (0, 0, cw - 1, 0))
    n = xbc.shape[1]
    out = sum(pads[:, i:i + n, :] * params["conv_w"][i] for i in range(cw))
    return F.silu(out + params["conv_b"])


def _ssm_inputs(xbc, dt, params, cfg: ArchConfig, heads=None):
    """``heads``: how many heads ``xbc`` / ``dt`` carry (default all)."""
    s, d_inner, all_heads, _ = _dims(cfg)
    heads = heads or all_heads
    d_inner = heads * s.head_dim
    xi, B, C = torch.split(xbc, [d_inner, s.state_dim, s.state_dim], dim=-1)
    b, n = xi.shape[0], xi.shape[1]
    xh = xi.reshape(b, n, heads, s.head_dim)
    dt = F.softplus(dt.float() + params["dt_bias"])                    # (b, n, h)
    a = -torch.exp(params["a_log"].float())                            # (h,)
    log_decay = dt * a                                                 # <= 0
    return xh, B, C, dt, log_decay


def _chunked_ssd(xh, B, C, dt, log_decay, chunk: int, d_skip):
    """Chunked SSD scan.  xh: (b, n, h, p); B, C: (b, n, N); dt, log_decay:
    (b, n, h).  Returns (y (b, n, h, p) fp32, final state (b, h, p, N))."""
    b, n, h, p = xh.shape
    N = B.shape[-1]
    q = min(chunk, n)
    n_orig = n
    if n % q:
        # pad to a chunk multiple: dt = 0 at the padding gives a = 1, b = 0,
        # so the carried state is unaffected; padded outputs are dropped.
        pad = q - n % q
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        B, C = F.pad(B, (0, 0, 0, pad)), F.pad(C, (0, 0, 0, pad))
        dt, log_decay = F.pad(dt, (0, 0, 0, pad)), F.pad(log_decay, (0, 0, 0, pad))
        n = n + pad
    nc = n // q
    xc = xh.reshape(b, nc, q, h, p).float()
    Bc = B.reshape(b, nc, q, N).float()
    Cc = C.reshape(b, nc, q, N).float()
    dtc = dt.reshape(b, nc, q, h)
    cum = torch.cumsum(log_decay.reshape(b, nc, q, h), dim=2)   # (b, nc, q, h)

    # Intra-chunk: L[i, j] = exp(cum_i - cum_j) for j <= i.  Mask before
    # exp: above the diagonal cum_i - cum_j > 0 would overflow.
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]         # (b, nc, i, j, h)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xh.device))
    L = torch.exp(torch.where(mask[None, None, :, :, None], li, -torch.inf))
    cb = torch.einsum("bciN,bcjN->bcij", Cc, Bc)
    w = cb[..., None] * L * dtc[:, :, None, :, :]              # (b, nc, i, j, h)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w, xc)
    del li, L, w

    # Chunk-final states: S_c = sum_j exp(cum_last - cum_j) dt_j B_j x_j^T.
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)          # (b, nc, q, h)
    sB = Bc[..., None, :] * (dtc * decay_to_end)[..., None]    # (b, nc, q, h, N)
    S_chunk = torch.einsum("bcqhN,bcqhp->bchpN", sB, xc)       # (b, nc, h, p, N)
    chunk_decay = torch.exp(cum[:, :, -1, :])                  # (b, nc, h)

    # Sequential pass over chunks: the state entering each chunk.
    S = torch.zeros((b, h, p, N), dtype=torch.float32, device=xh.device)
    S_prevs = []
    for c in range(nc):
        S_prevs.append(S)
        S = S * chunk_decay[:, c, :, None, None] + S_chunk[:, c]
    S_prev = torch.stack(S_prevs, dim=1)                       # (b, nc, h, p, N)

    # Inter-chunk: y_inter[i] = exp(cum_i) * C_i . S_prev.
    y_inter = torch.einsum("bciN,bchpN->bcihp", Cc, S_prev) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(b, n, h, p)
    y = y + d_skip[None, None, :, None] * xh.float()
    return y[:, :n_orig], S


def _forward(params, x, cfg: ArchConfig):
    """Returns (out, final state, the raw conv inputs)."""
    s, d_inner, heads, _ = _dims(cfg)
    z, xbc_raw, dt = _split_proj(params, x, cfg)
    xh, B, C, dtv, ld = _ssm_inputs(_conv_silu(xbc_raw, params), dt, params, cfg)
    y, S_final = _chunked_ssd(xh, B, C, dtv, ld, s.chunk_size, params["d_skip"])
    b, n = x.shape[0], x.shape[1]
    y = y.reshape(b, n, d_inner).to(x.dtype) * F.silu(z)
    y = common.rms_norm(y, params["norm"])
    return torch.einsum("bse,ed->bsd", y, params["w_out"]), S_final, xbc_raw


def _shard_ranges(cfg: ArchConfig, t: int, hl: int) -> dict:
    """Model shard ``t``'s (dim, column ranges) of each leaf: its ``hl``
    heads' columns of z, x and dt in the packed ``w_in`` with B and C
    whole, the same of the conv's x | B | C, its channels of ``norm`` /
    ``w_out`` and its heads of ``a_log`` / ``dt_bias`` / ``d_skip``."""
    s, d_inner, heads, _ = _dims(cfg)
    N = s.state_dim
    ch = (t * hl * s.head_dim, (t + 1) * hl * s.head_dim)
    dt0 = 2 * d_inner + 2 * N
    w_in = [ch, (d_inner + ch[0], d_inner + ch[1]), (2 * d_inner, dt0),
            (dt0 + t * hl, dt0 + (t + 1) * hl)]
    conv = [ch, (d_inner, d_inner + 2 * N)]
    own = [(t * hl, (t + 1) * hl)]
    return {"w_in": (1, w_in), "conv_w": (1, conv), "conv_b": (0, conv), "norm": (0, [ch]),
            "w_out": (0, [ch]), "a_log": (0, own), "dt_bias": (0, own), "d_skip": (0, own)}


def _shard_params(params, mp, hl: int, cfg: ArchConfig) -> list:
    """Each model shard's columns of every leaf (``_shard_ranges``), cut
    from whichever shards hold them."""
    rng = [_shard_ranges(cfg, t, hl) for t in range(mp.tp)]
    shards = [{} for _ in range(mp.tp)]
    for name, (dim, _) in rng[0].items():
        for t, part in enumerate(arrays.take(params[name], mp, [r[name][1] for r in rng], dim)):
            shards[t][name] = part
    return shards


def _gated_out(ys, shards, x, mp, d_inner: int):
    """The shards' ``y * silu(z)`` (fp32, their channels) through the gated
    RMSNorm over ``d_inner`` (each shard's share of the mean square summed
    in rank order) and ``w_out``'s row blocks, the partial products summed."""
    sq = []
    for t, y in enumerate(ys):
        with mp.on(t):
            # this shard's share of the mean square (exactly the mean at tp 1)
            sq.append(torch.mean(y * y, dim=-1, keepdim=True) * (y.shape[-1] / d_inner))
    var = arrays.to_model_shards(arrays.reduce_from_model_shards(sq, mp), mp)
    outs = []
    for t in range(mp.tp):
        with mp.on(t):
            y = ys[t] * torch.rsqrt(var[t] + 1e-6)
            y = (y * (1.0 + shards[t]["norm"].float())).to(x.dtype)
            outs.append(torch.einsum("bse,ed->bsd", y, shards[t]["w_out"]))
    return arrays.reduce_from_model_shards(outs, mp, x.dtype)


def _conv_columns(xbcs, cfg: ArchConfig, hl: int):
    """The shards' conv inputs (each its heads' x columns, then B and C) as
    ``ModelShards`` of disjoint column blocks of the packed ``x | B | C``
    (B and C held by the last shard), for ``arrays.take``."""
    s, d_inner, _, conv_dim = _dims(cfg)
    tp, w = len(xbcs), hl * s.head_dim
    parts = [p[..., :w] for p in xbcs[:-1]] + [xbcs[-1]]
    bounds = [(t * w, (t + 1) * w) for t in range(tp - 1)] + [((tp - 1) * w, conv_dim)]
    return arrays.ModelShards(parts, xbcs[0].dim() - 1, bounds,
                              tuple(xbcs[0].shape[:-1]) + (conv_dim,))


def _apply_full_tp(params, x, cfg: ArchConfig, mp):
    """``apply_full`` over the model shards of ``mp`` (the module
    docstring): (out, each shard's final state, each shard's raw conv
    input)."""
    s, d_inner, heads, _ = _dims(cfg)
    hl = heads // mp.tp
    shards = _shard_params(params, mp, hl, cfg)
    xs = arrays.to_model_shards(x, mp)
    b, n = x.shape[0], x.shape[1]
    ys, states, xbcs = [], [], []
    for t in range(mp.tp):
        with mp.on(t):
            p = shards[t]
            z, xbc, dt = torch.split(torch.einsum("bsd,de->bse", xs[t], p["w_in"]),
                                     [hl * s.head_dim, hl * s.head_dim + 2 * s.state_dim,
                                      hl], dim=-1)
            xh, B, C, dtv, ld = _ssm_inputs(_conv_silu(xbc, p), dt, p, cfg, hl)
            y, S = _chunked_ssd(xh, B, C, dtv, ld, s.chunk_size, p["d_skip"])
            ys.append((y.reshape(b, n, hl * s.head_dim).to(x.dtype) * F.silu(z)).float())
            states.append(S)
            xbcs.append(xbc)
    return _gated_out(ys, shards, x, mp, d_inner), states, xbcs


def apply_full(params, x, cfg: ArchConfig):
    """Training / prefill over the full sequence: x (b, n, d).  With its
    leaves in ``ModelShards`` it runs tensor-parallel (the module
    docstring)."""
    if any(isinstance(v, arrays.ModelShards) for v in params.values()):
        mp = shctx.model_parallel_state()
        if isinstance(params["a_log"], arrays.ModelShards):
            return _apply_full_tp(params, x, cfg, mp)[0]
        # the rules leave the heads whole: the whole block on the lead shard
        params = _whole_params(params, mp)
    return _forward(params, x, cfg)[0]


def init_state(cfg: ArchConfig, batch: int, dtype=torch.bfloat16,
               device="cuda") -> SSDState:
    s, d_inner, heads, conv_dim = _dims(cfg)
    return SSDState(
        h=torch.zeros((batch, heads, s.head_dim, s.state_dim),
                      dtype=torch.float32, device=device),
        conv=torch.zeros((batch, s.conv_width - 1, conv_dim), dtype=dtype,
                         device=device),
        pos=torch.zeros((), dtype=torch.int32, device=device))


def _whole_params(params, mp) -> dict:
    """Every leaf whole on the lead model shard (the rules leave the heads
    whole)."""
    return {k: arrays.lead_whole(v, mp) if isinstance(v, arrays.ModelShards) else v
            for k, v in params.items()}


def prefill_into_state(params, x, cfg: ArchConfig):
    """Full-sequence output and the state for decode: the final SSD state
    and the last conv_width - 1 raw conv inputs.  With its leaves in
    ``ModelShards`` the state's ``h`` is ``ModelShards`` of each model
    shard's heads and ``conv`` of its even block of the packed columns
    (each whole on every shard where the model axis does not divide it)."""
    cw = cfg.ssd.conv_width
    pos = torch.tensor(x.shape[1], dtype=torch.int32, device=x.device)
    mp = shctx.model_parallel_state()
    if mp is not None and isinstance(params["a_log"], arrays.ModelShards):
        s, _, heads, conv_dim = _dims(cfg)
        hl = heads // mp.tp
        out, states, xbcs = _apply_full_tp(params, x, cfg, mp)
        b = x.shape[0]
        h = arrays.ModelShards(states, 1, arrays.even_bounds(heads, mp.tp),
                               (b, heads, s.head_dim, s.state_dim))
        tails = _conv_columns([t[:, -(cw - 1):].to(x.dtype) for t in xbcs], cfg, hl)
        return out, SSDState(h=h, conv=_tail_blocks(tails, mp, conv_dim), pos=pos)
    if mp is not None:
        params = _whole_params(params, mp)
    out, S_final, xbc_raw = _forward(params, x, cfg)
    h, conv = S_final, xbc_raw[:, -(cw - 1):].to(x.dtype).contiguous()
    if mp is not None:
        h, conv = arrays.cache_blocks(h, mp), arrays.cache_blocks(conv, mp, (2,))
    return out, SSDState(h=h, conv=conv, pos=pos)


def _tail_blocks(tails: arrays.ModelShards, mp, conv_dim: int) -> arrays.ModelShards:
    """The shards' conv tails (``_conv_columns``) regrouped into the
    cache's blocks: even blocks of the packed columns, or the whole tail on
    every shard where the model axis does not divide them."""
    if conv_dim % mp.tp == 0:
        bounds = arrays.even_bounds(conv_dim, mp.tp)
        parts = arrays.take(tails, mp, [[bd] for bd in bounds])
        return arrays.ModelShards([p.contiguous() for p in parts], 2, bounds, tails.shape)
    parts = arrays.take(tails, mp, [[(0, conv_dim)]] * mp.tp)
    return arrays.ModelShards([p.contiguous() for p in parts], None, None, tails.shape)


def apply_decode(params, x, cfg: ArchConfig, state: SSDState):
    """One step of the recurrence: x (b, 1, d).  Writes the new ``h`` and
    conv tail into ``state``'s tensors in place; returns (out, state with
    ``pos`` advanced).  With the state in ``ModelShards``:
    ``_apply_decode_tp``."""
    if isinstance(state.h, arrays.ModelShards):
        return _apply_decode_tp(params, x, cfg, state, shctx.model_parallel_state())
    s, d_inner, heads, conv_dim = _dims(cfg)
    z, xbc, dt = _split_proj(params, x, cfg)
    hist = torch.cat([state.conv, xbc], dim=1)                 # (b, cw, conv_dim)
    xbc_c = F.silu((hist * params["conv_w"][None]).sum(1) + params["conv_b"])
    xh, B, C, dtv, ld = _ssm_inputs(xbc_c[:, None], dt, params, cfg)
    a = torch.exp(ld[:, 0])                                    # (b, h)
    dbx = torch.einsum("bh,bN,bhp->bhpN", dtv[:, 0], B[:, 0].float(),
                       xh[:, 0].float())
    h_new = state.h * a[..., None, None] + dbx
    y = torch.einsum("bN,bhpN->bhp", C[:, 0].float(), h_new)
    y = y + params["d_skip"][None, :, None] * xh[:, 0].float()
    b = x.shape[0]
    y = y.reshape(b, 1, d_inner).to(x.dtype) * F.silu(z)
    y = common.rms_norm(y, params["norm"])
    out = torch.einsum("bse,ed->bsd", y, params["w_out"])
    state.h.copy_(h_new)
    state.conv.copy_(hist[:, 1:])
    return out, state._replace(pos=state.pos + 1)


def _apply_decode_tp(params, x, cfg: ArchConfig, state: SSDState, mp):
    """``apply_decode`` over the model shards of ``mp`` (the module
    docstring); where the rules leave the heads whole, the step on the lead
    shard, its state written back to every shard's blocks."""
    s, d_inner, heads, conv_dim = _dims(cfg)
    if state.h.dim is None:
        h, tail = state.h.parts[0], arrays.lead_whole(state.conv, mp).clone()
        out, _ = apply_decode(_whole_params(params, mp), x, cfg,
                              SSDState(h=h, conv=tail, pos=state.pos))
        arrays.write_back(state.h, h, mp)
        arrays.write_back(state.conv, tail, mp)
        return out, state._replace(pos=state.pos + 1)
    hl = heads // mp.tp
    shards = _shard_params(params, mp, hl, cfg)
    conv = state.conv
    held = conv if conv.dim is not None else arrays.ModelShards(
        conv.parts[:1], 2, [(0, conv_dim)], conv.shape)
    own = arrays.take(held, mp, [_shard_ranges(cfg, t, hl)["conv_w"][1] for t in range(mp.tp)])
    xs = arrays.to_model_shards(x, mp)
    b, p_dim = x.shape[0], s.head_dim
    ys, hists = [], []
    for t in range(mp.tp):
        with mp.on(t):
            p = shards[t]
            z, xbc, dt = torch.split(torch.einsum("bsd,de->bse", xs[t], p["w_in"]),
                                     [hl * p_dim, hl * p_dim + 2 * s.state_dim, hl], dim=-1)
            hist = torch.cat([own[t], xbc], dim=1)
            hists.append(hist)
            xbc_c = F.silu((hist * p["conv_w"][None]).sum(1) + p["conv_b"])
            xh, B, C, dtv, ld = _ssm_inputs(xbc_c[:, None], dt, p, cfg, hl)
            a = torch.exp(ld[:, 0])
            dbx = torch.einsum("bh,bN,bhp->bhpN", dtv[:, 0], B[:, 0].float(),
                               xh[:, 0].float())
            h_new = state.h.parts[t] * a[..., None, None] + dbx
            y = torch.einsum("bN,bhpN->bhp", C[:, 0].float(), h_new)
            y = y + p["d_skip"][None, :, None] * xh[:, 0].float()
            ys.append((y.reshape(b, 1, hl * p_dim).to(x.dtype) * F.silu(z)).float())
            state.h.parts[t].copy_(h_new)
    out = _gated_out(ys, shards, x, mp, d_inner)
    new = _tail_blocks(_conv_columns([h[:, 1:] for h in hists], cfg, hl), mp, conv_dim)
    for t in range(mp.tp):
        with mp.on(t):
            if conv.parts[t].data_ptr() != new.parts[t].data_ptr():
                conv.parts[t].copy_(new.parts[t])
    return out, state._replace(pos=state.pos + 1)
