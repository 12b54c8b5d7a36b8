"""Whisper-style encoder-decoder backbone (port of
``repro/models/encdec.py``).

The audio conv frontend is a stub: callers pass precomputed frame
embeddings (batch, frames, d_model).  The encoder is bidirectional
self-attention (+ sinusoidal positions); the decoder is a causal LM with
cross-attention (+ a learned position table of 65536 rows).  A sparsity
policy applies to the decoder's self-attention prefill only: the encoder
has no causal information-flow asymmetry, and cross-attention sees a fixed
small source.

Semantics of the reference that the port keeps: ``prefill`` applies RoPE
to the decoder's self-attention (``prefill_into_cache``'s default), while
``loss_fn`` and ``decode_step`` do not, so decode after ``prefill(n)`` is
not ``prefill(n + 1)``.

Parameters keep the reference's tree: ``embed``, ``dec_pos``,
``enc_layers`` / ``dec_layers`` (leaves stacked along a leading layer
axis), ``enc_norm`` and ``final_norm``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention, common, mlp
from repro_torch.models.transformer import _index, _remat, _stack

MAX_DEC_POS = 65536   # rows of the learned decoder position table


class DecLayerCache(NamedTuple):
    self_cache: attention.KVCache
    cross_k: torch.Tensor
    cross_v: torch.Tensor


def _init_enc_layer(ini, cfg: ArchConfig) -> dict:
    return {
        "norm1": ini.zeros((cfg.d_model,)),
        "attn": attention.init(ini, cfg),
        "norm2": ini.zeros((cfg.d_model,)),
        "ffn": mlp.init(ini, cfg.d_model, cfg.d_ff, "gelu_mlp"),
    }


def _init_dec_layer(ini, cfg: ArchConfig) -> dict:
    return {
        "norm1": ini.zeros((cfg.d_model,)),
        "self_attn": attention.init(ini, cfg),
        "norm2": ini.zeros((cfg.d_model,)),
        "cross_attn": attention.init_cross(ini, cfg),
        "norm3": ini.zeros((cfg.d_model,)),
        "ffn": mlp.init(ini, cfg.d_model, cfg.d_ff, "gelu_mlp"),
    }


def init_params(generator: torch.Generator, cfg: ArchConfig, device="cuda") -> dict:
    """Random parameters with the reference's tree, shapes and scales,
    drawn from ``generator`` on ``device`` into the stacked tensors."""
    ini = common.Initializer(generator, cfg.torch_dtype, device)
    return {
        "embed": common.embed_init(ini, cfg.padded_vocab, cfg.d_model),
        "dec_pos": ini.normal((MAX_DEC_POS, cfg.d_model), scale=0.01),
        "enc_layers": ini.stacked(cfg.encdec.encoder_layers,
                                  lambda: _init_enc_layer(ini, cfg)),
        "enc_norm": ini.zeros((cfg.d_model,)),
        "dec_layers": ini.stacked(cfg.num_layers, lambda: _init_dec_layer(ini, cfg)),
        "final_norm": ini.zeros((cfg.d_model,)),
    }


def _layers(stacked: dict, n: int):
    """The per-layer views of a stacked layer tree."""
    return (_index(stacked, i) for i in range(n))


def encode(params, frames, cfg: ArchConfig, *, remat: bool = True):
    """frames: (b, F, d) stub embeddings -> (b, F, d) encoder states."""
    dtype = cfg.torch_dtype
    n = frames.shape[1]
    pos = common.sinusoidal_positions(n, cfg.d_model, device=frames.device)
    x = frames.to(dtype) + pos.to(dtype)
    positions = torch.arange(n, device=frames.device)

    def body(layer, x):
        h = common.layer_norm_simple(x, layer["norm1"])
        x = x + attention.apply_full(layer["attn"], h, cfg, positions=positions,
                                     use_rope=False, causal=False)
        h = common.layer_norm_simple(x, layer["norm2"])
        return x + mlp.apply(layer["ffn"], h, "gelu_mlp")

    body = _remat(body, remat)
    for layer in _layers(params["enc_layers"], cfg.encdec.encoder_layers):
        x = body(layer, x)
    return common.layer_norm_simple(x, params["enc_norm"])


def _dec_embed(params, tokens, cfg: ArchConfig, start=0):
    """Token embeddings plus the learned positions from ``start`` (clamped
    into the table, as the reference's ``dynamic_slice`` does)."""
    x = common.embed_lookup(params["embed"], tokens, cfg.torch_dtype)
    n = tokens.shape[1]
    start = min(max(int(start), 0), MAX_DEC_POS - n)
    return x + params["dec_pos"][start:start + n][None].to(cfg.torch_dtype)


def _cross_ffn(layer, x, ck, cv, cfg: ArchConfig):
    """The decoder layer after self-attention: cross-attention over the
    encoder's K/V, then the FFN."""
    h = common.layer_norm_simple(x, layer["norm2"])
    x = x + attention.apply_cross(layer["cross_attn"], h, ck, cv, cfg.head_dim)
    h = common.layer_norm_simple(x, layer["norm3"])
    return x + mlp.apply(layer["ffn"], h, "gelu_mlp")


def loss_fn(params, batch: dict, cfg: ArchConfig, *, stem_cfg=None,
            remat: bool = True):
    """batch: frames (b, F, d), tokens (b, s), labels (b, s), optional
    loss_mask.  Differentiable; ``remat`` recomputes each encoder and
    decoder layer in the backward pass.  Returns (ce, {"ce", "loss"})."""
    enc = encode(params, batch["frames"], cfg, remat=remat)
    x = _dec_embed(params, batch["tokens"], cfg)
    positions = torch.arange(batch["tokens"].shape[1], device=x.device)

    def body(layer, x, enc):
        h = common.layer_norm_simple(x, layer["norm1"])
        x = x + attention.apply_full(layer["self_attn"], h, cfg,
                                     positions=positions, stem_cfg=stem_cfg,
                                     use_rope=False)
        return _cross_ffn(layer, x, *attention.cross_kv(layer["cross_attn"], enc), cfg)

    body = _remat(body, remat)
    for layer in _layers(params["dec_layers"], cfg.num_layers):
        x = body(layer, x, enc)
    x = common.layer_norm_simple(x, params["final_norm"])
    logits = common.lm_logits(x, params["embed"])
    ce = common.cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
    return ce, {"ce": ce, "loss": ce}


@torch.no_grad()
def prefill(params, batch: dict, cfg: ArchConfig, *, max_len: int,
            stem_cfg=None):
    """Encode, then run the decoder prompt (self-attention with RoPE, as the
    reference's prefill does).  Returns (last-position logits (b, vocab),
    DecLayerCache with leaves stacked (n_layers, ...))."""
    enc = encode(params, batch["frames"], cfg)
    x = _dec_embed(params, batch["tokens"], cfg)
    positions = torch.arange(batch["tokens"].shape[1], device=x.device)
    caches = []
    for layer in _layers(params["dec_layers"], cfg.num_layers):
        h = common.layer_norm_simple(x, layer["norm1"])
        sa, cache = attention.prefill_into_cache(
            layer["self_attn"], h, cfg, positions=positions, max_len=max_len,
            stem_cfg=stem_cfg)
        ck, cv = attention.cross_kv(layer["cross_attn"], enc)
        x = _cross_ffn(layer, x + sa, ck, cv, cfg)
        caches.append(DecLayerCache(self_cache=cache, cross_k=ck, cross_v=cv))
    x = common.layer_norm_simple(x, params["final_norm"])
    return common.lm_logits(x[:, -1:], params["embed"])[:, 0], _stack(caches)


@torch.no_grad()
def decode_step(params, tokens, caches: DecLayerCache, cfg: ArchConfig):
    """One token for every sequence: tokens (b, 1).  Each layer writes its
    token's K/V into its view of the stacked self-attention cache in place.
    Returns (logits (b, vocab), caches with ``pos`` advanced)."""
    x = _dec_embed(params, tokens, cfg, start=caches.self_cache.pos[0])
    new_pos = []
    for li, layer in enumerate(_layers(params["dec_layers"], cfg.num_layers)):
        h = common.layer_norm_simple(x, layer["norm1"])
        view = attention.KVCache(*(leaf[li] for leaf in caches.self_cache))
        sa, view = attention.apply_decode(layer["self_attn"], h, cfg, view,
                                          use_rope=False)
        new_pos.append(view.pos)
        x = _cross_ffn(layer, x + sa, caches.cross_k[li], caches.cross_v[li], cfg)
    x = common.layer_norm_simple(x, params["final_norm"])
    caches = caches._replace(
        self_cache=caches.self_cache._replace(pos=torch.stack(new_pos)))
    return common.lm_logits(x, params["embed"])[:, 0], caches


def init_caches(cfg: ArchConfig, batch: int, max_len: int, frames: int,
                device="cuda") -> DecLayerCache:
    """Zeroed caches, leaves stacked (n_layers, ...)."""
    dtype = cfg.torch_dtype
    cross = torch.zeros((batch, cfg.num_heads, frames, cfg.head_dim), dtype=dtype,
                        device=device)
    one = DecLayerCache(
        self_cache=attention.init_cache(cfg, batch, max_len, dtype=dtype, device=device),
        cross_k=cross, cross_v=cross)
    return _stack([one] * cfg.num_layers)
