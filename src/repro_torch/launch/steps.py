"""Step functions (port of ``make_train_step``, ``make_unified_step``,
``make_monolithic_prefill``, ``make_prefill_step``, ``set_cache_positions``
and ``make_serve_step`` from ``repro/launch/steps.py``).  PyTorch runs
eagerly, so each step is a plain closure; the reference's trace counting
has no counterpart here, its ``shard_map`` + ``vmap`` over the serving
mesh becomes a loop over the slot groups (``make_unified_step(smesh=)``),
and the page extract / restore / copy steps are the engine's direct calls
of ``runtime/offload.py`` and ``runtime/paged.py``.  Training runs on one
device."""
from __future__ import annotations

import torch

from repro_torch import optim
from repro_torch.core import policy as policy_lib
from repro_torch.models import attention, mla, transformer
from repro_torch.optim.adamw import tree_leaves, tree_map


def loss_and_grads(bundle, master, batch: dict, *, stem_cfg=None, policies=None,
                   remat: bool = True):
    """(loss, metrics, gradient tree) of ``bundle.loss_fn`` at the fp32
    ``master``: the forward reads every leaf cast to the config's dtype
    (the fp32 embedding and router too, as the reference casts the whole
    tree) and the gradient is taken with respect to the fp32 master,
    through the cast.  A leaf the loss does not reach gets zeros, as under
    JAX's autodiff."""
    cfg = bundle.cfg
    kw = {"policies": policies} if policies else {}
    leaves = [m.detach().requires_grad_() for m in tree_leaves(master)]
    it = iter(leaves)
    params = tree_map(lambda _: next(it).to(cfg.torch_dtype), master)
    loss, metrics = bundle.loss_fn(params, batch, stem_cfg=stem_cfg, remat=remat, **kw)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    git = iter(torch.zeros_like(m) if g is None else g for m, g in zip(leaves, grads))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(git), master))


def make_train_step(bundle, opt_cfg: optim.AdamWConfig, *, stem_cfg=None,
                    policies=None, remat: bool = True, microbatches: int = 1,
                    grad_shardings=None):
    """(opt_state, batch) -> (opt_state, metrics).

    The gradient of each (micro)batch is ``loss_and_grads``'s.  With
    ``microbatches > 1`` the batch splits along its first axis, gradients
    accumulate in fp32 and are divided, and the metrics are the last
    microbatch's.  Then the gradient-compression cast and AdamW on the
    master, in place: the step consumes the state it is given (the returned
    state holds its master, mu and nu tensors, updated).  Metrics: the loss
    function's (``loss``, ``ce``, ``aux``, ``mtp_ce``) and ``lr``,
    ``grad_norm``.  ``grad_shardings`` has no
    one-device meaning: any value but None raises."""
    if grad_shardings is not None:
        raise ValueError("make_train_step: grad_shardings pins gradients to a "
                         "mesh's optimizer shards; the port runs on one device "
                         "(pass None)")

    def grad_of(master, mb):
        return loss_and_grads(bundle, master, mb, stem_cfg=stem_cfg,
                              policies=policies, remat=remat)

    def train_step(opt_state: optim.OptState, batch: dict):
        if microbatches == 1:
            loss, metrics, grads = grad_of(opt_state.master, batch)
        else:
            mbs = [{k: v.reshape((microbatches, v.shape[0] // microbatches)
                                 + tuple(v.shape[1:]))[i] for k, v in batch.items()}
                   for i in range(microbatches)]
            grads = tree_map(torch.zeros_like, opt_state.master)
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(grads)[0].device)
            for mb in mbs:
                l, metrics, g = grad_of(opt_state.master, mb)
                grads = tree_map(torch.add, grads, g)
                loss = loss + l
            grads = tree_map(lambda g: g / microbatches, grads)
            loss = loss / microbatches
        grads = optim.adamw.compress_grads(grads, opt_cfg)
        new_state, opt_metrics = optim.update(grads, opt_state, opt_cfg)
        return new_state, {**metrics, **opt_metrics, "loss": loss}

    return train_step


def make_unified_step(bundle, *, stem_cfg, budget_frac: float = 1.0,
                      chunk_k_max: int = 0, sampler=None, smesh=None):
    """(params, pools, tokens (S, 1), page_table (S, P), cache_lens (S,),
    chunk) -> (decode logits (S, vocab), chunk logits (L, vocab) | None,
    pools), one mixed batch per call (``transformer.paged_mixed_step``).

    With ``sampler`` the step is the async engine's sampled one
    (``transformer.paged_sampled_step``): (params, pools, token_buf
    (S + 1,), dec_mask (S,), page_table, cache_lens, chunk) -> (dec_ids
    (S,), chunk_ids (L,) | None, token_buf, pools); ``chunk`` then also
    carries ``slot`` and ``emit``.

    Every layer reads the paged backend from ``policy.executor`` ("fused" |
    "gather").

    With ``smesh`` (a ``sharding.serving.ServingMesh``; ref
    ``src/repro/launch/steps.py:144-325``) the step drives every slot group
    of the mesh in one call, group after group, where the reference maps
    ``shard_map`` + ``vmap`` over them.  ``params`` is
    ``serving.replicate_params``' ``{device: tree}``, ``pools`` the
    engine's list of one ``serving.HeadShards`` a group, and every batch
    argument gains the reference's leading ``(dp, ...)`` axis: a tensor or
    a sequence indexed by group first (tokens (dp, S, 1), page_table (dp,
    S, P), cache_lens (dp, S), chunk leaves (dp, L, ...); sampled:
    token_buf a sequence of the groups' ``(S + 1,)`` buffers, dec_mask
    (dp, S), ``chunk["slot"]`` group-local).  Group ``g``'s slice moves to
    its lead device ``(g, 0)`` (no copy when it is there already), which
    runs the projections, the MLP and the logits; each attention layer
    runs the group's tp shards on their own devices.  Outputs are
    per-group lists in group order: decode logits (S, vocab) and chunk
    logits (L, vocab) | None, or sampled (S,) / (L,) ids and the groups'
    token buffers."""
    cfg = bundle.cfg
    transformer.assert_paged_servable(cfg)
    policy = policy_lib.as_policy(stem_cfg)
    policy_lib.get_paged_executor(policy.executor)   # unknown names raise now
    if smesh is not None:
        return _mesh_unified_step(cfg, smesh, policy, budget_frac,
                                  chunk_k_max, sampler)

    if sampler is None:
        def unified_step(params, pools, tokens, page_table, cache_lens,
                         chunk=None):
            return transformer.paged_mixed_step(
                params, tokens, pools, page_table, cache_lens, cfg,
                stem_cfg=policy, budget_frac=budget_frac, chunk=chunk,
                chunk_k_max=chunk_k_max)
        return unified_step

    def unified_sampled(params, pools, token_buf, dec_mask, page_table,
                        cache_lens, chunk=None):
        return transformer.paged_sampled_step(
            params, token_buf, pools, page_table, cache_lens, dec_mask, cfg,
            stem_cfg=policy, sampler=sampler, budget_frac=budget_frac,
            chunk=chunk, chunk_k_max=chunk_k_max)
    return unified_sampled


def _mesh_unified_step(cfg, smesh, policy, budget_frac: float,
                       chunk_k_max: int, sampler):
    """``make_unified_step``'s mesh form: one call advances every slot
    group."""
    def group_args(g, chunk):
        dev = smesh.device(g, 0)
        return dev, (None if chunk is None
                     else {k: v[g].to(dev) for k, v in chunk.items()})

    if sampler is None:
        def unified_step(params, pools, tokens, page_table, cache_lens,
                         chunk=None):
            dec, chunks = [], []
            for g in range(smesh.dp):
                dev, ch = group_args(g, chunk)
                d, c, _ = transformer.paged_mixed_step(
                    params[dev], tokens[g].to(dev), pools[g],
                    page_table[g].to(dev), cache_lens[g].to(dev), cfg,
                    stem_cfg=policy, budget_frac=budget_frac, chunk=ch,
                    chunk_k_max=chunk_k_max)
                dec.append(d)
                chunks.append(c)
            return dec, None if chunk is None else chunks, pools
        return unified_step

    def unified_sampled(params, pools, token_buf, dec_mask, page_table,
                        cache_lens, chunk=None):
        dec, chunks = [], []
        for g in range(smesh.dp):
            dev, ch = group_args(g, chunk)
            d, c, _, _ = transformer.paged_sampled_step(
                params[dev], token_buf[g], pools[g], page_table[g].to(dev),
                cache_lens[g].to(dev), dec_mask[g].to(dev), cfg,
                stem_cfg=policy, sampler=sampler, budget_frac=budget_frac,
                chunk=ch, chunk_k_max=chunk_k_max)
            dec.append(d)
            chunks.append(c)
        return dec, None if chunk is None else chunks, token_buf, pools
    return unified_sampled


def make_prefill_step(bundle, *, max_len: int, stem_cfg=None, policies=None):
    """(params, batch) -> (last-position logits, caches): the one-shot
    prefill (``transformer.prefill``)."""
    def prefill_step(params, batch):
        kw = {"policies": policies} if policies else {}
        return bundle.prefill(params, batch, max_len=max_len,
                              stem_cfg=stem_cfg, **kw)
    return prefill_step


def set_cache_positions(caches, cache_lens):
    """Pin every attention / MLA cache's write position to per-sequence
    lengths (``(b,)`` int).  Cache leaves are stacked ``(n_layers, ...)``,
    so the position leaf becomes ``(n_layers, b)`` and each layer reads its
    ``(b,)`` row."""
    def fix(c):
        if isinstance(c, (attention.KVCache, mla.MLACache)):
            lens = torch.as_tensor(cache_lens, dtype=torch.int32,
                                   device=c.pos.device)
            return c._replace(pos=lens.expand((c[0].shape[0],) + lens.shape))
        if isinstance(c, dict):
            return {k: fix(v) for k, v in c.items()}
        if isinstance(c, list):
            return [fix(v) for v in c]
        return c
    return fix(caches)


def make_serve_step(bundle, *, stem_cfg=None, budget_frac: float = 1.0):
    """(params, tokens, caches[, cache_lens]) -> (logits, caches).

    ``cache_lens`` (``(b,)`` int) overrides the caches' write positions per
    sequence — the ragged fixed-batch path: each row decodes against its
    own prompt length.  Positions advance inside the caches afterwards, so
    pass it only on the first step.

    With ``stem_cfg`` the decode is policy-sparse over the contiguous cache
    (``attention.apply_decode`` summarizes + selects every step) — the
    fixed-batch reference arm for the paged engine's sparse decode."""
    def serve_step(params, tokens, caches, cache_lens=None):
        if cache_lens is not None:
            caches = set_cache_positions(caches, cache_lens)
        if stem_cfg is None:
            return bundle.decode_step(params, tokens, caches)
        return bundle.decode_step(params, tokens, caches,
                                  stem_cfg=stem_cfg, budget_frac=budget_frac)
    return serve_step


def make_monolithic_prefill(bundle, *, stem_cfg, sampler=None):
    """(params, tokens (1, Lp), true_len, pools, page_row) -> (next-token
    logits (vocab,), pools) — or, with ``sampler``, (the sampled first
    token id as a 0-d int32 tensor on the device, pools).

    The one-shot admission prefill: one request, right-padded to a page
    multiple, written into the pools with its block summaries
    (``transformer.prefill_kv_pages``).  ``policy.executor`` ("fused" |
    "gather" | "dense") picks the prefill backend."""
    cfg = bundle.cfg
    transformer.assert_paged_servable(cfg)
    policy = policy_lib.as_policy(stem_cfg)
    policy_lib.get_executor(policy.executor)         # unknown names raise now

    def monolithic_prefill(params, tokens, true_len, pools, page_row):
        logits, pools = transformer.prefill_kv_pages(
            params, tokens, true_len, pools, page_row, cfg, policy)
        if sampler is not None:
            return sampler(logits), pools
        return logits, pools
    return monolithic_prefill
