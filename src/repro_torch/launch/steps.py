"""The engine's step functions (port of ``make_unified_step``,
``make_monolithic_prefill`` and ``make_prefill_step`` from
``repro/launch/steps.py``, single device).  PyTorch runs eagerly, so each
step is a plain closure; the reference's trace counting and mesh wrapping
have no counterpart here."""
from __future__ import annotations

from repro_torch.core import policy as policy_lib
from repro_torch.models import transformer


def make_unified_step(bundle, *, stem_cfg, budget_frac: float = 1.0,
                      chunk_k_max: int = 0):
    """(params, pools, tokens (S, 1), page_table (S, P), cache_lens (S,),
    chunk) -> (decode logits (S, vocab), chunk logits (L, vocab) | None,
    pools), one mixed batch per call (``transformer.paged_mixed_step``).

    Every layer reads the paged backend from ``policy.executor`` ("fused" |
    "gather")."""
    cfg = bundle.cfg
    transformer.assert_paged_servable(cfg)
    policy = policy_lib.as_policy(stem_cfg)
    policy_lib.get_paged_executor(policy.executor)   # unknown names raise now

    def unified_step(params, pools, tokens, page_table, cache_lens, chunk=None):
        return transformer.paged_mixed_step(
            params, tokens, pools, page_table, cache_lens, cfg,
            stem_cfg=policy, budget_frac=budget_frac, chunk=chunk,
            chunk_k_max=chunk_k_max)
    return unified_step


def make_prefill_step(bundle, *, max_len: int, stem_cfg=None, policies=None):
    """(params, batch) -> (last-position logits, caches): the one-shot
    prefill (``transformer.prefill``)."""
    def prefill_step(params, batch):
        kw = {"policies": policies} if policies else {}
        return bundle.prefill(params, batch, max_len=max_len,
                              stem_cfg=stem_cfg, **kw)
    return prefill_step


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
