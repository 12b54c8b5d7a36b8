"""The engine's step function (port of ``make_unified_step`` from
``repro/launch/steps.py``, single device, logits out).  PyTorch runs
eagerly, so the step is a plain closure; the reference's trace counting and
mesh wrapping have no counterpart here."""
from __future__ import annotations

from repro_torch.core import policy as policy_lib
from repro_torch.models import transformer


def make_unified_step(bundle, *, stem_cfg, budget_frac: float = 1.0,
                      chunk_k_max: int = 0, executor=None):
    """(params, pools, tokens (S, 1), page_table (S, P), cache_lens (S,),
    chunk) -> (decode logits (S, vocab), chunk logits (L, vocab) | None,
    pools), one mixed batch per call (``transformer.paged_mixed_step``).

    ``executor`` ("fused" | "gather"; None keeps ``policy.executor``) is
    written into the policy here, once; every layer below reads the paged
    backend from the policy."""
    cfg = bundle.cfg
    transformer.assert_paged_servable(cfg)
    policy = policy_lib.as_policy(stem_cfg)
    if executor is not None:
        policy = policy.with_updates(executor=executor)
    policy_lib.get_paged_executor(policy.executor)   # unknown names raise now

    def unified_step(params, pools, tokens, page_table, cache_lens, chunk=None):
        return transformer.paged_mixed_step(
            params, tokens, pools, page_table, cache_lens, cfg,
            stem_cfg=policy, budget_frac=budget_frac, chunk=chunk,
            chunk_k_max=chunk_k_max)
    return unified_step
