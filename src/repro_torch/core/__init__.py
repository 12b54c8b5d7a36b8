"""Stem core of the port: composable sparsity policies (metric x schedule x
selector) over Token Position-Decay + Output-Aware Metric sparse attention,
and the decode / chunked-prefill stages of the paged serving lanes.

The reference's public names (``repro.core``), name for name
(``schedule.budgets_as_tensor``, the counterpart of ``budgets_as_jax``,
stays in its module as the reference's does):

    from repro_torch.core import StemConfig, stem_attention
"""
from repro_torch.core.config import StemConfig, uniform_equivalent_budget
from repro_torch.core.schedule import (
    average_budget,
    cost_decay,
    cost_uniform,
    max_budget_blocks,
    measured_cost_tokens,
    schedule_for,
    tpd_budget_blocks,
    tpd_budget_tokens,
)
from repro_torch.core.metric import oam_metric, routing_scores, value_block_magnitude
from repro_torch.core.policy import (
    CumulativeMassSelector,
    DenseSchedule,
    OutputAwareMetric,
    RoutingMetric,
    SinkLocalSchedule,
    SparsityPolicy,
    StreamingMetric,
    TPDSchedule,
    TopKSelector,
    UniformSchedule,
    as_policy,
    available_executors,
    available_policies,
    get_executor,
    get_policy,
    policy_from_config,
    register_executor,
    register_metric,
    register_policy,
    register_schedule,
    register_selector,
)
from repro_torch.core.selection import (
    BlockSelection,
    DecodeSelection,
    RaggedSegment,
    budget_sorted_segments,
    revisit_indices,
    select_blocks,
    selection_density,
)
from repro_torch.core.sparse_attention import (
    StemStats,
    dense_attention,
    sparse_attention,
    stem_attention,
)

__all__ = [
    "StemConfig",
    "uniform_equivalent_budget",
    "tpd_budget_tokens",
    "tpd_budget_blocks",
    "schedule_for",
    "max_budget_blocks",
    "cost_uniform",
    "cost_decay",
    "measured_cost_tokens",
    "average_budget",
    "oam_metric",
    "routing_scores",
    "value_block_magnitude",
    "BlockSelection",
    "DecodeSelection",
    "RaggedSegment",
    "budget_sorted_segments",
    "revisit_indices",
    "select_blocks",
    "selection_density",
    "stem_attention",
    "sparse_attention",
    "dense_attention",
    "StemStats",
    # policy API
    "SparsityPolicy",
    "OutputAwareMetric",
    "RoutingMetric",
    "StreamingMetric",
    "TPDSchedule",
    "UniformSchedule",
    "DenseSchedule",
    "SinkLocalSchedule",
    "TopKSelector",
    "CumulativeMassSelector",
    "as_policy",
    "policy_from_config",
    "register_policy",
    "get_policy",
    "available_policies",
    "register_metric",
    "register_schedule",
    "register_selector",
    "register_executor",
    "get_executor",
    "available_executors",
]
