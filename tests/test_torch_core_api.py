"""The port's public API against the reference's: the package exports of
``repro_torch.core`` / ``runtime`` / ``sharding`` name for name and kind
for kind, the TPD schedules and the cost model of Eqs. (2)-(4) bitwise
equal on drawn cases, ``oam_metric`` within 1e-5, the policy protocols
held by every built-in, and a user-written metric, registered in both
packages, selecting identically through ``sparse_attention``."""
import dataclasses
import inspect

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # degrade to fixed-seed parametrized sampling
    from _hypothesis_compat import given, settings, st

import jax.numpy as jnp

import repro.core as j_core
import repro.runtime as j_runtime
import repro.sharding as j_sharding
from repro.core import config as j_config
from repro.core import metric as j_metric
from repro.core import policy as j_policy
from repro.core import schedule as j_schedule

import repro_torch.core as t_core
import repro_torch.runtime as t_runtime
import repro_torch.sharding as t_sharding
from repro_torch.core import config as t_config
from repro_torch.core import metric as t_metric
from repro_torch.core import policy as t_policy
from repro_torch.core import schedule as t_schedule

torch.set_num_threads(1)

RENAMED = {"budgets_as_jax": "budgets_as_tensor"}
BLOCK_SIZES = (8, 16, 32, 64, 128)
# sparse_segment drawn by index: None or a (lo, hi) of the Fig. 3 overlay
SEGMENTS = (None, (0.0, 0.5), (0.25, 0.75), (0.5, 1.0))


def _kind(obj) -> str:
    return "class" if inspect.isclass(obj) else "function" if callable(obj) else "value"


@pytest.mark.parametrize("ref,port", [(j_core, t_core), (j_runtime, t_runtime),
                                      (j_sharding, t_sharding)],
                         ids=["core", "runtime", "sharding"])
def test_package_exports_match_reference(ref, port):
    """The same ``__all__`` (budgets_as_jax -> budgets_as_tensor), each
    name reachable (the runtime's heavy names through ``__getattr__``) and
    of the reference's kind."""
    want = [RENAMED.get(n, n) for n in ref.__all__]
    assert list(port.__all__) == want
    for ref_name, name in zip(ref.__all__, port.__all__):
        assert _kind(getattr(port, name)) == _kind(getattr(ref, ref_name)), name
    with pytest.raises(AttributeError):
        getattr(port, "no_such_name")


def test_schedule_module_names_match_reference():
    """Every public function of the reference's ``core/schedule.py`` has its
    counterpart of the same name (``budgets_as_tensor`` for ``budgets_as_jax``)."""
    def public(mod):
        return {n for n, f in vars(mod).items() if inspect.isfunction(f)
                and not n.startswith("_") and f.__module__ == mod.__name__}
    assert {RENAMED.get(n, n) for n in public(j_schedule)} == public(t_schedule)


def _same(got, want):
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert type(got) is type(want) and got == want, (got, want)


@given(seq_len=st.integers(1, 6000), kv_extra=st.integers(0, 3000),
       k_start=st.integers(1, 2048), mu=st.floats(0.05, 1.0),
       block=st.integers(0, len(BLOCK_SIZES) - 1), min_budget=st.integers(0, 64),
       segment=st.integers(0, len(SEGMENTS) - 1), frac=st.floats(0.0, 0.6))
@settings(max_examples=150, deadline=None)
def test_schedules_and_costs_bitwise(seq_len, kv_extra, k_start, mu, block, min_budget,
                                     segment, frac):
    """Eq. (3)'s token budgets, the block schedules, ``schedule_for`` /
    ``max_budget_blocks`` (a key grid at or past the query grid; a fixed
    or the length-rule k_start; each sparse segment) and the cost model
    bitwise equal to the reference's, dtypes included."""
    bs, kv_len = BLOCK_SIZES[block], seq_len + kv_extra
    nq, nk = -(-seq_len // bs), -(-kv_len // bs)
    for name, args, kw in (
            ("tpd_budget_tokens", (seq_len, k_start, mu), {}),
            ("tpd_budget_blocks", (nq, nk, k_start // bs + 1, mu),
             dict(min_budget_blocks=min_budget)),
            ("uniform_budget_blocks", (nq, nk, k_start // bs + 1), {}),
            ("dense_budget_blocks", (nq, nk), {}),
            ("sink_local_budget_blocks", (nq, nk, min_budget % 5, min_budget % 7), {}),
            ("cost_uniform", (seq_len, k_start), {}),
            ("cost_decay", (seq_len, k_start, mu), {}),
            ("measured_cost_tokens", (seq_len, k_start, mu), {})):
        _same(getattr(t_schedule, name)(*args, **kw), getattr(j_schedule, name)(*args, **kw))

    knobs = dict(block_size=bs, stride=8, mu=mu, min_budget_blocks=min_budget,
                 k_start_frac=frac if frac > 0.05 else None,
                 sparse_segment=SEGMENTS[segment])
    t_cfg, j_cfg = t_config.StemConfig(**knobs), j_config.StemConfig(**knobs)
    for kv in (None, kv_len):
        budgets = t_schedule.schedule_for(t_cfg, seq_len, kv)
        want = j_schedule.schedule_for(j_cfg, seq_len, kv)
        _same(budgets, want)
        _same(t_schedule.max_budget_blocks(t_cfg, seq_len, kv),
              j_schedule.max_budget_blocks(j_cfg, seq_len, kv))
        _same(t_schedule.measured_cost_blocks(budgets, bs),
              j_schedule.measured_cost_blocks(want, bs))
        _same(t_schedule.average_budget(budgets), j_schedule.average_budget(want))
        as_t = t_schedule.budgets_as_tensor(budgets)
        assert as_t.dtype == torch.int32 and as_t.device.type == "cpu"
        np.testing.assert_array_equal(as_t.numpy(),
                                      np.asarray(j_schedule.budgets_as_jax(want)))


@pytest.mark.parametrize("metric", ["oam", "sam"])
@pytest.mark.parametrize("pooling", ["antidiag", "mean"])
def test_oam_metric_matches_reference(metric, pooling):
    """``oam_metric`` within 1e-5 of the reference's, fp32, GQA 4 / 2, with
    "sam" zeroing the value term in both."""
    rng = np.random.RandomState(3)
    q = rng.randn(2, 4, 128, 16).astype(np.float32)
    k, v = (rng.randn(2, 2, 128, 16).astype(np.float32) for _ in range(2))
    v[:, :, 40:44] *= 8.0
    knobs = dict(block_size=16, stride=4, beta=0.3, metric=metric, pooling=pooling)
    got = t_metric.oam_metric(*(torch.from_numpy(x) for x in (q, k, v)),
                              t_config.StemConfig(**knobs))
    want = np.asarray(j_metric.oam_metric(*(jnp.asarray(x) for x in (q, k, v)),
                                          j_config.StemConfig(**knobs)))
    assert got.shape == want.shape == (2, 4, 8, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    route = t_metric.routing_scores(*(torch.from_numpy(x) for x in (q, k)),
                                    t_config.StemConfig(**knobs))
    assert torch.equal(got, route) == (metric == "sam")


@pytest.mark.parametrize("protocol,builtins", [
    ("BlockMetric", ("OutputAwareMetric", "RoutingMetric", "StreamingMetric")),
    ("BudgetSchedule", ("TPDSchedule", "UniformSchedule", "DenseSchedule",
                        "SinkLocalSchedule")),
    ("Selector", ("TopKSelector", "CumulativeMassSelector")),
])
def test_builtins_satisfy_their_protocol(protocol, builtins):
    """Each built-in is an instance of its ``runtime_checkable`` protocol,
    as in the reference, and of no other; the policies' components too."""
    proto = getattr(t_policy, protocol)
    others = [getattr(t_policy, p) for p in ("BlockMetric", "BudgetSchedule", "Selector")
              if p != protocol]
    for name in builtins:
        obj = getattr(t_policy, name)()
        assert isinstance(obj, proto), name
        assert isinstance(getattr(j_policy, name)(), getattr(j_policy, protocol)), name
        assert not any(isinstance(obj, o) for o in others), name
    assert not isinstance(object(), proto)
    field = {"BlockMetric": "metric", "BudgetSchedule": "schedule",
             "Selector": "selector"}[protocol]
    for name in t_policy.available_policies():
        assert isinstance(getattr(t_policy.get_policy(name), field), proto), name


@dataclasses.dataclass(frozen=True)
class TorchPositionBonusMetric:
    """A user's metric: the routing score plus ``bonus`` times the key
    block's position in [0, 1) (later blocks favoured)."""
    bonus: float = 0.5
    stride: int = 4

    def _bonus(self, n, like):
        return self.bonus * torch.arange(n, dtype=torch.float32, device=like.device) / n

    def prefill_scores(self, q, k, v, *, block_size: int):
        route = t_metric.blockwise_routing_scores(q, k, block_size=block_size,
                                                  stride=self.stride)
        return route + self._bonus(route.shape[-1], route)

    def decode_scores(self, q, k_groups, v_mag):
        route = t_metric.decode_routing_scores(q, k_groups)
        return route + self._bonus(route.shape[-1], route)

    def chunk_scores(self, q, k_groups, v_mag, *, block_size: int):
        route = t_metric.chunk_routing_scores(q, k_groups, block_size=block_size)
        return route + self._bonus(route.shape[-1], route)


@dataclasses.dataclass(frozen=True)
class JaxPositionBonusMetric:
    """The same metric written against the reference."""
    bonus: float = 0.5
    stride: int = 4

    def _bonus(self, n):
        return self.bonus * jnp.arange(n, dtype=jnp.float32) / n

    def prefill_scores(self, q, k, v, *, block_size: int):
        route = j_metric.blockwise_routing_scores(q, k, block_size=block_size,
                                                  stride=self.stride)
        return route + self._bonus(route.shape[-1])

    def decode_scores(self, q, k_groups, v_mag):
        route = j_metric.decode_routing_scores(q, k_groups)
        return route + self._bonus(route.shape[-1])

    def chunk_scores(self, q, k_groups, v_mag, *, block_size: int):
        route = j_metric.chunk_routing_scores(q, k_groups, block_size=block_size)
        return route + self._bonus(route.shape[-1])


@pytest.fixture
def user_metric_name():
    name = "test-position-bonus"
    yield name
    for lib in (t_policy, j_policy):
        lib._METRICS.pop(name, None)


def test_user_metric_selects_identically(user_metric_name):
    """A metric that is none of the built-ins, registered with
    ``register_metric`` in both packages and composed with the TPD
    schedule and top-k: ``prefill_select``'s selections (indices, slot
    masks, live counts, budgets) exactly equal, and ``sparse_attention``
    under the "gather" executor ("xla" in the reference) within 1e-4 with
    the same density."""
    t_core.register_metric(user_metric_name, TorchPositionBonusMetric())
    j_core.register_metric(user_metric_name, JaxPositionBonusMetric())
    rng = np.random.RandomState(5)
    q = rng.randn(1, 4, 256, 16).astype(np.float32)
    k, v = (rng.randn(1, 2, 256, 16).astype(np.float32) for _ in range(2))
    policies = []
    for lib, executor in ((t_policy, "gather"), (j_policy, "xla")):
        metric = lib.get_metric(user_metric_name)
        assert isinstance(metric, lib.BlockMetric)
        policies.append(lib.SparsityPolicy(
            metric=metric, schedule=lib.TPDSchedule(mu=0.5, min_budget_blocks=2,
                                                    k_start_frac=0.4),
            selector=lib.TopKSelector(sink_blocks=1, local_blocks=1),
            block_size=16, executor=executor))
    t_pol, j_pol = policies
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    (t_sel, t_kmax), (j_sel, j_kmax) = (t_pol.prefill_select(tq, tk, tv),
                                        j_pol.prefill_select(jq, jk, jv))
    assert t_kmax == j_kmax
    for field in ("indices", "slot_mask", "live_counts", "budgets"):
        np.testing.assert_array_equal(getattr(t_sel, field).numpy(),
                                      np.asarray(getattr(j_sel, field)), err_msg=field)
    assert not np.array_equal(  # the bonus moved the selection off plain routing
        t_sel.indices.numpy(), t_policy.get_policy("stem-sam").with_updates(
            ignore_missing=True, block_size=16, stride=4, min_budget_blocks=2,
            sink_blocks=1, local_blocks=1, mu=0.5, k_start_frac=0.4)
        .prefill_select(tq, tk, tv)[0].indices.numpy())
    t_out, t_stats = t_core.sparse_attention(tq, tk, tv, t_pol, return_stats=True)
    j_out, j_stats = j_core.sparse_attention(jq, jk, jv, j_pol, return_stats=True)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=1e-4, rtol=0)
    assert float(t_stats.density) == float(j_stats.density)
