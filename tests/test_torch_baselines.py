"""The paper's comparison baselines in the port (``repro_torch.core.
baselines``) against the reference's ``repro.core.baselines``: the
selections of uniform-sam, streaming and xattention (indices, slot masks,
live counts, block masks and budgets exactly equal, at a GQA and an MHA
geometry), the policies each name resolves to, and ``baseline_attention``'s
output (within 1e-4, the reference suites' fp32 tolerance) and realized
density (exactly equal) on the same numpy-seeded q / k / v."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import baselines as j_base
from repro.core.config import StemConfig as JStem

from repro_torch.core import baselines as t_base
from repro_torch.core.config import StemConfig as TStem

torch.set_num_threads(1)

TOL = 1e-4
GEOMETRY = dict(block_size=64, sink_blocks=1, local_blocks=1,
                min_budget_blocks=1, stride=8)


def _qkv(seed, b, hq, hk, n, d):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, h, n, d).astype(np.float32) for h in (hq, hk, hk))


def _both(arrays):
    return ([jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays])


def _same_selection(got, want):
    for field in ("indices", "slot_mask", "block_mask", "budgets", "live_counts"):
        g, w = getattr(got, field), getattr(want, field)
        assert (g is None) == (w is None), field
        if w is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=field)


@pytest.mark.parametrize("heads", [(2, 2), (4, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("k_uni", [None, 3], ids=["budget-matched", "k3"])
def test_uniform_sam_selection_matches(heads, k_uni):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(0, 1, *heads, 512, 32))
    kw = dict(GEOMETRY, k_start_frac=0.4)
    _same_selection(t_base.uniform_sam_selection(tq, tk, tv, TStem(**kw), k_uni=k_uni),
                    j_base.uniform_sam_selection(jq, jk, jv, JStem(**kw), k_uni=k_uni))


@pytest.mark.parametrize("sink,local", [(2, 2), (1, 3), (0, 1)])
def test_streaming_selection_matches(sink, local):
    _same_selection(t_base.streaming_selection(16, 16, 1, 2, sink, local, device="cpu"),
                    j_base.streaming_selection(16, 16, 1, 2, sink, local))


@pytest.mark.parametrize("heads", [(2, 2), (4, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("tau", [0.5, 0.9, 0.999999])
def test_xattention_selection_matches(heads, tau):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, 1, *heads, 512, 32))
    _same_selection(
        t_base.xattention_like_selection(tq, tk, tv, TStem(**GEOMETRY), tau=tau),
        j_base.xattention_like_selection(jq, jk, jv, JStem(**GEOMETRY), tau=tau))


@pytest.mark.parametrize("method", ["uniform_sam", "streaming", "xattention"])
def test_baseline_policy_matches(method):
    """Each name resolves to the reference's composition, field for field
    (the port's executor names "fused" / "gather" stand for the
    reference's "pallas" / "xla")."""
    kw = dict(GEOMETRY, k_start_frac=0.4)
    got = t_base.baseline_policy(TStem(**kw), method)
    want = j_base.baseline_policy(JStem(**kw), method)
    for part in ("metric", "schedule", "selector"):
        g, w = getattr(got, part), getattr(want, part)
        assert type(g).__name__ == type(w).__name__
        assert g.__dict__ == w.__dict__, part
    for field in ("block_size", "group_reduce", "ragged", "name"):
        assert getattr(got, field) == getattr(want, field), field
    with pytest.raises(ValueError, match="unknown baseline"):
        t_base.baseline_policy(TStem(**kw), "oracle")


@pytest.mark.parametrize("method", ["uniform_sam", "streaming", "xattention"])
def test_baseline_attention_matches(method):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, 2, 4, 2, 512, 32))
    kw = dict(GEOMETRY, k_start_frac=0.4)
    jout, jd = j_base.baseline_attention(jq, jk, jv, JStem(**kw), method=method)
    tout, td = t_base.baseline_attention(tq, tk, tv, TStem(**kw), method=method)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=TOL, rtol=0)
    assert float(td) == float(jd)
    assert 0.0 < float(td) <= 1.0


def test_uniform_budgets_match():
    np.testing.assert_array_equal(t_base.uniform_budgets(8, 12, 3, device="cpu").numpy(),
                                  np.asarray(j_base.uniform_budgets(8, 12, 3)))
