"""The port's evaluation passes and untied LM heads against the JAX
reference: ``loss_fn`` (with and without ``loss_mask``),
``forward_hiddens`` (every layer's residual) and ``forward_with_stats``
(per-layer records and realized density) under "stem", "uniform-sam",
dense and a per-layer ``policies`` override; then the dense configs with an
untied head or other widths (reduced ``qwen1.5-4b``: QKV bias, MHA;
reduced ``glm4-9b``: GQA group 4, and its widths at 16 query / 1 KV head
for group 16; reduced ``gemma-2b``: GeGLU, embedding scale, MQA): prefill
logits, one engine trace's streams, ``loss_fn`` and the ``head`` leaf's
round trip in fp32.  Weights carried from JAX ``init_params``; fp32
within 1e-4, ids and records exact."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as j_configs
from repro.core import policy as j_policy
from repro.models import registry as j_registry
from repro.models import transformer as j_transformer
from repro.runtime import engine as j_engine

from repro_torch import configs as t_configs
from repro_torch.core import policy as t_policy
from repro_torch.models import registry as t_registry
from repro_torch.models import transformer as t_transformer
from repro_torch.runtime import engine as t_engine
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)

TOL = 1e-4
T = torch.from_numpy
POLICY_KW = dict(block_size=16, stride=4, sink_blocks=1, local_blocks=1,
                 min_budget_blocks=2, ignore_missing=True)


def _configs(arch, **widths):
    jcfg = j_configs.reduced(j_configs.get_config(arch)).replace(dtype="float32", **widths)
    tcfg = t_configs.reduced(t_configs.get_config(arch)).replace(dtype="float32", **widths)
    return jcfg, tcfg


def _build(jcfg, tcfg, seed=0):
    jb, tb = j_registry.build(jcfg), t_registry.build(tcfg)
    jparams = jb.init_params(jax.random.PRNGKey(seed))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jb, jparams, tb, tparams


@pytest.fixture(scope="module")
def qwen():
    jcfg, tcfg = _configs("qwen3-0.6b")
    return (jcfg, tcfg) + _build(jcfg, tcfg)


def _batch(seed, b=2, s=64, vocab=512, masked=False):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, vocab, size=(b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if masked:
        batch["loss_mask"] = (rng.rand(b, s) > 0.3).astype(np.float32)
    return batch


def _policy_pair(name):
    if name is None:
        return None, None
    return (j_policy.get_policy(name).with_updates(**POLICY_KW),
            t_policy.get_policy(name).with_updates(**POLICY_KW))


ARMS = ["stem", "uniform-sam", None, "override"]


def _arm(name):
    """(JAX kwargs, port kwargs): a base policy, or "override" — stem on
    layer 0 and uniform-sam on layer 1 over a dense base."""
    if name == "override":
        (js, ts), (ju, tu) = _policy_pair("stem"), _policy_pair("uniform-sam")
        return ({"stem_cfg": None, "policies": {0: js, 1: ju}},
                {"stem_cfg": None, "policies": {0: ts, 1: tu}})
    jp, tp = _policy_pair(name)
    return {"stem_cfg": jp}, {"stem_cfg": tp}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("arm", ARMS)
def test_loss_fn_matches(qwen, arm, masked):
    jcfg, tcfg, jb, jparams, tb, tparams = qwen
    jkw, tkw = _arm(arm)
    batch = _batch(1, masked=masked)
    jloss, jm = jb.loss_fn(jparams, jax.tree.map(jnp.asarray, batch), remat=False, **jkw)
    tloss, tm = tb.loss_fn(tparams, {k: T(v) for k, v in batch.items()}, remat=True, **tkw)
    assert set(tm) == set(jm)
    for key in jm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), atol=TOL, rtol=0)
    np.testing.assert_allclose(float(tloss), float(jloss), atol=TOL, rtol=0)


@pytest.mark.parametrize("arm", ["stem", "uniform-sam", None])
def test_forward_hiddens_matches(qwen, arm):
    jcfg, tcfg, _, jparams, _, tparams = qwen
    jkw, tkw = _arm(arm)
    batch = _batch(2)
    jl, jh = j_transformer.forward_hiddens(jparams, {"tokens": jnp.asarray(batch["tokens"])},
                                           jcfg, **jkw)
    tl, th = t_transformer.forward_hiddens(tparams, {"tokens": T(batch["tokens"])},
                                           tcfg, **tkw)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    assert len(th) == len(jh)
    for t, j in zip(th, jh):
        assert tuple(t.shape) == j.shape == (tcfg.num_layers, 2, 64, tcfg.d_model)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL, rtol=0)


@pytest.mark.parametrize("arm", ARMS)
def test_forward_with_stats_matches(qwen, arm):
    jcfg, tcfg, _, jparams, _, tparams = qwen
    jkw, tkw = _arm(arm)
    batch = _batch(3)
    jl, jrec = j_transformer.forward_with_stats(
        jparams, {"tokens": jnp.asarray(batch["tokens"])}, jcfg, **jkw)
    tl, trec = t_transformer.forward_with_stats(
        tparams, {"tokens": T(batch["tokens"])}, tcfg, **tkw)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    assert [(r["layer"], r["kind"], r["policy"]) for r in trec] == \
        [(r["layer"], r["kind"], r["policy"]) for r in jrec]
    for t, j in zip(trec, jrec):
        assert (t["stats"] is None) == (j["stats"] is None)
        if j["stats"] is not None:
            np.testing.assert_allclose(float(t["stats"].density),
                                       float(j["stats"].density), atol=TOL, rtol=0)
            np.testing.assert_allclose(float(t["stats"].avg_budget_blocks),
                                       float(j["stats"].avg_budget_blocks),
                                       atol=TOL, rtol=0)
            assert t["stats"].k_max == j["stats"].k_max
    if arm is not None:
        assert any(r["stats"] is not None for r in trec)


def test_loss_fn_rejects_mtp(qwen):
    """The multi-token-prediction loss (ported with deepseek-v3-671b) needs
    the MTP head's parameters: on a tree without them, ``mtp=True`` is
    rejected with the reference's KeyError; on the dense qwen3 built with
    ``mtp=True`` (head included), ce / mtp_ce / loss equal the
    reference's within 1e-4."""
    jcfg, tcfg, _, jparams, _, tparams = qwen
    batch = _batch(0)
    with pytest.raises(KeyError, match="mtp_norm"):
        t_transformer.loss_fn(tparams, {k: T(v) for k, v in batch.items()},
                              tcfg.replace(mtp=True))
    with pytest.raises(KeyError, match="mtp_norm"):
        j_transformer.loss_fn(jparams, jax.tree.map(jnp.asarray, batch),
                              jcfg.replace(mtp=True))
    jb, jp, tb, tp = _build(jcfg.replace(mtp=True), tcfg.replace(mtp=True))
    _, jm = jax.jit(lambda p, b: jb.loss_fn(p, b))(jp, jax.tree.map(jnp.asarray, batch))
    _, tm = tb.loss_fn(tp, {k: T(v) for k, v in batch.items()})
    assert set(tm) == set(jm) == {"ce", "aux", "mtp_ce", "loss"}
    for key in jm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# Untied heads and the other dense configurations
# ---------------------------------------------------------------------------

CONFIGS = {
    "qwen1.5-4b": {},
    "glm4-9b": {},
    "glm4-9b-g16": {"num_heads": 16, "num_kv_heads": 1},
    "gemma-2b": {},
}


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "glm4-9b", "gemma-2b"])
@pytest.mark.parametrize("reduce", [False, True])
def test_config_matches(arch, reduce):
    jcfg, tcfg = j_configs.get_config(arch), t_configs.get_config(arch)
    if reduce:
        jcfg, tcfg = j_configs.reduced(jcfg), t_configs.reduced(tcfg)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.padded_vocab == jcfg.padded_vocab


@pytest.fixture(scope="module", params=list(CONFIGS))
def arch_models(request):
    name = request.param
    jcfg, tcfg = _configs(name.replace("-g16", ""), **CONFIGS[name])
    return (name, jcfg, tcfg) + _build(jcfg, tcfg, seed=3)


def test_head_round_trip(arch_models):
    name, jcfg, tcfg, _, jparams, tb, tparams = arch_models
    assert ("head" in tparams) == (not tcfg.tie_embeddings) == ("head" in jparams)
    if "head" in jparams:
        assert tparams["head"].dtype == torch.float32
        np.testing.assert_array_equal(tparams["head"].numpy(), np.asarray(jparams["head"]))
        own = tb.init_params(torch.Generator().manual_seed(0), device="cpu")
        assert own["head"].shape == tparams["head"].shape
        assert own["head"].dtype == torch.float32
        bf16 = from_jax_params(jax.tree.map(np.asarray, jparams),
                               tcfg.replace(dtype="bfloat16"), device="cpu")
        assert bf16["head"].dtype == torch.float32
        assert bf16["segment0"]["sub0"]["attn"]["wq"].dtype == torch.bfloat16
    extra = dict(jax.tree.map(np.asarray, jparams), mtp_proj=np.zeros((2, 2)))
    with pytest.raises(ValueError, match="not the dense"):
        from_jax_params(extra, tcfg, device="cpu")


@pytest.mark.parametrize("policy", [None, "stem"])
def test_prefill_logits_and_loss(arch_models, policy):
    name, jcfg, tcfg, jb, jparams, tb, tparams = arch_models
    jp, tp = _policy_pair(policy)
    batch = _batch(5, s=48)
    lens = np.array([48, 31], np.int32)
    jl, _ = jb.prefill(jparams, {"tokens": jnp.asarray(batch["tokens"])}, max_len=64,
                       stem_cfg=jp, last_pos=jnp.asarray(lens - 1))
    tl, _ = tb.prefill(tparams, {"tokens": T(batch["tokens"])}, max_len=64,
                       stem_cfg=tp, last_pos=T(lens - 1))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    jloss, _ = jb.loss_fn(jparams, jax.tree.map(jnp.asarray, batch), stem_cfg=jp)
    tloss, _ = tb.loss_fn(tparams, {k: T(v) for k, v in batch.items()}, stem_cfg=tp)
    np.testing.assert_allclose(float(tloss), float(jloss), atol=TOL, rtol=0)


@pytest.mark.parametrize("monolithic", [False, True], ids=["chunked", "monolithic"])
def test_engine_streams_match(arch_models, monolithic):
    """One staggered trace through both engines (block 16, budget 0.5)."""
    name, jcfg, tcfg, jb, jparams, tb, tparams = arch_models
    jp, tp = _policy_pair("stem")
    trace = [(37, 5, 0), (20, 4, 0), (50, 3, 1)]

    def run(mod, bundle, params, pol):
        rng = np.random.RandomState(9)
        reqs = [mod.Request(uid=i, prompt=rng.randint(0, 512, size=(n,)).astype(np.int32),
                            max_new_tokens=m, arrival_step=a)
                for i, (n, m, a) in enumerate(trace)]
        ecfg = mod.EngineConfig.for_trace(max_slots=2, max_prompt=50, max_new_tokens=5,
                                          page_size=16, budget_frac=0.5,
                                          monolithic_prefill=monolithic)
        eng = mod.StemEngine(bundle, params, pol, ecfg)
        return [f.tokens for f in eng.run(reqs)], eng.stats

    jtok, jstats = run(j_engine, jb, jparams, jp)
    ttok, tstats = run(t_engine, tb, tparams, tp)
    assert ttok == jtok
    for key in ("chunks", "prefills", "decode_steps", "step_calls"):
        assert tstats[key] == jstats[key], key
