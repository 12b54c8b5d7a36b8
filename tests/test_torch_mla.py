"""MLA and ``deepseek-v3-671b`` in the port (``repro_torch.models.mla`` and
the ``mla_dense`` / ``mla_moe`` sub-layers and MTP head of
``models/transformer.py``) against the JAX reference.

The reduced ``deepseek-v3-671b`` (3 layers: one ``mla_dense`` layer under
``first_k_dense`` then two ``mla_moe``; 4 heads, q/k head_dim 24 = nope 16
+ rope 8, v 16, latent 16, q rank 32; 8 experts top-2 with a shared expert;
the MTP head) is built once per module in both packages, its JAX
``init_params`` carried into the port by ``weights.from_jax_params``, and
both run on the same numpy-seeded inputs in fp32 (the reference's passes
under ``jax.jit``, which keeps the file's time down):

* ``mla.apply_full`` dense and under stem (block 8) at a length whose
  blocks are whole (the sparse path, at q/k 24 with v 16) and at one whose
  are not (the dense arm), outputs within 1e-4 and densities equal;
* ``prefill_into_cache``'s bf16 latent leaves (``c_kv``, ``k_rope``) within
  1e-4 and ``pos`` equal; ``apply_decode`` at scalar and ``(b,)``
  positions from one shared cache: outputs and written leaves;
* ``loss_fn``'s ``ce`` / ``mtp_ce`` / ``aux`` / ``loss`` and
  ``forward_with_stats``' logits and per-layer densities within 1e-4;
* a ragged stem prefill then dense ``decode_step`` (the fixed batch's
  path): prefill logits within 1e-4, greedy streams equal;
* the refusals the reference makes: ``decode_step`` under a policy, the
  paged engine and the paged steps (``NotImplementedError``).

Inputs are right-padded prompts and random weights (no checkpoint); the
tolerance 1e-4 is the reference suites' own for fp32 executors.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as j_configs
from repro.core import policy as j_policy
from repro.launch import steps as j_steps
from repro.models import mla as j_mla
from repro.models import registry as j_registry
from repro.models import transformer as j_transformer
from repro.runtime import engine as j_engine

from repro_torch import configs as t_configs
from repro_torch.core import policy as t_policy
from repro_torch.launch import steps as t_steps
from repro_torch.models import mla as t_mla
from repro_torch.models import registry as t_registry
from repro_torch.models import transformer as t_transformer
from repro_torch.runtime import engine as t_engine
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)

TOL = 1e-4
T = torch.from_numpy
ARCH = "deepseek-v3-671b"
POLICY_KW = dict(block_size=8, stride=4, sink_blocks=1, local_blocks=1,
                 min_budget_blocks=2, ignore_missing=True)


def _config(mod, dtype="float32"):
    return mod.reduced(mod.get_config(ARCH)).replace(dtype=dtype)


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _config(j_configs), _config(t_configs)
    jb, tb = j_registry.build(jcfg), t_registry.build(tcfg)
    jparams = jax.jit(jb.init_params)(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, jb, jparams, tcfg, tb, tparams


def _policies(name="stem"):
    return (j_policy.get_policy(name).with_updates(**POLICY_KW),
            t_policy.get_policy(name).with_updates(**POLICY_KW))


def _tokens(seed, b, s, vocab=512):
    return np.random.RandomState(seed).randint(0, vocab, size=(b, s)).astype(np.int32)


def _close(got, want, atol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               atol=atol, rtol=0)


def _walk(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, prefix + (k,))
    else:
        yield prefix, tree


def _attn(params, si=0, layer=0):
    """One layer's MLA ``attn`` subtree (either package's tree)."""
    return {k: v[layer] for k, v in params[f"segment{si}"]["sub0"]["attn"].items()}


# ---------------------------------------------------------------------------
# The config and the parameter tree
# ---------------------------------------------------------------------------

def test_config_and_param_tree_match(model):
    """The published and the reduced configs field for field, the layer
    program, and the bf16 init tree's keys / shapes / dtypes (the
    reference's from ``abstract_params``): the MLA ``attn`` subtrees,
    ``first_dense_d_ff`` on the ``mla_dense`` layer, the MTP head."""
    full_j, full_t = j_configs.get_config(ARCH), t_configs.get_config(ARCH)
    assert dataclasses.asdict(full_t) == dataclasses.asdict(full_j)
    assert t_transformer.layer_program(full_t) == j_transformer.layer_program(full_j) \
        == [(3, ("mla_dense",)), (58, ("mla_moe",))]
    jcfg, tcfg = _config(j_configs, "bfloat16"), _config(t_configs, "bfloat16")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.head_dim == 24 and tcfg.mla.v_head_dim == 16
    want = {p: (leaf.shape, str(leaf.dtype))
            for p, leaf in _walk(j_registry.build(jcfg).abstract_params()[0])}
    own = t_registry.build(tcfg).init_params(torch.Generator().manual_seed(0),
                                             device="cpu")
    jparams = model[2]
    carried = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    for tree in (own, carried):
        got = {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
               for p, t in _walk(tree)}
        assert got == want
    assert want[("segment0", "sub0", "ffn", "w_gate")][0] == (1, 64, 128)
    assert want[("mtp_layer", "sub0", "attn", "wq")][0] == (1, 64, 4, 24)
    assert carried["mtp_proj"].dtype == torch.bfloat16
    np.testing.assert_array_equal(     # the fp32 weights rounded to bf16 once
        carried["segment1"]["sub0"]["attn"]["w_uv"].float().numpy(),
        np.asarray(jparams["segment1"]["sub0"]["attn"]["w_uv"].astype(jnp.bfloat16),
                   np.float32))


# ---------------------------------------------------------------------------
# models/mla.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,policy", [(64, None), (64, "stem"), (60, "stem")],
                         ids=["dense-64", "stem-64", "stem-60-dense-arm"])
def test_apply_full_matches(model, n, policy):
    """64 tokens are 8 whole blocks: stem runs the sparse path (q/k 24
    against v 16); 60 are not, so the policy falls back to the dense arm."""
    jcfg, _, jparams, tcfg, _, tparams = model
    x = np.random.RandomState(n).standard_normal((2, n, 64)).astype(np.float32)
    jp, tp = _policies() if policy else (None, None)
    pos = np.arange(n)
    jo, js = j_mla.apply_full(_attn(jparams, 1, 1), jnp.asarray(x), jcfg,
                              positions=jnp.asarray(pos), stem_cfg=jp,
                              return_stats=True)
    to, ts = t_mla.apply_full(_attn(tparams, 1, 1), T(x), tcfg,
                              positions=T(pos), stem_cfg=tp, return_stats=True)
    _close(to, jo)
    assert (ts is None) == (js is None) == (policy is None or n % 8 != 0)
    if ts is not None:
        np.testing.assert_allclose(float(ts.density), float(js.density), atol=1e-6)
        assert ts.k_max == js.k_max and float(ts.density) < 0.9


def test_prefill_cache_and_decode_match(model):
    """prefill_into_cache's bf16 leaves; then apply_decode at a scalar and
    at a (b,) position from one shared cache (both packages start from the
    same bf16 contents): outputs and the leaves it wrote."""
    jcfg, _, jparams, tcfg, _, tparams = model
    jp, tp = _policies()
    n, L = 32, 48
    rng = np.random.RandomState(3)
    x = rng.standard_normal((2, n, 64)).astype(np.float32)
    pj, pt = _attn(jparams), _attn(tparams)
    jo, jc = j_mla.prefill_into_cache(pj, jnp.asarray(x), jcfg,
                                      positions=jnp.arange(n), max_len=L, stem_cfg=jp)
    to, tc = t_mla.prefill_into_cache(pt, T(x), tcfg, positions=torch.arange(n),
                                      max_len=L, stem_cfg=tp)
    _close(to, jo)
    for leaf in ("c_kv", "k_rope"):
        assert getattr(tc, leaf).dtype == torch.bfloat16
        assert getattr(tc, leaf).shape == getattr(jc, leaf).shape
        _close(getattr(tc, leaf), getattr(jc, leaf))
    assert int(tc.pos) == int(jc.pos) == n

    xd = rng.standard_normal((2, 1, 64)).astype(np.float32)
    c0 = np.array(jc.c_kv.astype(jnp.float32))
    r0 = np.array(jc.k_rope.astype(jnp.float32))
    for pos in (np.int32(n), np.array([n, 20], np.int32)):
        jcache = j_mla.MLACache(c_kv=jnp.asarray(c0, jnp.bfloat16),
                                k_rope=jnp.asarray(r0, jnp.bfloat16),
                                pos=jnp.asarray(pos))
        tcache = t_mla.MLACache(c_kv=T(c0).to(torch.bfloat16),
                                k_rope=T(r0).to(torch.bfloat16),
                                pos=torch.as_tensor(pos))
        jo, jn = j_mla.apply_decode(pj, jnp.asarray(xd), jcfg, jcache)
        to, tn = t_mla.apply_decode(pt, T(xd), tcfg, tcache)
        _close(to, jo)
        assert tn.c_kv is tcache.c_kv             # written in place
        _close(tn.c_kv, jn.c_kv)
        _close(tn.k_rope, jn.k_rope)
        np.testing.assert_array_equal(tn.pos.numpy(), np.asarray(jn.pos))


# ---------------------------------------------------------------------------
# The model: evaluation passes, prefill + decode, refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", [None, "stem"])
def test_loss_fn_and_forward_with_stats_match(model, policy):
    jcfg, jb, jparams, tcfg, tb, tparams = model
    toks = _tokens(1, 2, 64)
    labels = np.roll(toks, -1, axis=1)
    jp, tp = _policies() if policy else (None, None)
    _, jm = jax.jit(lambda p, b: jb.loss_fn(p, b, stem_cfg=jp))(
        jparams, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    _, tm = tb.loss_fn(tparams, {"tokens": T(toks), "labels": T(labels)},
                       stem_cfg=tp)
    assert list(tm) == ["ce", "aux", "mtp_ce", "loss"] and set(jm) == set(tm)
    assert float(tm["aux"]) > 0
    for key in jm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), atol=TOL,
                                   rtol=0, err_msg=key)
    def j_forward(p, b):            # records without their strings (jit)
        logits, recs = j_transformer.forward_with_stats(p, b, jcfg, stem_cfg=jp)
        return logits, [r["stats"] and r["stats"].density for r in recs]
    jl, jdens = jax.jit(j_forward)(jparams, {"tokens": jnp.asarray(toks)})
    tl, trec = t_transformer.forward_with_stats(
        tparams, {"tokens": T(toks)}, tcfg, stem_cfg=tp)
    _close(tl, jl)
    kinds = [k for n, ks in j_transformer.layer_program(jcfg) for _ in range(n)
             for k in ks]
    assert [(r["layer"], r["kind"], r["policy"]) for r in trec] == \
        [(i, k, tp and tp.name) for i, k in enumerate(kinds)] == \
        [(0, "mla_dense", tp and tp.name), (1, "mla_moe", tp and tp.name),
         (2, "mla_moe", tp and tp.name)]
    for a, want in zip(trec, jdens):
        assert (a["stats"] is None) == (want is None) == (policy is None)
        if want is not None:
            np.testing.assert_allclose(float(a["stats"].density), float(want),
                                       atol=1e-6)


def test_prefill_then_decode_streams_match(model):
    """The fixed batch's path: a right-padded ragged batch through the
    one-shot stem prefill (40 tokens: 5 whole blocks), then dense
    decode_step with per-row positions on the first step; greedy streams
    equal over 8 tokens, logits within 1e-4 at every step."""
    _, jb, jparams, _, tb, tparams = model
    jp, tp = _policies()
    toks = _tokens(2, 2, 40)
    last = np.array([39, 22], np.int32)
    jl, jc = jax.jit(lambda p, b, lp: jb.prefill(p, b, max_len=48, stem_cfg=jp,
                                                 last_pos=lp))(
        jparams, {"tokens": jnp.asarray(toks)}, jnp.asarray(last))
    tl, tc = tb.prefill(tparams, {"tokens": T(toks)}, max_len=48, stem_cfg=tp,
                        last_pos=T(last))
    _close(tl, jl)
    jserve = jax.jit(j_steps.make_serve_step(jb))
    tserve = t_steps.make_serve_step(tb)
    jstream, tstream = [], []
    jt = jnp.argmax(jl, axis=-1)[:, None].astype(jnp.int32)
    tt = torch.argmax(tl, dim=-1)[:, None].to(torch.int32)
    for i in range(8):
        jstream.append(np.asarray(jt)[:, 0].tolist())
        tstream.append(tt[:, 0].tolist())
        jl, jc = jserve(jparams, jt, jc, None if i else jnp.asarray(last + 1))
        tl, tc = tserve(tparams, tt, tc, None if i else T(last + 1))
        _close(tl, jl)
        jt = jnp.argmax(jl, axis=-1)[:, None].astype(jnp.int32)
        tt = torch.argmax(tl, dim=-1)[:, None].to(torch.int32)
    assert tstream == jstream
    for seg_j, seg_t in zip(jc, tc):
        np.testing.assert_array_equal(seg_t["sub0"].pos.numpy(),
                                      np.asarray(seg_j["sub0"].pos))


def test_paged_paths_refuse_mla_like_reference(model):
    """MLA has no page layout: a policy-sparse decode_step, the paged
    engine and the paged steps raise NotImplementedError in both packages
    (building the bundle does not)."""
    jcfg, jb, jparams, tcfg, tb, tparams = model
    jp, tp = _policies()
    toks = _tokens(4, 1, 16)
    _, jc = jb.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_len=24)
    _, tc = tb.prefill(tparams, {"tokens": T(toks)}, max_len=24)
    step = np.array([[3]], np.int32)
    with pytest.raises(NotImplementedError, match="mla_dense") as want:
        jb.decode_step(jparams, jnp.asarray(step), jc, stem_cfg=jp)
    with pytest.raises(NotImplementedError) as got:
        tb.decode_step(tparams, T(step), tc, stem_cfg=tp)
    assert str(got.value) == str(want.value)
    for mod, bundle, params, pol in ((j_engine, jb, jparams, jp),
                                     (t_engine, tb, tparams, tp)):
        ecfg = mod.EngineConfig.for_trace(max_slots=1, max_prompt=16,
                                          max_new_tokens=2, page_size=8)
        with pytest.raises(NotImplementedError, match="paged serving"):
            mod.StemEngine(bundle, params, pol, ecfg)
    for make in (lambda: t_steps.make_unified_step(tb, stem_cfg=tp),
                 lambda: t_steps.make_monolithic_prefill(tb, stem_cfg=tp)):
        with pytest.raises(NotImplementedError, match="mla_dense"):
            make()


def test_init_caches_and_bf16_paths(model):
    """init_caches' MLA leaves match the reference's (shapes, dtypes: the
    model dtype; prefill stores bf16); the bf16 config runs loss_fn,
    prefill and decode_step in the port with finite outputs and bf16
    latent leaves."""
    jcfg, jb, _, tcfg, tb, _ = model
    jc = jb.init_caches(2, 24)
    tc = tb.init_caches(2, 24, device="cpu")
    for seg_j, seg_t in zip(jc, tc):
        for leaf in ("c_kv", "k_rope", "pos"):
            assert tuple(getattr(seg_t["sub0"], leaf).shape) == \
                tuple(getattr(seg_j["sub0"], leaf).shape)
        assert seg_t["sub0"].c_kv.dtype == torch.float32
    cfg = _config(t_configs, "bfloat16")
    bundle = t_registry.build(cfg)
    params = bundle.init_params(torch.Generator().manual_seed(1), device="cpu")
    _, tp = _policies()
    toks = T(_tokens(5, 2, 33))
    _, m = bundle.loss_fn(params, {"tokens": toks[:, :-1], "labels": toks[:, 1:]},
                          stem_cfg=tp)
    assert all(np.isfinite(float(v)) for v in m.values())
    logits, caches = bundle.prefill(params, {"tokens": toks[:, :32]}, max_len=40,
                                    stem_cfg=tp, last_pos=T(np.array([31, 17])))
    assert caches[1]["sub0"].c_kv.dtype == torch.bfloat16
    logits, caches = t_steps.make_serve_step(bundle)(
        params, torch.argmax(logits, -1)[:, None].to(torch.int32), caches,
        T(np.array([32, 18], np.int32)))
    assert logits.dtype == torch.float32 and bool(torch.isfinite(logits).all())
    np.testing.assert_array_equal(caches[1]["sub0"].pos.numpy(), [[33, 19]] * 2)
