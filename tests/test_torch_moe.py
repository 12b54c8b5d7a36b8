"""The MoE family in the port (``repro_torch.models.moe`` and the ``moe``
sub-layer of ``models/transformer.py``) against the JAX reference.

* ``moe.apply`` on numpy-seeded inputs and carried weights over a grid of
  (b, s, E, K) x capacity factor {1.25 (binding), 8.0} x {plain, shared
  expert, residual dense}: the routing integers (experts, positions,
  keep, capacity) equal exactly, the output within 1e-5 and the aux loss
  within 1e-6 relative; a per-token numpy oracle where nothing drops; a
  planted router tie takes the lower expert first; pad positions of a
  chunk rank after its real tokens and never displace them.
* Two model fixtures built identically in both packages: the reduced
  ``arctic-480b`` (3 MoE layers, 8 experts, top-2, a residual dense FFN)
  and a deepseek-style variant of it (one shared expert, ``first_k_dense``
  1: a two-segment program).  ``loss_fn``, prefill, contiguous decode and
  ``forward_with_stats`` within 1e-4 (fp32); the engine's greedy streams
  and step counts equal the JAX engine's, chunked and monolithic, with the
  prefix cache on; the async loop equals the port's sync loop; the
  monolithic engine equals the fixed batch (the reference's oracle).
* The port's ``init_params`` tree (keys, shapes, dtypes) equals the
  reference's for both fixtures in bf16, and ``from_jax_params`` keeps
  the router fp32 there.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as j_configs
from repro.configs.base import MoEConfig as JMoE
from repro.core import policy as j_policy
from repro.models import common as j_common
from repro.models import moe as j_moe
from repro.models import registry as j_registry
from repro.runtime import engine as j_engine

from repro_torch import configs as t_configs
from repro_torch.configs.base import MoEConfig as TMoE
from repro_torch.core import policy as t_policy
from repro_torch.launch import steps as t_steps
from repro_torch.models import moe as t_moe
from repro_torch.models import registry as t_registry
from repro_torch.models import transformer as t_transformer
from repro_torch.runtime import engine as t_engine
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)

TOL = 1e-4
T = torch.from_numpy
POLICY_KW = dict(block_size=8, stride=4, sink_blocks=1, local_blocks=1,
                 min_budget_blocks=2, ignore_missing=True)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else T(np.array(v))
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# moe.apply
# ---------------------------------------------------------------------------

VARIANTS = {"plain": {}, "shared": dict(shared_experts=1, shared_d_ff=24),
            "residual": dict(residual_dense=True, residual_d_ff=24)}
SHAPES = [(2, 16, 4, 2), (1, 33, 8, 2), (3, 5, 8, 1)]


def _moe_case(b, s, E, K, cf, variant, d=16, seed=0):
    kw = dict(num_experts=E, top_k=K, expert_d_ff=16, capacity_factor=cf,
              **VARIANTS[variant])
    ini = j_common.Initializer(jax.random.PRNGKey(seed), jnp.float32)
    jp = j_common.unzip(j_moe.init(ini, d, JMoE(**kw), "silu"))[0]
    x = np.random.RandomState(seed + 1).standard_normal((b, s, d)).astype(np.float32)
    return JMoE(**kw), TMoE(**kw), _np_tree(jp), x


def _oracle(params, x, experts, weights):
    """Per-token loop: every token through its top-k experts, float64."""
    out = np.zeros(x.shape, np.float64)
    wg, wu, wd = (np.asarray(params[k], np.float64)
                  for k in ("w_gate", "w_up", "w_down"))
    for bi, si, kk in np.ndindex(*experts.shape):
        e = experts[bi, si, kk]
        h = x[bi, si].astype(np.float64) @ wg[e]
        u = x[bi, si].astype(np.float64) @ wu[e]
        out[bi, si] += weights[bi, si, kk] * ((h / (1 + np.exp(-h)) * u) @ wd[e])
    return out


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("cf", [1.25, 8.0])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "b%ds%dE%dK%d" % s)
def test_moe_apply_matches_reference(shape, cf, variant):
    jmoe, tmoe, params, x = _moe_case(*shape, cf, variant)
    _, jw, je, jpos, jkeep, jcap = j_moe._route(params, jnp.asarray(x), jmoe)
    _, tw, te, tpos, tkeep, tcap = t_moe.route(_torch_tree(params), T(x), tmoe)
    assert tcap == jcap == t_moe.capacity(tmoe, shape[1])
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6, rtol=0)
    jy, jaux = j_moe.apply(params, jnp.asarray(x), jmoe, "silu")
    ty, taux = t_moe.apply(_torch_tree(params), T(x), tmoe, "silu")
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6, atol=0)
    if cf == 8.0:
        assert bool(tkeep.all())
        want = _oracle(params, x, te.numpy(), tw.numpy().astype(np.float64))
        for name in ("shared", "residual"):
            if name in params:
                p = params[name]
                h = x @ p["w_gate"]
                want = want + (h / (1 + np.exp(-h)) * (x @ p["w_up"])) @ p["w_down"]
        np.testing.assert_allclose(ty.numpy(), want, atol=2e-5, rtol=0)
    else:
        assert not bool(tkeep.all())          # the capacity binds


def test_router_tie_takes_lower_expert_first():
    """Experts 2 and 5 carry the same router column and win every token
    whose logit there is positive: both packages put 2 before 5."""
    jmoe, tmoe, params, x = _moe_case(2, 12, 8, 2, 8.0, "plain")
    router = np.zeros_like(params["router"])
    col = np.abs(np.random.RandomState(9).standard_normal(router.shape[0]))
    router[:, 2] = router[:, 5] = col.astype(np.float32)
    params = dict(params, router=router)
    x = np.abs(x)                                     # positive logits
    _, _, je, _, _, _ = j_moe._route(params, jnp.asarray(x), jmoe)
    _, _, te, _, _, _ = t_moe.route(_torch_tree(params), T(x), tmoe)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert (te[..., 0] == 2).all() and (te[..., 1] == 5).all()


def test_padded_chunk_rows_never_displace_real_tokens():
    """A chunk of C positions whose last ones are padding: the real tokens'
    positions and keeps are those of the real tokens routed alone against
    the chunk's capacity, and so is their output."""
    jmoe, tmoe, params, x = _moe_case(1, 32, 8, 2, 1.25, "plain")
    tp = _torch_tree(params)
    real = 21
    _, w, e, pos, keep, cap = t_moe.route(tp, T(x), tmoe)
    _, w_r, e_r, pos_r, _, _ = t_moe.route(tp, T(x[:, :real]), tmoe)
    assert not bool(keep.all())
    assert torch.equal(pos[:, :real], pos_r)
    assert torch.equal(keep[:, :real], pos_r < cap)
    y = t_moe.expert_ffn(T(x), e, pos, keep, w, tp["w_gate"], tp["w_up"],
                         tp["w_down"], capacity=cap, activation="silu")
    y_r = t_moe.expert_ffn(T(x[:, :real]), e_r, pos_r, pos_r < cap, w_r,
                           tp["w_gate"], tp["w_up"], tp["w_down"],
                           capacity=cap, activation="silu")
    np.testing.assert_allclose(y[:, :real].numpy(), y_r.numpy(), atol=1e-6,
                               rtol=0)


def test_expert_flops_per_token_matches_reference():
    for variant in VARIANTS:
        jmoe, tmoe, _, _ = _moe_case(1, 4, 8, 2, 1.25, variant)
        assert t_moe.expert_flops_per_token(64, tmoe) == \
            j_moe.expert_flops_per_token(64, jmoe)


# ---------------------------------------------------------------------------
# The model fixtures
# ---------------------------------------------------------------------------

def _config(mod, fixture, dtype="float32"):
    cfg = mod.reduced(mod.get_config("arctic-480b")).replace(dtype=dtype)
    if fixture == "deepseek-style":
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, shared_experts=1, shared_d_ff=64, first_k_dense=1,
            residual_dense=False, residual_d_ff=0))
    return cfg


FIXTURES = ["arctic", "deepseek-style"]


@pytest.fixture(scope="module", params=FIXTURES)
def models(request):
    jcfg, tcfg = _config(j_configs, request.param), _config(t_configs, request.param)
    jb, tb = j_registry.build(jcfg), t_registry.build(tcfg)
    jparams = jb.init_params(jax.random.PRNGKey(0))
    tparams = from_jax_params(_np_tree(jparams), tcfg, device="cpu")
    return request.param, jcfg, jb, jparams, tcfg, tb, tparams


def _walk(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, prefix + (k,))
    else:
        yield prefix, tree


def test_config_and_param_tree_match(models):
    """Fields and layer program; the bf16 init tree's keys / shapes /
    dtypes (the reference's from ``abstract_params``); carried weights in
    a bf16 config keep the router fp32."""
    fixture, _, _, jparams, _, _, _ = models
    jcfg, tcfg = _config(j_configs, fixture, "bfloat16"), _config(
        t_configs, fixture, "bfloat16")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    from repro.models import transformer as j_transformer
    assert t_transformer.layer_program(tcfg) == j_transformer.layer_program(jcfg)
    want = {p: (leaf.shape, str(leaf.dtype))
            for p, leaf in _walk(j_registry.build(jcfg).abstract_params()[0])}
    own = t_registry.build(tcfg).init_params(torch.Generator().manual_seed(0),
                                             device="cpu")
    carried = from_jax_params(_np_tree(jparams), tcfg, device="cpu")
    for tree in (own, carried):
        got = {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
               for p, t in _walk(tree)}
        assert got == want
    routers = [p for p in want if p[-1] == "router"]
    assert routers and all(want[p][1] == "float32" for p in routers)
    seg = routers[0][0]
    assert carried[seg]["sub0"]["ffn"]["w_gate"].dtype == torch.bfloat16
    np.testing.assert_array_equal(carried[seg]["sub0"]["ffn"]["router"].numpy(),
                                  np.asarray(jparams[seg]["sub0"]["ffn"]["router"]))


def _policies(name="stem"):
    return (j_policy.get_policy(name).with_updates(**POLICY_KW),
            t_policy.get_policy(name).with_updates(**POLICY_KW))


def _tokens(seed, b, s, vocab=512):
    return np.random.RandomState(seed).randint(0, vocab, size=(b, s)).astype(np.int32)


@pytest.mark.parametrize("policy", [None, "stem"])
def test_loss_fn_matches(models, policy):
    _, jcfg, jb, jparams, tcfg, tb, tparams = models
    toks = _tokens(1, 2, 40)
    labels = np.roll(toks, -1, axis=1)
    jp, tp = _policies() if policy else (None, None)
    _, jm = jb.loss_fn(jparams, {"tokens": jnp.asarray(toks),
                                 "labels": jnp.asarray(labels)}, stem_cfg=jp)
    _, tm = tb.loss_fn(tparams, {"tokens": T(toks), "labels": T(labels)},
                       stem_cfg=tp)
    assert float(tm["aux"]) > 0
    for key in ("ce", "aux", "loss"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), atol=TOL,
                                   rtol=0, err_msg=key)
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]), rtol=1e-5)


def test_prefill_decode_and_stats_match(models):
    """One-shot prefill (stem) of a right-padded ragged batch, two
    contiguous decode steps (dense, then policy-sparse) and
    forward_with_stats' logits and realized densities."""
    from repro.launch import steps as j_steps
    from repro.models import transformer as j_transformer
    _, jcfg, jb, jparams, tcfg, tb, tparams = models
    jp, tp = _policies()
    toks = _tokens(2, 2, 32)
    last = np.array([31, 19], np.int32)
    jl, jc = jb.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_len=48,
                        stem_cfg=jp, last_pos=jnp.asarray(last))
    tl, tc = tb.prefill(tparams, {"tokens": T(toks)}, max_len=48, stem_cfg=tp,
                        last_pos=T(last))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    step = np.array([[5], [7]], np.int32)
    for i, sparse in enumerate((False, True)):
        jl, jc = j_steps.make_serve_step(jb, stem_cfg=jp if sparse else None)(
            jparams, jnp.asarray(step), jc, None if i else jnp.asarray(last + 1))
        tl, tc = t_steps.make_serve_step(tb, stem_cfg=tp if sparse else None)(
            tparams, T(step), tc, None if i else T(last + 1))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    jl, jrec = j_transformer.forward_with_stats(
        jparams, {"tokens": jnp.asarray(toks)}, jcfg, stem_cfg=jp)
    tl, trec = t_transformer.forward_with_stats(
        tparams, {"tokens": T(toks)}, tcfg, stem_cfg=tp)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    assert [(r["layer"], r["kind"]) for r in trec] == \
        [(r["layer"], r["kind"]) for r in jrec]
    for a, b in zip(trec, jrec):
        np.testing.assert_allclose(float(a["stats"].density),
                                   float(b["stats"].density), atol=1e-6)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

BS = POLICY_KW["block_size"]
# (prompt, new tokens, arrival); 13 and 21 leave padded final chunks
TRACE = [(13, 6, 0), (40, 5, 0), (21, 6, 1)]
SYSTEM = 16          # the shared prefix of the prefix-cache trace (2 pages)


def _requests(mod, trace, shared: bool, seed=5):
    """``trace``'s requests; ``shared`` puts one system prompt in front of
    each and adds the bare system prompt at step 3 (a full match: its
    last page is copied on write and recomputed)."""
    rng = np.random.RandomState(seed)
    system = rng.randint(0, 512, size=(SYSTEM,))
    out = []
    for uid, (n, mnt, arr) in enumerate(trace):
        prompt = rng.randint(0, 512, size=(n,))
        if shared:
            prompt = np.concatenate([system, prompt])
        out.append(mod.Request(uid=uid, prompt=prompt.astype(np.int32),
                               max_new_tokens=mnt, arrival_step=arr))
    if shared:
        out.append(mod.Request(uid=len(trace), prompt=system.astype(np.int32),
                               max_new_tokens=4, arrival_step=3))
    return out


def _ecfg(mod, shared, **kw):
    longest = max(n for n, _, _ in TRACE) + (SYSTEM if shared else 0)
    return mod.EngineConfig.for_trace(
        max_slots=2, max_prompt=longest, max_new_tokens=6, page_size=BS,
        **{"budget_frac": 0.5, **kw})


ENGINE_COUNTS = ("chunks", "prefills", "decode_steps", "step_calls",
                 "tokens_generated", "prefix_hits", "prefix_pages_shared",
                 "prefix_cows")


@pytest.mark.parametrize("mode", ["chunked", "monolithic", "prefix-cache"])
def test_engine_matches_reference(models, mode):
    _, jcfg, jb, jparams, tcfg, tb, tparams = models
    jp, tp = _policies()
    shared = mode == "prefix-cache"
    kw = dict(monolithic_prefill=True) if mode == "monolithic" else dict(
        chunk_size=16, prefix_cache=shared)
    jeng = j_engine.StemEngine(jb, jparams, jp, _ecfg(j_engine, shared, **kw))
    jfin = jeng.run(_requests(j_engine, TRACE, shared))
    teng = t_engine.StemEngine(tb, tparams, tp, _ecfg(t_engine, shared, **kw))
    tfin = teng.run(_requests(t_engine, TRACE, shared))
    assert {f.uid: f.tokens for f in tfin} == {f.uid: f.tokens for f in jfin}
    assert teng.step_count == jeng.step_count
    for key in ENGINE_COUNTS:
        assert teng.stats[key] == jeng.stats[key], key
    if shared:
        assert teng.stats["prefix_hits"] >= 2 and teng.stats["prefix_cows"] == 1
        # The system prompt fills whole chunks, so a sharer's suffix chunks
        # hold the tokens they hold with the cache off and route alike.
        # The full match recomputes its last page as a chunk of its own,
        # whose tokens compete for expert capacity without the page before
        # it: its stream may part from the cache-off run (both engines
        # agree on it above).
        off = t_engine.StemEngine(tb, tparams, tp, _ecfg(
            t_engine, True, chunk_size=16)).run(_requests(t_engine, TRACE, True))
        want = {f.uid: f.tokens for f in off if f.uid < len(TRACE)}
        assert {f.uid: f.tokens for f in tfin if f.uid < len(TRACE)} == want
    teng.allocator.check_conservation([])
    assert teng.allocator.available == teng.ecfg.num_pages - 1


@pytest.mark.parametrize("shared", [False, True], ids=["plain", "prefix-cache"])
def test_async_loop_matches_sync(models, shared):
    _, _, _, _, tcfg, tb, tparams = models
    _, tp = _policies()
    runs = {}
    for depth in (0, 1):
        eng = t_engine.StemEngine(tb, tparams, tp, _ecfg(
            t_engine, shared, chunk_size=16, prefix_cache=shared,
            async_depth=depth))
        fin = eng.run(_requests(t_engine, TRACE, shared))
        runs[depth] = {f.uid: f.tokens for f in fin}
        if depth:
            assert eng.stats["host_syncs"] <= 2 * len(fin)
            assert not eng._inflight
        assert eng.allocator.available == eng.ecfg.num_pages - 1
    assert runs[1] == runs[0]


def test_monolithic_engine_matches_fixed_batch(models):
    """The reference's oracle for the engine: one-shot prefill of the
    prompt padded to a page multiple (both route the same Lp tokens), then
    policy-sparse contiguous decode at budget 1.0, one request at a time."""
    _, _, _, _, tcfg, tb, tparams = models
    _, tp = _policies()
    reqs = _requests(t_engine, TRACE, False)
    fin = t_engine.StemEngine(tb, tparams, tp, _ecfg(
        t_engine, False, monolithic_prefill=True, budget_frac=1.0)).run(reqs)
    serve = t_steps.make_serve_step(tb, stem_cfg=tp, budget_frac=1.0)
    for req, f in zip(reqs, fin):
        plen, mnt = len(req.prompt), req.max_new_tokens
        lp = -(-plen // BS) * BS
        toks = np.zeros((1, lp), np.int32)
        toks[0, :plen] = req.prompt
        logits, caches = tb.prefill(tparams, {"tokens": T(toks)},
                                    max_len=-(-(plen + mnt) // BS) * BS,
                                    stem_cfg=tp, last_pos=torch.tensor([plen - 1]))
        out = [int(logits.argmax(-1)[0])]
        for i in range(mnt - 1):
            logits, caches = serve(tparams, torch.tensor([[out[-1]]]), caches,
                                   torch.tensor([plen]) if i == 0 else None)
            out.append(int(logits.argmax(-1)[0]))
        assert f.tokens == out, f"request {req.uid}"
