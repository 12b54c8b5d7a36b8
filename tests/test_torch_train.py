"""The port's training path against the JAX reference on the CPU.

* The attention backward's plain versions (``flash_attention_bwd_plain``,
  ``block_sparse_attention_bwd_plain``, the analytic ``dS = P * (dP -
  delta)``) against ``torch.autograd.grad`` through the plain forwards and
  against ``jax.vjp`` of the reference's ``dense_attention`` and gather
  executor, on numpy-seeded inputs: GQA groups 1 and 2, ``group_dedup``,
  revisit-filled dead slots, ``cnt == 0`` rows, (d, dv) = (16, 16) and
  (24, 16); within 1e-5 of each gradient's max|value| (fp32, different
  summation orders).  ``transpose_selection`` against a loop; the
  differentiable wrappers (``attention``) run the plain backward on the CPU
  and never autograd through the plain forward.
* One train step of the port (``launch/steps.make_train_step``) against the
  reference's ``make_train_step`` under ``jax.jit`` on the same carried
  weights (``weights.from_jax_params``) and ``SyntheticLMData`` batches, fp32
  reduced configs at seq 64: qwen3-0.6b over dense / Stem, microbatches 1 /
  2, remat on / off and grad_dtype None / bf16 for three steps (one step of
  each other family: ``tests/test_torch_train_families.py``).  Compared: the
  metrics (rtol 1e-5), and mu, nu and master.  After the first step with
  fp32 gradients mu = (1 - b1) * clip scale * gradient, so mu within 1e-4
  of each leaf's max|mu| is every gradient leaf within 1e-4 of its
  max|g|; nu likewise (1e-4, or one bf16 ulp, 2^-8, of the leaf's max
  when the gradients are cast to bf16: a last-ulp difference can round an
  element the other way).  master within 5% of the sum of the step's
  learning rates: AdamW moves an element by about lr a step whatever its
  gradient's size, so an element whose gradient is rounding noise in both
  frameworks may move differently.
* The port's ``remat`` on == off bitwise, and the fused executor's
  gradients (the backward's plain version on the CPU) == the gather
  executor's (autograd).
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as j_configs
from repro import optim as j_optim
from repro.core.config import StemConfig as JStem
from repro.data import SyntheticLMData
from repro.launch import steps as j_steps
from repro.models import registry as j_registry

from repro_torch import configs as t_configs
from repro_torch import optim as t_optim
from repro_torch.core import policy as t_policy
from repro_torch.core.config import StemConfig as TStem
from repro_torch.kernels import block_sparse_attn as t_bsa
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.launch import steps as t_steps
from repro_torch.models import registry as t_registry
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.weights import from_jax_params

# the module (the package re-exports a function of the same name)
j_sa = importlib.import_module("repro.core.sparse_attention")

torch.set_num_threads(1)

SEQ = 64
GEO = dict(block_size=16, min_budget_blocks=2, sink_blocks=1, local_blocks=1, stride=4)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.size == 0:                   # an empty layer stack: only its shape to hold
        assert got.shape == want.shape
        return 0.0
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# the attention backward's plain versions
# ---------------------------------------------------------------------------

def _selection(rng, b, hs, nq, kmax, dead_rows=((0, 0, 2),)):
    """Causal selections with a live prefix of random length, the dead
    slots revisit-filled with the row's first live block (the reference's
    filling), and the listed (b, h, row) at cnt == 0."""
    idx = np.zeros((b, hs, nq, kmax), np.int32)
    cnt = np.zeros((b, hs, nq), np.int32)
    for bb in range(b):
        for h in range(hs):
            for i in range(nq):
                c = 0 if (bb, h, i) in dead_rows else int(rng.integers(1, min(kmax, i + 1) + 1))
                live = rng.permutation(i + 1)[:c]
                idx[bb, h, i, :c] = live
                idx[bb, h, i, c:] = live[0] if c else 0
                cnt[bb, h, i] = c
    return idx, cnt


ATTN_CASES = [  # (hq, hk, d, dv, group_dedup)
    (2, 2, 16, 16, False), (4, 2, 16, 16, False), (4, 2, 16, 16, True),
    (4, 2, 24, 16, False), (4, 2, 24, 16, True),
    # the tensor-core backward's other pairs: whisper-medium's d 64, MLA's
    # (192, 128) and (192, 192), gemma-2b's 8 / 1 heads at d 256
    (4, 4, 64, 64, False), (2, 2, 192, 128, False), (2, 2, 192, 192, False),
    (8, 1, 256, 256, False), (8, 1, 256, 256, True)]


@pytest.mark.parametrize("hq,hk,d,dv,dedup", ATTN_CASES)
def test_backward_plain_versions(hq, hk, d, dv, dedup):
    rng = np.random.default_rng(hq * 100 + d + dv + dedup)
    b, n, bs, kmax = 2, 64, 8, 4
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in
                   ((b, hq, n, d), (b, hk, n, d), (b, hk, n, dv), (b, hq, n, dv)))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    scale = d ** -0.5

    # flash: the analytic backward against autograd and the reference
    o = t_fa.flash_attention_plain(tq, tk, tv)
    got = t_fa.flash_attention_bwd_plain(tq, tk, tv, o, tdo)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    auto = torch.autograd.grad(t_fa.flash_attention_plain(*leaves), leaves, tdo)
    _, vjp = jax.vjp(lambda *a: j_sa.dense_attention(*a, causal=True, scale=scale),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp(jnp.asarray(do))
    for g, a, r in zip(got, auto, ref):
        assert _rel(g, a.numpy()) < 1e-5 and _rel(g, r) < 1e-5

    # block-sparse
    hs = hk if dedup else hq
    idx, cnt = _selection(rng, b, hs, n // bs, kmax)
    ti, tc = torch.from_numpy(idx), torch.from_numpy(cnt)
    kw = dict(block_size=bs, group_dedup=dedup)
    o = t_bsa.block_sparse_attention_plain(tq, tk, tv, ti, tc, **kw)
    got = t_bsa.block_sparse_attention_bwd_plain(tq, tk, tv, o, tdo, ti, tc, **kw)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    auto = torch.autograd.grad(
        t_bsa.block_sparse_attention_plain(*leaves, ti, tc, **kw), leaves, tdo)
    mask = np.arange(kmax) < cnt[..., None]
    _, vjp = jax.vjp(lambda *a: j_sa._gather_executor(
        *a, jnp.asarray(idx), jnp.asarray(mask), block_size=bs, scale=scale,
        slot_chunk=2, group_dedup=dedup), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = vjp(jnp.asarray(do))
    for g, a, r in zip(got, auto, ref):
        assert _rel(g, a.numpy()) < 1e-5 and _rel(g, r) < 1e-5
    # the cnt == 0 row (batch 0, selection row 0, block 2) gets no gradient
    rows = range(2 * bs, 3 * bs)
    heads = range(hq // hk) if dedup else range(1)
    assert float(got[0][0, list(heads)][:, rows].abs().max()) == 0.0

    # the differentiable wrappers: the plain backward, no autograd through
    # the plain forward
    for fn, args in ((t_fa.attention, ()), (t_bsa.attention, (ti, tc))):
        leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
        out = fn(*leaves, *args, **(kw if args else {}))
        assert type(out.grad_fn).__name__ == "_AttentionBackward"
        grads = torch.autograd.grad(out, leaves, tdo)
        want = (t_fa.flash_attention_bwd_plain(tq, tk, tv, out.detach(), tdo) if not args
                else t_bsa.block_sparse_attention_bwd_plain(tq, tk, tv, out.detach(), tdo,
                                                            ti, tc, **kw))
        for g, w in zip(grads, want):
            assert torch.equal(g, w)


def test_transpose_selection():
    rng = np.random.default_rng(3)
    b, h, nq, kmax = 2, 3, 8, 4
    idx, cnt = _selection(rng, b, h, nq, kmax, dead_rows=((0, 1, 5), (1, 2, 0)))
    idx[1, 0, 7, 0] = nq + 3           # an id outside [0, nq) is not read
    tidx, tcnt = t_bsa.transpose_selection(torch.from_numpy(idx), torch.from_numpy(cnt), nq)
    assert tidx.dtype == tcnt.dtype == torch.int32
    assert tuple(tidx.shape) == (b, h, nq, nq)
    for bb in range(b):
        for hh in range(h):
            for j in range(nq):
                want = [i for i in range(nq)
                        if j in [x for x in idx[bb, hh, i, :cnt[bb, hh, i]] if 0 <= x < nq]]
                c = int(tcnt[bb, hh, j])
                assert tidx[bb, hh, j, :c].tolist() == want


# ---------------------------------------------------------------------------
# train steps against the reference's make_train_step
# ---------------------------------------------------------------------------

def _lwp(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in tree for x in _lwp(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def _get(tree, path):
    for k in path.strip("/").split("/"):
        tree = tree[k]
    return tree


def _setup(arch, cut=None):
    """Both packages' reduced fp32 ``arch`` (``cut``, if given, applied to
    each config), the reference's weights carried to the port, the data."""
    jcfg = j_configs.reduced(j_configs.get_config(arch)).replace(dtype="float32")
    tcfg = t_configs.reduced(t_configs.get_config(arch)).replace(dtype="float32")
    if cut is not None:
        jcfg, tcfg = cut(jcfg), cut(tcfg)
    jb, tb = j_registry.build(jcfg), t_registry.build(tcfg)
    jp = jax.jit(jb.init_params)(jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    data = SyntheticLMData(
        vocab_size=jcfg.vocab_size, seq_len=SEQ, global_batch=4, seed=0,
        kind={"vlm": "vlm", "encdec": "encdec"}.get(jcfg.family, "lm"),
        d_model=jcfg.d_model, frames=jcfg.encdec.encoder_frames if jcfg.encdec else 0)
    return jb, tb, jp, tp, data


STEP_CASES = [  # (arch, stem, microbatches, remat, grad_dtype, steps)
    ("qwen3-0.6b", False, 1, True, None, 3),
    ("qwen3-0.6b", True, 2, False, "bfloat16", 3),
    ("qwen3-0.6b", True, 1, True, None, 3),
    ("qwen3-0.6b", False, 2, False, "bfloat16", 3),
]


@pytest.mark.parametrize("arch,stem,mb,remat,gd,steps", STEP_CASES,
                         ids=lambda x: str(x))
def test_train_step_matches_reference(arch, stem, mb, remat, gd, steps):
    check_train_step(arch, stem, mb, remat, gd, steps)


def check_train_step(arch, stem, mb, remat, gd, steps, cut=None):
    """``steps`` train steps of the port against the reference's on the
    same weights and batches (the rules of the module docstring)."""
    jb, tb, jp, tp, data = _setup(arch, cut)
    kw = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=10, grad_dtype=gd)
    jo, to = j_optim.AdamWConfig(**kw), t_optim.AdamWConfig(**kw)
    jstep = jax.jit(j_steps.make_train_step(
        jb, jo, stem_cfg=JStem(**GEO) if stem else None, remat=remat, microbatches=mb))
    tstep = t_steps.make_train_step(
        tb, to, stem_cfg=TStem(**GEO) if stem else None, remat=remat, microbatches=mb)
    js, ts = j_optim.init_state(jp, jo), t_optim.init_state(tp, to)
    lr_sum = 0.0
    for s in range(steps):
        batch = data.batch_at(s)
        js, jm = jstep(js, batch)
        ts, tm = tstep(ts, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert sorted(jm) == sorted(tm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {s} {k}")
        lr_sum += float(jm["lr"])
        if s == 0 or s == steps - 1:
            mtol = 1e-4 if gd is None else 2.0 ** -8
            for name in ("mu", "nu"):
                for path, got in _lwp(getattr(ts, name)):
                    want = np.asarray(_get(getattr(js, name), path))
                    assert _rel(got.numpy(), want) <= mtol, f"step {s} {name}{path}"
    for path, got in _lwp(ts.master):
        want = np.asarray(_get(js.master, path))
        assert got.shape == want.shape, path
        assert float(np.abs(got.numpy() - want).max(initial=0.0)) <= 0.05 * lr_sum, path


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "whisper-medium"])
def test_remat_bitwise_and_fused_equals_gather(arch, monkeypatch):
    _, tb, _, tp, data = _setup(arch)
    batch = {k: torch.from_numpy(v) for k, v in data.batch_at(0).items()}
    master = tree_map(lambda p: p.float(), tp)
    calls = []
    plain = t_bsa.block_sparse_attention_bwd_plain
    monkeypatch.setattr(t_bsa, "block_sparse_attention_bwd_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    fused = t_policy.as_policy(TStem(**GEO))
    runs = {}
    for name, pol, remat in (("fused", fused, True), ("fused-noremat", fused, False),
                             ("gather", fused.with_updates(executor="gather"), True)):
        runs[name] = t_steps.loss_and_grads(tb, master, batch, stem_cfg=pol, remat=remat)
    n_sparse_layers = tb.cfg.num_layers
    assert len(calls) == 2 * n_sparse_layers      # the fused runs' backward, per layer
    (la, _, ga), (lb, _, gb), (lc, _, gc) = runs.values()
    assert torch.equal(la, lb)
    for a, b_ in zip(tree_leaves(ga), tree_leaves(gb)):
        assert torch.equal(a, b_)
    assert abs(float(la) - float(lc)) <= 1e-6 * abs(float(lc))
    for a, c in zip(tree_leaves(ga), tree_leaves(gc)):
        assert _rel(a.numpy(), c.numpy()) < 1e-5
