"""The SSM, hybrid, encoder-decoder and VLM-stub families in the port
against the JAX reference, end to end through ``registry.build(cfg)``:
``mamba2-370m`` (SSD), ``recurrentgemma-2b`` (RG-LRU + windowed local
attention over a ring cache, with a leftover ``rec`` group),
``whisper-medium`` (bidirectional encoder, decoder with cross attention)
and ``pixtral-12b`` (patch embeddings ahead of the text).

Each reduced config is built once per module in both packages, its JAX
``init_params`` carried into the port by ``weights.from_jax_params``, and
both run on the same numpy-seeded inputs in fp32 (the reference's passes
under ``jax.jit``):

* ``loss_fn``, ``prefill`` and eight greedy ``decode_step``s: logits within
  1e-4 at every step, streams exactly equal; for the configs with
  ``use_stem`` the prefill also under stem (block 8), beside dense;
* ``forward_hiddens`` / ``forward_with_stats`` for the decoder-only ones;
* two faults of the reference that the port keeps, pinned in both
  packages: decode after ``prefill(n)`` differs from ``prefill(n + 1)``
  by more than 1e-3 for a recurrentgemma prompt shorter than its window
  (the ring cache keeps n slots) and for whisper (RoPE in its decoder's
  prefill only), and matches within 1e-4 at n >= the window and for
  mamba2;
* the registry: ``ALL``'s names, ``param_counts`` of all twelve configs
  (the port's counted on the meta device), ``reduced()`` field for field,
  and the CLI's refusals of the four new configs (same exception type and
  message in both packages, in engine and ``--fixed-batch`` mode).

The tolerance 1e-4 is the reference suites' own for fp32 logits.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as j_configs
from repro.core import policy as j_policy
from repro.launch import serve as j_serve
from repro.models import registry as j_registry
from repro.models import transformer as j_transformer

from repro_torch import configs as t_configs
from repro_torch.core import policy as t_policy
from repro_torch.launch import serve as t_serve
from repro_torch.models import registry as t_registry
from repro_torch.models import transformer as t_transformer
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)

TOL = 1e-4
STEPS = 8
ARCHS = ("mamba2-370m", "recurrentgemma-2b", "whisper-medium", "pixtral-12b")
DECODER_ONLY = ("mamba2-370m", "recurrentgemma-2b", "pixtral-12b")
POLICY_KW = dict(block_size=8, stride=4, sink_blocks=1, local_blocks=1,
                 min_budget_blocks=2, ignore_missing=True)
# (prompt tokens, stub prefix positions) per arch: mamba2's 37 is not a
# multiple of its 32-token chunk, recurrentgemma's 40 passes its window of
# 32, whisper attends 16 stub frames, pixtral puts 16 patches before 48
# tokens (8 blocks of 8 for stem).
SHAPES = {"mamba2-370m": (37, 0), "recurrentgemma-2b": (40, 0),
          "whisper-medium": (64, 16), "pixtral-12b": (48, 16)}


def _config(mod, arch):
    return mod.reduced(mod.get_config(arch)).replace(dtype="float32")


_MODELS: dict = {}


def _model(arch):
    """(arch, jcfg, jax bundle, jax params, tcfg, port bundle, carried
    params), built once per arch in this process."""
    if arch not in _MODELS:
        jcfg, tcfg = _config(j_configs, arch), _config(t_configs, arch)
        jb, tb = j_registry.build(jcfg), t_registry.build(tcfg)
        jparams = jax.jit(jb.init_params)(jax.random.PRNGKey(0))
        tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                                  device="cpu")
        _MODELS[arch] = (arch, jcfg, jb, jparams, tcfg, tb, tparams)
    return _MODELS[arch]


def _policies():
    return (j_policy.get_policy("stem").with_updates(**POLICY_KW),
            t_policy.get_policy("stem").with_updates(**POLICY_KW))


def _batch(arch, b=2, n=None, seed=0):
    """numpy batch: tokens, labels and the stub prefix (frames or patches)."""
    n0, prefix = SHAPES[arch]
    n = n0 if n is None else n
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, 512, size=(b, n + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if arch == "whisper-medium":
        batch["frames"] = rng.randn(b, prefix, 64).astype(np.float32)
    if arch == "pixtral-12b":
        batch["patch_embeds"] = rng.randn(b, prefix, 64).astype(np.float32)
    return batch


def _split(batch):
    """(the JAX batch, the port's batch) without the labels."""
    j = {k: jnp.asarray(v) for k, v in batch.items() if k != "labels"}
    t = {k: torch.from_numpy(v) for k, v in batch.items() if k != "labels"}
    return j, t


def _close(got, want, atol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               atol=atol, rtol=0)


def _j_decode(jb):
    return jax.jit(lambda p, t, c: jb.decode_step(p, t, c))


def _prefill_fns(jb, tb, max_len, jpol=None, tpol=None):
    jfn = jax.jit(lambda p, b: jb.prefill(p, b, max_len=max_len, stem_cfg=jpol))
    return jfn, (lambda p, b: tb.prefill(p, b, max_len=max_len, stem_cfg=tpol))


def _prefix_len(batch):
    return sum(batch[k].shape[1] for k in ("patch_embeds",) if k in batch)


# ---------------------------------------------------------------------------
# loss_fn, prefill and greedy decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_jax(arch):
    arch, jcfg, jb, jparams, tcfg, tb, tparams = _model(arch)
    batch = _batch(arch, seed=1)
    jloss, jm = jax.jit(lambda p, b: jb.loss_fn(p, b))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, tm = tb.loss_fn(tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(tm) == set(jm)
    for key in jm:
        _close(tm[key], jm[key])
    assert abs(float(tloss) - float(jloss)) <= TOL


@pytest.mark.parametrize("arch,arm", [(a, "dense") for a in ARCHS] + [
    ("whisper-medium", "stem"), ("pixtral-12b", "stem")])
def test_prefill_and_greedy_decode_match_jax(arch, arm):
    """Prefill logits within 1e-4, then eight greedy decode steps from each
    package's own argmax: logits within 1e-4 at every step, streams equal.
    The stem arm runs for the configs with ``use_stem`` (whisper's decoder
    self-attention, pixtral)."""
    arch, jcfg, jb, jparams, tcfg, tb, tparams = _model(arch)
    assert tcfg.use_stem or arm == "dense"
    jpol, tpol = _policies() if arm == "stem" else (None, None)
    jbatch, tbatch = _split(_batch(arch, seed=2))
    n = SHAPES[arch][0] + _prefix_len(jbatch)
    jfn, tfn = _prefill_fns(jb, tb, n + STEPS, jpol, tpol)
    jl, jc = jfn(jparams, jbatch)
    tl, tc = tfn(tparams, tbatch)
    _close(tl, jl)
    jdec = _j_decode(jb)
    jtok = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
    ttok = torch.argmax(tl, -1)[:, None].to(torch.int32)
    jstream, tstream = [jtok], [ttok]
    for _ in range(STEPS):
        jl, jc = jdec(jparams, jtok, jc)
        tl, tc = tb.decode_step(tparams, ttok, tc)
        _close(tl, jl)
        jtok = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
        ttok = torch.argmax(tl, -1)[:, None].to(torch.int32)
        jstream.append(jtok)
        tstream.append(ttok)
    np.testing.assert_array_equal(torch.cat(tstream, 1).numpy(),
                                  np.asarray(jnp.concatenate(jstream, 1)))


@pytest.mark.parametrize("arch", ARCHS)
def test_caches_match_jax(arch):
    """The prefill's caches / recurrent states leaf for leaf (the ring
    cache after its roll, the SSD and RG-LRU states and conv tails, the
    cross K/V), and their ``init_caches`` shapes and dtypes."""
    arch, jcfg, jb, jparams, tcfg, tb, tparams = _model(arch)
    jbatch, tbatch = _split(_batch(arch, seed=3))
    n = SHAPES[arch][0] + _prefix_len(jbatch)
    jfn, tfn = _prefill_fns(jb, tb, n + STEPS)
    _, jc = jfn(jparams, jbatch)
    _, tc = tfn(tparams, tbatch)
    jleaves = jax.tree.leaves(jc)
    tleaves = jax.tree.leaves(tc)    # NamedTuples and lists: torch leaves
    assert len(tleaves) == len(jleaves)
    for got, want in zip(tleaves, jleaves):
        assert tuple(got.shape) == tuple(want.shape)
        _close(got, want)
    jinit = jb.init_caches(2, n + STEPS)
    tinit = tb.init_caches(2, n + STEPS, device="cpu")
    assert [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for t in jax.tree.leaves(tinit)] == \
        [(tuple(t.shape), str(t.dtype)) for t in jax.tree.leaves(jinit)]


# ---------------------------------------------------------------------------
# Evaluation passes of the decoder-only families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DECODER_ONLY)
def test_forward_hiddens_and_stats_match_jax(arch):
    arch, jcfg, jb, jparams, tcfg, tb, tparams = _model(arch)
    jbatch, tbatch = _split(_batch(arch, seed=4))
    jpol, tpol = _policies() if tcfg.use_stem else (None, None)
    jl, jh = jax.jit(lambda p, b: j_transformer.forward_hiddens(
        p, b, jcfg, stem_cfg=jpol))(jparams, jbatch)
    tl, th = t_transformer.forward_hiddens(tparams, tbatch, tcfg, stem_cfg=tpol)
    _close(tl, jl)
    assert len(th) == len(jh)
    for got, want in zip(th, jh):
        _close(got, want)
    jl, jrec = j_transformer.forward_with_stats(jparams, jbatch, jcfg, stem_cfg=jpol)
    tl, trec = t_transformer.forward_with_stats(tparams, tbatch, tcfg, stem_cfg=tpol)
    _close(tl, jl)
    assert [(r["layer"], r["kind"], r["policy"], r["stats"] is None) for r in trec] \
        == [(r["layer"], r["kind"], r["policy"], r["stats"] is None) for r in jrec]
    for t, j in zip(trec, jrec):
        if j["stats"] is not None:
            np.testing.assert_allclose(float(t["stats"].density),
                                       float(j["stats"].density), rtol=1e-6)
    if arch == "pixtral-12b":
        assert any(r["stats"] is not None and float(r["stats"].density) < 1.0
                   for r in trec)


# ---------------------------------------------------------------------------
# Faults of the reference that the port keeps
# ---------------------------------------------------------------------------

def _decode_gap(arch, prefill, decode, params, batch, n, to_host):
    """max |decode_step(prefill(n), token n) - prefill(n + 1)| of the
    logits, for one package."""
    pre = {k: v for k, v in batch.items() if k != "tokens"}
    _, caches = prefill(params, {**pre, "tokens": batch["tokens"][:, :n]})
    step, _ = decode(params, batch["tokens"][:, n:n + 1], caches)
    full, _ = prefill(params, {**pre, "tokens": batch["tokens"][:, :n + 1]})
    return float(np.abs(to_host(step) - to_host(full)).max())


@pytest.mark.parametrize("arch,n,faulty", [
    ("recurrentgemma-2b", 12, True),     # prompt shorter than the 32 window
    ("recurrentgemma-2b", 40, False),
    ("whisper-medium", 12, True),        # RoPE in the decoder's prefill only
    ("mamba2-370m", 12, False),
], ids=["recurrentgemma-short-prompt", "recurrentgemma-past-window",
        "whisper-prefill-rope", "mamba2"])
def test_reference_faults_pinned_in_both_packages(arch, n, faulty):
    """Decode after ``prefill(n)`` against ``prefill(n + 1)``'s logits, in
    each package: the port keeps the reference's two faults (gap > 1e-3)
    and its matches (gap < 1e-4)."""
    arch, jcfg, jb, jparams, tcfg, tb, tparams = _model(arch)
    batch = _batch(arch, b=1, n=n + 1, seed=5)
    max_len = n + 1 + _prefix_len(batch)
    jpre = jax.jit(lambda p, b: jb.prefill(p, b, max_len=max_len))
    gaps = [
        _decode_gap(arch, jpre, _j_decode(jb), jparams,
                    {k: jnp.asarray(v) for k, v in batch.items()}, n,
                    lambda a: np.asarray(a, np.float32)),
        _decode_gap(arch, lambda p, b: tb.prefill(p, b, max_len=max_len),
                    tb.decode_step, tparams,
                    {k: torch.from_numpy(v) for k, v in batch.items()}, n,
                    lambda t: t.float().numpy()),
    ]
    if faulty:
        assert min(gaps) > 1e-3, gaps
    else:
        assert max(gaps) < TOL, gaps


# ---------------------------------------------------------------------------
# Registry and the CLI's refusals
# ---------------------------------------------------------------------------

def test_registry_names_and_reduced_configs_match():
    assert list(t_configs.ALL) == list(j_configs.ALL)
    assert list(t_configs.ASSIGNED) == list(j_configs.ASSIGNED)
    assert list(t_configs.EXTRA) == list(j_configs.EXTRA)
    for name in j_configs.ALL:
        full_t, full_j = t_configs.get_config(name), j_configs.get_config(name)
        assert dataclasses.asdict(full_t) == dataclasses.asdict(full_j), name
        assert dataclasses.asdict(t_configs.reduced(full_t)) == \
            dataclasses.asdict(j_configs.reduced(full_j)), name
        if full_j.family != "encdec":
            assert t_transformer.layer_program(full_t) == \
                j_transformer.layer_program(full_j), name
    assert t_transformer.layer_program(t_configs.RECURRENTGEMMA_2B) == \
        [(8, ("rec", "rec", "dense_local")), (1, ("rec", "rec"))]


@pytest.mark.parametrize("name", list(j_configs.ALL))
def test_param_counts_match(name):
    """Total and active parameters, integer for integer, at full size (the
    port builds the tree on the meta device: nothing is allocated)."""
    assert t_registry.param_counts(t_configs.get_config(name)) == \
        j_registry.param_counts(j_configs.get_config(name))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches(arch):
    """The port's own init and the carried tree: the reference's keys,
    shapes and dtypes under the bf16 config (fp32 ``a_log`` / ``dt_bias``
    / ``d_skip`` / ``lam`` and embedding)."""
    jcfg = j_configs.reduced(j_configs.get_config(arch))
    tcfg = t_configs.reduced(t_configs.get_config(arch))
    want = {p: (tuple(v.shape), str(v.dtype)) for p, v in
            jax.tree_util.tree_flatten_with_path(
                j_registry.build(jcfg).abstract_params()[0])[0]}
    want = {tuple(k.key for k in p): v for p, v in want.items()}
    own = t_registry.build(tcfg).init_params(torch.Generator().manual_seed(0),
                                             device="cpu")
    jparams = jax.jit(j_registry.build(jcfg).init_params)(jax.random.PRNGKey(0))
    carried = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    for tree in (own, carried):
        got = {}

        def walk(node, path=()):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, path + (k,))
            else:
                got[path] = (tuple(node.shape), str(node.dtype).replace("torch.", ""))
        walk(tree)
        assert got == want


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", [[], ["--fixed-batch"]], ids=["engine", "fixed-batch"])
def test_cli_refusals_match_reference(arch, mode):
    """``main`` refuses each new config as the reference's does: whisper and
    pixtral before the model is built (their inputs are not token prompts),
    mamba2 and recurrentgemma in the engine (no page layout) and in the
    fixed batch (ragged padding would enter their states)."""
    argv = ["--arch", arch, "--reduced", "--requests", "2", "--decode-tokens", "3",
            "--min-prompt", "8", "--max-prompt", "16"] + mode
    with pytest.raises(Exception) as want:
        j_serve.main(argv)
    with pytest.raises(Exception) as got:
        t_serve.main(argv + ["--device", "cpu"])
    assert type(got.value) is type(want.value) is NotImplementedError
    assert str(got.value) == str(want.value)
