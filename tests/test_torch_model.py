"""Differential tests: the port's model against the JAX reference on the
engine-test config (2 layers, d_model 32, 4/2 heads, head_dim 8, fp32,
qk-norm).  Weights are carried across with ``from_jax_params``; two
``paged_mixed_step`` calls (a chunk lane alone, then a decode lane beside a
chunk lane) must give the same logits and the same pool leaves (k, v, kg,
vm) within 1e-4."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as j_configs
from repro.configs.base import ArchConfig as JArch
from repro.core import chunked as j_chunked
from repro.core.config import StemConfig as JStem
from repro.kernels import paged_attn as _j_kern  # noqa: F401 (registers "pallas")
from repro.models import common as j_common
from repro.models import registry as j_registry
from repro.models import transformer as j_transformer

from repro_torch import configs as t_configs
from repro_torch.configs.base import ArchConfig as TArch
from repro_torch.core.config import StemConfig as TStem
from repro_torch.models import common as t_common
from repro_torch.models import registry as t_registry
from repro_torch.models import transformer as t_transformer
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)

TOL = 1e-4
TINY = dict(name="engine-tiny", family="dense", num_layers=2, d_model=32,
            num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64, vocab_size=64,
            qk_norm=True, dtype="float32")
STEM = dict(block_size=8, sink_blocks=1, local_blocks=1, min_budget_blocks=2,
            stride=4)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = JArch(**TINY), TArch(**TINY)
    jparams = j_registry.build(jcfg).init_params(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jparams, tcfg, tparams


def test_from_jax_params_tree(models):
    _, jparams, tcfg, tparams = models
    jleaves = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(jleaves) == sum(1 for _ in _walk(tparams))
    for path, leaf in jleaves:
        node = tparams
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        assert node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert tparams["segment0"]["sub0"]["attn"]["wq"].shape[0] == tcfg.num_layers
    # the port's own initializer builds the same tree, shapes and dtypes
    own = t_registry.build(tcfg).init_params(torch.Generator().manual_seed(0),
                                             device="cpu")
    for (pa, a), (pb, b) in zip(sorted(_walk(own)), sorted(_walk(tparams))):
        assert pa == pb and a.shape == b.shape and a.dtype == b.dtype


@pytest.mark.parametrize("reduce", [False, True])
def test_qwen3_config_matches(reduce):
    """qwen3-0.6b (and its reduced variant) carries the reference's fields."""
    jcfg = j_configs.get_config("qwen3-0.6b")
    tcfg = t_configs.get_config("qwen3-0.6b")
    if reduce:
        jcfg, tcfg = j_configs.reduced(jcfg), t_configs.reduced(tcfg)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.padded_vocab == jcfg.padded_vocab
    assert tcfg.torch_dtype == torch.bfloat16


def _walk(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, prefix + (k,))
    else:
        yield prefix, tree


def test_norm_rope_embed_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 5, 8)).astype(np.float32)
    w = rng.standard_normal((8,)).astype(np.float32)
    np.testing.assert_allclose(
        t_common.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(j_common.rms_norm(x, w)), atol=TOL, rtol=0)
    for pos in (np.arange(5), np.array([[3, 4, 5, 6, 7], [0, 9, 20, 1, 2]])):
        np.testing.assert_allclose(
            t_common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                1e6).numpy(),
            np.asarray(j_common.apply_rope(x, jnp.asarray(pos), 1e6)),
            atol=TOL, rtol=0)
    table = rng.standard_normal((16, 8)).astype(np.float32)
    toks = np.array([[1, 5], [15, 0]], np.int32)
    np.testing.assert_allclose(
        t_common.lm_logits(t_common.embed_lookup(
            torch.from_numpy(table), torch.from_numpy(toks), torch.float32),
            torch.from_numpy(table)).numpy(),
        np.asarray(j_common.lm_logits(j_common.embed_lookup(
            table, toks, jnp.float32), table)), atol=TOL, rtol=0)


def _assert_pools(tpools, jpools):
    for tseg, jseg in zip(tpools, jpools):
        for name, got, want in zip(("k", "v", "kg", "vm"), tseg["sub0"],
                                   jseg["sub0"]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                       rtol=0, err_msg=name)


@pytest.mark.parametrize("executors", [("xla", "gather"), ("pallas", "fused")])
@pytest.mark.parametrize("budget_frac", [1.0, 0.5])
def test_paged_mixed_step_matches(models, executors, budget_frac):
    jcfg, jparams, tcfg, tparams = models
    jex, tex = executors
    jstem, tstem = JStem(**STEM), TStem(**STEM, backend=tex)
    bs, C, P, S = 8, 16, 5, 2
    rng = np.random.RandomState(3)
    prompt_a = rng.randint(0, 64, size=(13,)).astype(np.int32)
    prompt_b = rng.randint(0, 64, size=(21,)).astype(np.int32)
    num_pages = 12
    jpools = j_transformer.init_page_pools(jcfg, num_pages, jstem)
    tpools = t_transformer.init_page_pools(tcfg, num_pages, tstem, device="cpu")
    row_a = np.array([1, 2, 3, 0, 0], np.int32)
    row_b = np.array([4, 5, 6, 7, 0], np.int32)

    def chunk_of(prompt, row, start):
        toks = np.zeros((1, C), np.int32)
        part = prompt[start:start + C]
        toks[0, :len(part)] = part
        padded = -(-len(prompt) // bs) * bs
        return {"tokens": toks, "page_table": row[None].copy(),
                "start": np.array([start], np.int32),
                "true_len": np.array([len(prompt)], np.int32),
                "budgets": j_chunked.chunk_budget_rows(jstem, padded, start, C // bs)[None],
                "last": np.array([min(max(len(prompt) - 1 - start, 0), C - 1)],
                                 np.int32)}

    steps = [
        # chunk lane alone (decode lane idle: zero table, zero lengths)
        (np.zeros((S, 1), np.int32), np.zeros((S, P), np.int32),
         np.zeros((S,), np.int32), chunk_of(prompt_a, row_a, 0)),
        # a decode token for A beside B's first chunk
        (np.array([[7], [0]], np.int32), np.stack([row_a, np.zeros(P, np.int32)]),
         np.array([13, 0], np.int32), chunk_of(prompt_b, row_b, 0)),
        # decode only
        (np.array([[9], [0]], np.int32), np.stack([row_a, np.zeros(P, np.int32)]),
         np.array([14, 0], np.int32), None),
    ]
    k_max = 3
    for tokens, table, lens, chunk in steps:
        jdec, jch, jpools = j_transformer.paged_mixed_step(
            jparams, jnp.asarray(tokens), jpools, jnp.asarray(table),
            jnp.asarray(lens), jcfg, stem_cfg=jstem, budget_frac=budget_frac,
            chunk=None if chunk is None else jax.tree.map(jnp.asarray, chunk),
            chunk_k_max=k_max, executor=jex)
        tdec, tch, tpools = t_transformer.paged_mixed_step(
            tparams, torch.from_numpy(tokens), tpools, torch.from_numpy(table),
            torch.from_numpy(lens), tcfg, stem_cfg=tstem, budget_frac=budget_frac,
            chunk=None if chunk is None else {k: torch.from_numpy(v)
                                              for k, v in chunk.items()},
            chunk_k_max=k_max)
        np.testing.assert_allclose(tdec.numpy(), np.asarray(jdec), atol=TOL, rtol=0)
        if chunk is not None:
            np.testing.assert_allclose(tch.numpy(), np.asarray(jch), atol=TOL,
                                       rtol=0)
        _assert_pools(tpools, jpools)
