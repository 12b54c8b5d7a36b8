"""Tensor-parallel compute of the port's modules over CPU model shards.

Each module's parameters are placed in the rules' blocks on a (1, tp) mesh
of CPU shards (``sharding.arrays.place``), each block an autograd leaf, and
run inside ``sharding.context.model_parallel``, where ``arrays.materialize``
gives the model-axis blocks as ``ModelShards``: attention by heads (GQA
with whole groups, with groups split over shards under a group-pooled Stem
metric, with KV heads the rules leave whole; the windowed path), MLA by
heads, both MLP forms by ``mlp``, the embedding, logits and CE by
``vocab`` (a masked CE too), the MoE FFN's dense parts beside its
experts, the SSD by heads (the packed ``w_in`` / conv blocks cut inside a
segment; heads the rules leave whole), the RG-LRU by channels (a width
the rules leave whole), the cross attention and whisper's encoder and
decoder layers by heads and ``mlp``.  The forward output and the gradient of every parameter (its
blocks' gradients put together) equal the whole computation on plain
tensors within 1e-6 of the largest |value| in fp32 (the shards' sums run
in another order); at tp 1 bitwise.  The two collectives' backward is
held to ``torch.autograd.gradcheck`` in float64, and no tensor of a
tensor-parallel train step holds the ``(b, s, vocab)`` logits.

The whole computations are the port's one-device modules, which
``tests/test_torch_model.py``, ``test_torch_mla.py`` and
``test_torch_moe.py`` hold to the reference; the tensor-parallel train step
is held to the reference's sharded step in
``tests/test_torch_mesh_training*.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs as t_configs
from repro_torch.core.config import StemConfig
from repro_torch.launch import mesh as t_mesh
from repro_torch.models import attention, common, mla, mlp, moe
from repro_torch.sharding import arrays
from repro_torch.sharding import context as shctx
from repro_torch.sharding import rules

torch.set_num_threads(1)

TPS = (1, 2, 4)
B, S = 2, 64
POLICY = StemConfig(block_size=16, min_budget_blocks=2, sink_blocks=1, local_blocks=1,
                    stride=4)


def _draw(build, cfg, seed=0):
    """(params, their logical axes) of ``build(ini)``, fp32 on the CPU; the
    norms and biases drawn non-zero, so their gradients are exercised."""
    ini = common.Initializer(torch.Generator().manual_seed(seed), torch.float32, "cpu")
    params = build(ini)
    axes = ini.axes_tree(params)
    gen = torch.Generator().manual_seed(seed + 1)
    small = lambda t: t.ndim == 1 or (t.ndim == 2 and t.shape[-1] == cfg.head_dim)
    params = rules.tree_map(lambda t: t + 0.1 * torch.randn(t.shape, generator=gen)
                            if small(t) else t, params)
    return params, axes


def _x(shape, seed=7):
    return torch.from_numpy(np.random.RandomState(seed).standard_normal(shape)
                            .astype(np.float32))


def _whole(fn, params, *inputs):
    """(output, gradient tree) of ``fn`` on plain tensors."""
    leaves = rules.tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    out = fn(leaves, *inputs)
    _backward(out)
    return out.detach(), rules.tree_map(lambda t: t.grad if t.grad is not None
                                        else torch.zeros_like(t), leaves)


def _backward(out):
    w = _x(tuple(out.shape), seed=11)
    (out * w).sum().backward() if out.ndim else out.backward()


def _split(fn, params, axes, cfg, tp, *inputs):
    """(output, gradient tree) of ``fn`` with ``params`` in the rules'
    blocks on a (1, tp) mesh, inside ``model_parallel``."""
    mesh = t_mesh.make_mesh((1, tp), ("data", "model"), platform="cpu")
    sh = rules.tree_map(lambda ax, t: rules.NamedSharding(mesh, rules.spec_for(
        tuple(t.shape), ax, rules.logical_rules(cfg, mesh), mesh)), axes, params,
        is_leaf=rules.is_axes)
    placed = rules.tree_map(lambda t, s: arrays.place(t.detach(), s).map_blocks(
        lambda b: b.requires_grad_()), params, sh)
    with shctx.model_parallel(mesh, (0, 0)):
        view = arrays.materialize(placed, "cpu")
        out = fn(view, *inputs)
        _backward(out)

    def grad(a):
        full = torch.zeros(a.shape)
        for bounds, t in a.unique_blocks():
            if t.grad is not None:
                full[tuple(slice(*b) for b in bounds)] = t.grad
        return full
    return out.detach(), rules.tree_map(grad, placed), view


def _close(got, want, tp, what):
    if tp == 1:
        assert torch.equal(got, want), what
        return
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max())
    assert err <= 1e-6 * scale, f"{what}: {err:.3e} > 1e-6 * {scale:.3e}"


def check(fn, build, cfg, tp, *inputs, split=()):
    """The module docstring's rule for ``fn`` over ``build``'s parameters;
    ``split`` names leaves that must arrive in model shards."""
    params, axes = _draw(build, cfg)
    want, want_g = _whole(fn, params, *inputs)
    got, got_g, view = _split(fn, params, axes, cfg, tp, *inputs)
    _close(got, want, tp, "output")
    flat = lambda tree, pre="": ([x for k, v in tree.items() for x in flat(v, f"{pre}/{k}")]
                                 if isinstance(tree, dict) else [(pre, tree)])
    for (path, g), (_, w) in zip(flat(got_g), flat(want_g)):
        _close(g, w, tp, f"grad {path}")
    views = dict(flat(view))
    for name in split:
        assert isinstance(views[name], arrays.ModelShards), name
        assert len(views[name].parts) == tp
    return views


def _cfg(arch, **kw):
    return dataclasses.replace(t_configs.reduced(t_configs.get_config(arch)).replace(
        dtype="float32"), **kw)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

ATTN = {
    # (arch, heads, kv heads, policy): whole groups at tp 2 and 4 (8 / 4,
    # group 2)
    "whole_groups": ("qwen3-0.6b", 8, 4, None),
    "whole_groups_stem": ("qwen3-0.6b", 8, 4, dataclasses.replace(POLICY, group_reduce="mean")),
    # 8 / 2: at tp 4 a group of 4 spans 2 shards and the KV heads do not
    # divide the model axis (replicated, sent to the shards that read them)
    "split_groups_mean": ("qwen3-0.6b", 8, 2, dataclasses.replace(POLICY, group_reduce="mean")),
    "split_groups_max": ("qwen1.5-4b", 8, 2, dataclasses.replace(POLICY, group_reduce="max")),
    "replicated_kv_dense": ("qwen1.5-4b", 8, 2, None),
    "per_head_metric": ("qwen3-0.6b", 8, 2, POLICY),
}


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("case", sorted(ATTN))
def test_attention_by_heads(case, tp):
    arch, h, hk, pol = ATTN[case]
    cfg = _cfg(arch, num_heads=h, num_kv_heads=hk)
    x = _x((B, S, cfg.d_model))
    pos = torch.arange(S)
    fn = lambda p, x: attention.apply_full(p, x, cfg, positions=pos, stem_cfg=pol)
    views = check(fn, lambda ini: attention.init(ini, cfg), cfg, tp, x, split=("/wq", "/wo"))
    assert isinstance(views["/wk"], arrays.ModelShards) == (tp > 1 and hk % tp == 0) \
        or tp == 1


@pytest.mark.parametrize("tp", TPS)
def test_windowed_attention_by_heads(tp):
    cfg = _cfg("recurrentgemma-2b", num_heads=4, num_kv_heads=1)
    x = _x((B, S, cfg.d_model))
    fn = lambda p, x: attention.apply_full(p, x, cfg, positions=torch.arange(S),
                                           window=cfg.rglru.window)
    check(fn, lambda ini: attention.init(ini, cfg), cfg, tp, x, split=("/wq",))


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("pol", [None, POLICY], ids=["dense", "stem"])
def test_mla_by_heads(tp, pol):
    cfg = _cfg("deepseek-v3-671b")
    x = _x((B, S, cfg.d_model))
    fn = lambda p, x: mla.apply_full(p, x, cfg, positions=torch.arange(S), stem_cfg=pol)
    check(fn, lambda ini: mla.init(ini, cfg), cfg, tp, x,
          split=("/w_uq", "/w_uk", "/w_uv", "/wo"))


# ---------------------------------------------------------------------------
# MLP, MoE dense parts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("activation", ["silu", "gelu", "gelu_mlp"])
def test_mlp_by_columns_and_rows(activation, tp):
    cfg = _cfg("qwen3-0.6b")
    x = _x((B, S, cfg.d_model))
    names = ("/w_gate", "/w_up", "/w_down") if activation != "gelu_mlp" else \
        ("/w_in", "/b_in", "/w_out")
    check(lambda p, x: mlp.apply(p, x, activation),
          lambda ini: mlp.init(ini, cfg.d_model, cfg.d_ff, activation), cfg, tp, x,
          split=names)


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("arch", ["arctic-480b", "deepseek-v3-671b"])
def test_moe_dense_parts_and_experts(arch, tp):
    cfg = _cfg(arch)
    x = _x((B, 32, cfg.d_model))
    part = "/residual/w_down" if cfg.moe.residual_dense else "/shared/w_down"
    fn = lambda p, x: sum(t.sum() * w for t, w in zip(moe.apply(p, x, cfg.moe,
                                                                 cfg.activation), (1.0, 10.0)))
    fn_y = lambda p, x: moe.apply(p, x, cfg.moe, cfg.activation)[0]
    views = check(fn_y, lambda ini: moe.init(ini, cfg.d_model, cfg.moe, cfg.activation),
                  cfg, tp, x, split=(part,))
    assert isinstance(views["/w_gate"], arrays.ShardedArray)     # experts at use
    assert not isinstance(views["/router"], arrays.ModelShards)  # the router whole
    check(fn, lambda ini: moe.init(ini, cfg.d_model, cfg.moe, cfg.activation), cfg, tp, x)


# ---------------------------------------------------------------------------
# the SSD, the RG-LRU and the encoder-decoder's layers
# ---------------------------------------------------------------------------

SSD = {
    # the reduced mamba2-370m: w_in's 296 packed columns (z | x | B | C | dt)
    # cut at 148 (inside x) at tp 2 and every 74 at tp 4, the conv's 160 at
    # 80 / 40; every shard takes its heads' columns from other shards' blocks
    "packed_cut": dict(d_model=64),
    # 6 heads: split at tp 2 (w_in's 230 columns cut at 115, inside x); at
    # tp 4 the rules leave the heads and w_in whole while the conv, the norm
    # and w_out split: the block computes whole on the lead shard
    "heads_whole_at_4": dict(d_model=48),
}


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("case", sorted(SSD))
def test_ssd_by_heads(case, tp):
    from repro_torch.models import ssd
    cfg = _cfg("mamba2-370m", **SSD[case])
    heads = cfg.ssd.expand * cfg.d_model // cfg.ssd.head_dim
    x = _x((B, S, cfg.d_model))
    split = ("/a_log", "/w_in", "/conv_w", "/norm", "/w_out") if heads % tp == 0 else \
        ("/conv_w", "/norm", "/w_out")
    views = check(lambda p, x: ssd.apply_full(p, x, cfg), lambda ini: ssd.init(ini, cfg),
                  cfg, tp, x, split=split)
    assert isinstance(views["/a_log"], arrays.ModelShards) == (heads % tp == 0)


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("width", [64, 66], ids=["split", "whole_at_4"])
def test_rglru_by_channels(width, tp):
    from repro_torch.models import rglru
    cfg = _cfg("recurrentgemma-2b")
    cfg = dataclasses.replace(cfg, rglru=dataclasses.replace(cfg.rglru, lru_width=width))
    x = _x((B, S, cfg.d_model))
    names = ("/w_in", "/w_gate_branch", "/conv_w", "/w_a", "/w_x", "/lam", "/w_out")
    views = check(lambda p, x: rglru.apply_full(p, x, cfg), lambda ini: rglru.init(ini, cfg),
                  cfg, tp, x, split=names if width % tp == 0 else ())
    assert all(isinstance(views[k], arrays.ModelShards) == (width % tp == 0) for k in names)


FRAMES = 24


@pytest.mark.parametrize("tp", TPS)
def test_cross_attention_by_heads(tp):
    cfg = _cfg("whisper-medium")
    x, enc = _x((B, S, cfg.d_model)), _x((B, FRAMES, cfg.d_model), seed=8)
    fn = lambda p, x, enc: attention.apply_cross(p, x, *attention.cross_kv(p, enc),
                                                 cfg.head_dim)
    check(fn, lambda ini: attention.init_cross(ini, cfg), cfg, tp, x, enc,
          split=("/wq", "/wk", "/wv", "/wo"))


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("layer", ["encoder", "decoder", "decoder_stem"])
def test_whisper_layers_by_heads_and_mlp(layer, tp):
    from repro_torch.models import encdec
    cfg = _cfg("whisper-medium")
    x, enc = _x((B, S, cfg.d_model)), _x((B, FRAMES, cfg.d_model), seed=8)
    pos = torch.arange(S)
    if layer == "encoder":
        fn = lambda p, x: encdec.enc_layer(p, x, cfg, positions=pos)
        views = check(fn, lambda ini: encdec._init_enc_layer(ini, cfg), cfg, tp, x,
                      split=("/attn/wq", "/attn/wk", "/attn/wo", "/ffn/w_in", "/ffn/w_out"))
    else:
        pol = POLICY if layer == "decoder_stem" else None
        fn = lambda p, x, enc: encdec.dec_layer(p, x, enc, cfg, positions=pos, stem_cfg=pol)
        views = check(fn, lambda ini: encdec._init_dec_layer(ini, cfg), cfg, tp, x, enc,
                      split=("/self_attn/wq", "/self_attn/wo", "/cross_attn/wq",
                             "/cross_attn/wk", "/cross_attn/wo", "/ffn/w_in"))
    assert not isinstance(views["/norm1"], arrays.ModelShards)


# ---------------------------------------------------------------------------
# vocab-parallel embedding, logits and CE
# ---------------------------------------------------------------------------

def _ids(shape, vocab, seed):
    return torch.from_numpy(np.random.RandomState(seed).randint(0, vocab, shape))


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("tied,masked", [(True, False), (False, False), (True, True)],
                         ids=["tied", "untied", "tied_masked"])
def test_vocab_parallel_embedding_logits_ce(tied, masked, tp):
    cfg = _cfg("qwen3-0.6b")
    V = cfg.padded_vocab
    tokens, labels = _ids((B, S), cfg.vocab_size, 1), _ids((B, S), cfg.vocab_size, 2)
    mask = torch.from_numpy(np.random.RandomState(3).rand(B, S) < 0.6) if masked else None

    def build(ini):
        p = {"embed": common.embed_init(ini, V, cfg.d_model)}
        if not tied:
            p["head"] = ini.normal((cfg.d_model, V), ("embed", "vocab"), scale=0.02)
        return p

    def fn(p, tokens, labels):
        x = common.embed_lookup(p["embed"], tokens, torch.float32)
        x = torch.tanh(x * 3.0)
        logits = (common.lm_logits(x, p["embed"]) if tied
                  else common.head_logits(x, p["head"], "bsd,dv->bsv"))
        return common.cross_entropy(logits, labels, mask)

    check(fn, build, cfg, tp, tokens, labels, split=("/embed",) + (() if tied else ("/head",)))


class _LargestLastDim(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.shapes = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (list, tuple)) else [out]:
            if isinstance(t, torch.Tensor):
                self.shapes.add(tuple(t.shape))
        return out


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v3-671b"])
def test_no_device_holds_the_vocab_logits(arch):
    """A tensor-parallel train step (2, 2) makes no tensor whose last dim is
    the padded vocab but the table (and its gradient); every step at (2, 1)
    makes the (b, s, vocab) logits."""
    from repro_torch import optim
    from repro_torch.data import SyntheticLMData, make_global_batch
    from repro_torch.launch import steps
    from repro_torch.models import registry
    cfg = _cfg(arch)
    bundle = registry.build(cfg)
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4, seed=0)
    opt = optim.AdamWConfig(grad_dtype=None)
    found = {}
    for shape in ((2, 1), (2, 2)):
        mesh = t_mesh.make_mesh(shape, ("data", "model"), platform="cpu")
        av, ax = bundle.abstract_params()
        ssh = steps.opt_state_shardings(cfg, mesh, rules.param_shardings(cfg, mesh, av, ax), av)
        bsh = rules.batch_sharding(cfg, mesh, {k: torch.empty(v.shape, device="meta")
                                               for k, v in data.batch_at(0).items()})
        state = steps.place_state(optim.init_state(bundle.init_params(
            torch.Generator().manual_seed(0), device="cpu"), opt), ssh)
        mode = _LargestLastDim()
        with mode:
            steps.make_train_step(bundle, opt, grad_shardings=ssh.master)(
                state, make_global_batch(data.batch_at(0), mesh, bsh))
        found[shape] = {s for s in mode.shapes if len(s) == 3 and s[-1] == cfg.padded_vocab}
    assert found[(2, 1)], "the data-parallel step should hold the logits"
    assert not found[(2, 2)], found[(2, 2)]


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", (2, 4))
def test_collectives_gradcheck(tp):
    mesh = t_mesh.make_mesh((1, tp), ("data", "model"), platform="cpu")
    mp = shctx.model_shards_of(mesh, (0, 0))
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 4, 3), generator=gen, dtype=torch.float64, requires_grad=True)
    # (the shards' tensors alias x on its own device: gradcheck perturbs x in
    # place, so it reads copies of them)
    copies = lambda outs: tuple(o.clone() for o in outs)
    assert torch.autograd.gradcheck(lambda x: copies(arrays.to_model_shards(x, mp)), (x,))
    bounds = [(t * 4 // tp // 2, (t + 1) * 4 // tp // 2 + 1) for t in range(tp)]  # overlap
    assert torch.autograd.gradcheck(
        lambda x: copies(arrays.to_model_shards(x, mp, 1, bounds)), (x,))
    parts = [torch.randn((2, 3), generator=gen, dtype=torch.float64, requires_grad=True)
             for _ in range(tp)]
    assert torch.autograd.gradcheck(
        lambda *p: arrays.reduce_from_model_shards(list(p), mp), tuple(parts))
    # the sum in rank order, in fp32, whatever the parts' dtype
    half = [p.detach().to(torch.bfloat16) for p in parts]
    want = half[0].float()
    for p in half[1:]:
        want = want + p.float()
    assert torch.equal(arrays.reduce_from_model_shards(half, mp), want.to(torch.bfloat16))
