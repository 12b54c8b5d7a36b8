"""The dry run of the port's mesh train step (``launch/dryrun.py``) and its
counter (``launch/cost_analysis.py``).

(i) The counter against closed forms, the counterpart of
``tests/test_hlo_analysis.py``: an L-layer chain of matrix products counts
2 M N K a product, forward and backward, plus the recompute of a
``remat`` body; the collectives of the tensor-parallel pair at their
multipliers; a freed tensor leaves the live bytes.

(ii) For the reduced fp32 qwen3-0.6b, arctic-480b (MoE, FSDP) and
deepseek-v3-671b (MLA, MoE, MTP, FSDP) on (2, 2) and (1, 4) meshes of
``meta`` devices, each coordinate's argument bytes (its blocks of the
ZeRO-1 master, mu, nu, the step counter and the batch) equal the bytes of
the reference's ``addressable_shards`` on that device, exactly.  The
reference runs in a module-scoped subprocess on 8 forced host devices.

(iii) The matrix-product flops of the lead model shard of the first data
shard against ``hlo_analysis.analyze_hlo(...).flops_by_op["dot"]`` of the
reference's jitted sharded train step (the dry run's: ``remat``, the
config's microbatches, no policy, inside ``sharding.context.use``), per
device, on the same meshes: within ``DOT_TOLERANCE`` (5 %; the largest
deviation measured is 3.1 %, the reduced arctic-480b at (1, 4)).  The
reference's attention is XLA's dense (s x s) products, the port's the
flash kernel's shape-only path (counted as a kernel, by its causal
pairs): the reference's attention products, 4 x 2 (d + dv) s^2 rows x
heads a layer (forward, remat, backward twice), are added to the port's
count.  Where the rules leave a dim whole (the reduced MoE configs' one
KV head, the router, MLA's latents) the port computes it once, on the lead
shard, and the reference on every shard: the lead shard is compared.
qwen3-0.6b runs at its published widths cut to one layer: at the reduced
widths the reference's partitioner does not split the MLP and the logits
over the model axis at (2, 2) (its products there are the whole ``d_ff``
and vocab; 1.68x the split count), so the comparison would measure that
choice.  The collective counts of both are printed.

The SSD, RG-LRU and whisper layers of the reduced configs count below
their (1, 1) count on the lead model shard of a (1, 4) ``meta`` mesh, and
no model-axis leaf of a dry-run step is gathered whole inside
``model_parallel``.

(iv) ``--arch qwen3-0.6b`` and ``--arch gemma-2b`` on the 16 x 16 grid of
``meta`` devices write every key of the reference's record; the seconds
each took on the CPU are printed (PERF.md quotes them).
"""
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from repro_torch import configs as t_configs
from repro_torch.configs.base import RunShape
from repro_torch.kernels import cost as kernel_cost
from repro_torch.launch import cost_analysis, dryrun
from repro_torch.launch import mesh as t_mesh
from repro_torch.sharding import arrays
from repro_torch.sharding import context as shctx

from test_torch_mesh_training import ROOT

torch.set_num_threads(1)

SHAPE = RunShape("train_small", 128, 16, "train")
MESHES = [(2, 2), (1, 4)]
ARCHS = ("qwen3-0.6b", "arctic-480b", "deepseek-v3-671b")
DOT_TOLERANCE = 0.05

# The reference's side on 8 host devices; argv: archs, npz path.  An arch
# suffixed ":1" runs at its published widths cut to one layer.
JAX_SCRIPT = r"""
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from repro import configs, optim
from repro.configs.base import RunShape
from repro.launch import hlo_analysis
from repro.launch import steps as steps_lib
from repro.models import registry
from repro.sharding import context as shctx
from repro.sharding import rules as rules_lib

SHAPE = RunShape("train_small", 128, 16, "train")
assert len(jax.devices()) >= 8, jax.devices()
out = {}
for name in sys.argv[1].split(","):
    arch, _, layers = name.partition(":")
    cfg = (configs.get_config(arch).replace(num_layers=int(layers)) if layers
           else configs.reduced(configs.get_config(arch))).replace(dtype="float32")
    bundle = registry.build(cfg)
    av, ax = bundle.abstract_params()
    opt_cfg = optim.AdamWConfig(moment_dtype="bfloat16" if cfg.fsdp_weights else "float32")
    for shape in ((2, 2), (1, 4)):
        key = f"{name}/{shape[0]}x{shape[1]}"
        mesh = Mesh(np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape),
                    ("data", "model"))
        coord_of = {d.id: c for c, d in np.ndenumerate(mesh.devices)}
        psh = rules_lib.param_shardings(cfg, mesh, av, ax)
        ssh = steps_lib.opt_state_shardings(cfg, mesh, psh, av)
        specs = registry.input_specs(cfg, SHAPE)
        bsh = rules_lib.batch_sharding(cfg, mesh, specs)
        state = steps_lib.abstract_opt_state(av, opt_cfg)
        if not layers:
            per = {}
            for leaf, sh in zip(jax.tree.leaves((state, specs)), jax.tree.leaves((ssh, bsh))):
                arr = jax.device_put(jnp.zeros(leaf.shape, leaf.dtype), sh)
                for s in arr.addressable_shards:
                    c = "_".join(map(str, coord_of[s.device.id]))
                    per[c] = per.get(c, 0) + s.data.nbytes
            for c, n in per.items():
                out[f"{key}/args/{c}"] = np.int64(n)
        step = steps_lib.make_train_step(bundle, opt_cfg, stem_cfg=None, remat=True,
                                         microbatches=cfg.train_microbatches,
                                         grad_shardings=ssh.master)
        with mesh, shctx.use(cfg, mesh):
            compiled = jax.jit(step, in_shardings=(ssh, bsh), donate_argnums=(0,)).lower(
                state, specs).compile()
        cost = hlo_analysis.analyze_hlo(compiled.as_text())
        out[f"{key}/dot"] = np.float64(cost.flops_by_op.get("dot", 0.0))
        for k, v in cost.coll_counts.items():
            out[f"{key}/coll/{k}"] = np.float64(v)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_dryrun") / "dry.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    archs = ",".join(("qwen3-0.6b:1",) + ARCHS)
    res = subprocess.run([sys.executable, "-c", JAX_SCRIPT, archs, str(path)], env=env,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _meta_mesh(shape):
    return t_mesh.make_mesh(shape, ("data", "model"),
                            [torch.device("meta")] * (shape[0] * shape[1]))


def _cfg(name):
    arch, _, layers = name.partition(":")
    cfg = (t_configs.get_config(arch).replace(num_layers=int(layers)) if layers
           else t_configs.reduced(t_configs.get_config(arch)))
    return cfg.replace(dtype="float32")


# ---------------------------------------------------------------------------
# (i) the counter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_matmul_chain_against_closed_forms(device, remat):
    L, M, N = 5, 32, 48
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((M, N), generator=gen).to(device)
    ws = [torch.randn((N, N), generator=gen).to(device).requires_grad_() for _ in range(L)]
    body = lambda h, w: torch.tanh(h @ w)
    mode = cost_analysis.CostMode(default=(0,))
    with mode:
        h = x
        for w in ws:
            h = (torch.utils.checkpoint.checkpoint(body, h, w, use_reentrant=False)
                 if remat else body(h, w))
        h.sum().backward()
    c = mode.costs[(0,)]
    one = 2.0 * M * N * N
    # forward, then the backward's two products (the first layer's input
    # needs no gradient: one), and with remat each body once more
    want = L * one + (2 * L - 1) * one + (L * one if remat else 0)
    assert c.flops_by_op["dot"] == want, (c.flops_by_op, want)
    assert c.flops_by_op["elementwise"] >= L * M * N        # tanh, at least
    assert c.bytes_min >= L * (M * N + N * N + M * N) * 4
    assert c.bytes >= c.bytes_min
    assert 0 < c.peak and c.live < c.peak


def test_live_bytes_see_a_free():
    mode = cost_analysis.CostMode(default=(0,))
    with mode:
        a = torch.empty((1024,), device="meta")
        b = torch.empty((256,), device="meta")
        v = a[:10]                                  # a view allocates nothing
        assert mode.costs[(0,)].live == 1280 * 4
        del a
        assert mode.costs[(0,)].live == 1280 * 4    # the view holds its base
        del v
        assert mode.costs[(0,)].live == 256 * 4
        del b
    assert mode.costs[(0,)].live == 0 and mode.costs[(0,)].peak == 1280 * 4


@pytest.mark.parametrize("tp", [2, 4])
def test_tensor_parallel_collectives_counted(tp):
    """A broadcast and a sum over tp model shards: each coordinate moves its
    part once each way (the ring all-reduce's 2x), each op is counted on the
    shard it runs for, and the attention kernel's shape-only path reports
    its causal pairs and heads."""
    from repro_torch.kernels import flash_attention as flash
    mesh = _meta_mesh((1, tp))
    mp = shctx.model_shards_of(mesh, (0, 0))
    mode = cost_analysis.CostMode(default=(0, 0))
    b, h, n, d = 2, 4 * tp, 64, 16
    x = torch.empty((b, n, d), device="meta", requires_grad=True)
    with kernel_cost.counting(mode), mode:
        xs = arrays.to_model_shards(x, mp)
        parts = []
        for t in range(tp):
            with mp.on(t):
                q = (xs[t] * 2.0)[:, None].expand(b, 4, n, d).contiguous()
                parts.append(flash.attention(q, q, q).sum(dim=1))
        arrays.reduce_from_model_shards(parts, mp).sum().backward()
    part = b * n * d * 4
    pairs = b * 4 * n * (n + 1) / 2
    for t in range(tp):
        c = mode.costs[(0, t)]
        assert c.coll_counts == {"broadcast": 2, "reduce": 2}, c.coll_counts
        assert c.coll_by_op == {"broadcast": 2.0 * part, "reduce": 2.0 * part}
        assert c.kernel_calls == {"flash_attention": 1, "flash_attention_bwd": 1}
        assert c.kernel_heads["flash_attention"] == [4]
        assert c.flops_by_op["kernel"] == pytest.approx(
            2.0 * (2 * d) * pairs + 2.0 * (3 * d + 2 * d) * pairs)
        assert c.flops_by_op["elementwise"] > 0


def test_meta_paths_only_for_meta_tensors():
    """The kernels' shape-only paths report nothing for CPU tensors (the
    plain versions run) and launch nothing on ``meta``."""
    from repro_torch.kernels import block_sparse_attn as bsa
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import stem_metric as metric
    seen = []

    class Tally:
        def kernel(self, name, flops, nbytes, heads, like):
            seen.append((name, like.device.type, heads))

        def collective(self, *a):
            pass
    before = {**flash.LAUNCHES, **bsa.LAUNCHES, **metric.LAUNCHES}
    for dev in ("cpu", "meta"):
        q = torch.zeros((1, 2, 32, 16), device=dev)
        idx = torch.zeros((1, 2, 2, 1), dtype=torch.int32, device=dev)
        cnt = torch.ones((1, 2, 2), dtype=torch.int32, device=dev)
        with kernel_cost.counting(Tally()):
            o = flash.flash_attention(q, q, q)
            o2 = bsa.block_sparse_attention(q, q, q, idx, live_counts=cnt, block_size=16)
            g = flash.flash_attention_bwd(q, q, q, o, o)
            p = metric.antidiag_pool(q, block_size=16, stride=4)
            m = metric.value_magnitude(q, block_size=16)
        assert o.shape == o2.shape == q.shape and o.device.type == dev
        assert [t.shape for t in g] == [q.shape] * 3
        assert p.shape == (1, 2, 2, 4, 16) and m.shape == (1, 2, 2) and m.dtype == torch.float32
    assert {**flash.LAUNCHES, **bsa.LAUNCHES, **metric.LAUNCHES} == before
    assert [s[0] for s in seen] == ["flash_attention", "block_sparse_attention",
                                    "flash_attention_bwd", "antidiag_pool",
                                    "value_magnitude"]
    assert {s[1] for s in seen} == {"meta"}


# ---------------------------------------------------------------------------
# (ii), (iii) against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_are_the_reference_shards(arch, shape, ref):
    mesh = _meta_mesh(shape)
    _, _, _, args = dryrun.setup(_cfg(arch), mesh, SHAPE)
    for c in mesh.coords():
        want = int(ref[f"{arch}/{shape[0]}x{shape[1]}/args/{c[0]}_{c[1]}"])
        assert args[c] == want, (c, args[c], want)


def _reference_attention_flops(cfg, shape) -> float:
    """XLA's dense attention products on one device: 2 (d + dv) s^2 a row
    and head, forward, remat and backward (twice)."""
    d, dv = cfg.head_dim, cfg.head_dim
    if cfg.mla:
        d, dv = cfg.mla.nope_head_dim + cfg.mla.rope_head_dim, cfg.mla.v_head_dim
    h = cfg.num_heads
    heads = h // shape[1] if h % shape[1] == 0 else h
    rows = SHAPE.global_batch // shape[0]
    return 4 * 2.0 * rows * heads * SHAPE.seq_len ** 2 * (d + dv) * cfg.num_layers


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ("qwen3-0.6b:1", "arctic-480b", "deepseek-v3-671b"))
def test_dot_flops_against_the_reference_hlo(arch, shape, ref):
    cfg = _cfg(arch)
    mesh = _meta_mesh(shape)
    costs, _, _ = dryrun.count_step(cfg, mesh, SHAPE)
    lead = costs[(0, 0)]
    got = lead.flops_by_op["dot"] + _reference_attention_flops(cfg, shape)
    key = f"{arch}/{shape[0]}x{shape[1]}"
    want = float(ref[f"{key}/dot"])
    ref_coll = {k.split("/")[-1]: float(v) for k, v in ref.items()
                if k.startswith(f"{key}/coll/")}
    print(f"[{key}] port lead dot + dense attention {got:.4e}, reference {want:.4e} "
          f"(ratio {got / want:.4f}); collectives: port {dict(lead.coll_counts)}, "
          f"reference {ref_coll}")
    assert abs(got - want) <= DOT_TOLERANCE * want
    # each model shard's count is its own: the lead also runs the whole dims
    others = [costs[(0, t)].flops_by_op["dot"] for t in range(1, shape[1])]
    assert all(o <= lead.flops_by_op["dot"] for o in others)
    assert lead.kernel_calls["flash_attention"] == 2 * cfg.num_layers * cfg.train_microbatches \
        + (cfg.train_microbatches if cfg.mtp else 0)


# ---------------------------------------------------------------------------
# the SSD, RG-LRU and encoder-decoder layers by model shard
# ---------------------------------------------------------------------------

def _layer_flops(cfg, shape, build, fn, *shapes) -> float:
    """The lead model shard's counted flops of ``fn`` forward and backward
    over ``build``'s parameters in the rules' blocks on a meta mesh of
    ``shape`` (inside ``model_parallel`` when the model axis is above 1)."""
    from repro_torch.models import common
    from repro_torch.sharding import rules
    mesh = _meta_mesh(shape)
    ini = common.Initializer(torch.Generator(), torch.float32, "meta")
    params = build(ini)
    sh = rules.param_shardings(cfg, mesh, params, ini.axes_tree(params))
    placed = rules.tree_map(lambda t, s: arrays.place(t, s).map_blocks(
        lambda b: b.requires_grad_()), params, sh)
    inputs = [torch.empty(s, device="meta", requires_grad=True) for s in shapes]
    mode = cost_analysis.CostMode(default=(0, 0))
    ctx = shctx.model_parallel(mesh, (0, 0)) if shape[1] > 1 else contextlib.nullcontext()
    with ctx, kernel_cost.counting(mode), mode:
        fn(arrays.materialize(placed, "meta"), *inputs).sum().backward()
    return mode.costs[(0, 0)].flops


def _mixer_layers(arch):
    """(config, [(name, build, fn, input shapes)]): the arch's SSD, RG-LRU
    or encoder / decoder layers, as the mesh step runs them."""
    from repro_torch.models import encdec, rglru, ssd
    cfg = _cfg(arch)
    b, s, d = 2, 64, cfg.d_model
    if arch == "mamba2-370m":
        return cfg, [("ssd", lambda ini: ssd.init(ini, cfg),
                      lambda p, x: ssd.apply_full(p, x, cfg), (b, s, d))]
    if arch == "recurrentgemma-2b":
        return cfg, [("rglru", lambda ini: rglru.init(ini, cfg),
                      lambda p, x: rglru.apply_full(p, x, cfg), (b, s, d))]
    pos = torch.arange(s, device="meta")
    f = cfg.encdec.encoder_frames
    return cfg, [("encoder", lambda ini: encdec._init_enc_layer(ini, cfg),
                  lambda p, x: encdec.enc_layer(p, x, cfg, positions=pos), (b, f, d)),
                 ("decoder", lambda ini: encdec._init_dec_layer(ini, cfg),
                  lambda p, x, e: encdec.dec_layer(p, x, e, cfg, positions=pos),
                  (b, s, d), (b, f, d))]


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-2b", "whisper-medium"])
def test_mixer_layers_count_their_share(arch, monkeypatch):
    """On a (1, 4) ``meta`` mesh the reduced configs' SSD / RG-LRU / whisper
    layers count below the (1, 1) count on the lead model shard, forward
    and backward; and in the whole dry-run step no model-axis leaf is
    gathered whole inside ``model_parallel`` (each model shard reads only
    its own model block of it)."""
    cfg, layers = _mixer_layers(arch)
    for name, build, fn, *shapes in layers:
        one = _layer_flops(cfg, (1, 1), build, fn, *shapes)
        lead = _layer_flops(cfg, (1, 4), build, fn, *shapes)
        print(f"[{arch} {name}] lead model shard at (1, 4): {lead:.4e} flops, "
              f"(1, 1): {one:.4e} (ratio {lead / one:.3f})")
        assert lead < 0.5 * one, (name, lead, one)
    wide = []
    gather = arrays.ShardedArray.gather

    def spy(self, device, dtype=None, region=None, coord=None):
        dim = arrays.model_dim(self.sharding)
        if dim is not None and shctx.model_parallel_state() is not None:
            lo, hi = (region or tuple((0, n) for n in self.shape))[dim]
            if hi - lo > self.shape[dim] // self.mesh.shape["model"]:
                wide.append((tuple(self.shape), self.sharding.spec))
        return gather(self, device, dtype, region, coord)
    monkeypatch.setattr(arrays.ShardedArray, "gather", spy)
    dryrun.count_step(cfg, _meta_mesh((1, 4)), SHAPE)
    assert not wide, wide


# ---------------------------------------------------------------------------
# (iv) the production grid
# ---------------------------------------------------------------------------

KEYS = ("flops_per_device", "bytes_per_device", "bytes_per_device_nofusion",
        "flops_by_op", "collectives", "memory", "roofline", "model_flops_total",
        "model_flops_ratio", "fits")


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma-2b"])
def test_production_grid_record(arch, tmp_path):
    t0 = time.time()
    dryrun.main(["--arch", arch, "--shape", "train_4k", "--out", str(tmp_path)])
    seconds = time.time() - t0
    rec = json.loads((tmp_path / f"{arch}__train_4k__pod.json").read_text())
    print(f"[{arch}] dry run on the 16 x 16 grid in {seconds:.1f} s on the CPU: "
          + json.dumps({k: rec[k] for k in ("flops_per_device", "model_flops_ratio",
                                            "memory", "roofline", "fits")}))
    for k in KEYS:
        assert k in rec, k
    assert rec["mesh"] == "16x16" and rec["chips"] == 256
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes"}
    assert set(rec["roofline"]) == {"compute_s", "memory_s", "collective_s", "bottleneck"}
    assert set(rec["collectives"]) == {"counts", "bytes_by_op", "total_bytes"}
    assert len(rec["per_model_shard"]) == 16
    assert rec["memory"]["peak_bytes"] == rec["memory"]["argument_bytes"] \
        + rec["memory"]["temp_bytes"]
    assert 0 < rec["model_flops_ratio"] < 1


def test_cli_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """``--stem`` (no counterpart in the reference's dry run) exits 2, an
    unknown arch 1; a decode cell, refused before the serving steps were
    ported, now runs and the CLI exits 0 (qwen3-0.6b cut to one layer)."""
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--stem", "--out", str(tmp_path)])
    assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "no-such-arch", "--out", str(tmp_path)])
    assert e.value.code == 1
    get = t_configs.get_config
    monkeypatch.setattr(dryrun.configs, "get_config",
                        lambda name: get(name).replace(num_layers=1))
    dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "qwen3-0.6b__decode_32k__pod.json").read_text())
    assert rec["shape"] == "decode_32k" and rec["memory"]["argument_bytes"] > 0


def test_kernel_cost_formulas():
    """The formulas the kernel table's bounds use (``kernels/cost.py``,
    which ``chip_smoke.py`` imports), at one row of each kernel: phase 3's
    shapes cut to 1024 tokens."""
    q = torch.empty((1, 16, 1024, 128), dtype=torch.bfloat16, device="meta")
    k = torch.empty((1, 8, 1024, 128), dtype=torch.bfloat16, device="meta")
    pairs = 16 * 1024 * 1025 / 2
    assert kernel_cost.flash_bytes_flops(q, k, k) == (2 * (16 + 8) * 1024 * 128 * 2,
                                                      4.0 * 128 * pairs)
    assert kernel_cost.bwd_bytes_flops(q, k, k, pairs) == (
        2 * (2 * q.numel() + 2 * 2 * k.numel() + 2 * q.numel()) + q.numel() // 128 * 4,
        2.0 * 5 * 128 * pairs)
    out = torch.empty((1, 16, 8, 16, 128), dtype=torch.bfloat16, device="meta")
    assert kernel_cost.pool_bytes_flops(q, out) == (2 * q.numel() + 2 * out.numel(),
                                                    float(q.numel()))
    assert kernel_cost.vmag_bytes_flops(k, torch.empty((1, 8, 8))) == (
        2 * k.numel() + 8 * 8 * 4, 2.0 * k.numel())
    # block-sparse: two query blocks, each row its diagonal and block 0
    idx = torch.tensor([[[[0, 0], [0, 1]]]], dtype=torch.int32)
    cnt = torch.tensor([[[1, 2]]], dtype=torch.int32)
    qs = torch.zeros((1, 1, 256, 128), dtype=torch.bfloat16)
    assert kernel_cost.causal_pairs(idx, cnt, 128) == 128 * 129 / 2 * 2 + 128 * 128
    assert kernel_cost.bsa_bytes_flops(qs, qs, idx, cnt, 1, False, 128) == (
        2 * qs.numel() * 2 + 2 * 128 * 256 * 2 + (4 + 2) * 4,
        2.0 * 256 * (128 * 129 + 128 * 128))
    assert kernel_cost.bound(12_582_912, 4_299_161_600.0, torch.bfloat16) == (
        4_299_161_600.0 / 989e12 * 1e3, "operations")
