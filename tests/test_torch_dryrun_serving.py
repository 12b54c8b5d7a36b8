"""The dry run's serving cells (``launch/dryrun.py``: ``prefill_32k``,
``decode_32k``, ``long_500k``) and the Stem prefill's block-sparse pairs
counted by its budgets.

(a) The budget rule against the real selection: one layer of 4096 tokens
at the paper's defaults, and the stem mesh prefill of the reduced configs
on (1, 2): the causal pairs the shape-only block-sparse path counts on
``meta`` tensors by the policy's budgets (``SparsityPolicy.
prefill_live_counts``) equal ``kernels.cost.causal_pairs`` of every
selection the CPU run gives the kernel's plain version, exactly.

(b) The prefill and decode cells cut to 128 tokens, for the reduced fp32
qwen3-0.6b, arctic-480b and deepseek-v3-671b on (2, 2) and (1, 4) meshes
of ``meta`` devices: each coordinate's argument bytes (its blocks of the
parameters, the batch or tokens, and the caches in
``rules.cache_shardings``' layout) equal the bytes of the reference's
``addressable_shards`` on that device, exactly.  The reference places
zeros of each argument's shape in its sharding in a module-scoped
subprocess on 8 forced host devices (nothing is compiled).

(c) ``--arch qwen3-0.6b --shape decode_32k`` and ``--arch mamba2-370m
--shape long_500k`` on the 16 x 16 grid write every key of the
reference's record; qwen3-0.6b's KV cache is 1.75 GiB of the coordinate's
arguments.  The seconds each took on the CPU are printed (PERF.md quotes
them).
"""
import importlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch import configs as t_configs
from repro_torch.configs.base import RunShape
from repro_torch.core.config import StemConfig
from repro_torch.kernels import cost as kernel_cost
from repro_torch.launch import cost_analysis, dryrun
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import steps as t_steps
from repro_torch.models import registry as t_registry
from repro_torch.sharding import arrays
from repro_torch.sharding import context as shctx
from repro_torch.sharding import rules as t_rules

from test_torch_mesh_training import ROOT

torch.set_num_threads(1)

SERVE_SHAPES = (RunShape("prefill_small", 128, 16, "prefill"),
                RunShape("decode_small", 128, 16, "decode"))
MESHES = [(2, 2), (1, 4)]
ARCHS = ("qwen3-0.6b", "arctic-480b", "deepseek-v3-671b")
KEYS = ("flops_per_device", "bytes_per_device", "bytes_per_device_nofusion",
        "flops_by_op", "collectives", "memory", "roofline", "model_flops_total",
        "model_flops_ratio", "fits")
STEM = StemConfig(block_size=16, min_budget_blocks=2, sink_blocks=1, local_blocks=1, stride=4)

# The reference's serving-cell arguments on 8 host devices; argv: archs, npz
# path.
JAX_SCRIPT = r"""
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from repro import configs
from repro.configs.base import RunShape
from repro.models import registry
from repro.sharding import rules as rules_lib

SERVE_SHAPES = (RunShape("prefill_small", 128, 16, "prefill"),
                RunShape("decode_small", 128, 16, "decode"))
assert len(jax.devices()) >= 8, jax.devices()
out = {}
for arch in sys.argv[1].split(","):
    cfg = configs.reduced(configs.get_config(arch)).replace(dtype="float32")
    bundle = registry.build(cfg)
    av, ax = bundle.abstract_params()
    for shape in ((2, 2), (1, 4)):
        mesh = Mesh(np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape),
                    ("data", "model"))
        coord_of = {d.id: c for c, d in np.ndenumerate(mesh.devices)}
        psh = rules_lib.param_shardings(cfg, mesh, av, ax)
        for cell in SERVE_SHAPES:
            specs = registry.input_specs(cfg, cell)
            bsh = rules_lib.batch_sharding(cfg, mesh, specs)
            trees = [(av, psh)]
            if cell.kind == "prefill":
                trees.append((specs, bsh))
            else:
                caches = registry.abstract_caches(cfg, cell)
                trees += [(specs["tokens"], bsh["tokens"]),
                          (caches, rules_lib.cache_shardings(cfg, mesh, caches))]
            per = {}
            for tree, shs in trees:
                for leaf, sh in zip(jax.tree.leaves(tree), jax.tree.leaves(shs)):
                    arr = jax.device_put(jnp.zeros(leaf.shape, leaf.dtype), sh)
                    for sd in arr.addressable_shards:
                        c = "_".join(map(str, coord_of[sd.device.id]))
                        per[c] = per.get(c, 0) + sd.data.nbytes
            for c, n in per.items():
                out[f"{arch}/{shape[0]}x{shape[1]}/{cell.name}/{c}"] = np.int64(n)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_dryrun_serving") / "args.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, "-c", JAX_SCRIPT, ",".join(ARCHS), str(path)],
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _cfg(arch):
    return t_configs.reduced(t_configs.get_config(arch)).replace(dtype="float32")


def _meta_mesh(shape):
    return t_mesh.make_mesh(shape, ("data", "model"),
                            [torch.device("meta")] * (shape[0] * shape[1]))


# ---------------------------------------------------------------------------
# (a) the budget rule against the real selection
# ---------------------------------------------------------------------------

def _spy_block_sparse(monkeypatch) -> list:
    """Every plain block-sparse call's causal pairs (``causal_pairs`` of the
    selection it was given)."""
    from repro_torch.kernels import block_sparse_attn as bsa
    seen = []
    plain = bsa.block_sparse_attention_plain

    def spy(q, k, v, indices, live_counts, *, block_size, **kw):
        seen.append(kernel_cost.causal_pairs(indices, live_counts, block_size))
        return plain(q, k, v, indices, live_counts, block_size=block_size, **kw)
    monkeypatch.setattr(bsa, "block_sparse_attention_plain", spy)
    return seen


def test_budget_pairs_equal_the_selection_at_paper_defaults(monkeypatch):
    """One layer of 4096 tokens at the paper's defaults (block 128, TPD
    floor 54, 4 sink + 4 local blocks): the pairs the shape-only path
    counts by the budgets equal the real selection's, exactly."""
    sa = importlib.import_module("repro_torch.core.sparse_attention")  # not the function
    seen = _spy_block_sparse(monkeypatch)
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, h, 4096, 64), generator=gen) for h in (4, 2, 2))
    sa.sparse_attention(q, k, v, StemConfig())
    mode = cost_analysis.CostMode(default=(0,))
    with kernel_cost.counting(mode), mode:
        sa.sparse_attention(q.to("meta"), k.to("meta"), v.to("meta"), StemConfig())
    c = mode.costs[(0,)]
    assert c.kernel_pairs == {"budgets": seen[0]}, (c.kernel_pairs, seen)
    assert c.kernel_calls == {"antidiag_pool": 2, "value_magnitude": 1,
                              "block_sparse_attention": 1}


def test_threshold_selector_keeps_the_bound():
    """A selector whose live counts depend on the data (XAttention's
    cumulative mass) is counted by the bound, and the record says so."""
    from repro_torch.core import policy as policy_lib
    sa = importlib.import_module("repro_torch.core.sparse_attention")  # not the function
    pol = policy_lib.get_policy("xattention").with_updates(block_size=16, stride=4)
    assert pol.prefill_live_counts(128) is None
    q = torch.empty((1, 2, 128, 16), device="meta")
    mode = cost_analysis.CostMode(default=(0,))
    with kernel_cost.counting(mode), mode:
        sa.sparse_attention(q, q, q, pol)
    assert set(mode.costs[(0,)].kernel_pairs) == {"bound"}


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma-2b", "deepseek-v3-671b",
                                  "arctic-480b", "whisper-medium"])
def test_budget_pairs_equal_the_mesh_prefill_selection(arch, monkeypatch):
    """The reduced configs' stem mesh prefill on (1, 2): the pairs counted
    by the budgets on a ``meta`` mesh, summed over the coordinates, equal
    ``causal_pairs`` of every block-sparse call the CPU mesh makes."""
    seen = _spy_block_sparse(monkeypatch)
    cfg = _cfg(arch)
    bundle = t_registry.build(cfg)
    b, n = 2, 64
    gen = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, n), generator=gen)}
    if cfg.encdec:
        batch["frames"] = torch.randn((b, cfg.encdec.encoder_frames, cfg.d_model),
                                      generator=gen)
    av, ax = bundle.abstract_params()
    pairs = {}
    for dev in ("cpu", "meta"):
        mesh = t_mesh.make_mesh((1, 2), ("data", "model"), [torch.device(dev)] * 2)
        psh = t_rules.param_shardings(cfg, mesh, av, ax)
        params = (bundle.init_params(torch.Generator().manual_seed(0), device="cpu")
                  if dev == "cpu" else av)
        placed = t_rules.tree_map(lambda t, sh: arrays.place(t, sh, copy=False), params, psh)
        step = t_steps.mesh_prefill_step(bundle, mesh, max_len=n, stem_cfg=STEM)
        mode = cost_analysis.CostMode(default=(0, 0))
        with torch.no_grad(), shctx.use(cfg, mesh), kernel_cost.counting(mode), mode:
            step(placed, {k: v.to(dev) for k, v in batch.items()})
        for cost in mode.costs.values():
            for rule, p in cost.kernel_pairs.items():
                pairs[rule] = pairs.get(rule, 0.0) + p
    assert seen and pairs == {"budgets": sum(seen)}, (pairs, sum(seen), len(seen))


# ---------------------------------------------------------------------------
# (b) the serving cells' arguments against the reference's shards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell", SERVE_SHAPES, ids=lambda s: s.name)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_argument_bytes_are_the_reference_shards(arch, shape, cell, ref):
    """Each coordinate's blocks of the parameters, the batch or tokens, and
    (decode) the caches in ``rules.cache_shardings``' layout equal the
    reference's ``addressable_shards`` on that device, byte for byte."""
    mesh = _meta_mesh(shape)
    _, _, args = dryrun.setup_serving(_cfg(arch), mesh, cell)
    for c in mesh.coords():
        want = int(ref[f"{arch}/{shape[0]}x{shape[1]}/{cell.name}/{c[0]}_{c[1]}"])
        assert args[c] == want, (c, args[c], want)


# ---------------------------------------------------------------------------
# (c) the production grid
# ---------------------------------------------------------------------------

def _tensors(tree) -> list:
    if isinstance(tree, list):
        return [x for v in tree for x in _tensors(v)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tensors(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _tensors(v)]
    return [tree]


@pytest.mark.parametrize("arch,cell", [("qwen3-0.6b", "decode_32k"),
                                       ("mamba2-370m", "long_500k")])
def test_production_grid_serving_record(arch, cell, tmp_path):
    """The decode cells on the 16 x 16 grid write every key of the
    reference's record; qwen3-0.6b's KV cache (2 x 28 layers x 8 rows x
    8 KV heads x 32768 x 128 x 2 bytes, split by sequence: its 8 KV heads
    do not divide the model axis) is 1.75 GiB of the coordinate's
    arguments."""
    t0 = time.time()
    dryrun.main(["--arch", arch, "--shape", cell, "--out", str(tmp_path)])
    seconds = time.time() - t0
    rec = json.loads((tmp_path / f"{arch}__{cell}__pod.json").read_text())
    print(f"[{arch} {cell}] dry run on the 16 x 16 grid in {seconds:.1f} s on the CPU: "
          + json.dumps({k: rec[k] for k in ("flops_per_device", "model_flops_ratio",
                                            "memory", "roofline", "fits")}))
    for k in KEYS:
        assert k in rec, k
    assert rec["mesh"] == "16x16" and rec["chips"] == 256
    assert rec["memory"]["peak_bytes"] == rec["memory"]["argument_bytes"] \
        + rec["memory"]["temp_bytes"]
    assert rec["memory"]["output_bytes"] > 0 and rec["fits"]
    cfg = t_configs.get_config(arch)
    shape = {s.name: s for s in t_configs.ALL_SHAPES}[cell]
    _, active = t_registry.param_counts(cfg)
    assert rec["model_flops_total"] == 2.0 * active * shape.global_batch
    if arch == "qwen3-0.6b":
        from repro_torch.launch import mesh as mesh_lib
        mesh = mesh_lib.make_production_mesh()
        caches = t_registry.abstract_caches(cfg, shape)
        sh = t_rules.cache_shardings(cfg, mesh, caches)
        kv = sum(math.prod(len(range(*s.indices(n))) for s, n in zip(
            leaf_sh.indices(leaf.shape)[(0, 0)], leaf.shape)) * leaf.element_size()
            for leaf, leaf_sh in zip(_tensors(caches), _tensors(sh)) if leaf.dim() == 5)
        assert kv == 7 * 2 ** 28 == 2 * 28 * 8 * 8 * 32768 * 128 * 2 // 16
        assert kv <= rec["memory"]["argument_bytes"]
        print(f"[{arch} {cell}] KV cache {kv / 2 ** 30:.2f} GiB of "
              f"{rec['memory']['argument_bytes'] / 2 ** 30:.2f} GiB of arguments")
