"""Mesh training of the MoE, MLA + MTP and VLM-stub configs, and the
expert-parallel MoE branch, against the reference.

* The train step: the reduced arctic-480b (MoE, FSDP), deepseek-v3-671b
  (MLA, shared expert, MTP, FSDP) and pixtral-12b (patch positions, FSDP),
  fp32, on the meshes (1, 1), (2, 1), (4, 1), (2, 4), (1, 2), (1, 4), (2,
  2) with microbatches 1 and 2 (tensor-parallel where the model axis is
  above 1), against the reference's sharded ``make_train_step``, under the
  rules of ``tests/test_torch_mesh_training.py`` (its subprocess, run for
  these configs).  The MoE aux loss is a product of means over the global
  batch, so the port's data shards combine their expert statistics
  (``moe.GlobalAux``) before it: loss, grad norm, master and every ZeRO-1
  block match.
* Expert parallelism: ``moe.apply`` inside ``sharding.context.use`` on the
  meshes (1, 2) and (2, 4) (the model axis divides the reduced configs' 8
  experts) against the reference's ``shard_map`` branch, run under
  ``jax.jit`` in a subprocess with 8 host devices, for the reduced
  arctic-480b (FSDP: the expert tables gathered over the data axis first)
  and deepseek-v3-671b (a shared expert): the output within 1e-5 of the
  reference's (of its max|y| when above 1), the routing integers equal, the
  aux loss bitwise the port's local branch's and within 1e-6 of the
  reference's; plain tables and tables placed in the rules' blocks give the
  same bits; the branch's gradients (``loss_and_grads`` inside ``use``)
  equal the local branch's within 1e-5.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs as t_configs
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import steps as t_steps
from repro_torch.models import common as t_common
from repro_torch.models import moe as t_moe
from repro_torch.models import registry as t_registry
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.sharding import context as t_context
from repro_torch.sharding import rules as t_rules
from repro_torch.sharding.arrays import ShardedArray
from repro_torch.weights import to_shards
from test_torch_mesh_training import (MESHES, MICROBATCHES, ROOT, check_against_reference,
                                      run_reference)

torch.set_num_threads(1)

ARCHS = ("arctic-480b", "deepseek-v3-671b", "pixtral-12b")
EP_ARCHS = ("arctic-480b", "deepseek-v3-671b")
EP_MESHES = [(1, 2), (2, 4)]

# moe.apply's local and shard_map branches on 8 host devices; argv: the
# npz path.
JAX_EP_SCRIPT = r"""
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from repro import configs
from repro.models import common, moe
from repro.sharding import context as shctx

assert len(jax.devices()) >= 8, jax.devices()
out = {}


def paths(tree, pre=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in paths(tree[k], f"{pre}/{k}" if pre else k)]
    return [(pre, tree)]


for arch in ("arctic-480b", "deepseek-v3-671b"):
    cfg = configs.reduced(configs.get_config(arch)).replace(dtype="float32")
    ini = common.Initializer(jax.random.PRNGKey(3), jnp.float32)
    params = common.unzip(moe.init(ini, cfg.d_model, cfg.moe, cfg.activation))[0]
    x = np.random.RandomState(5).standard_normal((4, 32, cfg.d_model)).astype(np.float32)
    for p, v in paths(params):
        out[f"{arch}/params/{p}"] = np.asarray(v)
    out[f"{arch}/x"] = x
    apply = jax.jit(lambda p, x: moe.apply(p, x, cfg.moe, cfg.activation))
    _, _, experts, pos, keep, _ = moe._route(params, jnp.asarray(x), cfg.moe)
    out[f"{arch}/experts"], out[f"{arch}/pos"], out[f"{arch}/keep"] = map(
        np.asarray, (experts, pos, keep))
    y, aux = apply(params, x)
    out[f"{arch}/local/y"], out[f"{arch}/local/aux"] = np.asarray(y), np.asarray(aux)
    for shape in ((1, 2), (2, 4)):
        mesh = Mesh(np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape),
                    ("data", "model"))
        with shctx.use(cfg, mesh):
            y, aux = jax.jit(lambda p, x: moe.apply(p, x, cfg.moe, cfg.activation))(params, x)
        key = f"{arch}/{shape[0]}x{shape[1]}"
        out[f"{key}/y"], out[f"{key}/aux"] = np.asarray(y), np.asarray(aux)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(ARCHS, tmp_path_factory)


@pytest.fixture(scope="module")
def jax_ep(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_ep") / "ep.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, "-c", JAX_EP_SCRIPT, str(path)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


CASES = [(a, s, mb) for a in ARCHS for s in MESHES for mb in MICROBATCHES]


@pytest.mark.parametrize("arch,shape,mb", CASES, ids=lambda x: str(x))
def test_mesh_step_matches_reference(arch, shape, mb, ref):
    check_against_reference(arch, shape, mb, ref)


def _ep_setup(arch, z):
    """(config, the port's MoE parameters, their logical axes, x)."""
    cfg = t_configs.reduced(t_configs.get_config(arch)).replace(dtype="float32")
    ini = t_common.Initializer(torch.Generator(), torch.float32, "meta")
    meta = t_moe.init(ini, cfg.d_model, cfg.moe, cfg.activation)
    axes = ini.axes_tree(meta)

    def load(node, pre):
        if isinstance(node, dict):
            return {k: load(v, f"{pre}/{k}" if pre else k) for k, v in node.items()}
        return torch.from_numpy(z[f"{arch}/params/{pre}"])
    return cfg, load(meta, ""), meta, axes, torch.from_numpy(z[f"{arch}/x"])


@pytest.mark.parametrize("shape", EP_MESHES, ids=lambda x: str(x))
@pytest.mark.parametrize("arch", EP_ARCHS)
def test_expert_parallel_matches_shard_map(arch, shape, jax_ep):
    cfg, params, meta, axes, x = _ep_setup(arch, jax_ep)
    _, _, experts, pos, keep, _ = t_moe.route(params, x, cfg.moe)
    for name, got in (("experts", experts), ("pos", pos), ("keep", keep)):
        assert np.array_equal(got.numpy(), jax_ep[f"{arch}/{name}"]), name
    y_local, aux_local = t_moe.apply(params, x, cfg.moe, cfg.activation)
    mesh = t_mesh.make_mesh(shape, ("data", "model"), platform="cpu")
    placed = to_shards(tree_map(lambda t: t.numpy(), params),
                       t_rules.param_shardings(cfg, mesh, meta, axes))
    assert isinstance(placed["w_gate"], ShardedArray)
    if cfg.fsdp_weights:       # the expert tables' d_model dim split over data
        assert placed["w_gate"].sharding.spec == ("model", "data")
    calls = []
    orig = t_moe.expert_ffn
    with t_context.use(cfg, mesh):
        t_moe.expert_ffn = lambda *a, **kw: calls.append(kw.get("e_offset")) or orig(*a, **kw)
        try:
            y, aux = t_moe.apply(params, x, cfg.moe, cfg.activation)
            y2, aux2 = t_moe.apply(placed, x, cfg.moe, cfg.activation)
        finally:
            t_moe.expert_ffn = orig
    n_model, e_local = shape[1], cfg.moe.num_experts // shape[1]
    assert calls == [m * e_local for _ in range(2 * shape[0]) for m in range(n_model)]
    assert torch.equal(y, y2) and torch.equal(aux, aux2)
    assert torch.equal(aux, aux_local)
    want = jax_ep[f"{arch}/{shape[0]}x{shape[1]}/y"]
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(y.numpy() - want).max()) <= 1e-5 * scale
    assert float((y - y_local).abs().max()) <= 1e-5 * scale
    np.testing.assert_allclose(float(aux), float(jax_ep[f"{arch}/{shape[0]}x{shape[1]}/aux"]),
                               rtol=1e-6)
    assert float(jax_ep[f"{arch}/{shape[0]}x{shape[1]}/aux"]) == \
        float(jax_ep[f"{arch}/local/aux"])


def test_expert_parallel_gradients():
    """``loss_and_grads`` of the reduced arctic-480b inside ``use`` on (1, 2)
    and (2, 2): the experts split over the model axis, the same gradients
    as the local branch (within 1e-5 of each leaf's max)."""
    from repro_torch.data import SyntheticLMData
    cfg = t_configs.reduced(t_configs.get_config("arctic-480b")).replace(dtype="float32")
    bundle = t_registry.build(cfg)
    master = bundle.init_params(torch.Generator().manual_seed(0), device="cpu")
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4, seed=0)
    batch = {k: torch.from_numpy(v) for k, v in data.batch_at(0).items()}
    want = t_steps.loss_and_grads(bundle, master, batch)
    for shape in ((1, 2), (2, 2)):
        with t_context.use(cfg, t_mesh.make_mesh(shape, ("data", "model"), platform="cpu")):
            got = t_steps.loss_and_grads(bundle, master, batch)
        assert abs(float(got[0]) - float(want[0])) <= 1e-6 * float(want[0])
        for a, b in zip(tree_leaves(got[2]), tree_leaves(want[2])):
            assert float((a - b).abs().max()) <= 1e-5 * max(float(b.abs().max()), 1e-30)
