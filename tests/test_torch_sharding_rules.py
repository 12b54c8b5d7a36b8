"""The port's logical axes and sharding rules against the reference's.

* **axes:** for all 12 configs at published widths, every parameter leaf's
  path, shape, dtype and logical axes from ``ModelBundle.abstract_params()``
  (``meta`` tensors, nothing allocated) equal the reference's
  ``abstract_params()`` (``ShapeDtypeStruct``s), and ``init_params`` still
  returns the plain tree;
* **rules:** the specs of ``spec_for``, ``param_shardings``,
  ``zero1_shardings``, ``batch_sharding`` (``input_specs`` of train_4k) and
  ``cache_shardings`` (``abstract_caches`` of decode_32k) equal the
  reference's for all 12 configs on the meshes (2, 4), (4, 2), (8, 1) and
  (2, 2, 2), and the port's ``NamedSharding.indices`` at every coordinate
  equals ``NamedSharding.devices_indices_map`` at the device of that
  coordinate.  The reference's side needs 8 JAX devices: a module-scoped
  subprocess runs it with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``
  and writes JSON;
* the meshes (``launch/mesh.py``) and the context (``sharding/context.py``).
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from repro import configs as j_configs
from repro.models import registry as j_registry

from repro_torch import configs as t_configs
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import steps as t_steps
from repro_torch.models import registry as t_registry
from repro_torch.sharding import context as t_context
from repro_torch.sharding import rules as t_rules

ROOT = pathlib.Path(__file__).resolve().parent.parent
MESHES = [((2, 4), ("data", "model")), ((4, 2), ("data", "model")),
          ((8, 1), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))]
ARCHS = sorted(t_configs.ALL)
# spec_for on shapes the rules do and do not divide (an axis dropped for a
# dim it does not divide, an axis used once, a None axis)
SPEC_CASES = [((8, 7, 16), ("heads", "kv_heads", "embed")), ((12,), ("vocab",)),
              ((6, 4), ("batch", "heads")), ((16, 16), ("kv_heads", "heads")),
              ((4, 8, 2), (None, "mlp", "experts")), ((3, 5), ("kv_seq", "rnn"))]

JAX_RULES_SCRIPT = r"""
import json, sys
import numpy as np
import jax
from jax.sharding import Mesh
from repro import configs
from repro.configs.base import DECODE_32K, TRAIN_4K
from repro.launch import steps as steps_lib
from repro.models import registry
from repro.sharding import rules as rules_lib

assert len(jax.devices()) >= 8, jax.devices()
MESHES = json.loads(sys.argv[1])
SPEC_CASES = json.loads(sys.argv[2])


def spec(p):
    return [list(e) if isinstance(e, tuple) else e for e in p]


def flat(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def entry(sh, shape, coord_of):
    idx = sh.devices_indices_map(tuple(shape))
    return {"spec": spec(sh.spec), "shape": list(shape),
            "indices": {coord_of[d.id]: [list(s.indices(n)[:2]) for s, n in zip(i, shape)]
                        for d, i in idx.items()}}


out = {}
for shape, axes in MESHES:
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), tuple(axes))
    coord_of = {d.id: "_".join(map(str, c)) for c, d in np.ndenumerate(mesh.devices)}
    mkey = "x".join(map(str, shape))
    out[mkey + "/spec_for"] = {}
    for name in configs.ALL:
        cfg = configs.get_config(name)
        rules = rules_lib.logical_rules(cfg, mesh)
        out[mkey + "/spec_for"][name] = [spec(rules_lib.spec_for(tuple(s), tuple(a), rules, mesh))
                                         for s, a in SPEC_CASES]
        av, ax = registry.build(cfg).abstract_params()
        psh = rules_lib.param_shardings(cfg, mesh, av, ax)
        zsh = rules_lib.zero1_shardings(cfg, mesh, av, psh)
        rec = {"params": {}, "zero1": {}}
        for (path, v), (_, p), (_, z) in zip(flat(av), flat(psh), flat(zsh)):
            key = jax.tree_util.keystr(path)
            rec["params"][key] = entry(p, v.shape, coord_of)
            rec["zero1"][key] = entry(z, v.shape, coord_of)
        specs = registry.input_specs(cfg, TRAIN_4K)
        bsh = rules_lib.batch_sharding(cfg, mesh, specs)
        rec["batch"] = {k: {"spec": spec(bsh[k].spec), "shape": list(specs[k].shape)}
                        for k in specs}
        caches = registry.abstract_caches(cfg, DECODE_32K)
        csh = rules_lib.cache_shardings(cfg, mesh, caches)
        rec["cache"] = [{"spec": spec(s.spec), "shape": list(v.shape)}
                        for (_, v), (_, s) in zip(flat(caches), flat(csh))]
        st = steps_lib.opt_state_shardings(cfg, mesh, psh, av)
        rec["state_step"] = spec(st.step.spec)
        out[f"{mkey}/{name}"] = rec
json.dump(out, open(sys.argv[3], "w"))
"""


@pytest.fixture(scope="module")
def jax_rules(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_rules") / "rules.json"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run(
        [sys.executable, "-c", JAX_RULES_SCRIPT, json.dumps(MESHES), json.dumps(SPEC_CASES),
         str(path)], env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(path.read_text())


def _spec(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _key_paths(tree, pre="", is_leaf=t_rules.is_axes):
    """(jax keystr path, leaf) in JAX's flattening order: dict keys sorted,
    NamedTuples by field, lists by index; a logical-axes tuple is a leaf."""
    if is_leaf(tree):
        return [(pre, tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _key_paths(tree[k], f"{pre}['{k}']")]
    if hasattr(tree, "_fields"):
        return [x for f, v in zip(tree._fields, tree) for x in _key_paths(v, f"{pre}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _key_paths(v, f"{pre}[{i}]")]
    return [(pre, tree)]


def _indices(sh, shape) -> dict:
    return {"_".join(map(str, c)): [list(s.indices(n)[:2]) for s, n in zip(i, shape)]
            for c, i in sh.indices(shape).items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_axes_match_reference(arch):
    jv, jax_axes = j_registry.build(j_configs.get_config(arch)).abstract_params()
    tb = t_registry.build(t_configs.get_config(arch))
    tv, t_axes = tb.abstract_params()
    want = {jax.tree_util.keystr(p): (tuple(v.shape), str(v.dtype))
            for p, v in jax.tree_util.tree_flatten_with_path(jv)[0]}
    want_axes = {jax.tree_util.keystr(p): a for p, a in jax.tree_util.tree_flatten_with_path(
        jax_axes, is_leaf=lambda t: isinstance(t, tuple))[0]}
    got = {p: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for p, v in _key_paths(tv)}
    got_axes = dict(_key_paths(t_axes))
    assert got == want
    assert got_axes == want_axes
    assert all(v.device.type == "meta" for _, v in _key_paths(tv))


def test_init_params_stays_a_plain_tree():
    cfg = t_configs.reduced(t_configs.get_config("deepseek-v3-671b"))
    tree = t_registry.build(cfg).init_params(torch.Generator().manual_seed(0), device="cpu")
    values, axes = t_registry.build(cfg).abstract_params()
    assert all(isinstance(v, torch.Tensor) for _, v in _key_paths(tree))
    assert [p for p, _ in _key_paths(tree)] == [p for p, _ in _key_paths(values)]
    assert all(a[0] == "layers" for p, a in _key_paths(axes) if "segment" in p)


@pytest.mark.parametrize("shape,axes", MESHES, ids=lambda x: str(x))
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_match_reference(arch, shape, axes, jax_rules):
    mkey = "x".join(map(str, shape))
    want = jax_rules[f"{mkey}/{arch}"]
    cfg = t_configs.get_config(arch)
    mesh = t_mesh.make_mesh(shape, axes, [torch.device("meta")] * int(np.prod(shape)))
    rules = t_rules.logical_rules(cfg, mesh)
    assert [_spec(t_rules.spec_for(s, a, rules, mesh)) for s, a in SPEC_CASES] == \
        jax_rules[f"{mkey}/spec_for"][arch]
    values, axes_tree = t_registry.build(cfg).abstract_params()
    psh = t_rules.param_shardings(cfg, mesh, values, axes_tree)
    zsh = t_rules.zero1_shardings(cfg, mesh, values, psh)
    leaves = list(zip(_key_paths(values), _key_paths(psh), _key_paths(zsh)))
    assert sorted(p for (p, _), _, _ in leaves) == sorted(want["params"])
    for (path, v), (_, p), (_, z) in leaves:
        for name, sh in (("params", p), ("zero1", z)):
            rec = want[name][path]
            assert _spec(sh.spec) == rec["spec"], (name, path)
            assert _indices(sh, tuple(v.shape)) == rec["indices"], (name, path)
    specs = t_registry.input_specs(cfg, t_configs.TRAIN_4K)
    bsh = t_rules.batch_sharding(cfg, mesh, specs)
    assert {k: {"spec": _spec(bsh[k].spec), "shape": list(specs[k].shape)}
            for k in specs} == want["batch"]
    caches = t_registry.abstract_caches(cfg, t_configs.DECODE_32K)
    csh = t_rules.cache_shardings(cfg, mesh, caches)
    assert [{"spec": _spec(s.spec), "shape": list(v.shape)}
            for (_, v), (_, s) in zip(_key_paths(caches), _key_paths(csh))] == want["cache"]
    assert _spec(t_steps.opt_state_shardings(cfg, mesh, psh, values).step.spec) == \
        want["state_step"]


def test_meshes():
    m = t_mesh.make_mesh((2, 3), ("data", "model"), platform="cpu")
    assert m.shape == {"data": 2, "model": 3} and m.size == 6
    assert m.coords()[:4] == [(0, 0), (0, 1), (0, 2), (1, 0)]
    assert m.rank((1, 2)) == 5 and m.coord(model=2) == (0, 2)
    local = t_mesh.make_local_mesh(["cpu"] * 3)
    assert local.axis_names == ("data", "model") and local.grid == (3, 1)
    prod = t_mesh.make_production_mesh()
    assert prod.shape == {"data": 16, "model": 16}
    assert {d.type for d in prod.devices} == {"meta"}
    assert t_mesh.make_production_mesh(multi_pod=True).grid == (2, 16, 16)
    with pytest.raises(ValueError, match="needs 8 devices"):
        t_mesh.make_mesh((2, 4), ("data", "model"), ["cpu"] * 3)


def test_context():
    cfg = t_configs.get_config("arctic-480b")
    mesh = t_mesh.make_mesh((2, 2), ("data", "model"), platform="cpu")
    x = torch.ones(2, 3, 4)
    assert t_context.current() is None and t_context.constrain(x, ("batch", None, None)) is x
    with t_context.use(cfg, mesh):
        rules, got = t_context.current()
        assert got is mesh and rules["embed"] == ("data",) and rules["batch"] == ("data",)
        assert t_context.constrain(x, ("batch", None, None)) is x
    assert t_context.current() is None
