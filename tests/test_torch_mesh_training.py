"""Mesh training of the port (``launch/steps.mesh_train_step``, the train
CLI over a device grid, checkpoints across meshes) against the reference's
sharded ``make_train_step``.

The reference needs a mesh of JAX devices: a module-scoped subprocess runs
it with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``, its meshes
built as ``jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(shape),
axes)`` (``jax.make_mesh`` gives Explicit axes, under which the reference's
embedding gather raises ``ShardingTypeError``: the seed failures of
``tests/test_fault_tolerance.py``).  For each reduced fp32 config, mesh
``(1, 1)``, ``(2, 1)``, ``(4, 1)``, ``(2, 4)``, ``(1, 2)``, ``(1, 4)``,
``(2, 2)`` and microbatches 1 and 2 it
runs the reference's ``make_train_step(grad_shardings=<ZeRO-1 master
shardings>)`` under ``jax.jit`` with the state / batch shardings of
``repro/launch/train.py`` for 3 steps (global batch 8 x 32, ``grad_dtype``
None) and writes the metrics, the final master and every master shard
(``addressable_shards``: its coordinate, its index, its data) to an npz.

The port runs the same steps over a mesh of CPU shards from the same
initial parameters, its ZeRO-1 state carried shard for shard
(``weights.to_shards``).  On the meshes with a model axis above 1 ((2, 4),
(1, 2), (1, 4), (2, 2)) the port computes tensor-parallel
(``sharding.context.model_parallel``), as the reference's partitioned
program does.  Each case is held in two parts, and against the reference
by their sum (every term printed):

(i) the mesh run M against the port's own (1, 1) run P1 (bitwise its
    one-device step): loss and grad norm at every step, every final master
    leaf, within max(1e-6, 10x the reference's largest spread between its
    (1, 1) run and its six other meshes on that metric or leaf; relative for
    the scalars, absolute for the leaves), and never more than the mesh
    rule: max(1e-5, 10x the reference's spread at that mesh; at the meshes
    of ``TP_MESHES`` also the (1, 1) rule's spread; at (1, 1) the (1, 1)
    rule).  This holds the mesh machinery (ZeRO-1 blocks, data-parallel and
    tensor-parallel sums, the expert statistics) to the noise of reordered
    fp32 sums;
(ii) P1 against the reference's (1, 1) run R1 within the (1, 1) rule: the
    larger of 1e-5 and 10x the largest spread the reference shows between
    (1, 1) and its meshes (2, 1), (4, 1), (2, 4): the port's
    fp32 sums run in another order than XLA's at any mesh;
and M against the reference's run R at that mesh (every master leaf, and
every master block against the reference's shard at the same coordinate:
the same index, the data) within the triangle inequality's bound, (i)'s
bound + (ii)'s bound + |R1 - R| (element by element for the scalars).

Why the largest spread over the reference's meshes: AdamW turns a rounding
difference in a near-zero gradient into a step-sized one, and in which
order a mesh sums is the implementation's.  The reference's (2, 1) run
agrees with its (1, 1) run on the reduced arctic-480b's ``embed`` to 8e-8
where the port's moves it 1.6e-6 (microbatches 2), and its (1, 2) run
moves the reduced recurrentgemma-2b's layer-1 ``ffn/w_down`` by 2.3e-6
where the port's moves it 2.9e-5 (an element whose gradient is near
zero): the reference's spread over its meshes measures how far a leaf
moves when its sums are reordered, its spread at one mesh only samples
it.  (qwen3-0.6b's layer-0 ``wk`` moves 1.9e-5 between the reference's
own (1, 1) and (2, 1) runs; the port's one-device step moves the reduced
deepseek-v3-671b's ``embed[344, 36]`` 2.1e-5 from the reference's, which
its own (2, 4) run moves by 1.8e-5.)

Also: the (1, 1) mesh step == the one-device step, bitwise; two runs of
a mesh step give the same bits; a checkpoint
saved at (2, 1) restores bitwise at (1, 1) and (4, 1) and crosses packages
both ways; the CLI over ``devices=[cpu] * n`` == the mesh step.

The MoE, MLA and VLM configs' train steps are
``tests/test_torch_mesh_training_moe.py``'s, the SSD and RG-LRU configs'
``tests/test_torch_mesh_training_mixers.py``'s (the same subprocess, their
own configs), and the expert-parallel MoE branch is held in the first.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs as t_configs
from repro_torch import optim as t_optim
from repro_torch.checkpoint import CheckpointManager as TManager
from repro_torch.data import SyntheticLMData, make_global_batch
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import steps as t_steps
from repro_torch.launch import train as t_train
from repro_torch.models import registry as t_registry
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.sharding import rules as t_rules
from repro_torch.sharding.arrays import ShardedArray
from repro_torch.weights import to_shards

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
MESHES = [(1, 1), (2, 1), (4, 1), (2, 4), (1, 2), (1, 4), (2, 2)]
# the meshes added with tensor-parallel compute, outside the (1, 1) rule's
# spread (module docstring)
TP_MESHES = [(1, 2), (1, 4), (2, 2)]
MICROBATCHES = (1, 2)
STEPS, BATCH, SEQ = 3, 8, 32
OPT = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=10, grad_dtype=None)
METRICS = ("loss", "grad_norm")

# The reference's sharded train step on 8 forced host devices; argv: the
# archs (comma-separated), the npz path.
JAX_TRAIN_SCRIPT = r"""
import sys
import numpy as np
import jax
from jax.sharding import Mesh
from repro import configs, optim
from repro.data import SyntheticLMData, make_global_batch
from repro.launch import steps as steps_lib
from repro.models import registry
from repro.sharding import rules as rules_lib

MESHES = [(1, 1), (2, 1), (4, 1), (2, 4), (1, 2), (1, 4), (2, 2)]
STEPS, BATCH, SEQ = 3, 8, 32
assert len(jax.devices()) >= 8, jax.devices()
out = {}


def paths(tree, pre=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in paths(tree[k], f"{pre}/{k}" if pre else k)]
    return [(pre, tree)]


for arch in sys.argv[1].split(","):
    cfg = configs.reduced(configs.get_config(arch)).replace(dtype="float32")
    bundle = registry.build(cfg)
    init = jax.jit(bundle.init_params)(jax.random.PRNGKey(0))
    for p, v in paths(init):
        out[f"{arch}/init/{p}"] = np.asarray(v)
    data = SyntheticLMData(
        vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH, seed=0,
        kind={"vlm": "vlm", "encdec": "encdec"}.get(cfg.family, "lm"),
        d_model=cfg.d_model, frames=cfg.encdec.encoder_frames if cfg.encdec else 0)
    opt_cfg = optim.AdamWConfig(peak_lr=1e-3, warmup_steps=2, decay_steps=10,
                                grad_dtype=None)
    av, ax = bundle.abstract_params()
    for shape in MESHES:
        n = shape[0] * shape[1]
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model"))
        coord_of = {d.id: c for c, d in np.ndenumerate(mesh.devices)}
        psh = rules_lib.param_shardings(cfg, mesh, av, ax)
        ssh = steps_lib.opt_state_shardings(cfg, mesh, psh, av)
        bsh = rules_lib.batch_sharding(cfg, mesh, {
            k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in data.batch_at(0).items()})
        for mb in (1, 2):
            key = f"{arch}/{shape[0]}x{shape[1]}/{mb}"
            step = jax.jit(steps_lib.make_train_step(
                bundle, opt_cfg, remat=True, microbatches=mb,
                grad_shardings=ssh.master), in_shardings=(ssh, bsh))
            with mesh:
                state = jax.jit(lambda p: optim.init_state(p, opt_cfg),
                                out_shardings=ssh)(jax.device_put(init, psh))
                metrics = {k: [] for k in ("loss", "grad_norm")}
                for s in range(STEPS):
                    state, m = step(state, make_global_batch(data.batch_at(s), mesh, bsh))
                    for k in metrics:
                        metrics[k].append(float(m[k]))
            for k, v in metrics.items():
                out[f"{key}/{k}"] = np.asarray(v, np.float64)
            for p, v in paths(state.master):
                out[f"{key}/master/{p}"] = np.asarray(v)
                for sh in v.addressable_shards:
                    c = "_".join(map(str, coord_of[sh.device.id]))
                    out[f"{key}/bounds/{p}/{c}"] = np.asarray(
                        [s.indices(n)[:2] for s, n in zip(sh.index, v.shape)],
                        np.int64).reshape(-1, 2)
                    out[f"{key}/shard/{p}/{c}"] = np.asarray(sh.data)
np.savez(sys.argv[2], **out)
"""


def run_reference(archs, tmp_path_factory) -> dict:
    """The JAX side for ``archs``, in a process with 8 devices."""
    path = tmp_path_factory.mktemp("jax_train") / "train.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, "-c", JAX_TRAIN_SCRIPT, ",".join(archs), str(path)],
                         env=env, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


ARCHS = ("qwen3-0.6b", "qwen1.5-4b", "whisper-medium")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(ARCHS, tmp_path_factory)


def _paths(tree, pre=""):
    if isinstance(tree, dict):
        return [x for k in tree for x in _paths(tree[k], f"{pre}/{k}" if pre else k)]
    return [(pre, tree)]


def _tree_from(template, z: dict, prefix: str):
    """A numpy tree shaped as ``template`` from the npz keys
    ``{prefix}/{path}``."""
    def build(node, pre):
        if isinstance(node, dict):
            return {k: build(v, f"{pre}/{k}" if pre else k) for k, v in node.items()}
        return z[f"{prefix}/{pre}"]
    return build(template, "")


def setup(arch, shape):
    """(bundle, mesh, state shardings, batch shardings, data)."""
    cfg = t_configs.reduced(t_configs.get_config(arch)).replace(dtype="float32")
    bundle = t_registry.build(cfg)
    mesh = t_mesh.make_mesh(shape, ("data", "model"), platform="cpu")
    av, ax = bundle.abstract_params()
    psh = t_rules.param_shardings(cfg, mesh, av, ax)
    ssh = t_steps.opt_state_shardings(cfg, mesh, psh, av)
    data = SyntheticLMData(
        vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH, seed=0,
        kind={"vlm": "vlm", "encdec": "encdec"}.get(cfg.family, "lm"),
        d_model=cfg.d_model, frames=cfg.encdec.encoder_frames if cfg.encdec else 0)
    bsh = t_rules.batch_sharding(cfg, mesh, {
        k: torch.empty(v.shape, device="meta") for k, v in data.batch_at(0).items()})
    return bundle, mesh, ssh, bsh, data


def carried_state(bundle, ref: dict, arch: str, ssh) -> t_optim.OptState:
    """The reference's initial parameters as the port's ZeRO-1 state."""
    init = _tree_from(bundle.abstract_params()[0], ref, f"{arch}/init")
    zeros = tree_map(np.zeros_like, init)
    return t_optim.OptState(torch.zeros((), dtype=torch.int32),
                            to_shards(init, ssh.master, torch.float32),
                            to_shards(zeros, ssh.mu, torch.float32),
                            to_shards(zeros, ssh.nu, torch.float32))


def port_run(arch, shape, mb, ref):
    """The port's mesh steps: (metrics per step, final state)."""
    bundle, mesh, ssh, bsh, data = setup(arch, shape)
    state = carried_state(bundle, ref, arch, ssh)
    step = t_steps.make_train_step(bundle, t_optim.AdamWConfig(**OPT), microbatches=mb,
                                   grad_shardings=ssh.master)
    metrics = {k: [] for k in METRICS}
    for s in range(STEPS):
        state, m = step(state, make_global_batch(data.batch_at(s), mesh, bsh))
        for k in METRICS:
            metrics[k].append(float(m[k]))
    return metrics, state


# the port's (1, 1) runs, by (arch, microbatches): (metrics, {leaf path: master})
_PORT_ONE: dict = {}


def port_one(arch, mb, ref):
    """The port's (1, 1) mesh run (bitwise its one-device step:
    ``test_one_by_one_mesh_is_the_one_device_step``), made once a module."""
    if (arch, mb) not in _PORT_ONE:
        got, state = port_run(arch, (1, 1), mb, ref)
        _PORT_ONE[(arch, mb)] = (got, {p: a.gather("cpu").numpy()
                                       for p, a in _paths(state.master)})
    return _PORT_ONE[(arch, mb)]


def check_against_reference(arch, shape, mb, ref):
    """The module docstring's rules, for one (config, mesh, microbatches):
    (i) the mesh run M against the port's (1, 1) run P1, (ii) P1 against the
    reference's (1, 1) run R1, and M against the reference's run R at the
    mesh within the triangle inequality's sum of (i)'s bound, (ii)'s bound
    and the reference's own spread |R1 - R|."""
    got, state = port_run(arch, shape, mb, ref)
    if shape == (1, 1):
        _PORT_ONE[(arch, mb)] = (got, {p: a.gather("cpu").numpy()
                                       for p, a in _paths(state.master)})
    one, one_master = port_one(arch, mb, ref)
    key, base = f"{arch}/{shape[0]}x{shape[1]}/{mb}", f"{arch}/1x1/{mb}"
    others = [f"{arch}/{m[0]}x{m[1]}/{mb}" for m in MESHES
              if m != (1, 1) and m not in TP_MESHES]
    every = [f"{arch}/{m[0]}x{m[1]}/{mb}" for m in MESHES if m != (1, 1)]

    def spread(name, rel, against):
        """The reference's own spread of ``name`` from its (1, 1) run."""
        r1 = ref[f"{base}/{name}"]
        return max(float(np.max(np.abs(ref[f"{k}/{name}"] - r1)
                                / (np.abs(r1) if rel else 1.0), initial=0.0))
                   for k in against)

    def tols(name, rel):
        """(the reference's own spread at this mesh, (i)'s bound, (ii)'s
        bound: the (1, 1) rule)."""
        s, tol_ii = spread(name, rel, [key]), max(1e-5, 10 * spread(name, rel, others))
        mesh_rule = tol_ii if shape == (1, 1) else max(
            1e-5, 10 * spread(name, rel, [key] + (others if shape in TP_MESHES else [])))
        return s, min(mesh_rule, max(1e-6, 10 * spread(name, rel, every))), tol_ii

    report = []
    for k in METRICS:
        m, p1 = np.asarray(got[k]), np.asarray(one[k])
        r1, r = ref[f"{base}/{k}"], ref[f"{key}/{k}"]
        s, tol_i, tol_ii = tols(k, True)
        e_i = float(np.max(np.abs(m - p1) / np.abs(p1)))
        e_ii = float(np.max(np.abs(p1 - r1) / np.abs(r1)))
        # the triangle inequality, element by element, in absolute terms
        bound = tol_i * np.abs(p1) + tol_ii * np.abs(r1) + np.abs(r1 - r)
        err = float(np.max(np.abs(m - r) / np.abs(r)))
        report.append(f"{k}: (i) {e_i:.2e} <= {tol_i:.2e}, (ii) {e_ii:.2e} <= {tol_ii:.2e}, "
                      f"spread {s:.2e}, vs the reference {err:.2e} <= "
                      f"{float(np.max(bound / np.abs(r))):.2e}")
        assert e_i <= tol_i and e_ii <= tol_ii and np.all(np.abs(m - r) <= bound), \
            f"{key} {k}: {got[k]} vs one {one[k]} vs {r.tolist()} ({report[-1]})"
    worst = (0.0, "", 0.0, 0.0, 0.0, 0.0, 0.0)
    for path, arr in _paths(state.master):
        assert isinstance(arr, ShardedArray)
        name = f"master/{path}"
        want, p1 = ref[f"{key}/{name}"], one_master[path]
        s, tol_i, tol_ii = tols(name, False)
        bound = tol_i + tol_ii + s
        full = arr.gather("cpu").numpy()
        assert full.shape == want.shape == p1.shape, path
        e_i = float(np.max(np.abs(full - p1), initial=0.0))
        e_ii = float(np.max(np.abs(p1 - ref[f"{base}/{name}"]), initial=0.0))
        err = float(np.max(np.abs(full - want), initial=0.0))
        terms = (f"(i) {e_i:.3e} <= {tol_i:.3e}, (ii) {e_ii:.3e} <= {tol_ii:.3e}, "
                 f"spread {s:.3e}, vs the reference {err:.3e} <= {bound:.3e}")
        assert e_i <= tol_i and e_ii <= tol_ii and err <= bound, f"{key} {name}: {terms}"
        worst = max(worst, (e_i / tol_i, path, e_i, tol_i, e_ii, tol_ii, s))
        for coord in arr.mesh.coords():
            c = "_".join(map(str, coord))
            bounds = ref[f"{key}/bounds/{path}/{c}"]
            assert [list(b) for b in arr.index(coord)] == bounds.tolist(), (path, coord)
            block = arr.blocks[coord].numpy()
            shard = ref[f"{key}/shard/{path}/{c}"]
            assert block.shape == shard.shape, (path, coord)
            assert float(np.max(np.abs(block - shard), initial=0.0)) <= bound, (path, coord)
    _, path, e_i, tol_i, e_ii, tol_ii, s = worst
    report.append(f"worst master leaf for (i) {path}: (i) {e_i:.2e} <= {tol_i:.2e}, "
                  f"(ii) {e_ii:.2e} <= {tol_ii:.2e}, spread {s:.2e}")
    print(f"[{key}] " + "; ".join(report))


CASES = [(a, s, mb) for a in ARCHS for s in MESHES for mb in MICROBATCHES]


@pytest.mark.parametrize("arch,shape,mb", CASES, ids=lambda x: str(x))
def test_mesh_step_matches_reference(arch, shape, mb, ref):
    check_against_reference(arch, shape, mb, ref)


def test_reference_meshes_agree(ref):
    """The oracle itself: each mesh's run within 1e-5 of the (1, 1) run's
    losses (the spread the tolerance above scales)."""
    for arch in ARCHS:
        for shape in MESHES:
            for mb in MICROBATCHES:
                a = ref[f"{arch}/{shape[0]}x{shape[1]}/{mb}/loss"]
                b = ref[f"{arch}/1x1/{mb}/loss"]
                assert np.max(np.abs(a - b) / np.abs(b)) <= 1e-5, (arch, shape, mb)


# ---------------------------------------------------------------------------
# the one-device step, checkpoints, the CLI
# ---------------------------------------------------------------------------

def _one_device_state(bundle, seed=0):
    params = bundle.init_params(torch.Generator().manual_seed(seed), device="cpu")
    return t_optim.init_state(params, t_optim.AdamWConfig(**OPT))


@pytest.mark.parametrize("arch,stem,mb", [("qwen3-0.6b", False, 1), ("qwen3-0.6b", True, 2),
                                          ("arctic-480b", False, 2), ("whisper-medium", True, 1)],
                         ids=lambda x: str(x))
def test_one_by_one_mesh_is_the_one_device_step(arch, stem, mb):
    from repro_torch.core.config import StemConfig
    bundle, mesh, ssh, bsh, data = setup(arch, (1, 1))
    policy = (StemConfig(block_size=16, min_budget_blocks=2, sink_blocks=1, local_blocks=1,
                         stride=4) if stem else None)
    opt = t_optim.AdamWConfig(**OPT)
    one = t_steps.make_train_step(bundle, opt, stem_cfg=policy, microbatches=mb)
    meshed = t_steps.make_train_step(bundle, opt, stem_cfg=policy, microbatches=mb,
                                     grad_shardings=ssh.master)
    s1 = _one_device_state(bundle)
    s2 = t_steps.place_state(_one_device_state(bundle), ssh)
    for s in range(STEPS):
        batch = data.batch_at(s)
        s1, m1 = one(s1, make_global_batch(batch, "cpu"))
        s2, m2 = meshed(s2, make_global_batch(batch, mesh, bsh))
        assert {k: float(v) for k, v in m1.items()} == {k: float(v) for k, v in m2.items()}
    g = t_steps.gather_state(s2)
    assert torch.equal(s1.step, g.step)
    for name in ("master", "mu", "nu"):
        for a, b in zip(tree_leaves(getattr(s1, name)), tree_leaves(getattr(g, name))):
            assert torch.equal(a, b), name


@pytest.mark.parametrize("arch,shape", [("arctic-480b", (2, 1)), ("arctic-480b", (4, 1)),
                                        ("recurrentgemma-2b", (1, 2))], ids=lambda x: str(x))
def test_mesh_step_is_bitwise_run_to_run(arch, shape):
    """Two runs of the same mesh steps (microbatches 2) from the same state
    give the same bits: the metrics and every master block.  The sums run
    in rank order, and no gradient lands on a block by allocation order."""
    opt = t_optim.AdamWConfig(**OPT)
    runs = []
    for _ in range(2):
        bundle, mesh, ssh, bsh, data = setup(arch, shape)
        state = t_steps.place_state(_one_device_state(bundle), ssh)
        step = t_steps.make_train_step(bundle, opt, microbatches=2, grad_shardings=ssh.master)
        metrics = []
        for s in range(STEPS):
            state, m = step(state, make_global_batch(data.batch_at(s), mesh, bsh))
            metrics.append({k: float(v) for k, v in m.items()})
        runs.append((metrics, [(c, a.blocks[c].clone()) for a in tree_leaves(state.master)
                               for c in a.mesh.coords()]))
    assert runs[0][0] == runs[1][0]
    for (c, a), (_, b) in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b), c


def test_checkpoint_reshards_across_meshes(tmp_path):
    """Saved at (2, 1): restored bitwise at (1, 1) and (4, 1), and the
    restored (4, 1) state steps as the (2, 1) one does (within fp32
    reduction-order noise)."""
    bundle, mesh, ssh, bsh, data = setup("qwen1.5-4b", (2, 1))
    opt = t_optim.AdamWConfig(**OPT)
    state = t_steps.place_state(_one_device_state(bundle), ssh)
    step = t_steps.make_train_step(bundle, opt, grad_shardings=ssh.master)
    state, _ = step(state, make_global_batch(data.batch_at(0), mesh, bsh))
    mgr = TManager(str(tmp_path / "ckpt"))
    mgr.save(1, state, extra={"mesh": [2, 1]})
    saved = t_steps.gather_state(state)
    template = t_steps.abstract_opt_state(bundle.abstract_params()[0], opt)
    for shape in ((1, 1), (4, 1)):
        _, mesh2, ssh2, bsh2, _ = setup("qwen1.5-4b", shape)
        got, meta = mgr.restore(template, shardings=ssh2)
        assert meta["extra"] == {"mesh": [2, 1]}
        for a, b in zip(tree_leaves(got.master), tree_leaves(ssh2.master)):
            assert a.sharding == b
        g = t_steps.gather_state(got)
        for name in ("step", "master", "mu", "nu"):
            for a, b in zip(tree_leaves(getattr(saved, name)), tree_leaves(getattr(g, name))):
                assert torch.equal(a, b), (shape, name)
    step2 = t_steps.make_train_step(bundle, opt, grad_shardings=ssh2.master)
    _, m2 = step2(got, make_global_batch(data.batch_at(1), mesh2, bsh2))
    _, m1 = step(state, make_global_batch(data.batch_at(1), mesh, bsh))
    assert abs(float(m2["loss"]) - float(m1["loss"])) <= 1e-6 * abs(float(m1["loss"]))


def test_checkpoint_crosses_packages_from_a_mesh(tmp_path):
    """The port's (2, 1) checkpoint restores in the reference's manager, and
    the reference's checkpoint restores onto the port's (4, 1) mesh."""
    import jax
    import jax.numpy as jnp
    from repro import configs as j_configs
    from repro import optim as j_optim
    from repro.checkpoint import CheckpointManager as JManager
    from repro.models import registry as j_registry

    bundle, mesh, ssh, bsh, data = setup("qwen3-0.6b", (2, 1))
    opt = t_optim.AdamWConfig(**OPT)
    state = t_steps.place_state(_one_device_state(bundle), ssh)
    state, _ = t_steps.make_train_step(bundle, opt, grad_shardings=ssh.master)(
        state, make_global_batch(data.batch_at(0), mesh, bsh))
    TManager(str(tmp_path / "port")).save(1, state)
    jcfg = j_configs.reduced(j_configs.get_config("qwen3-0.6b")).replace(dtype="float32")
    jb = j_registry.build(jcfg)
    jopt = j_optim.AdamWConfig(**OPT)
    jtemplate = jax.eval_shape(
        lambda: j_optim.init_state(jb.init_params(jax.random.PRNGKey(0)), jopt))
    jtemplate = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jtemplate)
    restored, _ = JManager(str(tmp_path / "port")).restore(jtemplate)
    saved = t_steps.gather_state(state)
    for name in ("master", "mu", "nu"):
        for path, leaf in _paths(getattr(saved, name)):
            want = getattr(restored, name)
            for k in path.split("/"):
                want = want[k]
            assert np.array_equal(leaf.numpy(), np.asarray(want)), (name, path)

    jstate = j_optim.init_state(jax.jit(jb.init_params)(jax.random.PRNGKey(1)), jopt)
    JManager(str(tmp_path / "ref")).save(3, jstate)
    _, mesh4, ssh4, _, _ = setup("qwen3-0.6b", (4, 1))
    got, meta = TManager(str(tmp_path / "ref")).restore(
        t_steps.abstract_opt_state(bundle.abstract_params()[0], opt), shardings=ssh4)
    assert meta["step"] == 3
    for path, leaf in _paths(got.master):
        want = jstate.master
        for k in path.split("/"):
            want = want[k]
        assert isinstance(leaf, ShardedArray)
        assert np.array_equal(leaf.gather("cpu").numpy(), np.asarray(want)), path


@pytest.mark.parametrize("n", [2, 4])
def test_cli_over_cpu_devices(n, tmp_path):
    """``main(argv, devices=[cpu] * n)``: an (n, 1) mesh whose losses are the
    mesh step's, the (1, 1) CLI's within 1e-5, and ``--restore`` of an
    (n, 1) checkpoint onto (1, 1) resumes the uninterrupted losses."""
    def argv(steps, *extra):
        return ["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu", "--steps",
                str(steps), "--batch", "4", "--seq", "64", "--lr", "1e-2", *extra]
    one = t_train.main(argv(4))
    mesh = t_train.main(argv(4), devices=["cpu"] * n)
    assert one["mesh"] == [1, 1] and mesh["mesh"] == [n, 1]
    np.testing.assert_allclose(mesh["losses"], one["losses"], rtol=1e-5)
    ck = ("--checkpoint-dir", str(tmp_path / "c"), "--checkpoint-every", "2")
    t_train.main(argv(2, *ck), devices=["cpu"] * n)
    resumed = t_train.main(argv(4, *ck, "--restore"))
    assert resumed["losses"] == pytest.approx(mesh["losses"][2:], rel=1e-5)


@pytest.mark.parametrize("n,grid", [(256, [16, 16]), (512, [2, 16, 16])])
def test_cli_production_grid(n, grid):
    """From 256 devices the CLI trains over the production grid, with the
    pod axis from 512 (the reference's choice in ``launch/train.py``): 16
    / 32 data shards, the model axis 16; the losses within 1e-5 of the
    (1, 1) CLI's."""
    argv = ["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu", "--steps", "2",
            "--batch", "32", "--seq", "16"]
    one = t_train.main(argv)
    got = t_train.main(argv, devices=["cpu"] * n)
    assert got["mesh"] == grid
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-5)


def test_cli_refusals_keep_their_messages(monkeypatch):
    argv = ["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu", "--steps", "1"]
    with pytest.raises(SystemExit, match="prod-flags"):
        t_train.main(argv + ["--prod-flags"], devices=["cpu"] * 2)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:1234")
    with pytest.raises(SystemExit, match="JAX_COORDINATOR_ADDRESS"):
        t_train.main(argv, devices=["cpu"] * 2)


def test_pod_mesh_step_matches_one_device():
    """A (pod, data, model) = (2, 2, 1) mesh: four data shards in pod-major
    order, ZeRO-1 over pod and data; the losses and the final master
    within fp32 reduction noise of the one-device step."""
    cfg = t_configs.reduced(t_configs.get_config("qwen3-0.6b")).replace(dtype="float32")
    bundle = t_registry.build(cfg)
    mesh = t_mesh.make_mesh((2, 2, 1), ("pod", "data", "model"), platform="cpu")
    av, ax = bundle.abstract_params()
    ssh = t_steps.opt_state_shardings(cfg, mesh, t_rules.param_shardings(cfg, mesh, av, ax), av)
    assert any("pod" in str(s.spec) for s in tree_leaves(ssh.master))
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH, seed=0)
    bsh = t_rules.batch_sharding(cfg, mesh, {k: torch.empty(v.shape, device="meta")
                                             for k, v in data.batch_at(0).items()})
    assert bsh["tokens"].spec == (("pod", "data"),)
    opt = t_optim.AdamWConfig(**OPT)
    one = t_steps.make_train_step(bundle, opt)
    meshed = t_steps.make_train_step(bundle, opt, grad_shardings=ssh.master)
    s1, s2 = _one_device_state(bundle), t_steps.place_state(_one_device_state(bundle), ssh)
    for s in range(STEPS):
        s1, m1 = one(s1, make_global_batch(data.batch_at(s), "cpu"))
        s2, m2 = meshed(s2, make_global_batch(data.batch_at(s), mesh, bsh))
        assert abs(float(m1["loss"]) - float(m2["loss"])) <= 1e-5 * float(m1["loss"])
    for a, b in zip(tree_leaves(s1.master), tree_leaves(t_steps.gather_state(s2).master)):
        assert float((a - b).abs().max()) <= 1e-5
