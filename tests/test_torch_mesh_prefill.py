"""The port's mesh fixed-batch prefill and serve steps
(``launch/steps.mesh_prefill_step`` / ``mesh_serve_step``) against the
reference's ``make_prefill_step`` / ``make_serve_step`` lowered under the
dry run's shardings.

The reference needs a mesh of JAX devices: a module-scoped subprocess runs
it with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``, its meshes
``jax.sharding.Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data",
"model"))`` (``tests/test_torch_mesh_training.py`` says why not
``jax.make_mesh``).  For each reduced fp32 config and mesh it jits the
prefill with ``in_shardings`` (``param_shardings``, ``batch_sharding``) and
``out_shardings`` (logits ``("batch", "vocab")``, ``cache_shardings``)
inside ``sharding.context.use``, pins the ragged ``cache_lens`` with
``set_cache_positions``, then runs ``STEPS`` greedy steps of the serve step
with its caches donated and their output shardings pinned.  It writes the
parameters, the batch, every step's logits and greedy ids, and every cache
leaf's ``addressable_shards`` (coordinate, index, data) after the prefill
and after the last step to an npz.

The port runs the same steps over a mesh of CPU shards from the same
parameters (``arrays.place`` of the reference's values), ``cache_lens`` on
its first serve step.  Held, for every case:

* the prefill logits and each step's logits within ``TOL`` (1e-4, the
  fp32 rule), the greedy ids equal;
* every cache block at every coordinate, after the prefill and after the
  last step, at the reference's index with its data within ``TOL`` (a
  bf16 leaf, MLA's latents, within ``TOL`` plus one bf16 unit of the
  reference's value: the two round fp32 values that differ by ~1e-7); the
  ``pos`` leaves exact;
* the logits left split by vocab over the model axis;
* the block selections of the stem prefill and of the policy-sparse decode
  (their indices and live counts / slots) equal to the port's one-device
  run's, shard by shard; and at (1, 1) every logit and cache block bitwise
  the port's one-device steps'.

Configs (``ARCHS``, here; the MoE one in
``tests/test_torch_mesh_prefill_moe.py``, the MLA one in
``tests/test_torch_mesh_prefill_mla.py``, the SSD and RG-LRU ones in
``tests/test_torch_mesh_prefill_mixers.py``, each with its own subprocess
so that ``--dist loadfile`` spreads them): qwen3-0.6b (2 KV heads: its
cache split by heads at model 2, by sequence at model 4), gemma-2b (1 KV
head: by sequence) and whisper-medium (the decoder's self-attention cache
and the cross-attention K / V by heads; no ``cache_lens``: the reference's
``decode_step`` reads one position for the whole batch).  Arms: "stem" (the
prefill at a reduced block size, and where the reference's
``decode_step`` takes a policy, the paged-servable configs, the
policy-sparse serve step) on every mesh; "dense" at ``DENSE_MESHES`` (one
mesh of each cache layout).  The batch is ragged: row 1's length, 20, ends
inside the first of the cache's four sequence blocks at model 4, so three
shards add zero weight to its softmax.
"""
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch import configs as t_configs
from repro_torch.core import policy as policy_lib
from repro_torch.core.config import StemConfig
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import steps as t_steps
from repro_torch.models import attention as t_attention
from repro_torch.models import registry as t_registry
from repro_torch.models import transformer as t_transformer
from repro_torch.sharding import arrays
from repro_torch.sharding import context as shctx
from repro_torch.sharding import rules as t_rules

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
MESHES = [(1, 1), (2, 1), (1, 2), (2, 2), (1, 4)]
DENSE_MESHES = {True: [(1, 1), (1, 2), (1, 4)], False: [(1, 1), (1, 4)]}  # by paged-servable
B, N, MAX_LEN, STEPS = 4, 64, 128, 4
LENS = (64, 20, 64, 40)
TOL = 1e-4
ARCHS = ("qwen3-0.6b", "gemma-2b", "whisper-medium")

# The reference's sharded prefill and serve steps on 8 forced host devices;
# argv: the archs (comma-separated), the npz path.
JAX_SCRIPT = r"""
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from repro import configs
from repro.core.config import StemConfig
from repro.launch import steps as steps_lib
from repro.models import registry, transformer
from repro.sharding import context as shctx
from repro.sharding import rules as rules_lib

MESHES = [(1, 1), (2, 1), (1, 2), (2, 2), (1, 4)]
DENSE_MESHES = {True: [(1, 1), (1, 2), (1, 4)], False: [(1, 1), (1, 4)]}
B, N, MAX_LEN, STEPS = 4, 64, 128, 4
LENS = np.array([64, 20, 64, 40], np.int32)
POL = StemConfig(block_size=16, min_budget_blocks=2, sink_blocks=1, local_blocks=1, stride=4)
assert len(jax.devices()) >= 8, jax.devices()
out = {}


def leaves(tree, pre=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], f"{pre}/{k}" if pre else k)]
    if hasattr(tree, "_fields"):
        return [x for f, v in zip(tree._fields, tree) for x in leaves(v, f"{pre}/{f}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in leaves(v, f"{pre}/{i}" if pre else str(i))]
    return [(pre, tree)]


for arch in sys.argv[1].split(","):
    cfg = configs.reduced(configs.get_config(arch)).replace(dtype="float32")
    bundle = registry.build(cfg)
    init = jax.jit(bundle.init_params)(jax.random.PRNGKey(0))
    for p, v in leaves(init):
        out[f"{arch}/init/{p}"] = np.asarray(v)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, N)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.encdec.encoder_frames, cfg.d_model)).astype(np.float32)
    for k, v in batch.items():
        out[f"{arch}/batch/{k}"] = v
    ragged = cfg.family != "encdec"
    paged = ragged and all(k in transformer.PAGED_KINDS
                           for _, kinds in transformer.layer_program(cfg) for k in kinds)
    av, ax = bundle.abstract_params()
    for shape in MESHES:
        arms = [("stem", POL, POL if paged else None)] if cfg.use_stem else []
        if not cfg.use_stem or shape in DENSE_MESHES[paged]:
            arms.append(("dense", None, None))
        mesh = Mesh(np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape),
                    ("data", "model"))
        coord_of = {d.id: c for c, d in np.ndenumerate(mesh.devices)}
        rules = rules_lib.logical_rules(cfg, mesh)
        psh = rules_lib.param_shardings(cfg, mesh, av, ax)
        bsh = rules_lib.batch_sharding(cfg, mesh, {
            k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in batch.items()})
        logits_sh = NamedSharding(mesh, rules_lib.spec_for(
            (B, cfg.padded_vocab), ("batch", "vocab"), rules, mesh))
        cache_sh = rules_lib.cache_shardings(cfg, mesh, jax.eval_shape(
            lambda: bundle.init_caches(B, MAX_LEN)))

        def record(key, caches):
            for p, v in leaves(caches):
                for sh in v.addressable_shards:
                    c = "_".join(map(str, coord_of[sh.device.id]))
                    out[f"{key}/bounds/{p}/{c}"] = np.asarray(
                        [s.indices(n)[:2] for s, n in zip(sh.index, v.shape)],
                        np.int64).reshape(-1, 2)
                    data = sh.data   # bf16 (MLA's latents) kept exactly as fp32
                    out[f"{key}/shard/{p}/{c}"] = np.asarray(
                        data.astype(jnp.float32) if data.dtype == jnp.bfloat16 else data)

        for arm, ppol, spol in arms:
            key = f"{arch}/{shape[0]}x{shape[1]}/{arm}"
            with mesh, shctx.use(cfg, mesh):
                params = jax.device_put(init, psh)
                prefill = jax.jit(steps_lib.make_prefill_step(bundle, max_len=MAX_LEN,
                                                              stem_cfg=ppol),
                                  in_shardings=(psh, bsh), out_shardings=(logits_sh, cache_sh))
                logits, caches = prefill(params, {k: jax.device_put(v, bsh[k])
                                                  for k, v in batch.items()})
                out[f"{key}/logits/0"] = np.asarray(logits)
                record(f"{key}/prefill", caches)
                if ragged:
                    caches = steps_lib.set_cache_positions(caches, jnp.asarray(LENS))
                    caches = jax.device_put(caches, rules_lib.cache_shardings(cfg, mesh, caches))
                step = steps_lib.make_serve_step(bundle, stem_cfg=spol)
                serve = None
                for s in range(STEPS):
                    ids = np.argmax(np.asarray(logits), axis=-1).astype(np.int32)[:, None]
                    out[f"{key}/ids/{s}"] = ids
                    args = (params, jnp.asarray(ids), caches)
                    if serve is None:
                        sh = rules_lib.cache_shardings(cfg, mesh, jax.eval_shape(step, *args)[1])
                        serve = jax.jit(step, out_shardings=(logits_sh, sh), donate_argnums=(2,))
                    logits, caches = serve(*args)
                    out[f"{key}/logits/{s + 1}"] = np.asarray(logits)
                out[f"{key}/ids/{STEPS}"] = np.argmax(np.asarray(logits), axis=-1).astype(
                    np.int32)[:, None]
                record(f"{key}/decode", caches)
np.savez(sys.argv[2], **out)
"""


def run_reference(archs, tmp_path_factory) -> dict:
    """The JAX side for ``archs``, in a process with 8 devices."""
    path = tmp_path_factory.mktemp("jax_mesh_prefill") / "prefill.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    t0 = time.time()
    res = subprocess.run([sys.executable, "-c", JAX_SCRIPT, ",".join(archs), str(path)],
                         env=env, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    print(f"[reference {','.join(archs)}] {time.time() - t0:.1f} s")
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(ARCHS, tmp_path_factory)


POL = StemConfig(block_size=16, min_budget_blocks=2, sink_blocks=1, local_blocks=1, stride=4)


def _cfg(arch):
    return t_configs.reduced(t_configs.get_config(arch)).replace(dtype="float32")


def _paged(cfg) -> bool:
    return cfg.family != "encdec" and all(
        k in t_transformer.PAGED_KINDS for _, kinds in t_transformer.layer_program(cfg)
        for k in kinds)


def arms(arch, shape) -> list:
    """The arms the reference runs at ``shape`` (its script's rule)."""
    cfg = _cfg(arch)
    out = ["stem"] if cfg.use_stem else []
    if not cfg.use_stem or shape in DENSE_MESHES[_paged(cfg)]:
        out.append("dense")
    return out


def cases(archs) -> list:
    return [(a, s, arm) for a in archs for s in MESHES for arm in arms(a, s)]


def _leaves(tree, pre=""):
    """(path, leaf) of a cache tree, named as the reference's script names
    them."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], f"{pre}/{k}" if pre else k)]
    if hasattr(tree, "_fields"):
        return [x for f, v in zip(tree._fields, tree) for x in _leaves(v, f"{pre}/{f}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _leaves(v, f"{pre}/{i}" if pre else str(i))]
    return [(pre, tree)]


def _tree_from(template, z: dict, prefix: str):
    def build(node, pre):
        if isinstance(node, dict):
            return {k: build(v, f"{pre}/{k}" if pre else k) for k, v in node.items()}
        return torch.from_numpy(np.array(z[f"{prefix}/{pre}"]))
    return build(template, "")


class Selections:
    """Records every prefill and decode block selection (indices and live
    counts / slots) made while it is entered, by phase."""

    def __init__(self):
        self.calls: dict = {}
        self.phase = "prefill"

    def __enter__(self):
        self._pre = policy_lib.SparsityPolicy.prefill_select
        self._dec = policy_lib.SparsityPolicy.decode_select
        rec = self

        def prefill_select(pol, *a, **kw):
            sel, k_max = rec._pre(pol, *a, **kw)
            rec.calls.setdefault(rec.phase, []).append(
                (sel.indices.clone(), sel.live_counts.clone()))
            return sel, k_max

        def decode_select(pol, *a, **kw):
            sel = rec._dec(pol, *a, **kw)
            rec.calls.setdefault(rec.phase, []).append((sel.indices.clone(), sel.live.clone()))
            return sel
        policy_lib.SparsityPolicy.prefill_select = prefill_select
        policy_lib.SparsityPolicy.decode_select = decode_select
        return self

    def __exit__(self, *exc):
        policy_lib.SparsityPolicy.prefill_select = self._pre
        policy_lib.SparsityPolicy.decode_select = self._dec


def policies(arch, arm):
    """(prefill policy, serve policy) of an arm."""
    if arm == "dense":
        return None, None
    return POL, POL if _paged(_cfg(arch)) else None


def _snapshot(caches) -> dict:
    """{path: {coordinate: (its bounds, a copy of its block)}} of a mesh
    step's caches, or {path: a copy of the tensor} of a one-device step's."""
    out = {}
    for path, leaf in _leaves(caches):
        if isinstance(leaf, arrays.ShardedArray):
            out[path] = {c: ([list(b) for b in leaf.index(c)], leaf.blocks[c].clone())
                         for c in leaf.mesh.coords()}
        else:
            out[path] = leaf.clone()
    return out


def port_run(arch, shape, arm, ref) -> dict:
    """The port's steps on the reference's parameters and batch: a mesh of
    CPU shards at ``shape``, or one device at None."""
    cfg = _cfg(arch)
    bundle = t_registry.build(cfg)
    init = _tree_from(bundle.abstract_params()[0], ref, f"{arch}/init")
    batch = {k: torch.from_numpy(np.array(ref[f"{arch}/batch/{k}"]))
             for k in ("tokens", "frames") if f"{arch}/batch/{k}" in ref}
    ppol, spol = policies(arch, arm)
    ragged = cfg.family != "encdec"
    lens = torch.tensor(LENS, dtype=torch.int32)
    if shape is None:
        params = init
        prefill = t_steps.make_prefill_step(bundle, max_len=MAX_LEN, stem_cfg=ppol)
        serve = t_steps.make_serve_step(bundle, stem_cfg=spol)
        whole = lambda lg: lg
    else:
        mesh = t_mesh.make_mesh(shape, ("data", "model"), platform="cpu")
        av, ax = bundle.abstract_params()
        psh = t_rules.param_shardings(cfg, mesh, av, ax)
        params = t_rules.tree_map(lambda t, sh: arrays.place(t, sh), init, psh)
        bsh = t_rules.batch_sharding(cfg, mesh, {k: torch.empty(v.shape, device="meta")
                                                  for k, v in batch.items()})
        batch = {k: arrays.place(v, bsh[k]) for k, v in batch.items()}
        prefill = t_steps.mesh_prefill_step(bundle, mesh, max_len=MAX_LEN, stem_cfg=ppol)
        serve = t_steps.mesh_serve_step(bundle, mesh, stem_cfg=spol)
        whole = lambda lg: lg.gather("cpu")
    got = {"logits": [], "ids": [], "shards": []}
    with Selections() as sel:
        logits, caches = prefill(params, batch)
        got["prefill"] = _snapshot(caches)
        for s in range(STEPS + 1):
            if shape is not None:
                got["shards"].append(logits)
            lg = whole(logits)
            got["logits"].append(lg)
            got["ids"].append(lg.argmax(-1).to(torch.int32)[:, None])
            if s == STEPS:
                break
            sel.phase = f"decode{s}"
            kw = {"cache_lens": lens} if s == 0 and ragged else {}
            logits, caches = serve(params, got["ids"][-1], caches, **kw)
    got["decode"], got["caches"], got["selections"] = _snapshot(caches), caches, sel.calls
    return got


_ONE: dict = {}


def port_one(arch, arm, ref) -> dict:
    """The port's one-device run, made once a module."""
    if (arch, arm) not in _ONE:
        _ONE[(arch, arm)] = port_run(arch, None, arm, ref)
    return _ONE[(arch, arm)]


def _regroup(calls: list, n_data: int, n_one: int) -> list:
    """A mesh run's selections of one phase as the one-device run's: per
    data shard (rank order), per call of the one-device run, ``per`` calls
    (one a model shard, or one for all its heads), their heads joined, then
    the data shards' rows joined."""
    per = len(calls) // (n_data * n_one)
    assert per * n_data * n_one == len(calls), (len(calls), n_data, n_one)
    out = []
    for i in range(n_one):
        rows = []
        for d in range(n_data):
            at = (d * n_one + i) * per
            rows.append(tuple(torch.cat([c[j] for c in calls[at:at + per]], dim=1)
                              for j in range(2)))
        out.append(tuple(torch.cat([r[j] for r in rows], dim=0) for j in range(2)))
    return out


def check_case(arch, shape, arm, ref):
    """The module docstring's checks for one (config, mesh, arm)."""
    got = port_run(arch, shape, arm, ref)
    one = port_one(arch, arm, ref)
    key = f"{arch}/{shape[0]}x{shape[1]}/{arm}"
    errs = []
    for s, lg in enumerate(got["logits"]):
        want = torch.from_numpy(np.array(ref[f"{key}/logits/{s}"]))
        assert lg.shape == want.shape, (s, lg.shape, want.shape)
        errs.append(float((lg - want).abs().max()))
        assert errs[-1] <= TOL, (key, s, errs)
        assert np.array_equal(got["ids"][s].numpy(), ref[f"{key}/ids/{s}"]), (key, s)
    for lg in got["shards"]:        # left split by vocab, never gathered whole
        for c, blk in lg.blocks.items():
            assert tuple(blk.shape) == (B // shape[0], lg.shape[1] // shape[1]), (c, blk.shape)
    worst = 0.0
    for phase in ("prefill", "decode"):
        for path, blocks in got[phase].items():
            for coord, (bounds, blk) in blocks.items():
                c = "_".join(map(str, coord))
                assert bounds == ref[f"{key}/{phase}/bounds/{path}/{c}"].tolist(), \
                    (phase, path, coord)
                shard = ref[f"{key}/{phase}/shard/{path}/{c}"]
                assert tuple(blk.shape) == shard.shape, (phase, path, coord, blk.shape)
                if path.endswith("pos"):
                    assert np.array_equal(blk.numpy(), shard), (phase, path, coord)
                    continue
                diff = np.abs(blk.float().numpy() - shard)
                # a bf16 leaf (MLA's latents) may round the fp32 value apart by one unit
                lim = TOL + (2.0 ** -7 * np.abs(shard) if blk.dtype == torch.bfloat16 else 0.0)
                worst = max(worst, float(np.max(diff, initial=0.0)))
                assert np.all(diff <= lim), (phase, path, coord, float(np.max(diff - lim)))
    # the selections, shard by shard, against the one-device run's
    for phase, calls in one["selections"].items():
        mine = _regroup(got["selections"].get(phase, []), shape[0], len(calls))
        for (a, b), (c, d) in zip(mine, calls):
            assert torch.equal(a, c) and torch.equal(b, d), (key, phase)
    assert set(got["selections"]) == set(one["selections"])
    if shape == (1, 1):
        for a, b in zip(got["logits"], one["logits"]):
            assert torch.equal(a, b)
        for phase in ("prefill", "decode"):
            for path, blocks in got[phase].items():
                assert torch.equal(blocks[(0, 0)][1], one[phase][path]), (phase, path)
    print(f"[{key}] logits max err by step {['%.2e' % e for e in errs]}, "
          f"cache blocks {worst:.2e}, selection calls "
          f"{ {k: len(v) for k, v in got['selections'].items()} }")


@pytest.mark.parametrize("arch,shape,arm", cases(ARCHS), ids=lambda x: str(x))
def test_mesh_prefill_serve_matches_reference(arch, shape, arm, ref):
    check_case(arch, shape, arm, ref)


def test_mesh_prefill_serve_is_bitwise_run_to_run():
    """Two runs of the stem mesh prefill and policy-sparse serve steps on
    (1, 4) (the cache split by sequence) give the same bits: every step's
    logits and every cache block (the sums across shards and the
    partial-softmax combine run in rank order)."""
    cfg = _cfg("qwen3-0.6b")
    bundle = t_registry.build(cfg)
    params = bundle.init_params(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (B, N), generator=torch.Generator().manual_seed(1))
    runs = []
    for _ in range(2):
        mesh = t_mesh.make_mesh((1, 4), ("data", "model"), platform="cpu")
        av, ax = bundle.abstract_params()
        psh = t_rules.param_shardings(cfg, mesh, av, ax)
        placed = t_rules.tree_map(lambda t, sh: arrays.place(t, sh), params, psh)
        logits, caches = t_steps.mesh_prefill_step(bundle, mesh, max_len=MAX_LEN, stem_cfg=POL)(
            placed, {"tokens": tokens})
        serve = t_steps.mesh_serve_step(bundle, mesh, stem_cfg=POL)
        out = [logits.gather("cpu")]
        for s in range(3):
            logits, caches = serve(placed, out[-1].argmax(-1)[:, None], caches,
                                   cache_lens=torch.tensor(LENS) if s == 0 else None)
            out.append(logits.gather("cpu"))
        runs.append((out, _snapshot(caches)))
    for a, b in zip(runs[0][0], runs[1][0]):
        assert torch.equal(a, b)
    for path, blocks in runs[0][1].items():
        for c, (_, blk) in blocks.items():
            assert torch.equal(blk, runs[1][1][path][c][1]), (path, c)


def test_partial_softmax_combine_adds_zero_weight():
    """The sequence-split decode's combine: a shard that keeps no key of a
    row adds zero weight (no NaN), the result equals the softmax over the
    union of the shards' keys, and a row no shard keeps a key of is zeros."""
    mesh = t_mesh.make_mesh((1, 3), ("data", "model"), platform="cpu")
    mp = shctx.model_shards_of(mesh, (0, 0))
    gen = torch.Generator().manual_seed(0)
    s = torch.randn((2, 12), generator=gen)
    v = torch.randn((2, 12, 5), generator=gen)
    keep = torch.zeros((2, 12), dtype=torch.bool)
    keep[0, :3] = True              # row 0: only the first shard's keys
    parts = []
    for t in range(3):
        sl = slice(4 * t, 4 * t + 4)
        vt = v[:, sl]
        parts.append((t, t_attention._partial_softmax(
            s[:, sl], keep[:, sl], lambda p: torch.einsum("bn,bnd->bd", p, vt))))
    o = t_attention.combine_partials(parts, mp)
    want = torch.einsum("n,nd->d", torch.softmax(s[0, :3], dim=-1), v[0, :3])
    assert torch.isfinite(o).all()
    torch.testing.assert_close(o[0], want, rtol=1e-6, atol=1e-6)
    assert torch.equal(o[1], torch.zeros(5))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v3-671b", "mamba2-370m",
                                  "recurrentgemma-2b", "whisper-medium"])
def test_mesh_steps_where_the_rules_leave_dims_whole(arch):
    """At (1, 3) the model axis divides none of the reduced configs' heads,
    channels or cache lengths: the attention, MLA, SSD and RG-LRU layers
    compute on the lead shard and every cache leaf is whole on every shard
    (``cache_shardings`` replicates it).  The mesh steps equal the port's
    one-device steps within 1e-5, and every model shard's cache blocks
    are equal."""
    cfg = _cfg(arch)
    bundle = t_registry.build(cfg)
    params = bundle.init_params(torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, N), generator=gen)}
    if cfg.encdec:
        batch["frames"] = torch.randn((2, cfg.encdec.encoder_frames, cfg.d_model),
                                      generator=gen)
    ppol = POL if cfg.use_stem else None
    one_lg, one_c = t_steps.make_prefill_step(bundle, max_len=MAX_LEN, stem_cfg=ppol)(
        params, batch)
    mesh = t_mesh.make_mesh((1, 3), ("data", "model"), platform="cpu")
    av, ax = bundle.abstract_params()
    psh = t_rules.param_shardings(cfg, mesh, av, ax)
    placed = t_rules.tree_map(lambda t, sh: arrays.place(t, sh), params, psh)
    lg, caches = t_steps.mesh_prefill_step(bundle, mesh, max_len=MAX_LEN, stem_cfg=ppol)(
        placed, batch)
    serve_one, serve = t_steps.make_serve_step(bundle), t_steps.mesh_serve_step(bundle, mesh)
    errs = [float((lg.gather("cpu") - one_lg).abs().max())]
    for _ in range(3):
        ids = one_lg.argmax(-1)[:, None]
        one_lg, one_c = serve_one(params, ids, one_c)
        lg, caches = serve(placed, ids, caches)
        errs.append(float((lg.gather("cpu") - one_lg).abs().max()))
    assert max(errs) <= 1e-5, errs
    whole = 0
    for path, leaf in _leaves(caches):
        if path.endswith("pos"):
            continue
        assert leaf.sharding.spec in ((), (None, None)) or "model" not in str(
            leaf.sharding.spec), (path, leaf.sharding.spec)
        blocks = [leaf.blocks[c] for c in mesh.coords()]
        assert all(torch.equal(b, blocks[0]) for b in blocks), path
        whole += 1
    assert whole
