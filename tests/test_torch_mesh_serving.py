"""Mesh serving of the port (``repro_torch.sharding.serving`` and the
engine's ``EngineConfig(mesh=(dp, tp))``) against the reference's sharded
engine.

The meshes are grids of CPU shards, so nothing here skips on the CPU.  The
reference's own mesh tests (``tests/test_sharding.py:172-322``) need 8 JAX
devices; a module-scoped subprocess runs the JAX mesh engine with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` on the reference's
``TINY`` / ``STEM_SRV`` / ``TRACE`` (imported from ``tests/test_sharding.py``
there and held equal to this file's copies) for the meshes (1, 2), (2, 1)
and (2, 2), and its tp = 2 preempt snapshot, and writes the streams and the
``HostShards`` bytes to an npz.  The port's streams must equal the JAX mesh
engine's and the JAX single-device engine's, sync and async, and its tp = 2
snapshot must have the reference's ``(dp, tp)`` coordinates, each shard
bitwise the port's one-device snapshot's block of KV heads and within
1e-4 of the reference's shard (the reference's snapshot is a fixed-width
row padded with the trash page; the port's holds the request's own pages,
its first ones).

Also: the allocators' conservation and the host-sync accounting (the sync
loop fetches once per active lane kind a step, mesh or not; the async loop
keeps ``host_syncs <= 2 * finished``), the tp = 2 preempt / restore round
trip, priority preemption under chaos within slot groups, the executor
contract ("replicated" refused at tp > 1, served at dp only), the refused
shapes, the prefix cache under (2, 2), the reduced
qwen3-0.6b under (2, 2) against the JAX engine, and the CLI's ``--mesh``."""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from repro import configs as j_configs
from repro.configs.base import ArchConfig as JArch
from repro.core.config import StemConfig as JStem
from repro.models import registry as j_registry
from repro.runtime import engine as j_engine

from repro_torch import configs as t_configs
from repro_torch.configs.base import ArchConfig as TArch
from repro_torch.core import policy as t_policy
from repro_torch.core.config import StemConfig as TStem
from repro_torch.launch import serve as t_serve
from repro_torch.runtime import chaos as t_chaos
from repro_torch.models import registry as t_registry
from repro_torch.models import transformer as t_transformer
from repro_torch.runtime import offload as t_offload
from repro_torch.runtime import engine as t_engine
from repro_torch.sharding import serving as t_serving
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
# tests/test_sharding.py:132-145 (the subprocess holds these to its own).
TINY = dict(name="mesh-tiny", family="dense", num_layers=2, d_model=32,
            num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64, vocab_size=64,
            qk_norm=True, dtype="float32")
STEM_SRV = dict(block_size=8, sink_blocks=1, local_blocks=1,
                min_budget_blocks=2, stride=4)
TRACE = [(5, 4, 0), (13, 6, 0), (8, 3, 1), (20, 5, 3), (9, 4, 5)]
MESHES = [(1, 2), (2, 1), (2, 2)]

# The JAX mesh engine on 8 forced host devices, the reference's own trace
# and ecfg; argv: tests directory, npz path.
JAX_MESH_SCRIPT = r"""
import dataclasses, sys
import numpy as np
import jax
sys.path.insert(0, sys.argv[1])
import test_sharding as ts
from repro.models import registry
from repro.runtime import offload as offload_lib
from repro.runtime.engine import Request, StemEngine

assert len(jax.devices()) >= 8, jax.devices()
out = {"trace": np.asarray(ts.TRACE, np.int32),
       "tiny": np.asarray([getattr(ts.TINY, k) for k in (
           "num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim",
           "d_ff", "vocab_size")], np.int32),
       "stem": np.asarray([getattr(ts.STEM_SRV, k) for k in (
           "block_size", "sink_blocks", "local_blocks", "min_budget_blocks",
           "stride")], np.int32)}
bundle = registry.build(ts.TINY)
params = bundle.init_params(jax.random.PRNGKey(0))
for mesh in [(1, 2), (2, 1), (2, 2)]:
    eng = StemEngine(bundle, params, ts.STEM_SRV, ts._serve_ecfg(mesh=mesh))
    for f in eng.run(ts._serve_requests()):
        out[f"tokens/{mesh[0]}x{mesh[1]}/{f.uid}"] = np.asarray(f.tokens, np.int32)
# test_sharding.py:237-262: the tp = 2 preempt after 4 steps.
rng = np.random.RandomState(17)
prompt = rng.randint(0, ts.TINY.vocab_size, size=(20,)).astype(np.int32)
ecfg = ts._serve_ecfg(max_slots=1, budget_frac=0.5)
eng = StemEngine(bundle, params, ts.STEM_SRV, dataclasses.replace(ecfg, mesh=(1, 2)))
eng.submit(Request(uid=0, prompt=prompt.copy(), max_new_tokens=8))
for _ in range(4):
    eng.step()
out["preempt/npages"] = np.asarray(len(eng.slot_pages[0]), np.int32)
eng.preempt(0)
leaves = jax.tree.leaves(eng.host_store.get(0),
                         is_leaf=lambda x: isinstance(x, offload_lib.HostShards))
for j, leaf in enumerate(leaves):
    for (g, t), a in leaf.shards.items():
        out[f"snap/{j}/{g}_{t}"] = np.asarray(a)
out["preempt/tokens"] = np.asarray(eng.run()[0].tokens, np.int32)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def built():
    jcfg, tcfg = JArch(**TINY), TArch(**TINY)
    jbundle = j_registry.build(jcfg)
    jparams = jbundle.init_params(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jbundle, jparams, t_registry.build(tcfg), tparams


@pytest.fixture(scope="module")
def jax_mesh(tmp_path_factory):
    """The reference's mesh engine, run in a process with 8 JAX devices."""
    path = tmp_path_factory.mktemp("jax_mesh") / "mesh.npz"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run(
        [sys.executable, "-c", JAX_MESH_SCRIPT, str(ROOT / "tests"), str(path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _reqs(mod, trace=TRACE, seed=7, vocab=TINY["vocab_size"]):
    """tests/test_sharding.py's ``_serve_requests``, for either package."""
    rng = np.random.RandomState(seed)
    return [mod.Request(uid=i, prompt=rng.randint(0, vocab, size=(p,))
                        .astype(np.int32), max_new_tokens=m, arrival_step=a)
            for i, (p, m, a) in enumerate(trace)]


def _ecfg(mod, max_slots=2, trace=TRACE, bs=STEM_SRV["block_size"], **kw):
    """tests/test_sharding.py's ``_serve_ecfg``, for either package."""
    per_slot = -(-max(p + n for p, n, _ in trace) // bs)
    return mod.EngineConfig(max_slots=max_slots,
                            num_pages=1 + 2 * max_slots * per_slot,
                            max_pages_per_slot=per_slot, **kw)


def _streams(fin):
    return {f.uid: f.tokens for f in fin}


def _lane_fetches(eng) -> dict:
    """Wrap the engine's step: counts the steps whose decode lane and whose
    chunk lane ran (a granted decode slot has a cache length > 0)."""
    counts = {"fetches": 0}
    step = eng._unified

    def counted(params, pools, tokens, table, lens, chunk=None):
        counts["fetches"] += int(bool((lens > 0).any())) + (chunk is not None)
        return step(params, pools, tokens, table, lens, chunk)
    eng._unified = counted
    return counts


def _port_run(built, mesh=None, **kw):
    eng = t_engine.StemEngine(built[2], built[3], TStem(**STEM_SRV),
                              _ecfg(t_engine, mesh=mesh, **kw))
    counts = None if kw.get("async_depth") else _lane_fetches(eng)
    return eng, eng.run(_reqs(t_engine)), counts


@pytest.fixture(scope="module")
def single(built):
    """The JAX single-device engine's and the port's single-device streams
    and the port's host syncs."""
    jfin = j_engine.StemEngine(built[0], built[1], JStem(**STEM_SRV),
                               _ecfg(j_engine)).run(_reqs(j_engine))
    eng, fin, counts = _port_run(built)
    assert _streams(fin) == _streams(jfin)
    assert eng.stats["host_syncs"] == counts["fetches"]
    return _streams(jfin), eng.stats["host_syncs"]


def test_jax_mesh_run_uses_this_files_trace(jax_mesh):
    assert jax_mesh["trace"].tolist() == [list(t) for t in TRACE]
    assert jax_mesh["tiny"].tolist() == [TINY[k] for k in (
        "num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim",
        "d_ff", "vocab_size")]
    assert jax_mesh["stem"].tolist() == [STEM_SRV[k] for k in (
        "block_size", "sink_blocks", "local_blocks", "min_budget_blocks",
        "stride")]


@pytest.mark.parametrize("loop", ["sync", "async"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_mesh_engine_matches_jax_mesh_engine(built, single, jax_mesh, mesh, loop):
    """dp slot groups x tp KV-head shards give the single-device streams
    (JAX's and the port's) and the JAX mesh engine's, stream for stream;
    every group's allocator gets its pages back.  Sync: one host fetch per
    active lane kind a step (the mesh adds none; at dp 1 the same count as
    one device).  Async: ``host_syncs <= 2 * finished``, nothing in
    flight."""
    want, single_syncs = single
    eng, fin, counts = _port_run(built, mesh=mesh,
                                 async_depth=int(loop == "async"))
    jax_streams = {uid: jax_mesh[f"tokens/{mesh[0]}x{mesh[1]}/{uid}"].tolist()
                   for uid in want}
    assert _streams(fin) == want == jax_streams
    assert all(f.error is None for f in fin)
    assert eng.groups == mesh[0] and eng.total_slots == mesh[0] * 2
    assert len(eng.allocators) == mesh[0] and eng.allocator is eng.allocators[0]
    for alloc in eng.allocators:
        alloc.check_conservation([])
        assert alloc.available == eng.ecfg.num_pages - 1
    if loop == "sync":
        assert eng.stats["host_syncs"] == counts["fetches"]
        if mesh[0] == 1:
            assert eng.stats["host_syncs"] == single_syncs
    else:
        assert eng.stats["host_syncs"] <= 2 * len(fin)
        assert not eng._inflight


def _preempted_tp2(built, mesh=(1, 2)):
    """tests/test_sharding.py:237-262 on the port: 4 steps, then preempt
    (``mesh`` None: the same on one device)."""
    rng = np.random.RandomState(17)
    prompt = rng.randint(0, TINY["vocab_size"], size=(20,)).astype(np.int32)
    mk = lambda: t_engine.Request(uid=0, prompt=prompt.copy(), max_new_tokens=8)
    ecfg = _ecfg(t_engine, max_slots=1, budget_frac=0.5)
    ref = t_engine.StemEngine(built[2], built[3], TStem(**STEM_SRV),
                              ecfg).run([mk()])[0]
    eng = t_engine.StemEngine(built[2], built[3], TStem(**STEM_SRV),
                              dataclasses.replace(ecfg, mesh=mesh))
    eng.submit(mk())
    for _ in range(4):
        eng.step()
    assert eng.slots[0] is not None and eng.slots[0].phase == "decode"
    npages = len(eng.slot_pages[0])
    eng.preempt(0)
    eng.allocators[0].check_conservation([])
    return eng, ref, npages


def test_mesh_preempt_snapshot_matches_jax_shard_for_shard(built, jax_mesh):
    """The tp = 2 snapshot is keyed by the (dp, tp) coordinates (0, 0) and
    (0, 1), as the reference's.  Each shard equals the port's one-device
    snapshot's block of KV heads bitwise, and the reference's shard at the
    same coordinate (its first ``npages`` pages) within the 1e-4 that
    holds the port's pools to the reference's (the two packages' CPU
    matmuls round the projections apart, ~1e-6 here).  The resumed stream
    equals the reference's."""
    eng, ref, npages = _preempted_tp2(built)
    one, _, _ = _preempted_tp2(built, mesh=None)
    assert npages == int(jax_mesh["preempt/npages"])
    got = t_offload.leaves(eng.host_store.get(0))
    whole = t_offload.leaves(one.host_store.get(0))
    assert len(got) == len(whole) == len({k.split("/")[1] for k in jax_mesh
                                          if k.startswith("snap/")})
    for j, (leaf, full) in enumerate(zip(got, whole)):
        assert isinstance(leaf, t_offload.HostShards)
        assert sorted(leaf.shards) == [(0, 0), (0, 1)]
        for (g, t), a in leaf.shards.items():
            assert torch.equal(a, t_serving.local_heads(full, t, 2)), (j, t)
            want = jax_mesh[f"snap/{j}/{g}_{t}"]
            assert want.shape[0] == 1       # the reference keeps the dp axis
            np.testing.assert_allclose(a.numpy(), want[0][:, :, :npages],
                                       rtol=0, atol=1e-4)
    out = eng.run()[0]
    assert out.tokens == ref.tokens == jax_mesh["preempt/tokens"].tolist()


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)], ids=lambda m: f"{m[0]}x{m[1]}")
def test_mesh_preempt_restore_roundtrip_tp2(built, mesh):
    """Preempt -> per-shard host snapshot -> restore into fresh pages on
    the same coordinates: re-extracting the restored pages gives the
    snapshot back bitwise, shard for shard, and the stream equals the
    uninterrupted run's (the reference's ``:222-289``)."""
    eng, ref, _ = _preempted_tp2(built, mesh)
    snap = eng.host_store.get(0)
    eng._admit()
    assert eng.slots[0] is not None and not eng.preempted
    back = eng._extract(eng.slot_pages[0], 0)
    for got, want in zip(t_offload.leaves(back), t_offload.leaves(snap)):
        assert sorted(got.shards) == sorted(want.shards) == [(0, 0), (0, 1)]
        for c in want.shards:
            assert torch.equal(got.shards[c], want.shards[c]), c
    out = eng.run()[0]
    assert out.tokens == ref.tokens and out.preemptions == 1
    for alloc in eng.allocators:
        alloc.check_conservation([])


def _priority_trace():
    """Six background requests, then a priority-2 and a priority-1 arrival
    that preempt within their slot group."""
    rng = np.random.RandomState(5)
    reqs = [t_engine.Request(uid=i, prompt=rng.randint(0, TINY["vocab_size"],
                             size=(10 + 3 * i,)).astype(np.int32), max_new_tokens=5)
            for i in range(6)]
    for uid, n, new, arrival, prio in ((9, 9, 3, 3, 2), (10, 12, 4, 5, 1)):
        reqs.append(t_engine.Request(
            uid=uid, prompt=rng.randint(0, TINY["vocab_size"], size=(n,))
            .astype(np.int32), max_new_tokens=new, arrival_step=arrival,
            priority=prio))
    return reqs


@pytest.mark.parametrize("loop", ["sync", "async"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_mesh_preemption_under_chaos_matches_one_device(built, mesh, loop):
    """Priority arrivals preempt a victim of their own slot group, its
    restore goes back to that group (an alloc denial at the first
    admission, a step failure and, where a restore falls on step 6, a
    restore failure on the way), and every stream equals
    the fault-free one-device run's; every group's pages come back."""
    per_slot = -(-(25 + 8) // STEM_SRV["block_size"])
    ecfg = lambda **kw: t_engine.EngineConfig(
        max_slots=2, num_pages=1 + 2 * per_slot, max_pages_per_slot=per_slot, **kw)
    want = _streams(t_engine.StemEngine(built[2], built[3], TStem(**STEM_SRV),
                                        ecfg()).run(_priority_trace()))
    chaos = t_chaos.ChaosInjector(t_chaos.ChaosConfig(
        deny_alloc_steps=(0,), fail_steps=(4,), fail_restore_steps=(6,)))
    eng = t_engine.StemEngine(built[2], built[3], TStem(**STEM_SRV),
                              ecfg(mesh=mesh, async_depth=int(loop == "async")),
                              chaos=chaos)
    fin = eng.run(_priority_trace())
    assert _streams(fin) == want and all(f.error is None for f in fin)
    assert eng.stats["preemptions"] == eng.stats["restores"] >= 1
    assert chaos.counts["alloc_denied"] == chaos.counts["step_failed"] == 1
    assert eng.stats["restore_failures"] == chaos.counts["restore_failed"]
    for alloc in eng.allocators:
        alloc.check_conservation([])
        assert alloc.available == eng.ecfg.num_pages - 1


def test_mesh_executor_sharding_contract(built, single):
    """tp > 1 needs an executor that declares "kv-head"; a "replicated"
    one is refused when the engine is built, and serves a dp-only mesh."""
    for name in ("fused", "gather"):
        assert t_policy.get_paged_executor(name).sharding == "kv-head"
    spec = t_policy.get_paged_executor("gather")
    t_policy.register_paged_executor(
        "replicated-probe", decode_fn=spec.decode_fn, chunk_fn=spec.chunk_fn,
        sharding="replicated", overwrite=True)
    with pytest.raises(ValueError, match="kv-head"):
        _port_run(built, mesh=(1, 2), executor="replicated-probe")
    _, fin, _ = _port_run(built, mesh=(2, 1), executor="replicated-probe")
    assert _streams(fin) == single[0]
    with pytest.raises(ValueError, match="sharding must be"):
        t_policy.register_paged_executor(
            "bad-probe", decode_fn=spec.decode_fn, chunk_fn=spec.chunk_fn,
            sharding="row", overwrite=True)


@pytest.mark.parametrize("case", ["tp3", "few-devices", "monolithic", "axis0"])
def test_mesh_rejects_bad_shapes(built, case):
    """Refused up front: tp 3 does not divide 2 KV heads, two explicit
    devices cannot hold (2, 2), the mesh runs chunked prefill only, and an
    axis below 1."""
    if case == "tp3":
        with pytest.raises(ValueError, match="num_kv_heads"):
            _port_run(built, mesh=(1, 3))
    elif case == "few-devices":
        with pytest.raises(ValueError, match=r"needs 4 devices, have 2"):
            t_engine.StemEngine(built[2], built[3], TStem(**STEM_SRV),
                                _ecfg(t_engine, mesh=(2, 2)),
                                mesh_devices=["cpu", "cpu"])
        with pytest.raises(ValueError, match="needs 4 devices"):
            t_serving.make_serving_mesh(2, 2, ["cpu"] * 3)
    elif case == "monolithic":
        with pytest.raises(ValueError, match="monolithic"):
            _ecfg(t_engine, mesh=(2, 1), monolithic_prefill=True)
    else:
        with pytest.raises(ValueError, match=">= 1"):
            _ecfg(t_engine, mesh=(0, 2))
        with pytest.raises(ValueError, match=">= 1"):
            t_serving.make_serving_mesh(1, 0)


def test_serving_mesh_helpers():
    """The grid's coordinates; the head slicing and its gather are exact
    inverses over whole head blocks; the pools are split over KV heads into
    tensors of their own; the parameters are shared on their own device."""
    smesh = t_serving.make_serving_mesh(2, 3, platform="cpu")
    assert smesh.n_devices == 6 and smesh.device(1, 2) == torch.device("cpu")
    x = torch.randn(2, 6, 3, 4)
    blocks = [t_serving.local_heads(x, t, 3) for t in range(3)]
    assert all(b.shape == (2, 2, 3, 4) and b.is_contiguous() for b in blocks)
    assert torch.equal(blocks[1], x[:, 2:4])
    assert torch.equal(t_serving.gather_heads(blocks, torch.device("cpu")), x)
    cfg = TArch(**TINY)
    shards = t_transformer.init_page_pools(cfg, 5, TStem(**STEM_SRV), device="cpu",
                                         smesh=t_serving.make_serving_mesh(
                                             2, 2, platform="cpu"))
    assert len(shards) == 2 and all(isinstance(s, t_serving.HeadShards)
                                    for s in shards)
    k00, k01 = shards[0][0][0]["sub0"].k, shards[0][1][0]["sub0"].k
    assert k00.shape == (2, 1, 5, 8, 8) and k00.data_ptr() != k01.data_ptr()
    params = {"a": torch.ones(2), "b": {"c": torch.zeros(3)}}
    reps = t_serving.replicate_params(params, smesh)
    assert list(reps) == [torch.device("cpu")]
    assert reps[torch.device("cpu")] is params


def _prefix_trace():
    """Four requests on one 24-token system prompt (three whole pages), two
    more arriving once it is registered, plus an unrelated one."""
    rng = np.random.RandomState(3)
    system = rng.randint(0, TINY["vocab_size"], size=(24,))
    reqs = []
    for i, (extra, arrival) in enumerate([(5, 0), (9, 0), (3, 0), (12, 1),
                                          (7, 6), (11, 8), (0, 9)]):
        body = rng.randint(0, TINY["vocab_size"], size=(extra,))
        prompt = np.concatenate([system, body]) if i != 6 else \
            rng.randint(0, TINY["vocab_size"], size=(14,))
        reqs.append(t_engine.Request(uid=i, prompt=prompt.astype(np.int32),
                                     max_new_tokens=4, arrival_step=arrival))
    return reqs


def test_mesh_prefix_cache_matches_cache_off(built):
    """The prefix cache under (2, 2), sync and async: each group shares its
    own registered pages (copy on write included) and the streams equal
    the cache-off single-device run's."""
    trace = [(len(r.prompt), r.max_new_tokens, r.arrival_step)
             for r in _prefix_trace()]
    mk = lambda **kw: t_engine.StemEngine(
        built[2], built[3], TStem(**STEM_SRV),
        _ecfg(t_engine, trace=trace, **kw))
    want = _streams(mk().run(_prefix_trace()))
    for async_depth in (0, 1):
        eng = mk(mesh=(2, 2), prefix_cache=True, async_depth=async_depth)
        fin = eng.run(_prefix_trace())
        assert _streams(fin) == want, async_depth
        assert eng.stats["prefix_hits"] > 0, eng.stats
        for alloc in eng.allocators:
            alloc.check_conservation([])


def test_mesh_reduced_qwen3_matches_jax(built):
    """The reduced qwen3-0.6b (4 query / 2 KV heads, head_dim 16) under
    (2, 2), sync and async, sparse (budget 0.5): the JAX single-device
    engine's streams."""
    jcfg = j_configs.reduced(j_configs.get_config("qwen3-0.6b")).replace(
        dtype="float32")
    tcfg = t_configs.reduced(t_configs.get_config("qwen3-0.6b")).replace(
        dtype="float32")
    jbundle = j_registry.build(jcfg)
    jparams = jbundle.init_params(jax.random.PRNGKey(1))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    stem = dict(block_size=16, stride=4, sink_blocks=1, local_blocks=1,
                min_budget_blocks=2)
    trace = [(100, 6, 0), (250, 6, 0), (170, 5, 1), (60, 5, 3), (130, 4, 4)]
    kw = dict(trace=trace, bs=16, budget_frac=0.5)
    want = _streams(j_engine.StemEngine(
        jbundle, jparams, JStem(**stem), _ecfg(j_engine, **kw)).run(
        _reqs(j_engine, trace, vocab=jcfg.vocab_size)))
    for async_depth in (0, 1):
        eng = t_engine.StemEngine(t_registry.build(tcfg), tparams, TStem(**stem),
                                  _ecfg(t_engine, mesh=(2, 2),
                                        async_depth=async_depth, **kw))
        fin = eng.run(_reqs(t_engine, trace, vocab=tcfg.vocab_size))
        assert _streams(fin) == want, async_depth
        for alloc in eng.allocators:
            alloc.check_conservation([])


def test_serve_main_mesh_on_cpu(capsys):
    """``--device cpu --mesh 2,2``: the result line reports the mesh and no
    request fails; the streams equal the one-device run's."""
    argv = ["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
            "--requests", "3", "--decode-tokens", "6", "--max-slots", "2",
            "--stem"]
    out = t_serve.main(argv + ["--mesh", "2,2"])
    assert out["mesh"] == [2, 2] and out["failed"] == {}
    assert "mesh (2, 2)" in capsys.readouterr().out
    assert out["tokens"] == t_serve.main(argv)["tokens"]
