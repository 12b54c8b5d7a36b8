"""The port's checkpoint manager, restart harness and training CLI on the
CPU.

* ``CheckpointManager``: round trip with keep-K garbage collection, async
  save and atomicity (a stale ``.tmp`` directory is no checkpoint), shape
  mismatch on restore, restore into a template built on the ``meta``
  device — the reference substrate tests' checks, on the port; an async
  save restores the step it names while the in-place train step goes on;
* checkpoints cross the two packages both ways: an AdamW state of the
  reduced qwen3-0.6b (moments in bf16, stored as uint16 views) saved by the
  reference's ``CheckpointManager`` restores bitwise in the port, and the
  port's save restores bitwise in the reference;
* the port's counterparts of the reference's three training tests (which
  fail on the reference under this JAX version: its mesh path raises in the
  embedding gather), through ``python -m repro_torch.launch.train`` on the
  CPU: the loss falls over 12 steps; 10 uninterrupted steps against 8
  steps, a checkpoint, ``--restore`` and 2 more steps are bitwise equal;
  ``run_with_restarts`` around an injected failure at step 6 resumes from
  the step-4 checkpoint;
* the CLI refuses ``--prod-flags`` and ``JAX_COORDINATOR_ADDRESS``, and the
  train step refuses ``grad_shardings``.
"""
import os
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as j_configs
from repro import optim as j_optim
from repro.checkpoint import CheckpointManager as JManager
from repro.launch import steps as j_steps
from repro.models import registry as j_registry

from repro_torch import configs as t_configs
from repro_torch import optim as t_optim
from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch import steps as t_steps
from repro_torch.launch import train as t_train
from repro_torch.models import registry as t_registry
from repro_torch.optim.adamw import tree_map
from repro_torch.runtime.fault_tolerance import (FailureInjector, InjectedFailure,
                                                 run_with_restarts)

torch.set_num_threads(1)


def test_checkpoint_roundtrip_and_keep(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16)}}
    for step in (1, 2, 3):
        mgr.save(step, tree_map(lambda t: t * step, tree), extra={"s": step})
    assert mgr.steps() == [2, 3]   # keep-K GC
    target = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), tree)
    restored, meta = mgr.restore(target, device="cpu")
    assert meta["step"] == 3 and meta["extra"] == {"s": 3}
    torch.testing.assert_close(restored["a"], tree["a"] * 3, rtol=0, atol=0)
    assert restored["b"]["c"].dtype == torch.bfloat16
    torch.testing.assert_close(restored["b"]["c"], tree["b"]["c"] * 3, rtol=0, atol=0)


def test_checkpoint_async_and_atomic(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mgr.save(1, {"w": torch.zeros(1000, 100)}, blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 1
    os.makedirs(tmp_path / "step_9.tmp", exist_ok=True)
    assert mgr.latest_step() == 1


def test_async_save_holds_its_step_while_training_goes_on(tmp_path, monkeypatch):
    """An async save of step 1's state, whose write is held back until the
    in-place train step 2 has run, restores step 1's master, mu and nu
    bitwise: the save's host copy is a copy on the CPU too."""
    from repro_torch.data import SyntheticLMData, make_global_batch
    cfg = t_configs.reduced(t_configs.get_config("qwen3-0.6b"))
    bundle = t_registry.build(cfg)
    opt_cfg = t_optim.AdamWConfig(peak_lr=1e-2, warmup_steps=1, decay_steps=10)
    step = t_steps.make_train_step(bundle, opt_cfg)
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2, seed=3)
    state = t_optim.init_state(
        bundle.init_params(torch.Generator().manual_seed(3), device="cpu"), opt_cfg)
    state, _ = step(state, make_global_batch(data.batch_at(0), "cpu"))
    want = t_optim.OptState(*(tree_map(torch.clone, f) for f in state))

    released = threading.Event()
    savez = np.savez
    monkeypatch.setattr(np, "savez", lambda *a, **kw: released.wait(60) and savez(*a, **kw))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state, blocking=False)
    state, _ = step(state, make_global_batch(data.batch_at(1), "cpu"))
    released.set()
    mgr.wait()
    assert mgr.latest_step() == 1
    template = t_optim.OptState(*(tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), f) for f in want))
    got, _ = mgr.restore(template, device="cpu")
    for name in ("master", "mu", "nu"):
        for a, b in zip(t_optim.adamw.tree_leaves(getattr(got, name)),
                        t_optim.adamw.tree_leaves(getattr(want, name))):
            assert torch.equal(a, b), name
    assert not torch.equal(t_optim.adamw.tree_leaves(state.master)[0],
                           t_optim.adamw.tree_leaves(want.master)[0])


def test_checkpoint_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.zeros(4)})
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore({"w": torch.empty(5, device="meta")})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore({"w": torch.empty(4)})


def _states(moment_dtype="bfloat16"):
    """The reduced qwen3-0.6b's AdamW state after one update, in both
    packages from the same numpy-seeded parameters and gradients."""
    jcfg = j_configs.reduced(j_configs.get_config("qwen3-0.6b")).replace(dtype="float32")
    tcfg = t_configs.reduced(t_configs.get_config("qwen3-0.6b")).replace(dtype="float32")
    abstract, _ = j_registry.build(jcfg).abstract_params()
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), abstract)
    grads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), abstract)
    oc = dict(moment_dtype=moment_dtype)
    js = j_optim.init_state(jax.tree.map(jnp.asarray, params), j_optim.AdamWConfig(**oc))
    js, _ = jax.jit(j_optim.update, static_argnums=2)(
        jax.tree.map(jnp.asarray, grads), js, j_optim.AdamWConfig(**oc))
    template = t_optim.init_state(
        t_registry.build(tcfg).init_params(torch.Generator(), device="meta"),
        t_optim.AdamWConfig(**oc))
    return js, template, abstract


def _flat_j(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _flat_j(tree[k], f"{prefix}/{k}").items()}
    return {prefix: np.asarray(tree)}


def _flat_t(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _flat_t(tree[k], f"{prefix}/{k}").items()}
    return {prefix: tree}


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


def _bits_t(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 \
        else t.numpy()


def test_reference_checkpoint_restores_in_port(tmp_path):
    js, template, _ = _states()
    JManager(str(tmp_path)).save(1, js, extra={"from": "jax"})
    state, meta = CheckpointManager(str(tmp_path)).restore(template, device="cpu")
    assert isinstance(state, t_optim.OptState) and meta["extra"] == {"from": "jax"}
    assert int(state.step) == 1 and state.step.dtype == torch.int32
    for name in ("master", "mu", "nu"):
        want = _flat_j(getattr(js, name))
        got = _flat_t(getattr(state, name))
        assert sorted(got) == sorted(want)
        for path, t in got.items():
            np.testing.assert_array_equal(_bits_t(t), _bits(want[path]),
                                          err_msg=f"{name}{path}")


def test_port_checkpoint_restores_in_reference(tmp_path):
    _, template, abstract = _states()
    gen = torch.Generator().manual_seed(1)
    state = t_optim.OptState(
        step=torch.tensor(7, dtype=torch.int32),
        **{name: tree_map(lambda t: torch.randn(t.shape, generator=gen).to(t.dtype),
                          getattr(template, name)) for name in ("master", "mu", "nu")})
    CheckpointManager(str(tmp_path)).save(7, state, extra={"from": "port"})
    target = j_steps.abstract_opt_state(abstract, j_optim.AdamWConfig(moment_dtype="bfloat16"))
    restored, meta = JManager(str(tmp_path)).restore(target)
    restored = j_optim.OptState(*restored)
    assert meta["step"] == 7 and meta["extra"] == {"from": "port"}
    assert int(restored.step) == 7
    for name in ("master", "mu", "nu"):
        want = _flat_j(getattr(restored, name))
        for path, t in _flat_t(getattr(state, name)).items():
            assert str(want[path].dtype) == str(t.dtype).split(".")[-1]
            np.testing.assert_array_equal(_bits_t(t), _bits(want[path]),
                                          err_msg=f"{name}{path}")


# ---------------------------------------------------------------------------
# the training CLI (the reference's three failing training tests, on the port)
# ---------------------------------------------------------------------------

def _run(argv):
    return t_train.main(["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
                         "--batch", "4", "--seq", "64", "--lr", "1e-2"] + argv)


def test_train_smoke_and_loss_decreases(tmp_path):
    out = _run(["--steps", "12", "--checkpoint-dir", str(tmp_path / "ckpt"),
                "--checkpoint-every", "4"])
    losses = out["losses"]
    assert len(losses) == 12
    assert all(np.isfinite(l) for l in losses)
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
    assert CheckpointManager(str(tmp_path / "ckpt")).steps() == [4, 8, 12]


def test_restart_is_bit_identical(tmp_path):
    """Uninterrupted run == (run to step 8, checkpoint, restore at 8,
    continue): bitwise, as the seekable data and the atomic checkpoint
    replay nothing and the step is deterministic."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    ref = _run(["--steps", "10", "--checkpoint-dir", a, "--checkpoint-every", "100"])
    _run(["--steps", "8", "--checkpoint-dir", b, "--checkpoint-every", "8"])
    second = _run(["--steps", "10", "--checkpoint-dir", b, "--restore",
                   "--checkpoint-every", "100"])
    assert ref["losses"][8:] == second["losses"]


def test_injected_failure_with_restart_harness(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    calls = []

    def attempt():
        calls.append(1)
        restore = ["--restore"] if len(calls) > 1 else []
        return _run(["--steps", "10", "--checkpoint-dir", ckpt,
                     "--checkpoint-every", "4",
                     "--fail-at", "6" if len(calls) == 1 else "-1"] + restore)

    out = run_with_restarts(attempt, max_restarts=2)
    assert len(calls) == 2
    # the restart resumed from step 4's checkpoint: 6 more steps (4..9)
    assert len(out["losses"]) == 6


def test_restart_harness_gives_up():
    inj = FailureInjector((0,), repeats=5)
    seen = []
    with pytest.raises(InjectedFailure):
        run_with_restarts(lambda: inj.maybe_fail(0), max_restarts=2,
                          on_restart=lambda n, e: seen.append(n))
    assert seen == [1, 2]


def test_cli_refusals(monkeypatch):
    with pytest.raises(SystemExit, match="prod-flags"):
        _run(["--steps", "1", "--prod-flags"])
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:1234")
    with pytest.raises(SystemExit, match="JAX_COORDINATOR_ADDRESS"):
        _run(["--steps", "1"])
    cfg = t_configs.reduced(t_configs.get_config("qwen3-0.6b"))
    with pytest.raises(ValueError, match="grad_shardings"):
        t_steps.make_train_step(t_registry.build(cfg), t_optim.AdamWConfig(),
                                grad_shardings={})
