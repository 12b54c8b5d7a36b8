"""The port's AdamW (``repro_torch/optim``) and synthetic data
(``repro_torch/data``) against the JAX reference on the CPU.

* the warmup-cosine schedule at every step of two schedules, and the
  global norm, equal to the reference's in fp32 (both compute in fp32
  tensors; tolerance 4 fp32 ulps of the value: XLA's and PyTorch's fp32
  cos differ by up to 2 ulps, times the peak rate's rounding);
* ``update`` over three steps on a numpy-seeded tree (a matrix, a vector
  and a scalar leaf) under every (grad_dtype, moment_dtype) pair and a
  clip-active gradient scale: master, mu and nu within 1e-6 of each leaf's
  max|value| in fp32 moments (the two frameworks' pow / sqrt may differ in
  the last ulp), and within 1 bf16 ulp of the leaf's max in bf16 moments
  (a last-ulp difference can round a stored moment the other way);
* the reference substrate tests' optimizer checks, on the port
  (convergence on a quadratic, clipping, bf16 moments converge);
* ``SyntheticLMData`` batches bitwise equal to the reference's for the
  ``lm``, ``vlm`` and ``encdec`` kinds at several steps, seekable.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import optim as j_optim
from repro.data import SyntheticLMData as JData

from repro_torch import optim as t_optim
from repro_torch.data import SyntheticLMData as TData
from repro_torch.data import make_global_batch

torch.set_num_threads(1)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((8, 5)) * scale).astype(np.float32),
            "blk": {"b": (rng.standard_normal((5,)) * scale).astype(np.float32),
                    "s": np.asarray(rng.standard_normal(()) * scale, dtype=np.float32)}}


def _t(tree):
    return t_optim.adamw.tree_map(torch.from_numpy, tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in tree for x in _flat(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def _get(tree, path):
    for k in path.strip("/").split("/"):
        tree = tree[k]
    return tree


@pytest.mark.parametrize("warmup,decay", [(10, 100), (2, 10)])
def test_lr_schedule_matches_reference(warmup, decay):
    kw = dict(peak_lr=3e-4, warmup_steps=warmup, decay_steps=decay)
    jc, tc = j_optim.AdamWConfig(**kw), t_optim.AdamWConfig(**kw)
    for step in range(0, decay + 5):
        want = np.float32(j_optim.lr_at(jnp.asarray(step, jnp.int32), jc))
        got = t_optim.lr_at(torch.tensor(step, dtype=torch.int32), tc)
        assert got.dtype == torch.float32
        assert abs(float(got) - float(want)) <= 4 * np.spacing(want), step


def test_global_norm_matches_reference():
    tree = _tree(3, scale=7.0)
    want = float(j_optim.adamw.global_norm(_j(tree)))
    got = t_optim.adamw.global_norm(_t(tree))
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 2 * np.spacing(np.float32(want))


@pytest.mark.parametrize("grad_dtype,moment_dtype,gscale", [
    (None, "float32", 1.0), ("bfloat16", "float32", 1.0),
    ("bfloat16", "bfloat16", 1.0), (None, "float32", 50.0)])
def test_update_matches_reference(grad_dtype, moment_dtype, gscale):
    kw = dict(peak_lr=1e-2, warmup_steps=2, decay_steps=10, grad_dtype=grad_dtype,
              moment_dtype=moment_dtype)
    jc, tc = j_optim.AdamWConfig(**kw), t_optim.AdamWConfig(**kw)
    params = _tree(0)
    js = j_optim.init_state(_j(params), jc)
    ts = t_optim.init_state(_t(params), tc)
    assert ts.step.dtype == torch.int32 and int(ts.step) == 0
    for step in range(3):
        g = _tree(10 + step, scale=gscale)
        js, jm = j_optim.update(j_optim.adamw.compress_grads(_j(g), jc), js, jc)
        ts, tm = t_optim.update(t_optim.adamw.compress_grads(_t(g), tc), ts, tc)
        for k in ("lr", "grad_norm"):
            assert abs(float(tm[k]) - float(jm[k])) <= 2 * np.spacing(np.float32(jm[k]))
    assert int(ts.step) == int(js.step) == 3
    for name in ("master", "mu", "nu"):
        for path, got in _flat(getattr(ts, name)):
            want = np.asarray(_get(getattr(js, name), path)).astype(np.float32)
            assert str(got.dtype).split(".")[-1] == str(_get(getattr(js, name), path).dtype)
            scale = max(float(np.abs(want).max()), 1e-30)
            tol = (2.0 ** -8 if (moment_dtype == "bfloat16" and name != "master")
                   else 1e-6) * scale
            np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol,
                                       err_msg=f"{name}{path}")


def test_cast_params_and_compress():
    tc = t_optim.AdamWConfig()
    params = _t(_tree(1))
    like = t_optim.adamw.tree_map(lambda p: p.to(torch.bfloat16), params)
    st = t_optim.init_state(like, tc)
    assert all(m.dtype == torch.float32 for m in t_optim.adamw.tree_leaves(st.master))
    cast = t_optim.cast_params(st, like)
    assert all(c.dtype == torch.bfloat16 for c in t_optim.adamw.tree_leaves(cast))
    g = t_optim.adamw.compress_grads(params, tc)
    want = j_optim.adamw.compress_grads(_j(_tree(1)), j_optim.AdamWConfig())
    for path, got in _flat(g):
        w = np.asarray(_get(want, path))
        assert got.dtype == torch.bfloat16
        # round to nearest even in both: the same bits
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      w.view(np.int16))


def test_adamw_decreases_quadratic():
    cfg = t_optim.AdamWConfig(peak_lr=0.1, warmup_steps=1, decay_steps=100,
                              weight_decay=0.0, grad_dtype=None)
    state = t_optim.init_state({"w": torch.tensor([2.0, -3.0, 1.0])}, cfg)
    for _ in range(200):
        state, _ = t_optim.update({"w": 2 * state.master["w"]}, state, cfg)
    assert float((state.master["w"] ** 2).sum()) < 1e-2


def test_adamw_clipping_and_schedule():
    cfg = t_optim.AdamWConfig(peak_lr=1.0, warmup_steps=10, decay_steps=100,
                              clip_norm=1.0)
    assert float(t_optim.lr_at(torch.tensor(0), cfg)) == 0.0
    assert abs(float(t_optim.lr_at(torch.tensor(10), cfg)) - 1.0) < 1e-6
    assert float(t_optim.lr_at(torch.tensor(100), cfg)) <= cfg.min_lr_ratio + 1e-6
    state = t_optim.init_state({"w": torch.ones(4)}, cfg)
    before = state.master["w"].clone()          # the update is in place
    state2, metrics = t_optim.update({"w": torch.full((4,), 100.0)}, state, cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0, rel=1e-3)
    assert 0.0 < float((state2.master["w"] - before).abs().max()) < 1.0


def test_bf16_moments_still_converge():
    cfg = t_optim.AdamWConfig(peak_lr=0.1, warmup_steps=1, decay_steps=100,
                              weight_decay=0.0, moment_dtype="bfloat16")
    state = t_optim.init_state({"w": torch.tensor([5.0])}, cfg)
    assert state.mu["w"].dtype == torch.bfloat16
    for _ in range(100):
        state, _ = t_optim.update({"w": 2 * state.master["w"]}, state, cfg)
    assert abs(float(state.master["w"][0])) < 0.2


@pytest.mark.parametrize("kind", ["lm", "vlm", "encdec"])
def test_data_bitwise_reference(kind):
    kw = dict(vocab_size=1000, seq_len=96, global_batch=3, seed=5, kind=kind,
              d_model=16, frames=7 if kind == "encdec" else 0)
    jd, td = JData(**kw), TData(**kw)
    for step in (0, 1, 17, 123456):
        want, got = jd.batch_at(step), td.batch_at(step)
        assert sorted(want) == sorted(got)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    # seekable: a batch is a pure function of (seed, step)
    np.testing.assert_array_equal(td.batch_at(17)["tokens"], td.batch_at(17)["tokens"])
    assert not np.array_equal(td.batch_at(17)["tokens"], td.batch_at(18)["tokens"])
    dev = make_global_batch(td.batch_at(0), "cpu")
    for k, v in td.batch_at(0).items():
        np.testing.assert_array_equal(dev[k].numpy(), v)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_in_place_update_is_the_pure_update(monkeypatch, moment_dtype):
    """The update, in place and in slices (here of 64 elements), gives the
    bits of the same update in one slice (the pure arithmetic over whole
    leaves) for master, mu and nu over three steps, leaves them in the
    tensors of the state it was given, and raises on a leaf that is not
    contiguous rather than updating a copy of it."""
    import repro_torch.optim.adamw as t_adamw
    cfg = t_optim.AdamWConfig(peak_lr=1e-2, warmup_steps=1, decay_steps=10,
                              moment_dtype=moment_dtype)
    gen = torch.Generator().manual_seed(4)
    params = {"a": torch.randn(1000, generator=gen), "b": torch.randn(37, 11, generator=gen)}
    whole, sliced = t_optim.init_state(params, cfg), t_optim.init_state(params, cfg)
    for _ in range(3):
        grads = {k: torch.randn(v.shape, generator=gen).bfloat16() for k, v in params.items()}
        whole, _ = t_optim.update(grads, whole, cfg)
        given = sliced
        monkeypatch.setattr(t_adamw, "_CHUNK", 64)
        sliced, _ = t_optim.update(grads, sliced, cfg)
        monkeypatch.undo()
        for name in ("master", "mu", "nu"):
            for k in params:
                assert torch.equal(getattr(sliced, name)[k], getattr(whole, name)[k])
                assert getattr(sliced, name)[k] is getattr(given, name)[k]
    strided = t_optim.init_state({"w": torch.ones(6, 4)}, cfg)
    strided = strided._replace(master={"w": strided.master["w"].t()})
    with pytest.raises(RuntimeError, match="view"):
        t_optim.update({"w": torch.ones(4, 6)}, strided, cfg)
