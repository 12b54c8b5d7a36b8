"""The port's examples (``examples/*_torch.py``) against the reference's:
quickstart's and long-context prefill's ``run`` on the CPU against the
reference API on the same numpy-seeded arrays (budgets and density exactly
equal, errors within 1e-5), their ``StemConfig`` keywords equal to the
reference examples' literal ones, serve_stem's and train_lm's argv and
config equal to the reference examples' apart from ``--device``, and every
example refusing to run without a card when asked for one."""
import ast
import dataclasses
import importlib.util
import os
import pathlib
import sys
import tempfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import configs as j_configs
from repro.core import StemConfig as JStem
from repro.core import average_budget, dense_attention, schedule_for, stem_attention
from repro.launch import serve as j_serve
from repro.launch import train as j_train

from repro_torch import configs as t_configs
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train

torch.set_num_threads(2)
EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stem_kwargs(name: str) -> dict:
    """The literal keywords of the file's one ``StemConfig(...)`` call."""
    tree = ast.parse((EXAMPLES / f"{name}.py").read_text())
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == "StemConfig"]
    assert len(calls) == 1, name
    return {kw.arg: ast.literal_eval(kw.value) for kw in calls[0].keywords
            if kw.arg is not None}


@pytest.mark.parametrize("name", ["quickstart", "longcontext_prefill"])
def test_stem_config_matches_reference_example(name):
    """The port example's ``STEM_KWARGS`` are the reference example's
    literal ``StemConfig`` keywords, and its one ``StemConfig`` call takes
    them."""
    port = _load(f"{name}_torch")
    assert port.STEM_KWARGS == _stem_kwargs(name)
    tree = ast.parse((EXAMPLES / f"{name}_torch.py").read_text())
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == "StemConfig"]
    assert [ast.unparse(c) for c in calls] == ["StemConfig(**STEM_KWARGS)"]


def _inputs(seed, b, hq, hk, n, d, heavy=False):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, hq, n, d).astype(np.float32)
    k, v = (rng.randn(b, hk, n, d).astype(np.float32) for _ in range(2))
    if heavy:
        v[:, :, 100:110] *= 10.0
    return q, k, v


def _reference(q, k, v, cfg):
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    out, stats = stem_attention(jq, jk, jv, cfg, return_stats=True)
    err = np.abs(np.asarray(out) - np.asarray(dense_attention(jq, jk, jv)))
    return np.asarray(out), schedule_for(cfg, q.shape[2]), float(stats.density), err


def test_quickstart_run_matches_reference():
    """quickstart's ``run`` at 2048 tokens (16 blocks, sparse at the
    example's k_start 0.25 and floor 4) against the reference API."""
    port = _load("quickstart_torch")
    q, k, v = _inputs(0, 2, 8, 4, 2048, 64)
    res = port.run(*(torch.from_numpy(x) for x in (q, k, v)),
                   port.StemConfig(**port.STEM_KWARGS))
    out, budgets, density, err = _reference(q, k, v, JStem(**port.STEM_KWARGS))
    assert res["budgets"].dtype == budgets.dtype
    np.testing.assert_array_equal(res["budgets"], budgets)
    assert res["density"] == density < 1.0
    assert abs(res["max_err"] - float(err.max())) <= 1e-5
    assert abs(res["mean_err"] - float(err.mean())) <= 1e-5
    np.testing.assert_allclose(res["out"].numpy(), out, atol=1e-4, rtol=0)


def test_longcontext_run_matches_reference():
    """long-context prefill's ``run`` at 4096 tokens (the paper's defaults,
    heavy-hitter values 100-109) against the reference API: budgets,
    average budget, density and each row's mean error."""
    port = _load("longcontext_prefill_torch")
    q, k, v = _inputs(1, 1, 4, 2, 4096, 64, heavy=True)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    res = port.run(*t, port.StemConfig(**port.STEM_KWARGS))
    _, budgets, density, err = _reference(q, k, v, JStem(**port.STEM_KWARGS))
    np.testing.assert_array_equal(res["budgets"], budgets)
    assert average_budget(budgets) == port.average_budget(res["budgets"])
    assert res["density"] == density
    np.testing.assert_allclose(res["row_err"], err.mean(axis=(0, 1, 3)), atol=1e-5, rtol=0)
    # make_inputs scales values 100-109 of its v draw by 10, nothing else
    _, _, hv = port.make_inputs(1, "cpu", seq=256)
    gen = torch.Generator().manual_seed(1)
    raw = [torch.randn(s, generator=gen) for s in
           ((1, 4, 256, 64), (1, 2, 256, 64), (1, 2, 256, 64))][2]
    raw[:, :, 100:110] *= 10.0
    assert torch.equal(hv, raw)


def _serve_stub(calls):
    def main(argv):
        calls.append(list(argv))
        return {"throughput_tok_s": 1.0, "p50_ms": 1.0, "p95_ms": 1.0,
                "engine_stats": {"traces": 1, "prefill_traces": 1}}
    return main


def test_serve_stem_argv_matches_reference(monkeypatch):
    """The four arms' argv: the reference example's, each with ``--device``
    appended."""
    ref_calls, port_calls = [], []
    monkeypatch.setattr(j_serve, "main", _serve_stub(ref_calls))
    monkeypatch.setattr(t_serve, "main", _serve_stub(port_calls))
    _load("serve_stem").main()
    out = _load("serve_stem_torch").main(["--device", "cpu"])
    assert len(ref_calls) == len(port_calls) == 4
    assert port_calls == [c + ["--device", "cpu"] for c in ref_calls]
    assert list(out) == ["dense", "stem", "streaming", "monolithic"]


@pytest.mark.parametrize("losses,code,ckpt", [([3.0, 2.5], None, "CKPT"),
                                              ([2.5, 2.5], 1, "CKPT"),
                                              ([3.0, 2.5], None, None)],
                         ids=["falls", "flat", "default-dir"])
def test_train_lm_argv_and_config_match_reference(monkeypatch, losses, code, ckpt):
    """The train argv is the reference example's plus ``--device``, the
    registered ``qwen3-100m`` equals the reference's field for field, and
    both exit 1 when the loss does not fall.  Without ``--checkpoint-dir``
    the port writes under its own name in the temporary directory, where
    the reference writes ``/tmp/repro_train_lm``."""
    calls = {}

    def stub(key, pkg):
        def main(argv):
            calls[key] = (list(argv), pkg.ALL["qwen3-100m"])
            return {"losses": list(losses)}
        return main
    for pkg in (j_configs, t_configs):     # restored after the test
        monkeypatch.setitem(pkg.ALL, "qwen3-100m", None)
    monkeypatch.setattr(j_train, "main", stub("ref", j_configs))
    monkeypatch.setattr(t_train, "main", stub("port", t_configs))
    given = ["--checkpoint-dir", ckpt] if ckpt else []
    monkeypatch.setattr(sys, "argv", ["train_lm.py", "--steps", "7", *given])
    for run in (lambda: _load("train_lm").main(),
                lambda: _load("train_lm_torch").main(
                    ["--steps", "7", *given, "--device", "cpu"])):
        if code is None:
            run()
        else:
            with pytest.raises(SystemExit) as exc:
                run()
            assert exc.value.code == code
    (ref_argv, ref_cfg), (port_argv, port_cfg) = calls["ref"], calls["port"]
    if ckpt is None:
        at = ref_argv.index("--checkpoint-dir") + 1
        assert ref_argv[at] == "/tmp/repro_train_lm"
        ref_argv[at] = os.path.join(tempfile.gettempdir(), "repro_torch_train_lm")
    assert port_argv == ref_argv + ["--device", "cpu"]
    for f in dataclasses.fields(ref_cfg):
        assert getattr(port_cfg, f.name) == getattr(ref_cfg, f.name), f.name


@pytest.mark.parametrize("name", ["quickstart_torch", "longcontext_prefill_torch",
                                  "serve_stem_torch", "train_lm_torch"])
def test_example_without_a_card_exits(monkeypatch, name):
    """Asked for the card (the default) where none is visible, each example
    exits before it draws or builds anything; it never carries on on the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setitem(t_configs.ALL, "qwen3-100m", None)   # restored after the test
    ran = []
    monkeypatch.setattr(t_serve, "main", lambda argv: ran.append(argv))
    built = []
    monkeypatch.setattr(t_configs, "get_config", lambda name: built.append(name))
    with pytest.raises(SystemExit) as exc:
        _load(name).main([])
    assert "no CUDA device" in str(exc.value.code) and not ran and not built
