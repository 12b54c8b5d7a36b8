"""The port's serving CLI (``repro_torch.launch.serve``) and its
differential oracle.

* The reference's own differential, ported: the paged engine's greedy
  streams equal contiguous prefill + policy-sparse decode
  (``make_serve_step`` re-summarizing the whole cache) for every policy
  family, at decode ``budget_frac=1.0`` with prompts padded to a page
  multiple (``tests/test_engine.py``'s config and trace).
* The CLI's engine mode (chunked and ``--monolithic``; priorities,
  shedding, admission control, FCFS and the chaos plan) and
  ``--fixed-batch`` against the reference CLI's ``run_engine`` /
  ``run_fixed_batch`` with the same arguments and carried weights: equal
  tokens and errors, and equal engine step / chunk / decode-step and
  preemption / restore / shed / chaos counts.
* ``main`` end to end on the reduced qwen3-0.6b on the CPU, and every flag
  whose feature the port lacks raises ``SystemExit``."""
import numpy as np
import pytest
import torch

import jax

from repro import configs as j_configs
from repro.core import policy as j_policy
from repro.core.config import StemConfig as JStem
from repro.launch import serve as j_serve
from repro.models import registry as j_registry

from repro_torch import configs as t_configs
from repro_torch.configs.base import ArchConfig as TArch
from repro_torch.core import policy as t_policy
from repro_torch.core.config import StemConfig as TStem
from repro_torch.launch import serve as t_serve
from repro_torch.launch import steps as t_steps
from repro_torch.models import registry as t_registry
from repro_torch.runtime import engine as t_engine
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)

TINY = dict(name="engine-tiny", family="dense", num_layers=2, d_model=32,
            num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64, vocab_size=64,
            qk_norm=True, dtype="float32")
TRACE = [(5, 4, 0), (13, 6, 0), (8, 3, 1), (20, 5, 3), (9, 4, 5)]
CROSS_POLICIES = ["stem", "stem-sam", "uniform-sam", "streaming", "dense"]


@pytest.fixture(scope="module")
def tiny():
    cfg = TArch(**TINY)
    bundle = t_registry.build(cfg)
    return bundle, bundle.init_params(torch.Generator().manual_seed(0), device="cpu")


def _fixed_batch_tokens(bundle, params, pol, prompt, mnt):
    """Reference arm: one-shot contiguous-cache prefill of the prompt
    padded to a page multiple (TPD budgets are evaluated at the padded
    length, as in the engine), then policy-sparse decode at budget 1.0
    re-summarizing the whole cache every step.  Greedy stream."""
    plen = len(prompt)
    bs = pol.block_size
    max_len = -(-(plen + mnt) // bs) * bs
    lp = -(-plen // bs) * bs
    toks = np.zeros((1, lp), np.int32)
    toks[0, :plen] = prompt
    serve = t_steps.make_serve_step(bundle, stem_cfg=pol, budget_frac=1.0)
    logits, caches = bundle.prefill(params, {"tokens": torch.from_numpy(toks)},
                                    max_len=max_len, stem_cfg=pol,
                                    last_pos=torch.tensor([plen - 1]))
    tok = torch.argmax(logits, dim=-1)[:, None]
    out = [int(tok[0, 0])]
    for i in range(mnt - 1):
        logits, caches = serve(params, tok, caches,
                               torch.tensor([plen]) if i == 0 else None)
        tok = torch.argmax(logits, dim=-1)[:, None]
        out.append(int(tok[0, 0]))
    return out


@pytest.mark.parametrize("policy_name", CROSS_POLICIES)
def test_engine_matches_fixed_batch(tiny, policy_name):
    bundle, params = tiny
    pol = t_policy.get_policy(policy_name).with_updates(
        block_size=8, stride=4, sink_blocks=1, local_blocks=1,
        min_budget_blocks=2, ignore_missing=True)
    rng = np.random.RandomState(7)
    reqs = [t_engine.Request(uid=uid, prompt=rng.randint(0, 64, size=(plen,)).astype(
                np.int32), max_new_tokens=mnt, arrival_step=arr)
            for uid, (plen, mnt, arr) in enumerate(TRACE[:3])]
    per_slot = -(-max(p + n for p, n, _ in TRACE) // 8)
    ecfg = t_engine.EngineConfig(max_slots=2, num_pages=1 + 2 * per_slot,
                                 max_pages_per_slot=per_slot, budget_frac=1.0)
    finished = t_engine.StemEngine(bundle, params, pol, ecfg).run(reqs)
    assert [f.uid for f in finished] == [0, 1, 2]
    for req, fin in zip(reqs, finished):
        ref = _fixed_batch_tokens(bundle, params, pol, req.prompt, req.max_new_tokens)
        assert fin.tokens == ref, f"{policy_name}: request {req.uid} diverged"


# ---------------------------------------------------------------------------
# The CLI against the reference CLI
# ---------------------------------------------------------------------------

BASE = ["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu", "--requests", "3",
        "--min-prompt", "20", "--max-prompt", "70", "--decode-tokens", "5",
        "--max-slots", "2"]


@pytest.fixture(scope="module")
def carried():
    jcfg = j_configs.reduced(j_configs.get_config("qwen3-0.6b")).replace(dtype="float32")
    tcfg = t_configs.reduced(t_configs.get_config("qwen3-0.6b")).replace(dtype="float32")
    jb, tb = j_registry.build(jcfg), t_registry.build(tcfg)
    jparams = jb.init_params(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, jb, jparams, tcfg, tb, tparams


def _serving_policies(args):
    """Both packages' policy as ``main`` builds it from the flags."""
    bs = max(16, min(128, args.max_prompt // 8))
    bs = -(-bs // 8) * 8
    if args.policy:
        kw = dict(block_size=bs, stride=4, sink_blocks=1, local_blocks=1,
                  min_budget_blocks=2, ignore_missing=True)
        return (j_policy.get_policy(args.policy).with_updates(**kw),
                t_policy.get_policy(args.policy).with_updates(**kw), True)
    kw = dict(block_size=bs, min_budget_blocks=2, sink_blocks=1, local_blocks=1,
              stride=4)
    return JStem(**kw), TStem(**kw), args.stem


@pytest.mark.parametrize("mode,flags", [
    ("chunked", ["--policy", "stem"]),
    ("monolithic", ["--policy", "stem", "--monolithic"]),
    ("chunked-dense", []),
    ("fixed-batch", ["--policy", "stem", "--fixed-batch"]),
    ("fixed-batch-dense", ["--fixed-batch"]),
    ("chaos", ["--policy", "stem", "--chaos"]),
    ("hp-every", ["--policy", "stem", "--hp-every", "2"]),
    ("max-waiting", ["--policy", "stem", "--max-waiting", "4"]),
    # request 1 (priority 1) arrives at step 2 with a TTFT SLO no step
    # time can meet: both CLIs reject it
    ("admission-control", ["--policy", "stem", "--admission-control",
                           "--hp-every", "2", "--hp-ttft-slo-ms", "0.001"]),
    ("fcfs", ["--policy", "stem", "--scheduler", "fcfs"]),
    # one slot, arrivals every step: a preemption and its restore, three
    # requests shed, an alloc denial and a step failure
    ("overload", ["--policy", "stem", "--requests", "4", "--max-slots", "1",
                  "--arrival-every", "1", "--hp-every", "3", "--max-waiting", "2",
                  "--chaos"]),
])
def test_cli_matches_reference(carried, capsys, mode, flags):
    jcfg, jb, jparams, tcfg, tb, tparams = carried
    args = t_serve.build_parser().parse_args(BASE + flags)
    jpol, tpol, sparse = _serving_policies(args)
    frac = args.budget_frac if sparse else 1.0
    if args.fixed_batch:
        want = j_serve.run_fixed_batch(args, jcfg, jb, jparams,
                                       jpol if sparse else None, frac)
        got = t_serve.run_fixed_batch(args, tcfg, tb, tparams,
                                      tpol if sparse else None, frac)
        assert got["prompt_lens"] == want["prompt_lens"]
    else:
        want = j_serve.run_engine(args, jcfg, jb, jparams, jpol, frac)
        got = t_serve.run_engine(args, tcfg, tb, tparams, tpol, frac)
        for key in ("step_calls", "chunks", "decode_steps", "prefills",
                    "tokens_generated", "slots_reused", "max_concurrency",
                    "preemptions", "restores", "restore_failures", "shed",
                    "aborts", "step_failures", "alloc_denials",
                    "admission_rejects", "restore_bytes"):
            assert got["engine_stats"][key] == want["engine_stats"][key], key
        assert got["engine_metrics"]["chaos"] == want["engine_metrics"]["chaos"]
        # The port offloads a victim's own pages, the reference a padded row.
        peak = (got["engine_metrics"]["offload_peak_bytes"],
                want["engine_metrics"]["offload_peak_bytes"])
        assert 0 < peak[0] <= peak[1] if got["engine_stats"]["preemptions"] \
            else peak == (0, 0)
        assert set(got["engine_stats"]) <= set(want["engine_stats"])
        for key in ("mode", "prefill", "loop", "scheduler", "mesh", "chunk_size",
                    "step_token_budget", "requests", "total_tokens"):
            assert got[key] == want[key], key
        # An admission-control rejection ends in a wall-clock estimate.
        heads = [{uid: err.split(" ~ ")[0] for uid, err in out["failed"].items()}
                 for out in (got, want)]
        assert heads[0] == heads[1]
        if mode == "admission-control":
            assert got["engine_stats"]["admission_rejects"] == 1
            assert list(got["failed"]) == [1]
    assert got["tokens"] == want["tokens"]
    assert set(got) <= set(want)
    printed = capsys.readouterr().out
    assert printed.count("fixed-batch (ragged lens" if args.fixed_batch
                         else "engine (") == 2       # the reference's and the port's


def test_build_trace_matches_reference():
    for hp in ({}, dict(hp_every=2, hp_ttft_slo_s=0.5, hp_tpot_slo_s=0.05)):
        j = j_serve.build_trace(np.random.RandomState(3), 4, 10, 90, 7, 512, 2,
                                **hp)
        t = t_serve.build_trace(np.random.RandomState(3), 4, 10, 90, 7, 512, 2,
                                **hp)
        assert len(j) == len(t) == 4
        for a, b in zip(j, t):
            assert (a.uid, a.max_new_tokens, a.arrival_step, a.priority,
                    a.ttft_slo_s, a.tpot_slo_s) == \
                (b.uid, b.max_new_tokens, b.arrival_step, b.priority,
                 b.ttft_slo_s, b.tpot_slo_s)
            np.testing.assert_array_equal(a.prompt, b.prompt)
        assert [r.priority for r in t] == ([0, 1, 0, 1] if hp else [0] * 4)


@pytest.mark.parametrize("extra", [[], ["--fixed-batch"], ["--policy", "streaming"]])
def test_main_runs_on_cpu(capsys, extra):
    out = t_serve.main(["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
                        "--requests", "3", "--decode-tokens", "6", "--max-slots", "2"]
                       + extra)
    assert len(out["tokens"]) == 3
    assert all(len(toks) == 6 for toks in out["tokens"].values())
    printed = capsys.readouterr().out
    assert "serve: arch=qwen3-0.6b-reduced device=cpu" in printed
    assert ("fixed-batch (ragged lens" if extra == ["--fixed-batch"]
            else "engine (chunked, sync, slo)") in printed


@pytest.mark.parametrize("flags", [
    ["--prefix-cache"], ["--prefix-evict", "hit-rate"], ["--mesh", "1,1"],
    ["--async-depth", "1"], ["--sampler", "temperature"], ["--executor", "pallas"],
])
def test_unported_flags_raise(flags):
    with pytest.raises(SystemExit) as info:
        t_serve.main(["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu"] + flags)
    if flags[0] != "--executor":            # argparse's own choice check
        assert "ROADMAP.md" in str(info.value)
