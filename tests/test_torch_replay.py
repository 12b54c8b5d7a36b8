"""The kernel-call recorder of the port (``repro_torch.kernels.replay``) on
the CPU: a served trace reaches it through every kernel wrapper of the
path, it keeps the calls it promises to keep, puts the wrappers back, and
its check rejects an output that is off its plain version.  (On the CPU a
wrapper's output is its plain version's, so these tests hold the
recorder's plumbing; the card tests and chip_smoke.py hold the kernels.)"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import policy as t_policy
from repro_torch.kernels import paged_attn as t_kern
from repro_torch.kernels import replay
from repro_torch.kernels import stem_metric as t_sm
from repro_torch.models import registry as t_registry
from repro_torch.runtime import engine as t_engine

torch.set_num_threads(1)

# tests/test_engine.py's config, policy and trace
TINY = dict(name="engine-tiny", family="dense", num_layers=2, d_model=32,
            num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64, vocab_size=64,
            qk_norm=True, dtype="float32")
STEM = dict(block_size=8, sink_blocks=1, local_blocks=1, min_budget_blocks=2,
            stride=4)
TRACE = [(5, 4, 0), (13, 6, 0), (8, 3, 1), (20, 5, 3), (9, 4, 5)]
# the wrappers each admission mode calls on the CPU (the dense arm of a
# one-shot prefill runs flash only on the card)
PATH = {
    False: {"score_pages/decode", "score_pages/chunk", "attend_pages/decode",
            "attend_pages/chunk", "antidiag_pool", "value_magnitude"},
    True: {"score_pages/decode", "attend_pages/decode", "block_sparse_attention",
           "antidiag_pool", "value_magnitude"},
}


def _serve(monolithic):
    cfg = ArchConfig(**TINY)
    policy = t_policy.get_policy("stem").with_updates(**STEM)
    bundle = t_registry.build(cfg)
    params = bundle.init_params(torch.Generator().manual_seed(0), device="cpu")
    ecfg = t_engine.EngineConfig.for_trace(
        max_slots=2, max_prompt=max(p for p, _, _ in TRACE),
        max_new_tokens=max(m for _, m, _ in TRACE), page_size=policy.block_size,
        budget_frac=0.5, monolithic_prefill=monolithic)
    engine = t_engine.StemEngine(bundle, params, policy, ecfg)
    rng = np.random.RandomState(7)
    reqs = [t_engine.Request(uid=i, prompt=rng.randint(0, 64, size=(p,)).astype(np.int32),
                             max_new_tokens=m, arrival_step=a)
            for i, (p, m, a) in enumerate(TRACE)]
    with replay.Recorder() as rec:
        finished = engine.run(reqs)
    return rec, [f.tokens for f in finished]


@pytest.mark.parametrize("monolithic", [False, True], ids=["chunked", "monolithic"])
def test_recorder_sees_every_kernel_of_the_path(monolithic):
    originals = {name: getattr(mod, name) for name, (mod, _, _) in replay.KERNELS.items()}
    rec, streams = _serve(monolithic)
    assert set(rec.calls) == PATH[monolithic]
    report = rec.check()
    for key, r in report.items():
        assert 0 < r["checked"] <= min(replay.KEEP, r["of"])
        assert r["share_of_limit"] == 0.0          # CPU: the plain version itself
    assert {n: getattr(mod, n) for n, (mod, _, _) in replay.KERNELS.items()} == originals
    # recording leaves the run as it was
    _, again = _serve(monolithic)
    assert streams == again and all(len(s) > 0 for s in streams)


def test_recorder_keeps_new_shapes_and_power_of_two_calls():
    gen = torch.Generator().manual_seed(0)
    shapes = [(1, 2, 16, 8)] * 20 + [(1, 2, 32, 8)] + [(3, 8, 8)] * 13 + [(2, 8, 8)]
    xs = [torch.randn(sh, generator=gen) for sh in shapes]
    with replay.Recorder() as rec:
        for x in xs:
            t_sm.value_magnitude(x, block_size=8)
    kept = rec.calls["value_magnitude"]
    assert rec.seen["value_magnitude"] == len(xs) == 35
    # calls 1, 2, 4, 8, 16 of the first shape, the 21st and 22nd (new
    # shapes), the 32nd; then the cap (the 35th, a new shape, is dropped)
    assert len(kept) == replay.KEEP == 8
    assert [tuple(a["v"].shape) for a, _ in kept] == [shapes[n - 1] for n in
                                                      (1, 2, 4, 8, 16, 21, 22, 32)]
    assert torch.equal(kept[2][0]["v"], xs[3]) and kept[2][0]["block_size"] == 8
    rec.check()


def test_recorder_check_rejects_an_output_off_its_plain_version():
    gen = torch.Generator().manual_seed(1)
    qp = torch.randn((1, 2, 1, 4, 8), generator=gen)
    kg = torch.randn((1, 5, 4, 8), generator=gen)
    pt = torch.tensor([[1, 2, 3]], dtype=torch.int32)
    with replay.Recorder() as rec:
        t_kern.score_pages(qp, kg, pt, group=2, scale=0.5, lane="chunk", pair=True)
    rec.check()
    args, out = rec.calls["score_pages/chunk"][0]
    assert args["pair"] is True and args["lane"] == "chunk"
    out[0, 1, 0, 2] += 2e-4                  # over fp32's 1e-4
    with pytest.raises(AssertionError, match="score_pages/chunk"):
        rec.check()
    out[0, 1, 0, 2] = float("nan")
    with pytest.raises(AssertionError, match="not finite"):
        rec.check()
