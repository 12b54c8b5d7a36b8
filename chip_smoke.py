"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --profile  # also trace phase 4 with torch.profiler

Phases:
  1. device   — require CUDA; print the card's name and power limit.
  2. build    — compile every kernel source under
                src/repro_torch/kernels/csrc/ with nvcc (sm_90a) into
                build/kernels/, timed.
  3. kernels  — each kernel against its plain PyTorch version at the
                serving shapes of qwen3-0.6b (hq 16, hk 8, d 128, block 128,
                stride 16, 126 pages per row; decode b=4, chunk 1024):
                fp32 outputs (the scorer, and attention over fp32 pools)
                within 1e-4 abs; bf16 attention outputs within 2 bf16 ulps
                of the plain output plus 1e-3 * max|plain|; kernel and
                plain times from CUDA events.
  4. engine   — StemEngine at the full width of qwen3-0.6b (bf16, random
                weights from a seeded generator, policy "stem" with paper
                defaults, budget_frac 0.5, chunk 1024, 2 slots) serves four
                staggered requests (prompts 2000/6000/11000/16000 tokens, 32
                new tokens each).  Launch counters are zeroed just before the
                run and read just after; every kernel of both lanes must have
                launched, every logit must be finite, every page must return.
  5. parity   — full width, 2 layers, fp32: the "fused" and "gather"
                executors serve one short trace; greedy streams must be
                equal, or the logits at a split differ by < 1e-3.

Prints a {"kernels": [...]} line, the nvidia-smi line, and as its last line
{"ok": true, "device": {...}}.  Any failed phase raises (non-zero exit).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import QWEN3_0_6B  # noqa: E402
from repro_torch.core import chunked as chunked_lib  # noqa: E402
from repro_torch.core import metric as metric_lib  # noqa: E402
from repro_torch.core import policy as policy_lib  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import paged_attn as kern  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.runtime import engine as engine_lib  # noqa: E402

HBM_BYTES_S = 3.35e12        # H100 SXM data sheet
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
SOURCE = "src/repro_torch/kernels/csrc/paged_attn.cu"
REPLACES = {"score": "src/repro/kernels/paged_attn.py:142",
            "attend": "src/repro/kernels/paged_attn.py:249"}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """fp32 outputs within 1e-4 abs; bf16 outputs within 2 bf16 ulps of
    the plain value plus a floor of 1e-3 * max|plain| (for values near 0)."""
    dtype = got.dtype
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output not finite")
    diff = (got - want).abs()
    err = float(diff.max())
    if dtype == torch.float32:
        ok = err <= 1e-4
    else:
        limit = 2 * bf16_ulp(want) + 1e-3 * want.abs().max()
        ok = bool((diff <= limit).all())
    if not ok:
        raise AssertionError(f"{name}: max |kernel - plain| = {err}")
    return err


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    a = x.abs().clamp(min=1e-30)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_phase(records: dict, dev=torch.device("cuda")) -> None:
    hq, hk, d, bs, s = 16, 8, 128, 128, 16
    group = hq // hk
    maxp, b = 126, 4
    P = 1 + b * maxp
    policy = policy_lib.get_policy("stem")
    gen = torch.Generator(device=dev).manual_seed(0)
    perm = (1 + torch.randperm(P - 1, generator=gen, device=dev)).to(torch.int32)
    pt = perm[:b * maxp].reshape(b, maxp).contiguous()
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split(".")[-1]
        k = torch.randn((hk, P, bs, d), generator=gen, device=dev).to(dtype)
        v = torch.randn((hk, P, bs, d), generator=gen, device=dev).to(dtype)
        kg = metric_lib.antidiag_pool(k.float().reshape(hk, P * bs, d), bs, s).contiguous()
        vm = metric_lib.value_block_magnitude(v.reshape(hk, P * bs, d), bs)

        # -- decode lane -------------------------------------------------
        q = torch.randn((b, hq, 1, d), generator=gen, device=dev).to(dtype)
        lens = torch.tensor([16000, 11000, 6000, 2000], dtype=torch.int32, device=dev)
        qp = q.float()[:, :, :, None, :].expand(b, hq, 1, s, d)
        scale = 1.0 / (s * d ** 0.5)
        run_k = lambda: kern.score_pages(qp, kg, pt, group=group, scale=scale,
                                         lane="decode")
        run_p = lambda: kern.score_pages_plain(qp, kg, pt, group=group, scale=scale)
        sc_k = run_k()
        sc_p = run_p()
        torch.cuda.synchronize()
        err = check_close(f"score/decode/{tag}", sc_k, sc_p)
        m = sc_p.reshape(b, hk, group, maxp) + 0.2 * torch.clamp(
            vm[:, pt.long()].transpose(0, 1), min=0)[:, :, None, :]
        sel = policy.decode_select(m, lens, budget_frac=0.5)
        gp, idx, cnt = kern.pack_selection(sel.indices, sel.live, pt)
        args = (q.reshape(b, hq, 1, 1, d).contiguous(), k, v,
                gp.reshape(b, hq, 1, -1).contiguous(),
                idx.reshape(b, hq, 1, -1).contiguous(),
                cnt.reshape(b, hq, 1).contiguous(), lens)
        at_k = kern.attend_pages(*args, block_size=bs, causal=False, lane="decode")
        at_p = kern.attend_pages_plain(*args, block_size=bs, causal=False)
        torch.cuda.synchronize()
        err_a = check_close(f"attend/decode/{tag}", at_k, at_p)
        rec_kernel(records, "score", "decode", tag, err, run_k, run_p,
                   score_bytes_flops(qp_bytes=q.numel() * 4, pt=pt, hk=hk, s=s,
                                     d=d, out=sc_p), torch.float32)
        live_pairs = live_kv_pages(gp, cnt, group)
        rec_kernel(records, "attend", "decode", tag, err_a,
                   lambda: kern.attend_pages(*args, block_size=bs, causal=False,
                                             lane="decode"),
                   lambda: kern.attend_pages_plain(*args, block_size=bs, causal=False),
                   attend_bytes_flops(args, at_p, live_pairs, bs, d, rows=1),
                   dtype)

        # -- chunk lane (one lane, chunk 1024 at position 8192 of a
        #    16384-token padded prompt) ----------------------------------
        C, nc = 1024, 1024 // bs
        start = torch.tensor([8192], dtype=torch.int32, device=dev)
        ptc = pt[:1].contiguous()
        qc = torch.randn((1, hq, C, d), generator=gen, device=dev).to(dtype)
        qpc = metric_lib.antidiag_pool(qc.float(), bs, s)
        qpc = qpc.index_select(-2, (s - torch.arange(s, device=dev)) % s).contiguous()
        run_k = lambda: kern.score_pages(qpc, kg, ptc, group=group, scale=scale,
                                         lane="chunk")
        run_p = lambda: kern.score_pages_plain(qpc, kg, ptc, group=group, scale=scale)
        sc_k, sc_p = run_k(), run_p()
        torch.cuda.synchronize()
        err = check_close(f"score/chunk/{tag}", sc_k, sc_p)
        rec_kernel(records, "score", "chunk", tag, err, run_k, run_p,
                   score_bytes_flops(qp_bytes=qpc.numel() * 4, pt=ptc, hk=hk,
                                     s=s, d=d, out=sc_p), torch.float32)
        mv = torch.repeat_interleave(vm[:, ptc.long()].transpose(0, 1), group, dim=1)
        mc = sc_p + 0.2 * torch.clamp(mv, min=0)[..., None, :]
        rows = start[:, None] // bs + torch.arange(nc, device=dev)[None, :]
        budgets = torch.as_tensor(chunked_lib.chunk_budget_rows(
            policy, 16384, 8192, nc), device=dev)[None]
        k_max = chunked_lib.chunk_budget_bound(policy, maxp)
        selc = chunked_lib.select_chunk_blocks(mc, rows, budgets, policy, k_max)
        gp, idx, cnt = kern.pack_selection(selc.indices, selc.live, ptc)
        args = (qc.reshape(1, hq, nc, bs, d).contiguous(), k, v, gp.contiguous(),
                idx.contiguous(), cnt.contiguous(), start)
        at_k = kern.attend_pages(*args, block_size=bs, causal=True, lane="chunk")
        at_p = kern.attend_pages_plain(*args, block_size=bs, causal=True)
        torch.cuda.synchronize()
        err_a = check_close(f"attend/chunk/{tag}", at_k, at_p)
        rec_kernel(records, "attend", "chunk", tag, err_a,
                   lambda: kern.attend_pages(*args, block_size=bs, causal=True,
                                             lane="chunk"),
                   lambda: kern.attend_pages_plain(*args, block_size=bs, causal=True),
                   attend_bytes_flops(args, at_p, live_kv_pages(gp, cnt, group),
                                      bs, d, rows=bs),
                   dtype)
        del k, v, kg, vm
        torch.cuda.empty_cache()


def live_kv_pages(gp, cnt, group) -> int:
    """Distinct (kv head, page) pairs the live selections read."""
    b, hq, nc, kmax = gp.shape
    live = torch.arange(kmax, device=gp.device) < cnt[..., None].long()
    kvh = (torch.arange(hq, device=gp.device) // group)[None, :, None, None]
    key = (kvh.expand_as(gp).long() << 32) | gp.long()
    return int(torch.unique(key[live]).numel())


def score_bytes_flops(*, qp_bytes, pt, hk, s, d, out):
    pages = int(torch.unique(pt).numel())
    nbytes = qp_bytes + pages * hk * s * d * 4 + pt.numel() * 4 + out.numel() * 4
    flops = 2.0 * out.numel() * s * d
    return nbytes, flops


def attend_bytes_flops(args, out, live_pages, bs, d, rows):
    q, k = args[0], args[1]
    nbytes = (q.numel() * q.element_size() + out.numel() * out.element_size()
              + 2 * live_pages * bs * d * k.element_size()
              + sum(a.numel() * 4 for a in args[3:]))
    live_slots = float(args[5].sum())
    flops = 4.0 * live_slots * rows * bs * d
    return nbytes, flops


def rec_kernel(records, kernel, lane, tag, err, run_k, run_p, bf, dtype):
    ms = time_ms(run_k, iters=20)
    plain_ms = time_ms(run_p, iters=3, warmup=1)
    bound_ms, bound_by = bound(*bf, dtype)
    log(f"[kernels] {kernel}/{lane} {tag}: max_abs_err={err:.3e} "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by})")
    records.setdefault(f"{kernel}/{lane}", {})[tag] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by)


# ---------------------------------------------------------------------------
# Phase 4: the engine at full width
# ---------------------------------------------------------------------------

def _finite_guard(engine):
    """Wrap the engine's step so every logit it returns is checked."""
    step = engine._unified

    def guarded(*a, **kw):
        dec, chunk, pools = step(*a, **kw)
        for t in (dec, chunk):
            if t is not None and not torch.isfinite(t).all():
                raise AssertionError("non-finite logits in the engine step")
        return dec, chunk, pools
    engine._unified = guarded


def profile_summary(prof, wall: float, top: int = 12) -> None:
    """Device time by kernel name and the device's busy share of the run."""
    rows = []
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            continue                       # CPU ops: their kernels count below
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = ev.self_cuda_time_total
        if t > 0:
            rows.append((t / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e3
    log(f"[profile] device busy {busy:.3f} s of {wall:.3f} s wall "
        f"(busy share {busy / wall:.3f}; profiler on)")
    for ms, count, name in rows[:top]:
        log(f"[profile] {ms:10.1f} ms {count:7d} calls  {name[:90]}")


def engine_phase(profile: bool = False) -> dict:
    cfg = QWEN3_0_6B
    bundle = registry.build(cfg)
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0),
                                device="cuda")
    policy = policy_lib.get_policy("stem")
    prompts = (2000, 6000, 11000, 16000)
    arrivals = (0, 0, 2, 4)
    new = 32
    ecfg = engine_lib.EngineConfig.for_trace(
        max_slots=2, max_prompt=max(prompts), max_new_tokens=new,
        page_size=policy.block_size, budget_frac=0.5, chunk_size=1024)
    engine = engine_lib.StemEngine(bundle, params, policy, ecfg)
    _finite_guard(engine)
    rng = np.random.RandomState(0)
    reqs = [engine_lib.Request(
        uid=i, prompt=rng.randint(0, cfg.vocab_size, size=(n,)).astype(np.int32),
        max_new_tokens=new, arrival_step=a)
        for i, (n, a) in enumerate(zip(prompts, arrivals))]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kern.reset_launches()
    prof = None
    if profile:
        act = torch.profiler.ProfilerActivity
        prof = torch.profiler.profile(activities=[act.CPU, act.CUDA])
        prof.__enter__()
    t0 = time.perf_counter()
    finished = engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
        profile_summary(prof, wall)
    launches = dict(kern.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    if [f.uid for f in finished] != list(range(len(prompts))):
        raise AssertionError("not every request finished")
    for f in finished:
        if len(f.tokens) != new:
            raise AssertionError(f"request {f.uid}: {len(f.tokens)} tokens")
    if engine.allocator.available != ecfg.num_pages - 1:
        raise AssertionError("pages leaked")
    engine.allocator.check_conservation([])
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    gen_tokens = sum(len(f.tokens) for f in finished)
    tpots = [f.tpot_s for f in finished]
    summary = dict(
        wall_s=wall, tok_s=gen_tokens / wall,
        prompt_tok_s=sum(prompts) / wall,
        mean_ttft_s=float(np.mean([f.ttft_s for f in finished])),
        mean_tpot_s=float(np.mean(tpots)), steps=engine.step_count,
        chunks=engine.stats["chunks"], decode_steps=engine.stats["decode_steps"],
        peak_mem_gib=peak / 2 ** 30, num_pages=ecfg.num_pages,
        launches=launches)
    log("[engine] " + json.dumps(summary))
    del engine, params
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 5: fused vs gather at full width, 2 layers, fp32
# ---------------------------------------------------------------------------

def parity_phase() -> dict:
    cfg = QWEN3_0_6B.replace(num_layers=2, dtype="float32")
    bundle = registry.build(cfg)
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(1),
                                device="cuda")
    policy = policy_lib.get_policy("stem").with_updates(min_budget_blocks=4)
    prompts, new = (3000, 5000), 8
    rng = np.random.RandomState(1)
    prompt_ids = [rng.randint(0, cfg.vocab_size, size=(n,)).astype(np.int32)
                  for n in prompts]
    runs = {}
    for executor in ("fused", "gather"):
        ecfg = engine_lib.EngineConfig.for_trace(
            max_slots=2, max_prompt=max(prompts), max_new_tokens=new,
            page_size=policy.block_size, budget_frac=0.5, chunk_size=1024,
            executor=executor)
        engine = engine_lib.StemEngine(bundle, params, policy, ecfg)
        calls = []
        step = engine._unified

        def recorded(params_, pools, tokens, table, lens, chunk=None,
                     step=step, calls=calls):
            dec, ch, pools = step(params_, pools, tokens, table, lens, chunk)
            rows = [dec[i] for i in torch.nonzero(lens > 0).flatten().tolist()]
            if chunk is not None:
                rows += [ch[i] for i in
                         torch.nonzero(chunk["true_len"] > 0).flatten().tolist()]
            calls.append([r.float().cpu() for r in rows])
            return dec, ch, pools
        engine._unified = recorded
        fin = engine.run([engine_lib.Request(uid=i, prompt=p, max_new_tokens=new)
                          for i, p in enumerate(prompt_ids)])
        runs[executor] = ([f.tokens for f in fin], calls)
        del engine
    (tok_f, calls_f), (tok_g, calls_g) = runs["fused"], runs["gather"]
    max_diff, split = 0.0, None
    for cf, cg in zip(calls_f, calls_g):
        for rf, rg in zip(cf, cg):
            diff = float((rf - rg).abs().max())
            if int(rf.argmax()) != int(rg.argmax()):
                split = diff
                break
            max_diff = max(max_diff, diff)
        if split is not None:
            break
    if split is None and tok_f != tok_g:
        raise AssertionError("streams differ without a logits split")
    if split is not None and split >= 1e-3:
        raise AssertionError(f"executors split with logits diff {split}")
    result = dict(streams_equal=tok_f == tok_g, max_logit_diff=max_diff,
                  split_logit_diff=split)
    log("[parity] " + json.dumps(result))
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace the engine phase with torch.profiler and "
                         "print device time by kernel")
    args = ap.parse_args()

    # Phase 1: device.
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is false)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)} | {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    # Phase 2: build.
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"[build] {sorted(libs)} in {time.perf_counter() - t0:.1f} s")

    # Phase 3: kernels against their plain versions.
    records: dict = {}
    kernel_phase(records)

    # Phase 4: the engine at full width (the main path); phase 5: parity.
    launches = engine_phase(profile=args.profile)
    parity_phase()

    kernels = []
    for key in ("score/decode", "score/chunk", "attend/decode", "attend/chunk"):
        kernel, lane = key.split("/")
        rec = records[key]["bfloat16"]
        kernels.append(dict(
            name=f"paged_{kernel}/{lane}", route="cuda", source=SOURCE,
            replaces=REPLACES[kernel], launches=launches[key],
            max_abs_err=max(r["max_abs_err"] for r in records[key].values()),
            ms=rec["ms"], plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=None,
            fp32=records[key]["float32"]))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
