"""The serving CLI of the port: continuous batching over the paged Stem KV
cache, or the fixed batch over contiguous caches (port of
``repro/launch/serve.py``).

Requests carry mixed prompt lengths and staggered arrivals; the engine
(``runtime/engine.py``) admits them into slots as capacity frees up and
recycles slots on completion.  Three modes:

  * default — the continuous-batching engine with chunked prefill: one
    mixed step per iteration spends at most ``--step-token-budget`` tokens
    on decode tokens and prefill chunks of ``--chunk-size``;
  * ``--monolithic`` — one-shot admission prefill (the paper's prefill),
    then decode in the mixed step;
  * ``--fixed-batch`` — one ragged batch over contiguous caches: prompts
    right-padded, per-row ``cache_lens`` through ``make_serve_step``, every
    row decoding at its own length.  Under a policy both prefill and decode
    run policy-sparse (decode re-summarizes the whole cache every step: the
    reference arm of the paged engine's sparse decode).

In engine mode, ``--hp-every N`` makes every Nth request priority 1 with
the ``--hp-*-slo-ms`` SLOs (the SLO scheduler may preempt a lower-priority
request for it; ``--scheduler fcfs`` never does), ``--max-waiting`` sheds
waiting-queue overflow, ``--admission-control`` rejects requests whose TTFT
SLO is infeasible, and ``--chaos`` injects a fixed fault plan; failed
requests are reported under ``failed``.

``--policy <name>`` resolves a registered ``SparsityPolicy`` and rescales it
to the serving geometry; without it, ``--stem`` picks the flag-built stem
policy's sparse arm.  The port runs on ``--device`` (default ``cuda``).
Flags whose feature the port does not have yet raise ``SystemExit`` naming
the ``ROADMAP.md`` item that will lift them.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --reduced --device cpu --requests 3 --decode-tokens 6 --max-slots 2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --policy stem --requests 2 --min-prompt 2000 --max-prompt 6000
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

# Flags of the reference whose feature the port lacks: (is it set, message).
_UNPORTED = (
    (lambda a: a.prefix_cache or a.prefix_evict != "lru",
     "--prefix-cache / --prefix-evict: the prefix cache is ROADMAP.md queue 1 "
     "item 5.3"),
    (lambda a: bool(a.mesh),
     "--mesh: mesh serving is ROADMAP.md queue 1 item 6"),
    (lambda a: a.async_depth > 0,
     "--async-depth > 0: the async loop is ROADMAP.md queue 1 item 5.4"),
    (lambda a: a.sampler != "greedy",
     "--sampler: only greedy sampling is ported; the temperature sampler is "
     "ROADMAP.md queue 1 item 5.4"),
)


def _reject_unported(args) -> None:
    for is_set, msg in _UNPORTED:
        if is_set(args):
            raise SystemExit(f"serve: not ported yet: {msg}")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_trace(rng: np.random.RandomState, n_requests: int, min_prompt: int,
                max_prompt: int, decode_tokens: int, vocab: int,
                arrival_every: int, hp_every: int = 0,
                hp_ttft_slo_s: float = None, hp_tpot_slo_s: float = None):
    """Mixed-length, staggered-arrival request trace.  With ``hp_every``,
    every hp_every-th request is priority 1 and carries the given SLOs —
    the interactive class of the overload study."""
    from repro_torch.runtime.engine import Request
    reqs = []
    for i in range(n_requests):
        plen = int(rng.randint(min_prompt, max_prompt + 1))
        hp = bool(hp_every) and (i % hp_every == hp_every - 1)
        reqs.append(Request(
            uid=i,
            prompt=rng.randint(0, vocab, size=(plen,)).astype(np.int32),
            max_new_tokens=decode_tokens,
            arrival_step=i * arrival_every,
            priority=1 if hp else 0,
            ttft_slo_s=hp_ttft_slo_s if hp else None,
            tpot_slo_s=hp_tpot_slo_s if hp else None,
        ))
    return reqs


def _latency_stats(finished):
    """Serving-latency summary: inter-token decode gaps (p50/p95/p99), TTFT
    and TPOT.  NaN entries (failed requests never emitted a token;
    single-token requests have no TPOT) are excluded."""
    lats = np.asarray([t for f in finished for t in f.token_latencies_s])
    ttfts = np.asarray([f.ttft_s for f in finished], np.float64)
    ttfts = ttfts[~np.isnan(ttfts)] if ttfts.size else ttfts
    tpots = np.asarray([f.tpot_s for f in finished], np.float64)
    tpots = tpots[~np.isnan(tpots)] if tpots.size else tpots
    out = {"p50_ms": 0.0, "p95_ms": 0.0, "p99_ms": 0.0, "ttft_ms_mean": 0.0,
           "ttft_ms_p95": 0.0, "tpot_ms_mean": 0.0}
    if lats.size:
        out["p50_ms"] = float(np.percentile(lats, 50) * 1e3)
        out["p95_ms"] = float(np.percentile(lats, 95) * 1e3)
        out["p99_ms"] = float(np.percentile(lats, 99) * 1e3)
    if ttfts.size:
        out["ttft_ms_mean"] = float(np.mean(ttfts) * 1e3)
        out["ttft_ms_p95"] = float(np.percentile(ttfts, 95) * 1e3)
    if tpots.size:
        out["tpot_ms_mean"] = float(np.mean(tpots) * 1e3)
    return out


def run_engine(args, cfg, bundle, params, stem_cfg, budget_frac):
    from repro_torch.runtime.engine import EngineConfig, StemEngine

    ecfg = EngineConfig.for_trace(
        max_slots=args.max_slots, max_prompt=args.max_prompt,
        max_new_tokens=args.decode_tokens, page_size=stem_cfg.block_size,
        budget_frac=budget_frac,
        chunk_size=args.chunk_size or None,
        step_token_budget=args.step_token_budget or None,
        monolithic_prefill=args.monolithic,
        scheduler=args.scheduler,
        max_waiting=args.max_waiting or None,
        executor=args.executor or None,
        admission_control=args.admission_control,
        sampler=args.sampler)
    chaos = None
    if args.chaos:
        from repro_torch.runtime.chaos import CLI_PLAN, ChaosInjector
        chaos = ChaosInjector(CLI_PLAN)
    engine = StemEngine(bundle, params, stem_cfg, ecfg, chaos=chaos)
    rng = np.random.RandomState(args.seed + 1)
    trace = build_trace(rng, args.requests, args.min_prompt, args.max_prompt,
                        args.decode_tokens, cfg.vocab_size, args.arrival_every,
                        hp_every=args.hp_every,
                        hp_ttft_slo_s=args.hp_ttft_slo_ms * 1e-3,
                        hp_tpot_slo_s=args.hp_tpot_slo_ms * 1e-3)
    t0 = time.perf_counter()
    finished = engine.run(trace)
    _sync(engine.device)
    wall = time.perf_counter() - t0
    ok = [f for f in finished if f.error is None]
    failed = [f for f in finished if f.error is not None]
    stats = _latency_stats(ok)
    total_tokens = sum(len(f.tokens) for f in finished)
    metrics = engine.metrics
    # The reference's keys, but for its engine stats "traces" /
    # "prefill_traces" / "pallas_fallbacks" (PyTorch runs eagerly and the
    # port has no fallback path).
    out = {
        "mode": "engine",
        "prefill": "monolithic" if args.monolithic else "chunked",
        "loop": "sync",
        "scheduler": ecfg.scheduler,
        "mesh": None,
        "chunk_size": engine.chunk_size,
        "step_token_budget": engine.token_budget,
        "requests": len(finished),
        "failed": {f.uid: f.error for f in failed},
        "total_tokens": total_tokens,
        "wall_s": wall,
        "throughput_tok_s": total_tokens / max(wall, 1e-9),
        "engine_stats": dict(engine.stats),
        "engine_metrics": {
            "step_time_ema_s": metrics["step_time_ema_s"],
            "straggler_steps": metrics["straggler_steps"],
            "offload_peak_bytes": metrics["offload_peak_bytes"],
            "chaos": metrics["chaos"],
        },
        "tokens": {f.uid: f.tokens for f in finished},
        **stats,
    }
    print(f"engine ({out['prefill']}, {out['loop']}, {ecfg.scheduler}): "
          f"{len(finished)} reqs ({len(failed)} failed), {total_tokens} "
          f"tokens in {wall*1e3:.0f} ms -> {out['throughput_tok_s']:.1f} "
          f"tok/s; TTFT {out['ttft_ms_mean']:.1f} ms; TPOT "
          f"{out['tpot_ms_mean']:.2f} ms; inter-token p50 {out['p50_ms']:.2f} "
          f"/ p95 {out['p95_ms']:.2f} ms; slots reused "
          f"{engine.stats['slots_reused']}, max concurrency "
          f"{engine.stats['max_concurrency']}", flush=True)
    s = engine.stats
    if any(s[k] for k in ("preemptions", "shed", "aborts", "step_failures",
                          "restore_failures", "straggler_steps")):
        print(f"  resilience: preemptions {s['preemptions']} "
              f"(restores {s['restores']}), shed {s['shed']}, aborts "
              f"{s['aborts']}, step failures {s['step_failures']}, restore "
              f"failures {s['restore_failures']}; offload peak "
              f"{metrics['offload_peak_bytes']} B", flush=True)
    if metrics["straggler_steps"]:
        worst = max(metrics["straggler_steps"], key=lambda f: f[1])
        print(f"  stragglers: {len(metrics['straggler_steps'])} flagged "
              f"steps (EMA {metrics['step_time_ema_s']*1e3:.2f} ms; worst "
              f"step {worst[0]} at {worst[1]*1e3:.1f} ms vs EMA "
              f"{worst[2]*1e3:.2f} ms)", flush=True)
    print("  engine_metrics " + json.dumps(out["engine_metrics"]), flush=True)
    return out


def run_fixed_batch(args, cfg, bundle, params, stem_cfg, budget_frac=1.0):
    """One ragged batch: prompts right-padded, per-row cache_lens.  With
    ``stem_cfg`` both prefill and decode run policy-sparse (decode
    re-summarizes the contiguous cache every step — the reference arm for
    the paged engine)."""
    from repro_torch.core import policy as policy_lib
    from repro_torch.launch import steps as steps_lib
    from repro_torch.runtime import sampling as sampling_lib

    device = params["embed"].device
    rng = np.random.RandomState(args.seed + 1)
    lens = rng.randint(args.min_prompt, args.max_prompt + 1,
                       size=(args.requests,)).astype(np.int32)
    max_prompt = int(lens.max())
    max_len = max_prompt + args.decode_tokens
    if stem_cfg is not None:
        # Sparse decode re-summarizes the contiguous cache, which needs the
        # cache length to be a whole number of blocks.
        bs = policy_lib.as_policy(stem_cfg).block_size
        max_len = -(-max_len // bs) * bs
    toks = np.zeros((args.requests, max_prompt), np.int32)
    for i, L in enumerate(lens):
        toks[i, :L] = rng.randint(0, cfg.vocab_size, size=(int(L),))

    # The engine's sampler: logits stay on the device, and only the int32
    # ids of each step reach the host.
    sampler = sampling_lib.get_sampler(args.sampler)
    serve = steps_lib.make_serve_step(bundle, stem_cfg=stem_cfg,
                                      budget_frac=budget_frac)
    batch = {"tokens": torch.as_tensor(toks, device=device)}
    last = torch.as_tensor(lens - 1, device=device)
    _sync(device)
    t0 = time.perf_counter()
    logits, caches = bundle.prefill(params, batch, max_len=max_len,
                                    stem_cfg=stem_cfg, last_pos=last)
    _sync(device)
    ttft = time.perf_counter() - t0
    toks_step = sampler(logits)[:, None]
    out_tokens = [toks_step.cpu().numpy()]
    t1 = time.perf_counter()
    cache_lens = torch.as_tensor(lens, device=device)
    for i in range(args.decode_tokens - 1):
        logits, caches = serve(params, toks_step, caches,
                               cache_lens if i == 0 else None)
        toks_step = sampler(logits)[:, None]
        out_tokens.append(toks_step.cpu().numpy())
    _sync(device)
    dt = time.perf_counter() - t1
    per_tok = dt / max(args.decode_tokens - 1, 1)
    gen = np.concatenate(out_tokens, axis=1)
    print(f"fixed-batch (ragged lens {lens.tolist()}): TTFT {ttft*1e3:.1f} ms, "
          f"decode {per_tok*1e3:.2f} ms/token ({args.requests} seqs)", flush=True)
    return {"mode": "fixed-batch", "ttft_s": ttft, "ms_per_token": per_tok * 1e3,
            "prompt_lens": lens.tolist(),
            "tokens": {i: gen[i].tolist() for i in range(args.requests)}}


def build_parser() -> argparse.ArgumentParser:
    """The reference's flags and defaults, plus ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on ('cuda' | 'cpu')")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--min-prompt", type=int, default=48)
    ap.add_argument("--max-prompt", type=int, default=200)
    ap.add_argument("--decode-tokens", type=int, default=16)
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--arrival-every", type=int, default=2,
                    help="request i arrives at engine step i * this")
    ap.add_argument("--stem", action="store_true",
                    help="sparse decode budget (< 1.0); off = dense-equivalent")
    ap.add_argument("--policy", default=None,
                    help="named SparsityPolicy from the registry "
                         "(core/policy.py: stem, stem-sam, uniform-sam, "
                         "streaming, xattention, ...); default builds the "
                         "stem policy from StemConfig flags.  Implies the "
                         "sparse arm unless --budget-frac overrides it")
    ap.add_argument("--budget-frac", type=float, default=0.5)
    ap.add_argument("--block-size", type=int, default=0,
                    help="Stem block/page size; 0 = auto from max prompt")
    ap.add_argument("--chunk-size", type=int, default=0,
                    help="prefill chunk width in tokens (multiple of the "
                         "page size); 0 = auto (2 pages)")
    ap.add_argument("--step-token-budget", type=int, default=0,
                    help="max tokens one engine step spends (decode tokens "
                         "first, then prefill chunks); 0 = auto "
                         "(max_slots + chunk)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="not ported yet (ROADMAP.md queue 1 item 5.3)")
    ap.add_argument("--monolithic", action="store_true",
                    help="one-shot admission prefill in place of chunks")
    ap.add_argument("--scheduler", choices=("slo", "fcfs"), default="slo",
                    help="token-budget scheduling order: 'slo' = priority + "
                         "SLO headroom (preemption-capable), 'fcfs' = "
                         "admission order")
    ap.add_argument("--max-waiting", type=int, default=0,
                    help="waiting-queue bound; overflow sheds the lowest-"
                         "priority waiting request (0 = unbounded)")
    ap.add_argument("--hp-every", type=int, default=0,
                    help="every Nth request is priority 1 with the --hp-* "
                         "SLOs (0 = uniform priority)")
    ap.add_argument("--hp-ttft-slo-ms", type=float, default=500.0,
                    help="TTFT SLO of the high-priority class")
    ap.add_argument("--hp-tpot-slo-ms", type=float, default=50.0,
                    help="TPOT SLO of the high-priority class")
    ap.add_argument("--mesh", default="",
                    help="not ported yet (ROADMAP.md queue 1 item 6)")
    ap.add_argument("--executor", choices=("", "fused", "gather"), default="",
                    help="executor to force on the paged lanes and every "
                         "prefill ('fused' CUDA kernels | 'gather' PyTorch "
                         "oracle); empty = policy default")
    ap.add_argument("--prefix-evict", choices=("lru", "hit-rate"),
                    default="lru",
                    help="not ported yet (ROADMAP.md queue 1 item 5.3)")
    ap.add_argument("--admission-control", action="store_true",
                    help="reject waiting requests whose TTFT SLO is "
                         "infeasible at the measured step time")
    ap.add_argument("--async-depth", type=int, default=0,
                    help="0 = synchronous engine loop; > 0 is not ported "
                         "yet (ROADMAP.md queue 1 item 5.4)")
    ap.add_argument("--sampler", default="greedy",
                    help="registered sampler; only 'greedy' is ported")
    ap.add_argument("--chaos", action="store_true",
                    help="inject a fixed fault plan (alloc denial at step 2, "
                         "step failure at 4, restore failure at 7); the run "
                         "must still end every request")
    ap.add_argument("--fixed-batch", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    _reject_unported(args)

    from repro_torch import configs
    from repro_torch.core import policy as policy_lib
    from repro_torch.core.config import StemConfig
    from repro_torch.models import registry

    cfg = configs.get_config(args.arch)
    if args.reduced:
        cfg = configs.reduced(cfg).replace(dtype="float32")
    bundle = registry.build(cfg)
    params = bundle.init_params(
        torch.Generator(device=args.device).manual_seed(args.seed),
        device=args.device)

    bs = args.block_size or max(16, min(128, args.max_prompt // 8))
    bs = -(-bs // 8) * 8
    if args.policy:
        # Rescale the named policy's geometry / stability knobs to the
        # serving shape (registered defaults carry the paper's B=128 over
        # 8k+ contexts); content-free policies lack some of the fields.
        stem_cfg = policy_lib.get_policy(args.policy).with_updates(
            block_size=bs, stride=4, sink_blocks=1, local_blocks=1,
            min_budget_blocks=2, ignore_missing=True)
        sparse = True
    else:
        stem_cfg = StemConfig(block_size=bs, min_budget_blocks=2, sink_blocks=1,
                              local_blocks=1, stride=4)
        sparse = args.stem
    if args.executor:
        # One backend for the paged lanes and every prefill, --fixed-batch's
        # one-shot prefill included.
        stem_cfg = policy_lib.as_policy(stem_cfg).with_updates(
            executor=args.executor)
    budget_frac = args.budget_frac if sparse else 1.0
    name = args.policy or "stem"
    print(f"serve: arch={cfg.name} device={args.device} page/block={bs} "
          f"policy={name} sparse={'on' if sparse else 'off'} "
          f"budget_frac={budget_frac}", flush=True)

    if args.fixed_batch:
        return run_fixed_batch(args, cfg, bundle, params,
                               stem_cfg if sparse else None, budget_frac)
    return run_engine(args, cfg, bundle, params, stem_cfg, budget_frac)


if __name__ == "__main__":
    main()
