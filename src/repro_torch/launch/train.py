"""The training CLI of the port (port of ``repro/launch/train.py``, one
device).

Composes the training path: the model registry, AdamW with fp32 master
weights and bf16 gradient compression (``optim/``), the seekable synthetic
data (``data/``), the checkpoint manager (atomic, keep-K, async saves;
``checkpoint/``), the straggler monitor and failure injection, whose
restart harness is ``runtime.fault_tolerance.run_with_restarts``.  The
forward's attention runs the port's kernels on the card in both directions
(flash attention dense, block-sparse under ``--stem``, each with its
hand-written backward).

The reference's flags and defaults, plus ``--device`` (default ``cuda``).
``--reduced`` forces fp32, as in the reference.  ``main`` returns the
reference's ``{"final_loss", "losses", "stragglers"}`` and ``step_ms``
(each step's host milliseconds, up to reading its loss).  A failure
(``--fail-at``) leaves only after an async checkpoint save in flight has
finished, so the restart finds it.  ``--prod-flags`` (XLA
flags) and ``JAX_COORDINATOR_ADDRESS`` (multi-host start-up) have no
counterpart on one device and raise ``SystemExit``.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --reduced --device cpu --steps 12 --batch 4 --seq 64 --lr 1e-2
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --steps 12 --batch 2 --seq 4096 --stem --checkpoint-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --steps 20 --restore --checkpoint-dir /tmp/ckpt   # resume
"""
from __future__ import annotations

import argparse
import os
import time

import torch

# Flags and settings of the reference without a one-device counterpart.
_UNPORTED = (
    (lambda a: a.prod_flags,
     "--prod-flags sets XLA's TPU flags; the port runs no XLA"),
    (lambda a: bool(os.environ.get("JAX_COORDINATOR_ADDRESS")),
     "JAX_COORDINATOR_ADDRESS starts a multi-host JAX job; the port trains "
     "on one device"),
)


def build_parser() -> argparse.ArgumentParser:
    """The reference's flags and defaults, plus ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-scale smoke training)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--stem", action="store_true",
                    help="train with Stem sparse attention in the forward")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="inject a failure at this step (fault-tolerance demo)")
    ap.add_argument("--prod-flags", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on ('cuda' | 'cpu')")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    for is_set, msg in _UNPORTED:
        if is_set(args):
            raise SystemExit(f"train: no one-device counterpart: {msg}")

    from repro_torch import configs, optim
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.config import StemConfig
    from repro_torch.data import SyntheticLMData, make_global_batch
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import registry
    from repro_torch.runtime.fault_tolerance import FailureInjector
    from repro_torch.runtime.straggler import StragglerMonitor

    cfg = configs.get_config(args.arch)
    if args.reduced:
        cfg = configs.reduced(cfg).replace(dtype="float32")
    bundle = registry.build(cfg)
    device = torch.device(args.device)

    stem_cfg = None
    if args.stem:
        stem_cfg = StemConfig(block_size=min(128, max(16, args.seq // 8)),
                              min_budget_blocks=2, sink_blocks=1, local_blocks=1,
                              stride=4)

    opt_cfg = optim.AdamWConfig(peak_lr=args.lr, warmup_steps=max(2, args.steps // 10),
                                decay_steps=max(args.steps, 10))
    train_step = steps_lib.make_train_step(
        bundle, opt_cfg, stem_cfg=stem_cfg, remat=True,
        microbatches=args.microbatches)

    data = SyntheticLMData(
        vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed,
        kind={"vlm": "vlm", "encdec": "encdec"}.get(cfg.family, "lm"),
        d_model=cfg.d_model,
        frames=cfg.encdec.encoder_frames if cfg.encdec else 0)

    mgr = CheckpointManager(args.checkpoint_dir) if args.checkpoint_dir else None
    start_step = 0
    if args.restore and mgr and mgr.latest_step() is not None:
        template = optim.init_state(
            bundle.init_params(torch.Generator(), device="meta"), opt_cfg)
        state, meta = mgr.restore(template, device=device)
        start_step = int(meta["step"])
        print(f"restored checkpoint at step {start_step}", flush=True)
    else:
        params = bundle.init_params(
            torch.Generator(device=device).manual_seed(args.seed), device=device)
        state = optim.init_state(params, opt_cfg)
        del params

    injector = FailureInjector((args.fail_at,) if args.fail_at >= 0 else ())
    monitor = StragglerMonitor(on_straggler=lambda s, dt, ema: print(
        f"[straggler] step {s}: {dt:.3f}s vs ema {ema:.3f}s", flush=True))

    losses, step_ms = [], []
    try:
        for step in range(start_step, args.steps):
            injector.maybe_fail(step)
            monitor.start()
            t0 = time.perf_counter()
            state, metrics = train_step(
                state, make_global_batch(data.batch_at(step), device))
            loss = float(metrics["loss"])          # waits for the step
            step_ms.append((time.perf_counter() - t0) * 1e3)
            monitor.stop(step)
            losses.append(loss)
            if step % args.log_every == 0:
                print(f"step {step}: loss={loss:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"lr={float(metrics['lr']):.2e}", flush=True)
            if mgr and (step + 1) % args.checkpoint_every == 0:
                mgr.save(step + 1, state, extra={"loss": loss}, blocking=False)
    finally:
        if mgr:     # an async save in flight finishes before a failure leaves
            mgr.wait()
    if mgr:
        mgr.save(args.steps, state, extra={"final": True}, blocking=True)
    return {"final_loss": losses[-1] if losses else None, "losses": losses,
            "stragglers": monitor.flagged, "step_ms": step_ms}


if __name__ == "__main__":
    main()
