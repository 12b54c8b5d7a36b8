"""Long-context prefill (PyTorch port): Stem's budget scaling on a
16k-token prompt.

Shows the TPD schedule, the realized density at the paper's length rule
(k_start = 0.2 N_blk at 16k), and per-position reconstruction error:
early rows (recursive anchors) get large budgets, late rows are pruned
hard.  The counterpart of ``examples/longcontext_prefill.py`` at the same
sizes.

  PYTHONPATH=src python examples/longcontext_prefill_torch.py               # one GPU
  PYTHONPATH=src python examples/longcontext_prefill_torch.py --device cpu  # plain versions
"""
import argparse

import torch

from repro_torch.core import (StemConfig, average_budget, dense_attention,
                              schedule_for, stem_attention)

SEED = 1
STEM_KWARGS = dict()   # paper defaults incl. the length-dependent k_start


def device_or_exit(name: str) -> torch.device:
    """The device ``--device`` names; no card for ``cuda`` exits."""
    if name.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("longcontext_prefill: --device cuda, but no CUDA device "
                         "is visible")
    return torch.device(name)


def make_inputs(seed: int, device, seq: int = 16384, q_heads: int = 4,
                kv_heads: int = 2, head_dim: int = 64):
    """Standard normal fp32 q (1, q_heads, seq, head_dim) and k, v (1,
    kv_heads, seq, head_dim) drawn on the CPU from ``seed``, with values
    100-109 scaled by 10 (heavy hitters Stem must keep), on ``device``."""
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((1, q_heads, seq, head_dim), generator=gen)
    k = torch.randn((1, kv_heads, seq, head_dim), generator=gen)
    v = torch.randn((1, kv_heads, seq, head_dim), generator=gen)
    v[:, :, 100:110] *= 10.0
    return q.to(device), k.to(device), v.to(device)


def run(q, k, v, cfg) -> dict:
    """Stem attention of (q, k, v) under ``cfg`` against dense attention:
    the output, the TPD budgets, the realized density and the mean
    |stem - dense| of each query row (over batch, heads and features)."""
    out, stats = stem_attention(q, k, v, cfg, return_stats=True)
    err = (out - dense_attention(q, k, v)).abs().mean(dim=(0, 1, 3))
    return dict(out=out, budgets=schedule_for(cfg, q.shape[2]),
                density=float(stats.density), row_err=err.cpu().numpy())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="'cuda' | 'cpu'")
    args = ap.parse_args(argv)
    q, k, v = make_inputs(SEED, device_or_exit(args.device))
    cfg = StemConfig(**STEM_KWARGS)
    seq = q.shape[2]
    res = run(q, k, v, cfg)

    budgets, nb = res["budgets"], seq // cfg.block_size
    print(f"{seq} tokens -> {nb} blocks; k_start = {cfg.k_start_blocks(seq)} blocks"
          f" ({cfg.k_start_fraction(seq):.0%} rule), floor {cfg.min_budget_blocks}")
    print(f"budget row 16: {budgets[16]}  row {nb//2}: {budgets[nb//2]}  "
          f"row {nb-1}: {budgets[nb-1]}  (avg {average_budget(budgets):.1f})")
    print(f"realized density: {res['density']:.1%}")
    qtr, err = seq // 4, res["row_err"]
    res["quarter_err"] = [float(err[i * qtr:(i + 1) * qtr].mean()) for i in range(4)]
    for i in range(4):
        print(f"mean |err| rows [{i*qtr:6d},{(i+1)*qtr:6d}): {res['quarter_err'][i]:.5f}")
    return res


if __name__ == "__main__":
    main()
