"""Quickstart (PyTorch port): Stem sparse attention as a drop-in module.

Runs the coarse-to-fine pipeline (Algorithm 1) on random Q/K/V, compares
against dense attention, and prints the realized budget; the counterpart
of ``examples/quickstart.py`` at the same sizes.  On the card the
selection's pooling and value magnitude and the block-sparse attention run
as the port's CUDA kernels.

  PYTHONPATH=src python examples/quickstart_torch.py               # one GPU
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # plain versions
"""
import argparse

import torch

from repro_torch.core import StemConfig, dense_attention, schedule_for, stem_attention

SEED = 0
# Paper defaults: B=128, mu=0.7, beta=0.2, 4 sink + 4 local blocks.
STEM_KWARGS = dict(block_size=128, k_start_frac=0.25, mu=0.7, beta=0.2,
                   sink_blocks=2, local_blocks=2, min_budget_blocks=4)


def device_or_exit(name: str) -> torch.device:
    """The device ``--device`` names; no card for ``cuda`` exits."""
    if name.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("quickstart: --device cuda, but no CUDA device is visible")
    return torch.device(name)


def make_inputs(seed: int, device, batch: int = 2, q_heads: int = 8,
                kv_heads: int = 4, seq: int = 4096, head_dim: int = 64):
    """Standard normal fp32 q (batch, q_heads, seq, head_dim) and k, v
    (batch, kv_heads, seq, head_dim), drawn on the CPU from ``seed`` (the
    same values on every device) and moved to ``device``."""
    gen = torch.Generator().manual_seed(seed)
    shapes = ((batch, q_heads, seq, head_dim), (batch, kv_heads, seq, head_dim),
              (batch, kv_heads, seq, head_dim))
    return tuple(torch.randn(s, generator=gen).to(device) for s in shapes)


def run(q, k, v, cfg) -> dict:
    """Stem attention of (q, k, v) under ``cfg`` against dense attention:
    the output, the TPD budgets, the realized density and the max / mean
    |stem - dense|."""
    out, stats = stem_attention(q, k, v, cfg, return_stats=True)
    err = (out - dense_attention(q, k, v)).abs()
    return dict(out=out, budgets=schedule_for(cfg, q.shape[2]),
                density=float(stats.density), max_err=float(err.max()),
                mean_err=float(err.mean()))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="'cuda' | 'cpu'")
    args = ap.parse_args(argv)
    q, k, v = make_inputs(SEED, device_or_exit(args.device))
    cfg = StemConfig(**STEM_KWARGS)
    res = run(q, k, v, cfg)

    seq, budgets = q.shape[2], res["budgets"]
    print(f"sequence        : {seq} tokens = {seq // cfg.block_size} blocks of {cfg.block_size}")
    print(f"TPD budgets     : first rows {budgets[:4].tolist()} ... last rows {budgets[-4:].tolist()}")
    print(f"realized density: {res['density']:.1%} of the causal block triangle")
    print(f"max error vs dense: {res['max_err']:.4f}")
    print(f"mean error vs dense: {res['mean_err']:.5f}")
    print("(random QKV is the worst case for sparse attention)")
    return res


if __name__ == "__main__":
    main()
