"""End-to-end training run (PyTorch port): train a ~100M-parameter qwen3-family
LM for a few hundred steps on the synthetic pipeline, with checkpointing +
straggler monitoring, through ``repro_torch.launch.train``; the
counterpart of ``examples/train_lm.py`` with the same configuration and
arguments.  Exits 1 if the loss did not fall.

  PYTHONPATH=src python examples/train_lm_torch.py [--steps 300]               # one GPU
  PYTHONPATH=src python examples/train_lm_torch.py --steps 20 --device cpu
"""
import argparse
import os
import sys
import tempfile

from repro_torch.launch import train as train_mod


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--checkpoint-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda", help="'cuda' | 'cpu'")
    args = ap.parse_args(argv)

    # ~100M params: qwen3-family geometry at the reference example's size.
    from repro_torch import configs
    from repro_torch.configs.base import ArchConfig

    cfg = ArchConfig(
        name="qwen3-100m", family="dense", num_layers=6, d_model=512,
        num_heads=8, num_kv_heads=4, head_dim=64, d_ff=1536,
        vocab_size=50304, qk_norm=True, dtype="float32",
    )
    configs.ALL[cfg.name] = cfg

    out = train_mod.main([
        "--arch", cfg.name, "--steps", str(args.steps),
        "--batch", "8", "--seq", "512", "--lr", "3e-4",
        "--checkpoint-dir", args.checkpoint_dir,
        "--checkpoint-every", "50", "--log-every", "10",
        "--device", args.device,
    ])
    losses = out["losses"]
    print(f"\nloss: {losses[0]:.3f} -> {losses[-1]:.3f} over {len(losses)} steps")
    if losses[-1] >= losses[0]:
        print("WARNING: loss did not decrease", file=sys.stderr)
        sys.exit(1)
    return out


if __name__ == "__main__":
    main()
