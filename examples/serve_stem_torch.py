"""Serving example (PyTorch port): a mixed-length, staggered-arrival request
trace through the continuous-batching engine with the paged Stem KV cache,
the counterpart of ``examples/serve_stem.py`` with the same arguments.  All
arms share the engine and are declared via the policy registry
(``--policy``); the dense arm runs the same paged decode at
``budget_frac=1.0`` (the dense-equivalent oracle), so the comparisons
isolate each policy's selection rule.

Prefill is **chunked** by default: long prompts advance ``--chunk-size``
tokens per engine step in the mixed step instead of stalling co-tenants
behind a monolithic pass (``--monolithic`` shows the one-shot admission
prefill).  The summary line leaves out the reference's trace counts: the
port runs eagerly and counts no traces.

  PYTHONPATH=src python examples/serve_stem_torch.py               # one GPU
  PYTHONPATH=src python examples/serve_stem_torch.py --device cpu
"""
import argparse

import torch

from repro_torch.launch import serve as serve_mod

COMMON = [
    "--arch", "qwen3-0.6b", "--reduced",
    "--requests", "6", "--min-prompt", "64", "--max-prompt", "320",
    "--decode-tokens", "16", "--max-slots", "3", "--arrival-every", "2",
    "--block-size", "32", "--chunk-size", "128",
]
# (arm, its banner, its arguments after COMMON)
ARMS = (
    ("dense", "dense-equivalent decode (budget_frac=1.0, chunked prefill)", []),
    ("stem", "Stem-sparse decode (--policy stem, budget_frac=0.5)",
     ["--policy", "stem", "--budget-frac", "0.5"]),
    ("streaming", "StreamingLLM decode (--policy streaming: sink+local pages)",
     ["--policy", "streaming"]),
    ("monolithic", "monolithic-prefill baseline (one-shot admission prefill, HOL stalls)",
     ["--policy", "stem", "--monolithic"]),
)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="'cuda' | 'cpu'")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("serve_stem: --device cuda, but no CUDA device is visible")

    out = {}
    for i, (arm, banner, extra) in enumerate(ARMS):
        print(("\n" if i else "") + f"== {banner} ==")
        out[arm] = serve_mod.main(COMMON + extra + ["--device", args.device])
    dense, stem, streaming, mono = (out[a] for a, _, _ in ARMS)
    print(f"\nthroughput dense {dense['throughput_tok_s']:.1f} tok/s vs stem "
          f"{stem['throughput_tok_s']:.1f} tok/s vs streaming "
          f"{streaming['throughput_tok_s']:.1f} tok/s; inter-token p50 "
          f"{dense['p50_ms']:.2f} -> {stem['p50_ms']:.2f} -> "
          f"{streaming['p50_ms']:.2f} ms; chunked vs monolithic p95 "
          f"{stem['p95_ms']:.2f} vs {mono['p95_ms']:.2f} ms")
    return out


if __name__ == "__main__":
    main()
