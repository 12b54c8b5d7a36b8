"""Dry run of the mesh steps on the production mesh (port of
``repro/launch/dryrun.py``).

For each cell of the assigned archs (``configs.shapes_for``: ``train_4k``,
``prefill_32k``, ``decode_32k``, and ``long_500k`` for the sub-quadratic
archs) this builds the production mesh over ``meta`` devices (16 x 16, or
2 x 16 x 16 with ``--multi-pod``), places the step's arguments in the
rules' blocks (shapes only: nothing is allocated) and runs the step once
inside ``sharding.context.use``, as the reference lowers it:

* ``train_4k``: the mesh train step (``remat=True``, the config's
  microbatches, no sparsity policy) over the ZeRO-1 state and the batch;
* ``prefill_32k``: the mesh prefill step (``steps.mesh_prefill_step``)
  with ``steps.default_stem_cfg(cfg)`` (the paper's Stem where the arch
  uses it) over the parameters and the batch;
* ``decode_32k`` / ``long_500k``: the dense mesh serve step
  (``steps.mesh_serve_step``) over the parameters, the tokens and the
  caches (``registry.abstract_caches``, in ``rules.cache_shardings``'
  blocks), updated in place as the reference's donated caches are.

``launch/cost_analysis.CostMode`` counts every operator, kernel and
collective per mesh coordinate; the kernels take their shape-only paths.
A block-sparse call's causal pairs are counted by the policy's budgets
where they fix them (``SparsityPolicy.prefill_live_counts``: a budget-driven
selector, exactly), else by the bound of every slot live; the record's
``pairs`` names the rule (``block_sparse_pairs`` the counts by rule).  The
step runs the first data shard only (``data_shards=1``): every data shard
runs the same program on rows of the same shape.  The record is that of
the worst coordinate of that data shard (the largest roofline term; each
model shard's count is its own, and ``per_model_shard`` lists them all),
with the reference's keys:

* ``flops_per_device``, ``bytes_per_device`` (fusion-ideal),
  ``bytes_per_device_nofusion``, ``flops_by_op``, ``collectives``;
* ``memory``: ``argument_bytes`` (the coordinate's blocks of the step's
  arguments, exactly: the master, mu, nu and the batch; the parameters and
  the batch; the parameters, the tokens and the caches), ``temp_bytes``
  (the peak of the bytes of the tensors the step made on the coordinate
  and still held: ``cost_analysis``'s ``peak``), ``output_bytes`` (the
  coordinate's logits block, and the prefill's cache blocks; 0 for the
  train step: the state is updated in place, as the reference's donated
  state is), ``peak_bytes`` (arguments + temporaries);
* ``roofline``: ``compute_s``, ``memory_s``, ``collective_s`` at the
  H100 SXM data sheet's rates (``PEAK_FLOPS``, ``HBM_BW``, ``LINK_BW``:
  data-sheet figures, not measurements) and the ``bottleneck``;
* ``model_flops_total`` (6 N_active D for train, 2 N_active D for the
  prefill and decode, D the batch's tokens: one a row for decode) and
  ``model_flops_ratio`` (over ``flops_per_device`` times the mesh's
  devices);
* ``fits``: ``peak_bytes`` within the card's 80 GiB.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --out DIR

``--stem`` (a policy in the train step; the reference has no such flag)
exits 2.  A cell that fails is named and the run exits 1.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback

import torch

from repro_torch import configs, optim
from repro_torch.kernels import cost as kernel_cost
from repro_torch.launch import cost_analysis
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.models import registry
from repro_torch.optim.adamw import tree_leaves
from repro_torch.sharding import arrays
from repro_torch.sharding import context as shctx
from repro_torch.sharding import rules as rules_lib

# NVIDIA H100 SXM data sheet (the roofline's denominators, not measurements)
PEAK_FLOPS = 989e12        # dense bf16 flop/s
HBM_BW = 3.35e12           # HBM3 bytes/s
LINK_BW = 450e9            # NVLink bytes/s, one direction
CARD_BYTES = 80 * 2 ** 30

STEM_REFUSAL = ("--stem: the reference's dry run lowers its train step without a "
                "sparsity policy and its prefill with the paper's; it takes no --stem")


def block_bytes(mesh, trees) -> dict:
    """{coordinate: bytes of its blocks of every ``ShardedArray`` leaf of
    ``trees``}."""
    out = {c: 0 for c in mesh.coords()}
    for arr in _sharded_leaves(trees):
        for c in out:
            t = arr.blocks[c]
            out[c] += t.numel() * t.element_size()
    return out


def _sharded_leaves(tree) -> list:
    if isinstance(tree, arrays.ShardedArray):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _sharded_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _sharded_leaves(v)]
    return []


def argument_bytes(mesh, state, batch) -> dict:
    """{coordinate: bytes of its blocks of the state and the batch}; the
    step counter is replicated (4 bytes a coordinate)."""
    step = state.step.numel() * state.step.element_size()
    return {c: n + step for c, n in block_bytes(
        mesh, [state.master, state.mu, state.nu, list(batch.values())]).items()}


def setup(cfg, mesh, shape):
    """(step, placed state, placed batch, their argument bytes) of a train
    cell on ``mesh``."""
    bundle = registry.build(cfg)
    av, ax = bundle.abstract_params()
    param_sh = rules_lib.param_shardings(cfg, mesh, av, ax)
    opt_cfg = optim.AdamWConfig(moment_dtype="bfloat16" if cfg.fsdp_weights else "float32")
    state_sh = steps_lib.opt_state_shardings(cfg, mesh, param_sh, av)
    state = steps_lib.place_state(steps_lib.abstract_opt_state(av, opt_cfg), state_sh)
    specs = registry.input_specs(cfg, shape)
    batch_sh = rules_lib.batch_sharding(cfg, mesh, specs)
    batch = {k: arrays.place(v, batch_sh[k], copy=False) for k, v in specs.items()}
    step = steps_lib.mesh_train_step(bundle, opt_cfg, state_sh.master, stem_cfg=None,
                                     remat=True, microbatches=cfg.train_microbatches,
                                     data_shards=1)
    return step, state, batch, argument_bytes(mesh, state, batch)


_PAPER = object()


def setup_serving(cfg, mesh, shape, stem_cfg=_PAPER):
    """(step, its arguments, their argument bytes) of a prefill or decode
    cell on ``mesh``: the parameters in ``rules.param_shardings``' blocks,
    the batch (prefill) or the tokens and the caches (decode).  The
    prefill's policy is ``stem_cfg``, by default
    ``steps.default_stem_cfg(cfg)`` (the reference's)."""
    if stem_cfg is _PAPER:
        stem_cfg = steps_lib.default_stem_cfg(cfg)
    bundle = registry.build(cfg)
    av, ax = bundle.abstract_params()
    param_sh = rules_lib.param_shardings(cfg, mesh, av, ax)
    params = rules_lib.tree_map(lambda v, sh: arrays.place(v, sh, copy=False), av, param_sh)
    specs = registry.input_specs(cfg, shape)
    batch_sh = rules_lib.batch_sharding(cfg, mesh, specs)
    batch = {k: arrays.place(v, batch_sh[k], copy=False) for k, v in specs.items()}
    if shape.kind == "prefill":
        step = steps_lib.mesh_prefill_step(bundle, mesh, max_len=shape.seq_len,
                                           stem_cfg=stem_cfg, data_shards=1)
        args = (params, batch)
    else:
        caches = registry.abstract_caches(cfg, shape)
        cache_sh = rules_lib.cache_shardings(cfg, mesh, caches)
        caches = rules_lib.tree_map(lambda v, sh: arrays.place(v, sh, copy=False),
                                    caches, cache_sh)
        step = steps_lib.mesh_serve_step(bundle, mesh, data_shards=1)
        args = (params, batch["tokens"], caches)
    return step, args, block_bytes(mesh, list(args))


def count_step(cfg, mesh, shape) -> tuple:
    """Run the cell's step under ``CostMode``: (per-coordinate costs,
    argument bytes, seconds)."""
    costs, args, _, seconds = count_cell(cfg, mesh, shape)
    return costs, args, seconds


def count_cell(cfg, mesh, shape, stem_cfg=_PAPER) -> tuple:
    """``count_step``, with each coordinate's output bytes: (costs,
    argument bytes, output bytes, seconds).  ``stem_cfg``: the prefill's
    policy (``setup_serving``)."""
    if shape.kind == "train":
        step, state, batch, args = setup(cfg, mesh, shape)
        call = (state, batch)
    else:
        step, call, args = setup_serving(cfg, mesh, shape, stem_cfg)
    mode = cost_analysis.CostMode(default=mesh.coords()[0])
    t0 = time.time()
    with torch.no_grad() if shape.kind != "train" else contextlib.nullcontext(), \
            shctx.use(cfg, mesh), kernel_cost.counting(mode), mode:
        out = step(*call)
    seconds = time.time() - t0
    if shape.kind == "train":
        outputs = {c: 0 for c in mesh.coords()}
    else:        # the logits, and the prefill's caches (the serve step's are the arguments')
        outputs = block_bytes(mesh, [out[0]] + ([out[1]] if shape.kind == "prefill" else []))
    return mode.costs, args, outputs, seconds


def roofline(flops: float, nbytes: float, coll: float) -> dict:
    terms = {"compute_s": flops / PEAK_FLOPS, "memory_s": nbytes / HBM_BW,
             "collective_s": coll / LINK_BW}
    return {**terms, "bottleneck": max(terms, key=terms.get)}


def _bound(cost) -> float:
    r = roofline(cost.flops, cost.bytes_min, cost.coll_bytes)
    return max(r["compute_s"], r["memory_s"], r["collective_s"])


def run_cell(arch: str, shape_name: str = "train_4k", *, multi_pod: bool = False,
             cfg=None, mesh=None) -> dict:
    """The dry run of one cell (the module docstring): its record."""
    shape = {s.name: s for s in configs.ALL_SHAPES}[shape_name]
    cfg = cfg or configs.get_config(arch)
    mesh = mesh or mesh_lib.make_production_mesh(multi_pod=multi_pod)
    rec: dict = {"arch": arch, "shape": shape_name,
                 "mesh": "x".join(str(n) for n in mesh.grid), "chips": mesh.size,
                 "multi_pod": multi_pod, "rates": "NVIDIA H100 80GB HBM3 SXM data sheet "
                 "(989e12 bf16 flop/s, 3.35e12 HBM B/s, 450e9 NVLink B/s a direction)"}
    costs, args, outputs, seconds = count_cell(cfg, mesh, shape)
    rec["count_s"] = round(seconds, 2)
    lead = mesh.coords()[0]
    shard = shctx.model_shards_of(mesh, lead).coords if "model" in mesh.axis_names \
        else (lead,)
    worst = max(shard, key=lambda c: _bound(costs[c]))
    c = costs[worst]
    rec["coordinate"] = list(worst)
    rec["flops_per_device"] = c.flops
    rec["bytes_per_device"] = c.bytes_min
    rec["bytes_per_device_nofusion"] = c.bytes
    rec["flops_by_op"] = dict(c.flops_by_op)
    rec["collectives"] = {"counts": dict(c.coll_counts), "bytes_by_op": dict(c.coll_by_op),
                          "total_bytes": c.coll_bytes}
    rec["kernel_calls"] = dict(c.kernel_calls)
    pairs = {}
    for k in shard:
        for rule, n in costs[k].kernel_pairs.items():
            pairs[rule] = pairs.get(rule, 0.0) + n
    rec["block_sparse_pairs"] = pairs        # the data shard's, by rule
    rec["pairs"] = "+".join(sorted(pairs)) or None
    rec["memory"] = {"argument_bytes": int(args[worst]), "output_bytes": int(outputs[worst]),
                     "temp_bytes": int(c.peak),
                     "peak_bytes": int(args[worst] + c.peak)}
    rec["roofline"] = roofline(c.flops, c.bytes_min, c.coll_bytes)
    rec["per_model_shard"] = [
        {"coordinate": list(k), "flops": costs[k].flops, "bytes": costs[k].bytes_min,
         "collective_bytes": costs[k].coll_bytes, "temp_bytes": int(costs[k].peak),
         "argument_bytes": int(args[k])} for k in shard]
    total_p, active_p = registry.param_counts(cfg)
    tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    rec["model_flops_total"] = (6.0 if shape.kind == "train" else 2.0) * active_p * tokens
    total = rec["flops_per_device"] * mesh.size
    rec["model_flops_ratio"] = rec["model_flops_total"] / total if total else 0.0
    rec["fits"] = rec["memory"]["peak_bytes"] <= CARD_BYTES
    return rec


def cells(arch_filter: str, shape_filter: str):
    for name in sorted(configs.ASSIGNED):
        if arch_filter not in ("all", name):
            continue
        for shape in configs.shapes_for(configs.get_config(name)):
            if shape_filter in ("all", shape.name):
                yield name, shape.name


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--stem", action="store_true",
                    help="a sparsity policy in the train step (not supported: exits 2)")
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)
    if args.stem:
        print(f"dryrun: {STEM_REFUSAL}", file=sys.stderr)
        raise SystemExit(2)
    if args.arch != "all" and args.arch not in configs.ASSIGNED:
        print(f"dryrun: unknown arch {args.arch!r} (one of {sorted(configs.ASSIGNED)})",
              file=sys.stderr)
        raise SystemExit(1)
    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch, shape in cells(args.arch, args.shape):
        tag = f"{arch}__{shape}__{'multipod' if args.multi_pod else 'pod'}"
        out_path = os.path.join(args.out, tag + ".json")
        print(f"=== {tag} ===", flush=True)
        try:
            rec = run_cell(arch, shape, multi_pod=args.multi_pod)
            with open(out_path, "w") as f:
                json.dump(rec, f, indent=1)
            r, m = rec["roofline"], rec["memory"]
            print(f"  counted in {rec['count_s']} s: flops/dev={rec['flops_per_device']:.3e}"
                  f" bytes/dev={rec['bytes_per_device']:.3e}"
                  f" coll={rec['collectives']['total_bytes']:.3e}B"
                  f" peak={m['peak_bytes'] / 2 ** 30:.2f} GiB fits={rec['fits']}"
                  f" bottleneck={r['bottleneck']}", flush=True)
        except Exception as e:
            failures.append((tag, str(e)))
            with open(out_path + ".err", "w") as f:
                f.write(traceback.format_exc())
            print(f"  FAILED: {e}", flush=True)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for tag, err in failures:
            print(f"  {tag}: {err[:200]}")
        raise SystemExit(1)
    print("\nall cells counted")


if __name__ == "__main__":
    main()
