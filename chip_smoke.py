"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --profile  # also trace phase 4 and phase 11's
                                     # loops with torch.profiler
    python3 chip_smoke.py --profile-prefill  # also trace phase 5's,
                                             # phase 13's and phase 14's
                                             # prefills
    python3 chip_smoke.py --parent DIR       # phase 3c against a tree of
                                             # the parent commit (default:
                                             # git archive HEAD^ in a git
                                             # checkout; else skipped)

Phases:
  1. device   — require CUDA; print the card's name and power limit.
  2. build    — compile every kernel source under
                src/repro_torch/kernels/csrc/ with nvcc (sm_90a) into
                build/kernels/, one nvcc per source started together, timed;
                print each kernel's registers, stack and local memory
                (cuobjdump -res-usage: spills would show as stack / local
                bytes) and, for every template instance of the tensor-core
                attention kernels (flash and block-sparse at each pair of
                WGMMA_PAIRS, with and without the lse store; the paged
                chunk lane; the backward's four), its HGMMA count in the
                SASS: each must hold some, the flash and block-sparse
                instances must be exactly WGMMA_PAIRS, and the forward
                ones must use no stack or local memory (but block-sparse
                at (256, 256), a known spill: logged).
  3. kernels  — each kernel against its plain PyTorch version, in fp32 and
                bf16: the paged kernels at the serving shapes of qwen3-0.6b
                (hq 16, hk 8, d 128, block 128, stride 16, 126 pages per
                row; decode b=4, chunk 1024, the chunk scorer with the
                anti-diagonal pairing folded in); the one-shot prefill
                kernels (block-sparse attention under the TPD selection of
                "stem", also with group_dedup and with cnt == 0 rows; flash
                attention, also against scaled_dot_product_attention; the
                pool and value-magnitude kernels) at a 16384-token prompt,
                the pool also at the chunk lane's shapes (q (1, 16,
                1024, 128) and k (1, 8, 1024, 128), bf16 -> bf16)
                and vmag at a chunk's (v (1, 8, 1024, 128) bf16); flash and
                block-sparse also at head_dim 64 and 256 (a 4096-token
                prompt, bf16 on the tensor-core tile's instances of those
                pairs, whose counters must move; flash beside SDPA,
                block-sparse beside flex_attention).
                fp32 outputs within 1e-4 abs; bf16 outputs within 2 bf16
                ulps of the plain output plus 1e-3 * the max|plain| of the
                element's row (last axis), except the bf16 attention on the
                tensor-core tile (flash, block-sparse, the paged chunk
                lane), which rounds P to bf16 before P.V: its row floor is
                1e-2 * max|plain| (kernels.forward_route: bf16 flash and
                block-sparse at (64, 64), (128, 128), (192, 128), (192,
                192), (256, 256), blocks of a multiple of 128).  The same
                rule must reject the block-sparse kernel's output with one
                key tile dropped from each row past 4k (2k at 4096 tokens;
                the selection of each bf16 attention check: stem's, and
                every causal block for flash), and the
                chunk lane's output with the last live page dropped from
                each row that has two or more.  Both page-attention lanes
                also write exact zeros for cnt == 0 rows.
                Kernel, plain and library times are device times from CUDA
                events around calls queued behind a device-side sleep (so a
                call's host work does not count), with each kernel's TFLOP/s
                and share of its bound; each kernel's time a call back to
                back (host work included) is printed beside it.  The library calls
                are compiled flex_attention over a BlockMask of the same
                selection (block-sparse attention; page attention over the
                flattened pool, both lanes) and SDPA (flash), each timed
                and checked against the plain output, never called by the
                port.  The page scorer has none (no single call gathers
                the page table's summaries and contracts them).
  3c. parent  — with a tree of the parent commit (--parent DIR, or git
                archive HEAD^ in a git checkout): the (128, 128) flash and
                block-sparse instances and the paged chunk lane built from
                both trees, each run in its own process on phase 3's bf16
                inputs (16 / 8 heads, 16k tokens, stem's selection; the
                chunk lane's 1024-token chunk): outputs bitwise equal to
                the parent's, and each one's device time, timed parent,
                change, change, parent, at most 1.05x the parent's.
  4. engine   — StemEngine at the full width of qwen3-0.6b (bf16, random
                weights from a seeded generator, policy "stem" with paper
                defaults, budget_frac 0.5, chunk 1024, 2 slots) serves four
                staggered requests (prompts 2000/6000/11000/16000 tokens, 32
                new tokens each) with chunked prefill.  Launch counters are
                zeroed just before the run and read just after; every kernel
                of both lanes must have launched, and the pool and vmag
                kernels (chunk query pooling, page summaries); every logit the engine
                samples must be finite (its "greedy-finite" sampler folds
                that into one device flag, read after the run), every page
                must return.
  5. prefill  — the one-shot prefill (transformer.prefill) of one
                16384-token prompt at full width, under "stem" (block-sparse,
                pool and vmag kernels) and dense (stem_cfg=None: the flash
                kernel); ms and realized density of each, counters zeroed
                before each run and read after.
  6. monolithic — the phase-4 trace under EngineConfig(monolithic_prefill=
                True), then one 4096-token and one 100-token request under
                "xattention" (the 100-token prompt is one block: the dense
                arm); counters zeroed before and read after; every kernel
                of the path (decode-lane paged kernels, block-sparse, flash,
                pool, vmag) must have launched; the phase-4 checks hold.
  7. parity   — full width, 2 layers, fp32: the "fused" and "gather"
                executors serve one short trace with chunked prefill and
                with monolithic prefill, and run one 4096-token one-shot
                prefill; greedy streams must be equal (or the logits at a
                split differ by < 1e-3), prefill logits within 1e-4 and
                selections equal.
  8. small    — the small configurations the reference's suites serve:
                tests/test_engine.py's config (head_dim 8, block 8, stride
                4) and the reduced qwen3-0.6b (head_dim 16, block 128),
                fp32, each trace served under "fused" and "gather" on the
                card and under "fused" on the CPU (the plain versions),
                with chunked and with monolithic prefill; counters zeroed
                before each fused card run and read after (every kernel of
                the path must have launched); the three greedy streams must
                be equal.  The fused card run records the calls it makes
                to every kernel (kernels/replay.py: arguments and output,
                each new set of shapes and the 1st, 2nd, 4th, ... call)
                and holds each against its plain version on the recorded
                arguments (fp32 1e-4).  The reduced qwen3-0.6b is also
                served in bf16 (the CUDA-core tiles' bf16 loads and stores
                at head_dim 16): its recorded calls held to the bf16 rule
                of phase 3, its fused stream equal to "gather"'s.
  9. contiguous — the serving CLI (launch/serve.py main) on full-width
                qwen3-0.6b, bf16, "stem" at the CLI's geometry (block 128,
                stride 4): 2 requests of 2000-6000 tokens, 16 new tokens, in
                engine mode (chunked, the paged kernels) and --fixed-batch
                (ragged contiguous caches: flash prefill, then sparse decode
                re-summarizing the whole cache with the pool and vmag
                kernels every step); counters zeroed before and read after
                each; prints TTFT, ms per token and summarize_cache's share
                of the decode time (CUDA events around each call).  Then,
                each under a replay recorder whose kernel calls are held
                against the plain versions: the CLI runs again; the engine
                ("fused", decode at budget 1.0, chunk 1024) against
                contiguous prefill + sparse decode (the reference's oracle
                for the engine), 2 prompts of 1531 / 3907 tokens, 16 new
                tokens, fp32 (streams equal, or parted where both arms' logits
                rank the two tokens within 1e-3) and bf16 (reported: within
                phase 3's p_bf16 rule at the token or not); loss_fn (stem,
                dense) and forward_with_stats (stem) on one 8192-token
                sequence: CE, realized density per layer; glm4-9b (GQA
                group 16, untied fp32 head) through the CLI's run_engine
                (2 requests of 2048-4096 tokens) and run_fixed_batch (2 of
                4096, a sparse prefill), 8 new tokens, under "fused" and
                "gather": in fp32 at full width with the depth cut to 4
                layers (streams equal, or parted within 1e-3), and in bf16
                at 4 and 40 layers, reported with where the executors'
                chunk selections first differ, beside the 40-layer engine
                trace under "dense" (no selection to flip); peak memory.
 10. overload — full-width qwen3-0.6b, "stem" at paper defaults
                (budget_frac 0.5, chunk 1024), pools sized by
                EngineConfig.for_trace, counters zeroed before each arm and
                read after (every kernel of the engine path must launch).
                (a) bf16, 28 layers, one slot: one 6000-token request (32
                new) preempted after 2 chunks and again after 8 tokens,
                restored at the next admission each time: restored pages
                equal the pinned host snapshot bitwise, the stream equals
                the uninterrupted run's, chunks and prefills equal (zero
                recompute), every page back; snapshot bytes, preempt /
                restore ms and GB/s, and the link's raw pinned copy rate.
                (b) 2 slots: prompts of 4000 / 6000 / 8000 / 11000 tokens
                (32 new) at step 0 and two priority-1 requests of 2000
                tokens (16 new, TTFT SLO 2 s, TPOT SLO 0.2 s) at steps 2
                and 12, under scheduler "fcfs", "slo" and "slo" with the
                CLI's chaos plan (its restore failure moved to the trace's
                first restore step, found by a probe run): the SLO arms
                preempt a prefilling and a decoding victim and restore
                both, the chaos arm counts one alloc denial, one step
                failure and one restore failure and aborts nothing; fp32
                at 4 layers the three arms' streams are equal, bf16 at 28
                layers reported (check_partings); HP TTFT / TPOT, LP TPOT,
                wall, offload peak bytes and the restore bandwidth EMA per
                arm.  (c) The CLI (serve.main) with --hp-every 2
                --max-waiting 6 --chaos: no failed request, its
                engine_metrics line printed.
 11. prefix + async — full-width qwen3-0.6b, "stem" at paper defaults
                (budget_frac 0.5, chunk 1024, page 128, 2 slots),
                counters zeroed before each arm and read after (every
                kernel of the engine path must launch).  (a) A 4096-token
                system prompt (32 pages) behind suffixes of 300 / 900 /
                1500 / 2100 tokens arriving at steps 0 / 0 / 6 / 10 and the
                bare prompt at step 10 (a copy on write), 32 new tokens
                each, with the prefix cache off and on: hits >= 2, pages
                shared >= 64, one copy on write, fewer chunks, every page
                back; fp32 at 4 layers the streams equal strictly (the "on"
                arm's kernel calls recorded and held against their plain
                versions), also under prefix_evict="hit-rate" with a pool
                that forces reclaims of cached pages and through the async
                loop; bf16 at 28 layers reported (check_partings); the late
                tenants' TTFT.  (b) fp32, 4 layers: a sharer preempted by a
                priority-1 request snapshots its private pages only, its
                shared pages keep their references while it is out, and its
                restored stream equals the uninterrupted run's.  (c) Phase
                10 (b)'s trace through the sync and the async loop, fp32 at
                4 layers (also with a mid-stream EOS: a lookahead step
                discarded; and under the CLI's chaos plan with its restore
                failure at the async run's first restore) and bf16 at 28
                layers: streams bitwise equal, host_syncs <= 2 * finished,
                step_calls <= id_fetches <= 2 * step_calls, nothing in
                flight at the end, every _dispatch run under
                torch.cuda.set_sync_debug_mode("error"); wall, TTFT, TPOT
                and tok/s of both loops (with --profile also each loop's
                device busy share).  (d) The CLI with --prefix-cache
                --async-depth 1 and with --prefix-cache --prefix-evict
                hit-rate: no failed request.
 12. arctic   — the MoE family: arctic-480b at its published widths
                (d_model 7168, 56 query / 8 KV heads: GQA group 7, head_dim
                128, 128 experts top-2 of d_ff 4864, the parallel dense
                residual FFN of d_ff 4864, vocab 32000, untied head) with
                its depth cut from 35 layers to what one 80 GB card holds:
                2 layers in bf16 (2 x 27.22 GB of layers, 26.78 GB of each
                the expert tables, plus the fp32 embedding and head) and 1
                in fp32; random weights drawn on the card from a seeded
                generator in slices of at most 1 GiB.  (a) bf16 2 layers:
                phase 4's chunked trace ("stem" at paper defaults, budget
                0.5, chunk 1024, 2 slots), counters zeroed before and read
                after (every kernel of the engine path), every kernel call
                recorded and held against its plain version (group 7);
                TTFT, TPOT, tok/s, peak memory, the MoE FFN's device ms
                per lane and layer (CUDA events) beside two bounds of its
                expert products (every expert's weights read once, as the
                static capacity buffer does, and the routed experts'
                alone), dropped (token, k) slots per lane.  (b) The same
                weights: phase 11's shared-prefix trace with the prefix
                cache on through the sync and the async loop, every
                _dispatch under set_sync_debug_mode("error"), streams
                equal.  (d) The CLI's run_engine and run_fixed_batch on the
                same weights ("fused", kernel calls held against the plain
                versions).  (c) fp32 1 layer: "fused" == "gather" on a
                chunked trace of 1531 / 3907 / 2600 tokens, and the
                monolithic engine (budget 1.0) == a 1-request fixed batch
                (one-shot prefill of the same 4096 tokens, then sparse
                contiguous decode) over 16 new tokens, or parted at a tie
                within 1e-3.
 13. deepseek — MLA and deepseek-v3-671b, the paper's DSA + Stem backbone.
                (d) flash and block-sparse attention at MLA's head dims
                (q/k 192 with v 128, and the MTP layer's 192 / 192), 128
                heads, a 16384-token prompt under stem's selection: fp32 on
                the CUDA-core tile, bf16 on the tensor-core tile's
                instances (their counters must move), against the plain
                versions (the p_bf16 rule, which must reject a dropped key
                tile),
                bf16 timed beside the bound, SDPA and flex_attention where
                they take the shape; the reduced config's (24, 16) checked.
                Then the model at its published widths (d_model 7168, 128
                heads, MLA q rank 1536 / latent 512 / rope 64 / nope 128 /
                v 128, 256 experts top-8 of d_ff 2048 + a shared expert,
                first_k_dense 3 of d_ff 18432, vocab 129280, untied head,
                the MTP head) with its depth cut from 61 layers: (a) bf16 4
                layers (3 mla_dense + 1 mla_moe; 33.2 GiB of weights drawn
                on the card): the CLI's --fixed-batch (dense: MLA decodes
                densely, as in the reference) on 3 prompts of 2000-6000
                tokens, 16 new tokens (TTFT, ms a token, peak memory, every
                kernel call held against its plain version); the engine
                modes and the policy-sparse fixed batch refused with the
                reference's NotImplementedError; (b) one 16384-token
                one-shot prefill, stem against dense (ms, realized density,
                launches, the (192, 128) tensor-core instances among them;
                device time by kernel with --profile-prefill);
                (c) fp32 2 layers (first_k_dense cut to 1): "fused" ==
                "gather" prefill logits and greedy streams, loss_fn's ce /
                mtp_ce / aux equal under fused, gather, the dense oracle
                executor and dense attention.

 14. families — the SSM, hybrid, encoder-decoder and VLM-stub families at
                their published widths and full depth, random weights drawn
                on the card from a seeded generator, one family at a time
                (each frees its weights before the next).  (a) mamba2-370m
                (48 SSD layers) bf16: a 16384-token prefill and 32 greedy
                decode steps (ms, ms a token); fp32 at 4 layers: decode
                after prefill(1000) == prefill(1001)'s logits within 1e-4.
                (b) recurrentgemma-2b (26 layers: 8 x (rec, rec, local) + 2
                rec) bf16: an 8192-token prompt (past the 2048 window), 32
                decode steps over the 2048-slot ring caches, peak memory;
                fp32 at 4 layers: the same check at n = 2100.  (c)
                whisper-medium (24 + 24 layers) bf16: 1500 stub frames and
                a 4096-token decoder prompt prefilled under stem at the
                CLI's geometry (block 128, stride 4, sink 1, local 1, min
                budget 2) and dense: realized density, kernels 3, 5, 6
                launched under stem and 4 dense, all at head_dim 64 (3 and 4
                on their (64, 64) tensor-core instances), every
                call recorded and held against its plain version, layer
                0's calls timed beside their bound, SDPA / flex_attention
                / a mean; loss_fn at 4096 under both; 16 greedy decode
                steps; fp32 at 4 + 4 layers: "fused" == "gather" (2048
                tokens, prefill logits within 1e-4 of their scale, streams
                equal).  (d) pixtral-12b (40 layers) bf16: 4096 patch
                embeddings + 12288 text tokens prefilled one-shot under
                stem at the paper's defaults and dense (kernels 3-6
                launched, the attention calls on the wgmma tile, every call
                held against its plain version; with --profile-prefill the
                device's busy share), 16 decode steps; fp32 at 4 layers:
                "fused" == "gather" (512 patches + 1536 tokens).  (e)
                gemma-2b (18 layers, 8 query heads over one KV head,
                head_dim 256) bf16: an 8192-token prompt prefilled under
                stem at the paper's defaults and dense, kernels 3 and 4 on
                their (256, 256) tensor-core instances, every call held
                against its plain version.

 15. train    — the training path (python -m repro_torch.launch.train).
                (a) The backward kernels of flash and block-sparse
                attention at the training shapes of full-width qwen3-0.6b
                (b 2, 16 q / 8 KV heads, d 128, n 4096; block-sparse under
                the CLI's --stem geometry: block 128, stride 4, sink 1,
                local 1, min budget 2), fed the forward's saved
                log-sum-exp (held against the plain forward's): fp32 on
                the CUDA-core route against the plain backward (1e-4 abs),
                bf16 on the tensor-core route (wgmma; P and dS rounded to
                bf16) under the p_bf16 gradient rule (2 ulps + 1e-2 * the
                row's max|plain| + 1e-4 * the tensor's max), two calls
                bitwise equal (no atomics), the rule rejecting a (query
                block, key block) pair dropped from the transposed
                selection (dk / dv) and a selected block dropped from a
                row (dq); both routes timed beside the bound (2 * (3 d + 2
                dv) flops a causal pair), bf16 beside SDPA's backward
                (flash) and a compiled flex_attention's (block-sparse), and
                each wgmma kernel's own device time (torch.profiler);
                MLA's (192, 128) and whisper's d 64 checked once each on
                the CUDA-core route.  (b) The CLI's main() on full-width
                qwen3-0.6b, bf16, 28 layers, --seq 4096 --batch 2 --steps
                12, dense and --stem: the loss finite and the mean of the
                last 3 steps below the first 3; counters zeroed before and
                read after (dense: flash forward and backward, the wgmma
                route's counter too; stem: block-sparse forward and
                backward and its wgmma counter, pool, vmag); no plain
                attention version called;
                ms a step, tokens/s, peak memory, the backward kernels'
                share of the step (CUDA events around each call).  (c) fp32
                at full width with the depth cut to 4 layers: one step's
                loss, grad_norm and every gradient leaf under "fused" ==
                "gather" (within 1e-4 of each leaf's max|g|); 10 steps ==
                8 steps, a checkpoint, --restore and 2 more, bitwise;
                run_with_restarts around --fail-at 6 resumes from the
                step-4 checkpoint and its losses equal the uninterrupted
                run's, bitwise.

Prints a {"kernels": [...]} line, the nvidia-smi line, and as its last line
{"ok": true, "device": {...}}.  Any failed phase raises (non-zero exit).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import (ARCTIC_480B, DEEPSEEK_V3_671B, GEMMA_2B,  # noqa: E402
                                 GLM4_9B, MAMBA2_370M, PIXTRAL_12B, QWEN3_0_6B,
                                 RECURRENTGEMMA_2B, WHISPER_MEDIUM, reduced)
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.core import chunked as chunked_lib  # noqa: E402
from repro_torch.core import decode as decode_lib  # noqa: E402
from repro_torch.core import metric as metric_lib  # noqa: E402
from repro_torch.core import policy as policy_lib  # noqa: E402
from repro_torch.core.selection import selection_density  # noqa: E402
from repro_torch.kernels import WGMMA_PAIRS, forward_route, wgmma_counter  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import block_sparse_attn as bsa_kern  # noqa: E402
from repro_torch.kernels import flash_attention as flash_kern  # noqa: E402
from repro_torch.kernels import paged_attn as kern  # noqa: E402
from repro_torch.kernels import replay  # noqa: E402
from repro_torch.kernels import stem_metric as metric_kern  # noqa: E402
from repro_torch.kernels.replay import grad_tolerance, tolerance  # noqa: E402
from repro_torch.launch import serve as serve_lib  # noqa: E402
from repro_torch.launch import steps as steps_lib  # noqa: E402
from repro_torch.models import attention as attention_lib  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models import encdec as encdec_lib  # noqa: E402
from repro_torch.models import mla as mla_lib  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.runtime import chaos as chaos_lib  # noqa: E402
from repro_torch.runtime import engine as engine_lib  # noqa: E402
from repro_torch.runtime import offload as offload_lib  # noqa: E402
from repro_torch.runtime import sampling as sampling_lib  # noqa: E402

HBM_BYTES_S = 3.35e12        # H100 SXM data sheet
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
SOURCE = "src/repro_torch/kernels/csrc/paged_attn.cu"
REPLACES = {"score": "src/repro/kernels/paged_attn.py:142",
            "attend": "src/repro/kernels/paged_attn.py:249"}
# The one-shot prefill kernels: (record key, counter module, counter key,
# source, replaced TPU kernel).
PREFILL_KERNELS = (
    ("block_sparse_attention", bsa_kern, "block_sparse_attention",
     "src/repro_torch/kernels/csrc/block_sparse_attn.cu",
     "src/repro/kernels/block_sparse_attn.py:52"),
    ("flash_attention", flash_kern, "flash_attention",
     "src/repro_torch/kernels/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention.py:34"),
    ("antidiag_pool", metric_kern, "antidiag_pool",
     "src/repro_torch/kernels/csrc/stem_metric.cu",
     "src/repro/kernels/stem_metric.py:27"),
    ("value_magnitude", metric_kern, "value_magnitude",
     "src/repro_torch/kernels/csrc/stem_metric.cu",
     "src/repro/kernels/stem_metric.py:57"),
)
COUNTERS = (kern, bsa_kern, flash_kern, metric_kern)
# The served trace of phases 4 and 6: prompt lengths, arrival steps, new
# tokens per request.
PROMPTS, ARRIVALS, NEW_TOKENS = (2000, 6000, 11000, 16000), (0, 0, 2, 4), 32


def reset_all_launches() -> None:
    for mod in COUNTERS:
        mod.reset_launches()


def read_all_launches() -> dict:
    out = {}
    for mod in COUNTERS:
        out.update(mod.LAUNCHES)
    return out


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> tuple:
    """(device ms, host-bound ms) per call.  The second: CUDA events around
    `iters` back-to-back calls, so a call whose host work (checks, launches)
    outlasts its kernels measures the host.  The first: the same calls
    queued behind a device-side sleep that outlasts their enqueueing, with
    the start event after the sleep, so the card runs them back to back and
    the events see its time alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)

    def run() -> float:
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / iters

    host = run()
    # 1.5x the host-bound run + 1 ms, at ~2e6 cycles a ms (H100 at <= 2 GHz)
    torch.cuda._sleep(int(2e6 * (1.5 * host * iters + 1.0)))
    return run(), host


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name: str, got: torch.Tensor, want: torch.Tensor, *,
                p_bf16: bool = False) -> float:
    """Raises unless every element is within its tolerance; returns the max
    |kernel - plain|."""
    dtype = got.dtype
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output not finite")
    diff = (got - want).abs()
    over = float((diff / tolerance(want, dtype, p_bf16)).max())
    if p_bf16:
        log(f"[kernels] {name}: max |kernel - plain| / limit {over:.3f}")
    if not over <= 1:
        raise AssertionError(f"{name}: max |kernel - plain| = {float(diff.max())}, "
                             f"{over:.2f}x its limit")
    return float(diff.max())


def check_rejects_dropped_tile(name, q, k, v, idx, cnt, want, bs,
                               p_bf16: bool = True, past_token: int = 4096) -> None:
    """The bf16 attention rule (the tensor-core tile's p_bf16 rule, or the
    CUDA-core tile's 1e-3 one) must see the long rows: the block-sparse
    kernel over the selection (idx, cnt) passes it, and fails it once the
    last live block of each row past ``past_token`` (with two or more) is
    dropped."""
    check_close(f"{name}/block-sparse kernel, same selection",
                bsa_kern.block_sparse_attention(q, k, v, idx, live_counts=cnt,
                                                block_size=bs), want, p_bf16=p_bf16)
    past = (torch.arange(idx.shape[2], device=idx.device) * bs >= past_token) & (cnt >= 2)
    got = bsa_kern.block_sparse_attention(
        q, k, v, idx, live_counts=torch.where(past, cnt - 1, cnt).to(torch.int32),
        block_size=bs).float()
    want = want.float()
    over = (got - want).abs() / tolerance(want, torch.bfloat16, p_bf16=p_bf16)
    rows = int((over > 1).any(-1).sum())
    log(f"[kernels] {name} with one key tile dropped from each row past {past_token}: "
        f"{rows} of {int(past.sum()) * bs} such rows over the limit, max "
        f"{float(over.max()):.2f}x")
    if rows == 0:
        raise AssertionError(f"{name}: the bf16 rule passes a dropped key tile")


def check_rejects_dropped_page(name, args, want, bs) -> None:
    """The p_bf16 rule must see the chunk lane's rows: the chunk kernel's
    output with the last live page dropped from every row that has two or
    more (args as attend_pages takes them) must be over the limit in most
    of those rows."""
    q, k, v, gp, idx, cnt, pos = args
    faulted = cnt >= 2
    got = kern.attend_pages(q, k, v, gp, idx,
                            torch.where(faulted, cnt - 1, cnt).to(torch.int32),
                            pos, block_size=bs, causal=True, lane="chunk").float()
    want = want.float()
    over = (got - want).abs() / tolerance(want, torch.bfloat16, p_bf16=True)
    bad = int((over > 1).any(-1)[faulted].sum())
    rows = int(faulted.sum()) * q.shape[3]
    log(f"[kernels] {name} with the last live page dropped from each row with "
        f"two or more: {bad} of {rows} such rows over the limit, max "
        f"{float(over.max()):.2f}x")
    if not 2 * bad > rows:
        raise AssertionError(f"{name}: the bf16 rule passes a dropped page")


def check_zero_rows(name, args, *, bs, causal, lane) -> None:
    """Rows with cnt == 0 (every 7th row here) finalize to exact zeros, and
    the other rows still match the plain version."""
    cnt0 = args[5].clone()
    cnt0.view(-1)[::7] = 0
    a0 = args[:5] + (cnt0,) + args[6:]
    got = kern.attend_pages(*a0, block_size=bs, causal=causal, lane=lane)
    want = kern.attend_pages_plain(*a0, block_size=bs, causal=causal)
    torch.cuda.synchronize()
    check_close(name, got, want, p_bf16=causal and got.dtype == torch.bfloat16)
    if not bool((got[cnt0 == 0] == 0).all()):
        raise AssertionError(f"{name}: cnt == 0 rows are not exact zeros")


def check_library(name: str, lib: torch.Tensor, want: torch.Tensor) -> float:
    """A library call against the port: fp32 within 1e-4 abs; bf16 within
    1e-2 * max|lib| (library kernels may round the probabilities to bf16)."""
    err = float((lib.float() - want.float()).abs().max())
    limit = 1e-4 if lib.dtype == torch.float32 else float(
        1e-2 * lib.float().abs().max())
    log(f"[kernels] {name}: max_abs_err={err:.3e} (limit {limit:.3e})")
    if not err <= limit:
        raise AssertionError(f"{name}: library call disagrees")
    return err


# The tensor-core attention kernels: each template instance of these must
# hold HGMMA in its SASS and build with no stack or local memory (a spill of
# the tile's registers); the flash and block-sparse ones, forward and
# backward, are built once for each pair of WGMMA_PAIRS.
WGMMA_KERNELS = ("flash_wgmma_kernel", "block_sparse_wgmma_kernel", "attend_chunk_wgmma_kernel",
                 "flash_bwd_dq_wgmma_kernel", "flash_bwd_dkdv_wgmma_kernel",
                 "block_sparse_bwd_dq_wgmma_kernel", "block_sparse_bwd_dkdv_wgmma_kernel")
WGMMA_PAIRED = {"flash_attention": ("flash_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
                                    "flash_bwd_dkdv_wgmma_kernel"),
                "block_sparse_attn": ("block_sparse_wgmma_kernel",
                                      "block_sparse_bwd_dq_wgmma_kernel",
                                      "block_sparse_bwd_dkdv_wgmma_kernel")}
# Forward instances known to spill: block-sparse at (256, 256) needs ~210
# registers a consumer thread (O's 128 accumulators, S's 32, P's 16 and the
# selection walk), above what ptxas gives the consumer warpgroups, and
# spills around each S product (PERF.md).  Logged, not failed; any other
# spill fails.
KNOWN_SPILLS = ("block_sparse_wgmma_kernel<256x256",)


def _demangle(names: list) -> dict:
    """{mangled: short name} with each template instance's shape and flag,
    e.g. "flash_wgmma_kernel<256x256 bn64, lse>"."""
    out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                         text=True).stdout.splitlines()
    short = {}
    for mangled, full in zip(names, out if len(out) == len(names) else names):
        m = re.search(r"([a-z_]+_kernel|[a-z_]+_partials)(<.*?>(?=\())?", full)
        name = m.group(1) if m else mangled
        shape = re.search(r"(Dkdv)?Shape<(\d+), (\d+), (\d+), \d+>(?:, (true|false))?", full)
        if shape:
            dkdv, d, dv, bn, lse = shape.groups()
            name += (f"<{d}x{dv} {'bk' if dkdv else 'bn'}{bn}"
                     f"{', lse' if lse == 'true' else ''}>")
        elif m and m.group(2):
            name += m.group(2).replace(" ", "")
        short[mangled] = name
    return short


def build_report(libs: dict) -> dict:
    """Registers, stack and local memory of every kernel (spills would show
    as stack / local bytes), and the tensor-core instructions (HGMMA in the
    SASS) of every instance of the tensor-core attention kernels: each must
    hold some and use no stack or local memory, but for KNOWN_SPILLS (flash
    and block-sparse at every pair of WGMMA_PAIRS, the forwards with and
    without the lse store, the two backward kernels; the paged chunk lane).
    Returns {library: {instance: (registers, stack, local, HGMMA count)}}
    for the tensor-core kernels."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    run = lambda *a: subprocess.run([cuobjdump, *a], check=True, capture_output=True,
                                    text=True).stdout
    out = {}
    for stem in sorted(libs):
        usage, name = {}, None
        for line in run("-res-usage", str(libs[stem])).splitlines():
            m = re.search(r"Function (\S+):", line)
            if m:
                name = m.group(1)
            m = re.search(r"REG:(\d+) STACK:(\d+).*LOCAL:(\d+)", line)
            if m and name is not None:
                usage[name] = tuple(int(x) for x in m.groups())
                name = None
        short = _demangle(list(usage))
        sass = {}
        if any(k in v for v in short.values() for k in WGMMA_KERNELS):
            for part in run("-sass", str(libs[stem])).split("Function : ")[1:]:
                sass[part.split(None, 1)[0]] = part.count("HGMMA")
        for mangled, (reg, stack, local) in usage.items():
            name = short[mangled]
            line = f"[build] {stem}: {name} {reg} registers, stack {stack} B, local {local} B"
            if not any(name.startswith(k) for k in WGMMA_KERNELS):
                log(line)
                continue
            hgmma = sass.get(mangled, 0)
            log(f"{line}, {hgmma} HGMMA")
            out.setdefault(stem, {})[name] = (reg, stack, local, hgmma)
            if hgmma == 0:
                raise AssertionError(f"{stem}: no wgmma in {name}")
            if stack + local:
                if not name.startswith(KNOWN_SPILLS):
                    raise AssertionError(f"{stem}: {name} spills ({stack} B stack, "
                                         f"{local} B local)")
                log(f"[build] {stem}: {name} spills ({stack} B stack): a known open item")
    for stem, kernels in WGMMA_PAIRED.items():
        for kernel in kernels:
            shapes = {re.search(r"<(\d+)x(\d+)", n).groups() for n in out.get(stem, {})
                      if n.startswith(f"{kernel}<")}
            if shapes != {(str(d), str(dv)) for d, dv in WGMMA_PAIRS}:
                raise AssertionError(f"{stem}: {kernel} instances {sorted(shapes)} are not "
                                     f"WGMMA_PAIRS")
    return out


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def flex_page_attention(args, *, bs: int, causal: bool, flex):
    """Page attention as one flex_attention call over the flattened pool:
    q (b, hq, nc * rows, d) against k / v (b, hk, P * bs, d), the pool
    broadcast over the batch rows (a stride-0 view), under a BlockMask whose
    KV blocks are the selected physical pages: those wholly visible to a
    query block as full blocks, the rest under a mask_mod that maps the
    physical page back to its logical position (decode: tok < len; chunk:
    tok <= query position).  Returns a thunk giving (b, hq, nc, rows, d)."""
    from torch.nn.attention.flex_attention import BlockMask
    q, k, v, gp, idx, cnt, pos = args
    b, hq, nc, rows, d = q.shape
    hk, P = k.shape[0], k.shape[1]
    dev = q.device
    kmax = gp.shape[-1]
    live = torch.arange(kmax, device=dev) < cnt[..., None].long()
    lo = idx.long() * bs
    if causal:
        qmin = (pos.long()[:, None, None, None]
                + (torch.arange(nc, device=dev) * rows)[None, None, :, None])
        qmax = qmin + rows - 1
    else:
        qmin = qmax = (pos.long() - 1)[:, None, None, None]
    full = live & (lo + bs - 1 <= qmin)
    part = live & ~full & (lo <= qmax)

    def pack(sel):
        order = torch.argsort((~sel).to(torch.int8), dim=-1, stable=True)
        ids = torch.zeros((b, hq, nc, P), dtype=torch.int32, device=dev)
        ids[..., :kmax] = torch.gather(gp, -1, order)
        return sel.sum(-1, dtype=torch.int32), ids

    # logical page index of each physical page per (row, head, q block);
    # -1 where it is not selected (column P takes the dead slots)
    logical = torch.full((b, hq, nc, P + 1), -1, dtype=torch.long, device=dev)
    logical.scatter_(-1, torch.where(live, gp.long(), P), idx.long())
    logical = logical[..., :P].contiguous()
    posl = pos.long()

    def mask_mod(b_, h_, q_idx, kv_idx):
        lg = logical[b_, h_, q_idx // rows, kv_idx // bs]
        tok = lg * bs + kv_idx % bs
        seen = (tok <= posl[b_] + q_idx) if causal else (tok < posl[b_])
        return (lg >= 0) & seen

    (pn, pi), (fn, fi) = pack(part), pack(full)
    mask = BlockMask.from_kv_blocks(pn, pi, fn, fi, BLOCK_SIZE=(128, bs),
                                    mask_mod=mask_mod, seq_lengths=(nc * rows, P * bs))
    qf = q.reshape(b, hq, nc * rows, d)
    kf = k.reshape(1, hk, P * bs, d).expand(b, hk, P * bs, d)
    vf = v.reshape(1, hk, P * bs, -1).expand(b, hk, P * bs, v.shape[-1])
    # the chunk lane's default bf16 config asks for 256 KiB of shared memory
    # (above the H100's 227 KiB); two stages fit
    opts = {"num_stages": 2} if causal else None
    return lambda: flex(qf, kf, vf, block_mask=mask, enable_gqa=True,
                        kernel_options=opts).reshape(b, hq, nc, rows, -1)


def kernel_phase(records: dict, dev=torch.device("cuda")) -> None:
    hq, hk, d, bs, s = 16, 8, 128, 128, 16
    group = hq // hk
    maxp, b = 126, 4
    P = 1 + b * maxp
    policy = policy_lib.get_policy("stem")
    from torch.nn.attention.flex_attention import flex_attention
    flex = torch.compile(flex_attention, dynamic=False)
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
        check_zero_rows(f"attend/decode/cnt0/{tag}", args, bs=bs, causal=False,
                        lane="decode")
        run_l = flex_page_attention(args, bs=bs, causal=False, flex=flex)
        check_library(f"attend/decode {tag} vs flex_attention", run_l(), at_p)
        rec_kernel(records, "score", "decode", tag, err, run_k, run_p,
                   score_bytes_flops(qp_bytes=q.numel() * 4, pt=pt, hk=hk, s=s,
                                     d=d, out=sc_p), torch.float32)
        live_pairs = live_kv_pages(gp, cnt, group)
        rec_kernel(records, "attend", "decode", tag, err_a,
                   lambda: kern.attend_pages(*args, block_size=bs, causal=False,
                                             lane="decode"),
                   lambda: kern.attend_pages_plain(*args, block_size=bs, causal=False),
                   attend_bytes_flops(args, at_p, live_pairs, bs, d, rows=1),
                   dtype, run_lib=run_l)

        # -- chunk lane (one lane, chunk 1024 at position 8192 of a
        #    16384-token padded prompt) ----------------------------------
        C, nc = 1024, 1024 // bs
        start = torch.tensor([8192], dtype=torch.int32, device=dev)
        ptc = pt[:1].contiguous()
        qc = torch.randn((1, hq, C, d), generator=gen, device=dev).to(dtype)
        # the chunk lane's pooled queries, the anti-diagonal pairing folded
        # into the scorer (pair=True) as chunk_page_scores runs it
        qpc = metric_lib.antidiag_pool(qc, bs, s).float()
        run_k = lambda: kern.score_pages(qpc, kg, ptc, group=group, scale=scale,
                                         lane="chunk", pair=True)
        run_p = lambda: kern.score_pages_plain(qpc, kg, ptc, group=group,
                                               scale=scale, pair=True)
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
        err_a = check_close(f"attend/chunk/{tag}", at_k, at_p,
                            p_bf16=dtype == torch.bfloat16)
        if dtype == torch.bfloat16:
            check_rejects_dropped_page("attend/chunk", args, at_p, bs)
            AB_INPUTS["attend/chunk"] = args
        check_zero_rows(f"attend/chunk/cnt0/{tag}", args, bs=bs, causal=True,
                        lane="chunk")
        run_l = flex_page_attention(args, bs=bs, causal=True, flex=flex)
        check_library(f"attend/chunk {tag} vs flex_attention", run_l(), at_p)
        rec_kernel(records, "attend", "chunk", tag, err_a,
                   lambda: kern.attend_pages(*args, block_size=bs, causal=True,
                                             lane="chunk"),
                   lambda: kern.attend_pages_plain(*args, block_size=bs, causal=True),
                   attend_bytes_flops(args, at_p, live_kv_pages(gp, cnt, group),
                                      bs, d, rows=bs),
                   dtype, run_lib=run_l)
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


def rec_kernel(records, kernel, lane, tag, err, run_k, run_p, bf, dtype,
               run_lib=None, iters=20, plain_iters=3):
    ms, host_ms = time_ms(run_k, iters=iters)
    plain_ms = time_ms(run_p, iters=plain_iters, warmup=1)[0]
    lib_ms = None if run_lib is None else time_ms(run_lib, iters=iters)[0]
    bound_ms, bound_by = bound(*bf, dtype)
    tflops = bf[1] / ms * 1e-9
    log(f"[kernels] {kernel}/{lane} {tag}: max_abs_err={err:.3e} "
        f"kernel {ms:.4f} ms ({host_ms:.4f} ms a call back to back), plain "
        f"{plain_ms:.4f} ms, library "
        f"{'-' if lib_ms is None else f'{lib_ms:.4f}'} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}); {tflops:.1f} TFLOP/s, {bound_ms / ms:.3f} of bound")
    records.setdefault(f"{kernel}/{lane}", {})[tag] = dict(
        max_abs_err=err, ms=ms, host_ms=host_ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms, tflops=tflops)


# ---------------------------------------------------------------------------
# Phase 3b: the one-shot prefill kernels against their plain versions
# ---------------------------------------------------------------------------

def causal_pairs(idx, cnt, bs) -> float:
    """(query, key) pairs the live selected blocks hold under the causal
    mask: B*B below the diagonal, B*(B+1)/2 on it."""
    live = torch.arange(idx.shape[-1], device=idx.device) < cnt[..., None].long()
    rows = torch.arange(idx.shape[2], device=idx.device)[None, None, :, None]
    diag = (idx.long() == rows) & live
    below = (idx.long() < rows) & live
    return float(below.sum()) * bs * bs + float(diag.sum()) * bs * (bs + 1) / 2


def bsa_bytes_flops(q, k, idx, cnt, group, dedup, bs, dv=None):
    """Bytes (q read, the output written at v's head dim dv, each selected
    K / V block read once, the selection) and flops (2 * (d + dv) a causal
    pair) of one block-sparse call; dv defaults to q's head dim."""
    d, es = q.shape[-1], q.element_size()
    dv = d if dv is None else dv
    hsel = idx.shape[1]
    live = torch.arange(idx.shape[-1], device=idx.device) < cnt[..., None].long()
    kvh = (torch.arange(hsel, device=idx.device) // (1 if dedup else group))
    key = (kvh[None, :, None, None].expand_as(idx).long() << 32) | idx.long()
    blocks = int(torch.unique(key[live]).numel())
    nbytes = (q.numel() * (d + dv) // d * es + blocks * bs * (d + dv) * es
              + (idx.numel() + cnt.numel()) * 4)
    heads = group if dedup else 1
    return nbytes, 2.0 * (d + dv) * causal_pairs(idx, cnt, bs) * heads


def flex_block_mask(idx, cnt, bs):
    """The selection (indices, live counts) as a flex_attention BlockMask:
    live blocks below the diagonal as full blocks, the diagonal block under
    the mask_mod, index lists padded to the nq key blocks.  The mask_mod
    also holds the selection (eager flex_attention reads only it)."""
    from torch.nn.attention.flex_attention import BlockMask
    b, h, nq, k_max = idx.shape
    dev = idx.device
    rows = torch.arange(nq, device=dev)[None, None, :, None]
    live = torch.arange(k_max, device=dev) < cnt[..., None].long()
    below = live & (idx.long() < rows)
    picked = torch.zeros((b, h, nq, nq), dtype=torch.int32, device=dev)
    picked = picked.scatter_add_(-1, idx.long(), live.to(torch.int32)) > 0
    order = torch.argsort((~below).to(torch.int8), dim=-1, stable=True)
    full_idx = torch.zeros((b, h, nq, nq), dtype=torch.int32, device=dev)
    full_idx[..., :k_max] = torch.gather(idx, -1, order)
    diag_idx = torch.zeros_like(full_idx)
    diag_idx[..., 0] = rows[..., 0]
    return BlockMask.from_kv_blocks(
        (live & (idx.long() == rows)).any(-1).to(torch.int32), diag_idx,
        below.sum(-1, dtype=torch.int32), full_idx, BLOCK_SIZE=bs,
        mask_mod=lambda b_, h_, q_idx, kv_idx: (q_idx >= kv_idx)
        & picked[b_, h_, q_idx // bs, kv_idx // bs])


def pool_chunk_shapes(records, gen, hq, hk, d, bs, s, dev=torch.device("cuda")):
    """Kernel 5 at the chunk lane's shapes (one 1024-token chunk): the
    scorer's query pooling, q (1, hq, 1024, d) bf16 -> bf16, and a chunk's
    page summaries, k (1, hk, 1024, d) bf16 -> bf16; each against its plain
    version, timed beside one ``mean`` call of the same output dtype."""
    for name, heads, out_dtype in (("chunk_q", hq, torch.bfloat16),
                                   ("chunk_k", hk, torch.bfloat16)):
        x = torch.randn((1, heads, 1024, d), generator=gen, device=dev).to(torch.bfloat16)
        run_k = lambda: metric_kern.antidiag_pool(x, block_size=bs, stride=s,
                                                  out_dtype=out_dtype)
        run_p = lambda: metric_kern.antidiag_pool_plain(x, block_size=bs, stride=s,
                                                        out_dtype=out_dtype)
        run_l = lambda: torch.mean(x.reshape(1, heads, 1024 // bs, bs // s, s, d),
                                   dim=3, dtype=out_dtype)
        got, want = run_k(), run_p()
        torch.cuda.synchronize()
        err = check_close(f"antidiag_pool/{name}", got, want)
        rec_kernel(records, "antidiag_pool", name, "bfloat16", err, run_k, run_p,
                   (x.numel() * 2 + got.numel() * got.element_size(),
                    float(x.numel())), torch.bfloat16, run_lib=run_l)


def identity_selection(b: int, h: int, nb: int, dev):
    """Every causal block of each row, the diagonal first, then 0..i-1: the
    block-sparse kernel over it is flash attention, and dropping the last
    live block drops one key tile (block i - 1) from every row past the
    first two."""
    i = torch.arange(nb, device=dev)[:, None]
    j = torch.arange(nb, device=dev)[None, :]
    idx = torch.where(j == 0, i, j - 1).expand(b, h, nb, nb).to(torch.int32).contiguous()
    cnt = (i[:, 0] + 1).expand(b, h, nb).to(torch.int32).contiguous()
    return idx, cnt


def prefill_kernel_phase(records: dict, dev=torch.device("cuda")) -> None:
    n, hq, hk, d, bs, s = 16384, 16, 8, 128, 128, 16
    group = hq // hk
    policy = policy_lib.get_policy("stem")
    gen = torch.Generator(device=dev).manual_seed(2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    from torch.nn.attention.flex_attention import flex_attention
    flex = torch.compile(flex_attention, dynamic=False)
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split(".")[-1]
        es = torch.tensor([], dtype=dtype).element_size()
        q = torch.randn((1, hq, n, d), generator=gen, device=dev).to(dtype)
        k = torch.randn((1, hk, n, d), generator=gen, device=dev).to(dtype)
        v = torch.randn((1, hk, n, d), generator=gen, device=dev).to(dtype)

        # -- kernel 5: anti-diagonal pooling of q (rounded to q's dtype) --
        run_k = lambda: metric_kern.antidiag_pool(q, block_size=bs, stride=s,
                                                  out_dtype=dtype)
        run_p = lambda: metric_kern.antidiag_pool_plain(q, block_size=bs, stride=s,
                                                        out_dtype=dtype)
        run_l = lambda: q.reshape(1, hq, n // bs, bs // s, s, d).mean(dim=3)
        got, want = run_k(), run_p()
        torch.cuda.synchronize()
        err = check_close(f"antidiag_pool/{tag}", got, want)
        rec_kernel(records, "antidiag_pool", "prefill", tag, err, run_k, run_p,
                   (q.numel() * es + got.numel() * es, float(q.numel())), dtype,
                   run_lib=run_l)

        if dtype == torch.bfloat16:
            pool_chunk_shapes(records, gen, hq, hk, d, bs, s)

        # -- kernel 6: block max of log ||v|| (and at a chunk's v) ---------
        vc = v[:, :, :1024].contiguous()
        for lane, x in (("prefill", v), ("chunk", vc)):
            if lane == "chunk" and dtype != torch.bfloat16:
                continue
            run_k = lambda: metric_kern.value_magnitude(x, block_size=bs)
            run_p = lambda: metric_kern.value_magnitude_plain(x, block_size=bs)
            got, want = run_k(), run_p()
            torch.cuda.synchronize()
            err = check_close(f"value_magnitude/{lane}/{tag}", got, want)
            rec_kernel(records, "value_magnitude", lane, tag, err, run_k, run_p,
                       (x.numel() * es + got.numel() * 4, 2.0 * x.numel()), dtype)

        # -- kernel 3: block-sparse attention under stem's TPD selection ----
        for dedup in (False, True):
            pol = policy.with_updates(group_reduce="mean") if dedup else policy
            sel, _ = pol.prefill_select(q, k, v, with_block_mask=False)
            idx, cnt = sel.indices, sel.live_counts
            if dedup:
                idx, cnt = idx[:, ::group].contiguous(), cnt[:, ::group].contiguous()
            run_k = lambda: bsa_kern.block_sparse_attention(
                q, k, v, idx, live_counts=cnt, block_size=bs, group_dedup=dedup)
            run_p = lambda: bsa_kern.block_sparse_attention_plain(
                q, k, v, idx, cnt, block_size=bs, group_dedup=dedup)
            got, want = run_k(), run_p()
            torch.cuda.synchronize()
            name = "block_sparse_attention" + ("/dedup" if dedup else "")
            err = check_close(f"{name}/{tag}", got, want, p_bf16=True)
            if dedup:
                log(f"[kernels] {name} {tag}: max_abs_err={err:.3e}")
                continue
            density = float(selection_density(sel, n // bs))
            log(f"[kernels] stem selection at n={n}: k_max {idx.shape[-1]}, "
                f"realized density {density:.4f}")
            mask = flex_block_mask(idx, cnt, bs)
            run_l = lambda: flex(q, k, v, block_mask=mask, enable_gqa=True)
            check_library(f"{name} {tag} vs flex_attention", run_l(), want)
            rec_kernel(records, "block_sparse_attention", "prefill", tag, err,
                       run_k, run_p,
                       bsa_bytes_flops(q, k, idx, cnt, group, False, bs), dtype,
                       run_lib=run_l, iters=5, plain_iters=1)
            if dtype == torch.bfloat16:
                check_rejects_dropped_tile(name, q, k, v, idx, cnt, want, bs)
            # rows with cnt == 0 finalize to exact zeros
            cnt0 = cnt.clone()
            cnt0[:, :, 1::9] = 0
            got = bsa_kern.block_sparse_attention(q, k, v, idx, live_counts=cnt0,
                                                  block_size=bs)
            want = bsa_kern.block_sparse_attention_plain(q, k, v, idx, cnt0,
                                                         block_size=bs)
            torch.cuda.synchronize()
            check_close(f"block_sparse_attention/cnt0/{tag}", got, want, p_bf16=True)
            zero_rows = got.reshape(1, hq, n // bs, bs, d)[cnt0 == 0]
            if not bool((zero_rows == 0).all()):
                raise AssertionError("cnt == 0 rows are not exact zeros")
        del got, want

        # -- kernel 4: dense causal flash attention -------------------------
        run_k = lambda: flash_kern.flash_attention(q, k, v)
        run_p = lambda: flash_kern.flash_attention_plain(q, k, v)
        run_l = lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)
        got, want = run_k(), run_p()
        torch.cuda.synchronize()
        err = check_close(f"flash_attention/{tag}", got, want, p_bf16=True)
        check_library(f"flash_attention {tag} vs scaled_dot_product_attention",
                      run_l(), got)
        if dtype == torch.bfloat16:
            check_rejects_dropped_tile("flash_attention", q, k, v,
                                       *identity_selection(1, hq, n // bs, dev), want, bs)
        pairs = hq * n * (n + 1) / 2
        rec_kernel(records, "flash_attention", "prefill", tag, err, run_k, run_p,
                   (2 * q.numel() * es + 2 * k.numel() * es, 4.0 * d * pairs),
                   dtype, run_lib=run_l, iters=5, plain_iters=1)
        del q, k, v, got, want, mask
        torch.cuda.empty_cache()


def prefill_head_dim_phase(records: dict, dev=torch.device("cuda")) -> None:
    """Flash and block-sparse attention at head_dim 64 and 256 (bf16 on the
    tensor-core tile, each pair its own instance: P rounded to bf16), a
    4096-token prompt, 16 / 8 heads, block 128, stem's TPD selection: each
    against its plain version under the p_bf16 rule, which must reject a
    dropped key tile (flash: over the identity selection; block-sparse:
    stem's), the instance's launch counter moved, and timed (flash beside
    SDPA, block-sparse beside a compiled flex_attention over the same
    BlockMask); the bound is bf16's, the least the card could take for the
    same work."""
    n, hq, hk, bs = 4096, 16, 8, 128
    policy = policy_lib.get_policy("stem")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    from torch.nn.attention.flex_attention import flex_attention
    flex = torch.compile(flex_attention, dynamic=False)
    gen = torch.Generator(device=dev).manual_seed(4)
    for d in (64, 256):
        q = torch.randn((1, hq, n, d), generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn((1, hk, n, d), generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn((1, hk, n, d), generator=gen, device=dev).to(torch.bfloat16)
        wg = forward_route(torch.bfloat16, d, d) == "wgmma"
        run_k = lambda: flash_kern.flash_attention(q, k, v)
        run_p = lambda: flash_kern.flash_attention_plain(q, k, v)
        run_l = lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)
        reset_all_launches()
        got, want = run_k(), run_p()
        torch.cuda.synchronize()
        _need(read_all_launches(), [wgmma_counter("flash_attention", d, d)] if wg else [],
              f"flash_attention d{d}")
        err = check_close(f"flash_attention/d{d}/bfloat16", got, want, p_bf16=wg)
        check_rejects_dropped_tile(f"flash_attention d{d}", q, k, v,
                                   *identity_selection(1, hq, n // bs, dev), want, bs,
                                   p_bf16=wg, past_token=n // 2)
        check_library(f"flash_attention d{d} vs scaled_dot_product_attention",
                      run_l(), got)
        rec_kernel(records, "flash_attention", f"d{d}", "bfloat16", err, run_k, run_p,
                   (4 * q.numel() + 4 * k.numel(), 4.0 * d * hq * n * (n + 1) / 2),
                   torch.bfloat16, run_lib=run_l, iters=5, plain_iters=1)
        sel, _ = policy.prefill_select(q, k, v, with_block_mask=False)
        idx, cnt = sel.indices, sel.live_counts
        run_k = lambda: bsa_kern.block_sparse_attention(q, k, v, idx, live_counts=cnt,
                                                        block_size=bs)
        run_p = lambda: bsa_kern.block_sparse_attention_plain(q, k, v, idx, cnt,
                                                              block_size=bs)
        reset_all_launches()
        got, want = run_k(), run_p()
        torch.cuda.synchronize()
        wg = forward_route(torch.bfloat16, d, d, bs) == "wgmma"
        _need(read_all_launches(), [wgmma_counter("block_sparse_attention", d, d)] if wg else [],
              f"block_sparse_attention d{d}")
        err = check_close(f"block_sparse_attention/d{d}/bfloat16", got, want, p_bf16=wg)
        check_rejects_dropped_tile(f"block_sparse_attention d{d}", q, k, v, idx, cnt, want, bs,
                                   p_bf16=wg, past_token=n // 2)
        mask = flex_block_mask(idx, cnt, bs)
        run_l = lambda: flex(q, k, v, block_mask=mask, enable_gqa=True)
        try:
            check_library(f"block_sparse_attention d{d} vs flex_attention",
                          run_l(), want)
        except Exception as e:  # the library is only timed beside the kernel
            log(f"[kernels] flex_attention at d{d} failed, no library time: "
                f"{type(e).__name__}: {str(e).splitlines()[0][:200]}")
            run_l = None
        rec_kernel(records, "block_sparse_attention", f"d{d}", "bfloat16", err,
                   run_k, run_p, bsa_bytes_flops(q, k, idx, cnt, hq // hk, False, bs),
                   torch.bfloat16, run_lib=run_l, iters=5, plain_iters=1)
        del q, k, v, got, want
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 3c: the tensor-core kernels at d = dv = 128 against the parent commit's
# ---------------------------------------------------------------------------

# Phase 3's bf16 inputs of the rows the parent is timed on (row 2b: the
# paged chunk lane; 3 / 4: block-sparse and flash at 16k).
AB_INPUTS: dict = {}

# Run in a fresh process from one tree's src/: build that tree's kernels,
# run rows 2b / 3 / 4 and the backward rows 3b / 4b on the saved inputs,
# time each (device time, calls queued behind a device-side sleep) and save
# the outputs and times.
AB_SCRIPT = r"""
import sys
root, inputs, out = sys.argv[1:4]
sys.path.insert(0, root + "/src")
import torch
from repro_torch.kernels import _build
from repro_torch.kernels import block_sparse_attn as bsa, flash_attention as fa, paged_attn as pa
_build.build_all()
x = torch.load(inputs)
q, k, v, idx, cnt = x["prefill"]
tq, tk, tv, tdo, tidx, tcnt, tbs = x["train"]
fo, flse = fa.flash_attention(tq, tk, tv, return_lse=True)
bo, blse = bsa.block_sparse_attention(tq, tk, tv, tidx, live_counts=tcnt, block_size=tbs,
                                      return_lse=True)
runs = {
    "attend/chunk": lambda: pa.attend_pages(*x["attend/chunk"], block_size=128, causal=True,
                                            lane="chunk"),
    "block_sparse_attention": lambda: bsa.block_sparse_attention(q, k, v, idx, live_counts=cnt,
                                                                 block_size=128),
    "flash_attention": lambda: fa.flash_attention(q, k, v),
    "flash_attention_bwd": lambda: fa.flash_attention_bwd(tq, tk, tv, fo, tdo, lse=flse),
    "block_sparse_attention_bwd": lambda: bsa.block_sparse_attention_bwd(
        tq, tk, tv, bo, tdo, tidx, tcnt, block_size=tbs, lse=blse),
}
outs, ms = {}, {}
for name, fn in runs.items():
    outs[name] = fn()
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e6 * 200))
    t0.record()
    for _ in range(10):
        fn()
    t1.record()
    torch.cuda.synchronize()
    ms[name] = t0.elapsed_time(t1) / 10
cpu = lambda o: tuple(t.cpu() for t in o) if isinstance(o, tuple) else (o.cpu(),)
torch.save({"outs": {n: cpu(o) for n, o in outs.items()}, "ms": ms}, out)
"""


def parent_tree(arg) -> pathlib.Path | None:
    """The parent commit's tree: --parent DIR, else `git archive HEAD^`
    unpacked under the temporary directory when this checkout is a git
    repository; None otherwise."""
    if arg:
        return pathlib.Path(arg).resolve()
    if not (ROOT / ".git").exists():
        return None
    import tempfile
    dest = pathlib.Path(tempfile.mkdtemp(prefix="stem_parent_"))
    arch = subprocess.run(["git", "-C", str(ROOT), "archive", "HEAD^"], capture_output=True)
    if arch.returncode != 0:
        return None
    subprocess.run(["tar", "-x", "-C", str(dest)], input=arch.stdout, check=True)
    return dest


def parent_ab_phase(records: dict, parent) -> dict:
    """Phase 3c: the (128, 128) flash and block-sparse instances and the
    paged chunk lane, which this tile's shapes share, built from this tree
    and from the parent commit's, each in its own process, on phase 3's
    bf16 inputs (16 / 8 heads, 16k tokens, stem's selection; the chunk
    lane's 1024-token chunk), and both (128, 128) backward kernels at phase
    15's qwen3-0.6b training shapes (b 2, 16 / 8 heads, 4096 tokens, the
    CLI's stem selection; each tree's own forward gives o and lse):
    outputs bitwise equal, and each row's device time, timed parent,
    change, change, parent, within 5 % of the parent's.  Skipped (logged)
    without a parent tree."""
    if parent is None:
        log("[ab] no parent tree (--parent DIR, or a git checkout): A/B skipped")
        return {}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(31)
    n, hq, hk, d, bs = 16384, 16, 8, 128, 128
    q, k, v = (torch.randn((1, h, n, d), generator=gen, device=dev).to(torch.bfloat16)
               for h in (hq, hk, hk))
    sel, _ = policy_lib.get_policy("stem").prefill_select(q, k, v, with_block_mask=False)
    b, n_t = P15["b"], P15["n"]
    tq, tk, tv, tdo = _bwd_inputs(b, hq, hk, d, d, n_t, torch.bfloat16, 32, dev)
    pol = cli_stem_policy(n_t)
    tsel, _ = pol.prefill_select(tq, tk, tv, with_block_mask=False)
    inputs = ROOT / "build" / "ab_inputs.pt"
    inputs.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"prefill": (q, k, v, sel.indices, sel.live_counts),
                "attend/chunk": AB_INPUTS["attend/chunk"],
                "train": (tq, tk, tv, tdo, tsel.indices.contiguous(),
                          tsel.live_counts.contiguous(), pol.block_size)}, inputs)
    del q, k, v, sel, tq, tk, tv, tdo, tsel
    runs = []
    for tag, tree in (("parent", parent), ("change", ROOT), ("change", ROOT),
                      ("parent", parent)):
        out = ROOT / "build" / f"ab_{len(runs)}.pt"
        subprocess.run([sys.executable, "-c", AB_SCRIPT, str(tree), str(inputs), str(out)],
                       check=True, cwd=str(tree))
        runs.append((tag, torch.load(out)))
    base = runs[0][1]["outs"]
    for tag, r in runs[1:]:
        for name, o in r["outs"].items():
            if not all(torch.equal(x, y) for x, y in zip(o, base[name])):
                raise AssertionError(f"[ab] {name}: the {tag} output differs from the parent's")
    report = {}
    for name in base:
        ms = {tag: [r["ms"][name] for t, r in runs if t == tag] for tag in ("parent", "change")}
        mean = {tag: sum(v) / len(v) for tag, v in ms.items()}
        report[name] = dict(ms=ms, ratio=mean["change"] / mean["parent"])
        log(f"[ab] {name} (128, 128) bf16: outputs bitwise equal to the parent's; device ms "
            f"parent {ms['parent']}, change {ms['change']}, change / parent "
            f"{report[name]['ratio']:.4f}")
        if report[name]["ratio"] > 1.05:
            raise AssertionError(f"[ab] {name}: {report[name]['ratio']:.3f}x the parent's time")
    records["ab"] = report
    return report


# ---------------------------------------------------------------------------
# Phase 4: the engine at full width
# ---------------------------------------------------------------------------

class FiniteGreedy(sampling_lib.GreedySampler):
    """Greedy sampling that also folds "every logit sampled was finite" into
    one device flag, read once after the run (no host sync per step)."""

    def __init__(self):
        self.finite = None

    def __call__(self, logits):
        ok = torch.isfinite(logits).all()
        self.finite = ok if self.finite is None else self.finite & ok
        return super().__call__(logits)


sampling_lib.register_sampler("greedy-finite", FiniteGreedy)


# The port's own kernels (their device rows are printed below the top list
# too, so each kernel's share of the trace is always read).
PORT_KERNEL = re.compile(r"\b(score(_bcast)?|attend_\w+|block_sparse(_wgmma)?|"
                         r"flash(_wgmma)?|pool|vmag)_kernel\b")


def profile_summary(prof, wall: float, top: int = 12) -> float:
    """Device time by kernel name and the device's busy share of the run
    (the top rows, then the rest of the port's own kernels), then host time
    by operator (self CPU time: where a host-bound run goes).  Returns the
    busy share."""
    rows, host = [], []
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            host.append((ev.self_cpu_time_total / 1e3, ev.count, ev.key))
            continue                       # CPU ops: their kernels count below
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = ev.self_cuda_time_total
        if t > 0:
            rows.append((t / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    host.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e3
    log(f"[profile] device busy {busy:.3f} s of {wall:.3f} s wall "
        f"(busy share {busy / wall:.3f}; profiler on)")
    for i, (ms, count, name) in enumerate(rows):
        if i < top or PORT_KERNEL.search(name):
            log(f"[profile] {ms:10.1f} ms {count:7d} calls  {name[:90]}")
    log(f"[profile] host self time {sum(r[0] for r in host) / 1e3:.3f} s by operator:")
    for ms, count, name in host[:top]:
        log(f"[profile] host {ms:10.1f} ms {count:7d} calls  {name[:85]}")
    return busy / wall


def engine_phase(profile: bool = False) -> dict:
    cfg = QWEN3_0_6B
    bundle = registry.build(cfg)
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0),
                                device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    summary = _serve(bundle, params, policy_lib.get_policy("stem"), PROMPTS,
                     ARRIVALS, NEW_TOKENS, 0, profile=profile, budget_frac=0.5,
                     chunk_size=1024)
    launches = read_all_launches()
    # the paged kernels of both lanes, and the metric kernels that pool the
    # chunk scorer's queries and the chunk pages' summaries
    need = tuple(kern.LAUNCHES) + tuple(metric_kern.LAUNCHES)
    missing = [k for k in need if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    summary.update(peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   launches={k: launches[k] for k in need})
    log("[engine] " + json.dumps(summary))
    del params
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 5: the one-shot prefill at full width
# ---------------------------------------------------------------------------

def prefill_phase(profile: bool = False) -> dict:
    cfg = QWEN3_0_6B
    params = registry.build(cfg).init_params(
        torch.Generator(device="cuda").manual_seed(0), device="cuda")
    policy = policy_lib.get_policy("stem")
    n = 16384
    rng = np.random.RandomState(3)
    tokens = torch.as_tensor(rng.randint(0, cfg.vocab_size, size=(1, n)),
                             device="cuda")
    out = {}
    for arm, stem_cfg, need in (
            ("stem", policy, ("block_sparse_attention", "antidiag_pool",
                              "value_magnitude")),
            ("dense", None, ("flash_attention",))):
        step = steps_lib.make_prefill_step(registry.build(cfg), max_len=n,
                                           stem_cfg=stem_cfg)
        step(params, {"tokens": tokens[:, :1024]})        # warm-up
        torch.cuda.synchronize()
        reset_all_launches()
        t0 = time.perf_counter()
        logits, caches = step(params, {"tokens": tokens})
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = read_all_launches()
        if not torch.isfinite(logits).all():
            raise AssertionError(f"prefill/{arm}: non-finite logits")
        missing = [k for k in need if launches[k] == 0]
        if missing:
            raise AssertionError(f"prefill/{arm}: kernels never launched: {missing}")
        density = 1.0
        if stem_cfg is not None:
            # realized density of layer 0's selection on this prompt
            x = transformer._embed_inputs(params, {"tokens": tokens}, cfg)
            p0 = transformer._index(params["segment0"], 0)["sub0"]
            h = common.rms_norm(x, p0["norm1"])
            _, stats = attention_lib.apply_full(
                p0["attn"], h, cfg, positions=torch.arange(n, device="cuda"),
                stem_cfg=stem_cfg, return_stats=True)
            density = float(stats.density)
        del logits, caches
        torch.cuda.empty_cache()
        out[arm] = dict(ms=ms, density=density,
                        launches={k: v for k, v in launches.items() if v})
        log(f"[prefill] {arm}: n={n} {ms:.1f} ms, realized density "
            f"{density:.4f}, launches {out[arm]['launches']}")
        if profile:                         # a third, traced run
            act = torch.profiler.ProfilerActivity
            with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
                t0 = time.perf_counter()
                step(params, {"tokens": tokens})
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            log(f"[profile] prefill/{arm}:")
            profile_summary(prof, wall)
    return out


# ---------------------------------------------------------------------------
# Phase 6: the monolithic engine at full width
# ---------------------------------------------------------------------------

def _serve(bundle, params, policy, prompts, arrivals, new, seed,
           profile: bool = False, **knobs) -> dict:
    """Serve one trace (2 slots) with every sampled logit checked finite;
    checks that every request finished with ``new`` tokens and every page
    returned.  Returns the end-to-end summary."""
    ecfg = engine_lib.EngineConfig.for_trace(
        max_slots=2, max_prompt=max(prompts), max_new_tokens=new,
        page_size=policy.block_size, sampler="greedy-finite", **knobs)
    engine = engine_lib.StemEngine(bundle, params, policy, ecfg)
    rng = np.random.RandomState(seed)
    reqs = [engine_lib.Request(
        uid=i, prompt=rng.randint(0, bundle.cfg.vocab_size, size=(n,)).astype(np.int32),
        max_new_tokens=new, arrival_step=a)
        for i, (n, a) in enumerate(zip(prompts, arrivals))]
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
    if not bool(engine.sampler.finite):
        raise AssertionError("non-finite logits in the engine")
    if [f.uid for f in finished] != list(range(len(prompts))):
        raise AssertionError("not every request finished")
    for f in finished:
        if len(f.tokens) != new:
            raise AssertionError(f"request {f.uid}: {len(f.tokens)} tokens")
    if engine.allocator.available != ecfg.num_pages - 1:
        raise AssertionError("pages leaked")
    engine.allocator.check_conservation([])
    return dict(
        wall_s=wall, tok_s=sum(len(f.tokens) for f in finished) / wall,
        prompt_tok_s=sum(prompts) / wall,
        mean_ttft_s=float(np.mean([f.ttft_s for f in finished])),
        mean_tpot_s=float(np.mean([f.tpot_s for f in finished])),
        steps=engine.step_count, chunks=engine.stats["chunks"],
        prefills=engine.stats["prefills"],
        decode_steps=engine.stats["decode_steps"], num_pages=ecfg.num_pages)


def monolithic_phase() -> dict:
    cfg = QWEN3_0_6B
    bundle = registry.build(cfg)
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0),
                                device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    stem = _serve(bundle, params, policy_lib.get_policy("stem"), PROMPTS,
                  ARRIVALS, NEW_TOKENS, 0, budget_frac=0.5,
                  monolithic_prefill=True)
    xatt = _serve(bundle, params, policy_lib.get_policy("xattention"),
                  (4096, 100), (0, 0), NEW_TOKENS, 4, budget_frac=0.5,
                  monolithic_prefill=True)
    launches = read_all_launches()
    peak = torch.cuda.max_memory_allocated()
    need = ("score/decode", "attend/decode") + tuple(k[2] for k in PREFILL_KERNELS)
    missing = [k for k in need if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the monolithic path: {missing}")
    summary = dict(stem=stem, xattention=xatt, peak_mem_gib=peak / 2 ** 30,
                   launches=launches)
    log("[monolithic] " + json.dumps(summary))
    del params
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 5: fused vs gather at full width, 2 layers, fp32
# ---------------------------------------------------------------------------

def parity_phase(monolithic: bool) -> dict:
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
            executor=executor, monolithic_prefill=monolithic)
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
    log(f"[parity] {'monolithic' if monolithic else 'chunked'} "
        + json.dumps(result))
    return result


@dataclasses.dataclass(frozen=True)
class RecordingTopK(policy_lib.TopKSelector):
    """TopKSelector that keeps every selection it makes (indices, live
    counts); it reaches the path through the policy's selector slot."""
    selections: list = dataclasses.field(default_factory=list, compare=False)

    def select(self, *a, **kw):
        sel = super().select(*a, **kw)
        self.selections.append((sel.indices.clone(), sel.live_counts.clone()))
        return sel


def prefill_parity_phase() -> dict:
    """One-shot prefill, 2 layers, fp32, 4096 tokens: "fused" vs "gather"
    logits within 1e-4 and every layer's selection equal."""
    cfg = QWEN3_0_6B.replace(num_layers=2, dtype="float32")
    bundle = registry.build(cfg)
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(1),
                                device="cuda")
    policy = policy_lib.get_policy("stem").with_updates(min_budget_blocks=4)
    tokens = torch.as_tensor(np.random.RandomState(5).randint(
        0, cfg.vocab_size, size=(1, 4096)), device="cuda")
    runs = {}
    for executor in ("fused", "gather"):
        rec = RecordingTopK(sink_blocks=policy.selector.sink_blocks,
                            local_blocks=policy.selector.local_blocks)
        logits, _ = transformer.prefill(
            params, {"tokens": tokens}, cfg, max_len=4096,
            stem_cfg=dataclasses.replace(
                policy.with_updates(executor=executor), selector=rec))
        torch.cuda.synchronize()
        runs[executor] = (logits, rec.selections)
    (lf, sf), (lg, sg) = runs["fused"], runs["gather"]
    diff = float((lf - lg).abs().max())
    same = len(sf) == len(sg) == cfg.num_layers and all(
        torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) for a, b in zip(sf, sg))
    result = dict(max_logit_diff=diff, selections_equal=same)
    log("[parity] prefill " + json.dumps(result))
    if diff > 1e-4 or not same:
        raise AssertionError(f"one-shot prefill parity failed: {result}")
    return result


# ---------------------------------------------------------------------------
# Phase 8: the small configurations on the card
# ---------------------------------------------------------------------------

# tests/test_engine.py's config, policy and trace; the reduced qwen3-0.6b
# (head_dim 16) at block 128 / stride 16 with a smaller budget floor
TINY = dict(name="engine-tiny", family="dense", num_layers=2, d_model=32,
            num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64, vocab_size=64,
            qk_norm=True, dtype="float32")
SMALL_CONFIGS = {
    "tiny": (ArchConfig(**TINY),
             dict(block_size=8, sink_blocks=1, local_blocks=1, min_budget_blocks=2,
                  stride=4),
             [(5, 4, 0), (13, 6, 0), (8, 3, 1), (20, 5, 3), (9, 4, 5)]),
    "qwen3-0.6b-reduced": (reduced(QWEN3_0_6B).replace(dtype="float32"),
                           dict(sink_blocks=1, local_blocks=1, min_budget_blocks=2),
                           [(100, 6, 0), (700, 6, 0), (1300, 5, 1), (260, 5, 3)]),
}
PATH_KERNELS = {
    False: ("score/decode", "score/chunk", "attend/decode", "attend/chunk",
            "antidiag_pool", "value_magnitude"),
    True: ("score/decode", "attend/decode", "block_sparse_attention",
           "flash_attention", "antidiag_pool", "value_magnitude"),
}


def _serve_small(cfg, policy, trace, params, executor, monolithic):
    """Serve a small configuration's trace (2 slots, budget_frac 0.5) on
    the device of ``params``; returns the greedy streams."""
    rng = np.random.RandomState(7)
    ecfg = engine_lib.EngineConfig.for_trace(
        max_slots=2, max_prompt=max(n for n, _, _ in trace),
        max_new_tokens=max(m for _, m, _ in trace), page_size=policy.block_size,
        budget_frac=0.5, executor=executor, monolithic_prefill=monolithic)
    engine = engine_lib.StemEngine(registry.build(cfg), params, policy, ecfg)
    reqs = [engine_lib.Request(
        uid=i, prompt=rng.randint(0, cfg.vocab_size, size=(n,)).astype(np.int32),
        max_new_tokens=m, arrival_step=a) for i, (n, m, a) in enumerate(trace)]
    fin = engine.run(reqs)
    if [f.uid for f in fin] != list(range(len(trace))):
        raise AssertionError(f"small/{cfg.name}: not every request finished")
    if engine.allocator.available != ecfg.num_pages - 1:
        raise AssertionError(f"small/{cfg.name}: pages leaked")
    return [f.tokens for f in fin]


def small_config_phase() -> dict:
    """Each small configuration's trace (seeded weights) under "fused" and
    "gather" on the card and "fused" on the CPU, chunked and monolithic:
    every kernel of the path launched in the fused card run, each recorded
    kernel call equal to its plain version, the three streams equal; then
    the reduced qwen3-0.6b in bf16, its recorded kernel calls held to the
    bf16 rule and its fused stream to "gather"'s."""
    out = {}
    runs = [(name, "float32") for name in SMALL_CONFIGS] + [
        ("qwen3-0.6b-reduced", "bfloat16")]
    for name, dtype in runs:
        cfg, knobs, trace = SMALL_CONFIGS[name]
        cfg = cfg.replace(dtype=dtype)
        params_cpu = registry.build(cfg).init_params(
            torch.Generator().manual_seed(0), device="cpu")
        params = _to_device(params_cpu, "cuda")
        policy = policy_lib.get_policy("stem").with_updates(**knobs)
        for monolithic in (False, True):
            mode = "monolithic" if monolithic else "chunked"
            torch.cuda.synchronize()
            reset_all_launches()
            with replay.Recorder() as rec:
                fused = _serve_small(cfg, policy, trace, params, "fused", monolithic)
                torch.cuda.synchronize()
            launches = read_all_launches()
            counts = {k: launches[k] for k in PATH_KERNELS[monolithic]}
            if not all(counts.values()):
                raise AssertionError(f"small/{name}/{mode}: kernels never launched: "
                                     f"{counts}")
            report = rec.check()
            torch.cuda.synchronize()
            gather = _serve_small(cfg, policy, trace, params, "gather", monolithic)
            cpu = _serve_small(cfg, policy, trace, params_cpu, "fused", monolithic)
            res = dict(launches=counts, kernel_calls=report,
                       fused_equals_gather=fused == gather, fused_equals_cpu=fused == cpu)
            out[f"{name}/{dtype}/{mode}"] = res
            log(f"[small] {name} {dtype} {mode} (head_dim {cfg.head_dim}, block "
                f"{policy.block_size}, stride {policy.stride}): " + json.dumps(res))
            # bf16 is held to "gather" on the card only: the CPU run's bf16
            # matmuls round apart from cuBLAS's, so its stream is logged
            if fused != gather or (dtype == "float32" and fused != cpu):
                raise AssertionError(f"small/{name}/{dtype}/{mode}: streams differ "
                                     f"(fused card, gather card, fused CPU)")
        del params, params_cpu
    return out


# ---------------------------------------------------------------------------
# Phase 9: contiguous decode, the CLI and the evaluation passes
# ---------------------------------------------------------------------------

# The margin under which two arms' logits may choose different tokens: fp32
# phase 7's split rule; bf16 the p_bf16 rule of phase 3 at the chosen
# token (both arms run the wgmma tiles, which round P to bf16).
FP32_MARGIN = 1e-3
# The CLI's serving geometry of "stem" at block 128 (serve.main's rescale).
CLI_POLICY = dict(block_size=128, stride=4, sink_blocks=1, local_blocks=1,
                  min_budget_blocks=2)
ALL_KERNELS = ("score/decode", "score/chunk", "attend/decode", "attend/chunk",
               "block_sparse_attention", "flash_attention", "antidiag_pool",
               "value_magnitude")


def margin_limit(row: torch.Tensor, tok: int, dtype: str) -> float:
    if dtype == "float32":
        return FP32_MARGIN
    return float(tolerance(row[None], torch.bfloat16, p_bf16=True)[0, tok])


def check_partings(name, streams_a, rows_a, streams_b, rows_b, dtype,
                   strict=True, phase="phase9") -> dict:
    """Streams of two arms, request by request: equal, or they part at a
    step where each arm's logits row (the row its token was sampled from)
    ranks the two tokens within the margin of a near tie.  Later tokens of
    a parted request follow different inputs and are not compared.  With
    ``strict`` a parting over the margin raises."""
    out = {}
    for uid in sorted(streams_a):
        a, b = streams_a[uid], streams_b[uid]
        t = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if t is None:
            out[uid] = {"equal": len(a) == len(b)}
            continue
        ra, rb = rows_a[uid][t], rows_b[uid][t]
        margin = max(float(ra[a[t]] - ra[b[t]]), float(rb[b[t]] - rb[a[t]]))
        limit = max(margin_limit(ra, a[t], dtype), margin_limit(rb, b[t], dtype))
        out[uid] = {"equal": False, "parting_step": t, "margin": margin,
                    "limit": limit, "max_logit_diff": float((ra - rb).abs().max())}
    log(f"[{phase}] {name}: " + json.dumps(out))
    bad = [u for u, r in out.items() if not r["equal"]
           and ("margin" not in r or not r["margin"] <= r["limit"])]
    if bad and strict:
        raise AssertionError(f"{name}: streams part over the margin: {bad}")
    out["within_rule"] = not bad
    return out


class LogitTap:
    """Keeps, per request, the logits row (host, fp32) each of its tokens
    was sampled from, in the engine runs made inside the block: the decode
    rows of the granted slots, and the row of a chunk lane whose chunk
    completes its prompt.  ``engine_lib.StemEngine`` is replaced by module
    attribute, so engines the CLI builds are tapped."""

    def __init__(self):
        self.rows: dict = {}
        self._saved = None

    def __enter__(self):
        base, rows = engine_lib.StemEngine, self.rows
        self._saved = base

        class TappedEngine(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                step = self._unified

                def tapped(params, pools, tokens, table, lens, chunk=None):
                    dec, ch, pools = step(params, pools, tokens, table, lens, chunk)
                    for s in torch.nonzero(lens > 0).flatten().tolist():
                        rows.setdefault(self.slots[s].req.uid, []).append(
                            dec[s].float().cpu())
                    if chunk is not None:
                        tables = chunk["page_table"].cpu().numpy()
                        for lane in torch.nonzero(chunk["true_len"] > 0).flatten().tolist():
                            s = next(i for i, st in enumerate(self.slots)
                                     if st is not None and st.phase == "prefill"
                                     and (self.page_table[i] == tables[lane]).all())
                            st = self.slots[s]
                            if st.prefill_pos + self.chunk_size >= len(st.padded):
                                rows.setdefault(st.req.uid, []).append(
                                    ch[lane].float().cpu())
                    return dec, ch, pools
                self._unified = tapped

        engine_lib.StemEngine = TappedEngine
        return self

    def __exit__(self, *exc):
        engine_lib.StemEngine = self._saved
        return False


class SamplerTap:
    """Keeps every logits tensor the sampler reduces (host, fp32) in the
    fixed-batch runs made inside the block (``sampling_lib.get_sampler``
    replaced by module attribute): call t holds every row's token t."""

    def __init__(self):
        self.calls: list = []

    def __enter__(self):
        self._saved = sampling_lib.get_sampler
        calls, get = self.calls, self._saved

        def tapped_get(name):
            inner = get(name)

            def sample(logits):
                calls.append(logits.float().cpu())
                return inner(logits)
            return sample
        sampling_lib.get_sampler = tapped_get
        return self

    def __exit__(self, *exc):
        sampling_lib.get_sampler = self._saved
        return False

    def rows(self) -> dict:
        return {i: [c[i] for c in self.calls] for i in range(self.calls[0].shape[0])}


class SummarizeTimer:
    """CUDA events around every ``decode_lib.summarize_cache`` call made
    inside the block (replaced by module attribute; ``apply_decode`` calls
    it there): the device timeline between a call's first and last event,
    summed — the call's kernels, or its host work where the device waits
    on the host."""

    def __init__(self):
        self.events: list = []

    def __enter__(self):
        self._saved = fn = decode_lib.summarize_cache
        events = self.events

        def timed(*a, **kw):
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0.record()
            out = fn(*a, **kw)
            t1.record()
            events.append((t0, t1))
            return out
        decode_lib.summarize_cache = timed
        return self

    def __exit__(self, *exc):
        decode_lib.summarize_cache = self._saved
        return False

    def total_ms(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)


class SelectionTap:
    """Keeps every chunk-lane selection (live block ids of each query block
    row, on the host) made inside the block (``chunked_lib.
    select_chunk_blocks`` replaced by module attribute; both executors call
    it there).  Each prefill step calls it once a layer, in layer order."""

    def __init__(self):
        self.calls: list = []

    def __enter__(self):
        self._saved = fn = chunked_lib.select_chunk_blocks
        calls = self.calls

        def tapped(*a, **kw):
            sel = fn(*a, **kw)
            calls.append(torch.where(sel.live, sel.indices, -1).cpu())
            return sel
        chunked_lib.select_chunk_blocks = tapped
        return self

    def __exit__(self, *exc):
        chunked_lib.select_chunk_blocks = self._saved
        return False


def selection_splits(a: list, b: list, layers: int) -> dict:
    """Where two runs' chunk selections first differ (call i = prefill step
    i // layers, layer i % layers), how many calls differ, and the share of
    (head, query block) rows that differ in the first such call."""
    diff = [i for i, (x, y) in enumerate(zip(a, b))
            if x.shape != y.shape or not torch.equal(x, y)]
    out = {"calls": len(a), "differing_calls": len(diff)}
    if diff:
        i = diff[0]
        rows = (a[i] != b[i]).any(-1)
        out.update(first_step=i // layers, first_layer=i % layers,
                   rows_differing=float(rows.float().mean()),
                   layers_differing_in_step_0=sorted({j % layers for j in diff
                                                      if j < layers}))
    return out


def cli_args(arch, lo, hi, new, *extra):
    return ["--arch", arch, "--policy", "stem", "--requests", "2", "--min-prompt",
            str(lo), "--max-prompt", str(hi), "--decode-tokens", str(new),
            "--max-slots", "2", *extra]


def _fixed_batch_teacher_forced(bundle, params, policy, prompt, stream):
    """The contiguous arm of the engine differential (the reference's
    ``_fixed_batch_tokens``): the prompt padded to a page multiple through
    the one-shot prefill, then policy-sparse decode at budget 1.0, fed with
    ``stream`` (teacher forcing).  Returns the logits rows (host, fp32) its
    tokens are chosen from: row t gives token t."""
    plen, new = len(prompt), len(stream)
    bs = policy.block_size
    max_len = -(-(plen + new) // bs) * bs
    lp = -(-plen // bs) * bs
    toks = torch.zeros((1, lp), dtype=torch.int32, device="cuda")
    toks[0, :plen] = torch.as_tensor(prompt, device="cuda")
    serve = steps_lib.make_serve_step(bundle, stem_cfg=policy, budget_frac=1.0)
    logits, caches = bundle.prefill(params, {"tokens": toks}, max_len=max_len,
                                    stem_cfg=policy,
                                    last_pos=torch.tensor([plen - 1], device="cuda"))
    rows = [logits[0].float().cpu()]
    lens = torch.tensor([plen], dtype=torch.int32, device="cuda")
    for i in range(new - 1):
        tok = torch.tensor([[stream[i]]], dtype=torch.int32, device="cuda")
        logits, caches = serve(params, tok, caches, lens if i == 0 else None)
        rows.append(logits[0].float().cpu())
    return rows


def engine_vs_fixed_batch(dtype: str, rec) -> dict:
    """qwen3-0.6b at full width: the chunked engine ("fused", decode at
    budget 1.0) against contiguous prefill + sparse decode, per request,
    the contiguous arm teacher-forced on the engine's stream."""
    cfg = QWEN3_0_6B.replace(dtype=dtype)
    bundle = registry.build(cfg)
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(5),
                                device="cuda")
    policy = policy_lib.get_policy("stem").with_updates(**CLI_POLICY)
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in (1531, 3907)]
    new = 16
    ecfg = engine_lib.EngineConfig.for_trace(
        max_slots=2, max_prompt=max(map(len, prompts)), max_new_tokens=new,
        page_size=policy.block_size, budget_frac=1.0, chunk_size=1024,
        executor="fused")
    with rec, LogitTap() as tap:
        engine = engine_lib.StemEngine(bundle, params, policy, ecfg)
        fin = engine.run([engine_lib.Request(uid=i, prompt=p, max_new_tokens=new)
                          for i, p in enumerate(prompts)])
        streams = {f.uid: f.tokens for f in fin}
        rows_f = {i: _fixed_batch_teacher_forced(bundle, params, policy, p, streams[i])
                  for i, p in enumerate(prompts)}
    fixed = {i: [int(r.argmax()) for r in rows] for i, rows in rows_f.items()}
    # the contiguous arm's own stream equals the engine's up to the first
    # parting, where teacher forcing takes over
    res = check_partings(f"engine vs fixed-batch {dtype}", streams, tap.rows,
                         fixed, rows_f, dtype, strict=dtype == "float32")
    del params
    torch.cuda.empty_cache()
    return res


def eval_passes(rec) -> dict:
    """loss_fn and forward_with_stats at full width, bf16, one 8192-token
    sequence: CE under stem and dense, realized density per layer."""
    cfg = QWEN3_0_6B
    bundle = registry.build(cfg)
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0),
                                device="cuda")
    rng = np.random.RandomState(13)
    toks = torch.as_tensor(rng.randint(0, cfg.vocab_size, size=(1, 8193)),
                           device="cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    stem = policy_lib.get_policy("stem")
    out = {}
    with rec:
        for arm, pol in (("stem", stem), ("dense", None)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, metrics = bundle.loss_fn(params, batch, stem_cfg=pol)
            torch.cuda.synchronize()
            out[f"ce_{arm}"] = float(metrics["ce"])
            out[f"loss_fn_ms_{arm}"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        logits, records = transformer.forward_with_stats(params, batch, cfg,
                                                         stem_cfg=stem)
        torch.cuda.synchronize()
        out["forward_with_stats_ms"] = (time.perf_counter() - t0) * 1e3
        ce_stats = float(common.cross_entropy(logits, batch["labels"]))
        del logits
    out["density_per_layer"] = [float(r["stats"].density) for r in records]
    out["ce_from_forward_with_stats"] = ce_stats
    log("[phase9] eval " + json.dumps(out))
    if not all(np.isfinite(out[k]) for k in ("ce_stem", "ce_dense", "ce_from_forward_with_stats")):
        raise AssertionError("eval: non-finite CE")
    if abs(ce_stats - out["ce_stem"]) > 1e-3:
        raise AssertionError("eval: loss_fn and forward_with_stats disagree")
    if not all(0 < d <= 1 for d in out["density_per_layer"]):
        raise AssertionError("eval: realized density outside (0, 1]")
    if len(records) != cfg.num_layers:
        raise AssertionError("eval: not one record a layer")
    del params
    torch.cuda.empty_cache()
    return out


def _glm_cli(fixed, cfg, bundle, params, policy, executor, rec=None,
             arch="glm4-9b") -> tuple:
    """The CLI's run_engine / run_fixed_batch (serve.py) for ``arch``
    under ``executor``: the engine on 2 requests of 2048-4096 tokens, the
    fixed batch on 2 of 4096 (a block multiple, so its prefill is sparse),
    8 new tokens; logits rows and chunk selections tapped.  Returns
    (result, rows by request, chunk selections)."""
    args = serve_lib.build_parser().parse_args(
        cli_args(arch, 4096 if fixed else 2048, 4096, 8,
                 *(("--fixed-batch",) if fixed else ())))
    pol = policy.with_updates(executor=executor)
    tap = SamplerTap() if fixed else LogitTap()
    with (rec if rec is not None else contextlib.nullcontext()), tap, \
            SelectionTap() as sels:
        run = serve_lib.run_fixed_batch if fixed else serve_lib.run_engine
        res = run(args, cfg, bundle, params, pol, args.budget_frac)
    torch.cuda.synchronize()
    return res, (tap.rows() if fixed else tap.rows), sels.calls


def glm4_runs(recs: dict) -> dict:
    """glm4-9b (32 query / 2 KV heads: GQA group 16; untied fp32 head)
    through the CLI's engine and fixed-batch modes under "fused" and
    "gather".  fp32 at full width with the depth cut to 4 of 40 layers:
    streams equal or parted within 1e-3 (raises otherwise).  bf16 at 4 and
    at 40 layers: reported (streams, parting steps, margins, where the two
    executors' chunk selections first differ), with the 40-layer engine
    trace also under the "dense" policy, where no selection can flip; peak
    memory of each configuration."""
    out = {}
    stem = policy_lib.get_policy("stem").with_updates(**CLI_POLICY)
    dense = policy_lib.get_policy("dense").with_updates(**CLI_POLICY,
                                                        ignore_missing=True)
    # (dtype, layers, arms: (name, fixed batch?, policy))
    plan = (("float32", 4, (("engine", False, stem), ("fixed-batch", True, stem))),
            ("bfloat16", 4, (("engine", False, stem),)),
            ("bfloat16", GLM4_9B.num_layers, (("engine", False, stem),
                                              ("fixed-batch", True, stem),
                                              ("engine/dense", False, dense))))
    for dtype, depth, arms in plan:
        cfg = GLM4_9B.replace(dtype=dtype, num_layers=depth)
        bundle = registry.build(cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0),
                                    device="cuda")
        for mode, fixed, pol in arms:
            tag = f"{dtype}/{depth}/{mode}"
            rec = recs.setdefault(f"glm4-9b/{tag}", replay.Recorder())
            (res_f, rows_f, sel_f), (res_g, rows_g, sel_g) = (
                _glm_cli(fixed, cfg, bundle, params, pol, ex,
                         rec if ex == "fused" else None)
                for ex in ("fused", "gather"))
            keys = ("ttft_s", "ms_per_token") if fixed else (
                "wall_s", "ttft_ms_mean", "tpot_ms_mean")
            out[tag] = dict(
                **{k: res_f[k] for k in keys},
                chunk_selections=selection_splits(sel_f, sel_g, depth),
                parting=check_partings(
                    f"glm4-9b {dtype} {depth} layers {mode} fused vs gather",
                    res_f["tokens"], rows_f, res_g["tokens"], rows_g, dtype,
                    strict=dtype == "float32"))
        out[f"{dtype}/{depth}/peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        del params
        torch.cuda.empty_cache()
    log("[phase9] glm4-9b " + json.dumps(out))
    return out


def contiguous_phase() -> dict:
    """Phase 9.  (a) The CLI (serve.main) in engine and fixed-batch mode on
    full-width qwen3-0.6b, bf16, "stem": 2 requests of 2000-6000 tokens, 16
    new tokens; counters zeroed before and read after, the fixed-batch run
    timing summarize_cache.  (b) The engine vs fixed-batch differential,
    fp32 (streams equal or parted at a near tie) and bf16 (reported).  (c)
    loss_fn / forward_with_stats at 8192 tokens.  (d) glm4-9b
    (``glm4_runs``).  Every fused run is recorded and each recorded kernel
    call held against its plain version (kernels/replay.py)."""
    out = {}
    base = cli_args("qwen3-0.6b", 2000, 6000, 16)
    launches = {}
    recs = {}
    for mode, extra in (("engine", ()), ("fixed-batch", ("--fixed-batch",))):
        torch.cuda.synchronize()
        reset_all_launches()
        with recs.setdefault(f"cli/{mode}", replay.Recorder()), \
                SummarizeTimer() as timer:
            res = serve_lib.main(base + list(extra))
        counts = read_all_launches()
        launches.update({f"{mode}/{k}": v for k, v in counts.items()})
        summary = {k: res[k] for k in res if k not in ("tokens", "engine_stats")}
        if mode == "fixed-batch":
            decode_ms = res["ms_per_token"] * 15
            summary["summarize_ms"] = timer.total_ms()
            summary["summarize_calls"] = len(timer.events)
            summary["summarize_share_of_decode"] = summary["summarize_ms"] / decode_ms
        out[f"cli/{mode}"] = summary
        log(f"[phase9] cli {mode}: " + json.dumps(summary))
        for uid, toks in res["tokens"].items():
            if len(toks) != 16:
                raise AssertionError(f"cli {mode}: request {uid} has {len(toks)} tokens")
    need = {"engine": ("score/decode", "score/chunk", "attend/decode", "attend/chunk",
                       "antidiag_pool", "value_magnitude"),
            "fixed-batch": ("flash_attention", "antidiag_pool", "value_magnitude")}
    missing = [f"{m}/{k}" for m, ks in need.items() for k in ks
               if launches[f"{m}/{k}"] == 0]
    if missing:
        raise AssertionError(f"phase 9: kernels never launched: {missing}")
    out["launches"] = launches

    # the differential, the evaluation passes and glm4-9b, each fused run
    # under a recorder of its own
    for dtype in ("float32", "bfloat16"):
        recs[f"diff/{dtype}"] = replay.Recorder()
        out[f"diff/{dtype}"] = engine_vs_fixed_batch(dtype, recs[f"diff/{dtype}"])
    recs["eval"] = replay.Recorder()
    out["eval"] = eval_passes(recs["eval"])
    out["glm4-9b"] = glm4_runs(recs)
    need = {"score_pages/decode", "score_pages/chunk", "attend_pages/decode",
            "attend_pages/chunk", "antidiag_pool", "value_magnitude",
            "block_sparse_attention", "flash_attention"}
    seen = set()
    for name, rec in recs.items():
        report = rec.check()
        seen |= set(report)
        out[f"kernel_calls/{name}"] = report
        log(f"[phase9] recorded kernel calls, {name}: " + json.dumps(report))
    if need - seen:
        raise AssertionError(f"phase 9: kernels never recorded: {sorted(need - seen)}")
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 10: overload — preemption with host offload, the SLO scheduler, chaos
# ---------------------------------------------------------------------------

# The overload trace: four low-priority prompts at step 0 (32 new tokens
# each) and two priority-1 requests (16 new, TTFT SLO 2 s, TPOT SLO 0.2 s).
# With 2 slots and one 1024-token chunk lane, the first (step 2) finds both
# slots busy and evicts the cheapest victim, the 4000-token request after 2
# of its 4 chunks (prefilling); the second (step 12) finds the first HP
# request decoding beside the 6000-token one, decoding since step 9, and
# evicts that.
OVERLOAD_LP, OVERLOAD_HP = (4000, 6000, 8000, 11000), ((2000, 2), (2000, 12))
HP_SLO = dict(ttft_slo_s=2.0, tpot_slo_s=0.2)
ENGINE_KERNELS = ("score/decode", "score/chunk", "attend/decode", "attend/chunk",
                  "antidiag_pool", "value_magnitude")


def _engine_launches(arm: str, phase: str = "phase 10") -> dict:
    launches = read_all_launches()
    missing = [k for k in ENGINE_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"{phase} {arm}: kernels never launched: {missing}")
    return launches


def _overload_ecfg(max_slots, max_prompt, new, **knobs):
    return engine_lib.EngineConfig.for_trace(
        max_slots=max_slots, max_prompt=max_prompt, max_new_tokens=new,
        page_size=128, budget_frac=0.5, chunk_size=1024,
        sampler="greedy-finite", **knobs)


def _gbs(nbytes, ms):
    return nbytes / (ms * 1e6)


def forced_preempt_arm(bundle, params) -> dict:
    """One 6000-token request (32 new) in a 1-slot engine, preempted after 2
    chunks and again after 8 tokens, each time restored at the next
    admission and its pages read back; then drained.  Strict: restored
    pages == snapshot bitwise, stream == the uninterrupted run's, chunks and
    prefills equal (zero recompute), every page back."""
    policy = policy_lib.get_policy("stem")
    prompt = np.random.RandomState(10).randint(
        0, bundle.cfg.vocab_size, size=(6000,)).astype(np.int32)
    ecfg = _overload_ecfg(1, 6000, 32)
    req = lambda: engine_lib.Request(uid=0, prompt=prompt, max_new_tokens=32)
    ref_eng = engine_lib.StemEngine(bundle, params, policy, ecfg)
    ref = ref_eng.run([req()])[0]
    torch.cuda.synchronize()
    reset_all_launches()
    eng = engine_lib.StemEngine(bundle, params, policy, ecfg)
    eng.submit(req())
    swaps = []
    for phase, due in (("prefill", lambda: eng.stats["chunks"] >= 2),
                       ("decode", lambda: len(eng.slots[0].tokens) >= 8)):
        while not due():
            eng.step()
        if eng.slots[0].phase != phase:
            raise AssertionError(f"forced preempt: slot in {eng.slots[0].phase}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.preempt(0)                   # gather, pinned D2H copy, synchronize
        d2h_ms = (time.perf_counter() - t0) * 1e3
        nbytes = eng.host_store.nbytes
        snap = [t.clone() for t in offload_lib.leaves(eng.host_store.get(0))]
        eng.allocator.check_conservation([])
        t0 = time.perf_counter()
        eng._admit()                     # the restore (H2D scatter)
        torch.cuda.synchronize()
        h2d_ms = (time.perf_counter() - t0) * 1e3
        back = offload_lib.leaves(offload_lib.gather_pages(
            eng.pools, torch.as_tensor(eng.slot_pages[0], device="cuda")))
        if not all(torch.equal(b.cpu(), a) for b, a in zip(back, snap)):
            raise AssertionError(f"forced preempt ({phase}): restored pages "
                                 "differ from the snapshot")
        swaps.append(dict(phase=phase, pages=len(eng.slot_pages[0]),
                          snapshot_bytes=nbytes, preempt_ms=d2h_ms,
                          preempt_gb_s=_gbs(nbytes, d2h_ms), restore_ms=h2d_ms,
                          restore_gb_s=_gbs(nbytes, h2d_ms),
                          restore_ema_gb_s=eng.metrics["h2d_bw_bytes_per_s"] / 1e9))
    fin = eng.run()[0]
    torch.cuda.synchronize()
    launches = _engine_launches("forced")
    if fin.tokens != ref.tokens:
        raise AssertionError("forced preempt: stream differs from the "
                             "uninterrupted run")
    for key in ("chunks", "prefills"):
        if eng.stats[key] != ref_eng.stats[key]:
            raise AssertionError(f"forced preempt: {key} {eng.stats[key]} != "
                                 f"{ref_eng.stats[key]} (recompute)")
    if (fin.preemptions, eng.stats["restores"]) != (2, 2):
        raise AssertionError("forced preempt: not two swaps")
    if not bool(eng.sampler.finite):
        raise AssertionError("forced preempt: non-finite logits")
    eng.allocator.check_conservation([])

    # The link alone: the same bytes copied device -> pinned host -> device.
    nbytes = swaps[-1]["snapshot_bytes"]
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    link = {}
    for name, dst, src in (("d2h", host, dev), ("h2d", dev, host)):
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dst.copy_(src, non_blocking=True)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        link[name] = dict(bytes=nbytes, ms=min(ms), gb_s=_gbs(nbytes, min(ms)))
    del dev, host
    out = dict(swaps=swaps, link=link, tokens_equal=True,
               chunks=eng.stats["chunks"], prefills=eng.stats["prefills"],
               launches=launches)
    log("[phase10] forced " + json.dumps(out))
    return out


def overload_trace(vocab: int) -> list:
    rng = np.random.RandomState(11)
    reqs = [engine_lib.Request(
        uid=i, prompt=rng.randint(0, vocab, size=(n,)).astype(np.int32),
        max_new_tokens=32) for i, n in enumerate(OVERLOAD_LP)]
    reqs += [engine_lib.Request(
        uid=len(OVERLOAD_LP) + i,
        prompt=rng.randint(0, vocab, size=(n,)).astype(np.int32),
        max_new_tokens=16, arrival_step=a, priority=1, **HP_SLO)
        for i, (n, a) in enumerate(OVERLOAD_HP)]
    return reqs


def overload_run(bundle, params, arm: str, scheduler: str, plan=None,
                 phase: str = "phase 10", **knobs) -> dict:
    """Serve the overload trace (2 slots, pool sized by for_trace) under
    ``scheduler``, an optional chaos plan and further engine ``knobs``
    (``async_depth``, ``eos_id``); counters zeroed before and read after.
    Records each preemption's (step, uid, victim phase) and each restore's
    step."""
    policy = policy_lib.get_policy("stem")
    ecfg = _overload_ecfg(2, max(OVERLOAD_LP), 32, scheduler=scheduler, **knobs)
    chaos = chaos_lib.ChaosInjector(plan) if plan is not None else None
    eng = engine_lib.StemEngine(bundle, params, policy, ecfg, chaos=chaos)
    victims, restores = [], []
    preempt, restore = eng.preempt, eng._admit_restore

    def recorded_preempt(slot):
        st = eng.slots[slot]
        victims.append((eng.step_count, st.req.uid, st.phase))
        preempt(slot)

    def recorded_restore(rec, slot, pages):
        restores.append(eng.step_count)
        return restore(rec, slot, pages)
    eng.preempt, eng._admit_restore = recorded_preempt, recorded_restore
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    fin = eng.run(overload_trace(bundle.cfg.vocab_size))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _engine_launches(arm, phase)
    if not bool(eng.sampler.finite):
        raise AssertionError(f"{phase} {arm}: non-finite logits")
    errors = {f.uid: f.error for f in fin if f.error is not None}
    if errors:
        raise AssertionError(f"{phase} {arm}: failed requests {errors}")
    eng.allocator.check_conservation([])
    hp = [f for f in fin if f.priority == 1]
    lp = [f for f in fin if f.priority == 0]
    metrics = eng.metrics
    s = eng.stats
    return dict(
        arm=arm, wall_s=wall, loop=serving_summary(fin, wall),
        async_stats={k: s[k] for k in ("host_syncs", "id_fetches", "step_calls",
                                       "lookahead_discards", "dispatch_s",
                                       "sync_wait_s")},
        inflight_steps=metrics["inflight_steps"], finished=len(fin),
        hp_ttft_s=[f.ttft_s for f in hp], hp_tpot_s=[f.tpot_s for f in hp],
        lp_tpot_s=float(np.mean([f.tpot_s for f in lp])),
        lp_ttft_s=float(np.mean([f.ttft_s for f in lp])),
        offload_peak_bytes=metrics["offload_peak_bytes"],
        h2d_bw_bytes_per_s=metrics["h2d_bw_bytes_per_s"],
        chaos=metrics["chaos"], victims=victims, restore_steps=restores,
        steps=eng.step_count,
        stats={k: s[k] for k in ("preemptions", "restores", "restore_failures",
                                 "step_failures", "aborts", "alloc_denials",
                                 "chunks", "prefills", "restore_bytes")},
        launches=launches, tokens={f.uid: f.tokens for f in fin})


def _check_overload(run: dict, chaos: bool) -> None:
    s, arm = run["stats"], run["arm"]
    if run["arm"].startswith("fcfs"):
        if s["preemptions"]:
            raise AssertionError(f"phase 10 {arm}: fcfs preempted")
        return
    if s["preemptions"] < 2 or s["restores"] != s["preemptions"]:
        raise AssertionError(f"phase 10 {arm}: preemptions {s['preemptions']}, "
                             f"restores {s['restores']}")
    phases = {p for _, _, p in run["victims"]}
    if phases != {"prefill", "decode"}:
        raise AssertionError(f"phase 10 {arm}: victim phases {run['victims']}")
    if chaos and (run["chaos"] != {"alloc_denied": 1, "step_failed": 1,
                                   "restore_failed": 1} or s["aborts"]):
        raise AssertionError(f"phase 10 {arm}: chaos {run['chaos']}, "
                             f"aborts {s['aborts']}")


def overload_arms(dtype: str, layers: int, plan=None) -> tuple:
    """FCFS, SLO and SLO under the chaos ``plan`` (None: find the plan
    first: the CLI's ``chaos.CLI_PLAN`` with its restore failure moved to
    the first restore step of an SLO run under the CLI's other two faults,
    since no request of this trace is restored by step 7) at ``layers``
    layers of full-width
    qwen3-0.6b; every sampled logits row tapped.  Returns (runs, rows by
    arm, plan)."""
    cfg = QWEN3_0_6B.replace(num_layers=layers, dtype=dtype)
    bundle = registry.build(cfg)
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0),
                                device="cuda")
    if plan is None:
        probe = dataclasses.replace(chaos_lib.CLI_PLAN, fail_restore_steps=())
        first = overload_run(bundle, params, "probe", "slo", probe)["restore_steps"]
        plan = dataclasses.replace(chaos_lib.CLI_PLAN,
                                   fail_restore_steps=(first[0],))
    runs, rows = {}, {}
    for arm, scheduler, arm_plan in (("fcfs", "fcfs", None), ("slo", "slo", None),
                                     ("slo+chaos", "slo", plan)):
        with LogitTap() as tap:
            run = overload_run(bundle, params, f"{arm}/{dtype}/{layers}",
                               scheduler, arm_plan)
        _check_overload(run, arm_plan is not None)
        runs[arm], rows[arm] = run, tap.rows
        summary = {k: v for k, v in run.items() if k != "tokens"}
        log(f"[phase10] {arm} {dtype} {layers} layers: " + json.dumps(summary))
    del params
    torch.cuda.empty_cache()
    return runs, rows, plan


def overload_phase() -> dict:
    """Phase 10.  (1) The forced preempt / restore, bf16, full depth.  (2)
    The overload trace under FCFS, SLO and SLO + chaos: fp32 at 4 layers
    (streams of the three arms equal), bf16 at 28 (reported with
    ``check_partings``).  (3) The CLI with --hp-every 2 --max-waiting 6
    --chaos."""
    out, launches = {}, {}
    bundle = registry.build(QWEN3_0_6B)
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0),
                                device="cuda")
    out["forced"] = forced_preempt_arm(bundle, params)
    launches["forced"] = out["forced"]["launches"]
    del params
    torch.cuda.empty_cache()

    runs32, rows32, plan = overload_arms("float32", 4)
    for arm in ("fcfs", "slo+chaos"):
        check_partings(f"fp32/4 slo vs {arm}", runs32["slo"]["tokens"],
                       rows32["slo"], runs32[arm]["tokens"], rows32[arm],
                       "float32", strict=False, phase="phase10")
        if runs32[arm]["tokens"] != runs32["slo"]["tokens"]:
            raise AssertionError(f"phase 10: fp32 streams of slo and {arm} differ")
    runs16, rows16, _ = overload_arms("bfloat16", 28, plan)
    out["plan"] = dataclasses.asdict(plan)
    out["bf16_partings"] = {
        arm: check_partings(f"bf16/28 slo vs {arm}", runs16["slo"]["tokens"],
                            rows16["slo"], runs16[arm]["tokens"], rows16[arm],
                            "bfloat16", strict=False, phase="phase10")
        for arm in ("fcfs", "slo+chaos")}
    for tag, runs in (("fp32/4", runs32), ("bf16/28", runs16)):
        for arm, run in runs.items():
            out[f"{tag}/{arm}"] = {k: v for k, v in run.items() if k != "tokens"}
            launches[f"{tag}/{arm}"] = run["launches"]

    torch.cuda.synchronize()
    reset_all_launches()
    res = serve_lib.main(cli_args("qwen3-0.6b", 2000, 6000, 16, "--hp-every", "2",
                                  "--max-waiting", "6", "--chaos"))
    launches["cli"] = _engine_launches("cli")
    if res["failed"]:
        raise AssertionError(f"phase 10 cli: failed requests {res['failed']}")
    out["cli"] = {k: res[k] for k in res if k not in ("tokens", "engine_stats")}
    log("[phase10] cli " + json.dumps(out["cli"]))
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# Phase 11: the prefix cache and the async loop
# ---------------------------------------------------------------------------

# The shared-prefix trace: a 4096-token system prompt (32 pages) behind
# suffixes of 300 / 900 / 1500 / 2100 tokens arriving at steps 0 / 0 / 6 /
# 10, and one prompt of exactly the system prompt (a full match of a page
# multiple: its last page is copied on write) at step 10; 32 new tokens
# each.  The two late tenants and the copy find the system pages
# registered by the first prompt's prefill.
SYSTEM_TOKENS = 4096
PREFIX_SUFFIXES = ((300, 0), (900, 0), (1500, 6), (2100, 10))
PREFIX_COPY_ARRIVAL = 10
# The pool of the hit-rate arm: one request's reservation plus 8 pages, so
# admissions reclaim the cached pages of finished requests (14 of them on
# this trace; the page flow depends on no value).
HIT_RATE_SPARE = 8


def serving_summary(fin, wall: float) -> dict:
    """Wall, mean TTFT / TPOT and generated tok/s of a finished run."""
    ttft = [f.ttft_s for f in fin if not np.isnan(f.ttft_s)]
    tpot = [f.tpot_s for f in fin if not np.isnan(f.tpot_s)]
    tokens = sum(len(f.tokens) for f in fin)
    return dict(wall_s=wall, ttft_s=float(np.mean(ttft)) if ttft else None,
                tpot_s=float(np.mean(tpot)) if tpot else None,
                tok_s=tokens / wall)


class SyncFreeDispatch:
    """Runs every ``StemEngine._dispatch`` made inside the block (replaced
    by class attribute, so engines the CLI builds are covered) under
    ``torch.cuda.set_sync_debug_mode("error")``: a call of the async step
    path that waits on the card (``.item()``, a blocking copy, a boolean
    mask, a synchronize) raises.  ``calls`` counts the dispatches."""

    def __init__(self):
        self.calls = 0

    def __enter__(self):
        self._saved = dispatch = engine_lib.StemEngine._dispatch
        box = self

        def checked(eng, dec, grant):
            torch.cuda.set_sync_debug_mode("error")
            try:
                dispatch(eng, dec, grant)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            box.calls += 1
        engine_lib.StemEngine._dispatch = checked
        return self

    def __exit__(self, *exc):
        engine_lib.StemEngine._dispatch = self._saved
        return False


def prefix_trace(vocab: int) -> list:
    rng = np.random.RandomState(12)
    system = rng.randint(0, vocab, size=(SYSTEM_TOKENS,)).astype(np.int32)
    reqs = [engine_lib.Request(
        uid=i, prompt=np.concatenate(
            [system, rng.randint(0, vocab, size=(n,)).astype(np.int32)]),
        max_new_tokens=32, arrival_step=a)
        for i, (n, a) in enumerate(PREFIX_SUFFIXES)]
    reqs.append(engine_lib.Request(uid=len(reqs), prompt=system.copy(),
                                   max_new_tokens=32,
                                   arrival_step=PREFIX_COPY_ARRIVAL))
    return reqs


def _prefix_ecfg(**knobs):
    longest = SYSTEM_TOKENS + max(n for n, _ in PREFIX_SUFFIXES)
    return _overload_ecfg(2, longest, 32, **knobs)


def prefix_run(bundle, params, arm: str, num_pages=None, **knobs) -> dict:
    """Serve the shared-prefix trace (2 slots, paper-default "stem", budget
    0.5, chunk 1024) with the engine ``knobs`` (and ``num_pages`` in place
    of for_trace's pool); counters zeroed before and read after; every page
    back at the end."""
    ecfg = _prefix_ecfg(**knobs)
    if num_pages is not None:
        ecfg = dataclasses.replace(ecfg, num_pages=num_pages)
    eng = engine_lib.StemEngine(bundle, params, policy_lib.get_policy("stem"),
                                ecfg)
    torch.cuda.synchronize()
    reset_all_launches()
    t0 = time.perf_counter()
    fin = eng.run(prefix_trace(bundle.cfg.vocab_size))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _engine_launches(arm, "phase 11")
    if not bool(eng.sampler.finite):
        raise AssertionError(f"phase 11 {arm}: non-finite logits")
    errors = {f.uid: f.error for f in fin if f.error is not None}
    if errors:
        raise AssertionError(f"phase 11 {arm}: failed requests {errors}")
    eng.allocator.check_conservation([])
    if eng.allocator.available != ecfg.num_pages - 1:
        raise AssertionError(f"phase 11 {arm}: pages not back")
    s = eng.stats
    late = [f for f in fin if f.uid >= 2]
    return dict(
        arm=arm, loop=serving_summary(fin, wall), num_pages=ecfg.num_pages,
        late_ttft_s={f.uid: f.ttft_s for f in late},
        stats={k: s[k] for k in ("prefix_hits", "prefix_pages_shared",
                                 "prefix_cows", "chunks", "prefills",
                                 "step_calls", "host_syncs", "id_fetches",
                                 "lookahead_discards")},
        allocator={k: getattr(eng.allocator, k) for k in (
            "shares", "cows", "cache_reclaims", "total_alloced")},
        launches=launches, tokens={f.uid: f.tokens for f in fin})


def prefix_arms(dtype: str, layers: int, recorded: bool = False) -> dict:
    """(a) The shared-prefix trace with the prefix cache off and on (fp32:
    streams strictly equal; bf16: reported with ``check_partings``), the
    "on" arm optionally under the replay recorder; fp32 also under
    ``prefix_evict="hit-rate"`` with a pool that forces reclaims, and with
    the cache on through the async loop."""
    cfg = QWEN3_0_6B.replace(num_layers=layers, dtype=dtype)
    bundle = registry.build(cfg)
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0),
                                device="cuda")
    tag = f"{dtype}/{layers}"
    runs, rows = {}, {}
    for arm, knobs in (("off", {}), ("on", dict(prefix_cache=True))):
        rec = replay.Recorder() if recorded and arm == "on" else contextlib.nullcontext()
        with LogitTap() as tap, rec:
            runs[arm] = prefix_run(bundle, params, f"prefix-{arm}/{tag}", **knobs)
        rows[arm] = tap.rows
        if recorded and arm == "on":
            report = rec.check()
            log(f"[phase11] prefix-on/{tag}: {len(report)} recorded kernel calls "
                "held against their plain versions")
    on, off = runs["on"], runs["off"]
    st = on["stats"]
    if not (st["prefix_hits"] >= 2 and st["prefix_pages_shared"] >= 64
            and st["prefix_cows"] == 1):
        raise AssertionError(f"phase 11 prefix {tag}: {st}")
    if not on["stats"]["chunks"] < off["stats"]["chunks"]:
        raise AssertionError(f"phase 11 prefix {tag}: chunks on "
                             f"{on['stats']['chunks']} vs off {off['stats']['chunks']}")
    strict = dtype == "float32"
    out = {"partings": check_partings(
        f"prefix on vs off {tag}", off["tokens"], rows["off"], on["tokens"],
        rows["on"], dtype, strict=strict, phase="phase11")}
    if strict and on["tokens"] != off["tokens"]:
        raise AssertionError(f"phase 11 prefix {tag}: streams differ")
    if strict:
        spare = _prefix_ecfg().max_pages_per_slot + HIT_RATE_SPARE
        hit = prefix_run(bundle, params, f"prefix-hit-rate/{tag}",
                         prefix_cache=True, prefix_evict="hit-rate",
                         num_pages=1 + spare)
        if not hit["allocator"]["cache_reclaims"] > 0:
            raise AssertionError(f"phase 11 hit-rate {tag}: no cached page "
                                 f"reclaimed {hit['allocator']}")
        if hit["tokens"] != off["tokens"]:
            raise AssertionError(f"phase 11 hit-rate {tag}: streams differ")
        runs["hit-rate"] = hit
        with SyncFreeDispatch() as guard:
            both = prefix_run(bundle, params, f"prefix-async/{tag}",
                              prefix_cache=True, async_depth=1)
        if both["tokens"] != off["tokens"] or guard.calls != both["stats"]["step_calls"]:
            raise AssertionError(f"phase 11 prefix+async {tag}: streams differ "
                                 f"or {guard.calls} checked dispatches")
        for key in ("prefix_hits", "prefix_pages_shared", "prefix_cows"):
            if both["stats"][key] != st[key]:
                raise AssertionError(f"phase 11 prefix+async {tag}: {key}")
        runs["async"] = both
    for arm, run in runs.items():
        out[arm] = {k: v for k, v in run.items() if k != "tokens"}
        log(f"[phase11] prefix {arm} {tag}: " + json.dumps(out[arm]))
    del params
    torch.cuda.empty_cache()
    return out


def shared_preempt_arm() -> dict:
    """(b) fp32, 4 layers, 2 slots: a sharer of the system prompt (32
    shared pages) decoding beside the prompt's first owner is preempted by
    a priority-1 request.  The snapshot holds its private pages only, the
    shared pages keep their references while it is out, and its restored
    stream equals the uninterrupted run's (the same trace with the
    interloper at priority 0)."""
    cfg = QWEN3_0_6B.replace(num_layers=4, dtype="float32")
    bundle = registry.build(cfg)
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0),
                                device="cuda")
    base = prefix_trace(cfg.vocab_size)[:2]
    base[1] = dataclasses.replace(base[1], arrival_step=6)
    hp_prompt = np.random.RandomState(14).randint(
        0, cfg.vocab_size, size=(2000,)).astype(np.int32)
    ecfg = _prefix_ecfg(prefix_cache=True)
    runs = {}
    for arm, prio in (("uninterrupted", 0), ("preempted", 1)):
        reqs = [dataclasses.replace(r) for r in base] + [engine_lib.Request(
            uid=2, prompt=hp_prompt, max_new_tokens=16, arrival_step=10,
            priority=prio)]
        eng = engine_lib.StemEngine(bundle, params, policy_lib.get_policy("stem"),
                                    ecfg)
        seen = []
        preempt = eng.preempt

        def watched(slot, eng=eng, preempt=preempt, seen=seen):
            n = eng.slot_nshared[slot]
            shared = list(eng.slot_pages[slot][:n])
            private = len(eng.slot_pages[slot]) - n
            refs = [eng.allocator.refcount(p) for p in shared]
            preempt(slot)
            uid = eng.preempted[-1].st.req.uid
            seen.append(dict(uid=uid, shared=len(shared), private=private,
                             snapshot_bytes=eng.host_store.nbytes,
                             private_bytes=private * eng._page_nbytes,
                             pinned=eng.host_store.pinned(uid) == shared,
                             refs_kept=[eng.allocator.refcount(p)
                                        for p in shared] == refs))
        eng.preempt = watched
        torch.cuda.synchronize()
        reset_all_launches()
        fin = eng.run(reqs)
        torch.cuda.synchronize()
        launches = _engine_launches(f"shared-preempt/{arm}", "phase 11")
        if any(f.error for f in fin):
            raise AssertionError(f"phase 11 shared preempt {arm}: failed requests")
        eng.allocator.check_conservation([])
        runs[arm] = dict(tokens={f.uid: f.tokens for f in fin}, swaps=seen,
                         stats={k: eng.stats[k] for k in (
                             "preemptions", "restores", "restore_bytes",
                             "prefix_hits", "prefix_pages_shared")},
                         launches=launches)
    pre = runs["preempted"]
    swap = pre["swaps"][0] if pre["swaps"] else None
    if (swap is None or swap["uid"] != 1 or not swap["shared"]
            or swap["snapshot_bytes"] != swap["private_bytes"]
            or not swap["pinned"] or not swap["refs_kept"]):
        raise AssertionError(f"phase 11 shared preempt: swaps {pre['swaps']}")
    if pre["stats"]["restores"] != 1 or runs["uninterrupted"]["stats"]["preemptions"]:
        raise AssertionError(f"phase 11 shared preempt: {pre['stats']}")
    want = runs["uninterrupted"]["tokens"]
    if any(pre["tokens"][u] != want[u] for u in (0, 1)):
        raise AssertionError("phase 11 shared preempt: a restored stream differs")
    out = {arm: {k: v for k, v in r.items() if k != "tokens"}
           for arm, r in runs.items()}
    log("[phase11] shared preempt " + json.dumps(out))
    del params
    torch.cuda.empty_cache()
    return out


def async_arms(dtype: str, layers: int) -> dict:
    """(c) Phase 10 (b)'s overload trace through the sync and the async
    loop (scheduler "slo": two preemptions and restores); streams bitwise
    equal; the async counters bounded; every dispatch sync-free.  fp32 also
    with a mid-stream EOS (a lookahead discarded) and under the CLI's chaos
    plan; bf16 timed twice each, in turns."""
    cfg = QWEN3_0_6B.replace(num_layers=layers, dtype=dtype)
    bundle = registry.build(cfg)
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0),
                                device="cuda")
    tag = f"{dtype}/{layers}"
    runs = {"sync": overload_run(bundle, params, f"sync/{tag}", "slo",
                                 phase="phase 11")}
    arms = [("async", None, {})]
    if dtype == "float32":
        eos = runs["sync"]["tokens"][1][12]
        runs["sync+eos"] = overload_run(bundle, params, f"sync+eos/{tag}", "slo",
                                        phase="phase 11", eos_id=eos)
        # The CLI's chaos plan with its restore failure moved to the first
        # restore step of an async run under the other two faults.
        probe = dataclasses.replace(chaos_lib.CLI_PLAN, fail_restore_steps=())
        first = overload_run(bundle, params, f"probe/{tag}", "slo", probe,
                             phase="phase 11", async_depth=1)["restore_steps"]
        plan = dataclasses.replace(chaos_lib.CLI_PLAN,
                                   fail_restore_steps=(first[0],))
        arms += [("async+eos", None, dict(eos_id=eos)),
                 ("async+chaos", plan, {})]
    else:
        # Timed in turns (sync, async, async, sync): walls move by several
        # per cent between runs of one loop on one card.
        arms += [("async#2", None, {}), ("sync#2", None, {})]
    for arm, plan, knobs in arms:
        if arm == "sync#2":
            run = overload_run(bundle, params, f"{arm}/{tag}", "slo",
                               phase="phase 11")
            if run["tokens"] != runs["sync"]["tokens"]:
                raise AssertionError(f"phase 11 {arm} {tag}: streams differ")
            runs[arm] = run
            continue
        with SyncFreeDispatch() as guard:
            run = overload_run(bundle, params, f"{arm}/{tag}", "slo", plan,
                               phase="phase 11", async_depth=1, **knobs)
        a = run["async_stats"]
        if guard.calls != a["step_calls"] or run["inflight_steps"]:
            raise AssertionError(f"phase 11 {arm} {tag}: {guard.calls} checked "
                                 f"dispatches, {a}")
        if not (a["host_syncs"] <= 2 * run["finished"]
                and a["step_calls"] <= a["id_fetches"] <= 2 * a["step_calls"]):
            raise AssertionError(f"phase 11 {arm} {tag}: async counters {a}")
        if plan is not None:
            _check_overload(run, chaos=True)
        want = runs["sync+eos" if "eos" in arm else "sync"]["tokens"]
        if run["tokens"] != want:
            raise AssertionError(f"phase 11 {arm} {tag}: streams differ from sync")
        if "eos" in arm:
            early = [u for u, t in run["tokens"].items() if t[-1] == eos
                     and len(t) < (16 if u >= len(OVERLOAD_LP) else 32)]
            if not early or not 1 <= a["lookahead_discards"] <= len(early):
                raise AssertionError(f"phase 11 {arm}: early EOS {early}, "
                                     f"discards {a['lookahead_discards']}")
        runs[arm] = run
    out = {}
    for arm, run in runs.items():
        out[arm] = {k: v for k, v in run.items() if k != "tokens"}
        log(f"[phase11] loop {arm} {tag}: " + json.dumps(out[arm]))
    del params
    torch.cuda.empty_cache()
    return out


def profile_loops(profile: bool) -> dict:
    """With ``--profile``: the device's busy share of the bf16 overload
    trace under each loop (torch.profiler around the run)."""
    if not profile:
        return {}
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    cfg = QWEN3_0_6B
    bundle = registry.build(cfg)
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0),
                                device="cuda")
    out = {}
    for arm, depth in (("sync", 0), ("async", 1)):
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            run = overload_run(bundle, params, f"profile-{arm}", "slo",
                               phase="phase 11", async_depth=depth)
        log(f"[phase11] --profile {arm}:")
        profile_summary(prof, run["wall_s"])
        out[arm] = run["wall_s"]
    del params
    torch.cuda.empty_cache()
    return out


def prefix_async_phase(profile: bool = False) -> dict:
    """Phase 11: (a) the prefix cache off / on (fp32 4 layers, strict, the
    "on" arm recorded; hit-rate and async arms; bf16 28 layers reported),
    (b) preemption of a sharer, (c) the async loop against the sync loop
    on phase 10 (b)'s trace (fp32 4 layers with EOS and chaos arms; bf16
    28 layers timed), (d) the CLI with --prefix-cache --async-depth 1 and
    with --prefix-cache --prefix-evict hit-rate."""
    out, launches = {}, {}
    out["prefix/fp32/4"] = prefix_arms("float32", 4, recorded=True)
    out["prefix/bf16/28"] = prefix_arms("bfloat16", 28)
    out["shared_preempt"] = shared_preempt_arm()
    out["loops/fp32/4"] = async_arms("float32", 4)
    out["loops/bf16/28"] = async_arms("bfloat16", 28)
    for key in ("prefix/fp32/4", "prefix/bf16/28", "loops/fp32/4", "loops/bf16/28"):
        for arm, run in out[key].items():
            if isinstance(run, dict) and "launches" in run:
                launches[f"{key}/{arm}"] = run["launches"]
    for arm, run in out["shared_preempt"].items():
        launches[f"shared_preempt/{arm}"] = run["launches"]
    out["profile"] = profile_loops(profile)
    for tag, extra in (("prefix+async", ("--async-depth", "1")),
                       ("prefix hit-rate", ("--prefix-evict", "hit-rate"))):
        torch.cuda.synchronize()
        reset_all_launches()
        with SyncFreeDispatch():
            res = serve_lib.main(cli_args("qwen3-0.6b", 1000, 3000, 8,
                                          "--prefix-cache", *extra))
        launches[f"cli/{tag}"] = _engine_launches(f"cli {tag}", "phase 11")
        if res["failed"]:
            raise AssertionError(f"phase 11 cli {tag}: failed {res['failed']}")
        out[f"cli/{tag}"] = {k: res[k] for k in res if k not in ("tokens",)}
        log(f"[phase11] cli {tag} " + json.dumps(out[f"cli/{tag}"]))
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# Phase 12: the MoE family at full width (arctic-480b)
# ---------------------------------------------------------------------------

class MoETap:
    """CUDA events around every ``moe.apply`` and ``moe.expert_ffn`` call
    made inside the block (replaced by module attribute: ``transformer``
    calls ``moe.apply``, which calls ``route`` and ``expert_ffn`` there),
    by lane: "decode" for rows of one token, "chunk" for rows of
    ``chunk`` tokens, "prefill" otherwise; and the (token, k) slots each
    lane dropped past its capacity, summed on the device (no host sync)."""

    def __init__(self, chunk: int):
        self.chunk = chunk
        self.events: dict = {}
        self.drops: dict = {}
        self.slots: dict = {}
        self.shapes: dict = {}

    def lane(self, x) -> str:
        s = x.shape[1]
        return "decode" if s == 1 else "chunk" if s == self.chunk else "prefill"

    def __enter__(self):
        self._saved = {k: getattr(moe_lib, k) for k in ("apply", "route", "expert_ffn")}
        tap = self

        def timed(name, fn):
            def run(*a, **kw):
                x = a[1] if name == "apply" else a[0]
                t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                t0.record()
                out = fn(*a, **kw)
                t1.record()
                tap.events.setdefault((tap.lane(x), name), []).append((t0, t1))
                return out
            return run

        def route(params, x, moe):
            out = self._saved["route"](params, x, moe)
            lane = tap.lane(x)
            keep = out[4]
            tap.drops[lane] = tap.drops.get(lane, 0) + (~keep).sum()
            tap.slots[lane] = tap.slots.get(lane, 0) + keep.numel()
            tap.shapes[lane] = (tuple(x.shape), out[5])
            return out
        moe_lib.apply = timed("apply", self._saved["apply"])
        moe_lib.expert_ffn = timed("expert_ffn", self._saved["expert_ffn"])
        moe_lib.route = route
        return self

    def __exit__(self, *exc):
        for k, fn in self._saved.items():
            setattr(moe_lib, k, fn)
        return False

    def report(self, cfg) -> dict:
        """Per lane: calls (one a layer), mean device ms of the MoE FFN and
        of its expert products, the capacity, drops; the bounds of the
        expert products: every expert's weights read once (what the static
        capacity buffer reads) and the routed experts' alone (their
        bytes, and the products of the slots the capacity can keep)."""
        torch.cuda.synchronize()
        moe, d = cfg.moe, cfg.d_model
        elt = torch.tensor([], dtype=cfg.torch_dtype).element_size()
        per_expert = 3 * d * moe.expert_d_ff * elt
        out = {}
        for lane, (shape, cap) in self.shapes.items():
            b, s, _ = shape
            ms = {name: float(np.mean([a.elapsed_time(c) for a, c in
                                       self.events[(lane, name)]]))
                  for name in ("apply", "expert_ffn")}
            flops = 2 * 3 * b * moe.num_experts * cap * d * moe.expert_d_ff
            routed = min(moe.num_experts, b * s * moe.top_k)
            kept = min(b * s * moe.top_k, b * moe.num_experts * cap)
            out[lane] = dict(
                calls=len(self.events[(lane, "apply")]), rows=b, tokens=s,
                capacity=cap, moe_ms=ms["apply"], experts_ms=ms["expert_ffn"],
                bound_all_experts_ms=bound(moe.num_experts * per_expert, flops,
                                           cfg.torch_dtype)[0],
                bound_routed_ms=bound(routed * per_expert,
                                      2 * 3 * kept * d * moe.expert_d_ff,
                                      cfg.torch_dtype)[0],
                dropped_slots=int(self.drops[lane]), slots=self.slots[lane])
        return out


def arctic_phase() -> dict:
    """Phase 12: arctic-480b at its published widths (d_model 7168, 56 / 8
    heads, 128 experts top-2 of d_ff 4864, the dense residual FFN of d_ff
    4864, vocab 32000, untied head), depth cut to fit one card: 2 of 35
    layers in bf16 (2 x 27.22 GB of layers + the fp32 embedding and head),
    1 layer in fp32.  Random weights drawn on the card from a seeded
    generator.  (a) bf16 2 layers: phase 4's chunked trace (stem, budget
    0.5, chunk 1024, 2 slots), every kernel call recorded and held against
    its plain version, the MoE's device ms per lane and layer beside its
    bounds, drops per lane (also of (c)'s monolithic prefill).  (b) The same weights: a shared-prefix trace
    with the prefix cache through the sync and the async loop (every
    ``_dispatch`` sync-free), streams equal.  (d) The CLI's engine and
    --fixed-batch modes on the same weights.  (c) fp32 1 layer: "fused"
    == "gather" on a chunked trace; the monolithic engine == a 1-request
    fixed batch on a 4096-token prompt, 16 new tokens."""
    out, launches, recs = {}, {}, {}
    # Earlier phases' engines (the logit taps', the recorded preemptions')
    # hold their weights in reference cycles: collect them before drawing
    # 52 GiB.
    gc.collect()
    torch.cuda.empty_cache()
    out["allocated_before_gib"] = torch.cuda.memory_allocated() / 2 ** 30
    policy = policy_lib.get_policy("stem")
    cfg = ARCTIC_480B.replace(num_layers=2)
    bundle = registry.build(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0),
                                device="cuda")
    torch.cuda.synchronize()
    out["bf16/init"] = dict(s=time.perf_counter() - t0,
                            allocated_before_gib=out["allocated_before_gib"],
                            weights_gib=torch.cuda.memory_allocated() / 2 ** 30,
                            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    log("[phase12] bf16 2 layers drawn: " + json.dumps(out["bf16/init"]))

    # (a) phase 4's trace, chunked
    reset_all_launches()
    with replay.Recorder() as rec, MoETap(1024) as tap:
        summary = _serve(bundle, params, policy, PROMPTS, ARRIVALS, NEW_TOKENS, 0,
                         budget_frac=0.5, chunk_size=1024)
        torch.cuda.synchronize()
    launches["a/chunked"] = _engine_launches("arctic bf16 chunked", "phase 12")
    summary.update(peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   moe=tap.report(cfg), kernel_calls=rec.check(),
                   launches=launches["a/chunked"])
    out["a/chunked"] = summary
    log("[phase12] (a) bf16 2 layers, phase 4's trace: " + json.dumps(summary))

    # (b) the prefix cache through the sync and the async loop
    runs = {}
    for arm, depth in (("sync", 0), ("async", 1)):
        torch.cuda.reset_peak_memory_stats()
        with SyncFreeDispatch() as guard:
            run = prefix_run(bundle, params, f"arctic {arm}", prefix_cache=True,
                             async_depth=depth)
        if depth and guard.calls != run["stats"]["step_calls"]:
            raise AssertionError(f"phase 12 async: {guard.calls} checked "
                                 f"dispatches, {run['stats']}")
        if run["stats"]["prefix_hits"] < 2:
            raise AssertionError(f"phase 12 {arm}: prefix stats {run['stats']}")
        run["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        runs[arm] = run
        launches[f"b/{arm}"] = run["launches"]
    if runs["async"]["tokens"] != runs["sync"]["tokens"]:
        raise AssertionError("phase 12: the async loop's streams differ from sync")
    out["b/prefix"] = {arm: {k: v for k, v in r.items() if k != "tokens"}
                       for arm, r in runs.items()}
    log("[phase12] (b) prefix cache, sync vs async: " + json.dumps(out["b/prefix"]))

    # (d) the CLI's engine and fixed-batch modes
    cli_pol = policy.with_updates(**CLI_POLICY)
    for mode, fixed, need in (("engine", False, ENGINE_KERNELS),
                              ("fixed-batch", True, ("block_sparse_attention",
                                                     "antidiag_pool",
                                                     "value_magnitude"))):
        torch.cuda.synchronize()
        reset_all_launches()
        rec = recs.setdefault(f"cli/{mode}", replay.Recorder())
        res, _, _ = _glm_cli(fixed, cfg, bundle, params, cli_pol, "fused", rec,
                             arch="arctic-480b")
        n = read_all_launches()
        missing = [k for k in need if n[k] == 0]
        if missing:
            raise AssertionError(f"phase 12 cli {mode}: kernels never launched: "
                                 f"{missing}")
        if res.get("failed"):
            raise AssertionError(f"phase 12 cli {mode}: failed {res['failed']}")
        launches[f"d/cli {mode}"] = n
        keys = ("ttft_s", "ms_per_token") if fixed else (
            "wall_s", "ttft_ms_mean", "tpot_ms_mean")
        out[f"d/cli/{mode}"] = dict({k: res[k] for k in keys},
                                    kernel_calls=rec.check())
        log(f"[phase12] (d) cli {mode}: " + json.dumps(out[f"d/cli/{mode}"]))
    del params, rec, recs
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[phase12] bf16 freed: {torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB "
        "still allocated")

    # (c) fp32, 1 layer, strict
    cfg = ARCTIC_480B.replace(num_layers=1, dtype="float32")
    bundle = registry.build(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(1),
                                device="cuda")
    torch.cuda.synchronize()
    out["fp32/init"] = dict(weights_gib=torch.cuda.memory_allocated() / 2 ** 30)
    trace = [(1531, 16, 0), (3907, 16, 0), (2600, 8, 2)]
    reset_all_launches()
    with replay.Recorder() as rec:
        fused = _serve_small(cfg, policy, trace, params, "fused", False)
        torch.cuda.synchronize()
    launches["c/fused"] = _engine_launches("arctic fp32 fused", "phase 12")
    gather = _serve_small(cfg, policy, trace, params, "gather", False)
    if fused != gather:
        raise AssertionError("phase 12 fp32: fused and gather streams differ")
    out["c/fused_vs_gather"] = dict(equal=True, kernel_calls=rec.check(),
                                    launches=launches["c/fused"])
    rng = np.random.RandomState(13)
    prompt = rng.randint(0, cfg.vocab_size, size=(4096,)).astype(np.int32)
    new = 16
    ecfg = engine_lib.EngineConfig.for_trace(
        max_slots=1, max_prompt=len(prompt), max_new_tokens=new,
        page_size=policy.block_size, budget_frac=1.0, monolithic_prefill=True)
    reset_all_launches()
    with replay.Recorder() as rec, MoETap(chunk=0) as tap:
        fin = engine_lib.StemEngine(bundle, params, policy, ecfg).run(
            [engine_lib.Request(uid=0, prompt=prompt, max_new_tokens=new)])
        torch.cuda.synchronize()
    n = read_all_launches()
    need = ("score/decode", "attend/decode", "block_sparse_attention",
            "antidiag_pool", "value_magnitude")
    missing = [k for k in need if n[k] == 0]
    if missing:
        raise AssertionError(f"phase 12 monolithic: kernels never launched: {missing}")
    launches["c/monolithic"] = n
    stream = fin[0].tokens
    rows = _fixed_batch_teacher_forced(bundle, params, policy, prompt, stream)
    fixed = [int(r.argmax()) for r in rows]
    t = next((i for i, (a, b) in enumerate(zip(stream, fixed)) if a != b), None)
    res = dict(equal=t is None, kernel_calls=rec.check(), moe=tap.report(cfg),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    if t is not None:
        margin = float(rows[t][fixed[t]] - rows[t][stream[t]])
        res.update(parting_step=t, margin=margin)
        if not margin <= FP32_MARGIN:
            raise AssertionError(f"phase 12 fp32: monolithic engine parts from "
                                 f"the fixed batch at step {t} by {margin}")
    out["c/monolithic_vs_fixed"] = res
    log("[phase12] (c) fp32 1 layer: " + json.dumps(
        {k: out[k] for k in ("fp32/init", "c/fused_vs_gather",
                             "c/monolithic_vs_fixed")}))
    del params
    torch.cuda.empty_cache()
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# Phase 13: MLA and deepseek-v3-671b
# ---------------------------------------------------------------------------

# MLA's (q/k, v) head_dim pairs at deepseek-v3-671b's published widths: its
# attention (nope 128 + rope 64 against v 128) and its MTP layer's dense
# attention (192 throughout); the record tags of the kernels line.
MLA_PAIRS = {"d192v128": (192, 128), "d192": (192, 192)}
# The reference's refusal of a config without a page layout.
MLA_REFUSAL = ("paged serving supports ('dense', 'moe') sub-layers, got "
               "'mla_dense' (arch deepseek-v3-671b)")


def mla_kernel_phase(records: dict, dev=torch.device("cuda")) -> None:
    """Phase 13 (d): flash and block-sparse attention at MLA's pairs and
    deepseek-v3-671b's 128 query / 128 KV heads, one 16384-token prompt,
    block 128, stem's TPD selection: each against its plain version in fp32
    (the CUDA-core tile, 1e-4) and bf16 (the tensor-core tile at each pair
    its own instance, whose counter must move: the p_bf16 rule, which must
    reject a dropped key tile), the bf16 calls timed beside their bound,
    SDPA (flash) and a compiled flex_attention over the same BlockMask
    (block-sparse), where those take the shape.  Then the reduced config's
    (24, 16), checked only (4 heads, 4096 tokens, block 8, the CUDA-core
    tile)."""
    n, h, bs = 16384, 128, 128
    policy = policy_lib.get_policy("stem")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    from torch.nn.attention.flex_attention import flex_attention
    # Earlier phases' flex_attention shapes used up dynamo's recompile
    # limit, past which it runs flex eagerly (the full score matrix: 128
    # GiB here); start from empty caches.
    torch._dynamo.reset()
    flex = torch.compile(flex_attention, dynamic=False)
    gen = torch.Generator(device=dev).manual_seed(21)
    for tag, (d, dv) in MLA_PAIRS.items():
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            es = torch.tensor([], dtype=dtype).element_size()
            q = torch.randn((1, h, n, d), generator=gen, device=dev).to(dtype)
            k = torch.randn((1, h, n, d), generator=gen, device=dev).to(dtype)
            v = torch.randn((1, h, n, dv), generator=gen, device=dev).to(dtype)
            bf16 = dtype == torch.bfloat16

            # -- kernel 4: flash ------------------------------------------
            run_k = lambda: flash_kern.flash_attention(q, k, v)
            run_p = lambda: flash_kern.flash_attention_plain(q, k, v)
            wg = forward_route(dtype, d, dv) == "wgmma"
            reset_all_launches()
            got, want = run_k(), run_p()
            torch.cuda.synchronize()
            _need(read_all_launches(), [wgmma_counter("flash_attention", d, dv)] if wg else [],
                  f"phase 13 flash_attention {tag} {dname}")
            err = check_close(f"flash_attention/{tag}/{dname}", got, want, p_bf16=wg)
            log(f"[phase13] flash_attention {tag} {dname}: max_abs_err={err:.3e}")
            if bf16:
                check_rejects_dropped_tile(f"flash_attention {tag}", q, k, v,
                                           *identity_selection(1, h, n // bs, dev), want, bs,
                                           p_bf16=wg)
                run_l = lambda: sdpa(q, k, v, is_causal=True)
                try:
                    check_library(f"flash_attention {tag} vs "
                                  "scaled_dot_product_attention", run_l(), got)
                except Exception as e:  # the library is only timed beside it
                    log(f"[phase13] SDPA at {tag} failed, no library time: "
                        f"{type(e).__name__}: {str(e).splitlines()[0][:200]}")
                    run_l = None
                pairs = h * n * (n + 1) / 2
                rec_kernel(records, "flash_attention", tag, dname, err, run_k, run_p,
                           ((q.numel() + k.numel()) * es + 2 * v.numel() * es,
                            2.0 * (d + dv) * pairs), dtype, run_lib=run_l,
                           iters=3, plain_iters=1)
            del got, want

            # -- kernel 3: block-sparse under stem's selection ------------
            sel, _ = policy.prefill_select(q, k, v, with_block_mask=False)
            idx, cnt = sel.indices, sel.live_counts
            run_k = lambda: bsa_kern.block_sparse_attention(q, k, v, idx, live_counts=cnt,
                                                            block_size=bs)
            run_p = lambda: bsa_kern.block_sparse_attention_plain(q, k, v, idx, cnt,
                                                                  block_size=bs)
            wg = forward_route(dtype, d, dv, bs) == "wgmma"
            reset_all_launches()
            got, want = run_k(), run_p()
            torch.cuda.synchronize()
            _need(read_all_launches(),
                  [wgmma_counter("block_sparse_attention", d, dv)] if wg else [],
                  f"phase 13 block_sparse_attention {tag} {dname}")
            err = check_close(f"block_sparse_attention/{tag}/{dname}", got, want, p_bf16=wg)
            log(f"[phase13] block_sparse_attention {tag} {dname}: max_abs_err="
                f"{err:.3e}, k_max {idx.shape[-1]}, realized density "
                f"{float(selection_density(sel, n // bs)):.4f}")
            if bf16:
                check_rejects_dropped_tile(f"block_sparse_attention {tag}", q, k, v,
                                           idx, cnt, want, bs, p_bf16=wg)
                mask = flex_block_mask(idx, cnt, bs)
                run_l = lambda: flex(q, k, v, block_mask=mask)
                try:
                    check_library(f"block_sparse_attention {tag} vs flex_attention",
                                  run_l(), want)
                except Exception as e:  # the library is only timed beside it
                    log(f"[phase13] flex_attention at {tag} failed, no library "
                        f"time: {type(e).__name__}: {str(e).splitlines()[0][:200]}")
                    run_l = None
                rec_kernel(records, "block_sparse_attention", tag, dname, err,
                           run_k, run_p,
                           bsa_bytes_flops(q, k, idx, cnt, 1, False, bs, dv=dv),
                           dtype, run_lib=run_l, iters=3, plain_iters=1)
                del mask
            del q, k, v, got, want, sel, idx, cnt
            torch.cuda.empty_cache()

    # the reduced config's (24, 16): checked, not timed
    gen = torch.Generator(device=dev).manual_seed(22)
    n, h, bs = 4096, 4, 8
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn((1, h, n, 24), generator=gen, device=dev).to(dtype)
        k = torch.randn((1, h, n, 24), generator=gen, device=dev).to(dtype)
        v = torch.randn((1, h, n, 16), generator=gen, device=dev).to(dtype)
        pol = policy.with_updates(block_size=bs, stride=4)
        sel, _ = pol.prefill_select(q, k, v, with_block_mask=False)
        errs = [check_close(f"flash_attention/d24v16/{dtype}",
                            flash_kern.flash_attention(q, k, v),
                            flash_kern.flash_attention_plain(q, k, v)),
                check_close(f"block_sparse_attention/d24v16/{dtype}",
                            bsa_kern.block_sparse_attention(
                                q, k, v, sel.indices, live_counts=sel.live_counts,
                                block_size=bs),
                            bsa_kern.block_sparse_attention_plain(
                                q, k, v, sel.indices, sel.live_counts, block_size=bs))]
        log(f"[phase13] d24v16 {dtype}: flash / block-sparse max_abs_err "
            f"{errs[0]:.3e} / {errs[1]:.3e}")
    del q, k, v, sel
    torch.cuda.empty_cache()


def _need(launches: dict, need, what: str) -> dict:
    missing = [k for k in need if launches[k] == 0]
    if missing:
        raise AssertionError(f"{what}: kernels never launched: {missing}")
    return launches


def _refuses(what: str, fn) -> str:
    """``fn()`` must raise the reference's NotImplementedError for MLA."""
    try:
        fn()
    except NotImplementedError as e:
        if str(e) != MLA_REFUSAL:
            raise AssertionError(f"phase 13 {what}: refused with {e!r}") from e
        log(f"[phase13] {what} refused: {e}")
        return str(e)
    raise AssertionError(f"phase 13 {what}: MLA was not refused")


def _stem_vs_dense_prefill(cfg, params, n: int, profile: bool) -> dict:
    """(b) One n-token one-shot prefill, stem (paper defaults, block 128)
    against dense: ms (host clock around a synchronized call, after a
    1024-token warm-up), layer 0's realized density, launches; with
    ``profile`` a third, traced run of each arm."""
    bundle = registry.build(cfg)
    policy = policy_lib.get_policy("stem")
    rng = np.random.RandomState(23)
    tokens = torch.as_tensor(rng.randint(0, cfg.vocab_size, size=(1, n)), device="cuda")
    out = {}
    pair = (cfg.mla.nope_head_dim + cfg.mla.rope_head_dim, cfg.mla.v_head_dim)
    for arm, stem_cfg, need in (
            ("stem", policy, ("block_sparse_attention", "antidiag_pool", "value_magnitude",
                              wgmma_counter("block_sparse_attention", *pair))),
            ("dense", None, ("flash_attention", wgmma_counter("flash_attention", *pair)))):
        step = steps_lib.make_prefill_step(bundle, max_len=n, stem_cfg=stem_cfg)
        step(params, {"tokens": tokens[:, :1024]})        # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_all_launches()
        t0 = time.perf_counter()
        logits, caches = step(params, {"tokens": tokens})
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = _need(read_all_launches(), need, f"phase 13 prefill {arm}")
        if not torch.isfinite(logits).all():
            raise AssertionError(f"phase 13 prefill {arm}: non-finite logits")
        if caches[0]["sub0"].c_kv.dtype != torch.bfloat16:
            raise AssertionError("phase 13: the latent cache is not bf16")
        del logits, caches
        density = 1.0
        if stem_cfg is not None:
            x = transformer._embed_inputs(params, {"tokens": tokens}, cfg)
            p0 = transformer._index(params["segment0"], 0)["sub0"]
            h = common.rms_norm(x, p0["norm1"])
            _, stats = mla_lib.apply_full(p0["attn"], h, cfg,
                                          positions=torch.arange(n, device="cuda"),
                                          stem_cfg=stem_cfg, return_stats=True)
            density = float(stats.density)
            del x, h, stats
        out[arm] = dict(ms=ms, density=density,
                        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                        launches={k: v for k, v in launches.items() if v})
        log(f"[phase13] (b) prefill {arm}: n={n} {ms:.1f} ms, realized density "
            f"{density:.4f}, launches {out[arm]['launches']}")
        torch.cuda.empty_cache()
        if profile:
            act = torch.profiler.ProfilerActivity
            with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
                t0 = time.perf_counter()
                step(params, {"tokens": tokens})
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            log(f"[profile] phase 13 prefill/{arm}:")
            profile_summary(prof, wall)
            torch.cuda.empty_cache()
    return out


def _fixed_batch_stream(bundle, params, toks, lens, new: int, stem_cfg):
    """The fixed batch's path with a policy-sparse prefill: a right-padded
    ragged prefill under ``stem_cfg``, then dense decode (MLA decodes
    densely) for ``new`` tokens.  Returns (prefill logits, {row: stream},
    {row: the logits rows (host, fp32) its tokens were chosen from})."""
    last = torch.as_tensor(lens - 1, device="cuda")
    logits, caches = bundle.prefill(params, {"tokens": toks}, max_len=toks.shape[1] + new,
                                    stem_cfg=stem_cfg, last_pos=last)
    first = logits.float().clone()
    serve = steps_lib.make_serve_step(bundle)
    streams, rows = {i: [] for i in range(len(lens))}, {i: [] for i in range(len(lens))}
    for t in range(new):
        host = logits.float().cpu()
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        for i in streams:
            streams[i].append(int(tok[i, 0]))
            rows[i].append(host[i])
        if t + 1 < new:
            logits, caches = serve(params, tok, caches,
                                   torch.as_tensor(lens, device="cuda") if t == 0 else None)
    return first, streams, rows


def deepseek_phase(profile: bool = False) -> dict:
    """Phase 13: deepseek-v3-671b (MLA: q rank 1536, latent 512, rope 64,
    nope 128, v 128; 128 heads; 256 experts top-8 of d_ff 2048, one shared
    expert, first_k_dense 3 of d_ff 18432; vocab 129280, untied head; the
    MTP head) at its published widths, depth cut from 61 layers to what
    one 80 GB card holds.  Random weights drawn on the card from a seeded
    generator.  (a) bf16 4 layers (3 mla_dense + 1 mla_moe): the CLI's
    --fixed-batch (MLA decodes densely, as in the reference) on 3 prompts
    of 2000-6000 tokens, 16 new tokens, every kernel call recorded and
    held against its plain version; the engine modes and the policy-sparse
    fixed batch refused with the reference's NotImplementedError.  (b) The
    same weights: one 16384-token one-shot prefill, stem against dense.
    (c) fp32 2 layers (first_k_dense cut to 1: one mla_dense + one
    mla_moe), stem at the CLI's geometry (block 128, stride 4): "fused" ==
    "gather" prefill logits (within 1e-4 of their scale) and greedy streams
    (then dense decode, 16 tokens) on a ragged batch of 3072 / 1900, and
    loss_fn's ce / mtp_ce / aux under "fused", "gather" and the "dense"
    oracle executor and dense attention within 1e-4 (aux 1e-5 relative)."""
    out, launches = {}, {}
    gc.collect()
    torch.cuda.empty_cache()
    out["allocated_before_gib"] = torch.cuda.memory_allocated() / 2 ** 30
    cfg = DEEPSEEK_V3_671B.replace(num_layers=4)
    bundle = registry.build(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0),
                                device="cuda")
    torch.cuda.synchronize()
    out["bf16/init"] = dict(s=time.perf_counter() - t0,
                            program=transformer.layer_program(cfg),
                            weights_gib=torch.cuda.memory_allocated() / 2 ** 30,
                            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    log("[phase13] bf16 4 layers drawn: " + json.dumps(out["bf16/init"]))

    # (a) the CLI's fixed batch, and its refusals
    args = serve_lib.build_parser().parse_args(
        ["--arch", "deepseek-v3-671b", "--requests", "3", "--min-prompt", "2000",
         "--max-prompt", "6000", "--decode-tokens", "16", "--fixed-batch"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    with replay.Recorder() as rec, SamplerTap() as tap:
        res = serve_lib.run_fixed_batch(args, cfg, bundle, params, None, 1.0)
        torch.cuda.synchronize()
    launches["a/fixed-batch"] = _need(read_all_launches(), ("flash_attention",),
                                      "phase 13 cli fixed batch")
    if not all(bool(torch.isfinite(c).all()) for c in tap.calls):
        raise AssertionError("phase 13 cli fixed batch: non-finite logits")
    if any(len(t) != 16 for t in res["tokens"].values()):
        raise AssertionError(f"phase 13 cli fixed batch: {res['tokens']}")
    out["a/fixed-batch"] = dict(
        prompt_lens=res["prompt_lens"], ttft_s=res["ttft_s"],
        ms_per_token=res["ms_per_token"],
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        kernel_calls=rec.check(), launches=launches["a/fixed-batch"])
    log("[phase13] (a) cli fixed batch, bf16 4 layers: " + json.dumps(out["a/fixed-batch"]))
    del rec, tap
    pol = policy_lib.get_policy("stem").with_updates(**CLI_POLICY)
    base = cli_args("deepseek-v3-671b", 2000, 6000, 16)
    for mode, extra in (("engine", ()), ("monolithic", ("--monolithic",)),
                        ("fixed-batch --policy stem", ("--fixed-batch",))):
        a = serve_lib.build_parser().parse_args(base + list(extra))
        run = serve_lib.run_fixed_batch if a.fixed_batch else serve_lib.run_engine
        out[f"a/refused/{mode}"] = _refuses(
            f"cli {mode}", lambda: run(a, cfg, bundle, params, pol, a.budget_frac))
    torch.cuda.empty_cache()

    # (b) the paper's comparison on this backbone
    out["b/prefill"] = _stem_vs_dense_prefill(cfg, params, 16384, profile)
    for arm, r in out["b/prefill"].items():
        launches[f"b/{arm}"] = {k: r["launches"].get(k, 0) for k in read_all_launches()}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[phase13] bf16 freed: {torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB "
        "still allocated")

    # (c) fp32, 2 layers, strict
    cfg = DEEPSEEK_V3_671B.replace(
        num_layers=2, dtype="float32",
        moe=dataclasses.replace(DEEPSEEK_V3_671B.moe, first_k_dense=1))
    bundle = registry.build(cfg)
    meta = bundle.init_params(torch.Generator(), device="meta")
    need_gib = sum(t.numel() * t.element_size() for t in _leaves(meta)) / 2 ** 30
    free_gib = torch.cuda.mem_get_info()[0] / 2 ** 30
    log(f"[phase13] fp32 2 layers: {need_gib:.2f} GiB of weights, {free_gib:.2f} GiB free")
    if need_gib + 12 > free_gib:
        raise AssertionError(f"phase 13 fp32: {need_gib:.2f} GiB of weights do not "
                             f"fit {free_gib:.2f} GiB with 12 GiB to run")
    torch.cuda.reset_peak_memory_stats()
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(1),
                                device="cuda")
    torch.cuda.synchronize()
    out["fp32/init"] = dict(program=transformer.layer_program(cfg),
                            weights_gib=torch.cuda.memory_allocated() / 2 ** 30)
    # the CLI's stem geometry (sparse at these lengths); the gather
    # executor streams 2 slots a chunk, to bound its temporaries at 128 heads
    policy = policy_lib.get_policy("stem").with_updates(slot_chunk=2, **CLI_POLICY)
    rng = np.random.RandomState(29)
    lens = np.array([3072, 1900], np.int32)
    toks = torch.zeros((2, 3072), dtype=torch.int32, device="cuda")
    for i, L in enumerate(lens):
        toks[i, :L] = torch.as_tensor(rng.randint(0, cfg.vocab_size, size=(int(L),)))
    runs = {}
    for executor in ("fused", "gather"):
        reset_all_launches()
        rec = replay.Recorder() if executor == "fused" else contextlib.nullcontext()
        with rec:
            runs[executor] = _fixed_batch_stream(
                bundle, params, toks, lens, 16, policy.with_updates(executor=executor))
            torch.cuda.synchronize()
        if executor == "fused":
            launches["c/fused"] = _need(read_all_launches(),
                                        ("block_sparse_attention", "antidiag_pool",
                                         "value_magnitude"), "phase 13 fp32 fused prefill")
            out["c/kernel_calls"] = rec.check()
    (lf, sf, rf), (lg, sg, rg) = runs["fused"], runs["gather"]
    scale = float(lg.abs().max())
    diff = float((lf - lg).abs().max())
    out["c/prefill_logits"] = dict(max_abs_diff=diff, scale=scale,
                                   limit=1e-4 * scale)
    if not diff <= 1e-4 * scale:
        raise AssertionError(f"phase 13 fp32: fused and gather prefill logits differ "
                             f"by {diff} (scale {scale})")
    out["c/streams"] = check_partings("fp32 fused vs gather (prefill, dense decode)",
                                      sf, rf, sg, rg, "float32", phase="phase13")
    if sf != sg:
        raise AssertionError("phase 13 fp32: fused and gather streams differ")
    del runs, lf, lg, rf, rg
    # loss_fn under every executor and dense attention, 2048 tokens
    seq = torch.as_tensor(rng.randint(0, cfg.vocab_size, size=(1, 2049)), device="cuda")
    batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
    losses = {}
    for arm, pol in (("fused", policy), ("gather", policy.with_updates(executor="gather")),
                     ("dense-oracle", policy.with_updates(executor="dense")),
                     ("dense", None)):
        reset_all_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = bundle.loss_fn(params, batch, stem_cfg=pol)
        torch.cuda.synchronize()
        losses[arm] = {k: float(v) for k, v in m.items()}
        losses[arm]["ms"] = (time.perf_counter() - t0) * 1e3
        if arm == "fused":
            launches["c/loss_fn"] = _need(read_all_launches(),
                                          ("block_sparse_attention", "flash_attention",
                                           "antidiag_pool", "value_magnitude"),
                                          "phase 13 fp32 loss_fn")
    out["c/loss_fn"] = losses
    log("[phase13] (c) fp32 loss_fn: " + json.dumps(losses))
    for arm in ("gather", "dense-oracle"):
        for key in ("ce", "mtp_ce", "loss"):
            if not abs(losses[arm][key] - losses["fused"][key]) <= 1e-4:
                raise AssertionError(f"phase 13 fp32 loss_fn: {key} of {arm} "
                                     f"differs from fused")
        if not abs(losses[arm]["aux"] - losses["fused"]["aux"]) <= \
                1e-5 * abs(losses["fused"]["aux"]):
            raise AssertionError(f"phase 13 fp32 loss_fn: aux of {arm} differs")
    if not all(np.isfinite(v) for r in losses.values() for v in r.values()):
        raise AssertionError("phase 13 fp32 loss_fn: non-finite values")
    out["fp32/peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log("[phase13] (c) fp32 2 layers: " + json.dumps(
        {k: out[k] for k in ("fp32/init", "c/prefill_logits", "c/kernel_calls",
                             "fp32/peak_gib")}))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# Phase 14: the SSM, hybrid, encoder-decoder and VLM-stub families
# ---------------------------------------------------------------------------

# Phase 14's sizes: (a) mamba2's prompt, (b) recurrentgemma's (past its 2048
# window), (c) whisper's decoder prompt over its 1500 stub frames, (d)
# pixtral's patch and text positions; greedy decode steps after (a) / (b)
# and after (c) / (d); the depth and prompt lengths of the fp32 checks.
P14 = dict(mamba_n=16384, rg_n=8192, whisper_n=4096, pixtral_patches=4096,
           pixtral_text=12288, decode=32, decode_short=16, check_layers=4,
           mamba_check_n=1000, rg_check_n=2100, whisper_check_n=2048,
           pixtral_check_patches=512, pixtral_check_text=1536, warm=1024, gemma_n=8192)
STEM_KERNELS = ("block_sparse_attention", "antidiag_pool", "value_magnitude")


def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def _draw(cfg, seed: int, what: str):
    """registry.build(cfg) and its parameters drawn on the card from a
    seeded generator.  Returns (bundle, params, info)."""
    bundle = registry.build(cfg)
    _free()
    before = torch.cuda.memory_allocated()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(seed),
                                device="cuda")
    torch.cuda.synchronize()
    info = dict(s=time.perf_counter() - t0, params=registry.param_counts(cfg)[0],
                weights_gib=(torch.cuda.memory_allocated() - before) / 2 ** 30,
                layers=cfg.num_layers, dtype=cfg.dtype)
    log(f"[phase14] {what} drawn: " + json.dumps(info))
    return bundle, params, info


def _family_batch(cfg, n: int, seed: int, patches: int = 0, b: int = 1) -> dict:
    """Token prompts (b, n) and the stub inputs: whisper's frame embeddings,
    pixtral's ``patches`` patch embeddings; seeded, on the card."""
    rng = np.random.RandomState(seed)
    batch = {"tokens": torch.as_tensor(rng.randint(0, cfg.vocab_size, size=(b, n)),
                                       dtype=torch.int32, device="cuda")}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((b, cfg.encdec.encoder_frames, cfg.d_model),
                                      generator=gen, device="cuda").to(cfg.torch_dtype)
    if patches:
        batch["patch_embeds"] = torch.randn((b, patches, cfg.d_model), generator=gen,
                                            device="cuda").to(cfg.torch_dtype)
    return batch


def _head(batch: dict, n: int, patches: int = 0) -> dict:
    """The batch cut to its first ``n`` tokens (and ``patches`` patches)."""
    out = {k: v for k, v in batch.items() if k not in ("tokens", "patch_embeds")}
    out["tokens"] = batch["tokens"][:, :n]
    if "patch_embeds" in batch:
        out["patch_embeds"] = batch["patch_embeds"][:, :patches]
    return out


def _generate(bundle, params, batch: dict, max_len: int, steps: int, stem_cfg=None):
    """The prefill (timed: host clock around a synchronized call), then
    ``steps`` greedy dense decode steps (timed the same way).  Returns
    (prefill logits fp32, stream (b, steps), every decode logits row fp32 on
    the host, prefill ms, decode ms per token, caches)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = bundle.prefill(params, batch, max_len=max_len, stem_cfg=stem_cfg)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    first = logits.float().clone()
    toks, rows = [], []
    t0 = time.perf_counter()
    for _ in range(steps):
        rows.append(logits.float())
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        toks.append(tok)
        logits, caches = bundle.decode_step(params, tok, caches)
    torch.cuda.synchronize()
    per_token = (time.perf_counter() - t0) * 1e3 / max(steps, 1)
    rows = torch.stack(rows, 1).cpu()
    if not (torch.isfinite(first).all() and torch.isfinite(rows).all()):
        raise AssertionError("phase 14: non-finite logits")
    return first, torch.cat(toks, 1).cpu(), rows, prefill_ms, per_token, caches


def _decode_equals_prefill(cfg, n: int, seed: int, what: str) -> dict:
    """fp32 at full width, depth cut: ``decode_step`` after ``prefill(n)``
    against ``prefill(n + 1)``'s last logits, within 1e-4."""
    bundle, params, info = _draw(cfg, seed, f"{what} fp32 {cfg.num_layers} layers")
    batch = _family_batch(cfg, n + 1, seed + 1)
    _, caches = bundle.prefill(params, _head(batch, n), max_len=n + 1)
    step, _ = bundle.decode_step(params, batch["tokens"][:, n:n + 1], caches)
    full, _ = bundle.prefill(params, batch, max_len=n + 1)
    gap = float((step.float() - full.float()).abs().max())
    out = dict(n=n, max_abs_gap=gap, logit_scale=float(full.float().abs().max()),
               weights_gib=info["weights_gib"])
    log(f"[phase14] {what} fp32: decode after prefill({n}) vs prefill({n + 1}): "
        + json.dumps(out))
    if not gap <= 1e-4:
        raise AssertionError(f"phase 14 {what}: decode after prefill({n}) differs "
                             f"from prefill({n + 1}) by {gap}")
    del params, caches
    _free()
    return out


def _fused_equals_gather(cfg, batch_fn, n_prompt: int, steps: int, seed: int,
                         what: str) -> dict:
    """fp32 at full width, depth cut: the prefill under stem at the CLI's
    geometry (block 128, stride 4) with the "fused" and the "gather"
    executor, then ``steps`` greedy dense decode steps: prefill logits
    within 1e-4 of their scale, streams equal; the fused run's kernel calls
    recorded and held against their plain versions."""
    bundle, params, info = _draw(cfg, seed, f"{what} fp32 {cfg.num_layers} layers")
    batch = batch_fn(cfg)
    policy = policy_lib.get_policy("stem").with_updates(**CLI_POLICY)
    runs, out = {}, dict(weights_gib=info["weights_gib"])
    for executor in ("fused", "gather"):
        reset_all_launches()
        rec = replay.Recorder() if executor == "fused" else contextlib.nullcontext()
        with rec:
            runs[executor] = _generate(bundle, params, batch, n_prompt + steps, steps,
                                       policy.with_updates(executor=executor))[:3]
        if executor == "fused":
            out["launches"] = _need(read_all_launches(), STEM_KERNELS,
                                    f"phase 14 {what} fp32 fused")
            out["kernel_calls"] = rec.check()
    (lf, sf, _), (lg, sg, _) = runs["fused"], runs["gather"]
    scale = float(lg.abs().max())
    out.update(max_abs_diff=float((lf - lg).abs().max()), scale=scale,
               streams_equal=bool(torch.equal(sf, sg)))
    log(f"[phase14] {what} fp32 fused vs gather: " + json.dumps(out))
    if not out["max_abs_diff"] <= 1e-4 * scale:
        raise AssertionError(f"phase 14 {what}: fused and gather prefill logits differ")
    if not out["streams_equal"]:
        raise AssertionError(f"phase 14 {what}: fused and gather streams differ")
    del params
    _free()
    return out


def _layer0_density(cfg, params, batch, stem_cfg) -> float:
    """Realized density of the first attention layer's selection."""
    if cfg.family == "encdec":
        layer = transformer._index(params["dec_layers"], 0)
        x = encdec_lib._dec_embed(params, batch["tokens"], cfg)
        h = common.layer_norm_simple(x, layer["norm1"])
        attn = layer["self_attn"]
    else:
        x = transformer._embed_inputs(params, batch, cfg)
        p0 = transformer._index(params["segment0"], 0)["sub0"]
        h = common.rms_norm(x, p0["norm1"])
        attn = p0["attn"]
    _, stats = attention_lib.apply_full(attn, h, cfg,
                                        positions=torch.arange(h.shape[1], device="cuda"),
                                        stem_cfg=stem_cfg, return_stats=True)
    return float(stats.density)


def _prefill_arms(what, cfg, bundle, params, batch, warm, max_len, stem_cfg,
                  profile: bool) -> tuple:
    """One prefill under ``stem_cfg`` and one dense, each after a short
    warm-up: ms (host clock around a synchronized call), launches (kernels
    3, 5 and 6 must launch under stem, kernel 4 dense), peak memory, the
    realized density of the first attention layer; every kernel call
    recorded and held against its plain version.  With ``profile`` a third,
    traced run of each arm gives the device's busy share.  Returns (report,
    {arm: the recorder})."""
    out, recs = {}, {}
    for arm, pol, need in (("stem", stem_cfg, STEM_KERNELS),
                           ("dense", None, ("flash_attention",))):
        bundle.prefill(params, warm, max_len=max_len, stem_cfg=pol)
        _free()
        torch.cuda.reset_peak_memory_stats()
        reset_all_launches()
        with replay.Recorder() as rec:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = bundle.prefill(params, batch, max_len=max_len, stem_cfg=pol)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        launches = _need(read_all_launches(), need, f"phase 14 {what} prefill {arm}")
        if not torch.isfinite(logits).all():
            raise AssertionError(f"phase 14 {what} prefill {arm}: non-finite logits")
        del logits
        r = dict(ms=ms, peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                 launches=launches, kernel_calls=rec.check(),
                 density=1.0 if pol is None else _layer0_density(cfg, params, batch, pol))
        if profile:
            act = torch.profiler.ProfilerActivity
            with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
                t0 = time.perf_counter()
                bundle.prefill(params, batch, max_len=max_len, stem_cfg=pol)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            log(f"[profile] phase 14 {what} prefill/{arm}:")
            r["busy_share"] = profile_summary(prof, wall)
        out[arm], recs[arm] = r, rec
        log(f"[phase14] {what} prefill {arm}: " + json.dumps(
            {k: v for k, v in r.items() if k != "kernel_calls"}))
        _free()
    return out, recs


def _time_recorded(records: dict, lane: str, recs: dict, flex) -> None:
    """Each kernel's first recorded call of a prefill (layer 0's shapes)
    timed against its plain version on the recorded arguments, beside its
    bound and a library call of the same function (SDPA for flash, a
    compiled flex_attention over the same BlockMask for block-sparse, one
    ``mean`` for the pool; none for vmag)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    _, bsa_plain, _ = replay.KERNELS["block_sparse_attention"]
    a = recs["stem"].calls["block_sparse_attention"][0][0]
    q, k, v = a["q"], a["k"], a["v"]
    bs, group = a["block_size"], q.shape[1] // k.shape[1]
    idx, cnt = a["indices"], replay._live_counts(a)
    run_k = lambda: bsa_kern.block_sparse_attention(**a)
    run_p = lambda: bsa_plain(a)
    got, want = run_k(), run_p()
    torch.cuda.synchronize()
    err = check_close(f"block_sparse_attention/{lane}", got, want,
                      p_bf16=replay.KERNELS["block_sparse_attention"][2](a))
    mask = flex_block_mask(idx, cnt, bs)
    run_l = lambda: flex(q, k, v, block_mask=mask, enable_gqa=True, scale=a["scale"])
    try:
        check_library(f"block_sparse_attention {lane} vs flex_attention", run_l(), want)
    except Exception as e:  # the library is only timed beside the kernel
        log(f"[phase14] flex_attention at {lane} failed, no library time: "
            f"{type(e).__name__}: {str(e).splitlines()[0][:200]}")
        run_l = None
    rec_kernel(records, "block_sparse_attention", lane, "bfloat16", err, run_k, run_p,
               bsa_bytes_flops(q, k, idx, cnt, group, a["group_dedup"], bs),
               q.dtype, run_lib=run_l, iters=5, plain_iters=1)

    a = recs["dense"].calls["flash_attention"][0][0]
    q, k, v = a["q"], a["k"], a["v"]
    d, n = q.shape[-1], q.shape[2]
    run_k = lambda: flash_kern.flash_attention(**a)
    run_p = lambda: replay.KERNELS["flash_attention"][1](a)
    run_l = lambda: sdpa(q, k, v, is_causal=True, scale=a["scale"], enable_gqa=True)
    got, want = run_k(), run_p()
    torch.cuda.synchronize()
    err = check_close(f"flash_attention/{lane}", got, want,
                      p_bf16=replay.KERNELS["flash_attention"][2](a))
    check_library(f"flash_attention {lane} vs scaled_dot_product_attention",
                  run_l(), got)
    es = q.element_size()
    rec_kernel(records, "flash_attention", lane, "bfloat16", err, run_k, run_p,
               ((2 * q.numel() + k.numel() + v.numel()) * es,
                2.0 * (d + v.shape[-1]) * q.shape[1] * n * (n + 1) / 2),
               q.dtype, run_lib=run_l, iters=5, plain_iters=1)

    pools = recs["stem"].calls["antidiag_pool"]
    for name, (a, _) in (("q", pools[0]), ("k", pools[1])):
        x, bsz, st, od = a["x"], a["block_size"], a["stride"], a["out_dtype"]
        run_k = lambda: metric_kern.antidiag_pool(**a)
        run_p = lambda: replay.KERNELS["antidiag_pool"][1](a)
        run_l = lambda: torch.mean(x.reshape(*x.shape[:-2], x.shape[-2] // bsz,
                                             bsz // st, st, x.shape[-1]), dim=-3, dtype=od)
        got, want = run_k(), run_p()
        torch.cuda.synchronize()
        err = check_close(f"antidiag_pool/{lane}_{name}", got, want)
        rec_kernel(records, "antidiag_pool", f"{lane}_{name}", "bfloat16", err, run_k,
                   run_p, (x.numel() * x.element_size() + got.numel() * got.element_size(),
                           float(x.numel())), x.dtype, run_lib=run_l)
    a = recs["stem"].calls["value_magnitude"][0][0]
    run_k = lambda: metric_kern.value_magnitude(**a)
    run_p = lambda: replay.KERNELS["value_magnitude"][1](a)
    got, want = run_k(), run_p()
    torch.cuda.synchronize()
    err = check_close(f"value_magnitude/{lane}", got, want)
    rec_kernel(records, "value_magnitude", lane, "bfloat16", err, run_k, run_p,
               (a["v"].numel() * a["v"].element_size() + got.numel() * 4,
                2.0 * a["v"].numel()), a["v"].dtype)


def _timed_family(cfg, n: int, seed: int, what: str, sizes: dict) -> tuple:
    """bf16 at full width and depth: an n-token prefill (after a short
    warm-up) and ``sizes["decode"]`` greedy decode steps; peak memory,
    the caches' GiB, the launches.  Returns (report, caches)."""
    bundle, params, info = _draw(cfg, 0, f"{what} bf16")
    steps = sizes["decode"]
    batch = _family_batch(cfg, n, seed)
    bundle.prefill(params, _head(batch, sizes["warm"]), max_len=sizes["warm"])
    _free()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    _, _, _, pre_ms, tok_ms, caches = _generate(bundle, params, batch, n + steps, steps)
    out = dict(init=info, n=n, prefill_ms=pre_ms, decode_ms_per_token=tok_ms,
               decode_tokens=steps, peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               cache_gib=sum(t.numel() * t.element_size() for c in caches
                             for s in c.values() for t in s) / 2 ** 30,
               launches=read_all_launches())
    log(f"[phase14] {what} bf16: " + json.dumps(out))
    del params
    _free()
    return out, caches


def mamba_arm(sizes: dict) -> dict:
    """(a) mamba2-370m, 48 SSD layers, bf16: an n-token prefill and greedy
    decode (the SSD blocks are einsums and scans, no kernel of the port);
    then the fp32 check at full width, 4 layers."""
    cfg = MAMBA2_370M
    out, _ = _timed_family(cfg, sizes["mamba_n"], 31, "(a) mamba2-370m", sizes)
    out["fp32_decode_check"] = _decode_equals_prefill(
        cfg.replace(num_layers=sizes["check_layers"], dtype="float32"),
        sizes["mamba_check_n"], 32, "(a) mamba2-370m")
    return out


def recurrentgemma_arm(sizes: dict) -> dict:
    """(b) recurrentgemma-2b, 26 layers (8 x (rec, rec, local) + 2 rec),
    bf16: a prompt past the 2048 window prefilled, greedy decode over the
    ring caches (their slots checked), peak memory; then the fp32 check at
    full width, 4 layers, at n >= the window."""
    cfg = RECURRENTGEMMA_2B
    out, caches = _timed_family(cfg, sizes["rg_n"], 33, "(b) recurrentgemma-2b", sizes)
    out["ring_slots"] = int(caches[0]["sub2"].k.shape[3])
    if out["ring_slots"] != min(cfg.rglru.window, sizes["rg_n"] + sizes["decode"]):
        raise AssertionError(f"phase 14 (b): ring cache of {out['ring_slots']} slots")
    del caches
    out["fp32_decode_check"] = _decode_equals_prefill(
        cfg.replace(num_layers=sizes["check_layers"], dtype="float32"),
        sizes["rg_check_n"], 34, "(b) recurrentgemma-2b")
    return out


def whisper_arm(records: dict, sizes: dict, flex, profile: bool) -> tuple:
    """(c) whisper-medium, 24 encoder + 24 decoder layers, bf16, 1500 stub
    frames and a decoder prompt: the prefill under stem at the CLI's
    geometry (block 128, stride 4) and dense (kernels 3, 5, 6 and 4 at
    head_dim 64, every call held against its plain version, layer 0's calls
    timed), loss_fn under both, greedy decode after the stem prefill; then
    fp32 at 4 + 4 layers: fused == gather.  Returns (report, launches)."""
    cfg = WHISPER_MEDIUM
    bundle, params, info = _draw(cfg, 0, "whisper-medium bf16")
    n, steps = sizes["whisper_n"], sizes["decode_short"]
    batch = _family_batch(cfg, n + 1, 41)
    prompt = _head(batch, n)
    stem = policy_lib.get_policy("stem").with_updates(**CLI_POLICY)
    out = dict(init=info, n=n, frames=cfg.encdec.encoder_frames)
    out["prefill"], recs = _prefill_arms("(c) whisper-medium", cfg, bundle, params,
                                         prompt, _head(batch, sizes["warm"]), n + steps,
                                         stem, profile)
    for arm, key, arg in (("stem", "block_sparse_attention", "q"),
                          ("stem", "antidiag_pool", "x"),
                          ("stem", "value_magnitude", "v"),
                          ("dense", "flash_attention", "q")):
        if any(a[arg].shape[-1] != cfg.head_dim for a, _ in recs[arm].calls[key]):
            raise AssertionError(f"phase 14 (c): {key} not at head_dim {cfg.head_dim}")
    launches = {f"whisper/{arm}": r["launches"] for arm, r in out["prefill"].items()}
    d = cfg.head_dim
    _need(launches["whisper/stem"], [wgmma_counter("block_sparse_attention", d, d)],
          "phase 14 (c) whisper stem prefill")
    _need(launches["whisper/dense"], [wgmma_counter("flash_attention", d, d)],
          "phase 14 (c) whisper dense prefill")
    _time_recorded(records, "whisper", recs, flex)
    del recs
    _free()
    labels = {**prompt, "labels": batch["tokens"][:, 1:n + 1]}
    for arm, pol in (("stem", stem), ("dense", None)):
        reset_all_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ce, _ = bundle.loss_fn(params, labels, stem_cfg=pol)
        torch.cuda.synchronize()
        out[f"loss_fn/{arm}"] = dict(ms=(time.perf_counter() - t0) * 1e3, ce=float(ce),
                                     launches={k: v for k, v in read_all_launches().items()
                                               if v})
        if not np.isfinite(float(ce)):
            raise AssertionError(f"phase 14 (c) loss_fn {arm}: non-finite")
    reset_all_launches()
    _, stream, _, pre_ms, tok_ms, _ = _generate(bundle, params, prompt, n + steps, steps,
                                                stem)
    out["generate"] = dict(prefill_ms=pre_ms, decode_ms_per_token=tok_ms,
                           decode_tokens=steps)
    log("[phase14] (c) whisper-medium bf16: " + json.dumps(
        {k: v for k, v in out.items() if k != "prefill"}))
    del params
    _free()
    layers = sizes["check_layers"]
    cfg32 = cfg.replace(num_layers=layers, dtype="float32",
                        encdec=dataclasses.replace(cfg.encdec, encoder_layers=layers))
    m = sizes["whisper_check_n"]
    out["fp32_fused_vs_gather"] = _fused_equals_gather(
        cfg32, lambda c: _family_batch(c, m, 42), m, steps, 43, "(c) whisper-medium")
    return out, launches


def pixtral_arm(sizes: dict, profile: bool) -> tuple:
    """(d) pixtral-12b, 40 layers, bf16: patch embeddings + text tokens
    prefilled one-shot under stem at the paper's defaults and dense (kernels
    3-6 on the wgmma tile: bf16, head_dim 128, block 128; every call held
    against its plain version), then greedy decode; then fp32 at 4 layers:
    fused == gather.  Returns (report, launches)."""
    cfg = PIXTRAL_12B
    bundle, params, info = _draw(cfg, 0, "pixtral-12b bf16")
    patches, text, steps = sizes["pixtral_patches"], sizes["pixtral_text"], sizes["decode_short"]
    n = patches + text
    batch = _family_batch(cfg, text, 51, patches=patches)
    w = sizes["warm"]
    warm = _head(batch, w - w // 4, w // 4)
    stem = policy_lib.get_policy("stem")
    out = dict(init=info, n=n, patches=patches, text=text)
    out["prefill"], recs = _prefill_arms("(d) pixtral-12b", cfg, bundle, params, batch,
                                         warm, n + steps, stem, profile)
    on_tile = [replay.KERNELS[key][2](a) for arm, key in
               (("stem", "block_sparse_attention"), ("dense", "flash_attention"))
               for a, _ in recs[arm].calls[key]]
    if not all(on_tile):
        raise AssertionError("phase 14 (d): an attention call off the wgmma tile")
    launches = {f"pixtral/{arm}": r["launches"] for arm, r in out["prefill"].items()}
    del recs
    _free()
    _, stream, _, pre_ms, tok_ms, _ = _generate(bundle, params, batch, n + steps, steps, stem)
    out["generate"] = dict(prefill_ms=pre_ms, decode_ms_per_token=tok_ms,
                           decode_tokens=steps)
    log("[phase14] (d) pixtral-12b bf16: " + json.dumps(
        {k: v for k, v in out.items() if k != "prefill"}))
    del params
    _free()
    cp, ct = sizes["pixtral_check_patches"], sizes["pixtral_check_text"]
    out["fp32_fused_vs_gather"] = _fused_equals_gather(
        cfg.replace(num_layers=sizes["check_layers"], dtype="float32"),
        lambda c: _family_batch(c, ct, 52, patches=cp), cp + ct, steps, 53,
        "(d) pixtral-12b")
    return out, launches


def gemma_arm(sizes: dict, profile: bool) -> tuple:
    """(e) gemma-2b at full width and depth (18 layers, 8 query heads over
    one KV head at head_dim 256), bf16: one prompt prefilled one-shot under
    stem at the paper's defaults and dense (kernels 3, 5, 6 under stem and
    4 dense, flash and block-sparse on their (256, 256) tensor-core
    instance, every call held against its plain version).  Returns
    (report, launches)."""
    cfg = GEMMA_2B
    bundle, params, info = _draw(cfg, 0, "gemma-2b bf16")
    n = sizes["gemma_n"]
    batch = _family_batch(cfg, n, 51)
    out = dict(init=info, n=n)
    out["prefill"], _ = _prefill_arms("(e) gemma-2b", cfg, bundle, params, batch,
                                      _head(batch, sizes["warm"]), n,
                                      policy_lib.get_policy("stem"), profile)
    launches = {f"gemma/{arm}": r["launches"] for arm, r in out["prefill"].items()}
    d = cfg.head_dim
    _need(launches["gemma/stem"], [wgmma_counter("block_sparse_attention", d, d)],
          "phase 14 (e) gemma-2b stem prefill")
    _need(launches["gemma/dense"], [wgmma_counter("flash_attention", d, d)],
          "phase 14 (e) gemma-2b dense prefill")
    del params
    _free()
    return out, launches


def families_phase(records: dict, profile: bool = False, sizes: dict = P14) -> dict:
    """Phase 14: the four remaining families at their published widths and
    full depth, one after the other (each frees its weights first), then
    gemma-2b's prefill (head_dim 256)."""
    t0 = time.perf_counter()
    torch._dynamo.reset()
    from torch.nn.attention.flex_attention import flex_attention
    flex = torch.compile(flex_attention, dynamic=False)
    out = {"a/mamba2-370m": mamba_arm(sizes),
           "b/recurrentgemma-2b": recurrentgemma_arm(sizes)}
    out["c/whisper-medium"], launches = whisper_arm(records, sizes, flex, profile)
    out["d/pixtral-12b"], more = pixtral_arm(sizes, profile)
    launches.update(more)
    out["e/gemma-2b"], more = gemma_arm(sizes, profile)
    launches.update(more)
    out["launches"] = launches
    out["s"] = time.perf_counter() - t0
    log(f"[phase14] done in {out['s']:.1f} s")
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(x, device) for k, x in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(x, device) for x in tree)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree



# ---------------------------------------------------------------------------
# Phase 15: the training path
# ---------------------------------------------------------------------------

# Phase 15 (a) at the tensor-core backward's pairs besides (128, 128): tag ->
# ((b, hq, hk, d, dv, n) at the config's training shapes, the block-sparse
# selection: "cli" = the training CLI's --stem geometry, "paper" = the
# registered "stem" policy, the paper's defaults)
TRAIN_PAIRS = {
    "d192v128": ((1, 128, 128, 192, 128, 4096), "cli"),  # deepseek-v3-671b (latents expanded)
    "d192": ((1, 128, 128, 192, 192, 4096), "cli"),      # its MTP layer
    "d64": ((2, 16, 16, 64, 64, 4096), "cli"),           # whisper-medium's decoder
    "d256": ((1, 8, 1, 256, 256, 4096), "paper"),        # gemma-2b
}
P15 = dict(b=2, hq=16, hk=8, d=128, n=4096, pairs=TRAIN_PAIRS, fp32_heads=8, fp32_n=1024,
           seq=4096, batch=2, steps=12, check_layers=4, restart_steps=10,
           restart_at=8, fail_at=6, family_steps=6)
TRAIN_SOURCES = {"flash_attention_bwd": (flash_kern, "flash_attention.cu",
                                         "src/repro/kernels/flash_attention.py:34",
                                         "src/repro/core/sparse_attention.py:157"),
                 "block_sparse_attention_bwd": (bsa_kern, "block_sparse_attn.cu",
                                                "src/repro/kernels/block_sparse_attn.py:52",
                                                "src/repro/core/sparse_attention.py:166")}
# The tensor-core backward kernels: (kernel name, the wrapper that launches
# it and keys its counters, its part of the backward: "dq" = S, dP, dQ and
# delta; "dkdv" = S, dP, dV, dK).
BWD_WGMMA = (("flash_bwd_dq_wgmma_kernel", "flash_attention_bwd", "dq"),
             ("flash_bwd_dkdv_wgmma_kernel", "flash_attention_bwd", "dkdv"),
             ("block_sparse_bwd_dq_wgmma_kernel", "block_sparse_attention_bwd", "dq"),
             ("block_sparse_bwd_dkdv_wgmma_kernel", "block_sparse_attention_bwd", "dkdv"))
PLAIN_FNS = ((flash_kern, "flash_attention_plain"), (flash_kern, "flash_attention_bwd_plain"),
             (bsa_kern, "block_sparse_attention_plain"),
             (bsa_kern, "block_sparse_attention_bwd_plain"))


def cli_stem_policy(seq: int):
    """The training CLI's --stem geometry at ``seq`` tokens."""
    from repro_torch.core.config import StemConfig
    return StemConfig(block_size=min(128, max(16, seq // 8)), min_budget_blocks=2,
                      sink_blocks=1, local_blocks=1, stride=4).policy()


def check_grads(name: str, got: tuple, want: tuple, p_bf16: bool = False) -> float:
    """Each of (dq, dk, dv) against the plain backward under
    ``replay.grad_tolerance`` (p_bf16: the tensor-core route, which rounds
    P and dS to bf16); returns the max |kernel - plain|."""
    worst = 0.0
    for part, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = g.float(), w.float()
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}/{part}: kernel output not finite")
        diff = (g - w).abs()
        over = float((diff / grad_tolerance(w, got[0].dtype, p_bf16)).max())
        if p_bf16:
            log(f"[train] {name}/{part}: max |kernel - plain| / limit {over:.3f}")
        if not over <= 1:
            raise AssertionError(f"{name}/{part}: max |kernel - plain| = "
                                 f"{float(diff.max())}, {over:.2f}x its limit")
        worst = max(worst, float(diff.max()))
    return worst


def check_lse(name: str, got: torch.Tensor, want: torch.Tensor) -> None:
    """The forward kernel's saved log-sum-exp against the plain forward's:
    +inf in the same rows (no key seen), elsewhere within 1e-5 of its
    scale (the same fp32 row sums taken in another order)."""
    inf = torch.isinf(want)
    if not torch.equal(torch.isinf(got), inf) or not bool((got[inf] > 0).all()):
        raise AssertionError(f"{name}: the saved lse's +inf rows differ")
    err = float((got - want)[~inf].abs().max())
    limit = 1e-5 * float(want[~inf].abs().max())
    log(f"[train] {name} lse: max |kernel - plain| {err:.3e} (limit {limit:.3e}); "
        f"{int(inf.sum())} rows saw no key")
    if not err <= limit:
        raise AssertionError(f"{name}: the saved lse disagrees with the plain forward's")


def check_library_bwd(name: str, lib: tuple, want: tuple) -> None:
    """A library's attention backward (timed beside the kernel, never called
    by the port) against the plain backward, each gradient within 5e-2 *
    its max|lib| in bf16: the library's kernels round P and dS to bf16
    before the products, and dk / dv sum those over every query row."""
    for part, g, w in zip(("dq", "dk", "dv"), lib, want):
        err = float((g.float() - w.float()).abs().max())
        limit = float(5e-2 * g.float().abs().max())
        log(f"[train] {name} {part}: max_abs_err={err:.3e} (limit {limit:.3e})")
        if not err <= limit:
            raise AssertionError(f"{name} {part}: library call disagrees")


def bwd_bytes_flops(q, k, v, pairs: float, extra_bytes: float = 0.0, part: str = "both"):
    """Bytes and flops of one attention backward, or of one of its two
    kernels.  Both: q, k, v, o, do and the lse read once, dq, dk, dv
    written once; S, dP, dV, dK, dQ, 2 * (3 d + 2 dv) flops a causal pair.
    "dq": q, k, v, o, do, lse read, dq and delta written; S, dP, dQ (2 *
    (2 d + dv)).  "dkdv": q, k, v, do, lse, delta read, dk and dv written;
    S, dP, dV, dK (2 * (2 d + 2 dv))."""
    es, d, dv = q.element_size(), q.shape[-1], v.shape[-1]
    rows = q.numel() // d * 4                      # one fp32 a query row
    qo = q.numel() * dv // d * es                  # o or do
    kv = (k.numel() + v.numel()) * es
    if part == "dq":
        return 2 * q.numel() * es + kv + 2 * qo + 2 * rows + extra_bytes, \
            2.0 * (2 * d + dv) * pairs
    if part == "dkdv":
        return q.numel() * es + 2 * kv + qo + 2 * rows + extra_bytes, \
            2.0 * (2 * d + 2 * dv) * pairs
    return 2 * (q.numel() * es + kv + qo) + rows + extra_bytes, 2.0 * (3 * d + 2 * dv) * pairs


def kernel_device_ms(fn, names, iters: int = 5, optional=()) -> dict:
    """Each named kernel's device ms per launch over `iters` calls of fn,
    from torch.profiler's CUDA rows (the wgmma backward's two kernels run
    back to back in one wrapper call, so CUDA events would see only their
    sum).  Raises if a name has no device time; `optional` names may have
    none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        t = ev.cuda_time_total if t is None else t
        for name in (*names, *optional):
            if re.search(rf"\b{name}\b", ev.key) and ev.count and t > 0:
                out[name] = t / ev.count / 1e3
    missing = [n for n in names if n not in out]
    if missing:
        raise AssertionError(f"no device time in the profile for {missing}")
    return out


# Pairs of TRAIN_PAIRS where the p_bf16 rule cannot see the farthest pair
# of the sink block's list (rejects_dropped_transposed_block's default
# fault): read and logged there, not required.  The key block's own pair is
# required everywhere.
FAR_PAIR_UNSEEN = {
    "d256": "gemma-2b's 8 query heads share one KV head and its selection, so "
            "the dropped query block is 1 of 256 (head, query block) terms of "
            "the sink block's dk / dv, under the rule's limit",
}


def rejects_dropped_transposed_block(q, k, v, o, do, idx, cnt, bs, want, lse,
                                     diagonal: bool = False, dedup: bool = False,
                                     label: str = "", unseen: str = "") -> list:
    """The bf16 rule must see a missing pair: the block-sparse backward with
    one (query block, key block) pair dropped from the transposed selection
    (batch 0, KV head 0's first query head, the key block with the longest
    list; its last query block, the farthest from the key block, or with
    `diagonal` its first, the key block's own, whose rows weigh most in it)
    must put most of that key block's dk / dv rows over the limit, unless
    `unseen` says why the rule cannot (then the reading is only logged).
    Returns [dk rows, dv rows] over it."""
    tidx, tcnt = bsa_kern.transpose_selection(idx, cnt, idx.shape[2])
    j = int(tcnt[0, 0].argmax())
    if int(tcnt[0, 0, j]) < 2:
        raise AssertionError("no key block is selected by two query blocks")
    faulted, fidx = tcnt.clone(), tidx.clone()
    faulted[0, 0, j] -= 1
    dropped = int(tidx[0, 0, j, 0 if diagonal else int(tcnt[0, 0, j]) - 1])
    if diagonal:
        fidx[0, 0, j, :-1] = tidx[0, 0, j, 1:]
    got = bsa_kern.block_sparse_attention_bwd(q, k, v, o, do, idx, cnt, block_size=bs,
                                              group_dedup=dedup, transposed=(fidx, faulted),
                                              lse=lse)
    rows = slice(j * bs, (j + 1) * bs)
    bad = []
    for g, w in zip(got[1:], want[1:]):
        g, w = g[0, 0, rows].float(), w[0, 0, rows].float()
        limit = grad_tolerance(w, torch.bfloat16, p_bf16=True)
        bad.append(int(((g - w).abs() / limit).gt(1).any(-1).sum()))
    log(f"[train] block_sparse_attention_bwd{label} with query block {dropped} dropped from "
        f"key block {j}'s list of {int(tcnt[0, 0, j])}: {bad[0]} dk rows and {bad[1]} dv rows "
        f"of {bs} over the limit")
    if not 2 * min(bad) > bs:
        if unseen:
            log(f"[train] block_sparse_attention_bwd{label}: the bf16 rule passes this "
                f"fault, a known blind spot: {unseen}")
            return bad
        raise AssertionError(f"block_sparse_attention_bwd{label}: the bf16 rule passes a "
                             f"dropped key block (query block {dropped})")
    return bad


def rejects_dropped_selected_block(q, k, v, o, do, idx, cnt, bs, want, lse,
                                   dedup: bool = False) -> None:
    """The dq side of the same: the backward with the last live block
    dropped from every selection row with two or more (the forward's o and
    lse unchanged) must put most of those query blocks' dq rows over the
    p_bf16 rule."""
    faulted = cnt >= 2
    got = bsa_kern.block_sparse_attention_bwd(
        q, k, v, o, do, idx, torch.where(faulted, cnt - 1, cnt).to(torch.int32),
        block_size=bs, group_dedup=dedup, lse=lse)[0].float()
    w = want[0].float()
    over = ((got - w).abs() / grad_tolerance(w, torch.bfloat16, p_bf16=True)).gt(1).any(-1)
    over = over.reshape(over.shape[0], over.shape[1], -1, bs)         # (b, hq, nq, bs)
    faulted = faulted.repeat_interleave(over.shape[1] // faulted.shape[1], 1)
    bad = int(over[faulted].sum())
    rows = int(faulted.sum()) * bs
    log(f"[train] block_sparse_attention_bwd with the last live block dropped from each "
        f"row with two or more: {bad} of {rows} such dq rows over the limit")
    if not 2 * bad > rows:
        raise AssertionError("block_sparse_attention_bwd: the bf16 rule passes a "
                             "dropped selected block (dq)")


def rec_bwd_kernels(pending: list, key: str, lane: str, spec: dict, q, k, v, pairs,
                    extra_bytes, plain_ms, err) -> None:
    """Queues the timing of each tensor-core backward kernel of `key`'s
    wrapper alone (``bwd_kernel_times``) beside its bound: the dq kernel's
    work (S, dP, dQ) and the dk / dv kernel's (S, dP, dV, dK) of this call,
    the latter with the head split's second pass where the shape takes one.
    spec: the call's inputs as ``bwd_kernel_times_here`` rebuilds them."""
    parts = {}
    for name, wrapper, part in BWD_WGMMA:
        if wrapper == key:
            parts[name] = (*bound(*bwd_bytes_flops(q, k, v, pairs, extra_bytes, part),
                                  torch.bfloat16),
                           bwd_bytes_flops(q, k, v, pairs, 0.0, part)[1], part)
    pending.append(dict(key=key, lane=lane, spec=dict(spec, key=key), parts=parts,
                        plain_ms=plain_ms, err=err))


# One child process times the queued backward kernels: in a process whose
# torch.profiler traced before (--profile-prefill's sessions), a later
# session has seen no device rows for them, while cuBLAS's kernels stayed
# visible across eight sessions of one process (PERF.md).
BWD_TIMES_CHILD = ("import json, sys; import chip_smoke as c; "
                   "print(json.dumps(c.bwd_kernel_times_here(json.load(sys.stdin))))")


def bwd_kernel_times_here(specs: list, dev=torch.device("cuda")) -> list:
    """For each spec (key, shape (b, hq, hk, d, dv, n), seed, geometry):
    the bf16 inputs rebuilt (``_bwd_inputs``, the forward's o and lse, the
    selection of ``_pair_policy``) and each tensor-core kernel of the
    backward's device ms a launch (``kernel_device_ms``)."""
    _build.build_all()
    out = []
    for spec in specs:
        b, hq, hk, d, dv, n = spec["shape"]
        q, k, v, do = _bwd_inputs(b, hq, hk, d, dv, n, torch.bfloat16, spec["seed"], dev)
        names = [name for name, wrapper, _ in BWD_WGMMA if wrapper == spec["key"]]
        if spec["key"] == "flash_attention_bwd":
            o, lse = flash_kern.flash_attention(q, k, v, return_lse=True)
            fn = lambda: flash_kern.flash_attention_bwd(q, k, v, o, do, lse=lse)
        else:
            pol = _pair_policy(spec["geometry"], n)
            sel, _ = pol.prefill_select(q, k, v, with_block_mask=False)
            idx, cnt = sel.indices.contiguous(), sel.live_counts.contiguous()
            kw = dict(block_size=pol.block_size, group_dedup=idx.shape[1] != hq)
            o, lse = bsa_kern.block_sparse_attention(q, k, v, idx, live_counts=cnt,
                                                     return_lse=True, **kw)
            fn = lambda: bsa_kern.block_sparse_attention_bwd(q, k, v, o, do, idx, cnt,
                                                             lse=lse, **kw)
        out.append(kernel_device_ms(fn, names, optional=("reduce_kv_partials",)))
        del q, k, v, do, o, lse, fn
        torch.cuda.empty_cache()
    return out


def bwd_kernel_times(specs: list) -> list:
    """``bwd_kernel_times_here`` in a fresh process (its last stdout line)."""
    _free()
    run = subprocess.run([sys.executable, "-c", BWD_TIMES_CHILD], input=json.dumps(specs),
                         capture_output=True, text=True, cwd=str(ROOT))
    if run.returncode != 0:
        raise RuntimeError(f"the backward kernels' timing process failed:\n"
                           f"{run.stdout[-2000:]}\n{run.stderr[-4000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def finish_bwd_kernels(records: dict, pending: list) -> None:
    """Times every queued backward (``bwd_kernel_times``) and records each
    tensor-core kernel under f"{kernel}/{lane}"."""
    times = bwd_kernel_times([p["spec"] for p in pending])
    for p, ms in zip(pending, times):
        for name, (bound_ms, bound_by, flops, part) in p["parts"].items():
            t = ms[name] + (ms.get("reduce_kv_partials", 0.0) if part == "dkdv" else 0.0)
            log(f"[kernels] {name}/{p['lane']} bfloat16: {t:.4f} ms (profiled"
                + (f"; the split's reduction {ms['reduce_kv_partials']:.4f}"
                   if part == "dkdv" and "reduce_kv_partials" in ms else "")
                + f"), bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / t:.3f} of bound")
            records.setdefault(f"{name}/{p['lane']}", {})["bfloat16"] = dict(
                max_abs_err=p["err"], ms=t, host_ms=None, plain_ms=p["plain_ms"],
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                tflops=flops / t * 1e-9)


def train_kernel_phase(records: dict, sizes: dict = P15, dev=torch.device("cuda")) -> None:
    """(a) Both backward kernels at the training shapes of full-width
    qwen3-0.6b under the CLI's --stem geometry, fed the forward's saved
    lse (held against the plain forward's): fp32 on the CUDA-core route,
    bf16 on the tensor-core route (the wgmma counters must move, and only
    there), each against the plain backward, twice bitwise (no atomics);
    both routes timed beside the bound, bf16 beside the backward of SDPA
    (flash) / a compiled flex_attention (block-sparse) and each wgmma
    kernel alone; then the other pairs (``train_pair_kernels``)."""
    b, hq, hk, d, n = (sizes[x] for x in ("b", "hq", "hk", "d", "n"))
    pol = cli_stem_policy(n)
    bs = pol.block_size
    pending: list = []
    sdpa = torch.nn.functional.scaled_dot_product_attention
    torch._dynamo.reset()
    from torch.nn.attention.flex_attention import flex_attention
    flex = torch.compile(flex_attention, dynamic=False)

    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split(".")[-1]
        wg = dtype == torch.bfloat16
        seed = 15 if dtype == torch.float32 else 16
        q, k, v, do = _bwd_inputs(b, hq, hk, d, d, n, dtype, seed, dev)
        spec = dict(shape=(b, hq, hk, d, d, n), seed=seed, geometry="cli")
        # -- flash ---------------------------------------------------------
        o, lse = flash_kern.flash_attention(q, k, v, return_lse=True)
        check_lse(f"flash_attention/{tag}", lse,
                  flash_kern.flash_attention_plain(q, k, v, return_lse=True)[1])
        run_k = lambda: flash_kern.flash_attention_bwd(q, k, v, o, do, lse=lse)
        run_p = lambda: flash_kern.flash_attention_bwd_plain(q, k, v, o, do)
        got = routed_bwd(f"flash_attention_bwd/{tag}", flash_kern, "flash_attention_bwd", run_k,
                         d, d, wg)
        again, want = run_k(), run_p()
        torch.cuda.synchronize()
        err = check_grads(f"flash_attention_bwd/{tag}", got, want, p_bf16=wg)
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError("flash_attention_bwd: two calls differ")
        lib = None
        if wg:
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            out = sdpa(*leaves, is_causal=True, enable_gqa=True)
            check_library_bwd("flash_attention_bwd vs SDPA's backward",
                              torch.autograd.grad(out, leaves, do, retain_graph=True), want)
            lib = lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)
        pairs = b * hq * n * (n + 1) / 2
        rec_kernel(records, "flash_attention_bwd", "train", tag, err, run_k, run_p,
                   bwd_bytes_flops(q, k, v, pairs), dtype, run_lib=lib, iters=5,
                   plain_iters=1)
        if wg:
            rec_bwd_kernels(pending, "flash_attention_bwd", "train", spec, q, k, v, pairs, 0.0,
                            records["flash_attention_bwd/train"][tag]["plain_ms"], err)
        del got, again, want, o, lse, lib
        # -- block-sparse under the CLI's stem selection ---------------------
        sel, _ = pol.prefill_select(q, k, v, with_block_mask=False)
        idx, cnt = sel.indices.contiguous(), sel.live_counts.contiguous()
        o, lse = bsa_kern.block_sparse_attention(q, k, v, idx, live_counts=cnt, block_size=bs,
                                                 return_lse=True)
        check_lse(f"block_sparse_attention/{tag}", lse, bsa_kern.block_sparse_attention_plain(
            q, k, v, idx, cnt, block_size=bs, return_lse=True)[1])
        run_k = lambda: bsa_kern.block_sparse_attention_bwd(q, k, v, o, do, idx, cnt,
                                                            block_size=bs, lse=lse)
        run_p = lambda: bsa_kern.block_sparse_attention_bwd_plain(q, k, v, o, do, idx, cnt,
                                                                  block_size=bs)
        got = routed_bwd(f"block_sparse_attention_bwd/{tag}", bsa_kern,
                         "block_sparse_attention_bwd", run_k, d, d, wg)
        again, want = run_k(), run_p()
        torch.cuda.synchronize()
        err = check_grads(f"block_sparse_attention_bwd/{tag}", got, want, p_bf16=wg)
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError("block_sparse_attention_bwd: two calls differ")
        lib = None
        if wg:
            rejects_dropped_transposed_block(q, k, v, o, do, idx, cnt, bs, want, lse)
            rejects_dropped_selected_block(q, k, v, o, do, idx, cnt, bs, want, lse)
            mask = flex_block_mask(idx, cnt, bs)
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            out = flex(*leaves, block_mask=mask, enable_gqa=True)
            check_library_bwd("block_sparse_attention_bwd vs flex_attention's backward",
                              torch.autograd.grad(out, leaves, do, retain_graph=True), want)
            lib = lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)
            log(f"[train] stem selection at n={n}: k_max {idx.shape[-1]}, realized "
                f"density {float(selection_density(sel, n // bs)):.4f}")
        nq = n // bs
        sel_bytes = (idx.numel() + cnt.numel() + b * hq * nq * (nq + 1)) * 4
        pairs = causal_pairs(idx, cnt, bs)
        rec_kernel(records, "block_sparse_attention_bwd", "train", tag, err, run_k, run_p,
                   bwd_bytes_flops(q, k, v, pairs, sel_bytes), dtype, run_lib=lib, iters=5,
                   plain_iters=1)
        if wg:
            rec_bwd_kernels(pending, "block_sparse_attention_bwd", "train", spec, q, k, v,
                            pairs, sel_bytes, records["block_sparse_attention_bwd/train"][tag][
                                "plain_ms"], err)
        del q, k, v, do, o, lse, got, again, want, lib
        torch.cuda.empty_cache()
    train_pair_kernels(records, pending, sizes, dev, flex)
    finish_bwd_kernels(records, pending)


def routed_bwd(name: str, mod, key: str, run, d: int, dv: int, wgmma: bool):
    """One backward call with its wrapper's counters zeroed before and read
    after: one launch, and on the tensor-core route one of the route's and
    one of its instance at (d, dv) (``wgmma_counter``); none of either
    off it."""
    mod.reset_launches()
    out = run()
    torch.cuda.synchronize()
    want = {key: 1, f"{key}_wgmma": int(wgmma), wgmma_counter(key, d, dv): int(wgmma)}
    got = {c: mod.LAUNCHES[c] for c in want}
    if got != want:
        raise AssertionError(f"{name}: launches {got}, expected {want}")
    return out


def _bwd_inputs(b, hq, hk, d, dv, n, dtype, seed, dev):
    """q, k, v, do of one backward check, normal from a seeded generator."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(s, generator=gen, device=dev).to(dtype) for s in
                 ((b, hq, n, d), (b, hk, n, d), (b, hk, n, dv), (b, hq, n, dv)))


def _pair_policy(geometry: str, n: int):
    return cli_stem_policy(n) if geometry == "cli" else policy_lib.get_policy("stem")


def train_pair_kernels(records: dict, pending: list, sizes: dict, dev, flex) -> None:
    """(a) at the tensor-core backward's other pairs (``TRAIN_PAIRS``:
    deepseek-v3-671b's 128 heads at (192, 128) and its MTP layer's (192,
    192), whisper-medium's decoder at d 64, gemma-2b's 8 / 1 heads at d
    256), bf16: each backward fed its forward's saved lse (held against the
    plain forward's), on its tensor-core instance (the counters asserted),
    within the p_bf16 rule of the plain backward, two calls bitwise;
    block-sparse rejecting the planted faults (a block dropped from each
    row; from the transposed selection the sink block's own pair, and its
    farthest pair except where ``FAR_PAIR_UNSEEN`` says the rule cannot see
    it, logged there); each timed beside its bound,
    SDPA's backward (flash, where SDPA takes the shape) or a compiled
    flex_attention's (block-sparse), and the CUDA-core route at the same
    shape (the "was", itself held to the 1e-3 rule), each tensor-core
    kernel alone besides.  Then the CUDA-core route in fp32 at each pair,
    cut to ``fp32_heads`` query heads and ``fp32_n`` tokens."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bf16 = torch.bfloat16
    for tag, ((b, hq, hk, d, dv, n), geometry) in sizes["pairs"].items():
        q, k, v, do = _bwd_inputs(b, hq, hk, d, dv, n, bf16, 26, dev)
        spec = dict(shape=(b, hq, hk, d, dv, n), seed=26, geometry=geometry)
        pol = _pair_policy(geometry, n)
        bs = pol.block_size
        # -- flash -------------------------------------------------------
        o, lse = flash_kern.flash_attention(q, k, v, return_lse=True)
        check_lse(f"flash_attention/{tag}", lse,
                  flash_kern.flash_attention_plain(q, k, v, return_lse=True)[1])
        run_k = lambda: flash_kern.flash_attention_bwd(q, k, v, o, do, lse=lse)
        run_c = lambda: flash_kern._bwd_launch(q, k, v, o, do, None, lse, "cuda_core")
        run_p = lambda: flash_kern.flash_attention_bwd_plain(q, k, v, o, do)
        got = routed_bwd(f"flash_attention_bwd/{tag}", flash_kern, "flash_attention_bwd",
                         run_k, d, dv, True)
        again, want = run_k(), run_p()
        torch.cuda.synchronize()
        err = check_grads(f"flash_attention_bwd/{tag}", got, want, p_bf16=True)
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"flash_attention_bwd/{tag}: two calls differ")
        check_grads(f"flash_attention_bwd/{tag}/cuda_core", routed_bwd(
            f"flash_attention_bwd/{tag}/cuda_core", flash_kern, "flash_attention_bwd", run_c,
            d, dv, False), want)
        del got, again
        lib = out = leaves = None
        try:
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            out = sdpa(*leaves, is_causal=True, enable_gqa=True)
            check_library_bwd(f"flash_attention_bwd {tag} vs SDPA's backward",
                              torch.autograd.grad(out, leaves, do, retain_graph=True), want)
            lib = lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)
        except Exception as e:  # the library is only timed beside it
            log(f"[train] SDPA's backward at {tag} failed, no library time: "
                f"{type(e).__name__}: {str(e).splitlines()[0][:200]}")
        pairs = b * hq * n * (n + 1) / 2
        rec_kernel(records, "flash_attention_bwd", tag, "bfloat16", err, run_k, run_p,
                   bwd_bytes_flops(q, k, v, pairs), bf16, run_lib=lib, iters=3,
                   plain_iters=1)
        rec = records[f"flash_attention_bwd/{tag}"]["bfloat16"]
        rec["was_ms"] = time_ms(run_c, iters=1, warmup=0)[0]
        rec_bwd_kernels(pending, "flash_attention_bwd", tag, spec, q, k, v, pairs, 0.0,
                        rec["plain_ms"], err)
        log(f"[train] flash_attention_bwd/{tag}: the CUDA-core route {rec['was_ms']:.4f} ms, "
            f"{rec['was_ms'] / rec['ms']:.1f}x the tensor-core one"
            + ("" if rec["library_ms"] is None else
               f"; {rec['ms'] / rec['library_ms']:.3f}x SDPA's backward"))
        del want, lib, out, leaves, o, lse
        # -- block-sparse ------------------------------------------------
        sel, _ = pol.prefill_select(q, k, v, with_block_mask=False)
        idx, cnt = sel.indices.contiguous(), sel.live_counts.contiguous()
        hsel = idx.shape[1]
        kw = dict(block_size=bs, group_dedup=hsel != hq)
        o, lse = bsa_kern.block_sparse_attention(q, k, v, idx, live_counts=cnt,
                                                 return_lse=True, **kw)
        check_lse(f"block_sparse_attention/{tag}", lse, bsa_kern.block_sparse_attention_plain(
            q, k, v, idx, cnt, return_lse=True, **kw)[1])
        run_k = lambda: bsa_kern.block_sparse_attention_bwd(q, k, v, o, do, idx, cnt,
                                                            lse=lse, **kw)
        run_c = lambda: bsa_kern._bwd_launch(q, k, v, o, do, idx, cnt, bs, None,
                                             kw["group_dedup"], None, lse, "cuda_core")
        run_p = lambda: bsa_kern.block_sparse_attention_bwd_plain(q, k, v, o, do, idx, cnt,
                                                                  **kw)
        name = f"block_sparse_attention_bwd/{tag}"
        got = routed_bwd(name, bsa_kern, "block_sparse_attention_bwd", run_k, d, dv, True)
        again, want = run_k(), run_p()
        torch.cuda.synchronize()
        err = check_grads(name, got, want, p_bf16=True)
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"{name}: two calls differ")
        check_grads(f"{name}/cuda_core", routed_bwd(
            f"{name}/cuda_core", bsa_kern, "block_sparse_attention_bwd", run_c, d, dv, False),
            want)
        del got, again
        for diagonal in (False, True):      # the farthest pair, then the key block's own
            rejects_dropped_transposed_block(
                q, k, v, o, do, idx, cnt, bs, want, lse, diagonal=diagonal,
                dedup=kw["group_dedup"], label=f"/{tag}",
                unseen="" if diagonal else FAR_PAIR_UNSEEN.get(tag, ""))
        rejects_dropped_selected_block(q, k, v, o, do, idx, cnt, bs, want, lse,
                                       dedup=kw["group_dedup"])
        lib = out = leaves = mask = None
        try:
            rep = hq // hsel
            mask = flex_block_mask(idx.repeat_interleave(rep, 1), cnt.repeat_interleave(rep, 1),
                                   bs)
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            out = flex(*leaves, block_mask=mask, enable_gqa=True)
            check_library_bwd(f"{name} vs flex_attention's backward",
                              torch.autograd.grad(out, leaves, do, retain_graph=True), want)
            lib = lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)
        except Exception as e:  # the library is only timed beside it
            log(f"[train] flex_attention's backward at {tag} failed, no library time: "
                f"{type(e).__name__}: {str(e).splitlines()[0][:200]}")
        nq = n // bs
        sel_bytes = (idx.numel() + cnt.numel() + b * hsel * nq * (nq + 1)) * 4
        pairs = causal_pairs(idx, cnt, bs) * (hq // hsel)
        rec_kernel(records, "block_sparse_attention_bwd", tag, "bfloat16", err, run_k, run_p,
                   bwd_bytes_flops(q, k, v, pairs, sel_bytes), bf16, run_lib=lib, iters=3,
                   plain_iters=1)
        rec = records[f"block_sparse_attention_bwd/{tag}"]["bfloat16"]
        rec["was_ms"] = time_ms(run_c, iters=1, warmup=0)[0]
        rec["density"] = float(selection_density(sel, nq))
        rec_bwd_kernels(pending, "block_sparse_attention_bwd", tag, spec, q, k, v, pairs,
                        sel_bytes, rec["plain_ms"], err)
        log(f"[train] {name}: block {bs}, k_max {idx.shape[-1]}, realized density "
            f"{rec['density']:.4f}; the CUDA-core route {rec['was_ms']:.4f} ms, "
            f"{rec['was_ms'] / rec['ms']:.1f}x the tensor-core one"
            + ("" if rec["library_ms"] is None else
               f"; {rec['ms'] / rec['library_ms']:.3f}x flex_attention's backward"))
        del q, k, v, do, o, lse, want, lib, out, leaves, mask, sel, idx, cnt
        _free()

    # the CUDA-core route in fp32 at each pair, cut in heads and tokens
    for tag, ((b, hq, hk, d, dv, n), geometry) in sizes["pairs"].items():
        hq2 = min(hq, sizes["fp32_heads"])
        hk2, n2 = max(1, hq2 * hk // hq), sizes["fp32_n"]
        q, k, v, do = _bwd_inputs(1, hq2, hk2, d, dv, n2, torch.float32, 27, dev)
        o, lse = flash_kern.flash_attention(q, k, v, return_lse=True)
        e1 = check_grads(f"flash_attention_bwd/{tag}/float32", routed_bwd(
            f"flash_attention_bwd/{tag}/float32", flash_kern, "flash_attention_bwd",
            lambda: flash_kern.flash_attention_bwd(q, k, v, o, do, lse=lse), d, dv, False),
            flash_kern.flash_attention_bwd_plain(q, k, v, o, do))
        pol = _pair_policy(geometry, n2)
        sel, _ = pol.prefill_select(q, k, v, with_block_mask=False)
        idx, cnt = sel.indices.contiguous(), sel.live_counts.contiguous()
        kw = dict(block_size=pol.block_size, group_dedup=idx.shape[1] != hq2)
        o, lse = bsa_kern.block_sparse_attention(q, k, v, idx, live_counts=cnt,
                                                 return_lse=True, **kw)
        e2 = check_grads(f"block_sparse_attention_bwd/{tag}/float32", routed_bwd(
            f"block_sparse_attention_bwd/{tag}/float32", bsa_kern,
            "block_sparse_attention_bwd",
            lambda: bsa_kern.block_sparse_attention_bwd(q, k, v, o, do, idx, cnt, lse=lse,
                                                        **kw), d, dv, False),
            bsa_kern.block_sparse_attention_bwd_plain(q, k, v, o, do, idx, cnt, **kw))
        log(f"[train] fp32 at ({d}, {dv}), {hq2} / {hk2} heads, {n2} tokens: the CUDA-core "
            f"backward max_abs_err flash {e1:.3e}, block-sparse {e2:.3e}")
        del q, k, v, do, o, lse, sel, idx, cnt
    _free()


@contextlib.contextmanager
def train_taps():
    """During a training run: every call of a plain attention version
    counted (the card's path must make none), and each backward kernel
    call timed with CUDA events (its device ms, summed after the run)."""
    plain_calls = {f"{mod.__name__.split('.')[-1]}.{fn}": 0 for mod, fn in PLAIN_FNS}
    events = []
    saved = []

    def counting(mod, fn):
        orig = getattr(mod, fn)
        key = f"{mod.__name__.split('.')[-1]}.{fn}"

        def wrapped(*a, **kw):
            plain_calls[key] += 1
            return orig(*a, **kw)
        return orig, wrapped

    def timed(orig):
        def wrapped(*a, **kw):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = orig(*a, **kw)
            e1.record()
            events.append((e0, e1))
            return out
        return wrapped

    for mod, fn in PLAIN_FNS:
        orig, wrapped = counting(mod, fn)
        saved.append((mod, fn, orig))
        setattr(mod, fn, wrapped)
    for name, (mod, *_) in TRAIN_SOURCES.items():
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, timed(getattr(mod, name)))
    tap = {"plain_calls": plain_calls, "events": events}
    try:
        yield tap
    finally:
        for mod, fn, orig in saved:
            setattr(mod, fn, orig)


@contextlib.contextmanager
def train_config(cfg):
    """The training CLI builds ``cfg`` for its --arch (a depth cut of a
    published config) while the block runs."""
    from repro_torch import configs as configs_lib
    orig = configs_lib.get_config
    configs_lib.get_config = lambda name: cfg
    try:
        yield
    finally:
        configs_lib.get_config = orig


def train_cli(argv: list, device: str = "cuda", arch: str = "qwen3-0.6b") -> dict:
    from repro_torch.launch import train as train_lib
    return train_lib.main(["--arch", arch, "--device", device] + argv)


def train_cli_arm(what: str, argv: list, need, device: str, arch: str = "qwen3-0.6b",
                  batch: int = 2, seq: int = 4096) -> dict:
    """One run of the training CLI: the loss finite and falling (the mean
    of the last three steps under that of the first three), every kernel of
    `need` launched (counters zeroed before, read after), every backward
    on the tensor-core route (no CUDA-core backward launch), no plain
    attention version called; ms a step (median of steps 1..), tokens/s,
    peak memory, the backward kernels' share of the step."""
    _free()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    with train_taps() as tap:
        res = train_cli(argv, device, arch)
        torch.cuda.synchronize()
    launches = read_all_launches()
    losses = res["losses"]
    if not all(np.isfinite(losses)) or not np.mean(losses[-3:]) < np.mean(losses[:3]):
        raise AssertionError(f"train {what}: the loss did not fall: {losses}")
    missing = [key for key in need if launches[key] == 0]
    if missing:
        raise AssertionError(f"train {what}: kernels never launched: {missing}")
    for key in ("flash_attention_bwd", "block_sparse_attention_bwd"):
        if launches[key] != launches[f"{key}_wgmma"]:
            raise AssertionError(f"train {what}: {launches[key] - launches[f'{key}_wgmma']} "
                                 f"{key} launches on the CUDA-core route")
    if any(tap["plain_calls"].values()):
        raise AssertionError(f"train {what}: plain versions called: {tap['plain_calls']}")
    # the backward kernels' share of steps 1.. (each step makes the same
    # number of backward calls)
    steady = res["step_ms"][1:]
    per_step = len(tap["events"]) // len(res["step_ms"])
    bwd_ms = sum(e0.elapsed_time(e1) for e0, e1 in tap["events"][per_step:])
    step_ms = float(np.median(steady))
    out = dict(losses=losses, step_ms=step_ms, step_ms_all=res["step_ms"],
               tokens_s=batch * seq / step_ms * 1e3,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               bwd_kernel_share=bwd_ms / sum(steady), launches=launches,
               stragglers=len(res["stragglers"]))
    log(f"[train] CLI {what}: loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
        f"{step_ms:.1f} ms a step (median of steps 1-{len(losses) - 1}), "
        f"{out['tokens_s']:.0f} tokens/s, peak {out['peak_gib']:.2f} GiB, "
        f"backward kernels {100 * out['bwd_kernel_share']:.1f} % of the step, launches "
        f"{ {k: launches[k] for k in need} }")
    return out


def train_cli_arms(sizes: dict = P15, device: str = "cuda") -> dict:
    """(b) The CLI on full-width qwen3-0.6b, bf16, 28 layers, with --stem
    and without (``train_cli_arm``: the loss falling, the kernels of the
    path launched, the backward on the tensor-core route, no plain version;
    ms a step, tokens/s, peak memory, the backward kernels' share)."""
    out = {}
    for arm, extra, need in (("dense", [], ("flash_attention", "flash_attention_bwd",
                                            "flash_attention_bwd_wgmma",
                                            wgmma_counter("flash_attention_bwd", 128, 128))),
                             ("stem", ["--stem"], STEM_KERNELS + (
                                 "block_sparse_attention_bwd",
                                 "block_sparse_attention_bwd_wgmma",
                                 wgmma_counter("block_sparse_attention_bwd", 128, 128)))):
        out[arm] = train_cli_arm(arm, ["--seq", str(sizes["seq"]), "--batch",
                                       str(sizes["batch"]), "--steps", str(sizes["steps"])]
                                 + extra, need, device, batch=sizes["batch"], seq=sizes["seq"])
    return out


# Phase 15 (b) at the other pairs: arch -> (the config the CLI builds for it:
# published widths, deepseek-v3-671b's depth cut to one layer, a dense-FFN
# MLA layer at (192, 128) (first_k_dense 1, so its MoE segment holds no
# layer), and its MTP head (dense attention at (192, 192)); batch, and the
# (q/k, v) pairs of each arm's backward: flash for dense attention,
# block-sparse under --stem)
TRAIN_FAMILIES = {
    "whisper-medium": (WHISPER_MEDIUM, 2, {"dense": {"flash": [(64, 64)]},
                                           "stem": {"block_sparse": [(64, 64)]}}),
    "gemma-2b": (GEMMA_2B, 1, {"dense": {"flash": [(256, 256)]},
                               "stem": {"block_sparse": [(256, 256)]}}),
    "deepseek-v3-671b": (DEEPSEEK_V3_671B.replace(
        num_layers=1, moe=dataclasses.replace(DEEPSEEK_V3_671B.moe, first_k_dense=1)), 1,
                         {"dense": {"flash": [(192, 128), (192, 192)]},
                          "stem": {"block_sparse": [(192, 128)], "flash": [(192, 192)]}}),
}


def family_need(pairs: dict) -> list:
    """The counters an arm must move: each wrapper's forward and backward
    and the tensor-core instance of each of its pairs."""
    need = []
    for kind, ps in pairs.items():
        key = "flash_attention" if kind == "flash" else "block_sparse_attention"
        need += [key, f"{key}_bwd", f"{key}_bwd_wgmma"]
        need += [wgmma_counter(f"{key}_bwd", d, dv) for d, dv in ps]
        need += [wgmma_counter(key, d, dv) for d, dv in ps]
    return need + (list(STEM_KERNELS[1:]) if "block_sparse" in pairs else [])


def train_family_arms(sizes: dict = P15, device: str = "cuda", families=None) -> dict:
    """(b) The CLI at the tensor-core backward's other pairs
    (``TRAIN_FAMILIES``: whisper-medium and gemma-2b at full width and
    depth, deepseek-v3-671b depth-cut), seq 4096, ``family_steps`` steps,
    dense and --stem, each through ``train_cli_arm``; at a peak learning
    rate of 1e-4 (the CLI's 3e-4, reached after two warmup steps, swung
    gemma-2b's loss between 8.7 and 16.7 over 6 steps)."""
    out = {}
    for arch, (cfg, batch, arms) in (families or TRAIN_FAMILIES).items():
        with train_config(cfg):
            for arm, pairs in arms.items():
                out[f"{arch}/{arm}"] = train_cli_arm(
                    f"{arch} {arm}", ["--seq", str(sizes["seq"]), "--batch", str(batch),
                                      "--steps", str(sizes["family_steps"]), "--lr", "1e-4"]
                    + (["--stem"] if arm == "stem" else []), family_need(pairs), device,
                    arch=arch, batch=batch, seq=sizes["seq"])
    return out


def train_fp32_checks(sizes: dict = P15, device: str = "cuda") -> dict:
    """(c) fp32, full width, depth cut to ``check_layers``: one train step's
    loss, grad_norm and every gradient leaf under "fused" == "gather"
    (within 1e-4 of each leaf's max|g|); the CLI's restart bitwise; the
    restart harness resumes from the step-4 checkpoint."""
    from repro_torch import optim as optim_lib
    from repro_torch.data import SyntheticLMData, make_global_batch
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime.fault_tolerance import run_with_restarts
    _free()
    cfg = dataclasses.replace(QWEN3_0_6B, dtype="float32", num_layers=sizes["check_layers"])
    seq, batch = sizes["seq"], sizes["batch"]
    bundle = registry.build(cfg)
    params = bundle.init_params(torch.Generator(device=device).manual_seed(0), device=device)
    master = optim_lib.init_state(params, optim_lib.AdamWConfig()).master
    del params
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch)
    gbatch = make_global_batch(data.batch_at(0), device)
    fused = cli_stem_policy(seq)
    runs = {}
    for name, pol in (("fused", fused), ("gather", fused.with_updates(executor="gather"))):
        loss, metrics, grads = steps_lib.loss_and_grads(bundle, master, gbatch, stem_cfg=pol)
        gnorm = float(optim_lib.adamw.global_norm(grads))
        runs[name] = (float(loss), gnorm, tree_leaves(grads))
    (lf, nf, gf), (lg, ng, gg) = runs["fused"], runs["gather"]
    worst = max(float((a - c).abs().max() / c.abs().max().clamp(min=1e-30))
                for a, c in zip(gf, gg))
    log(f"[train] fp32 {cfg.num_layers} layers, one step: loss fused {lf:.7f} gather "
        f"{lg:.7f}, grad_norm {nf:.6f} / {ng:.6f}, worst leaf |fused - gather| / "
        f"max|g| {worst:.2e}")
    if not (abs(lf - lg) <= 1e-5 * abs(lg) and abs(nf - ng) <= 1e-5 * ng and worst <= 1e-4):
        raise AssertionError("train: fused and gather gradients disagree in fp32")
    del master, runs, gf, gg
    _free()

    ckpt = ROOT / "build" / "phase15"
    shutil.rmtree(ckpt, ignore_errors=True)
    common_args = ["--seq", str(seq), "--batch", str(batch), "--stem"]
    n_all, at, fail = sizes["restart_steps"], sizes["restart_at"], sizes["fail_at"]
    with train_config(cfg):
        ref = train_cli(common_args + ["--steps", str(n_all), "--checkpoint-dir",
                                       str(ckpt / "a"), "--checkpoint-every", "100"], device)
        train_cli(common_args + ["--steps", str(at), "--checkpoint-dir", str(ckpt / "b"),
                                 "--checkpoint-every", str(at)], device)
        second = train_cli(common_args + ["--steps", str(n_all), "--checkpoint-dir",
                                          str(ckpt / "b"), "--restore",
                                          "--checkpoint-every", "100"], device)
        if ref["losses"][at:] != second["losses"]:
            raise AssertionError(f"train: the restart is not bitwise: {ref['losses'][at:]} "
                                 f"vs {second['losses']}")
        log(f"[train] restart at step {at}: losses {second['losses']} == the "
            "uninterrupted run's, bitwise")
        for sub in ("a", "b"):
            shutil.rmtree(ckpt / sub)
        calls = []

        def attempt():
            calls.append(1)
            return train_cli(common_args + [
                "--steps", str(n_all), "--checkpoint-dir", str(ckpt / "c"),
                "--checkpoint-every", "4", "--fail-at", str(fail) if len(calls) == 1 else "-1"]
                + (["--restore"] if len(calls) > 1 else []), device)

        resumed = run_with_restarts(attempt, max_restarts=2)
    shutil.rmtree(ckpt, ignore_errors=True)
    if len(calls) != 2 or resumed["losses"] != ref["losses"][4:]:
        raise AssertionError(f"train: the harness did not resume from step 4: {len(calls)} "
                             f"attempts, losses {resumed['losses']}")
    log(f"[train] run_with_restarts around --fail-at {fail}: resumed at step 4, losses == "
        "the uninterrupted run's, bitwise")
    return dict(loss=lf, grad_norm=nf, worst_leaf=worst, restart_losses=second["losses"])


def train_phase(records: dict, sizes: dict = P15) -> dict:
    """Phase 15: the training path."""
    t0 = time.perf_counter()
    train_kernel_phase(records, sizes)
    out = {"cli": train_cli_arms(sizes), "families": train_family_arms(sizes),
           "fp32": train_fp32_checks(sizes)}
    out["s"] = time.perf_counter() - t0
    log(f"[phase15] done in {out['s']:.1f} s")
    return out


def bwd_pair_entries(kernels: list, by_name: dict, records: dict, p15: dict,
                     build: dict) -> None:
    """The kernels line's backward at the pairs besides (128, 128): each
    pair's phase 15 (a) row, the profiled time of its two kernels, its
    build, and its launches in the phase 15 (b) arms that run it, under the
    wrapper's ``head_dims``; a kernel entry of its own for each instance a
    phase 15 (b) arm launched (block-sparse at (192, 192) runs on no
    training path: deepseek's MTP layer attends densely)."""
    for key in ("flash_attention_bwd", "block_sparse_attention_bwd"):
        _, source, fwd, autodiff = TRAIN_SOURCES[key]
        stem = source.split(".")[0]
        parts_of = {name for name, wrapper, _ in BWD_WGMMA if wrapper == key}
        by_name[key]["head_dims"] = {}
        for tag, ((_, _, _, d, dv, _), _) in P15["pairs"].items():
            rec = records[f"{key}/{tag}"]["bfloat16"]
            counter = wgmma_counter(key, d, dv)
            runs = {arm: r["launches"][counter] for arm, r in p15["families"].items()
                    if r["launches"][counter]}
            parts = {part: records[f"{name}/{tag}"]["bfloat16"]
                     for name, wrapper, part in BWD_WGMMA if wrapper == key}
            inst = {n: b for n, b in build[stem].items()
                    if n.split("<")[0] in parts_of and f"<{d}x{dv} " in n}
            entry = dict(rec, route="wgmma", counter=counter, launches=sum(runs.values()),
                         launches_from=runs, kernels=parts, build=inst)
            by_name[key]["head_dims"][tag] = entry
            if not runs:
                continue
            kernels.append(dict(
                name=f"{key}[wgmma {d}x{dv}]", route="cuda",
                source=f"src/repro_torch/kernels/csrc/{source}",
                header="src/repro_torch/kernels/csrc/attn_bwd_wgmma.cuh", replaces=fwd,
                gradient_of=f"XLA's autodiff of {autodiff}", launches=sum(runs.values()),
                launches_from=runs, max_abs_err=rec["max_abs_err"], ms=rec["ms"],
                host_ms=rec["host_ms"], plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
                bound_by=rec["bound_by"], library_ms=rec["library_ms"],
                was_ms=rec["was_ms"], shape=tag, kernels=parts, build=inst))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace the engine phase with torch.profiler and "
                         "print device time by kernel")
    ap.add_argument("--profile-prefill", action="store_true",
                    help="trace the one-shot prefill phase with "
                         "torch.profiler and print device time by kernel")
    ap.add_argument("--parent", default=None,
                    help="a tree of the parent commit (git archive HEAD^) to hold the "
                         "d = dv = 128 attention kernels against (phase 3c); by default "
                         "git archive HEAD^ when this is a git checkout")
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

    # Compiler caches (torch.compile of the library call only) stay in
    # the checkout's gitignored build/ directory.
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(ROOT / "build" / sub))

    # Phase 2: build.
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"[build] {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    build = build_report(libs)

    # Phase 3: kernels against their plain versions.
    records: dict = {}
    kernel_phase(records)
    prefill_kernel_phase(records)
    prefill_head_dim_phase(records)
    parent_ab_phase(records, parent_tree(args.parent))
    AB_INPUTS.clear()

    # Phase 4: the chunked engine at full width; phase 5: the one-shot
    # prefill; phase 6: the monolithic engine (this slice's main path);
    # phase 7: executor parity.
    launches = engine_phase(profile=args.profile)
    prefill_phase(profile=args.profile_prefill)
    mono_launches = monolithic_phase()
    parity_phase(monolithic=False)
    parity_phase(monolithic=True)
    prefill_parity_phase()

    # Phase 8: the small configurations under both executors.
    small_config_phase()

    # Phase 9: contiguous decode, the CLI and the evaluation passes.
    p9 = contiguous_phase()

    # Phase 10: overload (preemption with host offload, SLO, chaos).
    p10 = overload_phase()
    p10_launches = lambda key: {arm: n[key] for arm, n in p10["launches"].items()}

    # Phase 11: the prefix cache and the async loop.
    p11 = prefix_async_phase(profile=args.profile)
    p11_launches = lambda key: {arm: n[key] for arm, n in p11["launches"].items()}

    # Phase 12: the MoE family (arctic-480b at full width, depth cut).
    p12 = arctic_phase()
    p12_launches = lambda key: {arm: n[key] for arm, n in p12["launches"].items()}

    # Phase 13: MLA and deepseek-v3-671b (the kernels at MLA's head dims,
    # then the model at full width, depth cut).
    mla_kernel_phase(records)
    p13 = deepseek_phase(profile=args.profile_prefill)
    p13_launches = lambda key: {arm: n[key] for arm, n in p13["launches"].items()}

    # Phase 14: the SSM, hybrid, encoder-decoder and VLM-stub families at
    # full width and depth.
    p14 = families_phase(records, profile=args.profile_prefill)
    p14_launches = lambda key: {arm: n[key] for arm, n in p14["launches"].items()}

    # Phase 15: the training path (the backward kernels, the CLI at full
    # width, the fp32 checks).
    p15 = train_phase(records)
    p15_launches = lambda key: {arm: r["launches"][key] for arm, r in p15["cli"].items()}

    kernels = []
    for key in ("score/decode", "score/chunk", "attend/decode", "attend/chunk"):
        kernel, lane = key.split("/")
        rec = records[key]["bfloat16"]
        kernels.append(dict(
            name=f"paged_{kernel}/{lane}", route="cuda", source=SOURCE,
            replaces=REPLACES[kernel], launches=launches[key],
            phase9_launches={m: p9["launches"][f"{m}/{key}"]
                             for m in ("engine", "fixed-batch")},
            phase10_launches=p10_launches(key),
            phase11_launches=p11_launches(key),
            phase12_launches=p12_launches(key),
            phase14_launches=p14_launches(key),
            phase15_launches=p15_launches(key),
            max_abs_err=max(r["max_abs_err"] for r in records[key].values()),
            ms=rec["ms"], host_ms=rec["host_ms"], plain_ms=rec["plain_ms"],
            bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
            library_ms=rec["library_ms"],
            fp32=records[key]["float32"]))
    for key, _, counter, source, replaces in PREFILL_KERNELS:
        rec = records[f"{key}/prefill"]["bfloat16"]
        kernels.append(dict(
            name=key, route="cuda", source=source, replaces=replaces,
            launches=mono_launches[counter],
            phase9_launches={m: p9["launches"][f"{m}/{counter}"]
                             for m in ("engine", "fixed-batch")},
            phase10_launches=p10_launches(counter),
            phase11_launches=p11_launches(counter),
            phase12_launches=p12_launches(counter),
            phase13_launches=p13_launches(counter),
            phase14_launches=p14_launches(counter),
            phase15_launches=p15_launches(counter),
            max_abs_err=max(r["max_abs_err"]
                            for r in records[f"{key}/prefill"].values()),
            ms=rec["ms"], host_ms=rec["host_ms"], plain_ms=rec["plain_ms"],
            bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
            library_ms=rec["library_ms"],
            fp32=records[f"{key}/prefill"]["float32"]))
    # the backward kernels (phase 15): launches of the training CLI's arm
    # that runs them (12 steps), timed at its shapes
    for key, arm in (("flash_attention_bwd", "dense"), ("block_sparse_attention_bwd", "stem")):
        _, source, fwd, autodiff = TRAIN_SOURCES[key]
        rec = records[f"{key}/train"]["bfloat16"]
        kernels.append(dict(
            name=key, route="cuda", source=f"src/repro_torch/kernels/csrc/{source}",
            replaces=fwd, gradient_of=f"XLA's autodiff of {autodiff} (the reference "
            "trains through it; its TPU kernel has no backward)",
            launches=p15["cli"][arm]["launches"][key],
            phase15_launches=p15_launches(key),
            launches_per_step=p15["cli"][arm]["launches"][key] / P15["steps"],
            max_abs_err=max(r["max_abs_err"] for r in records[f"{key}/train"].values()),
            ms=rec["ms"], host_ms=rec["host_ms"], plain_ms=rec["plain_ms"],
            bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
            library_ms=rec["library_ms"], fp32=records[f"{key}/train"]["float32"],
            step_share=p15["cli"][arm]["bwd_kernel_share"],
            wgmma_launches=p15["cli"][arm]["launches"][f"{key}_wgmma"]))
    # the tensor-core backward's two kernels each: launched once per
    # wgmma-route call of their wrapper, timed alone by the profiler; the
    # plain version and the library call are the whole backward's (above)
    for name, key, part in BWD_WGMMA:
        arm = "dense" if key.startswith("flash") else "stem"
        _, source, fwd, _ = TRAIN_SOURCES[key]
        rec = records[f"{name}/train"]["bfloat16"]
        kernels.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/kernels/csrc/{source}",
            header="src/repro_torch/kernels/csrc/attn_bwd_wgmma.cuh", replaces=fwd,
            part_of=key, launches=p15["cli"][arm]["launches"][f"{key}_wgmma"],
            phase15_launches=p15_launches(f"{key}_wgmma"),
            max_abs_err=rec["max_abs_err"], ms=rec["ms"], plain_ms=rec["plain_ms"],
            bound_ms=rec["bound_ms"], bound_by=rec["bound_by"], library_ms=None))
    log("[phase15] " + json.dumps({arm: {k: r[k] for k in (
        "step_ms", "tokens_s", "peak_gib", "bwd_kernel_share")}
        for arm, r in {**p15["cli"], **p15["families"]}.items()}))
    # the pool and vmag at the chunk lane's shapes, beside their 16k rows;
    # flash and block-sparse at head_dim 64 and 256
    by_name = {k["name"]: k for k in kernels}
    by_name["antidiag_pool"]["chunk_shapes"] = {
        lane: records[f"antidiag_pool/{lane}"]["bfloat16"]
        for lane in ("chunk_q", "chunk_k")}
    by_name["value_magnitude"]["chunk_shapes"] = {
        "chunk_v": records["value_magnitude/chunk"]["bfloat16"]}
    # the tensor-core instances at the head dims besides 128: each pair's
    # rows (phase 3 at d 64 / 256, phase 13 (d) at MLA's), its build, and
    # its launches on the model path that runs it (phase 14: whisper-medium
    # at d 64, gemma-2b at d 256; phase 13 (b): deepseek-v3-671b at (192,
    # 128)).  No model path runs (192, 192) (deepseek's MTP layer is not
    # served): it is held and timed in phase 13 (d) alone.
    paths = {(64, 64): ("d64", p14["launches"], "whisper"),
             (256, 256): ("d256", p14["launches"], "gemma"),
             (192, 128): ("d192v128", p13["launches"], "b"),
             (192, 192): ("d192", None, None)}
    for key, stem, arm, source in (
            ("flash_attention", "flash_attention", "dense", PREFILL_KERNELS[1][3]),
            ("block_sparse_attention", "block_sparse_attn", "stem", PREFILL_KERNELS[0][3])):
        kernel = "flash_wgmma_kernel" if stem == "flash_attention" else "block_sparse_wgmma_kernel"
        by_name[key]["head_dims"] = {}
        for (d, dv), (tag, runs, model) in paths.items():
            rec = records[f"{key}/{tag}"]["bfloat16"]
            counter = wgmma_counter(key, d, dv)
            launches_ = runs[f"{model}/{arm}"].get(counter, 0) if runs else None
            inst = {n: b for n, b in build[stem].items() if n.startswith(f"{kernel}<{d}x{dv} ")}
            by_name[key]["head_dims"][tag] = dict(rec, route="wgmma", counter=counter,
                                                  launches=launches_, build=inst)
            if runs is None:
                continue
            kernels.append(dict(
                name=f"{key}[wgmma {d}x{dv}]", route="cuda", source=source,
                header="src/repro_torch/kernels/csrc/attn_wgmma.cuh",
                replaces=by_name[key]["replaces"], launches=launches_,
                launches_from=f"{model} prefill ({arm})", max_abs_err=rec["max_abs_err"],
                ms=rec["ms"], host_ms=rec["host_ms"], plain_ms=rec["plain_ms"],
                bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
                library_ms=rec["library_ms"], shape=tag, build=inst))
    bwd_pair_entries(kernels, by_name, records, p15, build)
    # phase 14: each kernel at whisper-medium's decoder shapes
    for key, lanes in (("flash_attention", ("whisper",)),
                       ("block_sparse_attention", ("whisper",)),
                       ("antidiag_pool", ("whisper_q", "whisper_k")),
                       ("value_magnitude", ("whisper",))):
        by_name[key]["whisper_shapes"] = {
            lane: records[f"{key}/{lane}"]["bfloat16"] for lane in lanes}
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
