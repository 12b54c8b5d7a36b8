"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --profile  # also trace phase 4 with torch.profiler
    python3 chip_smoke.py --profile-prefill  # also trace phase 5's prefills

Phases:
  1. device   — require CUDA; print the card's name and power limit.
  2. build    — compile every kernel source under
                src/repro_torch/kernels/csrc/ with nvcc (sm_90a) into
                build/kernels/, one nvcc per source started together, timed;
                print each kernel's registers, stack and local memory
                (cuobjdump -res-usage: spills would show as stack / local
                bytes) and require HGMMA (wgmma) in the flash,
                block-sparse and paged-attention libraries.
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
                prompt, bf16 on the CUDA-core tile; flash beside SDPA,
                block-sparse beside flex_attention).
                fp32 outputs within 1e-4 abs; bf16 outputs within 2 bf16
                ulps of the plain output plus 1e-3 * the max|plain| of the
                element's row (last axis), except the bf16 attention on the
                tensor-core tile (flash, block-sparse, the paged chunk
                lane), which rounds P to bf16 before P.V: its row floor is
                1e-2 * max|plain|.  The same rule must reject the
                block-sparse kernel's output with one key tile dropped from
                each row past 4k (the selection of each bf16 attention
                check: stem's, and every causal block for flash), and the
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

Prints a {"kernels": [...]} line, the nvidia-smi line, and as its last line
{"ok": true, "device": {...}}.  Any failed phase raises (non-zero exit).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
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

from repro_torch.configs import GLM4_9B, QWEN3_0_6B, reduced  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.core import chunked as chunked_lib  # noqa: E402
from repro_torch.core import decode as decode_lib  # noqa: E402
from repro_torch.core import metric as metric_lib  # noqa: E402
from repro_torch.core import policy as policy_lib  # noqa: E402
from repro_torch.core.selection import selection_density  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import block_sparse_attn as bsa_kern  # noqa: E402
from repro_torch.kernels import flash_attention as flash_kern  # noqa: E402
from repro_torch.kernels import paged_attn as kern  # noqa: E402
from repro_torch.kernels import replay  # noqa: E402
from repro_torch.kernels import stem_metric as metric_kern  # noqa: E402
from repro_torch.kernels.replay import tolerance  # noqa: E402
from repro_torch.launch import serve as serve_lib  # noqa: E402
from repro_torch.launch import steps as steps_lib  # noqa: E402
from repro_torch.models import attention as attention_lib  # noqa: E402
from repro_torch.models import common  # noqa: E402
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


def check_rejects_dropped_tile(name, q, k, v, idx, cnt, want, bs) -> None:
    """The bf16 attention rule must see the long rows: the block-sparse
    kernel over the selection (idx, cnt) passes it, and fails it once the
    last live block of each row past 4k (with two or more) is dropped."""
    check_close(f"{name}/block-sparse kernel, same selection",
                bsa_kern.block_sparse_attention(q, k, v, idx, live_counts=cnt,
                                                block_size=bs), want, p_bf16=True)
    past = (torch.arange(idx.shape[2], device=idx.device) * bs >= 4096) & (cnt >= 2)
    got = bsa_kern.block_sparse_attention(
        q, k, v, idx, live_counts=torch.where(past, cnt - 1, cnt).to(torch.int32),
        block_size=bs).float()
    want = want.float()
    over = (got - want).abs() / tolerance(want, torch.bfloat16, p_bf16=True)
    rows = int((over > 1).any(-1).sum())
    log(f"[kernels] {name} with one key tile dropped from each row past 4k: "
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


def build_report(libs: dict) -> None:
    """Registers, stack and local memory of every kernel (spills would show
    as stack / local bytes), and the tensor-core instructions (HGMMA in the
    SASS) of the bf16 attention tile."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    run = lambda *a: subprocess.run([cuobjdump, *a], check=True, capture_output=True,
                                    text=True).stdout
    for stem in sorted(libs):
        name = None
        for line in run("-res-usage", str(libs[stem])).splitlines():
            m = re.search(r"Function (\S+):", line)
            if m:
                short = re.search(r"[a-z_]+_kernel", m.group(1))
                name = short.group(0) if short else m.group(1)
            m = re.search(r"REG:(\d+) STACK:(\d+).*LOCAL:(\d+)", line)
            if m and name is not None:
                log(f"[build] {stem}: {name} {m.group(1)} registers, stack "
                    f"{m.group(2)} B, local {m.group(3)} B")
                name = None
    for stem in ("flash_attention", "block_sparse_attn", "paged_attn"):
        sass = run("-sass", str(libs[stem]))
        n = sass.count("HGMMA")
        log(f"[build] {stem}: {n} HGMMA instructions in the SASS")
        if n == 0:
            raise AssertionError(f"{stem}: no wgmma in the built library")


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


def bsa_bytes_flops(q, k, idx, cnt, group, dedup, bs):
    d, es = q.shape[-1], q.element_size()
    hsel = idx.shape[1]
    live = torch.arange(idx.shape[-1], device=idx.device) < cnt[..., None].long()
    kvh = (torch.arange(hsel, device=idx.device) // (1 if dedup else group))
    key = (kvh[None, :, None, None].expand_as(idx).long() << 32) | idx.long()
    blocks = int(torch.unique(key[live]).numel())
    nbytes = (2 * q.numel() * es + 2 * blocks * bs * d * es
              + (idx.numel() + cnt.numel()) * 4)
    heads = group if dedup else 1
    return nbytes, 4.0 * d * causal_pairs(idx, cnt, bs) * heads


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
            # every causal block, the diagonal first: the fault drops block i - 1
            i = torch.arange(n // bs, device=dev)[:, None]
            j = torch.arange(n // bs, device=dev)[None, :]
            idx = torch.where(j == 0, i, j - 1).expand(1, hq, n // bs, n // bs)
            cnt = (i[:, 0] + 1).expand(1, hq, n // bs)
            check_rejects_dropped_tile("flash_attention", q, k, v,
                                       idx.to(torch.int32).contiguous(),
                                       cnt.to(torch.int32).contiguous(), want, bs)
        pairs = hq * n * (n + 1) / 2
        rec_kernel(records, "flash_attention", "prefill", tag, err, run_k, run_p,
                   (2 * q.numel() * es + 2 * k.numel() * es, 4.0 * d * pairs),
                   dtype, run_lib=run_l, iters=5, plain_iters=1)
        del q, k, v, got, want, mask
        torch.cuda.empty_cache()


def prefill_head_dim_phase(records: dict, dev=torch.device("cuda")) -> None:
    """Flash and block-sparse attention at head_dim 64 and 256 (bf16 on the
    CUDA-core tile: fp32 products and probabilities), a 4096-token prompt,
    16 / 8 heads, block 128, stem's TPD selection: each against its plain
    version (the 1e-3 bf16 rule: P stays fp32) and timed (flash beside
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
        run_k = lambda: flash_kern.flash_attention(q, k, v)
        run_p = lambda: flash_kern.flash_attention_plain(q, k, v)
        run_l = lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)
        got, want = run_k(), run_p()
        torch.cuda.synchronize()
        err = check_close(f"flash_attention/d{d}/bfloat16", got, want)
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
        got, want = run_k(), run_p()
        torch.cuda.synchronize()
        err = check_close(f"block_sparse_attention/d{d}/bfloat16", got, want)
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


def profile_summary(prof, wall: float, top: int = 12) -> None:
    """Device time by kernel name and the device's busy share of the run
    (the top rows, then the rest of the port's own kernels), then host time
    by operator (self CPU time: where a host-bound run goes)."""
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


def _glm_cli(fixed, cfg, bundle, params, policy, executor, rec=None) -> tuple:
    """The CLI's run_engine / run_fixed_batch (serve.py) under
    ``executor``: the engine on 2 requests of 2048-4096 tokens, the fixed
    batch on 2 of 4096 (a block multiple, so its prefill is sparse), 8 new
    tokens; logits rows and chunk selections tapped.  Returns (result,
    rows by request, chunk selections)."""
    args = serve_lib.build_parser().parse_args(
        cli_args("glm4-9b", 4096 if fixed else 2048, 4096, 8,
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


def _engine_launches(arm: str) -> dict:
    launches = read_all_launches()
    missing = [k for k in ENGINE_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"phase 10 {arm}: kernels never launched: {missing}")
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


def overload_run(bundle, params, arm: str, scheduler: str, plan=None) -> dict:
    """Serve the overload trace (2 slots, pool sized by for_trace) under
    ``scheduler`` and an optional chaos plan; counters zeroed before and
    read after.  Records each preemption's (step, uid, victim phase) and
    each restore's step."""
    policy = policy_lib.get_policy("stem")
    ecfg = _overload_ecfg(2, max(OVERLOAD_LP), 32, scheduler=scheduler)
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
    launches = _engine_launches(arm)
    if not bool(eng.sampler.finite):
        raise AssertionError(f"phase 10 {arm}: non-finite logits")
    errors = {f.uid: f.error for f in fin if f.error is not None}
    if errors:
        raise AssertionError(f"phase 10 {arm}: failed requests {errors}")
    eng.allocator.check_conservation([])
    hp = [f for f in fin if f.priority == 1]
    lp = [f for f in fin if f.priority == 0]
    metrics = eng.metrics
    s = eng.stats
    return dict(
        arm=arm, wall_s=wall,
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


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(x, device) for k, x in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(x, device) for x in tree)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace the engine phase with torch.profiler and "
                         "print device time by kernel")
    ap.add_argument("--profile-prefill", action="store_true",
                    help="trace the one-shot prefill phase with "
                         "torch.profiler and print device time by kernel")
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
    build_report(libs)

    # Phase 3: kernels against their plain versions.
    records: dict = {}
    kernel_phase(records)
    prefill_kernel_phase(records)
    prefill_head_dim_phase(records)

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
            max_abs_err=max(r["max_abs_err"]
                            for r in records[f"{key}/prefill"].values()),
            ms=rec["ms"], host_ms=rec["host_ms"], plain_ms=rec["plain_ms"],
            bound_ms=rec["bound_ms"], bound_by=rec["bound_by"],
            library_ms=rec["library_ms"],
            fp32=records[f"{key}/prefill"]["float32"]))
    # the pool and vmag at the chunk lane's shapes, beside their 16k rows;
    # flash and block-sparse at head_dim 64 and 256
    by_name = {k["name"]: k for k in kernels}
    by_name["antidiag_pool"]["chunk_shapes"] = {
        lane: records[f"antidiag_pool/{lane}"]["bfloat16"]
        for lane in ("chunk_q", "chunk_k")}
    by_name["value_magnitude"]["chunk_shapes"] = {
        "chunk_v": records["value_magnitude/chunk"]["bfloat16"]}
    for key in ("flash_attention", "block_sparse_attention"):
        by_name[key]["head_dims"] = {f"d{d}": records[f"{key}/d{d}"]["bfloat16"]
                                     for d in (64, 256)}
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
