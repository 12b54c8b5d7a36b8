"""Continuous-batching serving engine over the paged Stem KV cache (port of
``repro/runtime/engine.py``, cut to the main path).

Requests arrive over time, are admitted into a fixed set of slots with an
all-or-nothing page reservation for their whole lifetime (the reserved
pages are reset to pristine), and advance together through one mixed step
per iteration: a decode lane of one token per slot plus a narrow
chunked-prefill lane.  Each step spends at most ``step_token_budget``
tokens — decode tokens first (least recently served first), then whole
prefill chunks in admission order into the static chunk lanes, with the
reference's liveness rules (a lone chunk always runs when nothing else
would, and a chunk is forced after ``chunk_starve_steps`` starved steps).
This is what the reference's default ``scheduler="slo"`` reduces to when
every request has the default priority and no SLOs.  Slots hitting EOS or
max-new-tokens free their pages and are recycled.

With ``EngineConfig(monolithic_prefill=True)`` a request is instead
prefilled whole at admission — the paper's one-shot pre-filling phase
(``transformer.prefill_kv_pages`` through ``launch/steps.py``'s monolithic
prefill): its reserved pages are reset, the prompt runs through
``sparse_attention`` (or the dense arm for a one-block prompt), its pages
and summaries are written, and the first token is sampled on the device;
the host fetches one int.  Decode then runs in the mixed step as usual.
This is also the only path that serves budget-free (threshold) selectors
such as ``xattention``, which chunked prefill refuses.

The loop is synchronous: the step's logits stay on the device, the
registered sampler (greedy: first maximal index) reduces them to ids, and
the host fetches only the ids.  PyTorch runs eagerly, so the engine has no
trace counter (the reference's ``traces`` / ``prefill_traces``).  Not
ported yet: preemption and host offload, chaos injection, the prefix cache,
the async loop, mesh serving and SLO ordering.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import chunked as chunked_lib
from repro_torch.core import policy as policy_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.models import transformer
from repro_torch.runtime import paged as paged_lib
from repro_torch.runtime import sampling as sampling_lib


class EngineStalledError(RuntimeError):
    """``StemEngine.run`` hit its step cap with requests still in flight."""

    def __init__(self, max_steps: int, running: list, waiting: list):
        self.running, self.waiting = running, waiting
        super().__init__(
            f"engine stalled: {max_steps} steps without draining; stuck "
            f"requests: running uids {running}, waiting uids {waiting}")


@dataclasses.dataclass
class Request:
    """One generation request (the reference's priority and SLO fields
    arrive with the SLO scheduler)."""
    uid: int
    prompt: np.ndarray            # (prompt_len,) int32 token ids
    max_new_tokens: int
    arrival_step: int = 0         # engine step at which the request exists


@dataclasses.dataclass
class FinishedRequest:
    uid: int
    prompt_len: int
    tokens: list                  # generated token ids (greedy)
    slot: int
    admitted_step: int
    finished_step: int
    ttft_s: float                 # arrival -> first token (queueing included)
    tpot_s: float                 # mean per-output-token time after the
                                  # first (NaN with a single token)
    token_latencies_s: list       # inter-token gaps
    queue_s: float = 0.0          # arrival -> admission wait (in ttft_s too)


def pages_needed(prompt_len: int, max_new: int, page_size: int) -> int:
    """Pages a request holds for its whole lifetime: the prompt plus every
    generated token that is fed back (the final one is not)."""
    cached = prompt_len + max(max_new - 1, 0)
    return -(-cached // page_size)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Sizing + policy knobs of the serving engine (the fields of the
    reference's ``EngineConfig`` that this path reads, same defaults).

    ``num_pages`` includes the reserved trash page 0; a request needs
    ``pages_needed(prompt_len, max_new_tokens, page_size)`` pages, at most
    ``max_pages_per_slot``.  ``chunk_size`` (a page multiple; None = 2
    pages) is the prefill-lane width; ``step_token_budget`` (None =
    max_slots + chunk_size) caps the tokens one step may spend.
    ``executor`` picks the attention backend of the paged lanes and of the
    monolithic prefill ("fused" kernels | "gather" oracle; None defers to
    the policy).  ``monolithic_prefill`` prefills each prompt whole at
    admission instead of in chunks."""
    max_slots: int = 4
    num_pages: int = 64
    max_pages_per_slot: int = 16
    budget_frac: float = 1.0      # 1.0 = dense-equivalent oracle arm
    executor: Optional[str] = None
    eos_id: Optional[int] = None
    chunk_size: Optional[int] = None
    step_token_budget: Optional[int] = None
    chunk_starve_steps: int = 4
    monolithic_prefill: bool = False
    sampler: str = "greedy"

    def __post_init__(self):
        sampling_lib.get_sampler(self.sampler)   # validate the name early

    @classmethod
    def for_trace(cls, *, max_slots: int, max_prompt: int,
                  max_new_tokens: int, page_size: int,
                  budget_frac: float = 1.0, eos_id: Optional[int] = None,
                  chunk_size: Optional[int] = None,
                  step_token_budget: Optional[int] = None,
                  monolithic_prefill: bool = False,
                  **knobs) -> "EngineConfig":
        """Size the pool so every slot can hold the largest trace request."""
        per_slot = pages_needed(max_prompt, max_new_tokens, page_size)
        return cls(max_slots=max_slots, num_pages=1 + max_slots * per_slot,
                   max_pages_per_slot=per_slot, budget_frac=budget_frac,
                   eos_id=eos_id, chunk_size=chunk_size,
                   step_token_budget=step_token_budget,
                   monolithic_prefill=monolithic_prefill, **knobs)


@dataclasses.dataclass
class _SlotState:
    req: Request
    tokens: list
    admitted_step: int
    admit_t: float
    arrival_t: float
    phase: str                    # "prefill" | "decode"
    prefill_pos: int              # next absolute prompt position to process
    padded: np.ndarray            # (Lp,) prompt right-padded to a page multiple
    true_len: int
    ttft_s: float = 0.0
    first_token_t: float = 0.0
    last_token_t: float = 0.0
    token_latencies_s: list = dataclasses.field(default_factory=list)
    last_sched_step: int = 0      # last step granted a decode token


class StemEngine:
    """Continuous-batching engine: host-side scheduler + one mixed step.

    ``stem_cfg`` is any policy spelling (``SparsityPolicy``, registered
    name, ``StemConfig``).  The engine runs on the device of ``params``
    (``cuda`` for the port's entry points unless the caller built the
    parameters on the CPU)."""

    def __init__(self, bundle, params, stem_cfg,
                 ecfg: EngineConfig = EngineConfig()):
        transformer.assert_paged_servable(bundle.cfg)
        self.bundle = bundle
        self.cfg = bundle.cfg
        self.params = params
        self.device = params["embed"].device
        self.policy = policy_lib.as_policy(stem_cfg)
        if ecfg.executor is not None:
            self.policy = self.policy.with_updates(executor=ecfg.executor)
        self.ecfg = ecfg
        self.page_size = self.policy.block_size
        self.chunk_size = ecfg.chunk_size or 2 * self.page_size
        if self.chunk_size % self.page_size:
            raise ValueError(
                f"chunk_size {self.chunk_size} must be a multiple of the "
                f"page size {self.page_size}")
        self.token_budget = (ecfg.step_token_budget
                             or ecfg.max_slots + self.chunk_size)
        self.chunk_lanes = min(ecfg.max_slots,
                               max(1, self.token_budget // self.chunk_size))
        if not ecfg.monolithic_prefill:
            chunked_lib.validate_chunked_policy(self.policy)

        S, P = ecfg.max_slots, ecfg.max_pages_per_slot
        self.pools = transformer.init_page_pools(
            bundle.cfg, ecfg.num_pages, self.policy, device=self.device)
        self.allocator = paged_lib.PageAllocator(ecfg.num_pages)
        self.page_table = np.zeros((S, P), np.int32)
        self.cache_lens = np.zeros((S,), np.int32)
        self.slot_pages: list = [None] * S
        self.slots: list = [None] * S
        self.waiting: collections.deque = collections.deque()
        self.finished: list = []
        self.step_count = 0
        self.stats = {"prefills": 0, "chunks": 0, "decode_steps": 0,
                      "step_calls": 0, "tokens_generated": 0,
                      "slots_reused": 0, "max_concurrency": 0,
                      "decode_deferrals": 0, "starvation_grants": 0}
        self._slot_ever_used = [False] * S
        self._seq: dict = {}                   # uid -> submission order
        self._arrival_t: dict = {}             # uid -> first-schedulable wall
        self._next_seq = 0
        self._last_chunk_step = 0
        self.sampler = sampling_lib.get_sampler(ecfg.sampler)
        # The static chunk-selection width: the largest block budget any
        # admissible prompt can reach.
        k_bound = (0 if ecfg.monolithic_prefill else
                   chunked_lib.chunk_budget_bound(self.policy, P))
        self._unified = steps_lib.make_unified_step(
            bundle, stem_cfg=self.policy, budget_frac=ecfg.budget_frac,
            chunk_k_max=k_bound)
        self._prefill = None
        if ecfg.monolithic_prefill:
            self._prefill = steps_lib.make_monolithic_prefill(
                bundle, stem_cfg=self.policy, sampler=self.sampler)

    # -- scheduling ---------------------------------------------------------

    def submit(self, req: Request) -> None:
        npages = pages_needed(len(req.prompt), req.max_new_tokens,
                              self.page_size)
        if npages > self.ecfg.max_pages_per_slot:
            raise ValueError(
                f"request {req.uid} needs {npages} pages > max_pages_per_slot "
                f"{self.ecfg.max_pages_per_slot}")
        if req.uid in self._seq:
            raise ValueError(f"duplicate request uid {req.uid}")
        self._seq[req.uid] = self._next_seq
        self._next_seq += 1
        self.waiting.append(req)

    def _next_candidate(self) -> Optional[int]:
        """Index of the earliest-submitted arrived waiting request."""
        best, best_key = None, None
        for i, req in enumerate(self.waiting):
            if req.arrival_step > self.step_count:
                continue
            key = self._seq[req.uid]
            if best_key is None or key < best_key:
                best, best_key = i, key
        return best

    def _admit(self) -> None:
        while True:
            idx = self._next_candidate()
            if idx is None:
                return
            slot = next((s for s, st in enumerate(self.slots) if st is None),
                        None)
            if slot is None:
                return                         # slot-blocked: head waits
            req = self.waiting[idx]
            pages = self.allocator.alloc(pages_needed(
                len(req.prompt), req.max_new_tokens, self.page_size))
            if pages is None:
                return                         # memory-blocked: head waits
            del self.waiting[idx]
            self._admit_new(req, slot, pages)

    def _admit_new(self, req: Request, slot: int, pages: list) -> None:
        plen = len(req.prompt)
        padded_len = -(-plen // self.page_size) * self.page_size
        row = np.zeros((self.ecfg.max_pages_per_slot,), np.int32)
        row[:len(pages)] = pages
        if self._slot_ever_used[slot]:
            self.stats["slots_reused"] += 1
        self._slot_ever_used[slot] = True
        self.page_table[slot] = row
        self.slot_pages[slot] = list(pages)
        now = time.perf_counter()
        arrival = self._arrival_t.get(req.uid, now)
        ptoks = np.zeros((padded_len,), np.int32)
        ptoks[:plen] = req.prompt

        if self.ecfg.monolithic_prefill:
            # The whole prompt at admission (the reserved pages are reset
            # inside prefill_kv_pages); the first token is sampled on the
            # device and the host fetches one int.
            first_id, self.pools = self._prefill(
                self.params, torch.as_tensor(ptoks[None], device=self.device),
                plen, self.pools, torch.as_tensor(row, device=self.device))
            first = int(first_id)
            done = time.perf_counter()
            self.stats["prefills"] += 1
            self.stats["tokens_generated"] += 1
            self.cache_lens[slot] = plen
            st = _SlotState(
                req=req, tokens=[first], admitted_step=self.step_count,
                admit_t=now, arrival_t=arrival, phase="decode",
                prefill_pos=padded_len, padded=np.zeros((0,), np.int32),
                true_len=plen, ttft_s=done - arrival, first_token_t=done,
                last_token_t=done, last_sched_step=self.step_count)
            self.slots[slot] = st
            if self._is_finished(st):
                self._recycle(slot)
            return

        # Recycled pages are dirty; chunk writes + decode increments assume
        # pristine pages.  The reset row is trash-padded to a fixed width.
        paged_lib.reset_pools_stacked(
            self.pools, torch.as_tensor(row, device=self.device))
        self.cache_lens[slot] = 0
        self.slots[slot] = _SlotState(
            req=req, tokens=[], admitted_step=self.step_count, admit_t=now,
            arrival_t=arrival, phase="prefill",
            prefill_pos=0, padded=ptoks, true_len=plen,
            last_sched_step=self.step_count)

    def _is_finished(self, st: _SlotState) -> bool:
        if len(st.tokens) >= st.req.max_new_tokens:
            return True
        return self.ecfg.eos_id is not None and st.tokens[-1] == self.ecfg.eos_id

    def _recycle(self, slot: int) -> None:
        st = self.slots[slot]
        tpot = (float("nan") if len(st.tokens) < 2 else
                (st.last_token_t - st.first_token_t) / (len(st.tokens) - 1))
        self.finished.append(FinishedRequest(
            uid=st.req.uid, prompt_len=len(st.req.prompt), tokens=st.tokens,
            slot=slot, admitted_step=st.admitted_step,
            finished_step=self.step_count, ttft_s=st.ttft_s, tpot_s=tpot,
            token_latencies_s=st.token_latencies_s,
            queue_s=st.admit_t - st.arrival_t))
        self._seq.pop(st.req.uid, None)
        self.allocator.free(self.slot_pages[slot])
        self.page_table[slot] = 0
        self.cache_lens[slot] = 0
        self.slot_pages[slot] = None
        self.slots[slot] = None

    def _schedule(self, dec_all: list, pre_all: list) -> tuple:
        """The token-budget grant pass: (granted decode slots, granted chunk
        slots)."""
        self.stats["max_concurrency"] = max(self.stats["max_concurrency"],
                                            len(dec_all) + len(pre_all))
        C = self.chunk_size
        cap = max(1, self.token_budget)
        dec_sorted = sorted(dec_all,
                            key=lambda s: (self.slots[s].last_sched_step, s))
        dec = dec_sorted[:cap]
        deferred = dec_sorted[cap:]
        self.stats["decode_deferrals"] += len(deferred)
        pre = sorted(pre_all, key=lambda s: (self.slots[s].admitted_step, s))
        lanes_cap = 1 if deferred else self.chunk_lanes
        remaining = self.token_budget - len(dec)
        grant = []
        for s in pre:
            if len(grant) >= lanes_cap:
                break
            if remaining >= C or (not grant and not dec):
                grant.append(s)
                remaining -= C
        if (not grant and pre and self.step_count - self._last_chunk_step
                >= self.ecfg.chunk_starve_steps):
            grant = [pre[0]]
            self.stats["starvation_grants"] += 1
        if grant or not pre:
            self._last_chunk_step = self.step_count
        return dec, grant

    def _mixed_step(self) -> bool:
        """One synchronous mixed step: the scheduled decode tokens plus the
        granted prefill chunks; the host blocks on the sampled ids."""
        dec_all = [s for s, st in enumerate(self.slots)
                   if st is not None and st.phase == "decode"]
        pre_all = [s for s, st in enumerate(self.slots)
                   if st is not None and st.phase == "prefill"]
        if not dec_all and not pre_all:
            self._last_chunk_step = self.step_count
            return False
        dec, grant = self._schedule(dec_all, pre_all)

        C = self.chunk_size
        S, P = self.ecfg.max_slots, self.ecfg.max_pages_per_slot
        dev = self.device
        tokens = np.zeros((S, 1), np.int32)
        dec_table = np.zeros((S, P), np.int32)
        dec_lens = np.zeros((S,), np.int32)
        for s in dec:
            tokens[s, 0] = self.slots[s].tokens[-1]
            dec_table[s] = self.page_table[s]
            dec_lens[s] = self.cache_lens[s]
            self.slots[s].last_sched_step = self.step_count

        chunk = None
        if grant:
            L, nc = self.chunk_lanes, C // self.page_size
            ctoks = np.zeros((L, C), np.int32)
            ctable = np.zeros((L, P), np.int32)
            cstart = np.zeros((L,), np.int32)
            ctrue = np.zeros((L,), np.int32)
            cbud = np.zeros((L, nc), np.int32)
            clast = np.zeros((L,), np.int32)
            for lane, s in enumerate(grant):
                st = self.slots[s]
                pos = st.prefill_pos
                avail = st.padded[pos:pos + C]
                ctoks[lane, :len(avail)] = avail
                ctable[lane] = self.page_table[s]
                cstart[lane] = pos
                ctrue[lane] = st.true_len
                cbud[lane] = chunked_lib.chunk_budget_rows(
                    self.policy, len(st.padded), pos, nc)
                clast[lane] = min(max(st.true_len - 1 - pos, 0), C - 1)
            chunk = {k: torch.as_tensor(v, device=dev) for k, v in (
                ("tokens", ctoks), ("page_table", ctable), ("start", cstart),
                ("true_len", ctrue), ("budgets", cbud), ("last", clast))}

        dec_logits, chunk_logits, self.pools = self._unified(
            self.params, self.pools, torch.as_tensor(tokens, device=dev),
            torch.as_tensor(dec_table, device=dev),
            torch.as_tensor(dec_lens, device=dev), chunk)
        dec_ids = self.sampler(dec_logits).cpu().numpy() if dec else None
        chunk_ids = self.sampler(chunk_logits).cpu().numpy() if grant else None
        now = time.perf_counter()
        self.stats["step_calls"] += 1
        if dec:
            self.stats["decode_steps"] += 1

        for s in dec:
            self.cache_lens[s] += 1           # the fed-back token is now cached
            st = self.slots[s]
            st.tokens.append(int(dec_ids[s]))
            st.token_latencies_s.append(now - st.last_token_t)
            st.last_token_t = now
            self.stats["tokens_generated"] += 1
            if self._is_finished(st):
                self._recycle(s)

        for lane, s in enumerate(grant):
            st = self.slots[s]
            st.prefill_pos += C
            self.stats["chunks"] += 1
            if st.prefill_pos >= len(st.padded):
                # The chunk that completes the prompt: its logits at the true
                # last token give the request's first generated token.
                st.tokens = [int(chunk_ids[lane])]
                st.phase = "decode"
                self.cache_lens[s] = st.true_len
                st.first_token_t = st.last_token_t = now
                st.ttft_s = now - st.arrival_t
                self.stats["prefills"] += 1
                self.stats["tokens_generated"] += 1
                if self._is_finished(st):
                    self._recycle(s)
        return True

    def step(self) -> None:
        """One engine iteration: admit, one mixed step, recycle."""
        now = time.perf_counter()
        for r in self.waiting:
            if r.arrival_step <= self.step_count and r.uid not in self._arrival_t:
                self._arrival_t[r.uid] = now
        self._admit()
        self._mixed_step()
        self.step_count += 1

    @property
    def pending(self) -> int:
        return len(self.waiting) + sum(st is not None for st in self.slots)

    def run(self, requests=(), max_steps: int = 100_000) -> list:
        """Drive submitted (+ given) requests to completion; returns
        FinishedRequests sorted by uid."""
        for r in requests:
            self.submit(r)
        start = self.step_count
        while self.pending:
            if self.step_count - start >= max_steps:
                raise EngineStalledError(
                    max_steps,
                    running=[st.req.uid for st in self.slots if st is not None],
                    waiting=[r.uid for r in self.waiting])
            self.step()
        return sorted(self.finished, key=lambda f: f.uid)
