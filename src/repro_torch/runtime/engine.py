"""Continuous-batching serving engine over the paged Stem KV cache (port of
``repro/runtime/engine.py``: one device, the synchronous loop, no prefix
cache).

Requests arrive over time, are admitted into a fixed set of slots with an
all-or-nothing page reservation for their whole lifetime (the reserved
pages are reset to pristine), and advance together through one mixed step
per iteration: a decode lane of one token per slot plus a narrow
chunked-prefill lane.  One ``step()``:

  1. **Admission control** (``EngineConfig.admission_control``, off by
     default) rejects an arrived request whose TTFT SLO is infeasible at
     the measured step time.
  2. **Admission** — ordered by ``(priority desc, submission order)``
     over the arrived waiting requests and the preempted ones under the
     SLO scheduler (``scheduler="slo"``; ``"fcfs"`` admits strictly the
     waiting head), gated on a free slot and the page reservation.  A
     slot- or memory-blocked request may **preempt** a strictly
     lower-priority running one: the victim's pages (K/V + kg / vm
     summaries) are gathered to a pinned host snapshot
     (``runtime/offload.py``), its pages go back to the allocator, and it
     re-admits later by scattering the snapshot into fresh pages
     bit-identically — zero prefill recompute.  Then **load shedding**:
     with ``max_waiting`` set, overflow rejects the lowest-priority
     (newest among ties) waiting request as a failed ``FinishedRequest``.
  3. **Token-budget scheduling** — each step spends at most
     ``step_token_budget`` tokens: decode tokens first, ordered by
     ``(priority, TPOT headroom, least recently served)`` (FCFS:
     admission order), the rest deferred; then whole prefill chunks in
     ``(priority, TTFT headroom, admission)`` order into the static chunk
     lanes.  Under decode pressure (a deferral or a violated TPOT SLO) the
     chunk grant is capped at one lane; a lone chunk always runs when
     nothing else would, and a chunk is forced after
     ``chunk_starve_steps`` starved steps.
  4. **Mixed step**, inside the failure boundary: an injected failure
     (``runtime/chaos.py``) raised before any pool write is retried up to
     ``max_step_retries`` times, then the lowest-priority active request
     is aborted (a failed ``FinishedRequest``) and the step retried.
     ``StragglerMonitor`` times every working step.
  5. **Recycling** — slots hitting EOS or max-new-tokens free their pages.
     Page accounting is asserted after every preempt, restore and abort.

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
the host fetches only the ids.  The pools are updated in place (the
reference's are functional), which is why every failure injection sits
ahead of the pool writes it guards.  PyTorch runs eagerly, so the engine
has no trace counter (the reference's ``traces`` / ``prefill_traces``).
Not ported yet: the prefix cache, the async loop and mesh serving.
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
from repro_torch.runtime import offload as offload_lib
from repro_torch.runtime import paged as paged_lib
from repro_torch.runtime import sampling as sampling_lib
from repro_torch.runtime.fault_tolerance import InjectedFailure
from repro_torch.runtime.straggler import StragglerMonitor


class EngineStalledError(RuntimeError):
    """``StemEngine.run`` hit its step cap with requests still in flight;
    carries the stuck uids (running / waiting / preempted)."""

    def __init__(self, max_steps: int, running: list, waiting: list,
                 preempted: list):
        self.running, self.waiting, self.preempted = running, waiting, preempted
        super().__init__(
            f"engine stalled: {max_steps} steps without draining; stuck "
            f"requests: running uids {running}, waiting uids {waiting}, "
            f"preempted uids {preempted}")


@dataclasses.dataclass
class Request:
    """One generation request.

    ``priority``: higher wins admission and decode-token grants, and may
    preempt strictly lower-priority running requests (SLO scheduler only).
    ``ttft_slo_s`` / ``tpot_slo_s``: optional latency targets; the
    scheduler orders equal-priority work by remaining SLO headroom."""
    uid: int
    prompt: np.ndarray            # (prompt_len,) int32 token ids
    max_new_tokens: int
    arrival_step: int = 0         # engine step at which the request exists
    priority: int = 0
    ttft_slo_s: Optional[float] = None
    tpot_slo_s: Optional[float] = None


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
    token_latencies_s: list       # inter-token gaps (swapped-out time
                                  # while preempted included)
    priority: int = 0
    preemptions: int = 0          # times swapped out to host and restored
    queue_s: float = 0.0          # arrival -> admission wait (in ttft_s too)
    error: Optional[str] = None   # None = finished; else shed / abort reason


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
    admission instead of in chunks.

    Overload knobs: ``scheduler`` "slo" (priority + SLO-headroom order,
    preemption-capable) or "fcfs" (admission order everywhere, no
    preemption); ``preemption`` lets admission evict strictly
    lower-priority running requests to host memory; ``max_waiting``
    bounds the waiting queue (overflow is shed; None = unbounded);
    ``max_step_retries`` / ``max_restore_retries`` bound the retries of a
    failed mixed step / offload restore before the engine aborts a
    request; ``chunk_starve_steps`` is the most steps a prefill waits
    without a chunk before one is forced; ``straggler_threshold`` the
    step-time outlier factor of the ``StragglerMonitor``;
    ``admission_control`` rejects an arrived request whose TTFT SLO is
    infeasible at the measured step time (off by default)."""
    max_slots: int = 4
    num_pages: int = 64
    max_pages_per_slot: int = 16
    budget_frac: float = 1.0      # 1.0 = dense-equivalent oracle arm
    executor: Optional[str] = None
    eos_id: Optional[int] = None
    chunk_size: Optional[int] = None
    step_token_budget: Optional[int] = None
    monolithic_prefill: bool = False
    scheduler: str = "slo"
    preemption: bool = True
    max_waiting: Optional[int] = None
    max_step_retries: int = 2
    max_restore_retries: int = 2
    chunk_starve_steps: int = 4
    straggler_threshold: float = 3.0
    admission_control: bool = False
    sampler: str = "greedy"

    def __post_init__(self):
        if self.scheduler not in ("slo", "fcfs"):
            raise ValueError(f"unknown scheduler {self.scheduler!r} "
                             "(expected 'slo' or 'fcfs')")
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
    preemptions: int = 0
    last_sched_step: int = 0      # last step granted a decode token


@dataclasses.dataclass
class _Preempted:
    """A swapped-out request: slot state frozen, its pages on the host."""
    st: _SlotState
    npages: int                   # device pages to re-reserve
    cache_len: int                # cache_lens value at preemption
    seq: int                      # original submission order
    preempt_step: int
    restore_attempts: int = 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StemEngine:
    """Continuous-batching engine: host-side scheduler + one mixed step.

    ``stem_cfg`` is any policy spelling (``SparsityPolicy``, registered
    name, ``StemConfig``).  The engine runs on the device of ``params``
    (``cuda`` for the port's entry points unless the caller built the
    parameters on the CPU).  ``chaos`` (a ``runtime.chaos.ChaosInjector``)
    optionally injects allocator denials, step failures and restore
    failures at configured engine steps."""

    def __init__(self, bundle, params, stem_cfg,
                 ecfg: EngineConfig = EngineConfig(), chaos=None):
        transformer.assert_paged_servable(bundle.cfg)
        self.bundle = bundle
        self.cfg = bundle.cfg
        self.params = params
        self.device = params["embed"].device
        self.policy = policy_lib.as_policy(stem_cfg)
        if ecfg.executor is not None:
            self.policy = self.policy.with_updates(executor=ecfg.executor)
        self.ecfg = ecfg
        self.chaos = chaos
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
        self.preempted: list = []              # _Preempted records
        self.finished: list = []
        self.host_store = offload_lib.HostPageStore()
        self.step_count = 0
        self.stats = {"prefills": 0, "chunks": 0, "decode_steps": 0,
                      "step_calls": 0, "tokens_generated": 0,
                      "slots_reused": 0, "max_concurrency": 0,
                      "preemptions": 0, "restores": 0, "restore_failures": 0,
                      "step_failures": 0, "aborts": 0, "shed": 0,
                      "decode_deferrals": 0, "chunk_caps": 0,
                      "starvation_grants": 0, "alloc_denials": 0,
                      "straggler_steps": 0, "admission_rejects": 0,
                      "restore_bytes": 0}
        self._slot_ever_used = [False] * S
        self._seq: dict = {}                   # uid -> submission order
        self._arrival_t: dict = {}             # uid -> first-schedulable wall
        self._next_seq = 0
        self._last_chunk_step = 0
        self.monitor = StragglerMonitor(threshold=ecfg.straggler_threshold)
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
        # Restore-cost model: preemption victims are priced by the bytes
        # their restore moves host -> device over a measured-bandwidth EMA
        # (seeded pessimistically until the first timed restore).
        self._page_nbytes = (sum(t.numel() * t.element_size()
                                 for t in offload_lib.leaves(self.pools))
                             // ecfg.num_pages)
        self._h2d_bw_ema: Optional[float] = None

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

    def reset_metrics(self) -> None:
        """Zero the workload observability state (finished list, counters,
        slot-reuse tracking, straggler flags) without touching pools, slots
        or the allocator — e.g. after a warm-up pass.  The straggler EMA
        stays warm; only its flag history resets."""
        self.finished.clear()
        self.stats.update({k: 0 for k in self.stats})
        self._slot_ever_used = [False] * self.ecfg.max_slots
        self.monitor.flagged.clear()

    @property
    def metrics(self) -> dict:
        """Live observability: straggler flags, offload residency, chaos
        counters."""
        return {
            "h2d_bw_bytes_per_s": self._h2d_bw_ema,
            "step_time_ema_s": self.monitor.ema,
            "straggler_steps": list(self.monitor.flagged),
            "offloaded_requests": len(self.preempted),
            "offload_resident_bytes": self.host_store.nbytes,
            "offload_peak_bytes": self.host_store.peak_nbytes,
            "allocator_evictions": self.allocator.evictions,
            "allocator_restores": self.allocator.restores,
            "allocator_total_alloced": self.allocator.total_alloced,
            "chaos": self.chaos.counts if self.chaos else None,
        }

    def _free_slot(self) -> Optional[int]:
        return next((s for s, st in enumerate(self.slots) if st is None), None)

    def _check_pages(self) -> None:
        """Conservation after any path that moves pages: the pages the
        slots hold must be exactly the allocator's allocated set."""
        self.allocator.check_conservation(
            [p for pages in self.slot_pages if pages for p in pages])

    # -- preemption + host offload ------------------------------------------

    def preempt(self, slot: int) -> None:
        """Swap a running request out to host memory: gather its pages
        (K/V + kg / vm summaries) into a pinned host snapshot, evict them,
        and park the frozen slot state on the preempted list.  Re-admission
        restores bit-identically with zero recompute."""
        st = self.slots[slot]
        if st is None:
            raise ValueError(f"slot {slot} is not active")
        pages = self.slot_pages[slot]
        snap = offload_lib.gather_pages(
            self.pools, torch.as_tensor(pages, device=self.device))
        self.host_store.put(st.req.uid, snap)
        st.preemptions += 1
        self.preempted.append(_Preempted(
            st=st, npages=len(pages), cache_len=int(self.cache_lens[slot]),
            seq=self._seq[st.req.uid], preempt_step=self.step_count))
        self.allocator.evict(pages)
        self.page_table[slot] = 0
        self.cache_lens[slot] = 0
        self.slot_pages[slot] = None
        self.slots[slot] = None
        self.stats["preemptions"] += 1
        self._check_pages()

    def _admit_restore(self, rec: _Preempted, slot: int, pages: list) -> bool:
        """Swap a preempted request back in: scatter its snapshot into the
        fresh pages.  On an injected restore failure: free the fresh pages,
        keep the snapshot, retry on a later step — or abort the request
        with an explicit error once ``max_restore_retries`` is exhausted."""
        uid = rec.st.req.uid
        # Injection point: ahead of the scatter, which writes the pools in
        # place — a failed restore must leave no page written.
        try:
            if self.chaos:
                self.chaos.maybe_fail_restore(self.step_count)
        except InjectedFailure as e:
            self.allocator.free(pages)
            rec.restore_attempts += 1
            self.stats["restore_failures"] += 1
            if rec.restore_attempts > self.ecfg.max_restore_retries:
                self.host_store.drop(uid)
                self.stats["aborts"] += 1
                self._finish_with_error(
                    rec.st, slot=-1,
                    error=f"aborted: restore failed "
                          f"{rec.restore_attempts} times ({e})")
            else:
                self.preempted.append(rec)
            self._check_pages()
            return False
        snap = self.host_store.pop(uid)
        ids = torch.as_tensor(pages, device=self.device)
        # Time the host -> device scatter (synchronized on both sides) for
        # the restore-cost model's bandwidth EMA.
        _sync(self.device)
        t0 = time.perf_counter()
        offload_lib.scatter_pages(self.pools, ids, snap)
        _sync(self.device)
        nbytes = rec.npages * self._page_nbytes
        self.stats["restore_bytes"] += nbytes
        if nbytes:
            bw = nbytes / max(time.perf_counter() - t0, 1e-9)
            self._h2d_bw_ema = (bw if self._h2d_bw_ema is None
                                else 0.5 * self._h2d_bw_ema + 0.5 * bw)
        row = np.zeros((self.ecfg.max_pages_per_slot,), np.int32)
        row[:len(pages)] = pages
        if self._slot_ever_used[slot]:
            self.stats["slots_reused"] += 1
        self._slot_ever_used[slot] = True
        self.page_table[slot] = row
        self.cache_lens[slot] = rec.cache_len
        self.slot_pages[slot] = list(pages)
        self.slots[slot] = rec.st
        self.stats["restores"] += 1
        self._check_pages()
        return True

    def _try_preempt_for(self, priority: int, need_pages: int) -> bool:
        """Preempt one strictly lower-priority running request to make room
        (a slot and / or pages) for an admission at ``priority``.  Refuses
        when evicting every eligible victim still could not free enough
        pages — no pointless offloads."""
        if self.ecfg.scheduler != "slo" or not self.ecfg.preemption:
            return False
        victims = [s for s, st in enumerate(self.slots)
                   if st is not None and st.req.priority < priority]
        if not victims:
            return False
        reclaimable = sum(len(self.slot_pages[s]) for s in victims)
        if self.allocator.available + reclaimable < need_pages:
            return False
        # The victim class is the LOWEST priority present; within it, evict
        # the request whose restore is cheapest in seconds
        # (``_restore_cost_s``), then the most recently admitted (least
        # sunk progress), then the higher slot id.
        lowest = min(self.slots[s].req.priority for s in victims)
        cls = [s for s in victims if self.slots[s].req.priority == lowest]
        victim = min(cls, key=lambda s: (
            self._restore_cost_s(s), -self.slots[s].admitted_step, -s))
        self.preempt(victim)
        return True

    # Pessimistic PCIe-class seed bandwidth until the first timed restore.
    _BW_SEED = 8e9

    def _restore_cost_s(self, slot: int) -> float:
        """Estimated seconds to swap ``slot`` back in: its pages x page
        bytes over the measured restore bandwidth EMA."""
        return (len(self.slot_pages[slot]) * self._page_nbytes
                / (self._h2d_bw_ema or self._BW_SEED))

    # -- failure paths ------------------------------------------------------

    def _finish_with_error(self, st: _SlotState, slot: int, error: str) -> None:
        tpot = (float("nan") if len(st.tokens) < 2 else
                (st.last_token_t - st.first_token_t) / (len(st.tokens) - 1))
        self.finished.append(FinishedRequest(
            uid=st.req.uid, prompt_len=len(st.req.prompt), tokens=st.tokens,
            slot=slot, admitted_step=st.admitted_step,
            finished_step=self.step_count,
            ttft_s=st.ttft_s if st.tokens else float("nan"), tpot_s=tpot,
            token_latencies_s=st.token_latencies_s,
            priority=st.req.priority, preemptions=st.preemptions,
            queue_s=st.admit_t - st.arrival_t, error=error))
        self._seq.pop(st.req.uid, None)   # the uid may be resubmitted

    def _release_slot(self, slot: int) -> None:
        self.allocator.free(self.slot_pages[slot])
        self.page_table[slot] = 0
        self.cache_lens[slot] = 0
        self.slot_pages[slot] = None
        self.slots[slot] = None

    def _abort(self, slot: int, error: str) -> None:
        """Terminate an active request with an explicit error; its pages go
        back to the allocator and the slot frees up."""
        self._finish_with_error(self.slots[slot], slot, error)
        self._release_slot(slot)
        self.stats["aborts"] += 1
        self._check_pages()

    def _reject(self, req: Request, error: str) -> None:
        """A waiting request finished as failed, without ever running."""
        self.finished.append(FinishedRequest(
            uid=req.uid, prompt_len=len(req.prompt), tokens=[], slot=-1,
            admitted_step=-1, finished_step=self.step_count,
            ttft_s=float("nan"), tpot_s=float("nan"), token_latencies_s=[],
            priority=req.priority, error=error))
        self._seq.pop(req.uid, None)

    def _shed(self) -> None:
        """Bound the waiting queue: overflow rejects the lowest-priority
        (newest among ties; FCFS: the newest) waiting request."""
        lim = self.ecfg.max_waiting
        if lim is None:
            return
        while len(self.waiting) > lim:
            if self.ecfg.scheduler == "fcfs":
                i = len(self.waiting) - 1
            else:
                i = min(range(len(self.waiting)),
                        key=lambda j: (self.waiting[j].priority,
                                       -self._seq[self.waiting[j].uid]))
            req = self.waiting[i]
            del self.waiting[i]
            self._reject(req, f"shed: waiting queue exceeded max_waiting={lim}")
            self.stats["shed"] += 1

    def _admission_control(self) -> None:
        """SLO-aware admission control (off by default): reject an arrived
        request up front when its TTFT SLO is already infeasible at the
        current step-time EMA.  Prefill throughput is bounded by
        ``chunk_lanes * chunk_size`` tokens a step, so a request behind
        ``ahead`` backlogged prompt tokens needs at least
        ``ceil((ahead + own) / cap)`` more steps; queueing time already
        spent counts too.  Requests without a TTFT SLO are never rejected;
        a cold engine (no EMA) admits everything."""
        if not self.ecfg.admission_control:
            return
        ema = self.monitor.ema
        if not ema:
            return
        now = time.perf_counter()
        cap = self.chunk_lanes * self.chunk_size
        backlog = sum(len(st.padded) - st.prefill_pos for st in self.slots
                      if st is not None and st.phase == "prefill")
        arrived = [r for r in self.waiting if r.arrival_step <= self.step_count]
        if self.ecfg.scheduler == "slo":
            arrived.sort(key=lambda r: (-r.priority, self._seq[r.uid]))
        ahead = backlog
        reject = []
        for r in arrived:
            padded = -(-len(r.prompt) // self.page_size) * self.page_size
            if r.ttft_slo_s is not None:
                steps = -(-(ahead + padded) // cap)
                est = (now - self._arrival_t.get(r.uid, now)) + steps * ema
                if est > r.ttft_slo_s:
                    reject.append((r, est, steps))
                    continue
            ahead += padded
        for r, est, steps in reject:
            self.waiting.remove(r)
            self._reject(r, f"rejected: TTFT SLO {r.ttft_slo_s * 1e3:.1f} ms "
                            f"infeasible (>= {steps} prefill steps "
                            f"~ {est * 1e3:.1f} ms at current load)")
            self.stats["admission_rejects"] += 1

    def _lowest_priority_active(self) -> Optional[int]:
        active = [s for s, st in enumerate(self.slots) if st is not None]
        if not active:
            return None
        return min(active, key=lambda s: (self.slots[s].req.priority,
                                          -self.slots[s].admitted_step, -s))

    def _try_alloc(self, n: int, restore: bool = False):
        """(pages | None, chaos_denied).  An injected denial models
        transient allocator exhaustion: the admission blocks this step and
        retries on the next — it never triggers preemption."""
        if self.chaos and self.chaos.deny_alloc(self.step_count):
            self.stats["alloc_denials"] += 1
            return None, True
        pages = (self.allocator.restore(n) if restore
                 else self.allocator.alloc(n))
        return pages, False

    # -- admission ----------------------------------------------------------

    def _next_candidate(self):
        """Head-of-line admission candidate ``(kind, index)`` or None.
        FCFS: strictly the waiting head.  SLO: the best of the preempted and
        the arrived waiting requests by (priority desc, submission order) —
        admission never skips past a better candidate that is blocked."""
        if self.ecfg.scheduler == "fcfs":
            if self.waiting and self.waiting[0].arrival_step <= self.step_count:
                return ("new", 0)
            return None
        best, best_key = None, None
        for i, rec in enumerate(self.preempted):
            key = (-rec.st.req.priority, rec.seq)
            if best_key is None or key < best_key:
                best, best_key = ("pre", i), key
        for i, req in enumerate(self.waiting):
            if req.arrival_step > self.step_count:
                continue
            key = (-req.priority, self._seq[req.uid])
            if best_key is None or key < best_key:
                best, best_key = ("new", i), key
        return best

    def _admit(self) -> None:
        # Admit first, shed after: the queue bound applies to what remains
        # waiting once this step's capacity is used.
        self._admit_loop()
        self._shed()

    def _admit_loop(self) -> None:
        while True:
            cand = self._next_candidate()
            if cand is None:
                return
            kind, idx = cand
            if kind == "new":
                req = self.waiting[idx]
                prio = req.priority
                npages = pages_needed(len(req.prompt), req.max_new_tokens,
                                      self.page_size)
            else:
                rec = self.preempted[idx]
                prio = rec.st.req.priority
                npages = rec.npages
            slot = self._free_slot()
            if slot is None:
                if not self._try_preempt_for(prio, npages):
                    return                  # slot-blocked: the head waits
                slot = self._free_slot()
            pages, denied = self._try_alloc(npages, restore=(kind == "pre"))
            while pages is None and not denied:
                if not self._try_preempt_for(prio, npages):
                    return                  # memory-blocked: the head waits
                pages, denied = self._try_alloc(npages,
                                                restore=(kind == "pre"))
            if denied:
                return                      # transient exhaustion: retry later
            if kind == "pre":
                del self.preempted[idx]
                if not self._admit_restore(rec, slot, pages):
                    return                  # restore failed: handled inside
                continue
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
            priority=st.req.priority, preemptions=st.preemptions,
            queue_s=st.admit_t - st.arrival_t))
        self._seq.pop(st.req.uid, None)
        self._release_slot(slot)

    def _decode_key(self, s: int, now: float):
        """Decode-token grant order.  SLO: priority first, then remaining
        TPOT headroom (no-SLO slots last within the tier), then least
        recently served.  FCFS: admission order."""
        st = self.slots[s]
        if self.ecfg.scheduler == "fcfs":
            return (0, 0.0, st.admitted_step, s)
        slo = st.req.tpot_slo_s
        headroom = (slo - (now - st.last_token_t)) if slo else float("inf")
        return (-st.req.priority, headroom, st.last_sched_step, s)

    def _chunk_key(self, s: int, now: float):
        """Chunk grant order: priority, then remaining TTFT headroom."""
        st = self.slots[s]
        if self.ecfg.scheduler == "fcfs":
            return (0, 0.0, st.admitted_step, s)
        slo = st.req.ttft_slo_s
        headroom = (slo - (now - st.arrival_t)) if slo else float("inf")
        return (-st.req.priority, headroom, st.admitted_step, s)

    def _schedule(self, dec_all: list, pre_all: list, sched_now: float) -> tuple:
        """The token-budget grant pass: (granted decode slots, granted chunk
        slots)."""
        self.stats["max_concurrency"] = max(self.stats["max_concurrency"],
                                            len(dec_all) + len(pre_all))
        C = self.chunk_size
        cap = max(1, self.token_budget)
        dec_sorted = sorted(dec_all, key=lambda s: self._decode_key(s, sched_now))
        dec = dec_sorted[:cap]
        deferred = dec_sorted[cap:]
        self.stats["decode_deferrals"] += len(deferred)
        pre = sorted(pre_all, key=lambda s: self._chunk_key(s, sched_now))
        # Adaptive chunk sizing: under decode-lane TPOT pressure (a decode
        # was deferred, or a TPOT SLO is violated now) cap the chunk grant
        # at one lane.
        pressure = False
        if self.ecfg.scheduler == "slo":
            violating = any(
                self.slots[s].req.tpot_slo_s is not None
                and sched_now - self.slots[s].last_token_t
                    > self.slots[s].req.tpot_slo_s
                for s in dec_sorted)
            pressure = bool(deferred) or violating
        lanes_cap = 1 if pressure else self.chunk_lanes
        if pressure and pre and lanes_cap < self.chunk_lanes:
            self.stats["chunk_caps"] += 1
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
        # Injection point: ahead of the grant bookkeeping and of every pool
        # write of the step (``_unified`` updates the pools in place), so a
        # retried step never applies a summary increment twice.
        if self.chaos:
            self.chaos.maybe_fail_step(self.step_count)
        dec, grant = self._schedule(dec_all, pre_all, time.perf_counter())

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

    def _guarded_step(self) -> None:
        """The failure boundary around the mixed step: bounded retry of a
        failed step (the injection precedes every pool write, so a retry
        is sound), then graceful degradation — abort the lowest-priority
        active request and retry with the smaller batch.  Working steps
        are timed by the StragglerMonitor; failed or idle ones are not."""
        retries = 0
        while True:
            self.monitor.start()
            try:
                did_work = self._mixed_step()
            except InjectedFailure as e:
                self.monitor.cancel()
                self.stats["step_failures"] += 1
                retries += 1
                if retries > self.ecfg.max_step_retries:
                    victim = self._lowest_priority_active()
                    if victim is None:
                        raise
                    self._abort(victim,
                                f"aborted: step failed {retries} times ({e})")
                    retries = 0
                continue
            if did_work:
                self.monitor.stop(self.step_count)
                self.stats["straggler_steps"] = len(self.monitor.flagged)
            else:
                self.monitor.cancel()
            return

    def step(self) -> None:
        """One engine iteration: admission control, admit (with
        preemption) + shed, one guarded mixed step, recycle."""
        # Stamp arrival wall time the first step each request is
        # schedulable: TTFT and TTFT-SLO headroom count queueing time.
        now = time.perf_counter()
        for r in self.waiting:
            if r.arrival_step <= self.step_count and r.uid not in self._arrival_t:
                self._arrival_t[r.uid] = now
        self._admission_control()
        self._admit()
        self._guarded_step()
        self.step_count += 1

    @property
    def pending(self) -> int:
        return (len(self.waiting) + len(self.preempted)
                + sum(st is not None for st in self.slots))

    def run(self, requests=(), max_steps: int = 100_000) -> list:
        """Drive submitted (+ given) requests to completion; returns
        FinishedRequests sorted by uid (failed ones carry ``.error``).
        Raises ``EngineStalledError`` naming the stuck requests if the
        engine cannot drain within ``max_steps`` further steps."""
        for r in requests:
            self.submit(r)
        start = self.step_count
        while self.pending:
            if self.step_count - start >= max_steps:
                raise EngineStalledError(
                    max_steps,
                    running=[st.req.uid for st in self.slots if st is not None],
                    waiting=[r.uid for r in self.waiting],
                    preempted=[rec.st.req.uid for rec in self.preempted])
            self.step()
        return sorted(self.finished, key=lambda f: f.uid)
