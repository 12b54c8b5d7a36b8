"""Continuous-batching serving engine over the paged Stem KV cache (port of
``repro/runtime/engine.py``).

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

With ``EngineConfig(prefix_cache=True)`` admission probes the allocator's
prefix index for the prompt's whole pages (chained content keys,
``paged.prefix_page_keys``), maps the hits read-only at the head of the
slot's page table and starts the prefill past them: only the unmatched
suffix is prefilled and only its pages are allocated.  The page holding
the prompt's last token is always replayed; when it matched (a fully
matched page-multiple prompt) it is copied on write into a private page.
A completed prompt registers its full pages; at refcount 0 they park in
the allocator's cached set until ``alloc`` reclaims them (``prefix_evict``
"lru" | "hit-rate").  A preempted request snapshots only its private
pages and keeps one reference on each shared page until it is restored.

The synchronous loop (``async_depth=0``, the differential oracle): the
step's logits stay on the device, the registered sampler (greedy: first
maximal index) reduces them to ids, and the host blocks on the ids.  With
``async_depth=1`` the sampler runs inside the step
(``transformer.paged_sampled_step``), the fed-back decode tokens live in a
device-resident buffer, and the host dispatches step N+1 while step N is
still running: the step's inputs go up from pinned host buffers without
blocking, its ids come back the same way behind an event, and only
``_reconcile`` waits.  EOS is reconciled one step late; the one
speculative step of a finished request writes only into its own
still-reserved pages, and every pool write runs on the one compute stream,
so the streams equal the synchronous loop's bitwise.

The pools are updated in place (the reference's are functional), which is
why every failure injection sits ahead of the pool writes it guards.
With ``EngineConfig(mesh=(dp, tp))`` one engine drives a serving mesh
(``sharding/serving.py``): tp splits every page pool over its KV heads
(each shard scores, selects and attends its heads on its own device, the
outputs gathered before ``wo``: the single-device step, bitwise), and dp
adds slot groups, each with ``max_slots`` slots, ``num_pages`` pages and
its own ``PageAllocator``.  The scheduler partitions its grants by group,
each group with the full token budget and its own chunk lanes; a new
request goes to the group with a free slot and the most free pages, a
restore to its own group.  A step costs one host fetch per active lane
kind, mesh or not.

PyTorch runs eagerly, so the engine has no trace counter (the reference's
``traces`` / ``prefill_traces``).
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
from repro_torch.sharding import serving as serving_lib


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
    infeasible at the measured step time (off by default).

    ``prefix_cache`` shares whole prompt pages between requests through
    the allocator's prefix index (chunked prefill only); ``prefix_evict``
    is the cached pages' reclaim order, "lru" or "hit-rate".
    ``async_depth`` 0 is the synchronous loop, 1 the one-step-lookahead
    async loop (chunked prefill only).

    ``mesh`` ``(dp, tp)`` serves on a device mesh (ref
    ``src/repro/runtime/engine.py:219-227``): tp splits the pools' KV-head
    axis, dp adds slot groups of ``max_slots`` slots and ``num_pages``
    pages each; None is one device.  Chunked prefill only."""
    max_slots: int = 4
    num_pages: int = 64
    max_pages_per_slot: int = 16
    budget_frac: float = 1.0      # 1.0 = dense-equivalent oracle arm
    executor: Optional[str] = None
    eos_id: Optional[int] = None
    chunk_size: Optional[int] = None
    step_token_budget: Optional[int] = None
    monolithic_prefill: bool = False
    prefix_cache: bool = False
    scheduler: str = "slo"
    preemption: bool = True
    max_waiting: Optional[int] = None
    max_step_retries: int = 2
    max_restore_retries: int = 2
    chunk_starve_steps: int = 4
    straggler_threshold: float = 3.0
    prefix_evict: str = "lru"
    admission_control: bool = False
    async_depth: int = 0
    sampler: str = "greedy"
    mesh: Optional[tuple] = None

    def __post_init__(self):
        if self.scheduler not in ("slo", "fcfs"):
            raise ValueError(f"unknown scheduler {self.scheduler!r} "
                             "(expected 'slo' or 'fcfs')")
        if self.prefix_cache and self.monolithic_prefill:
            raise ValueError(
                "prefix_cache needs chunked prefill (the matched-prefix "
                "skip is chunk-granular); disable monolithic_prefill")
        if self.prefix_evict not in paged_lib.PageAllocator.EVICT_POLICIES:
            raise ValueError(
                f"prefix_evict must be one of "
                f"{paged_lib.PageAllocator.EVICT_POLICIES}, "
                f"got {self.prefix_evict!r}")
        if self.mesh is not None:
            if len(self.mesh) != 2 or any(int(a) < 1 for a in self.mesh):
                raise ValueError(f"mesh must be (dp >= 1, tp >= 1), "
                                 f"got {self.mesh!r}")
            if self.monolithic_prefill:
                raise ValueError(
                    "mesh serving runs through the unified chunked step; "
                    "disable monolithic_prefill")
        if self.async_depth not in (0, 1):
            raise ValueError(
                f"async_depth must be 0 (synchronous) or 1 (one-step "
                f"lookahead), got {self.async_depth!r}")
        if self.async_depth and self.monolithic_prefill:
            raise ValueError(
                "the async pipeline runs through the unified chunked step "
                "(monolithic admission prefill blocks the host per "
                "admission); disable monolithic_prefill")
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
    prefix_keys: list = dataclasses.field(default_factory=list)
                                  # chained key per full prompt page, to
                                  # register once the prefill completes
    inflight: int = 0             # async: dispatched, unreconciled tokens
    finished: bool = False        # async: terminal — in-flight results for
                                  # this request are discarded


@dataclasses.dataclass
class _Preempted:
    """A swapped-out request: slot state frozen, its private pages on the
    host.  Shared prefix pages are not snapshotted (co-tenants may read
    them); the record keeps one reference on each until the restore."""
    st: _SlotState
    npages: int                   # private device pages to re-reserve
    cache_len: int                # cache_lens value at preemption
    seq: int                      # original submission order
    preempt_step: int
    restore_attempts: int = 0
    shared_pages: list = dataclasses.field(default_factory=list)
    group: int = 0                # slot group: its snapshot's bytes belong
                                  # to that group's pool shards, so the
                                  # restore goes back there


@dataclasses.dataclass
class _InFlight:
    """One dispatched, unreconciled async step.  Its sampled ids land in
    the host buffer ``buf`` of the staging ring once ``events`` complete
    (one a device; none on the CPU).  The slot states pin the requests the
    ids belong to: a slot may be recycled before the reconcile, its state
    cannot, and a finished state marks its entries for discard."""
    buf: int
    events: list
    dec: list                     # [(slot, _SlotState), ...]
    chunks: list                  # [(group, lane, slot, _SlotState, completes)]
    step: int                     # engine step at dispatch
    dispatch_t: float


@dataclasses.dataclass
class _PrefixMatch:
    """Admission-time prefix probe, references already taken.  ``shared``:
    matched pages mapped read-only (ahead of the replayed last-token page).
    ``cow``: a matched last-token page (a fully matched page-multiple
    prompt), which the replayed chunk rewrites — copied on write.
    ``keys``: the chained key of every full prompt page."""
    keys: list
    shared: list
    cow: list


class _StagingRing:
    """Host staging of the async step: ``depth + 1`` sets, each one int32
    input buffer (the step's whole host-built input, packed: one block of
    ``n_in`` entries a slot group) and one int32 output buffer (its sampled
    ids).  On a card the buffers are pinned: each group's block goes up
    with one ``non_blocking`` copy into that group's device buffer on its
    lead device (stream order keeps a later copy behind the step that
    reads it), the ids come back with ``non_blocking`` copies and one event
    a device, and a set is written again only after the events behind its
    last use have completed.  On the CPU the step reads the input buffer
    itself."""

    def __init__(self, n_in: int, n_out: int, depth: int, devices: list):
        self.cuda = devices[0].type == "cuda"
        self.n_in = n_in
        mk = lambda n: torch.zeros((n,), dtype=torch.int32,
                                   pin_memory=self.cuda)
        self.inp = [mk(len(devices) * n_in) for _ in range(depth + 1)]
        self.out = [mk(n_out) for _ in range(depth + 1)]
        self.done: list = [None] * (depth + 1)
        self.dev = ([torch.zeros((n_in,), dtype=torch.int32, device=d)
                     for d in devices] if self.cuda else None)
        self.groups = len(devices)
        self._next = 0

    def acquire(self) -> int:
        """The next set, once the events behind its last use completed."""
        k = self._next
        self._next = (k + 1) % len(self.inp)
        for ev in self.done[k] or ():
            ev.synchronize()
        self.done[k] = None
        return k

    def block(self, k: int, g: int, n: int):
        """The first ``n`` entries of group ``g``'s block of input set ``k``."""
        return self.inp[k][g * self.n_in:g * self.n_in + n]

    def upload(self, k: int, n: int) -> list:
        """The first ``n`` entries of every group's block of input set
        ``k``, each on its group's device."""
        blocks = [self.block(k, g, n) for g in range(self.groups)]
        if not self.cuda:
            return blocks
        out = []
        for blk, dev in zip(blocks, self.dev):
            dev[:n].copy_(blk, non_blocking=True)
            out.append(dev[:n])
        return out

    def fetch(self, k: int, parts) -> list:
        """Copy each ``(offset, ids)`` into output set ``k``; returns the
        events that complete with the copies, one a device (none on the
        CPU)."""
        devices = []
        for off, ids in parts:
            self.out[k][off:off + ids.shape[0]].copy_(ids, non_blocking=True)
            if ids.device not in devices:
                devices.append(ids.device)
        if not self.cuda:
            return []
        events = []
        for dev in devices:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            events.append(ev)
        self.done[k] = events
        return events


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without blocking the host: through pinned
    memory on a card (the caching host allocator keeps the block until the
    copy has run)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class StemEngine:
    """Continuous-batching engine: host-side scheduler + one mixed step.

    ``stem_cfg`` is any policy spelling (``SparsityPolicy``, registered
    name, ``StemConfig``).  The engine runs on the device of ``params``
    (``cuda`` for the port's entry points unless the caller built the
    parameters on the CPU).  ``chaos`` (a ``runtime.chaos.ChaosInjector``)
    optionally injects allocator denials, step failures and restore
    failures at configured engine steps.

    With ``ecfg.mesh`` the mesh takes the first ``dp * tp`` devices of
    ``mesh_devices`` (the cards, or CPU shards when ``params`` are on the
    CPU, by default; a list may repeat a device), and the parameters are
    replicated once a distinct device.  Flat slot ids ``[g * max_slots,
    (g + 1) * max_slots)`` belong to group ``g``."""

    def __init__(self, bundle, params, stem_cfg,
                 ecfg: EngineConfig = EngineConfig(), chaos=None,
                 mesh_devices=None):
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
        # Serving mesh (ref ``src/repro/runtime/engine.py:447-470``): dp
        # slot groups, each with its own allocator and pages, and tp KV-head
        # shards of every pool.  smesh None is the one-device path, one group.
        self.smesh = None
        if ecfg.mesh is not None:
            dp, tp = (int(a) for a in ecfg.mesh)
            self.smesh = serving_lib.make_serving_mesh(
                dp, tp, mesh_devices, platform=self.device.type)
            serving_lib.validate_serving(bundle.cfg, self.policy.executor,
                                         self.smesh)
            self._replicas = serving_lib.replicate_params(params, self.smesh)
        elif mesh_devices is not None:
            raise ValueError("mesh_devices needs EngineConfig.mesh")
        self.groups = self.smesh.dp if self.smesh else 1
        self.slots_per_group = S
        self.total_slots = T = self.groups * S
        self.pools = transformer.init_page_pools(
            bundle.cfg, ecfg.num_pages, self.policy, device=self.device,
            smesh=self.smesh)
        self.allocators = [
            paged_lib.PageAllocator(ecfg.num_pages,
                                    evict_policy=ecfg.prefix_evict)
            for _ in range(self.groups)]
        self.allocator = self.allocators[0]    # the one-group alias
        self.page_table = np.zeros((T, P), np.int32)
        self.cache_lens = np.zeros((T,), np.int32)
        self.slot_pages: list = [None] * T
        self.slot_nshared = [0] * T            # leading prefix-shared pages
        self.slots: list = [None] * T
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
                      "straggler_steps": 0, "prefix_hits": 0,
                      "prefix_pages_shared": 0, "prefix_cows": 0,
                      "admission_rejects": 0, "host_syncs": 0,
                      "id_fetches": 0, "lookahead_discards": 0,
                      "restore_bytes": 0, "dispatch_s": 0.0,
                      "sync_wait_s": 0.0}
        self._slot_ever_used = [False] * T
        self._seq: dict = {}                   # uid -> submission order
        self._arrival_t: dict = {}             # uid -> first-schedulable wall
        self._next_seq = 0
        self._last_chunk_step = [0] * self.groups   # per slot group
        self.monitor = StragglerMonitor(threshold=ecfg.straggler_threshold)
        self.sampler = sampling_lib.get_sampler(ecfg.sampler)
        # The static chunk-selection width: the largest block budget any
        # admissible prompt can reach.
        k_bound = (0 if ecfg.monolithic_prefill else
                   chunked_lib.chunk_budget_bound(self.policy, P))
        self._async = ecfg.async_depth > 0
        self._unified = steps_lib.make_unified_step(
            bundle, stem_cfg=self.policy, budget_frac=ecfg.budget_frac,
            chunk_k_max=k_bound, sampler=self.sampler if self._async else None,
            smesh=self.smesh)
        self._prefill = None
        if ecfg.monolithic_prefill:
            self._prefill = steps_lib.make_monolithic_prefill(
                bundle, stem_cfg=self.policy, sampler=self.sampler)
        # Async pipeline state: the device-resident fed-back token buffer
        # (one entry per slot plus a trash entry for idle chunk lanes; under
        # the mesh one buffer a group, on its lead device), the host staging
        # ring and the dispatched, unreconciled steps.
        self._inflight: collections.deque = collections.deque()
        self.token_buf = None
        self._ring = None
        if self._async:
            L, C = self.chunk_lanes, self.chunk_size
            nc = C // self.page_size
            bufs = [torch.zeros((S + 1,), dtype=torch.int32, device=dev)
                    for dev in self._lead_devices()]
            self.token_buf = bufs if self.smesh else bufs[0]
            # The packed input of a step: (name, offset, rows, width), the
            # decode lane's fields first (a decode-only step sends those).
            fields = (("mask", S, 1), ("lens", S, 1), ("table", S, P),
                      ("tokens", L, C), ("page_table", L, P),
                      ("budgets", L, nc), ("start", L, 1), ("true_len", L, 1),
                      ("last", L, 1), ("slot", L, 1), ("emit", L, 1))
            self._layout, off = [], 0
            for name, rows, width in fields:
                self._layout.append((name, off, rows, width))
                off += rows * width
            self._dec_n = S * (P + 2)
            self._ring = _StagingRing(off, T + self.groups * L,
                                      ecfg.async_depth, self._lead_devices())
        # Restore-cost model: preemption victims are priced by the bytes
        # their restore moves host -> device over a measured-bandwidth EMA
        # (seeded pessimistically until the first timed restore).
        trees = ([tree for shards in self.pools for tree in shards]
                 if self.smesh else [self.pools])
        self._page_nbytes = (sum(t.numel() * t.element_size()
                                 for tree in trees
                                 for t in offload_lib.leaves(tree))
                             // (self.groups * ecfg.num_pages))
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
        self.stats.update({k: type(v)() for k, v in self.stats.items()})
        self._slot_ever_used = [False] * self.total_slots
        self.monitor.flagged.clear()

    @property
    def metrics(self) -> dict:
        """Live observability: in-flight steps, straggler flags, offload
        residency, prefix sharing, chaos counters."""
        return {
            "inflight_steps": len(self._inflight),
            "h2d_bw_bytes_per_s": self._h2d_bw_ema,
            "step_time_ema_s": self.monitor.ema,
            "straggler_steps": list(self.monitor.flagged),
            "offloaded_requests": len(self.preempted),
            "offload_resident_bytes": self.host_store.nbytes,
            "offload_peak_bytes": self.host_store.peak_nbytes,
            "allocator_evictions": sum(a.evictions for a in self.allocators),
            "allocator_restores": sum(a.restores for a in self.allocators),
            "allocator_total_alloced": sum(a.total_alloced
                                           for a in self.allocators),
            "prefix_shares": sum(a.shares for a in self.allocators),
            "prefix_cached_pages": sum(a.cached_pages
                                       for a in self.allocators),
            "chaos": self.chaos.counts if self.chaos else None,
        }

    # -- slot groups (ref ``src/repro/runtime/engine.py:699-722``) ----------

    def _group_of(self, slot: int) -> int:
        return slot // self.slots_per_group

    def _group_slots(self, g: int) -> range:
        S = self.slots_per_group
        return range(g * S, (g + 1) * S)

    def _free_slot_in(self, g: int) -> Optional[int]:
        return next((s for s in self._group_slots(g) if self.slots[s] is None),
                    None)

    def _lead_devices(self) -> list:
        """Each group's lead device ``(g, 0)``: its inputs, projections, MLP,
        logits and token buffer live there."""
        if self.smesh is None:
            return [self.device]
        return [self.smesh.device(g, 0) for g in range(self.groups)]

    def _sync_group(self, g: int) -> None:
        devices = ([self.device] if self.smesh is None else
                   {self.smesh.device(g, t) for t in range(self.smesh.tp)})
        for dev in devices:
            _sync(dev)

    def _candidate_groups(self) -> list:
        """Placement order for a new request: groups with a free slot first,
        then the most available pages, then the lowest group id (ref
        ``:1111-1120``).  A restore has no choice: its snapshot belongs to
        its own group's shards."""
        return sorted(range(self.groups), key=lambda g: (
            self._free_slot_in(g) is None, -self.allocators[g].available, g))

    def _fetch_ids(self, parts, n: int) -> np.ndarray:
        """Every group's sampled ids ``(offset, ids)`` staged into one host
        buffer without blocking, then one wait: a lane kind costs one host
        sync, whatever the mesh."""
        cuda = self.device.type == "cuda"
        out = torch.empty((n,), dtype=torch.int32, pin_memory=cuda)
        devices = set()
        for off, ids in parts:
            out[off:off + ids.shape[0]].copy_(ids, non_blocking=cuda)
            devices.add(ids.device)
        if cuda:
            for dev in devices:
                _sync(dev)
        return out.numpy()

    def _check_pages(self) -> None:
        """Refcount conservation after any path that moves pages, group by
        group: one reference per slot-held page plus one per shared page an
        offloaded request pins must equal the group's allocator refcounts (a
        multiset: a page shared by k slots appears k times)."""
        for g, alloc in enumerate(self.allocators):
            held = [p for s in self._group_slots(g) if self.slot_pages[s]
                    for p in self.slot_pages[s]]
            held += [p for rec in self.preempted if rec.group == g
                     for p in rec.shared_pages]
            alloc.check_conservation(held)

    # -- preemption + host offload ------------------------------------------

    def preempt(self, slot: int) -> None:
        """Swap a running request out to host memory: gather its private
        pages (K/V + kg / vm summaries) into a pinned host snapshot, evict
        them, and park the frozen slot state on the preempted list.  Shared
        prefix pages stay on the device for their co-tenants; the record
        keeps this request's reference on each.  Re-admission restores
        bit-identically with zero recompute.  Async: the in-flight steps
        are reconciled first (host tokens and ``cache_lens`` must agree
        with the pages the snapshot gathers)."""
        if self._async and self._inflight:
            self._drain()
        st = self.slots[slot]
        if st is None:
            raise ValueError(f"slot {slot} is not active")
        g = self._group_of(slot)
        pages = self.slot_pages[slot]
        nshared = self.slot_nshared[slot]
        shared, private = pages[:nshared], pages[nshared:]
        self.host_store.put(st.req.uid, self._extract(private, g),
                            pinned=shared)
        st.preemptions += 1
        self.preempted.append(_Preempted(
            st=st, npages=len(private), cache_len=int(self.cache_lens[slot]),
            seq=self._seq[st.req.uid], preempt_step=self.step_count,
            shared_pages=list(shared), group=g))
        self.allocators[g].evict(private)
        self.page_table[slot] = 0
        self.cache_lens[slot] = 0
        self.slot_pages[slot] = None
        self.slot_nshared[slot] = 0
        self.slots[slot] = None
        self.stats["preemptions"] += 1
        self._check_pages()

    def _extract(self, pages: list, g: int):
        """Group ``g``'s ``pages`` out of the pools: a device snapshot, or
        under the mesh each tp shard's pages on the host, keyed by ``(g,
        t)`` (``offload.HostShards``; ref ``:745-760``)."""
        if self.smesh is None:
            return offload_lib.gather_pages(
                self.pools, torch.as_tensor(pages, device=self.device))
        return offload_lib.shard_snapshot_to_host({
            (g, t): offload_lib.gather_pages(
                tree, torch.as_tensor(pages, device=self.smesh.device(g, t)))
            for t, tree in enumerate(self.pools[g])}, g)

    def _restore(self, pages: list, g: int, snap) -> None:
        """Scatter a snapshot into group ``g``'s fresh ``pages``; under the
        mesh each shard's bytes go back to the device of their own ``(g,
        t)`` (ref ``:812-822``)."""
        if self.smesh is None:
            offload_lib.scatter_pages(
                self.pools, torch.as_tensor(pages, device=self.device), snap)
            return
        parts = offload_lib.assemble_sharded_snapshot(snap, self.smesh, g)
        for (_, t), part in parts.items():
            offload_lib.scatter_pages(
                self.pools[g][t],
                torch.as_tensor(pages, device=self.smesh.device(g, t)), part)

    def _admit_restore(self, rec: _Preempted, slot: int, pages: list) -> bool:
        """Swap a preempted request back in: scatter its private snapshot
        into the fresh pages; its pinned shared pages re-enter the page
        table first, untouched.  On an injected restore failure: free the
        fresh pages, keep the snapshot and the pins, retry on a later step
        — or abort the request with an explicit error once
        ``max_restore_retries`` is exhausted (releasing the pins)."""
        uid, g = rec.st.req.uid, rec.group
        # Injection point: ahead of the scatter, which writes the pools in
        # place — a failed restore must leave no page written.
        try:
            if self.chaos:
                self.chaos.maybe_fail_restore(self.step_count)
        except InjectedFailure as e:
            self.allocators[g].free(pages)
            rec.restore_attempts += 1
            self.stats["restore_failures"] += 1
            if rec.restore_attempts > self.ecfg.max_restore_retries:
                self.host_store.drop(uid)
                if rec.shared_pages:
                    self.allocators[g].free(rec.shared_pages)
                self.stats["aborts"] += 1
                self._finish_with_error(
                    rec.st, slot=-1,
                    error=f"aborted: restore failed "
                          f"{rec.restore_attempts} times ({e})")
            else:
                self.preempted.append(rec)
            self._check_pages()
            return False
        if self._async and self._inflight:
            # Reconcile first, so the synchronized scatter below times the
            # link and not the in-flight steps.
            self._drain()
        snap = self.host_store.pop(uid)
        # Time the host -> device scatter (synchronized on both sides) for
        # the restore-cost model's bandwidth EMA.
        self._sync_group(g)
        t0 = time.perf_counter()
        self._restore(pages, g, snap)
        self._sync_group(g)
        nbytes = rec.npages * self._page_nbytes
        self.stats["restore_bytes"] += nbytes
        if nbytes:
            bw = nbytes / max(time.perf_counter() - t0, 1e-9)
            self._h2d_bw_ema = (bw if self._h2d_bw_ema is None
                                else 0.5 * self._h2d_bw_ema + 0.5 * bw)
        if self._async and rec.st.tokens:
            # Re-seed the fed-back token buffer: the restored request's next
            # decode step feeds its last emitted token.
            if self.smesh is None:
                self.token_buf[slot:slot + 1].fill_(rec.st.tokens[-1])
            else:
                g, local = divmod(slot, self.slots_per_group)
                self.token_buf[g][local:local + 1].fill_(rec.st.tokens[-1])
        all_pages = list(rec.shared_pages) + list(pages)
        row = np.zeros((self.ecfg.max_pages_per_slot,), np.int32)
        row[:len(all_pages)] = all_pages
        if self._slot_ever_used[slot]:
            self.stats["slots_reused"] += 1
        self._slot_ever_used[slot] = True
        self.page_table[slot] = row
        self.cache_lens[slot] = rec.cache_len
        self.slot_pages[slot] = all_pages
        self.slot_nshared[slot] = len(rec.shared_pages)
        self.slots[slot] = rec.st
        self.stats["restores"] += 1
        self._check_pages()
        return True

    def _try_preempt_for(self, priority: int, need_pages: int,
                         group: int) -> bool:
        """Preempt one strictly lower-priority running request of slot group
        ``group`` to make room (a slot and / or pages) for an admission at
        ``priority``.  Refuses when evicting every eligible victim still
        could not free enough pages — no pointless offloads."""
        if self.ecfg.scheduler != "slo" or not self.ecfg.preemption:
            return False
        victims = [s for s in self._group_slots(group)
                   if self.slots[s] is not None
                   and self.slots[s].req.priority < priority]
        if not victims:
            return False
        if self._async and self._inflight:
            # Reconcile before evicting anyone: an in-flight step may finish
            # a request outright, freeing its slot and pages.  (The
            # reference drains before looking for a victim, so a queue
            # blocked on slots drains the pipeline every step; with no
            # victim there is nothing to evict and no reason to wait.)
            self._drain()
            if (self._free_slot_in(group) is not None
                    and self.allocators[group].available >= need_pages):
                return True
            victims = [s for s in victims if self.slots[s] is not None]
            if not victims:
                return False
        # Only a victim's private pages come back (its shared pages stay
        # pinned by its preemption record).
        reclaimable = sum(len(self.slot_pages[s]) - self.slot_nshared[s]
                          for s in victims)
        if self.allocators[group].available + reclaimable < need_pages:
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
        """Estimated seconds to swap ``slot`` back in: its private pages x
        page bytes over the measured restore bandwidth EMA (shared pages
        stay on the device either way)."""
        private = len(self.slot_pages[slot]) - self.slot_nshared[slot]
        return (private * self._page_nbytes
                / (self._h2d_bw_ema or self._BW_SEED))

    # -- failure paths ------------------------------------------------------

    def _finish_with_error(self, st: _SlotState, slot: int, error: str) -> None:
        st.finished = True   # async: in-flight work for it is discarded
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
        # Shared references drop by one (co-tenants keep the pages); a
        # registered page at refcount 0 parks in the cached set, contents
        # intact, so the next tenant with this prefix still hits.
        self.allocators[self._group_of(slot)].free(self.slot_pages[slot])
        self.page_table[slot] = 0
        self.cache_lens[slot] = 0
        self.slot_pages[slot] = None
        self.slot_nshared[slot] = 0
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
        ``groups * chunk_lanes * chunk_size`` tokens a step, so a request behind
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
        cap = self.groups * self.chunk_lanes * self.chunk_size
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

    def _try_alloc(self, n: int, group: int, restore: bool = False):
        """(pages | None, chaos_denied) from ``group``'s allocator.  An
        injected denial models transient allocator exhaustion: the admission
        blocks this step and retries on the next — it never triggers
        preemption."""
        if self.chaos and self.chaos.deny_alloc(self.step_count):
            self.stats["alloc_denials"] += 1
            return None, True
        alloc = self.allocators[group]
        return (alloc.restore(n) if restore else alloc.alloc(n)), False

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

    def _probe_prefix(self, req: Request, group: int) -> _PrefixMatch:
        """Probe ``group``'s prefix index for the request's whole prompt
        pages and take a reference on every hit before any allocation (an
        alloc drawing on the cached set could otherwise reclaim a probed
        page); the caller releases them if admission blocks.  The longest
        matched chain wins: a miss at page j ends the scan.  Each slot group
        has its own index: its pages exist only in its own pools."""
        alloc = self.allocators[group]
        plen = len(req.prompt)
        bs = self.page_size
        budgets = self.policy.prefill_budgets(-(-plen // bs) * bs)
        keys = paged_lib.prefix_page_keys(req.prompt, budgets, bs)
        # The page holding the prompt's last token is always replayed (it
        # yields the first token's logits) and its chunk rewrites it: a hit
        # there is copied on write.
        last_page = (plen - 1) // bs
        shared, cow = [], []
        for j, key in enumerate(keys):
            p = alloc.probe(key)
            if p is None:
                break
            alloc.share(p)
            (shared if j < last_page else cow).append(p)
        return _PrefixMatch(keys=keys, shared=shared, cow=cow)

    def _release_prefix(self, prefix: Optional[_PrefixMatch],
                        group: int) -> None:
        if prefix is not None and (prefix.shared or prefix.cow):
            self.allocators[group].free(prefix.shared + prefix.cow)

    def _admit_loop(self) -> None:
        while True:
            cand = self._next_candidate()
            if cand is None:
                return
            kind, idx = cand
            if kind == "new":
                req = self.waiting[idx]
                prio = req.priority
                npages_full = pages_needed(len(req.prompt), req.max_new_tokens,
                                           self.page_size)
                groups = self._candidate_groups()
            else:
                rec = self.preempted[idx]
                prio = rec.st.req.priority
                groups = [rec.group]
            # Each eligible group in order; the head of the line waits only
            # when every group is blocked (ref ``:1122-1190``).
            placed = False
            for g in groups:
                prefix = None
                npages = rec.npages if kind == "pre" else npages_full
                if kind == "new" and self.ecfg.prefix_cache:
                    prefix = self._probe_prefix(req, g)
                    npages -= len(prefix.shared)
                slot = self._free_slot_in(g)
                if slot is None:
                    if not self._try_preempt_for(prio, npages, g):
                        self._release_prefix(prefix, g)
                        continue            # slot-blocked in this group
                    slot = self._free_slot_in(g)
                pages, denied = self._try_alloc(npages, g,
                                                restore=(kind == "pre"))
                while pages is None and not denied:
                    if not self._try_preempt_for(prio, npages, g):
                        break
                    pages, denied = self._try_alloc(npages, g,
                                                    restore=(kind == "pre"))
                if denied:
                    self._release_prefix(prefix, g)
                    return                  # a transient denial: retry later
                if pages is None:
                    self._release_prefix(prefix, g)
                    continue                # memory-blocked in this group
                placed = True
                break
            if not placed:
                return                      # the head waits in every group
            if kind == "pre":
                del self.preempted[idx]
                if not self._admit_restore(rec, slot, pages):
                    return                  # restore failed: handled inside
                continue
            del self.waiting[idx]
            self._admit_new(req, slot, pages, prefix)

    def _admit_new(self, req: Request, slot: int, pages: list,
                   prefix: Optional[_PrefixMatch] = None) -> None:
        plen = len(req.prompt)
        padded_len = -(-plen // self.page_size) * self.page_size
        shared = list(prefix.shared) if prefix else []
        n_share = len(shared)
        all_pages = shared + list(pages)
        # Shared prefix pages first (the page table is position-ordered),
        # then the private allocation, trash-padded.
        row = np.zeros((self.ecfg.max_pages_per_slot,), np.int32)
        row[:len(all_pages)] = all_pages
        if self._slot_ever_used[slot]:
            self.stats["slots_reused"] += 1
        self._slot_ever_used[slot] = True
        self.page_table[slot] = row
        self.slot_pages[slot] = all_pages
        self.slot_nshared[slot] = n_share
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
            self.stats["id_fetches"] += 1
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
        # pristine pages.  Only the private reservation is reset: shared
        # prefix pages hold live contents.  The row is trash-padded; under
        # the mesh the other groups' rows name only trash page 0.
        g = self._group_of(slot)
        fresh = np.zeros((self.groups, self.ecfg.max_pages_per_slot), np.int32)
        fresh[g, :len(pages)] = pages
        if self.smesh is None:
            paged_lib.reset_pools_stacked(self.pools,
                                          _upload(fresh[0], self.device))
        else:
            paged_lib.reset_pools_grouped(self.pools, [
                _upload(row, dev) for row, dev in zip(fresh, self._lead_devices())])
        if prefix and prefix.cow:
            # Copy on write: the matched last-token page of a fully matched
            # page-multiple prompt is replayed, and its chunk rewrites it —
            # so its contents go to the private page at table index n_share
            # and the probe's reference on the original is dropped.
            src = prefix.cow[0]
            if self.smesh is None:
                paged_lib.copy_pages_stacked(self.pools, src, pages[0])
            else:
                srcv = np.zeros((self.groups,), np.int32)
                dstv = np.zeros((self.groups,), np.int32)
                srcv[g], dstv[g] = src, pages[0]
                paged_lib.copy_pages_grouped(self.pools, srcv, dstv)
            self.allocators[g].free([src])
            self.allocators[g].cows += 1  # the private page came from the
                                          # bulk alloc, not allocator.cow()
            self.stats["prefix_cows"] += 1
        if prefix and (prefix.shared or prefix.cow):
            self.stats["prefix_hits"] += 1
            self.stats["prefix_pages_shared"] += n_share
        self.cache_lens[slot] = 0
        # The prefill cursor starts past the matched prefix: only the
        # unmatched suffix (at least the replayed last-token page) runs
        # through the chunk lane.
        self.slots[slot] = _SlotState(
            req=req, tokens=[], admitted_step=self.step_count, admit_t=now,
            arrival_t=arrival, phase="prefill",
            prefill_pos=n_share * self.page_size, padded=ptoks, true_len=plen,
            last_sched_step=self.step_count,
            prefix_keys=list(prefix.keys) if prefix else [])

    def _is_finished(self, st: _SlotState) -> bool:
        if len(st.tokens) >= st.req.max_new_tokens:
            return True
        return self.ecfg.eos_id is not None and st.tokens[-1] == self.ecfg.eos_id

    def _recycle(self, slot: int) -> None:
        st = self.slots[slot]
        st.finished = True   # async: the EOS lookahead step is discarded
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

    def _register_prefix(self, s: int, st: _SlotState) -> None:
        """A completed prompt's full pages are final: content-address them
        for later tenants (idempotent for the pages it shared itself; the
        partial tail page has no key and stays private)."""
        alloc = self.allocators[self._group_of(s)]
        for j, key in enumerate(st.prefix_keys):
            alloc.register(self.slot_pages[s][j], key)

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

    def _grantable_decodes(self) -> list:
        """Decode-phase slots still owed a token.  The count includes the
        in-flight tokens (async): a max-new-tokens finish is known at
        dispatch and never speculates; only an EOS earns the one lookahead
        step, whose result is discarded."""
        return [s for s, st in enumerate(self.slots)
                if st is not None and st.phase == "decode"
                and len(st.tokens) + st.inflight < st.req.max_new_tokens]

    def _work(self) -> tuple:
        """(grantable decode slots, prefilling slots)."""
        pre = [s for s, st in enumerate(self.slots)
               if st is not None and st.phase == "prefill"]
        return self._grantable_decodes(), pre

    def _schedule(self, dec_all: list, pre_all: list, sched_now: float) -> tuple:
        """The token-budget grant pass, shared by both loops and pure host
        bookkeeping, group by group (ref ``src/repro/runtime/engine.py:
        1355-1420``: each slot group gets the full token budget and its own
        chunk lanes): (granted decode slots of every group, granted chunk
        slots of each group)."""
        self.stats["max_concurrency"] = max(self.stats["max_concurrency"],
                                            len(dec_all) + len(pre_all))
        C, Sg = self.chunk_size, self.slots_per_group
        cap = max(1, self.token_budget)
        dec, grants = [], []
        for g in range(self.groups):
            dec_sorted = sorted((s for s in dec_all if s // Sg == g),
                                key=lambda s: self._decode_key(s, sched_now))
            dec_g = dec_sorted[:cap]
            deferred = dec_sorted[cap:]
            self.stats["decode_deferrals"] += len(deferred)
            pre = sorted((s for s in pre_all if s // Sg == g),
                         key=lambda s: self._chunk_key(s, sched_now))
            # Adaptive chunk sizing: under the group's decode-lane TPOT
            # pressure (a decode was deferred, or a TPOT SLO is violated
            # now) cap the chunk grant at one lane.
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
            remaining = self.token_budget - len(dec_g)
            grant = []
            for s in pre:
                if len(grant) >= lanes_cap:
                    break
                if remaining >= C or (not grant and not dec_g):
                    grant.append(s)
                    remaining -= C
            if (not grant and pre and self.step_count - self._last_chunk_step[g]
                    >= self.ecfg.chunk_starve_steps):
                grant = [pre[0]]
                self.stats["starvation_grants"] += 1
            if grant or not pre:
                self._last_chunk_step[g] = self.step_count
            dec += dec_g
            grants.append(grant)
        return dec, grants

    def _fill_chunk(self, grant: list, ctoks, ctable, cstart, ctrue, cbud,
                    clast) -> None:
        """One group's chunk-lane host inputs, lane i carrying ``grant[i]``'s
        next chunk (rows of idle lanes stay zero)."""
        C, nc = self.chunk_size, self.chunk_size // self.page_size
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

    def _mixed_step(self) -> bool:
        """One synchronous mixed step (``async_depth=0``, the differential
        oracle): the scheduled decode tokens plus the granted prefill
        chunks of every slot group; the host blocks on the sampled ids, one
        fetch per active lane kind (ref ``:1422-1575``)."""
        dec_all, pre_all = self._work()
        if not dec_all and not pre_all:
            self._last_chunk_step = [self.step_count] * self.groups
            return False
        # Injection point: ahead of the grant bookkeeping and of every pool
        # write of the step (``_unified`` updates the pools in place), so a
        # retried step never applies a summary increment twice.
        if self.chaos:
            self.chaos.maybe_fail_step(self.step_count)
        dec, grants = self._schedule(dec_all, pre_all, time.perf_counter())

        G, Sg, C = self.groups, self.slots_per_group, self.chunk_size
        T, P = self.total_slots, self.ecfg.max_pages_per_slot
        L = self.chunk_lanes
        dev = self.device
        tokens = np.zeros((T, 1), np.int32)
        dec_table = np.zeros((T, P), np.int32)
        dec_lens = np.zeros((T,), np.int32)
        for s in dec:
            tokens[s, 0] = self.slots[s].tokens[-1]
            dec_table[s] = self.page_table[s]
            dec_lens[s] = self.cache_lens[s]
            self.slots[s].last_sched_step = self.step_count

        any_grant = any(grants)
        host = None
        if any_grant:
            nc = C // self.page_size
            host = dict(tokens=np.zeros((G, L, C), np.int32),
                        page_table=np.zeros((G, L, P), np.int32),
                        start=np.zeros((G, L), np.int32),
                        true_len=np.zeros((G, L), np.int32),
                        budgets=np.zeros((G, L, nc), np.int32),
                        last=np.zeros((G, L), np.int32))
            for g, grant in enumerate(grants):
                self._fill_chunk(grant, host["tokens"][g], host["page_table"][g],
                                 host["start"][g], host["true_len"][g],
                                 host["budgets"][g], host["last"][g])

        t0 = time.perf_counter()
        if self.smesh is None:
            chunk = (None if host is None else
                     {k: torch.as_tensor(v[0], device=dev) for k, v in host.items()})
            dec_logits, chunk_logits, self.pools = self._unified(
                self.params, self.pools, torch.as_tensor(tokens, device=dev),
                torch.as_tensor(dec_table, device=dev),
                torch.as_tensor(dec_lens, device=dev), chunk)
            dec_logits = [dec_logits]
            chunk_logits = None if chunk_logits is None else [chunk_logits]
        else:
            # The batch arguments with the reference's leading (dp, ...)
            # axis; the step moves each group's slice to its lead device.
            chunk = (None if host is None else
                     {k: torch.from_numpy(v) for k, v in host.items()})
            dec_logits, chunk_logits, self.pools = self._unified(
                self._replicas, self.pools,
                torch.from_numpy(tokens.reshape(G, Sg, 1)),
                torch.from_numpy(dec_table.reshape(G, Sg, P)),
                torch.from_numpy(dec_lens.reshape(G, Sg)), chunk)
        t1 = time.perf_counter()
        self.stats["dispatch_s"] += t1 - t0
        dec_ids = chunk_ids = None
        if dec:
            dec_ids = self._fetch_ids(
                [(g * Sg, self.sampler(x)) for g, x in enumerate(dec_logits)], T)
            self.stats["host_syncs"] += 1
        if any_grant:
            chunk_ids = self._fetch_ids(
                [(g * L, self.sampler(x)) for g, x in enumerate(chunk_logits)],
                G * L).reshape(G, L)
            self.stats["host_syncs"] += 1
        now = time.perf_counter()
        self.stats["sync_wait_s"] += now - t1
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

        for g, grant in enumerate(grants):
            for lane, s in enumerate(grant):
                st = self.slots[s]
                st.prefill_pos += C
                self.stats["chunks"] += 1
                if st.prefill_pos >= len(st.padded):
                    # The chunk that completes the prompt: its logits at the
                    # true last token give the request's first generated
                    # token.
                    st.tokens = [int(chunk_ids[g, lane])]
                    st.phase = "decode"
                    self.cache_lens[s] = st.true_len
                    self._register_prefix(s, st)
                    st.first_token_t = st.last_token_t = now
                    st.ttft_s = now - st.arrival_t
                    self.stats["prefills"] += 1
                    self.stats["tokens_generated"] += 1
                    if self._is_finished(st):
                        self._recycle(s)
        return True

    # -- async pipeline -----------------------------------------------------

    def _unpack(self, buf, n: int) -> dict:
        """Named views of a group block's first ``n`` entries (numpy on the
        host, a tensor on the device): (rows,) or (rows, width)."""
        return {name: buf[o:o + r * w].reshape((r,) if w == 1 else (r, w))
                for name, o, r, w in self._layout if o < n}

    def _dispatch(self, dec: list, grants: list) -> None:
        """Launch one sampled step and return without waiting for it.  The
        inputs are packed into a pinned staging buffer, one block a slot
        group, and each block goes up with one ``non_blocking`` copy to its
        group's lead device; the ids come back the same way behind events,
        so nothing here waits on the device.  Every value-independent state
        change happens now, so the next ``_schedule`` sees it:
        ``cache_lens`` (+1 per granted decode), ``prefill_pos`` and phase
        flips, prefix registration (the completing chunk's page writes run
        before any later-dispatched reader, in stream order) and the
        counters.  Token values, EOS and timestamps wait for
        ``_reconcile``."""
        G, Sg, C = self.groups, self.slots_per_group, self.chunk_size
        T, L = self.total_slots, self.chunk_lanes
        ring = self._ring
        k = ring.acquire()
        any_grant = any(grants)
        n = ring.n_in if any_grant else self._dec_n
        views = []
        for g in range(G):
            h = ring.block(k, g, n).numpy()
            h[:] = 0
            views.append(self._unpack(h, n))
        dec_entries = []
        for s in dec:
            st = self.slots[s]
            g, local = divmod(s, Sg)
            views[g]["mask"][local] = 1
            views[g]["table"][local] = self.page_table[s]
            views[g]["lens"][local] = self.cache_lens[s]
            st.last_sched_step = self.step_count
            dec_entries.append((s, st))
        chunk_entries = []
        for g, grant in enumerate(grants):
            if not grant:
                continue
            v = views[g]
            self._fill_chunk(grant, v["tokens"], v["page_table"], v["start"],
                             v["true_len"], v["budgets"], v["last"])
            for lane, s in enumerate(grant):
                st = self.slots[s]
                completes = st.prefill_pos + C >= len(st.padded)
                # A completing chunk's sampled id is the request's first
                # token: "emit" steers it into the slot's token_buf entry.
                v["slot"][lane] = s - g * Sg
                v["emit"][lane] = completes
                chunk_entries.append((g, lane, s, st, completes))

        t0 = time.perf_counter()
        d = [self._unpack(blk, n) for blk in ring.upload(k, n)]
        chunks = None
        if any_grant:
            chunks = [{name: dg[name] for name in ("tokens", "page_table",
                                                   "budgets", "start",
                                                   "true_len", "last", "slot")}
                      for dg in d]
            for c, dg in zip(chunks, d):
                c["emit"] = dg["emit"] != 0
        if self.smesh is None:
            dec_ids, chunk_ids, self.token_buf, self.pools = self._unified(
                self.params, self.pools, self.token_buf, d[0]["mask"] != 0,
                d[0]["table"], d[0]["lens"], None if chunks is None else chunks[0])
            dec_ids = [dec_ids]
            chunk_ids = None if chunk_ids is None else [chunk_ids]
        else:
            chunk = (None if chunks is None else
                     {name: [c[name] for c in chunks] for name in chunks[0]})
            dec_ids, chunk_ids, self.token_buf, self.pools = self._unified(
                self._replicas, self.pools, self.token_buf,
                [dg["mask"] != 0 for dg in d], [dg["table"] for dg in d],
                [dg["lens"] for dg in d], chunk)
        events = ring.fetch(k, [(g * Sg, ids) for g, ids in enumerate(dec_ids)]
                            + [(T + g * L, ids)
                               for g, ids in enumerate(chunk_ids or ())])
        t1 = time.perf_counter()
        self.stats["dispatch_s"] += t1 - t0
        self.stats["step_calls"] += 1
        if dec:
            self.stats["decode_steps"] += 1

        for s in dec:
            self.cache_lens[s] += 1   # the fed-back token will be cached
            self.slots[s].inflight += 1
        for g, lane, s, st, completes in chunk_entries:
            st.prefill_pos += C
            self.stats["chunks"] += 1
            if completes:
                st.phase = "decode"
                self.cache_lens[s] = st.true_len
                st.inflight += 1      # the first token is in flight
                self._register_prefix(s, st)
                self.stats["prefills"] += 1
        self._inflight.append(_InFlight(
            buf=k, events=events, dec=dec_entries, chunks=chunk_entries,
            step=self.step_count, dispatch_t=t1))

    def _reconcile(self, infl: _InFlight) -> None:
        """Absorb one in-flight step's sampled ids: append decode tokens,
        the completing chunks' first tokens, timestamps, EOS /
        max-new-tokens finishes and recycling.  Entries of a request that
        finished meanwhile (the EOS lookahead, or an abort) are discarded:
        that step wrote only into the request's own still-reserved pages.
        ``host_syncs`` counts only the waits with no newer step queued
        behind (the ones that can leave the device idle)."""
        overlapped = bool(self._inflight)
        t0 = time.perf_counter()
        for ev in infl.events:
            ev.synchronize()
        ids = self._ring.out[infl.buf].numpy()
        self.stats["id_fetches"] += bool(infl.dec) + bool(infl.chunks)
        now = time.perf_counter()
        self.stats["sync_wait_s"] += now - t0
        if not overlapped and (infl.dec or infl.chunks):
            self.stats["host_syncs"] += 1
        self.monitor.observe(infl.step, now - infl.dispatch_t)
        self.stats["straggler_steps"] = len(self.monitor.flagged)

        T, L = self.total_slots, self.chunk_lanes
        for s, st in infl.dec:
            st.inflight -= 1
            if st.finished:
                self.stats["lookahead_discards"] += 1
                continue
            st.tokens.append(int(ids[s]))
            st.token_latencies_s.append(now - st.last_token_t)
            st.last_token_t = now
            self.stats["tokens_generated"] += 1
            if self._is_finished(st):
                self._recycle(s)
        for g, lane, s, st, completes in infl.chunks:
            if not completes:
                continue
            st.inflight -= 1
            if st.finished:
                self.stats["lookahead_discards"] += 1
                continue
            st.tokens = [int(ids[T + g * L + lane])]
            st.first_token_t = st.last_token_t = now
            st.ttft_s = now - st.arrival_t
            self.stats["tokens_generated"] += 1
            if self._is_finished(st):
                self._recycle(s)

    def _drain(self) -> None:
        """Reconcile every in-flight step, oldest first.  Whatever changes
        pools or host token state out of band (preemption, restore, an
        abort, the end of ``run``) drains first: the device runs in stream
        order, but the host's tokens run one step behind it."""
        while self._inflight:
            self._reconcile(self._inflight.popleft())

    def drain(self) -> None:
        """Block until every dispatched step is reconciled (a no-op for the
        synchronous engine).  Callers stepping the engine by hand call it
        before reading ``finished`` / ``stats`` as final."""
        self._drain()

    def _async_step(self) -> bool:
        """One async iteration: schedule from the host state (one step
        stale in values, exact in structure), dispatch without waiting,
        then reconcile what exceeds ``async_depth`` — the host prepares and
        launches step N+1 while the device runs step N."""
        dec_all, pre_all = self._work()
        if not dec_all and not pre_all:
            self._last_chunk_step = [self.step_count] * self.groups
            self._drain()
            return False
        # The sync loop's injection point: before this step's dispatch, so
        # a retry never applies anything twice, and the in-flight step is
        # untouched by the failure.
        if self.chaos:
            self.chaos.maybe_fail_step(self.step_count)
        dec, grants = self._schedule(dec_all, pre_all, time.perf_counter())
        if not dec and not any(grants):
            # Every grantable token is already in flight: reconcile to make
            # progress instead of dispatching an empty step.
            self._drain()
            return False
        self._dispatch(dec, grants)
        while len(self._inflight) > self.ecfg.async_depth:
            self._reconcile(self._inflight.popleft())
        return True

    def _guarded_step(self) -> None:
        """The failure boundary around the mixed step: bounded retry of a
        failed step (the injection precedes every pool write, so a retry
        is sound), then graceful degradation — abort the lowest-priority
        active request and retry with the smaller batch.  Sync: working
        steps are timed by the StragglerMonitor (failed or idle ones are
        not); async: each reconcile feeds it the dispatch -> ids time."""
        retries = 0
        while True:
            if not self._async:
                self.monitor.start()
            try:
                did_work = (self._async_step() if self._async
                            else self._mixed_step())
            except InjectedFailure as e:
                if not self._async:
                    self.monitor.cancel()
                self.stats["step_failures"] += 1
                retries += 1
                if retries > self.ecfg.max_step_retries:
                    if self._async:
                        # The in-flight steps may finish the victim, and the
                        # abort frees pages they still reference.
                        self._drain()
                    victim = self._lowest_priority_active()
                    if victim is None:
                        if self._async:
                            continue       # the drain emptied the slots
                        raise
                    self._abort(victim,
                                f"aborted: step failed {retries} times ({e})")
                    retries = 0
                continue
            if self._async:
                return
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
        self._drain()
        return sorted(self.finished, key=lambda f: f.uid)
