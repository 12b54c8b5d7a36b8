"""Block-paged Stem KV cache: page pool, per-page summaries, paged decode
(port of ``repro/runtime/paged.py``).

Layout (one attention layer):

  k, v : (hk, num_pages, page_size, d)    raw cache tokens
  kg   : (hk, num_pages, stride, d)       anti-diag group means (fp32)
  vm   : (hk, num_pages)                  max-pooled log ||V||  (fp32)

Page 0 is the trash page: inactive slots carry an all-zero page table, so
their masked writes land there.  The allocator never hands it out.

Unlike the reference's functional ``.at[]`` updates, every write here
updates the pool tensors IN PLACE (a pool is gigabytes at full width; a
copy per step would double its footprint).  Functions still return the pool
so call sites read like the reference.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import chunked as chunked_lib
from repro_torch.core import decode as decode_lib
from repro_torch.core import metric as metric_lib
from repro_torch.core import policy as policy_lib

TRASH_PAGE = 0


class PagePool(NamedTuple):
    """One attention layer's paged KV + Stem summary storage.  The engine
    keeps each leaf stacked over layers, ``(n_layers, hk, P, ...)``."""

    k: torch.Tensor    # (hk, P, page, d)
    v: torch.Tensor    # (hk, P, page, d)
    kg: torch.Tensor   # (hk, P, stride, d) fp32 anti-diag group means
    vm: torch.Tensor   # (hk, P) fp32 max-pooled log ||V||


def init_pool(num_pages: int, num_kv_heads: int, page_size: int, head_dim: int,
              stride: int, dtype=torch.float32, device="cuda",
              layers: Optional[int] = None) -> PagePool:
    """A pristine pool; ``layers`` adds the leading stacked-layer axis."""
    lead = () if layers is None else (layers,)
    hk, p = num_kv_heads, num_pages
    dev = torch.device(device)
    return PagePool(
        k=torch.zeros(lead + (hk, p, page_size, head_dim), dtype=dtype, device=dev),
        v=torch.zeros(lead + (hk, p, page_size, head_dim), dtype=dtype, device=dev),
        kg=torch.zeros(lead + (hk, p, stride, head_dim), dtype=torch.float32,
                       device=dev),
        vm=torch.full(lead + (hk, p), decode_lib.V_MAG_FLOOR,
                      dtype=torch.float32, device=dev),
    )


def layer_view(pool: PagePool, layer: int) -> PagePool:
    """One layer's pool as views into the stacked leaves (writes through)."""
    return PagePool(*(t[layer] for t in pool))


def reset_pages(pool: PagePool, page_ids: torch.Tensor) -> PagePool:
    """Return pages to their pristine state (zero K/V and group means, vm at
    the norm floor), in place.  Must run on every page a request reserves
    before its first write: ``append_token``'s kg-add / vm-max increments
    assume a fresh page.  Duplicate ids (trash padding) are harmless."""
    ids = page_ids.long()
    pool.k[:, ids] = 0
    pool.v[:, ids] = 0
    pool.kg[:, ids] = 0
    pool.vm[:, ids] = decode_lib.V_MAG_FLOOR
    return pool


def reset_pools_stacked(pools, page_ids: torch.Tensor):
    """``reset_pages`` over the engine's per-layer pool tree (leaves stacked
    ``(n_layers, hk, P, ...)``), in place."""
    ids = page_ids.long()
    for seg in pools:
        for pool in seg.values():
            pool.k[:, :, ids] = 0
            pool.v[:, :, ids] = 0
            pool.kg[:, :, ids] = 0
            pool.vm[:, :, ids] = decode_lib.V_MAG_FLOOR
    return pools


def write_prefill_pages(pool: PagePool, page_ids: torch.Tensor,
                        k: torch.Tensor, v: torch.Tensor, true_len,
                        cfg) -> PagePool:
    """Scatter one prefilled sequence's K/V + summaries into the pool, in
    place.  k, v: (hk, L, d) with L = len(page_ids) * page_size.  Positions
    >= true_len are zeroed before the write, so pages and summaries match
    the zero-padded semantics ``append_token`` extends.  The kg / vm
    summaries come from the metric kernels (the kg group means rounded to
    k's dtype first, as the reference's pooling keeps it)."""
    cfg = policy_lib.as_policy(cfg)
    hk, L, d = k.shape
    bs = cfg.block_size
    npages = L // bs
    keep = (torch.arange(L, device=k.device) < true_len)[None, :, None]
    k = torch.where(keep, k, torch.zeros((), dtype=k.dtype, device=k.device))
    v = torch.where(keep, v, torch.zeros((), dtype=v.dtype, device=v.device))
    kg = metric_lib.antidiag_pool(k, bs, cfg.stride)         # (hk, npages, s, d)
    vm = metric_lib.value_block_magnitude(v, bs)             # (hk, npages)
    ids = page_ids.long()
    pool.k[:, ids] = k.reshape(hk, npages, bs, d).to(pool.k.dtype)
    pool.v[:, ids] = v.reshape(hk, npages, bs, d).to(pool.v.dtype)
    pool.kg[:, ids] = kg.float()
    pool.vm[:, ids] = vm.float()
    return pool


def write_chunk_pages(pool: PagePool, page_table: torch.Tensor,
                      chunk_start: torch.Tensor, k_chunk: torch.Tensor,
                      v_chunk: torch.Tensor, true_len: torch.Tensor,
                      cfg) -> PagePool:
    """Scatter one prefill chunk per slot into the pool, summaries included.

    Chunk starts are block-aligned and the chunk width is a page multiple,
    so every page a chunk touches is written whole: k/v zeroed at positions
    >= ``true_len``, kg/vm pooled from the zeroed chunk by the metric
    kernels (kg rounded to k's dtype, as the reference's mean keeps it).
    page_table: (slots, max_pages); chunk_start, true_len: (slots,); k_chunk, v_chunk:
    (slots, hk, C, d).  Chunk-grid blocks past the page-table width go to
    the trash page."""
    cfg = policy_lib.as_policy(cfg)
    slots, hk, c, d = k_chunk.shape
    bs = cfg.block_size
    nc = c // bs
    dev = k_chunk.device
    pos = chunk_start[:, None] + torch.arange(c, device=dev)
    keep = (pos < true_len[:, None])[:, None, :, None]
    k = torch.where(keep, k_chunk, torch.zeros((), dtype=k_chunk.dtype, device=dev))
    v = torch.where(keep, v_chunk, torch.zeros((), dtype=v_chunk.dtype, device=dev))
    kg = metric_lib.antidiag_pool(k, bs, cfg.stride)      # (slots, hk, nc, s, d)
    vm = metric_lib.value_block_magnitude(v, bs)          # (slots, hk, nc)
    kp = k.reshape(slots, hk, nc, bs, d)
    vp = v.reshape(slots, hk, nc, bs, d)

    maxp = page_table.shape[1]
    j_abs = (torch.div(chunk_start, bs, rounding_mode="floor")[:, None]
             + torch.arange(nc, device=dev)[None, :])      # (slots, nc)
    pids = torch.where(
        j_abs < maxp,
        torch.take_along_dim(page_table.long(),
                             torch.clamp(j_abs, max=maxp - 1).long(), dim=1),
        TRASH_PAGE)
    flat = pids.reshape(-1)

    def per_head(x):
        # (slots, hk, nc, ...) -> (hk, slots*nc, ...) aligned with ``flat``.
        return x.transpose(0, 1).reshape((hk, slots * nc) + tuple(x.shape[3:]))

    pool.k[:, flat] = per_head(kp).to(pool.k.dtype)
    pool.v[:, flat] = per_head(vp).to(pool.v.dtype)
    pool.kg[:, flat] = per_head(kg).float()
    pool.vm[:, flat] = per_head(vm).float()
    return pool


def append_token(pool: PagePool, page_table: torch.Tensor,
                 cache_lens: torch.Tensor, k_new: torch.Tensor,
                 v_new: torch.Tensor, cfg) -> PagePool:
    """Write one new token per slot into its current page + fold summaries.

    Group means divide by the full group population, so adding
    ``k_new / per_group`` reproduces the batch pooling once the page fills.
    page_table: (slots, max_pages); cache_lens: (slots,) tokens already
    present; k_new, v_new: (slots, hk, 1, d).  Idle slots point at the trash
    page, whose duplicate ids accumulate (kg, ``index_put_(accumulate=True)``)
    and max-reduce (vm, ``scatter_reduce_("amax")``) as the reference's
    ``.at[].add`` / ``.at[].max`` do."""
    cfg = policy_lib.as_policy(cfg)
    bs, stride = cfg.block_size, cfg.stride
    per_group = bs // stride
    lens = cache_lens.long()
    pids = torch.take_along_dim(page_table.long(),
                                torch.div(lens, bs, rounding_mode="floor")[:, None],
                                dim=1)[:, 0]
    offs = lens % bs
    knh = k_new[:, :, 0].transpose(0, 1)                   # (hk, slots, d)
    vnh = v_new[:, :, 0].transpose(0, 1)
    hk, slots = knh.shape[0], knh.shape[1]
    log_norm = torch.log(torch.clamp(
        torch.linalg.vector_norm(vnh.float(), dim=-1), min=1e-20))
    heads = torch.arange(hk, device=knh.device)[:, None].expand(hk, slots)
    pid2 = pids[None, :].expand(hk, slots)
    pool.k[heads, pid2, offs[None, :].expand(hk, slots)] = knh.to(pool.k.dtype)
    pool.v[heads, pid2, offs[None, :].expand(hk, slots)] = vnh.to(pool.v.dtype)
    pool.kg.index_put_((heads, pid2, (offs % stride)[None, :].expand(hk, slots)),
                       (knh / per_group).float(), accumulate=True)
    pool.vm.scatter_reduce_(1, pid2, log_norm, reduce="amax", include_self=True)
    return pool


def paged_sparse_decode(q, pool: PagePool, page_table, cache_lens, cfg,
                        budget_frac: float = decode_lib.DEFAULT_BUDGET_FRAC
                        ) -> torch.Tensor:
    """Policy-sparse decode attention straight off the page pool, through
    the paged backend ``policy.executor`` ("fused" | "gather").
    q: (slots, hq, 1, d) -> (slots, hq, 1, dv)."""
    cfg = policy_lib.as_policy(cfg)
    spec = policy_lib.get_paged_executor(cfg.executor)
    return spec.decode_fn(q, pool, page_table, cache_lens, cfg, budget_frac)


def _paged_decode_gather(q, pool: PagePool, page_table, cache_lens, cfg,
                         budget_frac: float) -> torch.Tensor:
    """The gather backend and the fused kernels' differential oracle:
    summaries gathered per slot through the page table, the policy's metric
    + budget rule select logical page slots, and only the selected pages are
    fetched from the pool."""
    cfg = policy_lib.as_policy(cfg)
    b, hq, _, d = q.shape
    hk = pool.k.shape[0]
    group = hq // hk
    bs = cfg.block_size
    maxp = page_table.shape[1]
    pt = page_table.long()

    kg_rows = pool.kg[:, pt].transpose(0, 1)              # (b, hk, maxp, s, d)
    vm_rows = pool.vm[:, pt].transpose(0, 1)              # (b, hk, maxp)
    m = decode_lib.decode_block_metric(q, kg_rows, vm_rows, cfg)
    sel = decode_lib.select_decode_blocks(m, cache_lens, cfg, budget_frac)

    gp = torch.take_along_dim(pt[:, None, None, :].expand(b, hk, group, maxp),
                              sel.indices.long(), dim=-1)  # (b, hk, g, kmax)
    heads = torch.arange(hk, device=q.device)[None, :, None, None]
    gk = pool.k[heads, gp]                                 # (b,hk,g,kmax,bs,d)
    gv = pool.v[heads, gp]
    return decode_lib.attend_selected(q, gk, gv, sel, cache_lens, bs)


policy_lib.register_paged_executor(
    "gather", decode_fn=_paged_decode_gather,
    chunk_fn=chunked_lib._chunked_prefill_gather)


class PageAllocator:
    """Free-list page allocator; page 0 (the trash page) is never handed
    out.  Every page id 1..num_pages-1 is either on the free list or in the
    allocated set.  ``evict`` / ``restore`` are the preemption path's free
    and alloc, counted.  (The reference's prefix index, cached set and
    copy-on-write are not part of this port yet.)"""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, 0, -1))  # pop() -> lowest id
        self._allocated: set = set()
        self.total_alloced = 0
        self.evictions = 0
        self.restores = 0

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[list]:
        """Return n page ids, or None (all-or-nothing)."""
        if n > self.available:
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._allocated.update(pages)
        self.total_alloced += n
        return pages

    def free(self, pages) -> None:
        for p in pages:
            if not (0 < p < self.num_pages):
                raise ValueError(f"bad page id {p}")
            if p not in self._allocated:
                raise ValueError(f"double free of page {p}")
            self._allocated.discard(p)
            self._free.append(p)

    def evict(self, pages) -> None:
        """Free a preemption victim's pages (contents live on in the host
        snapshot; the device pages are immediately reusable)."""
        self.free(pages)
        self.evictions += 1

    def restore(self, n: int) -> Optional[list]:
        """Allocate pages for a re-admitted (offloaded) request.  The ids
        need not match the evicted ones — the page table re-maps."""
        pages = self.alloc(n)
        if pages is not None:
            self.restores += 1
        return pages

    def check_conservation(self, held=None) -> bool:
        """Assert the free list and the allocated set partition pages
        1..num_pages-1; with ``held`` (the page ids the caller believes it
        holds) they must equal the allocated set exactly."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("duplicate page ids in the free list")
        if free & self._allocated:
            raise AssertionError(
                f"pages both free and allocated: {sorted(free & self._allocated)}")
        universe = set(range(1, self.num_pages))
        if free | self._allocated != universe:
            lost = sorted(universe - free - self._allocated)
            raise AssertionError(f"orphaned pages: {lost}")
        if held is not None:
            held = list(held)
            if len(held) != len(set(held)) or set(held) != self._allocated:
                raise AssertionError(
                    f"allocator/holder mismatch: held {sorted(held)} vs "
                    f"allocated {sorted(self._allocated)}")
        return True
