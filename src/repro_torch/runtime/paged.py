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

import hashlib
from collections import Counter, OrderedDict
from typing import NamedTuple, Optional

import numpy as np
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


def copy_pages_stacked(pools, src: int, dst: int):
    """Copy one page's contents (K/V + kg / vm summaries) ``src`` -> ``dst``
    across every layer's stacked pool, in place: the device half of
    copy-on-write (``PageAllocator.cow`` is the bookkeeping half)."""
    for seg in pools:
        for pool in seg.values():
            for leaf in pool:
                leaf[:, :, dst] = leaf[:, :, src]
    return pools


def _tree_device(tree) -> torch.device:
    return next(iter(tree[0].values())).k.device


def reset_pools_grouped(groups, rows):
    """``reset_pools_stacked`` over every slot group of a serving mesh
    (``groups``: one ``serving.HeadShards`` of pool trees a group; ref
    ``src/repro/runtime/engine.py:1239-1246``): ``rows[g]``, a ``(W,)``
    trash-padded page-id tensor, resets those pages on every tp shard of
    group ``g``.  A group with nothing to reset gets a row of trash page 0,
    as in the reference."""
    for shards, row in zip(groups, rows):
        for tree in shards:
            reset_pools_stacked(tree, row.to(_tree_device(tree)))
    return groups


def copy_pages_grouped(groups, src, dst):
    """``copy_pages_stacked`` over every slot group of a serving mesh (ref
    ``:1254-1264``): page ``src[g]`` -> ``dst[g]`` on every tp shard of group
    ``g`` (``(groups,)`` host ints).  A group with nothing to copy gets
    trash page 0 onto itself, a no-op, as in the reference."""
    for shards, s, d in zip(groups, src, dst):
        for tree in shards:
            copy_pages_stacked(tree, int(s), int(d))
    return groups


def prefix_page_keys(tokens, budgets, page_size: int) -> list:
    """Chained content keys (hex strings) for every full page of a prompt.

    Page j's K/V at layers past the first depend on the whole prefix up to
    page j, and chunked prefill's budget rows on the prompt's padded
    length, so key_j = blake2b(key_{j-1} || tokens of page j (int32 bytes)
    || budget row j).  Two tenants share page j iff every token and every
    budget row through page j agree.  The partial tail page gets no key."""
    full = len(tokens) // page_size
    keys = []
    h = b"stem-prefix-v1"
    for j in range(full):
        page = np.asarray(
            tokens[j * page_size:(j + 1) * page_size], np.int32).tobytes()
        row = int(budgets[j]).to_bytes(4, "little")
        h = hashlib.blake2b(h + page + row, digest_size=16).digest()
        keys.append(h.hex())
    return keys


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
    chunk_fn=chunked_lib._chunked_prefill_gather, sharding="kv-head")


class PageAllocator:
    """Ref-counted free-list page allocator with a hash-keyed prefix index.
    Page 0 (the trash page) is never handed out.

    Every page id is in exactly one of three places: the free list, the
    cached set (registered prefix pages at refcount 0, contents kept for
    future hits, reclaimable) or the allocated set (refcount >= 1);
    ``check_conservation`` asserts that partition and the refcounts.
    ``evict`` / ``restore`` are the preemption path's free and alloc,
    counted.

    Prefix caching (the engine drives it):

    * ``register(page, key)`` content-addresses a full prompt page by its
      chained key (``prefix_page_keys``) once its contents are final.
    * ``probe(key)`` answers admission's per-page lookup; ``share(page)``
      takes a reference on a hit (reviving a cached page).
    * ``free`` drops one reference: a page leaves the allocated set only at
      refcount 0, and a registered page then parks in the cached set.
    * ``cow(page)`` exchanges the caller's reference on a shared page for a
      fresh private page (the device copy is ``copy_pages_stacked``).

    ``evict_policy`` picks the cached page ``alloc`` reclaims when the free
    list runs dry: "lru" (least recently parked) or "hit-rate" (fewest
    prefix hits since registration, LRU among ties)."""

    EVICT_POLICIES = ("lru", "hit-rate")

    def __init__(self, num_pages: int, evict_policy: str = "lru"):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        if evict_policy not in self.EVICT_POLICIES:
            raise ValueError(f"evict_policy must be one of "
                             f"{self.EVICT_POLICIES}, got {evict_policy!r}")
        self.num_pages = num_pages
        self.evict_policy = evict_policy
        self._free = list(range(num_pages - 1, 0, -1))  # pop() -> lowest id
        self._allocated: set = set()
        self._ref: dict = {}            # page -> live reference count (>= 1)
        self._index: dict = {}          # prefix key -> page id
        self._key_of: dict = {}         # page id -> its prefix key
        self._cached: OrderedDict = OrderedDict()   # ref-0 registered, LRU
        self._hits: dict = {}           # registered page -> prefix-hit count
        self.evictions = 0
        self.restores = 0
        self.total_alloced = 0          # pages handed out, lifetime
        self.shares = 0                 # references taken via prefix hits
        self.cows = 0
        self.cache_reclaims = 0         # cached pages reclaimed by alloc

    @property
    def available(self) -> int:
        """Pages an ``alloc`` could obtain: free plus cached."""
        return len(self._free) + len(self._cached)

    @property
    def cached_pages(self) -> int:
        return len(self._cached)

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    def alloc(self, n: int) -> Optional[list]:
        """Return n page ids at refcount 1, or None (all-or-nothing): the
        free list first, then cached pages reclaimed per ``evict_policy``
        (unregistered: their contents are gone)."""
        if n > self.available:
            return None
        pages = []
        for _ in range(n):
            p = self._free.pop() if self._free else self._reclaim_cached()
            pages.append(p)
            self._ref[p] = 1
        self._allocated.update(pages)
        self.total_alloced += n
        return pages

    def _reclaim_cached(self) -> int:
        if self.evict_policy == "hit-rate":
            lru_rank = {q: i for i, q in enumerate(self._cached)}
            p = min(self._cached,
                    key=lambda q: (self._hits.get(q, 0), lru_rank[q]))
            del self._cached[p]
        else:
            p, _ = self._cached.popitem(last=False)
        self._unregister(p)
        self.cache_reclaims += 1
        return p

    def free(self, pages) -> None:
        """Drop one reference per listed page; at refcount 0 a registered
        page parks in the cached set, any other goes back to the free
        list."""
        for p in pages:
            if not (0 < p < self.num_pages):
                raise ValueError(f"bad page id {p}")
            if p not in self._allocated:
                raise ValueError(f"double free of page {p}")
            self._ref[p] -= 1
            if self._ref[p] > 0:
                continue
            del self._ref[p]
            self._allocated.discard(p)
            if p in self._key_of:
                self._cached[p] = None          # most recently used end
            else:
                self._free.append(p)

    def probe(self, key) -> Optional[int]:
        """The page holding the content addressed by ``key`` (live or
        cached), or None.  Probing does not pin: ``share`` every hit before
        any ``alloc`` that could reclaim a cached page."""
        return self._index.get(key)

    def share(self, page: int) -> int:
        """Take one reference on an indexed page (a prefix hit); a cached
        page is revived into the allocated set."""
        if page in self._cached:
            del self._cached[page]
            self._allocated.add(page)
            self._ref[page] = 1
        elif page in self._allocated:
            self._ref[page] += 1
        else:
            raise ValueError(f"page {page} is neither allocated nor cached")
        self.shares += 1
        self._hits[page] = self._hits.get(page, 0) + 1
        return page

    def register(self, page: int, key) -> None:
        """Content-address an allocated page under ``key``.  First writer
        wins: a key already indexed keeps its page (the newcomer, with
        identical contents, stays private)."""
        if page not in self._allocated:
            raise ValueError(f"cannot register unallocated page {page}")
        old = self._key_of.get(page)
        if old == key or key in self._index:
            return
        if old is not None:
            del self._index[old]
        self._index[key] = page
        self._key_of[page] = key

    def cow(self, page: int) -> Optional[int]:
        """Exchange the caller's reference on a shared page for a fresh
        private page (None, reference untouched, if none is available)."""
        fresh = self.alloc(1)
        if fresh is None:
            return None
        self.free([page])
        self.cows += 1
        return fresh[0]

    def _unregister(self, page: int) -> None:
        key = self._key_of.pop(page, None)
        if key is not None and self._index.get(key) == page:
            del self._index[key]
        self._hits.pop(page, None)

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
        """Assert the three-way partition (free list, cached set, allocated
        set, together pages 1..num_pages-1), refcounts >= 1 on allocated
        pages, a key on every cached page and a consistent prefix index.
        With ``held`` (a multiset: one entry per reference the caller
        believes it holds) the per-page counts must equal the refcounts."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("duplicate page ids in the free list")
        cached = set(self._cached)
        parts = [("free", free), ("cached", cached),
                 ("allocated", self._allocated)]
        for i, (na, a) in enumerate(parts):
            for nb, b in parts[i + 1:]:
                if a & b:
                    raise AssertionError(
                        f"pages both {na} and {nb}: {sorted(a & b)}")
        universe = set(range(1, self.num_pages))
        if free | cached | self._allocated != universe:
            lost = sorted(universe - free - cached - self._allocated)
            raise AssertionError(f"orphaned pages: {lost}")
        if set(self._ref) != self._allocated:
            raise AssertionError(
                f"refcount table out of sync with the allocated set: refs "
                f"{sorted(self._ref)} vs {sorted(self._allocated)}")
        bad = {p: r for p, r in self._ref.items() if r < 1}
        if bad:
            raise AssertionError(f"allocated pages with refcount < 1: {bad}")
        for p in cached:
            if p not in self._key_of:
                raise AssertionError(f"cached page {p} has no prefix key")
        for key, p in self._index.items():
            if self._key_of.get(p) != key:
                raise AssertionError(
                    f"prefix index out of sync: key {key!r} -> page {p}")
            if p in free:
                raise AssertionError(f"indexed page {p} is on the free list")
        if held is not None:
            counts = dict(Counter(held))
            if counts != self._ref:
                over = {p: c for p, c in counts.items()
                        if c != self._ref.get(p, 0)}
                under = {p: r for p, r in self._ref.items()
                         if r != counts.get(p, 0)}
                raise AssertionError(
                    f"allocator/holder refcount mismatch: held {over} vs "
                    f"allocated {under}")
        return True
