"""Host page offload: swap a request's pages to host memory and back (port
of ``gather_pages``, ``scatter_pages``, ``snapshot_nbytes`` and
``HostPageStore`` from ``repro/runtime/offload.py``).

Preemption support for the serving engine (``runtime/engine.py``).  A
preempted request's device pages — raw K/V *and* the per-page Stem
selection summaries (``kg`` / ``vm``) — are gathered into a snapshot and
copied to host memory, and the device pages go back to the
``PageAllocator`` (``allocator.evict``).  Re-admission allocates fresh
pages (``allocator.restore``) and scatters the snapshot back
bit-identically; because a page carries its own summaries, the restored
request resumes decode (or mid-prefill chunking) with zero recompute.

Unlike the reference, which gathers a fixed-width page row padded with the
trash page (so that XLA traces once), the port moves only the request's
real pages: eager PyTorch has no trace to save, a padded row would move up
to a whole slot's worth of pages however small the request, and
``index_copy_`` with repeated (trash) indices is nondeterministic on CUDA.
"""
from __future__ import annotations

import torch

from repro_torch.runtime import paged as paged_lib


def _map(fn, *trees):
    """``fn`` over the PagePools of the engine's pool tree
    (``[{"sub0": PagePool, ...}, ...]``) and trees of the same shape."""
    return [{name: fn(*(t[i][name] for t in trees)) for name in trees[0][i]}
            for i in range(len(trees[0]))]


def leaves(tree) -> list:
    """Every tensor of a pool tree or snapshot, in the reference's
    ``jax.tree.leaves`` order (segments, sorted sub-layer names, then
    k, v, kg, vm)."""
    return [leaf for seg in tree for name in sorted(seg) for leaf in seg[name]]


def gather_pages(pools, page_ids: torch.Tensor):
    """Extract the pages named by ``page_ids`` from every layer's pool.

    pools: the engine pool tree, PagePool leaves stacked (n, hk, P, ...).
    page_ids: (npages,) the request's pages, in page-table order.
    Returns the same tree with the page axis narrowed to ``npages`` — a
    device-side copy (``HostPageStore.put`` moves it to the host)."""
    ids = page_ids.long()
    return _map(lambda pool: paged_lib.PagePool(
        *(leaf.index_select(2, ids) for leaf in pool)), pools)


def scatter_pages(pools, page_ids: torch.Tensor, snapshot):
    """Write a snapshot back into the pages named by ``page_ids``, in place.

    Exact inverse of ``gather_pages`` modulo page renaming: the snapshot's
    i-th page lands in ``page_ids[i]``, which need not be the page it was
    gathered from — the engine's page-table row carries the new mapping.
    ``page_ids`` must not repeat."""
    ids = page_ids.long()

    def one(pool, snap):
        for leaf, src in zip(pool, snap):
            leaf.index_copy_(2, ids, src.to(leaf.device, non_blocking=True))
        return pool
    _map(one, pools, snapshot)
    return pools


def snapshot_nbytes(snapshot) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(snapshot))


def _to_host(snapshot):
    """The snapshot in host memory.  A CUDA leaf is copied into a pinned
    buffer without blocking, then the stream is synchronized once, so the
    returned snapshot is complete.  (The gather ran on the same stream, so
    any later reset of the victim's freed pages is ordered after it.)  A
    CPU leaf is already a fresh copy (``index_select``)."""
    dev = None

    def leaf_to_host(t):
        nonlocal dev
        if not t.is_cuda:
            return t
        dev = t.device
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        return h
    host = _map(lambda pool: paged_lib.PagePool(*map(leaf_to_host, pool)),
                snapshot)
    if dev is not None:
        torch.cuda.current_stream(dev).synchronize()
    return host


class HostPageStore:
    """Host-side store of offloaded page snapshots, keyed by request uid.

    ``put`` moves the device snapshot to the host, so the device pages can
    be reused at once; ``pop`` hands it back for ``scatter_pages``.
    Tracks resident and peak bytes for the engine's metrics."""

    def __init__(self):
        self._store: dict = {}
        self.nbytes = 0
        self.peak_nbytes = 0

    def __len__(self) -> int:
        return len(self._store)

    def put(self, uid, snapshot) -> None:
        if uid in self._store:
            raise ValueError(f"request {uid} already offloaded")
        host = _to_host(snapshot)
        self._store[uid] = host
        self.nbytes += snapshot_nbytes(host)
        self.peak_nbytes = max(self.peak_nbytes, self.nbytes)

    def get(self, uid):
        return self._store[uid]

    def pop(self, uid):
        snap = self._store.pop(uid)
        self.nbytes -= snapshot_nbytes(snap)
        return snap

    def drop(self, uid) -> None:
        """Discard a snapshot without restoring (aborted request)."""
        if uid in self._store:
            self.pop(uid)
