"""Host page offload: swap a request's pages to host memory and back (port
of ``gather_pages``, ``scatter_pages``, ``snapshot_nbytes``,
``HostShards``, ``shard_snapshot_to_host``, ``assemble_sharded_snapshot``
and ``HostPageStore`` from ``repro/runtime/offload.py``).

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

Under the serving mesh (``sharding/serving.py``) a preempted group's pages
are gathered from each of its tp shards and kept on the host per shard,
keyed by the ``(dp, tp)`` coordinate (``HostShards``); the restore puts
each shard's bytes back on the same coordinate's device, with no gather and
no reshard.  Only the preempted group's shards are moved: the reference's
fixed-width extract also gathers the other groups' trash page and drops it.
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


class HostShards:
    """One snapshot leaf of a mesh-sharded pool as per-shard host tensors
    keyed by mesh coordinate ``(dp, tp)`` (ref
    ``src/repro/runtime/offload.py:93-116``): under tp > 1 a leaf's KV-head
    axis is split across the group's shards, and each shard's bytes go
    back to the device of the same coordinate.  Only the preempted slot
    group's shards are held."""

    __slots__ = ("shards",)

    def __init__(self, shards: dict):
        self.shards = shards            # (dp, tp) coord -> host tensor

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.shards.values())


def _nbytes(leaf) -> int:
    if isinstance(leaf, HostShards):
        return leaf.nbytes
    return leaf.numel() * leaf.element_size()


def snapshot_nbytes(snapshot) -> int:
    return sum(_nbytes(t) for t in leaves(snapshot))


def _copy_to_host(snapshot, devices: set):
    """Start the copy of every CUDA leaf into a pinned buffer without
    blocking, adding its device to ``devices``; a CPU leaf is already a
    fresh copy (``index_select``) and a ``HostShards`` already host memory."""
    def leaf_to_host(t):
        if isinstance(t, HostShards) or not t.is_cuda:
            return t
        devices.add(t.device)
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        return h
    return _map(lambda pool: paged_lib.PagePool(*map(leaf_to_host, pool)),
                snapshot)


def _wait(devices: set) -> None:
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()


def _to_host(snapshot):
    """The snapshot in host memory: the copies start without blocking, then
    each device's stream is synchronized once, so the returned snapshot is
    complete.  (The gather ran on the same stream, so any later reset of
    the victim's freed pages is ordered after it.)"""
    devices: set = set()
    host = _copy_to_host(snapshot, devices)
    _wait(devices)
    return host


def shard_snapshot_to_host(snapshots: dict, group: int):
    """``{(g, t): device snapshot}`` of a preempted group's shards (each
    from ``gather_pages`` on that shard's pools) -> one snapshot tree whose
    leaves are ``HostShards`` holding group ``group``'s shards (ref
    ``:124-141``).  Every copy is started before the one wait per device."""
    devices: set = set()
    host = {c: _copy_to_host(snap, devices)
            for c, snap in sorted(snapshots.items()) if c[0] == group}
    _wait(devices)
    first = next(iter(host.values()))
    return [{name: paged_lib.PagePool(*(
                HostShards({c: tree[si][name][j] for c, tree in host.items()})
                for j in range(len(pool))))
             for name, pool in seg.items()} for si, seg in enumerate(first)]


def assemble_sharded_snapshot(host, smesh, group: int) -> dict:
    """Inverse of ``shard_snapshot_to_host`` (ref ``:144-166``): ``{(group,
    t): snapshot tree}`` with each shard's bytes on the device of its own
    coordinate, copied without blocking; ``scatter_pages`` writes each into
    that shard's pools."""
    coords = sorted(leaves(host)[0].shards)
    if any(c[0] != group for c in coords):
        raise ValueError(f"snapshot shards {coords} are not all of group {group}")
    return {c: _map(lambda pool, c=c: paged_lib.PagePool(*(
                leaf.shards[c].to(smesh.device(*c), non_blocking=True)
                for leaf in pool)), host)
            for c in coords}


class HostPageStore:
    """Host-side store of offloaded page snapshots, keyed by request uid.

    ``put`` moves the device snapshot to the host, so the device pages can
    be reused at once; ``pop`` hands it back for ``scatter_pages``.
    Tracks resident and peak bytes for the engine's metrics."""

    def __init__(self):
        self._store: dict = {}
        self._pinned: dict = {}      # uid -> device pages pinned, not copied
        self.nbytes = 0
        self.peak_nbytes = 0

    def __len__(self) -> int:
        return len(self._store)

    def put(self, uid, snapshot, pinned=()) -> None:
        """Store a request's private-page snapshot.  ``pinned`` lists the
        prefix-shared pages that stay on the device (the engine keeps one
        allocator reference on each): recorded, no bytes copied."""
        if uid in self._store:
            raise ValueError(f"request {uid} already offloaded")
        host = _to_host(snapshot)
        self._store[uid] = host
        self._pinned[uid] = list(pinned)
        self.nbytes += snapshot_nbytes(host)
        self.peak_nbytes = max(self.peak_nbytes, self.nbytes)

    def get(self, uid):
        return self._store[uid]

    def pinned(self, uid) -> list:
        """Device pages this offloaded request keeps pinned (shared prefix)."""
        return list(self._pinned.get(uid, ()))

    def pop(self, uid):
        snap = self._store.pop(uid)
        self._pinned.pop(uid, None)
        self.nbytes -= snapshot_nbytes(snap)
        return snap

    def drop(self, uid) -> None:
        """Discard a snapshot without restoring (aborted request)."""
        if uid in self._store:
            self.pop(uid)
