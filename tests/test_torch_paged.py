"""Differential tests: the port's page pool writes and allocator against the
JAX reference (``runtime/paged.py``) — ``write_chunk_pages``,
``append_token`` (including duplicate trash-page increments from idle
slots), ``reset_pages`` and ``PageAllocator``.  Pool leaves within 1e-4
(fp32); page ids and allocator state exact."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.config import StemConfig as JStem
from repro.runtime import paged as j_paged

from repro_torch.core.config import StemConfig as TStem
from repro_torch.runtime import paged as t_paged

torch.set_num_threads(1)

TOL = 1e-4
STEM = dict(block_size=8, sink_blocks=1, local_blocks=1, min_budget_blocks=2,
            stride=4)
JCFG, TCFG = JStem(**STEM), TStem(**STEM)
BS, D = 8, 8


def _to_port(jpool):
    return t_paged.PagePool(*(torch.from_numpy(np.array(x)) for x in jpool))


def _assert_pools(tpool, jpool, only=None):
    for name, got, want in zip(("k", "v", "kg", "vm"), tpool, jpool):
        got, want = got.numpy(), np.asarray(want)
        if only is not None:
            got, want = got[:, only], want[:, only]
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0, err_msg=name)


def _pool(num_pages, hk, seed=0, dirty=True):
    """A pool with random (dirty) contents so writes are really checked."""
    pool = j_paged.init_pool(num_pages, hk, BS, D, STEM["stride"])
    if not dirty:
        return pool
    rng = np.random.default_rng(seed)
    return j_paged.PagePool(*(jnp.asarray(rng.standard_normal(x.shape).astype(
        np.float32)) for x in pool))


@pytest.mark.parametrize("hk", [1, 2])
@pytest.mark.parametrize("nc", [1, 2, 3])
def test_write_chunk_pages_matches(hk, nc):
    rng = np.random.default_rng(hk * 10 + nc)
    slots, maxp = 3, 5
    c = nc * BS
    jpool = _pool(1 + slots * maxp, hk, seed=nc)
    table = (1 + np.arange(slots * maxp, dtype=np.int32)).reshape(slots, maxp)
    table[2] = 0                                  # an idle lane: trash page
    start = np.array([0, 3 * BS, 0], np.int32)    # lane 1 overruns the table
    true_len = np.array([c - 3, 3 * BS + 5, 0], np.int32)
    k = rng.standard_normal((slots, hk, c, D)).astype(np.float32)
    v = rng.standard_normal((slots, hk, c, D)).astype(np.float32)
    tpool = _to_port(jpool)
    want = j_paged.write_chunk_pages(jpool, jnp.asarray(table), jnp.asarray(start),
                                     jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(true_len), JCFG)
    got = t_paged.write_chunk_pages(tpool, torch.from_numpy(table),
                                    torch.from_numpy(start), torch.from_numpy(k),
                                    torch.from_numpy(v), torch.from_numpy(true_len),
                                    TCFG)
    _assert_pools(got, want, only=np.arange(1, 1 + slots * maxp))


@pytest.mark.parametrize("chunk_pages", [1, 2, 3])
@pytest.mark.parametrize("plen", [19, 24, 37])
def test_chunk_writes_equal_prefill_pages(chunk_pages, plen):
    """Building a prompt chunk by chunk in the port reproduces the
    reference's ``write_prefill_pages`` of the whole sequence."""
    hk = 2
    rng = np.random.default_rng(plen)
    npages = -(-plen // BS)
    c = chunk_pages * BS
    span = -(-npages // chunk_pages) * c
    k = rng.standard_normal((hk, span, D)).astype(np.float32)
    v = rng.standard_normal((hk, span, D)).astype(np.float32)
    ids = np.array([3, 1, 6, 2, 5][:npages], np.int32)
    table = np.zeros((1, 6), np.int32)
    table[0, :npages] = ids
    want = j_paged.write_prefill_pages(
        _pool(8, hk, dirty=False), jnp.asarray(ids),
        jnp.asarray(k[:, :npages * BS]), jnp.asarray(v[:, :npages * BS]),
        jnp.asarray(plen), JCFG)
    tpool = _to_port(_pool(8, hk, dirty=False))
    for s0 in range(0, npages * BS, c):
        t_paged.write_chunk_pages(
            tpool, torch.from_numpy(table), torch.tensor([s0], dtype=torch.int32),
            torch.from_numpy(k[None, :, s0:s0 + c].copy()),
            torch.from_numpy(v[None, :, s0:s0 + c].copy()),
            torch.tensor([plen], dtype=torch.int32), TCFG)
    _assert_pools(tpool, want, only=ids)


def test_append_token_matches_with_idle_slots():
    """Idle slots (all-zero page table rows) scribble the trash page with
    duplicate ids: kg accumulates and vm max-reduces like the reference's
    ``.at[].add`` / ``.at[].max``; live pages match exactly."""
    hk = 2
    rng = np.random.default_rng(4)
    jpool = _pool(9, hk, seed=3)
    tpool = _to_port(jpool)
    table = np.array([[2, 5, 0], [0, 0, 0], [7, 1, 3], [0, 0, 0]], np.int32)
    for step in range(3):
        lens = np.array([6 + step, 0, 15 + step, 0], np.int32)
        k = rng.standard_normal((4, hk, 1, D)).astype(np.float32)
        v = rng.standard_normal((4, hk, 1, D)).astype(np.float32)
        jpool = j_paged.append_token(jpool, jnp.asarray(table), jnp.asarray(lens),
                                     jnp.asarray(k), jnp.asarray(v), JCFG)
        t_paged.append_token(tpool, torch.from_numpy(table), torch.from_numpy(lens),
                             torch.from_numpy(k), torch.from_numpy(v), TCFG)
        _assert_pools(tpool, jpool)


def test_append_grows_to_prefill_pages():
    hk, plen, npages = 2, 11, 3
    rng = np.random.default_rng(9)
    L = npages * BS
    k = rng.standard_normal((hk, L, D)).astype(np.float32)
    v = rng.standard_normal((hk, L, D)).astype(np.float32)
    ids = np.array([4, 2, 5], np.int32)
    table = ids[None]
    tpool = _to_port(j_paged.write_prefill_pages(
        _pool(6, hk, dirty=False), jnp.asarray(ids), jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(plen), JCFG))
    for pos in range(plen, L):
        t_paged.append_token(tpool, torch.from_numpy(table),
                             torch.tensor([pos], dtype=torch.int32),
                             torch.from_numpy(k[None, :, pos:pos + 1].copy()),
                             torch.from_numpy(v[None, :, pos:pos + 1].copy()), TCFG)
    want = j_paged.write_prefill_pages(
        _pool(6, hk, dirty=False), jnp.asarray(ids), jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(L), JCFG)
    _assert_pools(tpool, want)


def test_reset_pages_matches():
    jpool = _pool(7, 2, seed=5)
    ids = np.array([3, 0, 0, 5], np.int32)
    want = j_paged.reset_pages(jpool, jnp.asarray(ids))
    got = t_paged.reset_pages(_to_port(jpool), torch.from_numpy(ids))
    _assert_pools(got, want)
    stacked = [{"sub0": t_paged.PagePool(*(t[None].repeat(
        (2,) + (1,) * t.ndim) for t in _to_port(jpool)))}]
    t_paged.reset_pools_stacked(stacked, torch.from_numpy(ids))
    for layer in range(2):
        _assert_pools(t_paged.layer_view(stacked[0]["sub0"], layer), want)


def test_allocator_matches_reference():
    """The same alloc/free sequence leaves both allocators in the same
    state: same ids handed out, same free-list order."""
    ja, ta = j_paged.PageAllocator(12), t_paged.PageAllocator(12)
    rng = np.random.default_rng(0)
    held = []
    for _ in range(40):
        if held and rng.random() < 0.45:
            i = int(rng.integers(len(held)))
            pages = held.pop(i)
            ja.free(pages)
            ta.free(pages)
        else:
            n = int(rng.integers(1, 5))
            got_j, got_t = ja.alloc(n), ta.alloc(n)
            assert got_t == got_j
            if got_t is not None:
                held.append(got_t)
        assert ta._free == ja._free
        assert ta._allocated == ja._allocated
        assert ta.available == ja.available
        ta.check_conservation([p for ps in held for p in ps])
    assert ta.alloc(100) is None and ta.available == ja.available
    with pytest.raises(ValueError, match="bad page"):
        ta.free([0])
    pages = ta.alloc(1)
    ta.free(pages)
    with pytest.raises(ValueError, match="double free"):
        ta.free(pages)


def _record_metric_kernels(monkeypatch):
    """Wrap the metric kernels' wrappers (CUDA kernels on the card, their
    plain versions here) so a test sees which pooling went through them."""
    from repro_torch.kernels import stem_metric as t_sm
    calls = []
    pool, vmag = t_sm.antidiag_pool, t_sm.value_magnitude

    def rec_pool(x, **kw):
        calls.append(("pool", x.dtype, kw["out_dtype"]))
        return pool(x, **kw)

    def rec_vmag(v, **kw):
        calls.append(("vmag", v.dtype, torch.float32))
        return vmag(v, **kw)

    monkeypatch.setattr(t_sm, "antidiag_pool", rec_pool)
    monkeypatch.setattr(t_sm, "value_magnitude", rec_vmag)
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("write", ["chunk", "prefill"])
def test_pool_writes_summarize_through_metric_kernels(monkeypatch, dtype, write):
    """Both pool writes take their kg / vm page summaries from the metric
    kernels, kg rounded to k's dtype (the reference's mean) before it is
    stored in fp32; the summaries equal the plain pooling of the zeroed
    pages."""
    calls = _record_metric_kernels(monkeypatch)
    hk, npages, plen = 2, 3, 19
    rng = np.random.default_rng(7)
    k = torch.from_numpy(rng.standard_normal((hk, npages * BS, D)).astype(np.float32)).to(dtype)
    v = torch.from_numpy(rng.standard_normal((hk, npages * BS, D)).astype(np.float32)).to(dtype)
    pool = t_paged.init_pool(1 + npages, hk, BS, D, STEM["stride"], dtype=dtype,
                             device="cpu")
    ids = torch.arange(1, 1 + npages, dtype=torch.int32)
    if write == "chunk":
        t_paged.write_chunk_pages(pool, ids[None], torch.zeros(1, dtype=torch.int32),
                                  k[None], v[None], torch.tensor([plen], dtype=torch.int32),
                                  TCFG)
    else:
        t_paged.write_prefill_pages(pool, ids, k, v, plen, TCFG)
    assert calls == [("pool", dtype, dtype), ("vmag", dtype, torch.float32)]
    kz = torch.where(torch.arange(npages * BS)[None, :, None] < plen, k, 0)
    want = kz.float().reshape(hk, npages, BS // STEM["stride"], STEM["stride"], D).mean(2)
    torch.testing.assert_close(pool.kg[:, 1:], want.to(dtype).float(), atol=0, rtol=0)
