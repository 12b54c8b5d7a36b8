"""The port's sequence mixers of the SSM, hybrid and encoder-decoder
families against the JAX reference: the SSD block (``models/ssd.py``), the
RG-LRU block and its linear scan (``models/rglru.py``), windowed (local)
attention over a ring cache and cross attention (``models/attention.py``),
and the helpers of ``models/common.py`` they use (the ring-cache write,
the layer norms, sinusoidal positions).

Weights come from the reference's ``init`` and inputs from a numpy seed;
both packages run in fp32.  Tolerance 1e-5 of the compared tensor's scale
(``max(1, max|reference|)``): the chunked scans sum in another order than
the reference's ``lax.scan`` / ``associative_scan``, so the two agree to
fp32 rounding, not bitwise.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JArch
from repro.configs.base import RGLRUConfig as JRG
from repro.configs.base import SSDConfig as JSSD
from repro.models import attention as j_attention
from repro.models import common as j_common
from repro.models import rglru as j_rglru
from repro.models import ssd as j_ssd

from repro_torch.configs.base import ArchConfig as TArch
from repro_torch.configs.base import RGLRUConfig as TRG
from repro_torch.configs.base import SSDConfig as TSSD
from repro_torch.models import attention as t_attention
from repro_torch.models import common as t_common
from repro_torch.models import rglru as t_rglru
from repro_torch.models import ssd as t_ssd

torch.set_num_threads(1)

TOL = 1e-5
T = torch.from_numpy


def _close(got, want, atol=TOL):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               atol=atol * scale, rtol=0)


def _carry(tree):
    """A JAX params dict (values) -> torch tensors, dtypes kept."""
    return {k: T(np.array(v)) for k, v in tree.items()}


def _randn(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------

def _ssd_cfgs(chunk):
    kw = dict(name="t", family="ssm", num_layers=1, d_model=16, num_heads=4,
              num_kv_heads=4, head_dim=8, d_ff=0, vocab_size=16, dtype="float32")
    sub = dict(state_dim=8, head_dim=8, expand=2, conv_width=4, chunk_size=chunk)
    return JArch(ssd=JSSD(**sub), **kw), TArch(ssd=TSSD(**sub), **kw)


def _ssd_params(jcfg, seed=0):
    ini = j_common.Initializer(jax.random.PRNGKey(seed), jnp.float32)
    jp = j_common.unzip(j_ssd.init(ini, jcfg))[0]
    return jp, _carry(jp)


@pytest.mark.parametrize("n,chunk", [(32, 8), (37, 8), (5, 8), (40, 16)],
                         ids=["whole-chunks", "uneven-padding", "one-short-chunk",
                              "chunk16"])
def test_chunked_ssd_scan_matches_jax(n, chunk):
    """``_chunked_ssd`` on the same raw inputs: outputs and the final state,
    including a length that is not a chunk multiple (the dt = 0 padding)."""
    b, h, p, N = 2, 3, 4, 5
    xh, B, C = _randn(1, b, n, h, p), _randn(2, b, n, N), _randn(3, b, n, N)
    dt = np.log1p(np.exp(_randn(4, b, n, h)))                 # softplus > 0
    ld = -dt * np.linspace(0.5, 4.0, h, dtype=np.float32)
    d_skip = np.linspace(0.5, 1.5, h).astype(np.float32)
    jy, js = j_ssd._chunked_ssd(*map(jnp.asarray, (xh, B, C, dt, ld)), chunk,
                                jnp.asarray(d_skip))
    ty, ts = t_ssd._chunked_ssd(*map(T, (xh, B, C, dt, ld)), chunk, T(d_skip))
    assert tuple(ty.shape) == (b, n, h, p)
    _close(ty, jy)
    _close(ts, js)


@pytest.mark.parametrize("n", [24, 29], ids=["whole-chunks", "uneven-padding"])
def test_ssd_block_matches_jax(n):
    """``apply_full``, ``prefill_into_state`` (state and raw conv tail) and
    three ``apply_decode`` steps, which write the state in place."""
    jcfg, tcfg = _ssd_cfgs(chunk=8)
    jp, tp = _ssd_params(jcfg)
    x = _randn(5, 2, n + 3, 16)
    _close(t_ssd.apply_full(tp, T(x[:, :n]), tcfg),
           j_ssd.apply_full(jp, jnp.asarray(x[:, :n]), jcfg))
    jo, js = j_ssd.prefill_into_state(jp, jnp.asarray(x[:, :n]), jcfg)
    to, ts = t_ssd.prefill_into_state(tp, T(x[:, :n]), tcfg)
    _close(to, jo)
    for got, want in zip(ts, js):
        _close(got, want)
    for t in range(n, n + 3):
        jo, js = j_ssd.apply_decode(jp, jnp.asarray(x[:, t:t + 1]), jcfg, js)
        h_ptr = ts.h.data_ptr()
        to, ts = t_ssd.apply_decode(tp, T(x[:, t:t + 1]), tcfg, ts)
        assert ts.h.data_ptr() == h_ptr
        _close(to, jo)
        for got, want in zip(ts, js):
            _close(got, want)


def test_ssd_params_keep_reference_dtypes():
    """Under a bf16 config ``a_log`` / ``dt_bias`` / ``d_skip`` stay fp32 in
    both packages; the port's own init draws the same values for them."""
    jcfg, tcfg = _ssd_cfgs(8)
    jcfg, tcfg = jcfg.replace(dtype="bfloat16"), tcfg.replace(dtype="bfloat16")
    ini = j_common.Initializer(jax.random.PRNGKey(0), jnp.bfloat16)
    jp = j_common.unzip(j_ssd.init(ini, jcfg))[0]
    tp = t_ssd.init(t_common.Initializer(torch.Generator().manual_seed(0),
                                         torch.bfloat16, "cpu"), tcfg)
    assert {k: str(v.dtype) for k, v in jp.items()} == \
        {k: str(v.dtype).replace("torch.", "") for k, v in tp.items()}
    for k in ("a_log", "dt_bias", "d_skip"):
        assert tp[k].dtype == torch.float32
        _close(tp[k], jp[k], atol=1e-7)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def _rg_cfgs(width=16):
    kw = dict(name="t", family="hybrid", num_layers=3, d_model=16, num_heads=2,
              num_kv_heads=1, head_dim=8, d_ff=32, vocab_size=16, dtype="float32")
    sub = dict(lru_width=width, conv_width=4, attn_period=3, window=8)
    return JArch(rglru=JRG(**sub), **kw), TArch(rglru=TRG(**sub), **kw)


@pytest.mark.parametrize("scale", [1e-3, 0.3, 20.0],
                         ids=["slow-decay", "medium-decay", "fast-decay"])
@pytest.mark.parametrize("n,chunk", [(64, 16), (50, 16), (7, 16), (200, 64)],
                         ids=["whole-chunks", "uneven", "one-short-chunk", "long"])
def test_linear_scan_matches_associative_scan(n, chunk, scale):
    """``rglru.linear_scan`` against the reference's ``associative_scan``
    over the same (a, b) pairs, from barely decaying to vanishing a."""
    log_a = -np.abs(_randn(6, 2, n, 8)) * scale
    b = _randn(7, 2, n, 8)

    def combine(lhs, rhs):
        return lhs[0] * rhs[0], rhs[0] * lhs[1] + rhs[1]

    _, want = jax.lax.associative_scan(
        combine, (jnp.exp(jnp.asarray(log_a)), jnp.asarray(b)), axis=1)
    _close(t_rglru.linear_scan(T(log_a), T(b), chunk=chunk), want)


def test_rglru_block_matches_jax():
    """``apply_full``, ``prefill_into_state`` and three ``apply_decode`` steps
    (in place) against the reference; ``_C`` and the gates' multiplier."""
    jcfg, tcfg = _rg_cfgs()
    ini = j_common.Initializer(jax.random.PRNGKey(6), jnp.float32)
    jp = j_common.unzip(j_rglru.init(ini, jcfg))[0]
    tp = _carry(jp)
    assert t_rglru._C == j_rglru._C == 8.0
    x = _randn(8, 2, 23, 16)
    _close(t_rglru.apply_full(tp, T(x[:, :20]), tcfg),
           j_rglru.apply_full(jp, jnp.asarray(x[:, :20]), jcfg))
    xc = _randn(9, 2, 20, 16) * 5.0
    ja, jb = j_rglru._gates(jp, jnp.asarray(xc))
    tla, tb = t_rglru._gates(tp, T(xc))
    _close(torch.exp(tla), ja)
    _close(tb, jb)
    jo, js = j_rglru.prefill_into_state(jp, jnp.asarray(x[:, :20]), jcfg)
    to, ts = t_rglru.prefill_into_state(tp, T(x[:, :20]), tcfg)
    _close(to, jo)
    for got, want in zip(ts, js):
        _close(got, want)
    for t in range(20, 23):
        jo, js = j_rglru.apply_decode(jp, jnp.asarray(x[:, t:t + 1]), jcfg, js)
        h_ptr = ts.h.data_ptr()
        to, ts = t_rglru.apply_decode(tp, T(x[:, t:t + 1]), tcfg, ts)
        assert ts.h.data_ptr() == h_ptr
        _close(to, jo)
        for got, want in zip(ts, js):
            _close(got, want)


def test_rglru_decode_from_fresh_state():
    """Decode from ``init_state`` (the fp32 conv tail of the reference)."""
    jcfg, tcfg = _rg_cfgs()
    ini = j_common.Initializer(jax.random.PRNGKey(3), jnp.float32)
    jp = j_common.unzip(j_rglru.init(ini, jcfg))[0]
    tp = _carry(jp)
    js, ts = j_rglru.init_state(jcfg, 2), t_rglru.init_state(tcfg, 2, device="cpu")
    assert ts.conv.dtype == torch.float32 and ts.h.dtype == torch.float32
    x = _randn(4, 2, 5, 16)
    for t in range(5):
        jo, js = j_rglru.apply_decode(jp, jnp.asarray(x[:, t:t + 1]), jcfg, js)
        to, ts = t_rglru.apply_decode(tp, T(x[:, t:t + 1]), tcfg, ts)
        _close(to, jo)
    assert int(ts.pos) == int(js.pos) == 5


# ---------------------------------------------------------------------------
# Local (windowed) attention and the ring cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,w", [(12, 16), (16, 16), (40, 16), (64, 16), (33, 8)],
                         ids=["n<w", "n=w", "n%w!=0", "multi-chunk", "n%w=1"])
def test_local_attention_matches_jax(n, w):
    q, k, v = _randn(10, 1, 2, n, 8), _randn(11, 1, 2, n, 8), _randn(12, 1, 2, n, 8)
    _close(t_attention.local_attention(T(q), T(k), T(v), w),
           j_attention.local_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), w))


@pytest.mark.parametrize("pos", [np.int32(13), np.array([0, 7, 20], np.int32)],
                         ids=["scalar", "per-row"])
def test_update_ring_cache_matches_jax(pos):
    ck, cv = _randn(13, 3, 2, 8, 4), _randn(14, 3, 2, 8, 4)
    nk, nv = _randn(15, 3, 2, 1, 4), _randn(16, 3, 2, 1, 4)
    jk, jv = j_common.update_ring_cache(jnp.asarray(ck), jnp.asarray(cv),
                                        jnp.asarray(pos), jnp.asarray(nk),
                                        jnp.asarray(nv), 8)
    tk, tv = T(ck.copy()), T(cv.copy())
    gk, gv = t_common.update_ring_cache(tk, tv, torch.as_tensor(pos), T(nk), T(nv), 8)
    assert gk.data_ptr() == tk.data_ptr()                     # in place
    np.testing.assert_array_equal(gk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(jv))


def _attn_cfgs():
    kw = dict(name="t", family="hybrid", num_layers=3, d_model=32, num_heads=4,
              num_kv_heads=1, head_dim=8, d_ff=32, vocab_size=16, dtype="float32")
    return JArch(**kw), TArch(**kw)


@pytest.mark.parametrize("n", [12, 40], ids=["prompt<window", "prompt>=window"])
def test_windowed_attention_layer_matches_jax(n):
    """``apply_full`` / ``prefill_into_cache`` / ``apply_decode`` with a
    window of 16 (MQA 4 / 1): outputs, the ring cache after the prefill's
    roll (n slots for a prompt shorter than the window, as the reference
    leaves it) and after each decode step, at scalar positions."""
    w = 16
    jcfg, tcfg = _attn_cfgs()
    ini = j_common.Initializer(jax.random.PRNGKey(2), jnp.float32)
    jp = j_common.unzip(j_attention.init(ini, jcfg))[0]
    tp = _carry(jp)
    x = _randn(17, 2, n + 4, 32)
    pos_j, pos_t = jnp.arange(n), torch.arange(n)
    _close(t_attention.apply_full(tp, T(x[:, :n]), tcfg, positions=pos_t, window=w),
           j_attention.apply_full(jp, jnp.asarray(x[:, :n]), jcfg, positions=pos_j,
                                  window=w))
    jo, jc = j_attention.prefill_into_cache(jp, jnp.asarray(x[:, :n]), jcfg,
                                            positions=pos_j, max_len=64, window=w)
    to, tc = t_attention.prefill_into_cache(tp, T(x[:, :n]), tcfg, positions=pos_t,
                                            max_len=64, window=w)
    _close(to, jo)
    assert tc.k.shape[2] == jc.k.shape[2] == min(n, w)
    for t in range(n, n + 4):
        jo, jc = j_attention.apply_decode(jp, jnp.asarray(x[:, t:t + 1]), jcfg, jc,
                                          window=w)
        to, tc = t_attention.apply_decode(tp, T(x[:, t:t + 1]), tcfg, tc, window=w)
        _close(to, jo)
        _close(tc.k, jc.k)
        assert int(tc.pos) == int(jc.pos)


def test_windowed_decode_per_row_positions_match_jax():
    """A ring cache of 16 slots decoded at (b,) positions 3 / 16 / 37 (rows
    whose ring has not wrapped, just wrapped, and wrapped twice)."""
    jcfg, tcfg = _attn_cfgs()
    ini = j_common.Initializer(jax.random.PRNGKey(4), jnp.float32)
    jp = j_common.unzip(j_attention.init(ini, jcfg))[0]
    tp = _carry(jp)
    ck, cv = _randn(18, 3, 1, 16, 8), _randn(19, 3, 1, 16, 8)
    pos = np.array([3, 16, 37], np.int32)
    x = _randn(20, 3, 1, 32)
    jo, jc = j_attention.apply_decode(
        jp, jnp.asarray(x), jcfg,
        j_attention.KVCache(jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(pos)),
        window=16)
    to, tc = t_attention.apply_decode(
        tp, T(x), tcfg, t_attention.KVCache(T(ck.copy()), T(cv.copy()), T(pos)),
        window=16)
    _close(to, jo)
    _close(tc.k, jc.k)
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))


def test_windowed_decode_refuses_a_policy():
    _, tcfg = _attn_cfgs()
    cache = t_attention.init_cache(tcfg, 1, 32, window=16, dtype=torch.float32,
                                   device="cpu")
    assert cache.k.shape[2] == 16
    tp = t_attention.init(t_common.Initializer(torch.Generator(), torch.float32,
                                               "cpu"), tcfg)
    with pytest.raises(NotImplementedError, match="windowed"):
        t_attention.apply_decode(tp, torch.zeros((1, 1, 32)), tcfg, cache,
                                 window=16, stem_cfg="stem")


# ---------------------------------------------------------------------------
# Cross attention and the common helpers
# ---------------------------------------------------------------------------

def test_cross_attention_matches_jax():
    kw = dict(name="t", family="encdec", num_layers=1, d_model=32, num_heads=4,
              num_kv_heads=4, head_dim=8, d_ff=32, vocab_size=16, dtype="float32")
    jcfg, tcfg = JArch(**kw), TArch(**kw)
    ini = j_common.Initializer(jax.random.PRNGKey(5), jnp.float32)
    jp = j_common.unzip(j_attention.init_cross(ini, jcfg))[0]
    tp = _carry(jp)
    enc, x = _randn(21, 2, 11, 32), _randn(22, 2, 7, 32)
    jk, jv = j_attention.cross_kv(jp, jnp.asarray(enc))
    tk, tv = t_attention.cross_kv(tp, T(enc))
    _close(tk, jk)
    _close(tv, jv)
    _close(t_attention.apply_cross(tp, T(x), tk, tv, 8),
           j_attention.apply_cross(jp, jnp.asarray(x), jk, jv, 8))


def test_norms_and_positions_match_jax():
    x, w, b = _randn(23, 2, 5, 24), _randn(24, 24) * 0.1, _randn(25, 24)
    _close(t_common.layer_norm_simple(T(x), T(w)),
           j_common.layer_norm_simple(jnp.asarray(x), jnp.asarray(w)))
    _close(t_common.layer_norm(T(x), T(w), T(b)),
           j_common.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    # Sinusoidal positions: sin / cos of angles up to 1499 rad, where one
    # fp32 ulp of the angle is 1.2e-4.  Both packages round exp(-i log(1e4)
    # / dim) to fp32 with their CPU's vector math (1-2 ulps apart), which the
    # product with the position carries into the angle, so the reference
    # itself moves by a few ulps of the angle between CPUs.  Held to 4 fp32
    # ulps of each element's own angle, and the port's output to a float64
    # evaluation of its own fp32 angles.
    got = t_common.sinusoidal_positions(1500, 64, device="cpu")
    want = np.asarray(j_common.sinusoidal_positions(1500, 64), np.float64)
    pos = torch.arange(1500, dtype=torch.float32)[:, None]
    inv = torch.exp(-torch.arange(0, 64, 2, dtype=torch.float32)
                    * (math.log(10000.0) / 64))
    ang = (pos * inv[None, :]).double().numpy()
    limit = 4 * 2.0 ** -23 * np.maximum(1.0, np.abs(np.concatenate([ang, ang], -1)))
    assert np.all(np.abs(got.double().numpy() - want) <= limit)
    np.testing.assert_allclose(got.double().numpy(),
                               np.concatenate([np.sin(ang), np.cos(ang)], -1),
                               atol=1e-6, rtol=0)
