"""The bf16 tensor-core attention tile at the head dims it takes besides 128,
emulated on the CPU and held against the JAX reference.

The tile (``csrc/attn_wgmma.cuh``) runs flash and block-sparse attention in
bf16 at every pair of ``kernels.WGMMA_PAIRS``: 128 query rows a CTA, an
online softmax over BN-key tiles (BN 128 at (64, 64) and (192, 128), 64 at
(192, 192) and (256, 256): ``TileOf``), the scores and the running max and
sum in fp32, P rounded to bf16 before P.V, fp32 accumulation, the output
rounded to bf16.  ``tile_attention`` below walks the same key tiles in the
kernel's order (flash: 0..the tile of the query tile's last row;
block-sparse: the row's live selected blocks in list order, each in BN-key
sub-tiles that hold a key at or below the query tile's last row) and masks
them as the kernel does (key column c from query row r where c + off > r,
off = first key - first query).

On bf16-valued inputs made from a numpy seed, at each new pair x {flash,
block-sparse}:

* the emulation is within the p_bf16 rule (``replay.tolerance(...,
  p_bf16=True)``: 2 bf16 ulps + 1e-2 * the row's max|ref|) of the
  reference's Pallas kernel in interpret mode (its fp32 P) and of the
  port's plain version: the rule the card tests apply admits the rounding;
* the same walk with one key tile left out (flash: the first tile of every
  query tile that has two or more; block-sparse: the last live block of
  every selection row with two or more) puts most of the touched rows over
  that rule: the rule sees a dropped tile at these shapes.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as j_ops

from repro_torch.kernels import WGMMA_PAIRS, forward_route, replay
from repro_torch.kernels import block_sparse_attn as t_bsa
from repro_torch.kernels import flash_attention as t_fa

torch.set_num_threads(1)

BM = 128                      # query rows a CTA
NEW_PAIRS = [p for p in WGMMA_PAIRS if p != (128, 128)]


def _tile_bn(d: int, dv: int) -> int:
    """TileOf's key tile: 128 while a stage of K and V at 128 keys leaves
    room for two stages beside Q (d + dv <= 320), else 64."""
    return 128 if d + dv <= 320 else 64


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _inputs(seed, b, hq, hk, n, d, dv):
    rng = np.random.default_rng(seed)
    return [_bf16(torch.from_numpy(rng.standard_normal(s).astype(np.float32)))
            for s in ((b, hq, n, d), (b, hk, n, d), (b, hk, n, dv))]


def tile_attention(q, k, v, walk, *, bn: int, scale: float) -> torch.Tensor:
    """The tile's arithmetic: for each (batch, head, 128-row query tile at
    q0) the key tiles ``walk(b, h, q0)`` yields (their first key rows k0),
    scores in log2 units, the online softmax with a row that has seen no
    key exponentiating against 0, P rounded to bf16 for P.V, the output
    acc / max(l, 1e-20) rounded to bf16.  Returns (b, hq, n, dv) fp32."""
    b, hq, n, d = q.shape
    hk, dv = k.shape[1], v.shape[-1]
    group = hq // hk
    pad = (-n) % BM + BM
    kp = torch.cat([k, torch.zeros((b, hk, pad, d))], dim=2)
    vp = torch.cat([v, torch.zeros((b, hk, pad, dv))], dim=2)
    sc = scale * 1.4426950408889634
    out = torch.zeros((b, hq, n, dv))
    for bb in range(b):
        for h in range(hq):
            for q0 in range(0, n, BM):
                rows = min(BM, n - q0)
                qt = q[bb, h, q0:q0 + rows]
                m = torch.full((rows,), -torch.inf)
                l = torch.zeros(rows)
                o = torch.zeros((rows, dv))
                for k0 in walk(bb, h, q0):
                    s = qt @ kp[bb, h // group, k0:k0 + bn].T * sc
                    off = k0 - q0
                    if off > -bn:
                        cols = torch.arange(bn)[None, :] + off
                        s = torch.where(cols > torch.arange(rows)[:, None], -torch.inf, s)
                    m_new = torch.maximum(m, s.max(dim=-1).values)
                    m_use = torch.where(m_new == -torch.inf, 0.0, m_new)
                    corr = torch.exp2(m - m_use)
                    p = torch.exp2(s - m_use[:, None])
                    l = l * corr + p.sum(dim=-1)
                    m = m_new
                    o = o * corr[:, None] + _bf16(p) @ vp[bb, h // group, k0:k0 + bn]
                out[bb, h, q0:q0 + rows] = o / torch.clamp(l, min=1e-20)[:, None]
    return _bf16(out)


def flash_walk(n: int, bn: int, drop_first: bool = False):
    """The key tiles 0..(last valid row of the query tile) // bn; with
    drop_first the first is left out of every query tile that has two or
    more."""
    def walk(b, h, q0):
        tiles = list(range((min(q0 + BM, n) - 1) // bn + 1))
        if drop_first and len(tiles) >= 2:
            tiles = tiles[1:]
        return [t * bn for t in tiles]
    return walk


def sparse_walk(idx, cnt, bs: int, bn: int):
    """The BN-key sub-tiles of the live selected blocks of the query tile's
    selection row, in list order, that hold a key at or below its last
    row (blocks, q0 and sub-tiles are multiples of bn)."""
    nq = idx.shape[2]

    def walk(b, h, q0):
        row = (b, h, q0 // bs)
        tiles = []
        for s in range(min(int(cnt[row]), idx.shape[-1])):
            j = int(idx[row + (s,)])
            if 0 <= j < nq:
                tiles += [j * bs + t for t in range(0, bs, bn) if j * bs + t <= q0 + BM - bn]
        return tiles
    return walk


def _selection(seed, b, hs, nq, kmax):
    """Causal selections, the diagonal block first, then distinct blocks
    below it; live counts 1..min(i + 1, kmax), one row (0, 0, 1) empty."""
    rng = np.random.default_rng(seed)
    idx = np.zeros((b, hs, nq, kmax), np.int32)
    cnt = np.zeros((b, hs, nq), np.int32)
    for r in np.ndindex(b, hs, nq):
        i = r[2]
        pick = [i] + list(rng.permutation(i))[:kmax - 1]
        idx[r][:len(pick)] = pick
        idx[r][len(pick):] = pick[0]
        cnt[r] = int(rng.integers(1, len(pick) + 1))
    cnt[0, 0, 1] = 0
    return idx, cnt


def _over(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|got - want| / the p_bf16 rule's limit, per element."""
    return (got - want).abs() / replay.tolerance(want, torch.bfloat16, p_bf16=True)


def _j(x: torch.Tensor):
    return jnp.asarray(x.numpy(), dtype=jnp.bfloat16)


def _ref(x) -> torch.Tensor:
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32)))


@pytest.mark.parametrize("kernel", ["flash", "block_sparse"])
@pytest.mark.parametrize("pair", NEW_PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_tile_emulation_within_p_bf16_rule_and_rejects_dropped_tile(pair, kernel):
    d, dv = pair
    bn = _tile_bn(d, dv)
    assert forward_route(torch.bfloat16, d, dv, None if kernel == "flash" else 128) == "wgmma"
    b, hq, hk, n, bs, kmax = 1, 2, 1, 512, 128, 3
    q, k, v = _inputs(d * 3 + dv, b, hq, hk, n, d, dv)
    scale = d ** -0.5
    if kernel == "flash":
        want = _ref(j_ops.flash_attention(_j(q), _j(k), _j(v)))
        plain = t_fa.flash_attention_plain(q.bfloat16(), k.bfloat16(), v.bfloat16()).float()
        walk, bad_walk = flash_walk(n, bn), flash_walk(n, bn, drop_first=True)
        touched = torch.zeros((b, hq, n), dtype=torch.bool)
        for q0 in range(0, n, BM):            # the query tiles with two or more
            touched[..., q0:q0 + BM] = len(walk(0, 0, q0)) >= 2
    else:
        idx, cnt = _selection(d + dv, b, hq, n // bs, kmax)
        want = _ref(j_ops.block_sparse_attention(
            _j(q), _j(k), _j(v), jnp.asarray(idx),
            jnp.asarray(np.arange(kmax)[None, None, None] < cnt[..., None]),
            block_size=bs, live_counts=jnp.asarray(cnt)))
        ti, tc = torch.from_numpy(idx), torch.from_numpy(cnt)
        plain = t_bsa.block_sparse_attention_plain(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                                   ti, tc, block_size=bs).float()
        walk = sparse_walk(idx, cnt, bs, bn)
        fewer = np.where(cnt >= 2, cnt - 1, cnt)
        bad_walk = sparse_walk(idx, fewer, bs, bn)
        touched = torch.from_numpy(np.repeat(cnt >= 2, bs, axis=-1))
    got = tile_attention(q, k, v, walk, bn=bn, scale=scale)
    assert tuple(got.shape) == (b, hq, n, dv)
    for ref in (want, plain):
        worst = float(_over(got, ref).max())
        assert worst <= 1, f"bf16 P at {worst:.2f}x the p_bf16 rule"
    bad = tile_attention(q, k, v, bad_walk, bn=bn, scale=scale)
    over_rows = (_over(bad, want) > 1).any(dim=-1)
    assert int(touched.sum()) > 0
    assert 2 * int(over_rows[touched].sum()) > int(touched.sum())
    assert not bool(over_rows[~touched].any())
